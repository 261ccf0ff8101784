"""Flow evaluation metrics: EPE, Fl-all, and the parity-harness metric set.

The port's own copy of ``opticalflow_tpu.utils.metrics`` (numpy only; the
port imports nothing of the JAX package).  The reference's metric
definitions:

  * :func:`epe` — mean endpoint error over valid pixels
    (``inference_kitti.py:94-107``);
  * :func:`fl_all` — KITTI outlier %, outlier ⇔ EPE > 3px AND
    EPE > 0.05·‖gt‖ (``inference_kitti.py:109-128``);
  * :func:`parity_report` — the full comparison suite of the reference's
    ONNX↔pth harness (``onnx_pth_compare.py:133-201``): L2/MAE/max-abs/
    relative-L2/Pearson/cosine/EPE-mean/EPE-max/agreement@τ.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["epe", "fl_all", "epe_map", "parity_report"]


def epe_map(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-pixel endpoint error for (H, W, 2) flows."""
    return np.sqrt(np.sum((np.asarray(pred, np.float64)
                           - np.asarray(gt, np.float64)) ** 2, axis=-1))


def epe(pred: np.ndarray, gt: np.ndarray,
        valid: Optional[np.ndarray] = None) -> float:
    """Mean EPE over valid pixels; NaN when no pixel is valid."""
    err = epe_map(pred, gt)
    if valid is not None:
        err = err[np.asarray(valid, bool)]
    if err.size == 0:
        return float("nan")
    return float(err.mean())


def fl_all(pred: np.ndarray, gt: np.ndarray,
           valid: Optional[np.ndarray] = None) -> float:
    """KITTI Fl-all outlier percentage over valid pixels."""
    err = epe_map(pred, gt)
    mag = np.sqrt(np.sum(np.asarray(gt, np.float64) ** 2, axis=-1))
    if valid is not None:
        v = np.asarray(valid, bool)
        err, mag = err[v], mag[v]
    if err.size == 0:
        return float("nan")
    outlier = (err > 3.0) & (err > 0.05 * mag)
    return float(outlier.mean() * 100.0)


def parity_report(a: np.ndarray, b: np.ndarray,
                  thresholds=(0.25, 0.5, 1.0, 2.0)) -> Dict[str, float]:
    """Numerical agreement between two flow fields (or any same-shape
    tensors); flow-specific entries assume trailing dim 2."""
    a64 = np.asarray(a, np.float64).ravel()
    b64 = np.asarray(b, np.float64).ravel()
    diff = a64 - b64
    rep: Dict[str, float] = {
        "l2": float(np.linalg.norm(diff)),
        "mae": float(np.abs(diff).mean()),
        "max_abs": float(np.abs(diff).max()),
        "rel_l2": float(np.linalg.norm(diff)
                        / (np.linalg.norm(b64) + 1e-12)),
        "cosine": float(np.dot(a64, b64)
                        / (np.linalg.norm(a64) * np.linalg.norm(b64) + 1e-12)),
    }
    if a64.std() > 0 and b64.std() > 0:
        rep["pearson"] = float(np.corrcoef(a64, b64)[0, 1])
    if a.shape == b.shape and a.shape[-1] == 2:
        e = epe_map(a, b)
        rep["epe_mean"] = float(e.mean())
        rep["epe_max"] = float(e.max())
        for t in thresholds:
            rep[f"agree@{t}"] = float((e <= t).mean() * 100.0)
    return rep
