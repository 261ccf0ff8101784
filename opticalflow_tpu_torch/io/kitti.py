"""KITTI 16-bit PNG optical-flow I/O, with no OpenCV, imageio or PIL.

The port's own copy of ``opticalflow_tpu.io.kitti``.  Encoding (KITTI
devkit; reference readers ``inference_kitti.py:23-52``,
``data_processing_or.py:25-66``, ``inference.py:60-79``):

    u = (R - 2^15) / 64,  v = (G - 2^15) / 64,  valid = (B != 0)

The reader decodes the 16-bit RGB PNG with the port's own decoder
(``io.images.decode_png``); the writer follows ``inference.py:266-282``
through the port's own encoder (``io.images.encode_png``).
"""

from __future__ import annotations

import numpy as np

from opticalflow_tpu_torch.io.images import decode_png, encode_png

__all__ = ["read_flow_png", "write_flow_png"]


def read_flow_png(path: str):
    """Read a KITTI flow PNG → ((H, W, 2) float32 flow, (H, W) bool valid)."""
    with open(path, "rb") as f:
        arr = decode_png(f.read())
    if arr is None:
        raise ValueError(f"{path}: not a non-interlaced 8/16-bit PNG")
    if arr.ndim != 3 or arr.shape[2] < 3:
        raise ValueError(f"{path}: expected 3-channel PNG, got {arr.shape}")
    if arr.dtype != np.uint16:
        raise ValueError(f"{path}: expected uint16 PNG, got {arr.dtype}")
    u = (arr[..., 0].astype(np.float32) - 32768.0) / 64.0
    v = (arr[..., 1].astype(np.float32) - 32768.0) / 64.0
    valid = arr[..., 2] != 0
    return np.stack([u, v], axis=-1), valid


def write_flow_png(path: str, flow: np.ndarray,
                   valid: np.ndarray | None = None) -> None:
    """Write (H, W, 2) flow (+ optional validity) as a KITTI 16-bit PNG."""
    flow = np.asarray(flow)
    h, w, _ = flow.shape
    out = np.zeros((h, w, 3), np.uint16)
    scaled = np.clip(flow * 64.0 + 32768.0, 0, 65535)
    out[..., 0] = scaled[..., 0].astype(np.uint16)
    out[..., 1] = scaled[..., 1].astype(np.uint16)
    out[..., 2] = (np.ones((h, w), np.uint16) if valid is None
                   else np.asarray(valid).astype(np.uint16))
    with open(path, "wb") as f:
        f.write(encode_png(out))
