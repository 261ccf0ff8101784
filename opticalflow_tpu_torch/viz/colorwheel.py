"""Flow → color visualization (Middlebury color wheel).

The port's own copy of ``opticalflow_tpu.viz.colorwheel`` (numpy only),
bit-exact to it.  Behavioral clone of the reference's ``flow_to_color``
(``pwc_extract_flow.py:58-123``): a 55-entry RY/YG/GC/CB/BM/MR wheel
(15+6+4+11+13+6), angle = atan2(−v, −u) mapped to fractional wheel position
``fk = (ang/π + 1)/2 · 54 + 1`` with wrap-around lerp, and saturation
attenuated toward white by the magnitude normalized to the per-image max.
Also exposes the HSV variant used by the parity harness
(``onnx_pth_compare.py:25-45``), and :func:`magma_rgb`, matplotlib's
``magma`` colour map from its table stored beside this module
(``magma.npz``), for the export report's EPE map.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["make_colorwheel", "flow_to_color", "flow_to_color_hsv",
           "magma_rgb", "MAGMA_PATH"]

MAGMA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "magma.npz")

_WHEEL_SEGMENTS = (("RY", 15), ("YG", 6), ("GC", 4), ("CB", 11),
                   ("BM", 13), ("MR", 6))


def make_colorwheel() -> np.ndarray:
    """(55, 3) uint8 Middlebury color wheel."""
    ncols = sum(n for _, n in _WHEEL_SEGMENTS)
    wheel = np.zeros((ncols, 3), np.uint8)
    # each segment ramps one channel while holding another at 255
    ramps = {
        "RY": (0, 1, False), "YG": (0, 1, True), "GC": (1, 2, False),
        "CB": (1, 2, True), "BM": (2, 0, False), "MR": (2, 0, True),
    }
    col = 0
    for name, n in _WHEEL_SEGMENTS:
        hold, ramp, descending = ramps[name]
        ramp_vals = np.floor(255 * np.arange(n) / n).astype(np.uint8)
        if descending:
            wheel[col:col + n, hold] = 255 - ramp_vals
            wheel[col:col + n, ramp] = 255
        else:
            wheel[col:col + n, hold] = 255
            wheel[col:col + n, ramp] = ramp_vals
        col += n
    return wheel


def flow_to_color(flow_uv: np.ndarray,
                  clip_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) uint8 RGB color-wheel image."""
    u = np.asarray(flow_uv[..., 0], np.float64)
    v = np.asarray(flow_uv[..., 1], np.float64)
    if clip_flow is not None:
        rad = np.sqrt(u * u + v * v)
        scale = clip_flow / np.maximum(np.maximum(rad, 1e-5), clip_flow)
        u, v = u * scale, v * scale

    rad = np.sqrt(u * u + v * v)
    wheel = make_colorwheel().astype(np.float64) / 255.0
    ncols = wheel.shape[0]

    ang = np.arctan2(-v, -u) / np.pi                  # [-1, 1]
    fk = (ang + 1.0) / 2.0 * (ncols - 1) + 1.0        # [1, ncols]
    k0 = np.floor(fk).astype(int)
    frac = (fk - k0)[..., None]
    c0 = wheel[(k0 - 1) % ncols]
    c1 = wheel[k0 % ncols]
    col = (1.0 - frac) * c0 + frac * c1

    rad_norm = np.clip(rad / (rad.max() + 1e-5), 0.0, 1.0)[..., None]
    col = 1.0 - rad_norm * (1.0 - col)
    return (np.clip(col, 0.0, 1.0) * 255).astype(np.uint8)


def flow_to_color_hsv(flow_uv: np.ndarray,
                      max_mag: float | None = None) -> np.ndarray:
    """HSV flow coloring: hue = direction, value = normalized magnitude
    (the parity-harness variant, ``onnx_pth_compare.py:25-45``)."""
    u = np.asarray(flow_uv[..., 0], np.float32)
    v = np.asarray(flow_uv[..., 1], np.float32)
    mag = np.sqrt(u * u + v * v)
    ang = (np.arctan2(v, u) + np.pi) / (2 * np.pi)    # [0, 1]
    if max_mag is None:
        max_mag = mag.max() + 1e-5
    val = np.clip(mag / max_mag, 0.0, 1.0)
    hsv = np.stack([ang, np.ones_like(ang), val], axis=-1)
    # HSV → RGB without cv2 dependency
    h6 = hsv[..., 0] * 6.0
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    p = np.zeros_like(val)
    q = val * (1.0 - f)
    t = val * f
    rgb = np.select(
        [i[..., None] == k for k in range(6)],
        [np.stack(c, axis=-1) for c in
         ((val, t, p), (q, val, p), (p, val, t),
          (p, q, val), (t, p, val), (val, p, q))])
    return (rgb * 255).astype(np.uint8)


def magma_rgb(x) -> np.ndarray:
    """Values in [0, 1] → uint8 RGB by matplotlib's 256-entry ``magma``, as
    ``matplotlib.colormaps["magma"](x, bytes=True)[..., :3]`` gives them:
    entry ``int(256·x)`` (1.0 → the last), below 0 the first, above 1 the
    last, NaN black."""
    with np.load(MAGMA_PATH) as z:
        lut = (z["magma"] * 255).astype(np.uint8)
    xa = np.array(x, dtype=np.float64) * len(lut)
    bad = np.isnan(xa)
    idx = np.clip(np.where(bad, 0.0, xa), 0, len(lut) - 1).astype(np.int64)
    out = lut[idx]
    out[bad] = 0
    return out
