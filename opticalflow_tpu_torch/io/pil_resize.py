"""PIL's ``Image.resize(..., Image.BILINEAR)`` in numpy.

The v1 evaluation script resizes its frames and its quarter-res flow with
PIL (``inference.py:162-190, 296-324``); the engine's ``resize_fixed`` mode
reproduces that without PIL, which the GPU machine does not have.

PIL resamples separably with a triangle filter whose support grows with the
shrink factor (an antialiasing filter when a side shrinks, plain bilinear
when it grows).  Per output pixel of an axis it takes the source pixels
``[xmin, xmin + n)`` around ``center = (x + 0.5) * scale`` with weights
``tri((x_src - center + 0.5) / filterscale)``, normalised to sum 1, all in
double.  Then:

  * uint8 images: the weights become 22-bit fixed point
    (``int(0.5 + w * 2**22)``), each pass sums ``pixel * weight`` in
    integers from ``2**21`` and takes ``>> 22`` clipped to 0..255: the
    horizontal pass first, into a uint8 intermediate, then the vertical;
  * float32 images (mode ``F``): each pass sums in double, in source order,
    and stores float32.

An axis whose size does not change is not resampled.  This is not the
half-pixel triangle of ``ops/resize._triangle_weights`` (JAX's
``jax.image.resize``), which differs in its support and its rounding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["pil_bilinear_weights", "resize_pil_bilinear_u8",
           "resize_pil_bilinear_f32"]

_PRECISION_BITS = 32 - 8 - 2


def pil_bilinear_weights(in_size: int, out_size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(xmin (out,), weights (out, ksize) float64) of one axis, as PIL's
    ``precompute_coeffs`` computes them; weights past a pixel's own span
    are 0 (its span is clamped to the image)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale          # the bilinear filter's support is 1
    ksize = int(np.ceil(support)) * 2 + 1
    xmin = np.empty(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        ww = 0.0
        row = weights[xx]
        for x in range(hi - lo):
            t = abs((x + lo - center + 0.5) * ss)
            w = 1.0 - t if t < 1.0 else 0.0
            row[x] = w
            ww += w
        if ww != 0.0:
            row[:hi - lo] /= ww
        xmin[xx] = lo
    return xmin, weights


def _taps(in_size: int, out_size: int):
    """Source indices (out, ksize), clamped into the image (their weights
    are 0 there), and the weights."""
    xmin, weights = pil_bilinear_weights(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(weights.shape[1]),
                     in_size - 1)
    return idx, weights


def _pass_u8(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    idx, weights = _taps(img.shape[axis], out_size)
    k = np.floor(0.5 + weights * (1 << _PRECISION_BITS)).astype(np.int64)
    src = img.astype(np.int64)
    acc = np.full(np.take(src, idx[:, 0], axis=axis).shape,
                  1 << (_PRECISION_BITS - 1), np.int64)
    shape = [1] * img.ndim
    shape[axis] = out_size
    for j in range(idx.shape[1]):
        acc += np.take(src, idx[:, j], axis=axis) * k[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass_f32(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    idx, weights = _taps(img.shape[axis], out_size)
    src = img.astype(np.float64)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.zeros(np.take(src, idx[:, 0], axis=axis).shape, np.float64)
    for j in range(idx.shape[1]):      # in source order, as PIL sums
        acc += np.take(src, idx[:, j], axis=axis) * weights[:, j].reshape(
            shape)
    return acc.astype(np.float32)


def _resize(img: np.ndarray, height: int, width: int, one_pass):
    h, w = img.shape[:2]
    if width != w:
        img = one_pass(img, 1, width)
    if height != h:
        img = one_pass(img, 0, height)
    return img


def resize_pil_bilinear_u8(img: np.ndarray, height: int,
                           width: int) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) → (height, width[, C]), bit-exact to
    ``np.asarray(Image.fromarray(img).resize((width, height),
    Image.BILINEAR))``."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_pil_bilinear_u8 takes uint8, got {img.dtype}")
    return _resize(img, int(height), int(width), _pass_u8)


def resize_pil_bilinear_f32(img: np.ndarray, height: int,
                            width: int) -> np.ndarray:
    """float32 (H, W) → (height, width), PIL's mode-``F`` BILINEAR resize:
    both passes sum in double and store float32."""
    return _resize(np.asarray(img, np.float32), int(height), int(width),
                   _pass_f32)
