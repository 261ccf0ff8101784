"""Planar YUV 4:2:0 (I420) on the host, in OpenCV's integer arithmetic.

The video runner's ``upload="i420"`` ships each frame as I420, half the
bytes of RGB, and unpacks it on the card (``video.yuv_i420_to_rgb_u8``,
whose plain version is :func:`i420_to_rgb`; the ``.y4m`` reader converts
as swscale does instead, ``runtime/mpeg4.i420_to_bgr``, since the JAX
package reads a ``.y4m`` through FFmpeg).  The writers and the runner
pack frames with ``runtime/mpeg4.to_i420``, a C copy of
:func:`rgb_to_i420` that the tests hold to it bit for bit.  All are bit-exact to OpenCV, which the port does
not use:

  * :func:`rgb_to_i420` = ``cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)``:
    BT.601 video range at 20-bit fixed point, round half up; the chroma of
    each 2×2 block is the top-left pixel's (OpenCV does not average);
  * :func:`i420_to_rgb` = ``cv2.cvtColor(yuv, cv2.COLOR_YUV2RGB_I420)``:
    nearest 2×2 chroma upsampling, the same constants as the card's op;
  * :func:`bgr_to_gray` = ``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)``, the
    grey the comparison baselines (``viz/overlay.opencv_flow``) start from.

The packed layout is OpenCV's: (H·3/2, W) uint8, the Y plane, then the U
plane and the V plane (H/2 × W/2 each) back to back.  H and W are even.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rgb_to_i420", "i420_to_rgb", "i420_planes", "pad_to_even",
           "bgr_to_gray"]

_SHIFT = 20
_HALF = 1 << (_SHIFT - 1)
# RGB -> YUV (BT.601, video range)
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74448
# YUV -> RGB
_CY, _CVR, _CVG, _CUG, _CUB = 1220542, 1673527, -852492, -409993, 2116026
# BGR -> grey: OpenCV 5's 15-bit weights of R, G, B (its older releases
# used a 14-bit table, which differs by 1 on some pixels)
_GR, _GG, _GB, _GSHIFT = 9798, 19235, 3735, 15


def pad_to_even(frame: np.ndarray) -> np.ndarray:
    """Edge-pad an (H, W, C) frame by at most one row and one column so
    that both sides are even, as the video runner does before I420."""
    h, w = frame.shape[:2]
    if h % 2 or w % 2:
        frame = np.pad(frame, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    return frame


def rgb_to_i420(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB, H and W even → (H·3/2, W) uint8 I420."""
    h, w = rgb.shape[:2]
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"rgb_to_i420 takes uint8 (H, W, 3), got "
                         f"{rgb.dtype} {rgb.shape}")
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even sides, got {h}x{w} "
                         "(pad_to_even first)")
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    y = (_CRY * r + _CGY * g + _CBY * b + _HALF + (16 << _SHIFT)) >> _SHIFT
    r0, g0, b0 = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    u = (_CRU * r0 + _CGU * g0 + _CBU * b0 + _HALF
         + (128 << _SHIFT)) >> _SHIFT
    v = (_CBU * r0 + _CGV * g0 + _CBV * b0 + _HALF
         + (128 << _SHIFT)) >> _SHIFT
    planes = [np.clip(p, 0, 255).astype(np.uint8).ravel() for p in (y, u, v)]
    return np.concatenate(planes).reshape(h * 3 // 2, w)


def i420_planes(yuv: np.ndarray):
    """(H·3/2, W) packed I420 → its (Y, U, V) planes, as views."""
    h, w = yuv.shape[0] * 2 // 3, yuv.shape[1]
    flat = yuv.reshape(-1)
    n, c = h * w, (h // 2) * (w // 2)
    return (flat[:n].reshape(h, w), flat[n:n + c].reshape(h // 2, w // 2),
            flat[n + c:n + 2 * c].reshape(h // 2, w // 2))


def i420_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """(H·3/2, W) uint8 I420 → (H, W, 3) uint8 RGB.  The chroma planes are
    sliced by element count: when H % 4 != 0 the U/V boundary falls inside
    a row of the packed array."""
    h32, w = yuv.shape
    if h32 % 3 or (h32 * 2 // 3) % 2 or w % 2:
        raise ValueError(f"bad I420 packed shape {yuv.shape}: rows must be "
                         "H*3/2 with H and W even")
    h = h32 * 2 // 3
    y = np.maximum(yuv[:h].astype(np.int32) - 16, 0) * _CY
    ce = (h // 2) * (w // 2)
    chroma = yuv[h:].reshape(-1)
    u = chroma[:ce].reshape(h // 2, w // 2).astype(np.int32) - 128
    v = chroma[ce:].reshape(h // 2, w // 2).astype(np.int32) - 128
    u = u.repeat(2, axis=0).repeat(2, axis=1)
    v = v.repeat(2, axis=0).repeat(2, axis=1)
    r = (y + _CVR * v + _HALF) >> _SHIFT
    g = (y + _CVG * v + _CUG * u + _HALF) >> _SHIFT
    b = (y + _CUB * u + _HALF) >> _SHIFT
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) BGR → (H, W) uint8 grey, bit-exact to
    ``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)`` in OpenCV 5:
    ``(9798·R + 19235·G + 3735·B + 2^14) >> 15``."""
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"bgr_to_gray takes uint8 (H, W, 3), got "
                         f"{bgr.dtype} {bgr.shape}")
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    y = (_GR * r + _GG * g + _GB * b + (1 << (_GSHIFT - 1))) >> _GSHIFT
    return y.astype(np.uint8)
