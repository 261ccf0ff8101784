"""Host-side data augmentation for flow training, in numpy alone.

The port's own copy of ``opticalflow_tpu.data.augment``: the same two
pipelines, drawing from an explicit ``numpy.random.Generator`` in the same
order, so one seed gives one transform in both packages:

  * :func:`reduced_affine` — the KITTI fine-tune augmentation
    (``data_processing_or.py:72-140``): 40% skip, rotation ±2°, isotropic
    zoom 0.95–1.05, anisotropic squeeze 0.97–1.03, reflect-101 border;
    flow vectors transformed by the affine's linear part;
  * :class:`RichAugment` — the PWC-paper pipeline
    (``data_processing.py:136-279``): crop, 50% h-flip with u negation,
    rotation ±17° with vector rotation, translation ±10px, brightness /
    contrast 0.8–1.2, Gaussian blur;
  * :func:`random_crop` / :func:`hflip` shared helpers (30% flip in the
    KITTI set, ``data_processing_or.py:281-287``).

The JAX module calls OpenCV's ``warpAffine`` and ``GaussianBlur``; here
:func:`_warp` samples each destination pixel at the inverse affine map,
formed in float64 (bilinear with float32 weights, or nearest by
round-to-nearest), with a reflecting border, and :func:`gaussian_blur` is the separable [1,2,1]/4 or
[1,4,6,4,1]/16 kernel OpenCV uses for sigma 0, with a reflect-101 border.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["reduced_affine", "RichAugment", "random_crop", "hflip",
           "affine_matrix", "gaussian_blur", "BORDER_REFLECT_101",
           "BORDER_REFLECT"]

# the two borders the pipelines use: ``dcb|abcd|cba`` (the edge pixel not
# repeated) and ``cba|abcd|dcb`` (repeated)
BORDER_REFLECT_101 = "reflect_101"
BORDER_REFLECT = "reflect"

# OpenCV's fixed Gaussian kernels for sigma 0 (getGaussianKernel, ksize ≤ 7)
_GAUSS = {3: np.array([1.0, 2.0, 1.0]) / 4.0,
          5: np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0}


def affine_matrix(center_xy: Tuple[float, float], rot_deg: float,
                  sx: float, sy: float,
                  translate_xy: Tuple[float, float] = (0.0, 0.0)):
    """2×3 affine about a center: A = R(θ)·diag(sx, sy); returns (M, A)."""
    cx, cy = center_xy
    th = np.deg2rad(rot_deg)
    c, s = np.cos(th), np.sin(th)
    a = np.array([[sx * c, -sy * s], [sx * s, sy * c]], np.float32)
    t = np.array([cx, cy], np.float32) - a @ np.array([cx, cy], np.float32)
    t = t + np.asarray(translate_xy, np.float32)
    return np.concatenate([a, t[:, None]], axis=1), a


def _border_index(i: np.ndarray, n: int, border: str) -> np.ndarray:
    """Map integer indices anywhere on the line into [0, n) by reflection."""
    if n == 1:
        return np.zeros_like(i)
    if border == BORDER_REFLECT_101:
        period = 2 * n - 2
        i = np.mod(i, period)
        return np.where(i >= n, period - i, i)
    if border == BORDER_REFLECT:
        period = 2 * n
        i = np.mod(i, period)
        return np.where(i >= n, period - 1 - i, i)
    raise ValueError(f"unknown border {border!r}")


def _inverse_map(m: np.ndarray, h: int, w: int):
    """Source coordinates (float64, each (h, w)) of every destination pixel
    under the 2×3 forward map ``m``: its inverse, formed in double as
    OpenCV's ``warpAffine`` forms it."""
    a00, a01, b0, a10, a11, b1 = (float(v) for v in
                                  np.asarray(m, np.float64).ravel())
    d = a00 * a11 - a01 * a10
    d = 1.0 / d if d != 0.0 else 0.0
    i00, i01, i10, i11 = a11 * d, -a01 * d, -a10 * d, a00 * d
    j0 = -i00 * b0 - i01 * b1
    j1 = -i10 * b0 - i11 * b1
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return i00 * x + i01 * y + j0, i10 * x + i11 * y + j1


def _bilinear_taps(m: np.ndarray, size_hw, src_hw, border: str):
    """The four source indices (flat, into an (H·W, C) view) and the two
    float32 fractions of every destination pixel: what one map costs,
    shared by every array warped with it."""
    h, w = size_hw
    sh, sw = src_hw
    xs, ys = _inverse_map(m, h, w)
    x0f, y0f = np.floor(xs), np.floor(ys)
    fx = (xs - x0f).astype(np.float32).reshape(-1, 1)
    fy = (ys - y0f).astype(np.float32).reshape(-1, 1)
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)
    xa, xb = _border_index(x0, sw, border), _border_index(x0 + 1, sw, border)
    ya, yb = (_border_index(y0, sh, border) * sw,
              _border_index(y0 + 1, sh, border) * sw)
    return ((ya + xa).ravel(), (ya + xb).ravel(), (yb + xa).ravel(),
            (yb + xb).ravel(), fx, fy)


def _apply_taps(img: np.ndarray, taps, size_hw) -> np.ndarray:
    """Bilinear sampling of (H, W) or (H, W, C) ``img`` at ``taps``, in
    float32 with the products accumulated in place (float64 temporaries
    cost more than the gathers), returned in the input's dtype."""
    i00, i01, i10, i11, fx, fy = taps
    src = img.reshape(img.shape[0] * img.shape[1], -1).astype(
        np.float32, copy=False)
    top = src[i00]
    top *= 1.0 - fx
    t = src[i01]
    t *= fx
    top += t
    bot = src[i10]
    bot *= 1.0 - fx
    t = src[i11]
    t *= fx
    bot += t
    top *= 1.0 - fy
    bot *= fy
    top += bot
    return top.astype(img.dtype, copy=False).reshape(tuple(size_hw)
                                                     + img.shape[2:])


def _warp(img: np.ndarray, m: np.ndarray, size_hw, nearest: bool = False,
          border: str = BORDER_REFLECT_101) -> np.ndarray:
    """``warpAffine(img, m, (w, h))``: (H, W) or (H, W, C) → size_hw, in
    the input's dtype.  Every destination pixel samples the source at the
    inverse map, bilinearly (or at the nearest pixel, halves rounded to
    even), with source indices outside the image reflected back in."""
    h, w = size_hw
    sh, sw = img.shape[:2]
    if nearest:
        xs, ys = _inverse_map(m, h, w)
        xi = _border_index(np.rint(xs).astype(np.int64), sw, border)
        yi = _border_index(np.rint(ys).astype(np.int64), sh, border)
        src = img.reshape(sh * sw, -1)
        return src[(yi * sw + xi).ravel()].reshape((h, w) + img.shape[2:])
    return _apply_taps(img, _bilinear_taps(m, size_hw, (sh, sw), border),
                       size_hw)


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``GaussianBlur(img, (k, k), 0)`` for k = 3 or 5: the separable
    binomial kernel along the rows, then the columns, reflect-101 border,
    in the input's dtype."""
    taps = _GAUSS[k]
    r = k // 2
    x = img.astype(np.float64)
    for axis in (1, 0):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r, r)
        xp = np.pad(x, pad, mode="reflect")
        n = x.shape[axis]
        x = sum(t * np.take(xp, np.arange(j, j + n), axis=axis)
                for j, t in enumerate(taps))
    return x.astype(img.dtype)


def _warp_flow(flow: np.ndarray, m: np.ndarray, a: np.ndarray, size_hw,
               taps=None):
    """Resample the flow field and rotate/scale its vectors by A (``taps``:
    the map's, where the caller has them already)."""
    if taps is None:
        taps = _bilinear_taps(m, size_hw, flow.shape[:2], BORDER_REFLECT_101)
    fu = _apply_taps(flow[..., 0], taps, size_hw)
    fv = _apply_taps(flow[..., 1], taps, size_hw)
    return np.stack([a[0, 0] * fu + a[0, 1] * fv,
                     a[1, 0] * fu + a[1, 1] * fv], axis=-1).astype(np.float32)


def reduced_affine(im1, im2, flow, valid, rng: np.random.Generator,
                   skip_prob: float = 0.4):
    """Reduced rotation/zoom/squeeze applied identically to frames + flow."""
    if rng.random() < skip_prob:
        return im1, im2, flow, valid
    h, w = im1.shape[:2]
    rot = rng.uniform(-2.0, 2.0)
    zoom = rng.uniform(0.95, 1.05)
    sx = zoom * rng.uniform(0.97, 1.03)
    sy = zoom * rng.uniform(0.97, 1.03)
    m, a = affine_matrix((w * 0.5, h * 0.5), rot, sx, sy)
    taps = _bilinear_taps(m, (h, w), (h, w), BORDER_REFLECT_101)
    im1 = _apply_taps(im1, taps, (h, w))
    im2 = _apply_taps(im2, taps, (h, w))
    flow = _warp_flow(flow, m, a, (h, w), taps)
    valid = _apply_taps(valid.astype(np.float32), taps, (h, w)) > 0.5
    return im1, im2, flow, valid


def random_crop(arrays, crop_hw: Tuple[int, int], rng: np.random.Generator):
    """Crop all (H, W, ...) arrays at one random window."""
    h, w = arrays[0].shape[:2]
    ch, cw = crop_hw
    y = 0 if h <= ch else int(rng.integers(0, h - ch + 1))
    x = 0 if w <= cw else int(rng.integers(0, w - cw + 1))
    return [arr[y:y + ch, x:x + cw] for arr in arrays]


def hflip(im1, im2, flow, valid):
    """Horizontal flip with u-component negation."""
    im1 = np.ascontiguousarray(im1[:, ::-1])
    im2 = np.ascontiguousarray(im2[:, ::-1])
    flow = np.ascontiguousarray(flow[:, ::-1])
    flow[..., 0] *= -1.0
    valid = np.ascontiguousarray(valid[:, ::-1])
    return im1, im2, flow, valid


class RichAugment:
    """The PWC-paper augmentation pipeline (``data_processing.py:136-279``).

    Operates on uint8-range float images (0..255) like the reference; each
    transform fires with probability 0.5.
    """

    def __init__(self, crop_hw: Tuple[int, int] = (368, 768),
                 augment: bool = True):
        self.crop_hw = crop_hw
        self.augment = augment

    def __call__(self, im1, im2, flow, valid, rng: np.random.Generator):
        im1, im2, flow, valid = random_crop((im1, im2, flow, valid),
                                            self.crop_hw, rng)
        if not self.augment:
            return im1, im2, flow, valid

        if rng.random() < 0.5:
            im1, im2, flow, valid = hflip(im1, im2, flow, valid)

        if rng.random() < 0.5:  # rotation ±17° with vector rotation
            ang = rng.uniform(-17.0, 17.0)
            h, w = im1.shape[:2]
            m, a = affine_matrix((w // 2, h // 2), ang, 1.0, 1.0)
            im1 = _warp(im1, m, (h, w), border=BORDER_REFLECT)
            im2 = _warp(im2, m, (h, w), border=BORDER_REFLECT)
            flow = _warp_flow(flow, m, a, (h, w))
            valid = _warp(valid.astype(np.float32), m, (h, w),
                          border=BORDER_REFLECT) > 0.5

        if rng.random() < 0.5:  # translation ±10 px (both frames alike)
            tx = int(rng.integers(-10, 11))
            ty = int(rng.integers(-10, 11))
            m = np.float32([[1, 0, tx], [0, 1, ty]])
            h, w = im1.shape[:2]
            im1 = _warp(im1, m, (h, w), border=BORDER_REFLECT)
            im2 = _warp(im2, m, (h, w), border=BORDER_REFLECT)
            fu = _warp(flow[..., 0], m, (h, w), border=BORDER_REFLECT)
            fv = _warp(flow[..., 1], m, (h, w), border=BORDER_REFLECT)
            flow = np.stack([fu, fv], axis=-1)
            valid = _warp(valid.astype(np.float32), m, (h, w),
                          border=BORDER_REFLECT) > 0.5

        if rng.random() < 0.5:  # brightness / contrast on 0..255 range
            # bf·cf·(x−127.5)+127.5 is one gain about the center; the
            # reference draws two factors (data_processing.py:238-250), and
            # both draws stay so the distribution and the draw order match
            bf = rng.uniform(0.8, 1.2)
            cf = rng.uniform(0.8, 1.2)
            im1 = np.clip(bf * cf * (im1 - 127.5) + 127.5, 0, 255)
            im2 = np.clip(bf * cf * (im2 - 127.5) + 127.5, 0, 255)

        if rng.random() < 0.5:  # gaussian blur
            k = int(rng.choice((3, 5)))
            im1 = gaussian_blur(im1, k)
            im2 = gaussian_blur(im2, k)

        return im1, im2, flow.astype(np.float32), valid
