"""Gunnar Farneback's dense optical flow as OpenCV computes it, in torch.

The baseline of ``extract_video --mode compare`` (``viz/overlay.opencv_flow``)
for the ``farneback`` and ``lucaskanade_dense`` methods:
:func:`farneback_flow` is ``cv2.calcOpticalFlowFarneback(prev, next, None,
pyr_scale, levels, winsize, iterations, poly_n, poly_sigma, flags=0)``
rebuilt stage by stage against OpenCV 5.0, as torch ops on any device (the
card in the CLI, the CPU in the tests):

  1. the pyramid: at each level the float32 image is blurred with a
     Gaussian of σ = (1/scale − 1)/2, kernel ``round(5σ)|1`` and at least 3
     (σ = 0 at the finest level takes OpenCV's fixed [1/4, 1/2, 1/4]),
     reflect-101 borders, then resized bilinearly from full resolution to
     ``round(size·scale)``; levels under 32 px a side are not built;
  2. the polynomial expansion: a column pass in float32 with the Gaussian
     applicability and its x and x² moments, replicated border rows, then a
     row pass accumulated in double, and OpenCV's inverse of the 6×6 normal
     matrix;
  3. the matrix update: the second image's coefficients sampled bilinearly
     at x + flow (the first image's alone outside the frame), OpenCV's
     border weights within 5 px of the edge;
  4. ``iterations`` rounds of a ``winsize`` box filter (replicated borders)
     and a 2×2 solve per pixel, the determinant regularised by 1e-3 as
     OpenCV does, the matrices updated between rounds;
  5. between levels the flow resized bilinearly to the next level and
     divided by ``pyr_scale``.

Every stage is elementwise arithmetic, gathers and shifted sums: there is
no convolution or matmul, so TF32 never enters, and float32 and float64
are used where OpenCV uses them.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

from opticalflow_tpu_torch.engine import resolve_device
from opticalflow_tpu_torch.io.images import _linear_taps

__all__ = ["farneback_flow", "FARNEBACK_PARAMS"]

# (pyr_scale, levels, winsize, iterations, poly_n, poly_sigma) of the JAX
# package's two Farneback baselines (``opticalflow_tpu/viz/overlay.py``)
FARNEBACK_PARAMS = {
    "farneback": (0.5, 3, 15, 3, 5, 1.2),
    "lucaskanade_dense": (0.5, 5, 13, 10, 5, 1.1),
}

_MIN_SIZE = 32                  # OpenCV's smallest pyramid level side
_BORDER = (0.14, 0.14, 0.4472, 0.4472, 0.4472)
_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25],
                   5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875,
                       0.109375, 0.03125]}


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, CV_32F)`` for σ > 0, or σ ≤ 0
    and an odd ``ksize`` ≤ 7 (OpenCV's fixed small kernels; the pyramid
    needs no other): OpenCV's bit-exact double computation (the taps at
    doubled offsets with exp(−x²/8σ²), normalised by the reciprocal of
    their sum, the centre tap that reciprocal itself) rounded to
    float32."""
    if sigma <= 0:
        if ksize not in _SMALL_GAUSSIAN:
            raise ValueError(f"gaussian_kernel: sigma {sigma} <= 0 needs an "
                             f"odd ksize <= 7, got {ksize}")
        return np.asarray(_SMALL_GAUSSIAN[ksize], np.float32)
    half = (ksize - 1) // 2
    x = np.arange(1 - ksize, 1 - ksize + 2 * half, 2, dtype=np.float64)
    t = np.exp((x * x) * (-0.125 / (sigma * sigma)))
    total = 0.0
    for v in t:
        total += v
    total = total * 2 + 1 + (ksize % 2 == 0)
    mul = 1.0 / total
    side = t * mul
    mid = [mul] * (2 - ksize % 2)
    return np.concatenate([side, mid, side[::-1]]).astype(np.float32)


def _filter_axis(x: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    """Correlate the 2-D float32 ``x`` with the symmetric kernel ``k``
    along ``dim``, reflect-101 borders, float32 sums."""
    r = len(k) // 2
    n = x.shape[dim]
    period = max(2 * (n - 1), 1)
    idx = torch.arange(-r, n + r, device=x.device).abs() % period
    xp = x.index_select(dim, torch.where(idx >= n, period - idx, idx))
    out = xp.narrow(dim, r, n) * float(k[r])
    for i in range(1, r + 1):
        out = out + (xp.narrow(dim, r - i, n)
                     + xp.narrow(dim, r + i, n)) * float(k[r + i])
    return out


def _resize_linear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``cv2.resize`` INTER_LINEAR of float32 (H, W) or (H, W, 2), the
    arithmetic of ``io.images.resize_bilinear_f32`` as torch ops: one
    channel through IPP's rule (double positions, both edges take the
    pixel whole), two channels through OpenCV's own code (float32
    positions, rows clamped into the image)."""
    h, w = x.shape[:2]
    if (h, w) == (height, width):
        return x
    dev = x.device
    out_shape = (height, width) + tuple(x.shape[2:])
    x = x.reshape(h, w, -1)
    ipp = h > 1 and w > 1 and x.shape[2] != 2
    if width != w:
        sx, fx = _linear_taps(w, width, ipp)
        fx = np.where((sx < 0) | (sx >= w - 1), np.float32(0), fx)
        sx = np.clip(sx, 0, w - 1)
        x0 = x[:, torch.from_numpy(sx).to(dev)]
        x1 = x[:, torch.from_numpy(np.minimum(sx + 1, w - 1)).to(dev)]
        t = torch.from_numpy(fx).to(dev)[None, :, None]
        x = ((x1 - x0) * t + x0 if ipp
             else x0 * (1 - t) + x1 * t)
    if height != h:
        sy, fy = _linear_taps(h, height, ipp)
        if ipp:
            fy = np.where((sy < 0) | (sy >= h - 1), np.float32(0), fy)
        y0 = x[torch.from_numpy(np.clip(sy, 0, h - 1)).to(dev)]
        y1 = x[torch.from_numpy(np.clip(sy + 1, 0, h - 1)).to(dev)]
        t = torch.from_numpy(fy).to(dev)[:, None, None]
        x = ((y1 - y0) * t + y0 if ipp
             else y0 * (1 - t) + y1 * t)
    return x.reshape(out_shape)


def pyramid_level(img: torch.Tensor, scale: float) -> torch.Tensor:
    """The float32 image of the level at ``scale``: OpenCV's Gaussian blur
    of the full-resolution image, then its bilinear resize."""
    sigma = (1.0 / scale - 1) * 0.5
    ksize = max(int(round(sigma * 5)) | 1, 3)
    k = gaussian_kernel(ksize, sigma)
    blurred = _filter_axis(_filter_axis(img, k, 1), k, 0)
    h, w = img.shape
    return _resize_linear(blurred, int(round(h * scale)),
                          int(round(w * scale)))


def _poly_kernels(n: int, sigma: float):
    """OpenCV's ``FarnebackPrepareGaussian``: the float32 applicability g,
    x·g and x²·g on [−n, n], and the four entries of the inverse of the
    6×6 normal matrix the expansion needs (double)."""
    if sigma < np.finfo(np.float32).eps:
        sigma = n * 0.3
    x = np.arange(-n, n + 1)
    g = np.exp(-(x * x) / (2 * sigma * sigma)).astype(np.float32)
    g = (g * (1.0 / g.astype(np.float64).sum())).astype(np.float32)
    xg = (x * g).astype(np.float32)
    xxg = (x * x * g).astype(np.float32)
    gd = g.astype(np.float64)
    gg = np.outer(gd, gd)
    xx = (x * x).astype(np.float64)
    G = np.zeros((6, 6))
    G[0, 0] = gg.sum()
    G[1, 1] = (gg * xx[None, :]).sum()
    G[3, 3] = (gg * (xx * xx)[None, :]).sum()
    G[5, 5] = (gg * xx[None, :] * xx[:, None]).sum()
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return g, xg, xxg, (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5])


def _replicate(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    return x.index_select(dim, idx)


def poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """OpenCV's ``FarnebackPolyExp``: (H, W) float32 → (H, W, 5) float32,
    the coefficients in OpenCV's channel order (y, x, yy, xx, xy)."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_kernels(n, sigma)
    h, w = img.shape
    src = _replicate(img, n, 0)
    # the column pass, float32, OpenCV's order of sums
    r0 = src[n:n + h] * float(g[n])
    r1 = torch.zeros_like(r0)
    r2 = torch.zeros_like(r0)
    for k in range(1, n + 1):
        s0, s1 = src[n - k:n - k + h], src[n + k:n + k + h]
        p = s0 + s1
        r0 = r0 + p * float(g[n + k])
        r1 = r1 + (s1 - s0) * float(xg[n + k])
        r2 = r2 + p * float(xxg[n + k])
    r0, r1, r2 = (_replicate(r, n, 1) for r in (r0, r1, r2))

    def at(r, k):
        return r[:, n + k:n + k + w]

    # the row pass: sums of float32 products and pair sums, in double
    f64 = torch.float64
    b1 = (at(r0, 0) * float(g[n])).to(f64)
    b3 = (at(r1, 0) * float(g[n])).to(f64)
    b5 = (at(r2, 0) * float(g[n])).to(f64)
    b2 = torch.zeros_like(b1)
    b4 = torch.zeros_like(b1)
    b6 = torch.zeros_like(b1)
    for k in range(1, n + 1):
        tg = (at(r0, k) + at(r0, -k)).to(f64)
        b1 = b1 + tg * float(g[n + k])
        b4 = b4 + tg * float(xxg[n + k])
        b2 = b2 + ((at(r0, k) - at(r0, -k)) * float(xg[n + k])).to(f64)
        b3 = b3 + ((at(r1, k) + at(r1, -k)) * float(g[n + k])).to(f64)
        b6 = b6 + ((at(r1, k) - at(r1, -k)) * float(xg[n + k])).to(f64)
        b5 = b5 + ((at(r2, k) + at(r2, -k)) * float(g[n + k])).to(f64)
    out = torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                       b1 * ig03 + b4 * ig33, b6 * ig55], dim=-1)
    return out.to(torch.float32)


def _border_scale(n: int, device) -> torch.Tensor:
    """OpenCV's per-row (or column) factor: the border weights within 5 px
    of each edge, 1 elsewhere (float32 products, as OpenCV's)."""
    s = np.ones(n, np.float32)
    for i in range(min(len(_BORDER), n)):
        s[i] *= np.float32(_BORDER[i])
        s[n - 1 - i] *= np.float32(_BORDER[i])
    return torch.from_numpy(s).to(device)


def update_matrices(R0: torch.Tensor, R1: torch.Tensor,
                    flow: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``FarnebackUpdateMatrices``: the (H, W, 5) float32 system
    (G11, G12, G22, h1, h2) of every pixel for the current ``flow``."""
    h, w = flow.shape[:2]
    dev = flow.device
    dx, dy = flow[..., 0], flow[..., 1]
    fx = torch.arange(w, device=dev, dtype=torch.float32)[None, :] + dx
    fy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + dy
    x1, y1 = fx.floor(), fy.floor()
    fx, fy = fx - x1, fy - y1
    x1, y1 = x1.long(), y1.long()
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    xc, yc = x1.clamp(0, max(w - 2, 0)), y1.clamp(0, max(h - 2, 0))
    xc1, yc1 = (xc + 1).clamp(max=w - 1), (yc + 1).clamp(max=h - 1)
    a00, a01 = (1 - fx) * (1 - fy), fx * (1 - fy)
    a10, a11 = (1 - fx) * fy, fx * fy
    p = (a00[..., None] * R1[yc, xc] + a01[..., None] * R1[yc, xc1]
         + a10[..., None] * R1[yc1, xc] + a11[..., None] * R1[yc1, xc1])
    r2 = torch.where(inside, p[..., 0], 0.0)
    r3 = torch.where(inside, p[..., 1], 0.0)
    r4 = torch.where(inside, (R0[..., 2] + p[..., 2]) * 0.5, R0[..., 2])
    r5 = torch.where(inside, (R0[..., 3] + p[..., 3]) * 0.5, R0[..., 3])
    r6 = torch.where(inside, (R0[..., 4] + p[..., 4]) * 0.25,
                     R0[..., 4] * 0.5)
    r2 = (R0[..., 0] - r2) * 0.5
    r3 = (R0[..., 1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    s = _border_scale(h, dev)[:, None] * _border_scale(w, dev)[None, :]
    r2, r3, r4, r5, r6 = (r * s for r in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=-1)


def _box_sum(x: torch.Tensor, m: int, dim: int) -> torch.Tensor:
    """Sum over the window [−m, m] along ``dim``, replicated borders, by a
    float64 prefix sum."""
    n = x.shape[dim]
    c = torch.cumsum(_replicate(x, m, dim), dim)
    zero = torch.zeros_like(c.narrow(dim, 0, 1))
    c = torch.cat([zero, c], dim)
    return c.narrow(dim, 2 * m + 1, n) - c.narrow(dim, 0, n)


def blur_solve(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """OpenCV's ``FarnebackUpdateFlow_Blur`` without the matrix update:
    the ``winsize`` box mean of the system (double sums, replicated
    borders), then the per-pixel 2×2 solve, determinant + 1e-3."""
    m = winsize // 2
    s = _box_sum(_box_sum(M.to(torch.float64), m, 0), m, 1)
    s = s * (1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = s.unbind(-1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet],
                       dim=-1).to(torch.float32)


def farneback_flow(g1: np.ndarray, g2: np.ndarray, *, pyr_scale: float,
                   levels: int, winsize: int, iterations: int, poly_n: int,
                   poly_sigma: float,
                   device: Union[str, torch.device, None] = None
                   ) -> np.ndarray:
    """Dense flow from grey ``g1`` to ``g2`` ((H, W) uint8 or float32), as
    ``cv2.calcOpticalFlowFarneback(g1, g2, None, pyr_scale, levels,
    winsize, iterations, poly_n, poly_sigma, 0)``: (H, W, 2) float32.

    Runs on ``device`` (the card unless the CPU is asked for); a failure
    there raises, nothing falls back."""
    if g1.shape != g2.shape or g1.ndim != 2:
        raise ValueError(f"farneback_flow needs two grey images of one "
                         f"size, got {g1.shape} and {g2.shape}")
    if not 0 < pyr_scale < 1:
        raise ValueError(f"pyr_scale must be in (0, 1), got {pyr_scale}")
    dev = resolve_device(device)
    h, w = g1.shape
    imgs = [torch.from_numpy(np.ascontiguousarray(g, np.float32)).to(dev)
            for g in (g1, g2)]
    n_levels, scale = 0, 1.0
    while n_levels < levels:
        scale *= pyr_scale
        if w * scale < _MIN_SIZE or h * scale < _MIN_SIZE:
            break
        n_levels += 1
    flow = None
    with torch.inference_mode():
        for k in range(n_levels, -1, -1):
            scale = math.prod([pyr_scale] * k) if k else 1.0
            lh, lw = int(round(h * scale)), int(round(w * scale))
            if flow is None:
                flow = torch.zeros((lh, lw, 2), dtype=torch.float32,
                                   device=dev)
            else:
                flow = _resize_linear(flow, lh, lw) * (1.0 / pyr_scale)
            R0, R1 = (poly_exp(pyramid_level(im, scale), poly_n, poly_sigma)
                      for im in imgs)
            M = update_matrices(R0, R1, flow)
            for i in range(iterations):
                flow = blur_solve(M, winsize)
                if i < iterations - 1:
                    M = update_matrices(R0, R1, flow)
        return flow.cpu().numpy()
