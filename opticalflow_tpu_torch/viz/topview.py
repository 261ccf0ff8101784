"""Top-view perspective warp + dominant-direction flow visualization.

The port's counterpart of ``opticalflow_tpu.viz.topview`` (itself the
reference ``topview.py``): warp each frame to a top-down view through a
fixed trapezoid→rectangle homography (``topview.py:57-76``), run flow on
the warped frames, take the mean flow direction over the pixels above a
threshold (``:122-134``), and draw arrows red or white by <30° agreement
with it (``:137-178``).  The JAX package warps with OpenCV on the host;
here the host warp is bit-exact to ``cv2.warpPerspective``:

  * :func:`perspective_matrix` solves OpenCV's 8×8 system
    (``getPerspectiveTransform``: float32 products in the matrix, then
    Gaussian elimination with partial pivoting in double, in OpenCV's
    order);
  * :func:`warp_topview` maps each output pixel through the inverse in
    float32 with OpenCV 5's fused multiply-adds and interpolates in
    float32, zero outside the frame (``BORDER_CONSTANT``), in host C++
    (``runtime/flowviz.cpp``).

Divergences from the reference (as in the JAX package): the preset is
configurable, and the quarter-res flow is upsampled with its vectors
rescaled.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from opticalflow_tpu_torch.runtime import flowviz
from opticalflow_tpu_torch.viz.overlay import draw_arrows_batch

__all__ = ["perspective_matrix", "get_perspective_transform", "warp_topview",
           "dominant_direction",
           "draw_direction_arrows"]

def _solve_lu(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OpenCV's LU solve (``hal::LU64f``): elimination with partial
    pivoting, the pivot's negated reciprocal as multiplier, then back
    substitution by that reciprocal, scalar by scalar in double."""
    a = [list(map(float, row)) for row in a]
    b = list(map(float, b))
    m = len(b)
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < np.finfo(np.float64).eps * 10:
            raise np.linalg.LinAlgError("singular perspective system")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for c in range(i + 1, m):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
        a[i][i] = -d
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i][c] * b[c]
        b[i] = s * a[i][i]
    return np.array(b, np.float64)


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3×3 homography taking 4 float32 ``src`` points to ``dst``, as
    ``cv2.getPerspectiveTransform`` builds and solves it."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    a = np.zeros((8, 8), np.float64)
    b = np.zeros(8, np.float64)
    for i in range(4):
        sx, sy = src[i]
        dx, dy = dst[i]
        a[i, 0] = a[i + 4, 3] = sx
        a[i, 1] = a[i + 4, 4] = sy
        a[i, 2] = a[i + 4, 5] = 1.0
        # float32 products, as OpenCV multiplies two Point2f coordinates
        a[i, 6] = -(sx * dx)
        a[i, 7] = -(sy * dx)
        a[i + 4, 6] = -(sx * dy)
        a[i + 4, 7] = -(sy * dy)
        b[i] = dx
        b[i + 4] = dy
    return np.append(_solve_lu(a, b), 1.0).reshape(3, 3)


def perspective_matrix(width: int, height: int) -> np.ndarray:
    """Side-cam trapezoid → top-view rectangle homography (3×3)."""
    src = np.float32([
        [width * 0.2, height * 0.8], [width * 0.8, height * 0.8],
        [width * 0.3, height * 0.4], [width * 0.7, height * 0.4]])
    dst = np.float32([
        [width * 0.2, height * 0.9], [width * 0.8, height * 0.9],
        [width * 0.2, height * 0.1], [width * 0.8, height * 0.1]])
    return get_perspective_transform(src, dst)


# OpenCV 5 warps 16 output columns at a time with vector code and the
# columns past the last full 16 with scalar code; the two round differently
SIMD_COLUMNS = 16


def warp_topview(frame: np.ndarray,
                 matrix: Optional[np.ndarray] = None) -> np.ndarray:
    """``cv2.warpPerspective(frame, matrix, (w, h))`` (INTER_LINEAR, zero
    border) on a uint8 (H, W, C) frame, bit-exact to OpenCV 5, by the
    host C++ of ``runtime/flowviz``.  OpenCV inverts the matrix in double
    (:func:`_invert3`) and then works in float32: the source point is
    ``(X / W, Y / W)`` with ``X = fma(x, M0, y*M1 + M2)`` in its vector
    columns and ``fma(x, M0, y*M1) + M2`` in the scalar ones past them;
    its floor, and fractions ``a``, ``b``; the four taps (0 outside the
    frame) blend as ``fma(a, p01 - p00, p00)`` along x, then along y,
    rounded half to even."""
    h, w = frame.shape[:2]
    if matrix is None:
        matrix = perspective_matrix(w, h)
    return flowviz.warp_perspective_native(frame, _invert3(matrix),
                                           SIMD_COLUMNS)


def _invert3(m: np.ndarray) -> np.ndarray:
    """``cv::invert`` of a 3×3 double matrix (DECOMP_LU): the adjugate
    over the determinant, in OpenCV's closed form and order."""
    m = np.asarray(m, np.float64).reshape(3, 3).tolist()
    d = (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
         - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
         + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))
    if d == 0.0:
        raise np.linalg.LinAlgError("singular perspective matrix")
    d = 1.0 / d
    return np.array([
        (m[1][1] * m[2][2] - m[1][2] * m[2][1]) * d,
        (m[0][2] * m[2][1] - m[0][1] * m[2][2]) * d,
        (m[0][1] * m[1][2] - m[0][2] * m[1][1]) * d,
        (m[1][2] * m[2][0] - m[1][0] * m[2][2]) * d,
        (m[0][0] * m[2][2] - m[0][2] * m[2][0]) * d,
        (m[0][2] * m[1][0] - m[0][0] * m[1][2]) * d,
        (m[1][0] * m[2][1] - m[1][1] * m[2][0]) * d,
        (m[0][1] * m[2][0] - m[0][0] * m[2][1]) * d,
        (m[0][0] * m[1][1] - m[0][1] * m[1][0]) * d]).reshape(3, 3)


def dominant_direction(flow: np.ndarray,
                       threshold: float = 1.0) -> np.ndarray:
    """Mean (u, v) over pixels with |flow| > threshold; zeros if none."""
    mag = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    mask = mag > threshold
    if not mask.any():
        return np.zeros(2, np.float32)
    return flow[mask].mean(axis=0)


def draw_direction_arrows(frame_bgr: np.ndarray, flow: np.ndarray, *,
                          step: int = 20, scale: float = 5.0,
                          dominant: Optional[np.ndarray] = None,
                          angle_threshold_deg: float = 30.0,
                          min_mag: float = 0.5) -> np.ndarray:
    """Arrows of thickness 2, red within ``angle_threshold_deg`` of the
    dominant direction, white otherwise, in the per-point loop's grid
    order (later arrows over earlier ones where red and white overlap)."""
    out = np.ascontiguousarray(frame_bgr).copy()
    h, w = frame_bgr.shape[:2]
    dom = None
    if dominant is not None and np.linalg.norm(dominant) > 0:
        dom = dominant / np.linalg.norm(dominant)
    cos_thr = np.cos(np.deg2rad(angle_threshold_deg))
    ys, xs = np.mgrid[0:h:step, 0:w:step]
    fx = flow[ys, xs, 0].astype(np.float64).ravel()
    fy = flow[ys, xs, 1].astype(np.float64).ravel()
    x = xs.ravel().astype(np.float64)
    y = ys.ravel().astype(np.float64)
    mag = np.hypot(fx, fy)
    keep = mag >= min_mag
    x, y, fx, fy, mag = x[keep], y[keep], fx[keep], fy[keep], mag[keep]
    if len(x) == 0:  # every arrow below min_mag — nothing to draw
        return out
    p0 = np.stack([x, y], axis=1)
    # int() truncation toward zero, as the per-point loop did
    p1 = np.stack([np.trunc(x + fx * scale), np.trunc(y + fy * scale)], axis=1)
    white = (np.zeros(len(x), bool) if dom is None
             else (fx * dom[0] + fy * dom[1]) / mag < cos_thr)
    # one batch per same-colour run, keeping the loop's draw order
    bounds = np.flatnonzero(np.diff(white))
    for lo, hi in zip(np.r_[0, bounds + 1], np.r_[bounds + 1, len(white)]):
        color = (255, 255, 255) if white[lo] else (0, 0, 255)
        draw_arrows_batch(out, p0[lo:hi], p1[lo:hi], color, thickness=2)
    return out
