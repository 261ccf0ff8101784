"""Epipolar geometry filtering for self-supervised flow, in torch.

The port's copy of ``opticalflow_tpu.geometry.epipolar``: estimate a
fundamental matrix from the predicted flow with the normalized 8-point
algorithm inside RANSAC over Sampson distances, then build a per-pixel
inlier mask (absolute threshold ``tau`` ∧ ``keep_ratio``-quantile, relaxed to
``min_keep`` if too sparse) that gates the photometric loss; plus the
optional soft Sampson penalty (``train_fundamental.py:169-382``).

Every RANSAC hypothesis is an independent 9×9 problem: all of them go
through one batched ``torch.linalg.svd`` on the flow's device, the winner
is an argmax, and the refit is a weighted 8-point solve over the winner's
inliers.  Hypotheses are drawn without replacement from an explicit
``torch.Generator``; ``sample_idx`` takes them from the caller instead (the
parity tests feed the JAX package's own draws).

Flows are channel-first, as everywhere in the port: (2, H, W) for one
sample, (B, 2, H, W) for a batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["flow_to_pairs", "eight_point_fundamental", "sampson_distance",
           "ransac_fundamental", "epipolar_mask_and_f", "sampson_penalty"]


def _grid(h: int, w: int, stride: int, device) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    ys = torch.arange(0, h, stride, device=device)
    xs = torch.arange(0, w, stride, device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


def _homogeneous(flow: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor):
    """Correspondences (N, 3), (N, 3): each grid pixel and where ``flow``
    (2, H, W) moves it."""
    u = gx.reshape(-1).to(flow.dtype)
    v = gy.reshape(-1).to(flow.dtype)
    du = flow[0][gy, gx].reshape(-1)
    dv = flow[1][gy, gx].reshape(-1)
    ones = torch.ones_like(u)
    return (torch.stack([u, v, ones], dim=1),
            torch.stack([u + du, v + dv, ones], dim=1))


def flow_to_pairs(flow: torch.Tensor, stride: int = 4
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(2, H, W) flow → homogeneous correspondences (N, 3), (N, 3) sampled
    on a stride grid (``train_fundamental.py:169-193``)."""
    gy, gx = _grid(flow.shape[1], flow.shape[2], stride, flow.device)
    return _homogeneous(flow, gy, gx)


def _normalize_points(x: torch.Tensor, wgt: Optional[torch.Tensor] = None):
    """Hartley normalization (mean → 0, mean radius → √2) of (..., N, 3)
    points, optionally weighted so masked-out rows don't move the frame.
    Returns the normalized points and the (..., 3, 3) transform."""
    if wgt is None:
        wgt = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    wsum = wgt.sum(-1) + 1e-12                                   # (...)
    mean = (x[..., :2] * wgt[..., None]).sum(-2) / wsum[..., None]
    xc = x[..., :2] - mean[..., None, :]
    md = (torch.sqrt((xc ** 2).sum(-1) + 1e-24) * wgt).sum(-1) / wsum
    s = math.sqrt(2.0) / (md + 1e-12)
    t = torch.zeros(x.shape[:-2] + (3, 3), dtype=x.dtype, device=x.device)
    t[..., 0, 0] = s
    t[..., 1, 1] = s
    t[..., 0, 2] = -s * mean[..., 0]
    t[..., 1, 2] = -s * mean[..., 1]
    t[..., 2, 2] = 1.0
    return x @ t.transpose(-1, -2), t


def eight_point_fundamental(x1: torch.Tensor, x2: torch.Tensor,
                            weights: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Normalized 8-point fundamental matrix from (..., N, 3) homogeneous
    correspondences, one per leading index; ``weights`` (..., N)
    soft-select rows (0 rows drop out of the SVD)."""
    x1n, t1 = _normalize_points(x1, weights)
    x2n, t2 = _normalize_points(x2, weights)
    u, v = x1n[..., 0], x1n[..., 1]
    up, vp = x2n[..., 0], x2n[..., 1]
    a = torch.stack([u * up, v * up, up, vp * u, vp * v, vp, u, v,
                     torch.ones_like(u)], dim=-1)
    if weights is not None:
        a = a * weights[..., None]
    # full_matrices=True is required: for the minimal N=8 case A is (8, 9)
    # and the null vector is the 9th row of Vh, which the reduced SVD
    # leaves out (its last row is a row-space vector, not a solution of
    # Af = 0)
    vh = torch.linalg.svd(a, full_matrices=True).Vh
    f = vh[..., -1, :].reshape(vh.shape[:-2] + (3, 3))
    # rank-2 projection
    uu, ss, vvt = torch.linalg.svd(f)
    ss = torch.cat([ss[..., :2], torch.zeros_like(ss[..., 2:])], dim=-1)
    f = (uu * ss[..., None, :]) @ vvt
    f = t2.transpose(-1, -2) @ f @ t1
    # normalize like the reference: by f22 when safe, else by Frobenius norm
    f22 = f[..., 2, 2]
    denom = torch.where(f22.abs() > 1e-12, f22,
                        torch.linalg.matrix_norm(f) + 1e-12)
    return f / denom[..., None, None]


def sampson_distance(f: torch.Tensor, x1: torch.Tensor,
                     x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance of (N, 3) points under one
    (3, 3) or a batch (..., 3, 3) of fundamental matrices → (..., N); the
    points may carry the batch's leading dimensions too."""
    fx1 = x1 @ f.transpose(-1, -2)
    ftx2 = x2 @ f
    x2fx1 = (x2 * fx1).sum(-1)
    denom = (fx1[..., 0] ** 2 + fx1[..., 1] ** 2
             + ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2 + 1e-12)
    return x2fx1 ** 2 / denom


def _draw(n: int, iters: int, min_samples: int,
          generator: Optional[torch.Generator], device) -> torch.Tensor:
    """``iters`` draws of ``min_samples`` distinct indices in [0, n): the
    ``min_samples`` largest of n uniform keys per row."""
    keys = torch.rand(iters, n, generator=generator, device=device)
    return keys.topk(min_samples, dim=1).indices


def ransac_fundamental(x1: torch.Tensor, x2: torch.Tensor,
                       generator: Optional[torch.Generator] = None, *,
                       iters: int = 256, thresh: float = 0.5,
                       min_samples: int = 8,
                       sample_idx: Optional[torch.Tensor] = None):
    """Batched-hypothesis RANSAC: returns (F, inlier_mask, best_count).

    All ``iters`` minimal 8-point solves run as one batched SVD; the best
    hypothesis (most Sampson inliers, the first on a tie) is refit on its
    inliers with a weighted 8-point solve.  ``sample_idx`` (iters,
    min_samples) gives the hypotheses' rows in place of draws from
    ``generator`` (on ``x1``'s device)."""
    if sample_idx is None:
        sample_idx = _draw(x1.shape[0], iters, min_samples, generator,
                           x1.device)
    sample_idx = sample_idx.to(x1.device)
    fs = eight_point_fundamental(x1[sample_idx], x2[sample_idx])
    inl = sampson_distance(fs, x1, x2) < thresh          # (iters, N)
    counts = inl.sum(1)
    best = torch.argmax(counts)
    best_mask = inl[best]
    f_ref = eight_point_fundamental(x1, x2, best_mask.to(x1.dtype))
    return f_ref, best_mask, counts[best]


def epipolar_mask_and_f(flow: torch.Tensor,
                        generator: Optional[torch.Generator] = None, *,
                        tau: float = 1.0, stride: int = 4,
                        keep_ratio: float = 0.2, min_keep: float = 0.05,
                        iters: int = 256, thresh: float = 0.5,
                        min_samples: int = 8,
                        sample_idx: Optional[torch.Tensor] = None):
    """(2, H, W) flow → ((H, W) bool keep-mask, (3, 3) fundamental matrix).

    Threshold = min(tau, keep_ratio-quantile of the Sampson map), relaxed to
    the min_keep quantile when the mask would fall below that coverage
    (``train_fundamental.py:258-325``).  When RANSAC finds fewer than
    ``min_samples`` inliers the mask is all-True (the reference's failure
    fallback).  ``torch.quantile`` takes at most 2**24 pixels and raises
    beyond that.
    """
    h, w = flow.shape[1:]
    x1s, x2s = flow_to_pairs(flow, stride)
    f, _, count = ransac_fundamental(x1s, x2s, generator, iters=iters,
                                     thresh=thresh, min_samples=min_samples,
                                     sample_idx=sample_idx)
    x1, x2 = _homogeneous(flow, *_grid(h, w, 1, flow.device))
    d = sampson_distance(f, x1, x2).reshape(h, w)

    thr = torch.clamp(torch.quantile(d, keep_ratio), max=tau)
    keep = d <= thr
    # relax when coverage < min_keep: the relaxed threshold must NOT be
    # re-clamped by tau — coverage can only fall below min_keep when
    # tau < quantile(d, min_keep), so min(tau, .) would reproduce the
    # original mask and starve the photometric loss
    thr_relaxed = torch.quantile(d, min_keep)
    keep = torch.where(keep.float().mean() < min_keep, d <= thr_relaxed,
                       keep)
    # RANSAC failure → keep everything
    keep = torch.where(count < min_samples, torch.ones_like(keep), keep)
    return keep, f


def sampson_penalty(flow: torch.Tensor, f: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    robust: str = "huber", delta: float = 1.0
                    ) -> torch.Tensor:
    """Soft epipolar consistency penalty on a (B, 2, H, W) flow batch with
    per-sample (B, 3, 3) fundamental matrices
    (``train_fundamental.py:330-382``, applied with weight ``epi_soft_w``);
    ``valid`` (B, H, W) restricts it.  ``robust``: "huber", "l1" or
    anything else for the plain distance."""
    b, _, h, w = flow.shape
    gy, gx = _grid(h, w, 1, flow.device)
    gx = gx.reshape(-1).to(flow.dtype)
    gy = gy.reshape(-1).to(flow.dtype)
    ones = torch.ones_like(gx)
    x1 = torch.stack([gx, gy, ones], dim=1)                   # (HW, 3)
    fl = flow.reshape(b, 2, h * w)
    x2 = torch.stack([gx + fl[:, 0], gy + fl[:, 1],
                      ones.expand(b, -1)], dim=-1)            # (B, HW, 3)
    d = sampson_distance(f, x1, x2).reshape(b, h, w)
    m = ((valid > 0.5).to(d.dtype) if valid is not None
         else torch.ones_like(d))
    if robust == "huber":
        r = torch.sqrt(d + 1e-12)
        v = torch.where(r <= delta, 0.5 * r * r / delta, r - 0.5 * delta)
    elif robust == "l1":
        v = torch.sqrt(d + 1e-12)
    else:
        v = d
    return (v * m).sum() / (m.sum() + 1e-12)
