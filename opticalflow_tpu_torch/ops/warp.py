"""Bilinear backward warping with validity mask (NCHW).

Counterpart of ``opticalflow_tpu.ops.warp``, written as the reference
writes it (``models/PWCNet.py:141-177``): the flow is added to an integer
mesh grid, normalised with ``2*p/max(dim-1,1) - 1`` (the align_corners=True
convention), and sampled by ``F.grid_sample`` with its torch-2.x default
``align_corners=False`` and zero padding.  The effective sample point for
target ``p = x + u`` is therefore ``p * W / max(W-1, 1) - 0.5``, and zero
flow is not an exact identity.  The validity mask is ``grid_sample`` of
ones, binarised with ``>=`` at 0.9999 (current PWCDCNet) or 0.999 (the
_old variant, ``models/PWCNet.py:401``).

Sampling runs in float32 whatever the input dtype: the 0.9999 threshold is
below bf16 resolution, and the JAX package keeps its weights in float32 too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["warp_with_mask", "bilinear_warp"]


def _normalised_grid(flow: torch.Tensor) -> torch.Tensor:
    """(B, 2, H, W) pixel flow → (B, H, W, 2) grid_sample grid, normalised
    with (dim - 1) like the reference."""
    _, _, h, w = flow.shape
    flow = flow.float()
    xx = torch.arange(w, dtype=torch.float32, device=flow.device)
    yy = torch.arange(h, dtype=torch.float32, device=flow.device)
    gx = 2.0 * (xx.view(1, 1, w) + flow[:, 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (yy.view(1, h, 1) + flow[:, 1]) / max(h - 1, 1) - 1.0
    return torch.stack((gx, gy), dim=3)


def warp_with_mask(x: torch.Tensor, flow: torch.Tensor,
                   mask_threshold: float = 0.9999) -> torch.Tensor:
    """Backward-warp ``x`` (B, C, H, W) by ``flow`` (B, 2, H, W) and zero the
    samples whose bilinear footprint leaves the image.  Returns float32."""
    grid = _normalised_grid(flow)
    out = F.grid_sample(x.float(), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    ones = torch.ones((x.shape[0], 1) + tuple(x.shape[2:]),
                      dtype=torch.float32, device=x.device)
    mask = F.grid_sample(ones, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)
    return out * (mask >= mask_threshold).float()


def bilinear_warp(x: torch.Tensor, flow: torch.Tensor,
                  padding: str = "zeros") -> torch.Tensor:
    """Mask-free bilinear warp of the photometric losses: align_corners=True,
    so the sample point is exactly ``p = x + u`` (``train2.py:44-61``
    "zeros", ``train_pseudo.py:128-164`` "border").  Returns float32.

    Sampled in pixel space as the JAX ``grid_sample`` does, not through
    ``F.grid_sample``: "border" clamps the point with max/min, whose
    gradient is 1/2 where the point lies exactly on the edge, as JAX's
    ``jnp.clip``; ``F.grid_sample`` gives 0 there.  A near-zero flow at
    the last row or column rounds onto the edge in float32, so the two
    gradients differ there."""
    if padding not in ("zeros", "border"):
        raise ValueError(f"padding must be 'zeros' or 'border', got "
                         f"{padding!r}")
    b, c, h, w = x.shape
    flow = flow.float()
    xs = torch.arange(w, dtype=torch.float32, device=x.device) + flow[:, 0]
    ys = (torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
          + flow[:, 1])
    if padding == "border":
        zero = xs.new_zeros(())
        xs = torch.minimum(torch.maximum(xs, zero), zero + (w - 1))
        ys = torch.minimum(torch.maximum(ys, zero), zero + (h - 1))
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx, wy = xs - x0, ys - y0
    x0, y0 = x0.long(), y0.long()
    img = x.float().reshape(b, c, h * w)
    out = 0.0
    for dy, dx, wt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                       (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, -1)
        v = img.gather(2, idx.expand(b, c, -1)).reshape(b, c, h, w)
        out = out + v * (wt * inside)[:, None]
    return out
