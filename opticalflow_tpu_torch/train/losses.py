"""Training losses for the four reference regimes, NCHW.

Counterpart of ``opticalflow_tpu.train.losses`` (the reference's
``train.py``, ``train2.py``, ``train_pseudo.py`` and
``train_fundamental.py``), with the same semantics in the port's layout:
flows are (B, 2, H, W) with channel 0 = u, images (B, 3, H, W), masks
(B, H, W).

  * masked Charbonnier EPE (supervised fine-tune, ``train.py:31-48``);
  * multiscale supervised loss, GT bilinearly downsampled (half-pixel, no
    antialiasing) with vector rescale and the mask by torch's nearest rule,
    weights [0.32, 0.08, 0.02, 0.01, 0.005], optional photometric and
    edge-aware smoothness terms (``train2.py:124-167``);
  * proxy-label self-supervised loss, 0.85·SSIM + 0.15·L1 of the
    border-padded align_corners=True warp + 0.1 first-order smoothness
    (``train_pseudo.py:65-164``), with an optional photometric mask (the
    epipolar-filtered regime's hook).

Under data parallelism each rank holds a shard of the batch, and the JAX
step's masked means divide by the GLOBAL batch's count.  The masked losses
take ``denominator``, a callable that turns this rank's count into
(the global count, the number of ranks); the rank's term is then its
numerator over the global count times the number of ranks, so that the
mean over the ranks (the gradient average) is the global masked mean.
Plain means need nothing: the shards are equal.  Without it the losses are
the single-process ones, bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from opticalflow_tpu_torch.ops.warp import bilinear_warp

__all__ = ["charbonnier_epe", "multiscale_supervised_loss", "ssim",
           "photometric_l1", "proxy_photometric_loss",
           "smoothness_first_order", "edge_aware_smoothness",
           "proxy_label_loss", "epe_loss", "MULTISCALE_WEIGHTS"]

MULTISCALE_WEIGHTS = (0.32, 0.08, 0.02, 0.01, 0.005)

# this rank's count of a masked mean → (the global count, the number of ranks)
Denominator = Callable[[torch.Tensor], Tuple[torch.Tensor, int]]


def _masked_mean(num: torch.Tensor, count: torch.Tensor,
                 denominator: Optional[Denominator], *,
                 floor: Optional[float] = None,
                 eps: float = 0.0) -> torch.Tensor:
    """num / count, the count clamped at ``floor`` or offset by ``eps`` as
    the single-process loss does it; with ``denominator``, over the global
    count and scaled by the number of ranks (module docstring)."""
    ranks = 1
    if denominator is not None:
        count, ranks = denominator(count)
    out = num / (count.clamp(min=floor) if floor is not None
                 else count + eps)
    return out if denominator is None else out * ranks


def _vec_scale(flow: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Scale u by sx and v by sy (channels 0 and 1)."""
    s = torch.tensor([sx, sy], dtype=flow.dtype, device=flow.device)
    return flow * s.view(2, 1, 1)


def charbonnier_epe(pred: torch.Tensor, gt: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    eps: float = 1e-3,
                    denominator: Optional[Denominator] = None
                    ) -> torch.Tensor:
    """Masked Charbonnier endpoint error: mean over valid pixels of
    sqrt(‖pred−gt‖² + eps²)."""
    e = torch.sqrt(((pred - gt) ** 2).sum(dim=-3) + eps * eps)
    if valid is None:
        return e.mean()
    v = (valid > 0.5).to(e.dtype)
    return _masked_mean((e * v).sum(), v.sum(), denominator, floor=1.0)


def epe_loss(pred: torch.Tensor, gt: torch.Tensor,
             valid: Optional[torch.Tensor] = None,
             denominator: Optional[Denominator] = None) -> torch.Tensor:
    """Plain mean EPE (the train-time metric, ``train2.py:100-112``)."""
    e = torch.sqrt(((pred - gt) ** 2).sum(dim=-3))
    if valid is None:
        return e.mean()
    v = valid.to(e.dtype)
    return _masked_mean((e * v).sum(), v.sum(), denominator, eps=1e-8)


def smoothness_first_order(flow: torch.Tensor) -> torch.Tensor:
    """mean |∂u/∂x| + mean |∂u/∂y| over both flow channels."""
    dx = (flow[..., :, :-1] - flow[..., :, 1:]).abs()
    dy = (flow[..., :-1, :] - flow[..., 1:, :]).abs()
    return dx.mean() + dy.mean()


def edge_aware_smoothness(flow: torch.Tensor,
                          image: torch.Tensor) -> torch.Tensor:
    """First-order smoothness weighted by exp(−|∇image|)
    (``train2.py:80-97``)."""
    fdx = (flow[..., :, :-1] - flow[..., :, 1:]).abs()
    fdy = (flow[..., :-1, :] - flow[..., 1:, :]).abs()
    idx = (image[..., :, :-1] - image[..., :, 1:]).abs().mean(dim=-3,
                                                              keepdim=True)
    idy = (image[..., :-1, :] - image[..., 1:, :]).abs().mean(dim=-3,
                                                              keepdim=True)
    return (fdx * torch.exp(-idx)).mean() + (fdy * torch.exp(-idy)).mean()


def photometric_l1(im1: torch.Tensor, im2_warped: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   denominator: Optional[Denominator] = None
                   ) -> torch.Tensor:
    """L1 photometric loss, optionally masked ((B, H, W) mask)."""
    diff = (im1 - im2_warped).abs()
    if mask is None:
        return diff.mean()
    m = mask.unsqueeze(-3)
    return _masked_mean((diff * m).sum(), mask.sum() * im1.shape[-3],
                        denominator, eps=1e-8)


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 average pool with the zero padding counted in the mean
    (``avg_pool2d(3, 1, 1)``, count_include_pad=True, as the reference SSIM,
    ``train_pseudo.py:87-99``)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _ssim_map(x: torch.Tensor, y: torch.Tensor, c1: float = 0.01 ** 2,
              c2: float = 0.03 ** 2) -> torch.Tensor:
    """Per-pixel clamp((1 − SSIM)/2, 0, 1)."""
    mu_x = _avg_pool3(x)
    mu_y = _avg_pool3(y)
    sig_x = _avg_pool3(x * x) - mu_x ** 2
    sig_y = _avg_pool3(y * y) - mu_y ** 2
    sig_xy = _avg_pool3(x * y) - mu_x * mu_y
    s = ((2 * mu_x * mu_y + c1) * (2 * sig_xy + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (sig_x + sig_y + c2))
    return ((1.0 - s) / 2.0).clamp(0.0, 1.0)


def ssim(x: torch.Tensor, y: torch.Tensor, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """SSIM-based loss term: mean of clamp((1 − SSIM)/2, 0, 1)."""
    return _ssim_map(x, y, c1, c2).mean()


def proxy_photometric_loss(im1: torch.Tensor,
                           im2_warped: torch.Tensor) -> torch.Tensor:
    """0.85·SSIM + 0.15·L1 (``train_pseudo.py:77-85``)."""
    return 0.85 * ssim(im1, im2_warped) + 0.15 * (im2_warped - im1).abs(
    ).mean()


def _flow_to_image_res(flow: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """align_corners=True upsample + vector rescale
    (``train_pseudo.py:195-208``)."""
    h, w = flow.shape[-2:]
    if (h, w) == (height, width):
        return flow
    up = resize_bilinear(flow, height, width, align_corners=True)
    return _vec_scale(up, width / float(w), height / float(h))


def proxy_label_loss(flow: torch.Tensor, im1: torch.Tensor,
                     im2: torch.Tensor, alpha_photo: float = 1.0,
                     alpha_smooth: float = 0.1,
                     photo_mask: Optional[torch.Tensor] = None,
                     denominator: Optional[Denominator] = None):
    """Self-supervised proxy-label loss (``train_pseudo.py:65-164``).

    ``flow`` may be at reduced resolution: it is upsampled to the image
    size with vector rescale; im2 is backward-warped with border padding
    and align_corners=True semantics.  ``photo_mask`` (optional, (B, H, W))
    restricts the photometric term (``train_fundamental.py:102-163``).

    Returns (total, photometric, smoothness)."""
    h, w = im1.shape[-2:]
    flow_full = _flow_to_image_res(flow, h, w)
    im2_warped = bilinear_warp(im2, flow_full, padding="border")
    if photo_mask is None:
        photo = proxy_photometric_loss(im1, im2_warped)
    else:
        m = photo_mask.unsqueeze(-3)
        count = photo_mask.sum() * im1.shape[-3]
        l1 = _masked_mean(((im2_warped - im1).abs() * m).sum(), count,
                          denominator, eps=1e-8)
        # masked SSIM: weight the per-pixel SSIM map before the reduction
        ssim_v = _masked_mean((_ssim_map(im1, im2_warped) * m).sum(), count,
                              denominator, eps=1e-8)
        photo = 0.85 * ssim_v + 0.15 * l1
    smooth = smoothness_first_order(flow_full)
    total = alpha_photo * photo + alpha_smooth * smooth
    return total, photo, smooth


def multiscale_supervised_loss(
        flow_preds: Sequence[torch.Tensor], gt_flow: torch.Tensor,
        valid: torch.Tensor, *, weights: Sequence[float] = MULTISCALE_WEIGHTS,
        images: Optional[torch.Tensor] = None, lambda_photo: float = 0.0,
        lambda_smooth: float = 0.0,
        denominator: Optional[Denominator] = None) -> torch.Tensor:
    """Supervised multiscale loss (``train2.py:124-167``).

    flow_preds: (flow2..flow6) finest first, each (B, 2, h, w) in the
    network's own units; gt_flow (B, 2, H, W) full-resolution pixels; valid
    (B, H, W); images (B, 6, H, W) for the optional terms.  The GT is
    downsampled to each prediction's size with vector division by the scale
    factor; the mask by torch's nearest rule."""
    bh, bw = gt_flow.shape[-2:]
    total = 0.0
    for i, pred in enumerate(flow_preds):
        h, w = pred.shape[-2:]
        gt_s = resize_bilinear(gt_flow, h, w, align_corners=False)
        gt_s = _vec_scale(gt_s, w / float(bw), h / float(bh))
        mask_s = resize_nearest(valid.unsqueeze(1).float(), h, w)[:, 0]
        lvl = charbonnier_epe(pred, gt_s, mask_s, denominator=denominator)
        if images is not None and (lambda_photo > 0.0 or lambda_smooth > 0.0):
            im1_s = resize_bilinear(images[:, :3], h, w)
            im2_s = resize_bilinear(images[:, 3:], h, w)
            if lambda_photo > 0.0:
                warped = bilinear_warp(im2_s, pred)
                lvl = lvl + lambda_photo * photometric_l1(
                    im1_s, warped, mask_s, denominator=denominator)
            if lambda_smooth > 0.0:
                lvl = lvl + lambda_smooth * edge_aware_smoothness(pred, im1_s)
        wi = weights[i] if i < len(weights) else weights[-1]
        total = total + wi * lvl
    return total
