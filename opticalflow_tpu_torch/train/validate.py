"""No-ground-truth validation metrics for self-supervised training.

Counterpart of ``opticalflow_tpu.train.validate``, the proxy-quality signals
of the reference (``train_pseudo.py:177-233``,
``train_fundamental.py:503-536``):

  * photometric error of the warped pair;
  * forward–backward cycle consistency: ‖flow12 + warp(flow21, flow12)‖;
  * out-of-bounds ratio: the share of sample points that leave the frame.
"""

from __future__ import annotations

from typing import Dict

import torch

from opticalflow_tpu_torch.ops.warp import bilinear_warp
from opticalflow_tpu_torch.train.losses import (_flow_to_image_res,
                                                proxy_photometric_loss)
from opticalflow_tpu_torch.train.trainer import batch_to_device

__all__ = ["selfsup_metrics"]


def selfsup_metrics(model, images, flow_scale: float = 1.0
                    ) -> Dict[str, torch.Tensor]:
    """images: (B, H, W, 6) in the JAX batch layout (numpy or tensor),
    moved to the model's device.  Runs the model on both frame orders under
    ``torch.no_grad()``; returns 0-d tensors ``photometric``, ``fb_cycle``
    and ``oob_ratio``."""
    device = next(model.parameters()).device
    x = batch_to_device({"images": images}, device)["images"]
    im1, im2 = x[:, :3], x[:, 3:]
    h, w = x.shape[-2:]
    with torch.no_grad():
        flow12 = model(x) * flow_scale
        flow21 = model(torch.cat([im2, im1], dim=1)) * flow_scale
        f12 = _flow_to_image_res(flow12, h, w)
        f21 = _flow_to_image_res(flow21, h, w)

        warped2 = bilinear_warp(im2, f12, padding="border")
        photo = proxy_photometric_loss(im1, warped2)

        # the backward flow sampled at the forward-displaced positions
        # should cancel the forward flow (train_pseudo.py:177-193)
        f21_warped = bilinear_warp(f21, f12, padding="border")
        cycle = (f12 + f21_warped).abs().mean()

        # out-of-bounds share of the forward sample points
        # (train_pseudo.py:209-233)
        xs = torch.arange(w, dtype=torch.float32,
                          device=device).view(1, 1, w) + f12[:, 0]
        ys = torch.arange(h, dtype=torch.float32,
                          device=device).view(1, h, 1) + f12[:, 1]
        oob = (xs < 0) | (xs > w - 1) | (ys < 0) | (ys > h - 1)
    return {"photometric": photo, "fb_cycle": cycle,
            "oob_ratio": oob.float().mean()}
