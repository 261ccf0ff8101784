"""Bilinear / nearest resizing of NCHW images and flow fields.

Counterpart of ``opticalflow_tpu.ops.resize``.  Both interpolation
conventions of the reference matter for parity:

  * half-pixel (``align_corners=False``) — ``F.interpolate`` in
    ``upsample_flow_to`` (``data_processing_or.py:300-310``) and cv2.resize
    in the canonical CLI (``script_pwc.py:76-81``);
  * ``align_corners=True`` — ``flow_resize`` in ``inference_kitti.py:83-91``
    and the loss-side resizes (``train2.py:129-141``).

Flow tensors are (B, 2, H, W) with channel 0 = u (x) and 1 = v (y).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear", "upsample_flow_to", "flow_resize",
           "resize_nearest", "upsample_flow_2x"]


def resize_bilinear(x: torch.Tensor, height: int, width: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (height, width), no antialiasing
    in either direction (torch ``F.interpolate`` / cv2 INTER_LINEAR)."""
    if x.shape[-2:] == (height, width):
        return x
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=align_corners)


def _scale_vectors(out: torch.Tensor, sy: float, sx: float) -> torch.Tensor:
    scale = torch.tensor([sx, sy], dtype=out.dtype, device=out.device)
    return out * scale.view(1, 2, 1, 1)


def upsample_flow_to(flow: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """Resize (B, 2, h, w) flow half-pixel and rescale the vectors, cloning
    ``data_processing_or.py:300-310``."""
    h, w = flow.shape[-2:]
    out = resize_bilinear(flow, height, width, align_corners=False)
    return _scale_vectors(out, height / float(h), width / float(w))


def flow_resize(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize flow with align_corners=True + vector rescale, cloning
    ``inference_kitti.py:83-91``."""
    h, w = flow.shape[-2:]
    if (h, w) == (height, width):
        return flow
    out = resize_bilinear(flow, height, width, align_corners=True)
    return _scale_vectors(out, height / float(h), width / float(w))


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Nearest-neighbour resize with torch's asymmetric index rule
    ``src = floor(dst * in/out)`` (validity masks in the multiscale loss,
    ``train2.py:135``)."""
    if x.shape[-2:] == (height, width):
        return x
    return F.interpolate(x, size=(height, width), mode="nearest")


def upsample_flow_2x(flow: torch.Tensor) -> torch.Tensor:
    """2× flow upsampling with vector doubling (multiscale-loss helper)."""
    h, w = flow.shape[-2:]
    return upsample_flow_to(flow, 2 * h, 2 * w)
