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

__all__ = ["resize_bilinear", "resize_linear_antialiased",
           "upsample_flow_to", "flow_resize", "resize_nearest",
           "upsample_flow_2x"]


def resize_bilinear(x: torch.Tensor, height: int, width: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (height, width), no antialiasing
    in either direction (torch ``F.interpolate`` / cv2 INTER_LINEAR)."""
    if x.shape[-2:] == (height, width):
        return x
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=align_corners)


def _triangle_weights(n_in: int, n_out: int,
                      device: torch.device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of a half-pixel linear resize of one
    axis: a triangle filter, widened by the shrink factor where the axis
    shrinks, each column renormalised to sum 1 (so edges clamp)."""
    inv_scale = n_in / n_out
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    dist = (pos[None, :] - src[:, None]).abs() / max(inv_scale, 1.0)
    w = (1.0 - dist).clamp(min=0.0)
    return w / w.sum(0, keepdim=True)


def resize_linear_antialiased(x: torch.Tensor, height: int,
                              width: int) -> torch.Tensor:
    """Half-pixel linear resize of (B, C, H, W) that antialiases where it
    shrinks a side, as ``jax.image.resize(method="linear")`` computes it:
    one weight matrix per axis (:func:`_triangle_weights`), applied
    separably in float32.  Where a side grows this is plain bilinear.

    ``F.interpolate(..., antialias=True)`` computes the same function but
    is not used: on the CPU it returns wrong values when the output width
    is 1 and the height changes (torch 2.13, NCHW-contiguous input)."""
    h, w = x.shape[-2:]
    if (h, w) == (height, width):
        return x
    wy = _triangle_weights(h, height, x.device)
    wx = _triangle_weights(w, width, x.device)
    return torch.einsum("bchw,hy,wx->bcyx", x.float(), wy, wx)


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
