"""Local cost-volume correlation (NCHW): the plain PyTorch version and the
dispatcher to the hand-written CUDA kernel.

Semantics of the reference's CUDA extension
(``correlation_cuda_kernel.cu:73-147``, glue ``correlation_cuda.cc:10-87``),
as ``opticalflow_tpu.ops.correlation.correlation_lax`` implements them:

  * both inputs are zero-padded by ``pad_size`` (plus the kernel radius, so
    a ``pad_size`` below ``kernel_radius + max_displacement`` reads zeros
    where the CUDA extension read out of bounds);
  * output channel ``tc = (tj + D) * (2D+1) + (ti + D)`` with
    ``D = max_displacement // stride2``, displacement applied to input 2;
  * each value is the channel-MEAN of the products over a ``kernel_size²``
    window, ``acc / (k*k*C)``.  The reference's ONNX fallback
    (``correlation.py:12-17``) sums instead; the shipped weights were trained
    with the CUDA mean, so that is what is computed here;
  * output size ``ceil((dim + 2*pad - 2*(kernel_radius + md)) / stride1)``.

:func:`correlation` sends the PWC-Net hot configuration (k=1,
stride1=stride2=1, pad=md) on a CUDA tensor to the kernel in
``corr_cuda``; everything else, and every CPU tensor, runs
:func:`correlation_plain`.  There is no fallback from the kernel: on a CUDA
tensor the hot configuration launches it or raises.

Where autograd must record (grad enabled and an input requires grad) the
hot configuration goes through :class:`CorrelationFn`: its forward is the
kernel (CUDA) or :func:`correlation_plain` (CPU), its backward the
backward kernel (CUDA) or :func:`correlation_bwd_plain` (CPU), the gather
form of the JAX package's ``pallas_corr.py::_corr_bwd_lax``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

__all__ = ["correlation", "correlation_plain", "correlation_bwd_plain",
           "CorrelationFn"]


def _out_dim(dim: int, pad: int, kernel_radius: int, md: int,
             stride1: int) -> int:
    return -(-(dim + 2 * pad - 2 * (kernel_radius + md)) // stride1)


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, *,
                      pad_size: int = 4, kernel_size: int = 1,
                      max_displacement: int = 4, stride1: int = 1,
                      stride2: int = 1) -> torch.Tensor:
    """Plain PyTorch correlation volume, float32 accumulation.

    f1, f2: (B, C, H, W).  Returns float32 (B, (2D+1)², Ho, Wo)."""
    b, c, h, w = f1.shape
    kr = (kernel_size - 1) // 2
    disp = max_displacement // stride2
    ho = _out_dim(h, pad_size, kr, max_displacement, stride1)
    wo = _out_dim(w, pad_size, kr, max_displacement, stride1)
    p = pad_size + kr
    f1p = F.pad(f1.float(), (p, p, p, p))
    f2p = F.pad(f2.float(), (p, p, p, p))
    inv_nelems = 1.0 / (kernel_size * kernel_size * c)
    span_h = (ho - 1) * stride1 + 1
    span_w = (wo - 1) * stride1 + 1

    outs = []
    for tj in range(-disp, disp + 1):
        for ti in range(-disp, disp + 1):
            acc = 0.0
            for j in range(-kr, kr + 1):
                for i in range(-kr, kr + 1):
                    y1 = kr + max_displacement + j
                    x1 = kr + max_displacement + i
                    y2 = y1 + tj * stride2
                    x2 = x1 + ti * stride2
                    a = f1p[:, :, y1:y1 + span_h:stride1,
                            x1:x1 + span_w:stride1]
                    bb = f2p[:, :, y2:y2 + span_h:stride1,
                             x2:x2 + span_w:stride1]
                    acc = acc + (a * bb).sum(dim=1)
            outs.append(acc * inv_nelems)
    return torch.stack(outs, dim=1)


def correlation_bwd_plain(f1: torch.Tensor, f2: torch.Tensor,
                          g: torch.Tensor, *, max_displacement: int = 4):
    """Plain PyTorch backward of the hot configuration (k=1, strides 1,
    pad = max_displacement): the gather form of ``_corr_bwd_lax``, float32
    accumulation, no scatters.

    f1, f2: (B, C, H, W); g: (B, (2·md+1)², H, W), the volume's gradient.
    Returns (d1, d2) in the dtypes of f1 and f2:
    ``d1 = Σ_d g_d · shift_d(f2) / C``, ``d2 = Σ_d shift_{−d}(g_d · f1) / C``,
    zero outside the image."""
    b, c, h, w = f1.shape
    md = max_displacement
    pad = (md, md, md, md)
    gf = g.float()
    f2p = F.pad(f2.float(), pad)
    f1p = F.pad(f1.float(), pad)
    gp = F.pad(gf, pad)
    d1 = torch.zeros_like(f1, dtype=torch.float32)
    d2 = torch.zeros_like(f2, dtype=torch.float32)
    k = 0
    for tj in range(-md, md + 1):
        for ti in range(-md, md + 1):
            f2s = f2p[:, :, md + tj:md + tj + h, md + ti:md + ti + w]
            d1 = d1 + gf[:, k:k + 1] * f2s
            gshift = gp[:, k:k + 1, md - tj:md - tj + h,
                        md - ti:md - ti + w]
            f1shift = f1p[:, :, md - tj:md - tj + h, md - ti:md - ti + w]
            d2 = d2 + gshift * f1shift
            k += 1
    inv_c = 1.0 / c
    return (d1 * inv_c).to(f1.dtype), (d2 * inv_c).to(f2.dtype)


class CorrelationFn(torch.autograd.Function):
    """The hot configuration's correlation volume, differentiable: forward
    by the CUDA kernel (CUDA tensors) or :func:`correlation_plain` (CPU),
    backward by the backward kernel or :func:`correlation_bwd_plain`.  The
    volume is in the inputs' dtype; f1 and f2 are saved for the backward.

    ``CorrelationFn.apply(f1, f2, max_displacement)``."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement):
        f1 = f1.contiguous()
        f2 = f2.contiguous()
        ctx.save_for_backward(f1, f2)
        ctx.md = max_displacement
        if f1.is_cuda:
            from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda
            return correlation_cuda(f1, f2,
                                    max_displacement=max_displacement)
        return correlation_plain(f1, f2, pad_size=max_displacement,
                                 max_displacement=max_displacement
                                 ).to(f1.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        if f1.is_cuda:
            from opticalflow_tpu_torch.ops.corr_cuda import \
                correlation_bwd_cuda
            d1, d2 = correlation_bwd_cuda(f1, f2, g.contiguous(),
                                          max_displacement=ctx.md)
        else:
            d1, d2 = correlation_bwd_plain(f1, f2, g,
                                           max_displacement=ctx.md)
        return d1, d2, None


def correlation(f1: torch.Tensor, f2: torch.Tensor, *, pad_size: int = 4,
                kernel_size: int = 1, max_displacement: int = 4,
                stride1: int = 1, stride2: int = 1,
                use_cuda: bool = True) -> torch.Tensor:
    """Local correlation volume in the input dtype (float32 accumulation).

    The hot configuration on a CUDA tensor goes to the CUDA kernel when
    ``use_cuda``; every other case runs :func:`correlation_plain`.  Where
    autograd must record, the hot configuration goes through
    :class:`CorrelationFn` (the two kernels on a CUDA tensor when
    ``use_cuda``, the plain versions on the CPU); with ``use_cuda=False``
    autograd differentiates :func:`correlation_plain` itself."""
    hot = (kernel_size == 1 and stride1 == 1 and stride2 == 1
           and pad_size == max_displacement)
    if (hot and (use_cuda or not f1.is_cuda)
            and torch.is_grad_enabled()
            and (f1.requires_grad or f2.requires_grad)):
        return CorrelationFn.apply(f1, f2, max_displacement)
    if use_cuda and hot and f1.is_cuda:
        from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda
        return correlation_cuda(f1.contiguous(), f2.contiguous(),
                                max_displacement=max_displacement)
    out = correlation_plain(f1, f2, pad_size=pad_size,
                            kernel_size=kernel_size,
                            max_displacement=max_displacement,
                            stride1=stride1, stride2=stride2)
    return out.to(f1.dtype)
