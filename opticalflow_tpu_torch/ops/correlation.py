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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["correlation", "correlation_plain"]


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


def correlation(f1: torch.Tensor, f2: torch.Tensor, *, pad_size: int = 4,
                kernel_size: int = 1, max_displacement: int = 4,
                stride1: int = 1, stride2: int = 1,
                use_cuda: bool = True) -> torch.Tensor:
    """Local correlation volume in the input dtype (float32 accumulation).

    The hot configuration on a CUDA tensor goes to the CUDA kernel when
    ``use_cuda``; every other case runs :func:`correlation_plain`."""
    hot = (kernel_size == 1 and stride1 == 1 and stride2 == 1
           and pad_size == max_displacement)
    if use_cuda and hot and f1.is_cuda:
        from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda
        return correlation_cuda(f1.contiguous(), f2.contiguous(),
                                max_displacement=max_displacement)
    out = correlation_plain(f1, f2, pad_size=pad_size,
                            kernel_size=kernel_size,
                            max_displacement=max_displacement,
                            stride1=stride1, stride2=stride2)
    return out.to(f1.dtype)
