"""Wrapper of the hand-written CUDA correlation kernel
(``csrc/correlation_fwd.cu``), the port of the Pallas kernels
``opticalflow_tpu/ops/pallas_corr.py::_fwd_kernel`` and
``::_fwd_kernel_windowed``.

The library is built with ``nvcc`` and bound with ``ctypes`` at the first
call, never at import.  The wrapper checks what the kernel takes, allocates
the output, launches on PyTorch's current stream and raises if the launch
was refused.  ``correlation_cuda.launches`` counts launches, so a run can
show that the main path went through the kernel.

This is a forward only: the backward (ROADMAP Queue 2) is not written yet,
so a call on tensors that require grad raises instead of returning a
volume autograd cannot differentiate.
"""

from __future__ import annotations

import ctypes

import torch

from opticalflow_tpu_torch.ops._build import load_library

__all__ = ["correlation_cuda", "SUPPORTED_MD"]

SUPPORTED_MD = (4,)   # the model's max displacement; one instantiation
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load_library("correlation_fwd").corr_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, *,
                     max_displacement: int = 4) -> torch.Tensor:
    """Correlation volume of the hot configuration (k=1, strides 1,
    pad = max_displacement) on the GPU.

    f1, f2: contiguous (B, C, H, W) CUDA tensors of one dtype, float32 or
    bfloat16.  Returns (B, (2·md+1)², H, W) in that dtype."""
    if not (f1.is_cuda and f2.is_cuda) or f1.device != f2.device:
        raise ValueError("correlation_cuda needs both inputs on one CUDA "
                         f"device, got {f1.device} and {f2.device}")
    if f1.dtype not in _DTYPE_CODES or f2.dtype != f1.dtype:
        raise TypeError("correlation_cuda takes float32 or bfloat16 inputs "
                        f"of one dtype, got {f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError("correlation_cuda needs two (B, C, H, W) tensors of "
                         f"one shape, got {tuple(f1.shape)} and "
                         f"{tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation_cuda needs contiguous NCHW inputs")
    if max_displacement not in SUPPORTED_MD:
        raise ValueError(f"correlation_cuda supports max_displacement in "
                         f"{SUPPORTED_MD}, got {max_displacement}")
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        raise RuntimeError(
            "correlation_cuda is forward-only (its backward is ROADMAP "
            "Queue 2 item 3); run under torch.no_grad()/inference_mode()")
    b, c, h, w = f1.shape
    nd = 2 * max_displacement + 1
    out = torch.empty((b, nd * nd, h, w), dtype=f1.dtype, device=f1.device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w,
                 max_displacement, _DTYPE_CODES[f1.dtype], stream)
    if err != 0:
        raise RuntimeError(f"correlation_fwd launch failed: cudaError {err} "
                           f"at shape {tuple(f1.shape)} {f1.dtype}")
    correlation_cuda.launches += 1
    return out


correlation_cuda.launches = 0
