"""Wrapper of the hand-written CUDA correlation kernel
(``csrc/correlation_fwd.cu``), the port of the Pallas kernels
``opticalflow_tpu/ops/pallas_corr.py::_fwd_kernel`` and
``::_fwd_kernel_windowed``.

The library is built with ``nvcc`` and bound with ``ctypes`` at the first
call, never at import.  The wrapper checks what the kernel takes, allocates
the output, launches on PyTorch's current stream through the shared launch
path (``ops/_launch.py``) and raises if the launch was refused.
``correlation_cuda.launches`` counts launches, so a run can show that the
main path went through the kernel.

The kernel's C entry point chooses the tile and the channel split per
launch; :func:`launch_plan` reports that choice.

This is a forward only: the backward (ROADMAP Queue 2) is not written yet,
so a call on tensors that require grad raises instead of returning a
volume autograd cannot differentiate.
"""

from __future__ import annotations

import ctypes

import torch

from opticalflow_tpu_torch.ops._build import load_library
from opticalflow_tpu_torch.ops._launch import (Kernel, needs_grad,
                                               raw_stream)

__all__ = ["correlation_cuda", "launch_plan", "SUPPORTED_MD"]

SUPPORTED_MD = (4,)   # the model's max displacement; one instantiation
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_kernel = Kernel("correlation_fwd", "corr_fwd",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8)
_plan_fn = None


def _refuse(f1, f2, max_displacement) -> None:
    """Raise for the first thing the kernel does not take; the message is
    built here, off the passing path."""
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
    if needs_grad(f1, f2):
        raise RuntimeError(
            "correlation_cuda is forward-only (its backward is ROADMAP "
            "Queue 2 item 3); run under torch.no_grad()/inference_mode()")
    raise AssertionError("correlation_cuda refused inputs it should take")


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, *,
                     max_displacement: int = 4, tile: int = 0,
                     split: int = 0) -> torch.Tensor:
    """Correlation volume of the hot configuration (k=1, strides 1,
    pad = max_displacement) on the GPU.

    f1, f2: contiguous (B, C, H, W) CUDA tensors of one dtype, float32 or
    bfloat16.  Returns (B, (2·md+1)², H, W) in that dtype.  ``tile`` (16 or
    32 columns) and ``split`` (1..8 channel splits) override the kernel's
    own choice; 0 leaves it to the kernel."""
    dtype = f1.dtype
    code = _DTYPE_CODES.get(dtype)
    shape = f1.shape
    device = f1.device
    if not (code is not None and f2.dtype == dtype and f1.is_cuda
            and f2.device == device and len(shape) == 4
            and f2.shape == shape and f1.is_contiguous()
            and f2.is_contiguous() and max_displacement == 4
            and not needs_grad(f1, f2)):
        _refuse(f1, f2, max_displacement)
    b, c, h, w = shape
    out = torch.empty(b, 81, h, w, dtype=dtype, device=device)
    if b == 0 or c == 0 or h == 0 or w == 0:
        return out
    index = device.index
    fn = _kernel.fn or _kernel.load()
    err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w,
             max_displacement, code, tile, split, index, raw_stream(index))
    if err:
        _kernel.refused(err, index, f"shape {tuple(shape)} {dtype} "
                                    f"tile={tile} split={split}")
    correlation_cuda.launches += 1
    return out


correlation_cuda.launches = 0


def launch_plan(b: int, c: int, h: int, w: int, dtype: torch.dtype, *,
                tile: int = 0, split: int = 0, device_index: int = 0) -> dict:
    """The kernel's choice for a (b, c, h, w) call on that device, without
    launching: tile width, image tiles per batch item, channel split (the
    cluster size), channels per split, threads per block, dynamic shared
    memory per block, and the grid."""
    global _plan_fn
    if _plan_fn is None:
        fn = load_library(_kernel.library).corr_fwd_plan   # built if need be
        fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _plan_fn = fn
    plan = (ctypes.c_int * 6)()
    err = _plan_fn(b, c, h, w, 4, _DTYPE_CODES[dtype], tile, split,
                   device_index, plan)
    if err:
        raise ValueError(f"corr_fwd_plan refused ({b}, {c}, {h}, {w}) "
                         f"{dtype} tile={tile} split={split}: cudaError {err}")
    tile_w, tiles, nsplit, cper, threads, smem = plan
    return {"tile": [8, tile_w], "tiles": tiles, "split": nsplit,
            "channels_per_split": cper, "threads": threads,
            "smem_bytes": smem, "grid": [tiles, nsplit, b]}
