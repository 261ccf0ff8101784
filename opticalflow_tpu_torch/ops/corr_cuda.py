"""Wrappers of the hand-written CUDA correlation kernels: the forward
(``csrc/correlation_fwd.cu``), the port of the Pallas kernels
``opticalflow_tpu/ops/pallas_corr.py::_fwd_kernel`` and
``::_fwd_kernel_windowed``, and the backward (``csrc/correlation_bwd.cu``),
the port of the custom_vjp's backward ``pallas_corr.py::_corr_bwd_lax``.

The library is built with ``nvcc`` and bound with ``ctypes`` at the first
call, never at import.  The wrapper checks what the kernel takes, allocates
the output, launches on PyTorch's current stream through the shared launch
path (``ops/_launch.py``) and raises if the launch was refused.
``correlation_cuda.launches`` and ``correlation_bwd_cuda.launches`` count
launches, so a run can show that the main path went through the kernels.

Each kernel's C entry point chooses its tile and channel split per launch;
:func:`launch_plan` and :func:`bwd_launch_plan` report that choice.

Neither wrapper records autograd: a call on tensors that require grad, with
grad enabled, raises.  ``ops.correlation.correlation`` differentiates
through ``CorrelationFn``, whose forward and backward call these two.
"""

from __future__ import annotations

import ctypes

import torch

from opticalflow_tpu_torch.ops._build import load_library
from opticalflow_tpu_torch.ops._launch import (Kernel, needs_grad,
                                               raw_stream)

__all__ = ["correlation_cuda", "correlation_bwd_cuda", "launch_plan",
           "bwd_launch_plan", "SUPPORTED_MD", "BWD_TILES", "BWD_MAX_SPLIT"]

SUPPORTED_MD = (4,)   # the model's max displacement; one instantiation
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_kernel = Kernel("correlation_fwd", "corr_fwd",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8)
_bwd_kernel = Kernel("correlation_bwd", "corr_bwd",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8)
_plan_fns = {}
BWD_TILES = (0, 16, 32)           # the backward's tile widths (0: its choice)
BWD_MAX_SPLIT = 64                # its most channel splits


def _check_bwd_plan(tile, split) -> None:
    """Range checks of a forced backward plan, before any build."""
    if tile not in BWD_TILES or split not in range(BWD_MAX_SPLIT + 1):
        raise ValueError(f"correlation_bwd_cuda takes tile in {BWD_TILES} "
                         f"and split in 0..{BWD_MAX_SPLIT} (0: the kernel "
                         f"chooses), got tile={tile!r} split={split!r}")


def _refuse(name, f1, f2, max_displacement, g=None) -> None:
    """Raise for the first thing kernel ``name`` does not take; the message
    is built here, off the passing path."""
    if not (f1.is_cuda and f2.is_cuda) or f1.device != f2.device:
        raise ValueError(f"{name} needs both inputs on one CUDA "
                         f"device, got {f1.device} and {f2.device}")
    if f1.dtype not in _DTYPE_CODES or f2.dtype != f1.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 inputs "
                        f"of one dtype, got {f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"{name} needs two (B, C, H, W) tensors of "
                         f"one shape, got {tuple(f1.shape)} and "
                         f"{tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError(f"{name} needs contiguous NCHW inputs")
    if max_displacement not in SUPPORTED_MD:
        raise ValueError(f"{name} supports max_displacement in "
                         f"{SUPPORTED_MD}, got {max_displacement}")
    if g is not None:
        b, _, h, w = f1.shape
        if not g.is_cuda or g.device != f1.device or g.dtype != f1.dtype:
            raise TypeError(f"{name} needs the volume's gradient on the "
                            f"inputs' device and in their dtype, got "
                            f"{g.dtype} on {g.device}")
        if tuple(g.shape) != (b, 81, h, w) or not g.is_contiguous():
            raise ValueError(f"{name} needs a contiguous (B, 81, H, W) "
                             f"gradient, got {tuple(g.shape)}")
    if needs_grad(f1, f2, *(() if g is None else (g,))):
        raise RuntimeError(
            f"{name} records no autograd (a forward-only call); call "
            "ops.correlation.correlation(), which differentiates through "
            "CorrelationFn (the forward and the backward kernel), or run "
            "under torch.no_grad()/inference_mode()")
    raise AssertionError(f"{name} refused inputs it should take")


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
        _refuse("correlation_cuda", f1, f2, max_displacement)
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


def correlation_bwd_cuda(f1: torch.Tensor, f2: torch.Tensor,
                         g: torch.Tensor, *, max_displacement: int = 4,
                         tile: int = 0, split: int = 0):
    """Gradients of the hot configuration's correlation volume on the GPU:
    given the forward's inputs f1, f2 and the volume's gradient g, returns
    (d1, d2) = (∂L/∂f1, ∂L/∂f2), the function ``_corr_bwd_lax`` computes.

    f1, f2: contiguous (B, C, H, W) CUDA tensors of one dtype, float32 or
    bfloat16; g: contiguous (B, 81, H, W) in that dtype.  The gradients are
    in that dtype too (float32 accumulation).  ``tile`` (16 or 32 columns)
    and ``split`` (1..64 channel splits) override the kernel's own choice,
    and exist only so the card tests and the sweep can force a plan (both
    tiles, every split count, ragged and empty splits) at small shapes;
    ``CorrelationFn`` and the model pass 0, the kernel's choice, which never
    leaves a split empty."""
    _check_bwd_plan(tile, split)
    dtype = f1.dtype
    code = _DTYPE_CODES.get(dtype)
    shape = f1.shape
    device = f1.device
    if not (code is not None and f2.dtype == dtype and g.dtype == dtype
            and f1.is_cuda and f2.device == device and g.device == device
            and len(shape) == 4 and f2.shape == shape
            and g.shape == (shape[0], 81, shape[2], shape[3])
            and f1.is_contiguous() and f2.is_contiguous()
            and g.is_contiguous() and max_displacement == 4
            and not needs_grad(f1, f2, g)):
        _refuse("correlation_bwd_cuda", f1, f2, max_displacement, g)
    b, c, h, w = shape
    d1 = torch.empty(shape, dtype=dtype, device=device)
    d2 = torch.empty(shape, dtype=dtype, device=device)
    if b == 0 or c == 0 or h == 0 or w == 0:
        return d1, d2
    index = device.index
    fn = _bwd_kernel.fn or _bwd_kernel.load()
    err = fn(f1.data_ptr(), f2.data_ptr(), g.data_ptr(), d1.data_ptr(),
             d2.data_ptr(), b, c, h, w, max_displacement, code, tile, split,
             index, raw_stream(index))
    if err:
        _bwd_kernel.refused(err, index, f"shape {tuple(shape)} {dtype} "
                                        f"tile={tile} split={split}")
    correlation_bwd_cuda.launches += 1
    return d1, d2


correlation_bwd_cuda.launches = 0


def _plan_fn(kernel: Kernel, symbol: str, nargs: int):
    """The C plan entry point ``symbol`` of ``kernel``'s library, bound
    once (the library is built if need be)."""
    fn = _plan_fns.get(symbol)
    if fn is None:
        fn = getattr(load_library(kernel.library), symbol)
        fn.argtypes = [ctypes.c_int] * nargs + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _plan_fns[symbol] = fn
    return fn


def launch_plan(b: int, c: int, h: int, w: int, dtype: torch.dtype, *,
                tile: int = 0, split: int = 0, device_index: int = 0) -> dict:
    """The kernel's choice for a (b, c, h, w) call on that device, without
    launching: tile width, image tiles per batch item, channel split (the
    cluster size), channels per split, threads per block, dynamic shared
    memory per block, and the grid."""
    plan = (ctypes.c_int * 6)()
    err = _plan_fn(_kernel, "corr_fwd_plan", 9)(
        b, c, h, w, 4, _DTYPE_CODES[dtype], tile, split, device_index, plan)
    if err:
        raise ValueError(f"corr_fwd_plan refused ({b}, {c}, {h}, {w}) "
                         f"{dtype} tile={tile} split={split}: cudaError {err}")
    tile_w, tiles, nsplit, cper, threads, smem = plan
    return {"tile": [8, tile_w], "tiles": tiles, "split": nsplit,
            "channels_per_split": cper, "threads": threads,
            "smem_bytes": smem, "grid": [tiles, nsplit, b]}


def bwd_launch_plan(b: int, c: int, h: int, w: int, dtype: torch.dtype, *,
                    tile: int = 0, split: int = 0,
                    device_index: int = 0) -> dict:
    """The backward kernel's choice for a (b, c, h, w) call on that device,
    without launching: tile, image tiles per batch item, channel splits,
    channels per split, threads per block, dynamic shared memory per block,
    the blocks of that kernel an SM holds (the occupancy API's answer, which
    the split rule fills), its registers a thread, and the grid (its last
    axis is 2B: one block of each role per tile, split and batch item).
    ``tile`` and ``split`` force a plan, as in ``correlation_bwd_cuda``."""
    _check_bwd_plan(tile, split)
    plan = (ctypes.c_int * 9)()
    err = _plan_fn(_bwd_kernel, "corr_bwd_plan", 9)(
        b, c, h, w, 4, _DTYPE_CODES[dtype], tile, split, device_index, plan)
    if err:
        raise ValueError(f"corr_bwd_plan refused ({b}, {c}, {h}, {w}) "
                         f"{dtype} tile={tile} split={split}: cudaError {err}")
    th, tw, tiles, nsplit, cper, threads, smem, per_sm, regs = plan
    return {"tile": [th, tw], "tiles": tiles, "split": nsplit,
            "channels_per_split": cper, "threads": threads,
            "smem_bytes": smem, "blocks_per_sm": per_sm, "registers": regs,
            "grid": [tiles, nsplit, 2 * b]}
