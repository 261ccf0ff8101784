"""Fused masked warp + correlation, ``corr(f1, warp_with_mask(f2, flow))``:
the plain PyTorch version, the wrapper of the hand-written CUDA kernel
(``csrc/fused_warp_corr.cu``) and the dispatcher.

The kernel is the port of the Pallas probe kernel
``scripts/probe_fused_warpcorr.py::_fused_kernel``, and :func:`prep_gather`
of its XLA-side precompute ``_prep_gather`` (without the md-row padding).
Layouts are NCHW: f1, f2 (B, C, H, W) float32 or bfloat16, flow
(B, 2, H, W) float32, out (B, 81, H, W) in f1's dtype with channel
``tj·9 + ti``, as :func:`~opticalflow_tpu_torch.ops.correlation.correlation`.

:func:`fused_warp_corr_plain` computes the kernel's formulation step by
step (sample points, folded corner weights, a four-corner gather in
float32, then :func:`correlation_plain`), so the CPU tests check the
kernel's math against the JAX package.  :func:`fused_warp_corr` sends a CPU
tensor to it and a CUDA tensor to :func:`fused_warp_corr_cuda`, which
launches the kernel or raises; ``fused_warp_corr_cuda.launches`` counts
launches.  The kernel is forward only, like the TPU kernel it replaces.

The kernel's C entry point chooses the tile and the channel split per
launch; :func:`launch_plan` reports that choice, and ``tile=``/``split=``
force it.  They steer the kernel only: the plain version has neither, so
:func:`fused_warp_corr` raises if they are given with CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from opticalflow_tpu_torch.ops._build import load_library
from opticalflow_tpu_torch.ops._launch import (Kernel, needs_grad,
                                               raw_stream)
from opticalflow_tpu_torch.ops.correlation import correlation_plain

__all__ = ["prep_gather", "fused_warp_corr", "fused_warp_corr_plain",
           "fused_warp_corr_cuda", "launch_plan", "MD", "TILES",
           "MAX_SPLIT"]

MD = 4    # max displacement: the model's, and the kernel's only one
TILES = (0, 16, 32)   # tile widths to force; 0: the kernel chooses
MAX_SPLIT = 8         # most channel splits (the portable cluster size)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_kernel = Kernel("fused_warp_corr", "fused_warp_corr",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 2)
_plan_fn = None
_SPLITS = range(MAX_SPLIT + 1)


def prep_gather(flow: torch.Tensor, h: int, w: int,
                mask_threshold: float = 0.9999):
    """Sample points and folded bilinear weights of the masked warp.

    flow (B, 2, h, w) → ``(x0, y0, wv)``: the int32 top-left corner
    (B, h, w) of each sample point ``xs = (x+u)·(w/max(w-1,1)) - 0.5`` (and
    likewise ys), and float32 weights (B, 4, h, w) of the corners (y0, x0),
    (y0, x0+1), (y0+1, x0), (y0+1, x0+1), each zeroed where its corner lies
    outside the image and all four zeroed where their sum is below
    ``mask_threshold``.  Every step is one float32 operation in the order
    the kernel does it."""
    u = flow[:, 0].float()
    v = flow[:, 1].float()
    xx = torch.arange(w, dtype=torch.float32, device=flow.device)
    yy = torch.arange(h, dtype=torch.float32, device=flow.device)
    xs = (xx.view(1, 1, w) + u) * (w / max(w - 1, 1)) - 0.5
    ys = (yy.view(1, h, 1) + v) * (h / max(h - 1, 1)) - 0.5
    xf = torch.floor(xs)
    yf = torch.floor(ys)
    wx = xs - xf
    wy = ys - yf
    x0 = xf.int()
    y0 = yf.int()
    vx0 = (x0 >= 0) & (x0 <= w - 1)
    vx1 = (x0 >= -1) & (x0 <= w - 2)
    vy0 = (y0 >= 0) & (y0 <= h - 1)
    vy1 = (y0 >= -1) & (y0 <= h - 2)
    wv = torch.stack([(1 - wy) * (1 - wx) * (vy0 & vx0),
                      (1 - wy) * wx * (vy0 & vx1),
                      wy * (1 - wx) * (vy1 & vx0),
                      wy * wx * (vy1 & vx1)], dim=1)
    total = wv[:, 0] + wv[:, 1] + wv[:, 2] + wv[:, 3]
    return x0, y0, wv * (total >= mask_threshold).unsqueeze(1)


def _warp_gathered(f2: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                   wv: torch.Tensor) -> torch.Tensor:
    """Four-corner gather of f2 (B, C, H, W) in float32, weighted by wv:
    the warped tensor, float32 (B, C, H, W)."""
    b, c, h, w = f2.shape
    flat = f2.float().reshape(b, c, h * w)
    x0 = x0.long()
    y0 = y0.long()
    # corners clamped into the image (their weight is 0 where clamped)
    xs = (x0.clamp(0, w - 1), x0.clamp(-1, w - 2) + 1)
    ys = (y0.clamp(0, h - 1), y0.clamp(-1, h - 2) + 1)
    warped = None
    for k, (yk, xk) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        lin = (ys[yk] * w + xs[xk]).reshape(b, 1, h * w).expand(b, c, h * w)
        term = wv[:, k].reshape(b, 1, h * w) * flat.gather(2, lin)
        warped = term if warped is None else warped + term
    return warped.reshape(b, c, h, w)


def fused_warp_corr_plain(f1: torch.Tensor, f2: torch.Tensor,
                          flow: torch.Tensor, *,
                          mask_threshold: float = 0.9999) -> torch.Tensor:
    """Plain PyTorch ``corr(f1, warp_with_mask(f2, flow))`` in the kernel's
    formulation; float32 throughout, the result cast to f1's dtype."""
    _, _, h, w = f1.shape
    x0, y0, wv = prep_gather(flow, h, w, mask_threshold)
    warped = _warp_gathered(f2, x0, y0, wv)
    out = correlation_plain(f1, warped, pad_size=MD, max_displacement=MD)
    return out.to(f1.dtype)


def _check_plan(tile, split) -> None:
    if tile not in TILES or split not in _SPLITS:
        raise ValueError(f"fused_warp_corr takes tile in {TILES} and split "
                         f"in 0..{MAX_SPLIT} (0: the kernel chooses), got "
                         f"tile={tile!r} split={split!r}")


def _refuse(f1, f2, flow, tile, split) -> None:
    """Raise for the first thing the kernel does not take; the message is
    built here, off the passing path."""
    _check_plan(tile, split)
    tensors = (f1, f2, flow)
    if not all(t.is_cuda for t in tensors) or len(
            {t.device for t in tensors}) != 1:
        raise ValueError("fused_warp_corr_cuda needs f1, f2 and flow on one "
                         f"CUDA device, got {[t.device for t in tensors]}")
    if f1.dtype not in _DTYPE_CODES or f2.dtype != f1.dtype:
        raise TypeError("fused_warp_corr_cuda takes float32 or bfloat16 "
                        f"features of one dtype, got {f1.dtype} and "
                        f"{f2.dtype}")
    if flow.dtype != torch.float32:
        raise TypeError(f"fused_warp_corr_cuda takes a float32 flow, got "
                        f"{flow.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape or tuple(flow.shape) != (
            f1.shape[0], 2) + tuple(f1.shape[2:]):
        raise ValueError("fused_warp_corr_cuda needs f1, f2 (B, C, H, W) and "
                         f"flow (B, 2, H, W), got {tuple(f1.shape)}, "
                         f"{tuple(f2.shape)} and {tuple(flow.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_warp_corr_cuda needs contiguous NCHW inputs")
    if needs_grad(*tensors):
        raise RuntimeError(
            "fused_warp_corr_cuda is forward-only, like the TPU kernel it "
            "replaces; run under torch.no_grad()/inference_mode()")
    raise AssertionError("fused_warp_corr_cuda refused inputs it should take")


def fused_warp_corr_cuda(f1: torch.Tensor, f2: torch.Tensor,
                         flow: torch.Tensor, *,
                         mask_threshold: float = 0.9999, tile: int = 0,
                         split: int = 0) -> torch.Tensor:
    """The CUDA kernel.  f1, f2: contiguous (B, C, H, W) CUDA tensors of one
    dtype, float32 or bfloat16; flow: contiguous float32 (B, 2, H, W) on the
    same device.  Returns (B, 81, H, W) in f1's dtype.  ``tile`` (16 or 32
    columns) and ``split`` (1..8 channel splits) override the kernel's own
    choice; 0 leaves it to the kernel."""
    dtype = f1.dtype
    code = _DTYPE_CODES.get(dtype)
    shape = f1.shape
    device = f1.device
    if not (tile in TILES and split in _SPLITS
            and code is not None and f2.dtype == dtype
            and flow.dtype is torch.float32 and f1.is_cuda
            and f2.device == device and flow.device == device
            and len(shape) == 4 and f2.shape == shape
            and flow.shape == (shape[0], 2, shape[2], shape[3])
            and f1.is_contiguous() and f2.is_contiguous()
            and flow.is_contiguous() and not needs_grad(f1, f2, flow)):
        _refuse(f1, f2, flow, tile, split)
    b, c, h, w = shape
    out = torch.empty(b, 81, h, w, dtype=dtype, device=device)
    if b == 0 or c == 0 or h == 0 or w == 0:
        return out
    index = device.index
    fn = _kernel.fn or _kernel.load()
    err = fn(f1.data_ptr(), f2.data_ptr(), flow.data_ptr(), out.data_ptr(),
             b, c, h, w, MD, code, mask_threshold, tile, split, index,
             raw_stream(index))
    if err:
        _kernel.refused(err, index, f"shape {tuple(shape)} {dtype} "
                                    f"tile={tile} split={split}")
    fused_warp_corr_cuda.launches += 1
    return out


fused_warp_corr_cuda.launches = 0


def launch_plan(b: int, c: int, h: int, w: int, dtype: torch.dtype, *,
                tile: int = 0, split: int = 0, device_index: int = 0) -> dict:
    """The kernel's choice for a (b, c, h, w) call on that device, without
    launching: tile width, image tiles per batch item, channel split (the
    cluster size), channels per split, threads per block, dynamic shared
    memory per block, and the grid."""
    global _plan_fn
    _check_plan(tile, split)
    if _plan_fn is None:
        # built if need be
        fn = load_library(_kernel.library).fused_warp_corr_plan
        fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _plan_fn = fn
    plan = (ctypes.c_int * 6)()
    err = _plan_fn(b, c, h, w, MD, _DTYPE_CODES[dtype], tile, split,
                   device_index, plan)
    if err:
        raise ValueError(f"fused_warp_corr_plan refused ({b}, {c}, {h}, {w}) "
                         f"{dtype} tile={tile} split={split}: cudaError {err}")
    tile_w, tiles, nsplit, cper, threads, smem = plan
    return {"tile": [8, tile_w], "tiles": tiles, "split": nsplit,
            "channels_per_split": cper, "threads": threads,
            "smem_bytes": smem, "grid": [tiles, nsplit, b]}


def fused_warp_corr(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                    *, mask_threshold: float = 0.9999, tile: int = 0,
                    split: int = 0) -> torch.Tensor:
    """``corr(f1, warp_with_mask(f2, flow, mask_threshold))``: the kernel on
    a CUDA tensor, the plain version on a CPU tensor.  ``tile`` and ``split``
    force the kernel's plan; the plain version has none, so with CPU tensors
    anything but 0 raises rather than being dropped."""
    if f1.is_cuda:
        return fused_warp_corr_cuda(f1, f2, flow,
                                    mask_threshold=mask_threshold, tile=tile,
                                    split=split)
    if tile or split:
        raise ValueError("tile= and split= steer the CUDA kernel only; the "
                         f"tensors are on {f1.device} (got tile={tile!r} "
                         f"split={split!r})")
    return fused_warp_corr_plain(f1, f2, flow, mask_threshold=mask_threshold)
