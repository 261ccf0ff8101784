"""Row gather ``out[i] = x[idx[i]]``: the plain PyTorch version, the wrapper
of the hand-written CUDA kernel (``csrc/row_gather.cu``) and the dispatcher.

The kernel is the port of the Pallas probe kernels
``scripts/probe_gather.py::k_take`` / ``k_takealong`` / ``k_loop``.  Both
versions follow ``jnp.take(x, idx, axis=0)``: an index in [-N, 0) counts
from the end, and any other index outside [0, N) gives a row of NaN.

:func:`row_gather` sends a CPU tensor to :func:`row_gather_plain` and a CUDA
tensor to :func:`row_gather_cuda`, which launches the kernel or raises.
``row_gather_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from opticalflow_tpu_torch.ops._launch import (Kernel, needs_grad,
                                               raw_stream)

__all__ = ["row_gather", "row_gather_plain", "row_gather_cuda"]

_kernel = Kernel("row_gather", "row_gather",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)


def _flat_index(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"row_gather needs x of shape (N, C), got "
                         f"{tuple(x.shape)}")
    if not (idx.dim() == 1 or (idx.dim() == 2 and idx.shape[1] == 1)):
        raise ValueError(f"row_gather needs idx of shape (M,) or (M, 1), got "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"row_gather takes int32 indices, got {idx.dtype}")
    return idx.reshape(-1)


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N, C), idx (M,) or (M, 1) int32 → (M, C) in x's dtype."""
    i = _flat_index(x, idx).long()
    n = x.shape[0]
    i = torch.where(i < 0, i + n, i)
    inside = (i >= 0) & (i < n)
    out = x[torch.where(inside, i, torch.zeros_like(i))]
    return torch.where(inside[:, None], out,
                       torch.full_like(out, float("nan")))


def _refuse(x, idx) -> None:
    """Raise for the first thing the kernel does not take; the message is
    built here, off the passing path."""
    if not (x.is_cuda and idx.is_cuda) or x.device != idx.device:
        raise ValueError("row_gather_cuda needs x and idx on one CUDA "
                         f"device, got {x.device} and {idx.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"row_gather_cuda takes float32 rows, got {x.dtype}")
    _flat_index(x, idx)
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather_cuda needs contiguous x and idx")
    if needs_grad(x):
        raise RuntimeError(
            "row_gather_cuda is forward-only, like the TPU kernels it "
            "replaces; run under torch.no_grad()/inference_mode()")
    raise AssertionError("row_gather_cuda refused inputs it should take")


def row_gather_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: x (N, C) float32, idx (M,) or (M, 1) int32, both
    contiguous on one CUDA device → (M, C) float32."""
    device = x.device
    xs = x.shape
    ids = idx.shape
    # a contiguous (M, 1) idx is its own flat view: no reshape on this path
    if not (x.dtype is torch.float32 and idx.dtype is torch.int32
            and x.is_cuda and idx.device == device and len(xs) == 2
            and (len(ids) == 1 or (len(ids) == 2 and ids[1] == 1))
            and x.is_contiguous() and idx.is_contiguous()
            and not needs_grad(x)):
        _refuse(x, idx)
    n, c = xs
    m = ids[0]
    out = torch.empty(m, c, dtype=torch.float32, device=device)
    if m == 0 or c == 0:
        return out
    index = device.index
    fn = _kernel.fn or _kernel.load()
    err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m, c, index,
             raw_stream(index))
    if err:
        _kernel.refused(err, index, f"x {tuple(xs)}, {m} indices")
    row_gather_cuda.launches += 1
    return out


row_gather_cuda.launches = 0


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with ``jnp.take``'s rules: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.is_cuda:
        return row_gather_cuda(x, idx)
    return row_gather_plain(x, idx)
