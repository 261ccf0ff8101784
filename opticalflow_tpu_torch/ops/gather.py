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

from opticalflow_tpu_torch.ops._build import load_library

__all__ = ["row_gather", "row_gather_plain", "row_gather_cuda"]

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load_library("row_gather").row_gather
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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


def row_gather_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: x (N, C) float32, idx (M,) or (M, 1) int32, both
    contiguous on one CUDA device → (M, C) float32."""
    if not (x.is_cuda and idx.is_cuda) or x.device != idx.device:
        raise ValueError("row_gather_cuda needs x and idx on one CUDA "
                         f"device, got {x.device} and {idx.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"row_gather_cuda takes float32 rows, got {x.dtype}")
    flat = _flat_index(x, idx)
    if not (x.is_contiguous() and flat.is_contiguous()):
        raise ValueError("row_gather_cuda needs contiguous x and idx")
    n, c = x.shape
    m = flat.shape[0]
    out = torch.empty((m, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), flat.data_ptr(), out.data_ptr(), n, m, c,
                 stream)
    if err != 0:
        raise RuntimeError(f"row_gather launch failed: cudaError {err} at "
                           f"x {tuple(x.shape)}, {m} indices")
    row_gather_cuda.launches += 1
    return out


row_gather_cuda.launches = 0


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with ``jnp.take``'s rules: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.is_cuda:
        return row_gather_cuda(x, idx)
    return row_gather_plain(x, idx)
