"""The one launch path of the port's CUDA kernels.

Every wrapper (``corr_cuda``, ``fused_warpcorr``, ``gather``) binds its C
entry point through :class:`Kernel` and launches through it, so the host
cost of a call is the wrapper's own checks, one ``torch.empty``, and this:

  * the ctypes function is looked up and its ``argtypes`` are set once, at
    the first call (which is also when ``nvcc`` builds the library);
  * the raw handle of PyTorch's current stream on the tensors' device is
    fetched at every call (:data:`raw_stream`), without building a
    ``torch.cuda.Stream``: the
    caller may have changed it (``with torch.cuda.stream(s):``, CUDA-graph
    capture), so it is never kept between calls;
  * there is no Python device guard: the C entry point is given the device
    index and switches device only when the current one differs
    (``csrc/device_guard.cuh``).

Every entry point's last two arguments are ``int device, void* stream``;
:class:`Kernel` appends their types.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from opticalflow_tpu_torch.ops._build import load_library

__all__ = ["Kernel", "raw_stream", "needs_grad"]


def _raw_stream_through_object(device_index: int) -> int:
    return torch.cuda.current_stream(device_index).cuda_stream


#: ``raw_stream(device_index)``: the ``cudaStream_t`` of PyTorch's current
#: stream on that device, as an int, as it is now.  Decided once: PyTorch's
#: own accessor of the raw handle where the installed version has it, else
#: through a ``torch.cuda.Stream`` object.
raw_stream: Callable[[int], int] = getattr(
    torch._C, "_cuda_getCurrentRawStream", _raw_stream_through_object)


def needs_grad(*tensors) -> bool:
    """True if autograd would record a function of these tensors (the
    kernels are forward-only)."""
    for t in tensors:
        if t.requires_grad:
            return torch.is_grad_enabled()
    return False


class Kernel:
    """A C entry point ``int fn(<argtypes>, int device, void* stream)`` of
    ``csrc/<library>.cu`` that returns the launch's ``cudaError_t``.

    A wrapper launches with::

        fn = kernel.fn or kernel.load()
        err = fn(..., index, raw_stream(index))
        if err:
            kernel.refused(err, index, ...)
    """

    def __init__(self, library: str, symbol: str, argtypes: Sequence):
        self.library = library
        self.symbol = symbol
        self._argtypes = [*argtypes, ctypes.c_int, ctypes.c_void_p]
        self.fn = None    # the bound ctypes function, once loaded

    def load(self):
        """Build (if need be) and load the library, bind the function and
        set its ``argtypes``, once; returns the function."""
        fn = self.fn
        if fn is None:
            fn = getattr(load_library(self.library), self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self.fn = fn
        return fn

    def refused(self, err: int, device_index: int, what: str) -> None:
        """Raise for a launch the runtime refused."""
        raise RuntimeError(f"{self.symbol} launch failed: cudaError {err} "
                           f"on cuda:{device_index} at {what}")
