"""Numerical debugging utilities.

Counterpart of ``opticalflow_tpu.utils.debugging``:

  * :func:`nan_guard`: a context that raises ``FloatingPointError`` at the
    first operator whose output holds a NaN, naming it, as
    ``jax_debug_nans`` does (``torch.autograd.detect_anomaly`` checks only
    the backward).  It is a ``TorchDispatchMode``, so it sees every aten
    operator of the forward and, under autograd, of the backward; a kernel
    launched through ctypes is not an operator, and a NaN it writes is
    caught at the next operator that reads it.  Every check reads the
    tensor back: a debugging tool, not a serving mode;
  * :func:`interpret_kernels`: inside it, the given model's correlations
    run :func:`~opticalflow_tpu_torch.ops.correlation.correlation_plain`,
    on the card too, for telling a kernel's fault from the model's.  A CUDA
    kernel has no interpreter, so this is not Pallas' interpret mode (the
    kernel's own body, interpreted) but the model's explicit selector
    ``use_cuda_corr`` set to False for the context.  It changes that model
    only: the kernel dispatchers, and every other model of the process (a
    server's included), go on launching their kernels.  The probes' kernels
    have their plain versions to call directly
    (``ops.fused_warpcorr.fused_warp_corr_plain``,
    ``ops.gather.row_gather_plain``);
  * :func:`check_finite`: raise ``ValueError`` naming every non-finite
    tensor of a state dict, a module or a nested dict/list of tensors.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Mapping

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["nan_guard", "interpret_kernels", "check_finite"]

# operators whose output is uninitialised memory, which may hold any bits
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "empty_permuted"}


class _NanGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor)
                    and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (shape {tuple(t.shape)}, "
                    f"{int(torch.isnan(t).sum())} of {t.numel()} values)")
        return out


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Raise ``FloatingPointError`` at the operator that first produces a
    NaN inside the context (on the thread that entered it)."""
    with _NanGuard():
        yield


@contextlib.contextmanager
def interpret_kernels(model: torch.nn.Module) -> Iterator[None]:
    """Within the context, ``model``'s correlations (those of every
    submodule with a ``use_cuda_corr`` selector) run their plain PyTorch
    version; each selector is restored on exit.  Raises ``TypeError`` for a
    model without one, such as a loaded export artifact (export from
    ``use_cuda_corr=False`` for a plain artifact)."""
    mods = [m for m in model.modules() if hasattr(m, "use_cuda_corr")]
    if not mods:
        raise TypeError(
            f"{type(model).__name__} has no use_cuda_corr selector: "
            "interpret_kernels switches a PWCDCNet's correlation to its "
            "plain version (for an export artifact, export the model with "
            "use_cuda_corr=False)")
    prev = [m.use_cuda_corr for m in mods]
    for m in mods:
        m.use_cuda_corr = False
    try:
        yield
    finally:
        for m, p in zip(mods, prev):
            m.use_cuda_corr = p


def _named_leaves(tree, prefix: str):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def check_finite(tree, name: str = "tree") -> None:
    """Raise ValueError naming every non-finite floating tensor (or array)
    of ``tree``, with its count of non-finite values."""
    bad = []
    for label, leaf in _named_leaves(tree, ""):
        if isinstance(leaf, torch.Tensor):
            if not (leaf.is_floating_point() or leaf.is_complex()):
                continue
            finite = torch.isfinite(leaf)
            n_bad, size = int((~finite).sum()), leaf.numel()
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.inexact):
                continue
            n_bad, size = int((~np.isfinite(arr)).sum()), arr.size
        if n_bad:
            bad.append(f"{label} ({n_bad}/{size} non-finite)")
    if bad:
        raise ValueError(f"non-finite values in {name}: " + "; ".join(bad))
