"""Weight pruning (the reference's ``prun.py`` capability), on a state dict
or an ``nn.Module``.

Counterpart of ``opticalflow_tpu.models.prune``:

  * :func:`magnitude_prune`: global unstructured magnitude pruning (keeps
    the largest |w|) over every convolution kernel, with the same global
    ``np.quantile`` threshold as the JAX package, so on carried-over
    weights its mask equals JAX's;
  * :func:`random_prune`: the reference's random criterion, a fraction of
    each kernel dropped, drawn from a ``torch.Generator`` seeded by
    ``seed`` (not ``jax.random``'s bits);
  * :func:`sparsity_report`: per-layer and global sparsity.

A "kernel" is the weight of every ``Conv2d`` / ``ConvTranspose2d``: in a
state dict of :class:`~opticalflow_tpu_torch.models.pwcnet.PWCDCNet`, every
``*.weight`` (the model has no other weights); biases are untouched.  The
masks zero weights in dense tensors: cuDNN's convolutions do not exploit
unstructured sparsity, so this is an accuracy and size experiment, not a
speed path.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

__all__ = ["magnitude_prune", "random_prune", "sparsity_report"]

Weights = Union[nn.Module, Mapping[str, torch.Tensor]]


def _state_dict(params: Weights) -> Dict[str, torch.Tensor]:
    return dict(params.state_dict() if isinstance(params, nn.Module)
                else params)


def _kernel_names(params: Weights):
    """The state-dict names of the convolution kernels, in order."""
    if isinstance(params, nn.Module):
        return [f"{name}.weight" if name else "weight"
                for name, m in params.named_modules()
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    return [k for k in params if k.endswith(".weight")]


def _with(params: Weights, new: Dict[str, torch.Tensor]) -> Weights:
    """``params`` with the tensors in ``new`` replaced: a new state dict,
    or the module itself, changed in place."""
    if isinstance(params, nn.Module):
        params.load_state_dict({**params.state_dict(), **new})
        return params
    return {k: new.get(k, v) for k, v in params.items()}


def magnitude_prune(params: Weights, amount: float = 0.3) -> Weights:
    """Zero the globally smallest |w| fraction ``amount`` of all convolution
    kernels (every |w| at or below the ``amount`` quantile).  Returns a new
    state dict, or the module pruned in place."""
    sd = _state_dict(params)
    names = _kernel_names(params)
    all_abs = np.concatenate([sd[k].detach().abs().cpu().numpy().ravel()
                              for k in names])
    thresh = np.quantile(all_abs, amount)
    pruned = {}
    for k in names:
        v = sd[k].detach()
        pruned[k] = torch.where(v.abs() <= thresh, torch.zeros_like(v), v)
    return _with(params, pruned)


def random_prune(params: Weights, amount: float = 0.3,
                 seed: int = 0) -> Weights:
    """The reference's criterion: drop each kernel weight with probability
    ``amount``, drawn from a ``torch.Generator`` seeded by ``seed`` (kernel
    by kernel, in state-dict order).  Returns a new state dict, or the
    module pruned in place."""
    gen = torch.Generator().manual_seed(int(seed))
    sd = _state_dict(params)
    pruned = {}
    for k in _kernel_names(params):
        v = sd[k].detach()
        keep = torch.rand(v.shape, generator=gen) >= amount
        pruned[k] = v * keep.to(v.device, v.dtype)
    return _with(params, pruned)


def _layer_name(key: str) -> str:
    """``conv1a.0.weight`` → ``conv1a``: the JAX package's layer name (the
    reference's ``conv()`` helper puts the convolution at index 0 of a
    Sequential)."""
    name = key[:-len(".weight")]
    return name[:-len(".0")] if name.endswith(".0") else name


def sparsity_report(params: Weights) -> Dict[str, Tuple[int, float]]:
    """{layer: (num_weights, zero_fraction)} for every convolution kernel,
    under the JAX package's layer names (``conv1a``, ``predict_flow2``),
    plus a ``"_global"`` row."""
    sd = _state_dict(params)
    rep = {}
    total = zeros = 0
    for k in _kernel_names(params):
        v = sd[k]
        z = int((v == 0).sum())
        rep[_layer_name(k)] = (v.numel(), z / v.numel())
        total += v.numel()
        zeros += z
    rep["_global"] = (total, zeros / max(total, 1))
    return rep
