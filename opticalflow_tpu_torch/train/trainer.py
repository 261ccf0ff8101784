"""Training on the GPU: optimizers, the train state, and the train step.

Counterpart of ``opticalflow_tpu.train.trainer``, covering the reference's
training regimes behind one :class:`TrainConfig` with the same fields and
defaults:

  * ``loss="charbonnier_full"``: supervised fine-tune, flow2 upsampled to
    the full-resolution GT, masked Charbonnier (``train.py:54-87``);
  * ``loss="multiscale"``: per-level supervised loss, weights
    [0.32, 0.08, 0.02, 0.01, 0.005] (``train2.py:124-200``);
  * ``loss="proxy"``: self-supervised SSIM+L1 photometric + smoothness
    (``train_pseudo.py:65-164``);
  * ``loss="proxy_epipolar"``: the proxy loss under a per-sample epipolar
    inlier mask (``photo_mask`` in the batch), plus, for
    ``epi_soft_weight > 0``, that weight times the soft Sampson penalty of
    flow2 under the batch's per-sample ``fundamental`` matrices (reported
    as ``metrics["sampson"]``).

The step takes the JAX package's batch layout (NHWC ``images`` (B, H, W, 6),
``flow`` (B, H, W, 2), ``valid`` (B, H, W), optional ``photo_mask`` (B, H, W) and
``fundamental`` (B, 3, 3); numpy arrays or tensors) and moves it to the model's device.  PyTorch updates the
model and the optimizer in place, where the JAX step donates its state.
Gradient clipping is optax's ``clip_by_global_norm`` written out
(g·max/‖g‖ once ‖g‖ reaches max), not ``clip_grad_norm_``, which divides by
‖g‖ + 1e-6.  The correlation's gradient comes from the backward kernel
through ``ops.correlation.CorrelationFn`` on the card.

Data parallelism (the JAX step's ``mesh``, a :class:`~opticalflow_tpu_torch.
parallel.mesh.Mesh` here): each rank's step takes its own rows of the
global batch (``parallel.mesh.shard_batch``; the CLI's loader feeds each
rank its shard).  The masked means divide by the global batch's counts, as
the JAX step's do on its one sharded batch (``losses.Denominator``); after
the backward one all-reduce of all the gradients, coalesced into one
buffer per dtype, averages them over the ranks, and only then come the
global norm, the clip and the update, the same on every rank.  The metrics
are averaged over the ranks too.  One all-reduce after the backward, not
``DistributedDataParallel``: the step already holds the gradients for the
clip, the model stays the unwrapped module (``numerics()``, state dicts
without ``module.`` prefixes), nothing changes for ``grad_accum``, remat or
parameters that get no gradient, and a 37.5 MB all-reduce a step gains
little from DDP's overlap with the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from opticalflow_tpu_torch.geometry.epipolar import sampson_penalty
from opticalflow_tpu_torch.models.torch_import import (reference_state_dict,
                                                        state_dict_from_jax)
from opticalflow_tpu_torch.ops.resize import upsample_flow_to
from opticalflow_tpu_torch.parallel import mesh as meshlib
from opticalflow_tpu_torch.train import losses as L

__all__ = ["TrainConfig", "TrainState", "make_optimizer", "make_train_step",
           "create_train_state", "make_eval_metrics_step",
           "PlateauController", "batch_to_device", "clip_by_global_norm_"]

_LOSSES = ("charbonnier_full", "multiscale", "proxy", "proxy_epipolar")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One config for every regime (the JAX ``TrainConfig``'s fields and
    defaults)."""
    loss: str = "multiscale"           # charbonnier_full | multiscale | proxy | proxy_epipolar
    optimizer: str = "adamw"           # adam | adamw
    lr: float = 1e-4
    weight_decay: float = 1e-4
    grad_clip: float = 1.0             # 0 disables (train2.py grad-clip 1.0)
    # ReduceLROnPlateau (train2.py's scheduler): scale lr by plateau_factor
    # after plateau_patience epochs without val-metric improvement; 0 = off
    plateau_factor: float = 0.0
    plateau_patience: int = 3
    multiscale_weights: Tuple[float, ...] = L.MULTISCALE_WEIGHTS
    lambda_photo: float = 0.0
    lambda_smooth: float = 0.0
    alpha_photo: float = 1.0           # proxy loss weights (train_pseudo)
    alpha_smooth: float = 0.1
    epi_soft_weight: float = 0.0       # soft Sampson penalty weight
    # flow2 is in /20 units for the canonical weights; GT-space
    # checkpoints (the reference's own fine-tunes) use 1.0
    flow_scale: float = 1.0
    # recompute activations in the backward instead of keeping them: True
    # the whole forward (torch.utils.checkpoint), "l2" only the level-2
    # estimator and the context network, the largest activations
    remat: Any = False                 # False | True | "l2"
    # split each batch into this many micro-batches, average their
    # gradients, apply one update; metrics are micro-batch means
    grad_accum: int = 1


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters) and the optimizer (its
    moments and learning rates), all updated in place by the step."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """Adam or AdamW (optax's defaults: betas 0.9/0.999, eps 1e-8; AdamW's
    decay on every parameter) at ``cfg.lr``.  Each param group records
    whether ``cfg.plateau_factor`` asked for a plateau schedule."""
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                               eps=1e-8)
    elif cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    for group in opt.param_groups:
        group["plateau"] = bool(cfg.plateau_factor)
    return opt


class PlateauController:
    """Host-side ReduceLROnPlateau (the ``train2.py`` scheduler): call
    :meth:`step` with the epoch's validation metric; after ``patience``
    epochs without improvement every param group's learning rate is scaled
    by ``factor``.  Returns the state."""

    def __init__(self, cfg: TrainConfig):
        self.factor = cfg.plateau_factor
        self.patience = cfg.plateau_patience
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, state: TrainState, metric: float) -> TrainState:
        if not self.factor:
            return state
        if metric < self.best - 1e-6:
            self.best = metric
            self.bad_epochs = 0
            return state
        self.bad_epochs += 1
        if self.bad_epochs < self.patience:
            return state
        self.bad_epochs = 0
        groups = state.optimizer.param_groups
        if not all(g.get("plateau") for g in groups):
            raise ValueError(
                "PlateauController: the optimizer was built without a "
                "plateau schedule; build it with plateau_factor > 0")
        for g in groups:
            g["lr"] *= self.factor
        print(f"plateau: learning_rate -> {groups[0]['lr']:.3e}")
        return state


def create_train_state(model: torch.nn.Module, cfg: TrainConfig,
                       params: Optional[Mapping] = None
                       ) -> Tuple[TrainState, torch.optim.Optimizer]:
    """Load ``params`` into ``model`` (JAX ``PWCDCNet`` params, carried
    across by ``state_dict_from_jax``, or a reference-layout state dict;
    None keeps the model's own) and build its optimizer."""
    if params is not None:
        first = next(iter(params.values()))
        sd = (state_dict_from_jax(params) if isinstance(first, Mapping)
              else reference_state_dict(params))
        dev = next(model.parameters()).device
        model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
    opt = make_optimizer(cfg, model.parameters())
    return TrainState(step=0, model=model, optimizer=opt), opt


def _nchw(a, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
    return t.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2
                                                            ).contiguous()


def batch_to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """The JAX batch layout (NHWC ``images``/``flow``, (B, H, W) masks,
    numpy or tensors) → float32 NCHW tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        if k in ("images", "flow"):
            out[k] = _nchw(v, device)
        else:
            t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            out[k] = t.to(device=device, dtype=torch.float32)
    return out


def _check_config(cfg: TrainConfig, mesh) -> None:
    if mesh is not None and not isinstance(mesh, meshlib.Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if cfg.loss not in _LOSSES:
        raise ValueError(f"unknown loss {cfg.loss!r}")
    if cfg.remat not in (False, True, "l2"):
        raise ValueError(f"remat must be False, True or 'l2', got "
                         f"{cfg.remat!r}")


def _global_denominator(mesh) -> Optional[L.Denominator]:
    """The masked means' denominators over the global batch: this rank's
    count all-reduced (detached: a count carries no gradient)."""
    if mesh is None:
        return None

    def total(count: torch.Tensor):
        return meshlib.all_reduce_(count.detach().clone(), mesh), mesh.world

    return total


def _compute_loss(model, batch: Dict[str, torch.Tensor], cfg: TrainConfig,
                  denominator: Optional[L.Denominator] = None):
    """The configured loss of one (device, NCHW) batch; returns (loss,
    metrics dict).  Under a mesh (``denominator``) the loss and metrics are
    this rank's terms, whose mean over the ranks is the global batch's."""
    x = batch["images"]
    if cfg.remat == "l2":
        preds = model(x, train=True, checkpoint_l2=True)
    elif cfg.remat:
        preds = checkpoint(lambda xx: model(xx, train=True), x,
                           use_reentrant=False)
    else:
        preds = model(x, train=True)
    flow2 = preds[0] * cfg.flow_scale
    metrics = {}

    if cfg.loss == "charbonnier_full":
        gt, valid = batch["flow"], batch["valid"]
        h, w = gt.shape[-2:]
        pred_full = upsample_flow_to(flow2, h, w)
        loss = L.charbonnier_epe(pred_full, gt, valid,
                                 denominator=denominator)
        metrics["epe"] = L.epe_loss(pred_full, gt, valid, denominator)
    elif cfg.loss == "multiscale":
        gt, valid = batch["flow"], batch["valid"]
        scaled = tuple(p * cfg.flow_scale for p in preds)
        loss = L.multiscale_supervised_loss(
            scaled, gt, valid, weights=cfg.multiscale_weights, images=x,
            lambda_photo=cfg.lambda_photo, lambda_smooth=cfg.lambda_smooth,
            denominator=denominator)
        h, w = gt.shape[-2:]
        metrics["epe"] = L.epe_loss(upsample_flow_to(scaled[0], h, w), gt,
                                    valid, denominator)
    else:   # proxy, proxy_epipolar
        mask = batch.get("photo_mask") if cfg.loss == "proxy_epipolar" \
            else None
        loss, photo, smooth = L.proxy_label_loss(
            flow2, x[:, :3], x[:, 3:], alpha_photo=cfg.alpha_photo,
            alpha_smooth=cfg.alpha_smooth, photo_mask=mask,
            denominator=denominator)
        metrics["photo"] = photo
        metrics["smooth"] = smooth
        if cfg.loss == "proxy_epipolar" and cfg.epi_soft_weight > 0:
            pen = sampson_penalty(flow2, batch["fundamental"])
            loss = loss + cfg.epi_soft_weight * pen
            metrics["sampson"] = pen
    metrics["loss"] = loss
    return loss, metrics


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: every gradient is scaled
    by max_norm / ‖g‖ where the global norm ‖g‖ is not below max_norm
    (``max_norm`` ≤ 0 clips nothing).  Returns ‖g‖ before the clip, on the
    device (no host synchronisation).  Multi-tensor kernels: a handful of
    launches for all the model's gradients, not a few per tensor."""
    norm = torch.nn.utils.get_total_norm(grads, 2.0)
    if max_norm and max_norm > 0:
        factor = torch.where(norm < max_norm, torch.ones_like(norm),
                             max_norm / norm)
        torch._foreach_mul_(grads, factor)
    return norm


@torch.no_grad()
def _all_reduce_scaled_(tensors, mesh, scale: float) -> None:
    """Sum ``tensors`` over the mesh in place, one all-reduce per dtype of
    them all flattened into one buffer, then multiply by ``scale``."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = meshlib.all_reduce_(
            torch.cat([t.reshape(-1) for t in group]), mesh)
        flat.mul_(scale)
        torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in group]), group)])


def _reduce_metrics(sums: Dict[str, torch.Tensor], mesh,
                    scale: float) -> Dict[str, torch.Tensor]:
    """The metrics' sums over the ranks (one all-reduce), times ``scale``."""
    names = sorted(sums)
    stacked = torch.stack([sums[n].float() for n in names])
    _all_reduce_scaled_([stacked], mesh, scale)
    return dict(zip(names, stacked.unbind()))


def make_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                    cfg: TrainConfig, mesh=None) -> Callable:
    """The train step ``step(state, batch) -> (state, metrics)``: gradients
    of the configured loss (averaged over ``grad_accum`` micro-batches),
    their global norm, optax's global-norm clip, one optimizer update.
    ``metrics`` holds 0-d device tensors (``loss``, ``grad_norm``, and
    ``epe`` or ``photo``/``smooth``); reading one waits for the card.

    With a ``mesh`` the step takes this rank's rows of the global batch
    (``shard_batch(batch, mesh, cfg.grad_accum)`` makes its micro-batches
    this rank's shares of the global ones) and every rank comes out with
    the same gradients, metrics and parameters (module docstring)."""
    _check_config(cfg, mesh)
    accum = max(1, int(cfg.grad_accum))
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    denominator = _global_denominator(mesh)

    def step(state: TrainState, batch: Mapping):
        b = batch_to_device(batch, device)
        b0 = b["images"].shape[0]
        if b0 % accum:
            raise ValueError(
                f"batch size {b0} not divisible by grad_accum={accum}")
        opt.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        with model.numerics():   # the backward in the model's precision
            for k in range(accum):
                micro = {n: t.chunk(accum)[k] for n, t in b.items()} \
                    if accum > 1 else b
                loss, metrics = _compute_loss(model, micro, cfg, denominator)
                loss.backward()
                for n, v in metrics.items():
                    v = v.detach()
                    sums[n] = v if n not in sums else sums[n] + v
        grads = [p.grad for p in params if p.grad is not None]
        if mesh is not None:
            scale = 1.0 / (accum * mesh.world)
            _all_reduce_scaled_(grads, mesh, scale)
            sums = _reduce_metrics(sums, mesh, scale)
        elif accum > 1:
            with torch.no_grad():
                torch._foreach_mul_(grads, 1.0 / accum)
            sums = {n: v * (1.0 / accum) for n, v in sums.items()}
        norm = clip_by_global_norm_(grads, cfg.grad_clip)
        opt.step()
        state.step += 1
        sums["grad_norm"] = norm
        return state, sums

    return step


def make_eval_metrics_step(model: torch.nn.Module, cfg: TrainConfig,
                           mesh=None) -> Callable:
    """``eval_step(batch) -> metrics``: the train step's loss metrics, no
    update, under ``torch.no_grad()``; with a ``mesh``, of this rank's
    rows, reduced over the global batch (the same on every rank)."""
    _check_config(cfg, mesh)
    device = next(model.parameters()).device
    denominator = _global_denominator(mesh)

    def step(batch: Mapping):
        with torch.no_grad():
            _, metrics = _compute_loss(model, batch_to_device(batch, device),
                                       cfg, denominator)
        if mesh is not None:
            metrics = _reduce_metrics(metrics, mesh, 1.0 / mesh.world)
        return metrics

    return step
