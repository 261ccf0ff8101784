"""Data parallelism on ``torch.distributed``: one process per card.

Counterpart of ``opticalflow_tpu.parallel.mesh``.  In JAX a ``Mesh`` is the
devices under one controller and XLA emits the collectives; here a
:class:`Mesh` is a process group: every rank is one process that drives
one card (``device``), and the collectives are ``torch.distributed``'s,
NCCL between cards and gloo for CPU processes.  ``mesh.shape["data"]`` is
the number of ranks, so the call sites read like their JAX counterparts.

Launch N ranks with ``python -m torch.distributed.run --nproc-per-node N``
(the ``env://`` variables), or call :func:`distributed_init` in each
process with the coordinator's ``host:port``, the number of processes and
the process id (``tcp://``), as in the JAX signature.  The backend is
NCCL on a card and gloo on the CPU, and gloo on a card when the launched
ranks outnumber the visible cards: two ranks may then share one card
(``device="cuda:0"``), which NCCL refuses.  ``backend=`` overrides it.

The contract is JAX's multi-process one: every rank is fed the same global
batch, computes its own contiguous rows (:func:`shard_batch`), and an
all-gather (:func:`all_gather_rows`) hands every rank the whole output.
Nothing falls back: a CUDA rank without its card, or a failed collective,
raises.  Every collective has the group's timeout, and the group is
destroyed at exit.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import hashlib
import os
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "distributed_init", "barrier", "make_mesh",
           "resolve_data_parallel", "check_eval_cli_mesh_args",
           "batch_sharding", "shard_batch", "replicate", "local_batch_size",
           "all_gather_rows", "all_reduce_", "broadcast_", "any_rank",
           "rank_device",
           "launched", "shutdown", "DEFAULT_TIMEOUT_S"]

# every collective's timeout (the JAX barrier's default): generous, since
# ranks may build kernels or load checkpoints minutes apart
DEFAULT_TIMEOUT_S = 1800


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One data-parallel process group, seen from one rank."""
    group: Any                # the torch.distributed process group
    rank: int
    world: int
    device: torch.device      # the card (or CPU) this rank computes on
    backend: str              # "nccl" | "gloo"

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.world}


def rank_device(device: Union[str, torch.device, None] = None
                ) -> torch.device:
    """This rank's device.  ``None`` or ``"cuda"`` means the card of the
    rank's ``LOCAL_RANK`` (0 outside a launch); ``"cuda:N"`` pins one.
    Raises if the card does not exist: a rank never moves to the CPU
    unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(CLI: --device cpu) to run the ranks on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"this rank's card {dev} does not exist "
            f"({torch.cuda.device_count()} visible): launch one rank per "
            "card, or pin a shared card with device='cuda:0' (the ranks "
            "then talk over gloo: NCCL refuses two ranks on one card)")
    return dev


def _backend_for(backend: Optional[str], dev: torch.device) -> str:
    """``backend``, or the default for ``dev``: gloo on the CPU; on a card
    NCCL, unless the ranks launched on this host (``LOCAL_WORLD_SIZE``)
    outnumber its visible cards and so share them, which NCCL refuses."""
    if backend is None:
        shared = dev.type == "cuda" and int(os.environ.get(
            "LOCAL_WORLD_SIZE", "1")) > torch.cuda.device_count()
        backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    return backend


def launched() -> bool:
    """Whether this process was started by ``torch.distributed.run`` (or
    anything else that sets ``RANK`` and ``WORLD_SIZE``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


# the device :func:`distributed_init` selected for this process's group
_GROUP_DEVICE: Dict[str, torch.device] = {}


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    _GROUP_DEVICE.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _init_group(backend: str, dev: torch.device, timeout_s: float,
                **kw) -> None:
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev      # the communicator is built here
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    _GROUP_DEVICE["device"] = dev
    atexit.register(shutdown)


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     device: Union[str, torch.device, None] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Tuple[int, int]:
    """Join the process group: over ``tcp://coordinator`` ("host:port" of
    process 0) with ``num_processes`` and this ``process_id``, or, with no
    coordinator, from the ``env://`` variables ``torch.distributed.run``
    sets.  ``device`` defaults to the card of the rank's ``LOCAL_RANK``;
    ``backend`` to NCCL on a card, gloo on the CPU or on cards the ranks
    share.  Returns ``(rank, world)``."""
    dev = rank_device(device)
    backend = _backend_for(backend, dev)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        _init_group(backend, dev, timeout_s,
                    init_method=f"tcp://{coordinator}",
                    world_size=int(num_processes), rank=int(process_id))
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no coordinator given and {', '.join(missing)} not set: "
                "launch the ranks with python -m torch.distributed.run, or "
                "pass coordinator, num_processes and process_id")
        _init_group(backend, dev, timeout_s, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def barrier(mesh: Optional[Mesh] = None) -> None:
    """Block until every rank reaches this point (the group's timeout).
    No-op without a process group."""
    if dist.is_initialized():
        dist.barrier(group=mesh.group if mesh is not None else None)


def make_mesh(device: Union[str, torch.device, None] = None) -> Mesh:
    """The data-parallel mesh over the launched process group.  ``device``
    defaults to the device :func:`distributed_init` selected, whatever the
    backend (for a group joined otherwise, the current card); the CPU only
    when it was asked for."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "distributed_init first")
    backend = dist.get_backend()
    if device is None:
        device = _GROUP_DEVICE.get("device")
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if torch.cuda.is_available() else "cuda")
    dev = rank_device(device)
    _backend_for(backend, dev)
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                world=dist.get_world_size(), device=dev, backend=backend)


def resolve_data_parallel(spec: str, *,
                          device: Union[str, torch.device, None] = None,
                          backend: Optional[str] = None,
                          command: str = "<module>") -> Optional[Mesh]:
    """Parse a CLI ``--data-parallel N|all`` spec into a mesh (or ``None``).

    ``"1"`` (the default) returns ``None``: one process, no collectives.
    Inside a launched group (``torch.distributed.run``) ``N`` must equal
    the number of ranks and ``"all"`` takes them all.  With nothing
    launched, ``"all"`` builds a one-rank group, the counterpart of JAX's
    one-chip mesh that drives the sharded code path on a single card, and
    ``N > 1`` raises with the command that would launch N ranks
    (``command`` is the module to name in it).  ``N < 1`` and non-integer
    specs raise with JAX's messages."""
    if spec == "all":
        n = None
    else:
        try:
            n = int(spec)
        except ValueError:
            raise ValueError(
                f"--data-parallel expects an integer or 'all', got {spec!r}")
        if n < 1:
            raise ValueError(
                f"--data-parallel must be >= 1 (or 'all'), got {spec!r}")
        if n == 1:
            return None
    if not dist.is_initialized():
        if launched():
            distributed_init(backend=backend, device=device)
        elif n is None:
            dev = rank_device(device)
            _init_group(_backend_for(backend, dev), dev, DEFAULT_TIMEOUT_S,
                        store=dist.HashStore(), world_size=1, rank=0)
        else:
            raise ValueError(
                f"--data-parallel {n} needs {n} processes, one per card; "
                f"launch them with: python -m torch.distributed.run "
                f"--nproc-per-node {n} -m {command} ... --data-parallel {n}")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(
            f"--data-parallel {n} does not match the {world} launched "
            f"ranks; pass {world} or 'all'")
    return make_mesh(device)


def check_eval_cli_mesh_args(mesh: Optional[Mesh], dispatch_chunk,
                             batch: int) -> None:
    """The eval CLIs' fail-fast checks of the mesh-adjacent flags, before
    any checkpoint load (JAX's messages): ``--dispatch-chunk`` is
    single-card only, and the eval batch must divide over the ranks."""
    if mesh is None:
        return
    if dispatch_chunk is not None:
        raise SystemExit(
            "--dispatch-chunk is a single-chip scheduling lever; it is "
            "mutually exclusive with --data-parallel (the mesh shards each "
            "batch instead)")
    if batch % mesh.shape["data"]:
        raise SystemExit(
            f"--batch {batch} must be divisible by the data-parallel "
            f"width {mesh.shape['data']} (each evaluation batch is sharded "
            f"over the mesh)")


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape["data"]
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by mesh axis "
            f"'data' of size {n}")
    return global_batch // n


def batch_sharding(global_batch: int, mesh: Mesh,
                   grad_accum: int = 1) -> Union[slice, np.ndarray]:
    """This rank's rows of a global batch: a contiguous slice, or with
    ``grad_accum`` > 1 its share of each of the batch's micro-batches (the
    JAX step splits the global batch into micro-batches first and shards
    each over the mesh; the port's step chunks the rank's rows, so these
    rows make its micro-batch k this rank's share of the global one)."""
    per = local_batch_size(global_batch, mesh)
    if grad_accum == 1:
        return slice(mesh.rank * per, (mesh.rank + 1) * per)
    if global_batch % (grad_accum * mesh.world):
        raise ValueError(
            f"global batch {global_batch} not divisible by grad_accum="
            f"{grad_accum} x {mesh.world} ranks")
    micro = global_batch // grad_accum
    share = micro // mesh.world
    return np.concatenate([np.arange(k * micro + mesh.rank * share,
                                     k * micro + (mesh.rank + 1) * share)
                           for k in range(grad_accum)])


def shard_batch(batch, mesh: Mesh, grad_accum: int = 1):
    """This rank's rows (:func:`batch_sharding`) of a global batch: a dict
    of arrays or tensors with a common leading dimension, or one of
    them."""
    if isinstance(batch, Mapping):
        n = len(next(iter(batch.values())))
        rows = batch_sharding(n, mesh, grad_accum)
        return {k: _rows(v, rows) for k, v in batch.items()}
    return _rows(batch, batch_sharding(len(batch), mesh, grad_accum))


def _rows(a, rows):
    if torch.is_tensor(a) and not isinstance(rows, slice):
        return a[torch.as_tensor(rows, device=a.device)]
    return a[rows]


# ---------------------------------------------------------------- collectives

def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor a collective of ``mesh``'s backend takes: NCCL moves card
    memory; gloo is given host memory (a card's tensors are staged)."""
    if mesh.backend == "nccl":
        if not t.is_cuda:
            return t.to(mesh.device)
        return t
    return t.cpu() if t.is_cuda else t


def all_reduce_(t: torch.Tensor, mesh: Mesh,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``t`` in place over the mesh; returns it."""
    w = _wire(t, mesh)
    dist.all_reduce(w, op=op, group=mesh.group)
    if w is not t:
        t.copy_(w)
    return t


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` on every rank with rank ``src``'s, in place;
    returns it."""
    w = _wire(t, mesh)
    dist.broadcast(w, src=src, group=mesh.group)
    if w is not t:
        t.copy_(w)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank), concatenated along
    dim 0 in rank order, on ``t``'s device."""
    w = _wire(t.contiguous(), mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.world)]
    dist.all_gather(parts, w, group=mesh.group)
    return torch.cat(parts).to(t.device)


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """True on every rank if ``flag`` is true on any (an all-reduce MAX of
    one element): the ranks agree before acting on a local event."""
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    return bool(all_reduce_(t, mesh, dist.ReduceOp.MAX).item())


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a module's state dict, or of nested mappings and
    sequences (an optimizer's ``state_dict()``), in a fixed order."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict(keep_vars=True)
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _fingerprint(tree) -> bytes:
    digest = hashlib.sha256()
    for path, leaf in _leaves(tree):
        digest.update(path.encode())
        if torch.is_tensor(leaf):
            t = leaf.detach().reshape(-1).contiguous().cpu()
            digest.update(f"{tuple(leaf.shape)}{leaf.dtype}".encode())
            digest.update(t.view(torch.uint8).numpy().tobytes())
        else:
            digest.update(repr(leaf).encode())
    return digest.digest()


def _assert_equal_across_ranks(fingerprint: bytes, mesh: Mesh) -> None:
    """Raise on EVERY rank if any rank's ``fingerprint`` differs: every
    rank gathers every fingerprint and compares them all.  (The JAX copy
    compares each process with process 0, which reads its own key: a
    divergent process raises while process 0 goes on and hangs in the
    next collective.)"""
    mine = torch.frombuffer(bytearray(fingerprint), dtype=torch.uint8)
    every = all_gather_rows(mine.to(mesh.device), mesh).cpu()
    every = every.view(mesh.world, len(fingerprint))
    differ = [r for r in range(mesh.world) if not torch.equal(every[r],
                                                              every[0])]
    if differ:
        raise ValueError(
            f"rank {mesh.rank}: rank(s) {differ} hold different replicated "
            f"values than rank 0 (fingerprints "
            f"{', '.join(bytes(every[r].tolist()).hex()[:12] for r in range(mesh.world))}"
            ") — e.g. a stale or mismatched checkpoint on one host; every "
            "rank must load identical weights")


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Make ``tree`` (a module, or nested mappings of tensors such as an
    optimizer's ``state_dict()``) the same on every rank, in place: a
    fingerprint check first, in which every rank compares every rank's
    fingerprint and raises on a mismatch (divergent checkpoints would
    otherwise silently serve or train mixed weights), then a broadcast of
    every tensor from rank 0.  Returns ``tree``."""
    _assert_equal_across_ranks(_fingerprint(tree), mesh)
    for _, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            w = _wire(leaf.detach(), mesh)
            dist.broadcast(w, src=0, group=mesh.group)
            if w.data_ptr() != leaf.data_ptr():
                leaf.detach().copy_(w)
    return tree
