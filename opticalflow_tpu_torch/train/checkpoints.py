"""Checkpoints for the port: reference torch ``.pth(.tar)`` files in, and the
port's own training checkpoints out and back.

Counterpart of ``opticalflow_tpu.train.checkpoints`` in a torch format with
the JAX layout, so a run directory reads the same: ``{dir}/step_{N}/`` holds
one torch file (:data:`STATE_FILE`) with the model's and the optimizer's
``state_dict`` and the step, and JSON metadata goes to the
``step_{N}.meta.json`` sidecar.  A save is written under a temporary name and
renamed into place (``os.replace``), so a run stopped during a save leaves
the previous checkpoint as the latest and no torn one: what Orbax's
finalize-on-wait gives the JAX package.  Orbax directories need orbax and
JAX, which the port does not import, and are refused (ROADMAP Queue 1
item 2).

Under data parallelism (``mesh=``, ``parallel.mesh``) the run directory is
one shared filesystem: only rank 0 writes, every rank waits at a barrier
until it has, and every rank restores; :func:`latest_step` checks that the
ranks see the same latest step.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Mapping, Optional

import torch

from opticalflow_tpu_torch.models.torch_import import (load_torch_state_dict,
                                                        reference_state_dict)
from opticalflow_tpu_torch.parallel import mesh as meshlib

__all__ = ["load_params", "save_train_state", "restore_train_state",
           "latest_step", "STATE_FILE"]

_TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt", ".tar")
# the one file inside a step_{N} directory
STATE_FILE = "train_state.pt"


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Load model weights → the port's state dict, ready for
    ``PWCDCNet.load_state_dict`` (strict): from a reference torch
    checkpoint, or from a checkpoint of :func:`save_train_state` (a
    ``step_N`` directory, or a run directory for its latest step)."""
    if os.path.isdir(path):
        return reference_state_dict(restore_train_state(path)["params"])
    if path.endswith(_TORCH_SUFFIXES):
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"checkpoint not found: {path!r} (pass a valid torch "
                ".pth(.tar) file or a checkpoint directory of this port)")
        return reference_state_dict(load_torch_state_dict(path))
    raise ValueError(f"unrecognized checkpoint {path!r}: expected a torch "
                     f"file ({'/'.join(_TORCH_SUFFIXES)}) or a checkpoint "
                     "directory of this port")


def _atomic_json(path: str, obj) -> None:
    fd, tmp = tempfile.mkstemp(prefix=".meta-", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_train_state(directory: str, step: int,
                     params: Mapping[str, torch.Tensor],
                     opt_state: Optional[Mapping[str, Any]] = None,
                     metadata: Optional[Dict[str, Any]] = None, *,
                     mesh: Optional[meshlib.Mesh] = None) -> str:
    """Write ``{directory}/step_{step}`` holding the model's state dict
    ``params``, the optimizer's ``opt_state`` (optional) and the step, and
    ``metadata`` to the ``step_{step}.meta.json`` sidecar.  The sidecar is
    written first and the directory is renamed into place last, so the
    checkpoint appears whole or not at all.  With a ``mesh`` only rank 0
    writes (the state is the same on every rank) and every rank returns
    after it has.  Returns the checkpoint path."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step}")
    if mesh is not None:
        if mesh.rank == 0:
            save_train_state(directory, step, params, opt_state, metadata)
        meshlib.barrier(mesh)
        return path
    os.makedirs(directory, exist_ok=True)
    if metadata:
        _atomic_json(path + ".meta.json", metadata)
    payload = {"params": {k: v.detach().cpu() for k, v in params.items()},
               "step": int(step)}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    tmp = tempfile.mkdtemp(prefix=f".step_{step}-", dir=directory)
    try:
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(path):     # a save of the same step again
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def latest_step(directory: str,
                mesh: Optional[meshlib.Mesh] = None) -> Optional[int]:
    """Largest step among ``step_*`` checkpoints in ``directory``.  With a
    ``mesh`` every rank gathers every rank's answer and raises if they
    differ: ranks that restored different states would be stitched into
    one corrupted model."""
    step = None
    if os.path.isdir(directory):
        steps = [int(n.split("_", 1)[1]) for n in os.listdir(directory)
                 if n.startswith("step_") and n.split("_", 1)[1].isdigit()
                 and os.path.isdir(os.path.join(directory, n))]
        step = max(steps) if steps else None
    if mesh is not None:
        mine = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                            device=mesh.device)
        every = meshlib.all_gather_rows(mine, mesh).tolist()
        if len(set(every)) != 1:
            raise ValueError(
                f"--resume sees different checkpoint steps per process "
                f"({every}): out_dir must be one shared filesystem visible "
                f"to all hosts")
    return step


def restore_train_state(path: str) -> Dict[str, Any]:
    """Restore a checkpoint written by :func:`save_train_state`:
    ``{"params", "step"[, "opt_state"][, "metadata"]}`` on the CPU.

    ``path`` may be a specific ``step_N`` directory or a run directory, in
    which case the latest step is restored (the reference's ``--resume``
    behavior, ``train.py:134-139``).  A directory that holds no checkpoint
    of the port (an Orbax checkpoint of the JAX package, say) raises
    ``NotImplementedError``."""
    base = os.path.abspath(path)
    if not os.path.basename(base.rstrip("/")).startswith("step_"):
        step = latest_step(base)
        if step is not None:
            base = os.path.join(base, f"step_{step}")
    if not os.path.isdir(base):
        raise FileNotFoundError(f"no checkpoint at {base!r}")
    state_file = os.path.join(base, STATE_FILE)
    if not os.path.isfile(state_file):
        raise NotImplementedError(
            f"{base!r} holds no {STATE_FILE}: not a checkpoint of the "
            "PyTorch port (an Orbax checkpoint of the JAX package? reading "
            "those needs orbax and JAX, which the port leaves out: ROADMAP "
            "Queue 1 item 2)")
    out = dict(torch.load(state_file, map_location="cpu", weights_only=True))
    meta_path = base + ".meta.json"
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            out["metadata"] = json.load(f)
    return out
