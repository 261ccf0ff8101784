"""Checkpoint loading for the port: reference torch ``.pth(.tar)`` files.

Counterpart of ``opticalflow_tpu.train.checkpoints.load_params`` (torch-file
branch).  Orbax checkpoint directories need orbax and JAX, which the port
does not import; reading them is ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from opticalflow_tpu_torch.models.torch_import import (load_torch_state_dict,
                                                        reference_state_dict)

__all__ = ["load_params"]

_TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt", ".tar")


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference torch checkpoint → the port's state dict, ready for
    ``PWCDCNet.load_state_dict`` (strict)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path!r} is a directory (an Orbax checkpoint?): the PyTorch "
            "port reads torch .pth(.tar) files only; Orbax loading is "
            "ROADMAP Queue 1 item 5")
    if path.endswith(_TORCH_SUFFIXES):
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"checkpoint not found: {path!r} (pass --ckpt with a valid "
                "torch .pth(.tar) file)")
        return reference_state_dict(load_torch_state_dict(path))
    raise ValueError(f"unrecognized checkpoint {path!r}: expected a torch "
                     f"file ({'/'.join(_TORCH_SUFFIXES)})")
