"""Weights into the port's :class:`PWCDCNet` (``models/pwcnet.py``).

The port's modules carry the reference's own state-dict names and layouts
(OIHW conv weights, IOHW transposed-conv weights), so a reference
checkpoint needs no conversion, only unwrapping:

  * :func:`load_torch_state_dict` reads any of the three reference layouts
    (flat, ``{'state_dict': ...}``, ``{'model'/'model_state_dict': ...}``,
    ``models/PWCNet.py:500-506``, ``train.py:165-171``) and strips the
    ``module.`` DataParallel prefix (``train.py:148``);
  * :func:`reference_state_dict` drops the ``deconv2`` the reference creates
    but never applies (``models/PWCNet.py:124`` vs ``:256-268``), so
    everything else can load strictly.

:func:`state_dict_from_jax` carries the JAX package's flax parameters
(nested dicts of numpy arrays, NHWC/HWIO) across: HWIO → OIHW, and for
``deconv*``/``upfeat*`` the flipped HWIO equivalent-conv kernel back to the
IOHW transposed-conv weight, the inverse of the JAX importer.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["load_torch_state_dict", "reference_state_dict",
           "state_dict_from_jax"]

# torch modules whose weights are ConvTranspose2d (IOHW)
_DECONV_PREFIXES = ("deconv", "upfeat")
# modules that are a bare conv, not Sequential(conv, LeakyReLU)
_BARE_CONV_PREFIXES = ("predict_flow", "dc_conv7")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch checkpoint file into a flat {name: tensor} dict on the
    CPU, unwrapping the reference layouts and ``module.`` prefixes.  Only
    tensors and plain containers are unpickled (``weights_only=True``)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(data, Mapping):
        for key in ("state_dict", "model_state_dict", "model"):
            if key in data and isinstance(data[key], Mapping):
                data = data[key]
                break
    return {k[len("module."):] if k.startswith("module.") else k:
            torch.as_tensor(v) for k, v in data.items()}


def reference_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference state dict (tensors or numpy arrays) → the port's: float32
    tensors, ``module.`` stripped, the dead ``deconv2`` dropped."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("deconv2."):
            continue
        out[k] = torch.as_tensor(v, dtype=torch.float32)
    return out


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``PWCDCNet`` params ``{module: {"kernel", "bias"}}`` → the port's
    state dict (float32 CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    for mod, entry in params.items():
        deconv = mod.startswith(_DECONV_PREFIXES)
        prefix = (mod if deconv or mod.startswith(_BARE_CONV_PREFIXES)
                  else f"{mod}.0")
        w = np.asarray(entry["kernel"], np.float32)
        if deconv:
            # flipped HWIO equivalent-conv kernel → IOHW ConvTranspose2d
            w = np.flip(w.transpose(2, 3, 0, 1), axis=(2, 3))
        else:
            w = w.transpose(3, 2, 0, 1)          # HWIO → OIHW
        sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        sd[f"{prefix}.bias"] = torch.from_numpy(
            np.array(entry["bias"], np.float32))
    return sd
