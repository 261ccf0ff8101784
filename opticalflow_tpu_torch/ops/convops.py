"""Convolution / transposed-convolution primitives with the reference's
``nn.Conv2d`` / ``nn.ConvTranspose2d`` semantics (``models/PWCNet.py:26-36``).

NCHW activations and torch weight layouts (OIHW for convs, IOHW for
transposed convs), so reference checkpoints load with ``load_state_dict``
and no transposes.  Counterpart of ``opticalflow_tpu.ops.convops``, which
stores the transposed-conv kernel pre-flipped in HWIO instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "deconv2d", "leaky_relu"]


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, *, stride: int = 1,
           padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """NCHW conv matching torch Conv2d(stride, padding, dilation)."""
    return F.conv2d(x, weight, bias, stride=stride, padding=padding,
                    dilation=dilation)


def deconv2d(x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None = None, *, stride: int = 2,
             padding: int = 1) -> torch.Tensor:
    """NCHW ConvTranspose2d(k, s, p) with the torch IOHW weight; output
    size is in*s for the model's (k=4, s=2, p=1)."""
    return F.conv_transpose2d(x, weight, bias, stride=stride,
                              padding=padding)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """LeakyReLU(0.1), the activation used throughout PWC-Net."""
    return F.leaky_relu(x, negative_slope)
