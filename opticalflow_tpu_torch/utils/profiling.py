"""Parameter count of a model (the reference's ptflops load-time print).

Only ``param_count`` of ``opticalflow_tpu.utils.profiling`` is ported; the
per-layer FLOP table (``--complexity``), the timing harness and the device
traces are ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch.nn as nn

__all__ = ["param_count"]


def param_count(params: Union[nn.Module, Mapping]) -> int:
    """Number of parameters of a module, or of a state dict's tensors."""
    tensors = (params.parameters() if isinstance(params, nn.Module)
               else params.values())
    return sum(int(t.numel()) for t in tensors)
