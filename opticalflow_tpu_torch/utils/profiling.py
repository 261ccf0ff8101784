"""Profiling and complexity: timing, FLOP counts, the per-layer table and
device traces.

Counterpart of ``opticalflow_tpu.utils.profiling``; the reference's
ptflops MACs/params print (``pwc_extract_flow_video.py:178-184``) becomes
:func:`model_complexity` and :func:`per_layer_complexity`.

What is counted: FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``,
which counts convolutions, transposed convolutions and matrix products (a
multiply-add is 2 FLOPs; a convolution's bias is not counted).  It does not
count elementwise work (LeakyReLU, the warp, concatenation copies) nor the
correlation, which is its own operator.  XLA's cost analysis, which the JAX
package reports, counts those too, so the JAX package's totals are larger
by design.  On PWC-Net the convolutions are nearly all of the arithmetic.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn

__all__ = ["timeit", "flops_estimate", "param_count", "model_complexity",
           "per_layer_complexity", "trace"]


def param_count(params: Union[nn.Module, Mapping]) -> int:
    """Number of parameters of a module, or of a state dict's tensors."""
    tensors = (params.parameters() if isinstance(params, nn.Module)
               else params.values())
    return sum(int(t.numel()) for t in tensors)


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 2,
           **kwargs) -> Dict[str, float]:
    """Mean wall time of ``fn(*args, **kwargs)`` over ``iters`` calls after
    ``warmup`` calls; the GPU is synchronised before and after the timed
    loop, so queued work is inside the time."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _synchronize()
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "iters_per_s": 1.0 / dt}


def flops_estimate(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call of ``fn(*args)`` by ``FlopCounterMode`` (what it
    counts: the module docstring), or None if the call fails under it."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
    except Exception:     # any failure of the call: no estimate
        return None
    return float(counter.get_total_flops())


def _model_input(model: nn.Module, input_shape) -> torch.Tensor:
    p = next(model.parameters(), None)
    return torch.zeros(input_shape, dtype=torch.float32,
                       device=p.device if p is not None else "cpu")


def model_complexity(model: nn.Module,
                     input_shape: Tuple[int, ...] = (1, 6, 384, 512)
                     ) -> Dict:
    """Params and FLOPs of one forward at ``input_shape`` (NCHW), the
    ptflops print's equivalent: ``{"params", "params_m", "input_shape",
    "flops", "gmacs"}`` (the last two absent if the count failed)."""
    x = _model_input(model, input_shape)
    flops = flops_estimate(model, x)
    n = param_count(model)
    out = {"params": n, "params_m": n / 1e6,
           "input_shape": tuple(input_shape)}
    if flops is not None:
        out["flops"] = flops
        out["gmacs"] = flops / 2e9
    return out


def per_layer_complexity(model: nn.Module,
                         input_shape: Tuple[int, ...] = (1, 6, 384, 512)
                         ) -> str:
    """Per-layer table of one forward at ``input_shape`` (NCHW): one row per
    top-level module (JAX's ``nn.tabulate(depth=1)``) with its type, output
    shape, params and FLOPs, then the totals.  The siamese pyramid runs
    both frames as one batch, so its output shapes have 2B rows."""
    from torch.utils.flop_counter import FlopCounterMode
    x = _model_input(model, input_shape)
    shapes: Dict[str, Tuple[int, ...]] = {}
    hooks = []
    for name, child in model.named_children():
        def record(mod, inp, out, name=name):
            y = out[0] if isinstance(out, (tuple, list)) else out
            shapes[name] = tuple(y.shape)
        hooks.append(child.register_forward_hook(record))
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x)
    finally:
        for h in hooks:
            h.remove()
    counts = counter.get_flop_counts()
    root = type(model).__name__
    rows = []
    for name, child in model.named_children():
        flops = sum(counts.get(f"{root}.{name}", {}).values())
        rows.append((name, type(child).__name__,
                     "x".join(str(d) for d in shapes.get(name, ())) or "-",
                     param_count(child), flops))
    total_flops = counter.get_total_flops()
    head = ("module", "type", "output shape", "params", "flops")
    body = [(n, t, s, f"{p:,}", f"{f:,}") for n, t, s, p, f in rows]
    body.append(("total", root, "x".join(str(d) for d in input_shape),
                 f"{param_count(model):,}", f"{total_flops:,}"))
    widths = [max(len(r[i]) for r in [head, *body]) for i in range(5)]

    def fmt(r):
        return "  ".join(c.ljust(w) if i < 3 else c.rjust(w)
                         for i, (c, w) in enumerate(zip(r, widths)))

    rule = "-" * len(fmt(head))
    return "\n".join([fmt(head), rule, *map(fmt, body[:-1]), rule,
                      fmt(body[-1]),
                      "flops: convolutions and matrix products only "
                      "(FlopCounterMode; 2 per multiply-add), not the "
                      "correlation nor elementwise work"])


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write a Chrome trace, ``{log_dir}/trace.json``,
    viewable in Perfetto or ``chrome://tracing``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
