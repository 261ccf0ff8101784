"""Device timing and roofline bounds shared by the probes and
``chip_smoke.py``.

The peaks are the NVIDIA H100 SXM data sheet's (dense, 700 W): HBM3
bandwidth; the float32 rate outside the tensor cores; the bfloat16 rate of
the tensor cores (products of bf16 operands, float32 sums).  A bound is the
larger of bytes over the memory rate and operations over the peak rate for
the operands' type: the least time the card could take for the work,
whatever units a kernel actually uses.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS_PER_S", "BF16_FLOPS_PER_S",
           "cuda_ms", "host_ms", "device_ms", "bound"]


def cuda_ms(fn: Callable[[int], object], iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` back-to-back calls
    (i = 0, 1, ...), by CUDA events, after ``warmup`` calls."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn: Callable[[int], object], iters: int, warmup: int = 3) -> float:
    """Mean host time to issue ``fn(i)``: the host clock over ``iters``
    calls with no synchronisation inside.  Where it is close to
    :func:`cuda_ms` of the same calls, the host, not the card, sets their
    pace."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def device_ms(fn: Callable[[int], object], iters: int,
              warmup: int = 3, attempts: int = 4) -> float:
    """Mean device time of ``fn(i)`` with the host out of the way: a spin
    kernel holds the stream until all ``iters`` calls are queued, so the
    card runs them back to back however slowly the host issues them.
    A window where the spin ended before the host had queued every call
    (a host stall longer than the margin) is measured again with a spin
    four times as long; raises after ``attempts`` such windows."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0          # one call, host and card
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin for twice the time the host needs, counted at 2 GHz (the card's
    # clock is at most that, so the spin lasts at least as long)
    spin_s = 2 * iters * one_s + 1e-3
    for _ in range(attempts):
        torch.cuda._sleep(int(2e9 * spin_s))
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        spin_s *= 4
    raise RuntimeError("device_ms: the host did not queue every call "
                       f"before the card reached them ({attempts} windows)")


def bound(nbytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> Tuple[float, str]:
    """(least time in ms, "bytes" | "operations") for work that must move
    ``nbytes`` through device memory and do ``flops`` operations at the
    peak ``flops_per_s`` of their type (float32 unless given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
