"""Row gather ``out[i] = x[idx[i]]``: the port's kernel against
``torch.index_select`` on the card.

Counterpart of the JAX package's ``scripts/probe_gather.py``, at its shape
and seeds: x (2048, 128) float32 from seed 0, idx (4096, 1) int32 in
[0, 2048) from seed 1.

    python -m opticalflow_tpu_torch.scripts.probe_gather [--device cuda|cpu]

Prints, for the kernel (``ops/gather.py``) and for ``torch.index_select``,
whether the rows equal numpy's ``x[idx]``, µs per call and M rows/s (CUDA
events over back-to-back calls), the host's µs to issue one call and the
card's µs alone (calls queued behind a spin kernel), each the median of five
rounds in which the two functions alternate; then the wrapper's host
time by piece (``torch.empty``, the three ``data_ptr`` calls, the raw stream
handle, the ctypes call with its launch; the argument checks are the rest);
then both at 2^20 rows, where the card's time dominates.  With
``--device cpu`` it checks the plain version and skips timing.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from opticalflow_tpu_torch.engine import resolve_device
from opticalflow_tpu_torch.ops import gather
from opticalflow_tpu_torch.ops._launch import raw_stream
from opticalflow_tpu_torch.ops.gather import row_gather
from opticalflow_tpu_torch.scripts._timing import (bound, cuda_ms, device_ms,
                                                   host_ms)

__all__ = ["gather_bound", "wrapper_pieces", "main", "N", "M", "C"]

N, M, C = 2048, 4096, 128
ROUNDS = 5         # alternating timing rounds per function; medians reported
LARGE = 1 << 20    # rows of the large run: 512 MiB written


def gather_bound(m: int, c: int, distinct: int):
    """Least time of one gather: the ``distinct`` rows of c float32 that
    the indices name read once, m int32 indices read and m rows written.
    There are no operations to count."""
    return bound((distinct + m) * c * 4 + m * 4, 0.0)


def wrapper_pieces(x: torch.Tensor, idx: torch.Tensor, iters: int = 2000):
    """Host ms per call of the pieces of ``row_gather_cuda(x, idx)``: the
    output's ``torch.empty``, three ``data_ptr`` calls, the raw stream
    handle, the ctypes call (stream handle and ``cudaLaunchKernel``
    included), the whole wrapper, and the rest (its argument checks and
    Python's own call overhead)."""
    m, c, n = idx.shape[0], x.shape[1], x.shape[0]
    index = x.device.index
    out = torch.empty((m, c), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), idx.data_ptr(), out.data_ptr())
    fn = gather._kernel.load()
    device = x.device
    pieces = {
        "empty_ms": host_ms(lambda _: torch.empty(
            m, c, dtype=torch.float32, device=device), iters),
        "data_ptr_x3_ms": host_ms(lambda _: (x.data_ptr(), idx.data_ptr(),
                                             out.data_ptr()), iters),
        "raw_stream_ms": host_ms(lambda _: raw_stream(index), iters),
        "ctypes_launch_ms": host_ms(lambda _: fn(*ptrs, n, m, c, index,
                                                 raw_stream(index)), iters),
        "wrapper_ms": host_ms(lambda _: gather.row_gather_cuda(x, idx),
                              iters),
    }
    pieces["checks_and_rest_ms"] = (
        pieces["wrapper_ms"] - pieces["empty_ms"] - pieces["data_ptr_x3_ms"]
        - pieces["ctypes_launch_ms"])
    return pieces


def main(argv=None) -> dict:
    """Runs the probe; returns {"kernel": row, "index_select": row} (empty
    on the CPU)."""
    p = argparse.ArgumentParser(
        description="row gather kernel vs torch.index_select")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = resolve_device(p.parse_args(argv).device)
    x_np = np.random.RandomState(0).randn(N, C).astype(np.float32)
    idx_np = np.random.RandomState(1).randint(0, N, (M, 1)).astype(np.int32)
    ref = x_np[idx_np[:, 0]]
    x = torch.from_numpy(x_np).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    flat = idx.reshape(-1)

    calls = {"kernel": lambda: row_gather(x, idx),
             "index_select": lambda: torch.index_select(x, 0, flat)}
    if device.type != "cuda":
        ok = np.array_equal(row_gather(x, idx).numpy(), ref)
        print(f"row_gather (plain, cpu): correct={ok}")
        print("not on the GPU — timing skipped")
        if not ok:
            raise AssertionError("row_gather disagrees with numpy")
        return {}
    rows = {}
    distinct = len(np.unique(idx_np))
    b_ms, b_by = gather_bound(M, C, distinct)
    # the host's pace differs from one second to the next, so the two
    # functions are timed in alternating rounds and each reports its median
    samples = {name: {"ms": [], "host_ms": [], "device_ms": []}
               for name in calls}
    for _ in range(ROUNDS):
        for name, fn in calls.items():
            samples[name]["ms"].append(cuda_ms(lambda _: fn(), 200))
            samples[name]["host_ms"].append(host_ms(lambda _: fn(), 200))
            samples[name]["device_ms"].append(device_ms(lambda _: fn(), 200))
    for name, fn in calls.items():
        ok = np.array_equal(fn().cpu().numpy(), ref)
        med = {k: float(np.median(v)) for k, v in samples[name].items()}
        rows[name] = {"correct": ok, **med,
                      "rows_per_s": M / (med["ms"] * 1e-3),
                      "host_ms_rounds": samples[name]["host_ms"],
                      "bound_ms": b_ms, "bound_by": b_by}
        print(f"{name}: correct={ok}  {med['ms'] * 1e3:.2f} us/call "
              f"({M / (med['ms'] * 1e-3) / 1e6:.1f} M rows/s)  host "
              f"{med['host_ms'] * 1e3:.2f} us/call to queue (rounds: "
              + " ".join(f"{h * 1e3:.2f}" for h in samples[name]["host_ms"])
              + f"), card alone {med['device_ms'] * 1e3:.2f} us  bound "
              f"{b_ms * 1e3:.2f} us ({b_by}, {distinct} distinct rows)",
              flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with numpy")
    rows["wrapper_pieces"] = wrapper_pieces(x, idx)
    print("row_gather_cuda host time by piece, us/call: " + "  ".join(
        f"{k[:-3]} {v * 1e3:.2f}" for k, v in rows["wrapper_pieces"].items()),
        flush=True)
    # the same indices 256 times over, where the card's time dominates the
    # host's
    big = torch.from_numpy(idx_np).to(device).repeat(LARGE // M, 1)
    b_ms, b_by = gather_bound(LARGE, C, distinct)
    for name, fn in (("kernel", lambda _: row_gather(x, big)),
                     ("index_select",
                      lambda _: torch.index_select(x, 0, big.reshape(-1)))):
        ms = cuda_ms(fn, 20)
        rows[f"{name}_large"] = {"ms": ms, "bound_ms": b_ms,
                                 "bound_by": b_by}
        print(f"{name} at M={LARGE}: {ms * 1e3:.2f} us/call "
              f"({LARGE / (ms * 1e-3) / 1e6:.1f} M rows/s)  bound "
              f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
    return rows


if __name__ == "__main__":
    main()
