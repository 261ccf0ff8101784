"""Sweep the correlation kernel's tile and channel split on the card.

    python -m opticalflow_tpu_torch.scripts.sweep_corr [--variants] [--iters N]

For every correlation level of a 448×1024 frame (B=1 and, at levels 2-4,
B=8) and of a 1088×1920 frame, float32, it times the kernel with the card
alone (``scripts/_timing.device_ms``: the calls queued behind a spin
kernel) at the tile and split the C entry point chooses and at every forced
tile (16, 32 columns) × split (1, 2, 4, 8), after checking each against the
plain version.  The plan's rule in ``csrc/correlation_fwd.cu``
(``make_plan``) was set from this table.

``--variants`` also builds, under ``_build/sweep/``, copies of the source
with one constant changed each (rows of dy a thread owns, the ring's shape,
the channel loop's unrolling) and sweeps them the same way, so a design
choice can be re-examined on another card without editing the kernel.
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from typing import Callable, Dict, List

import torch

from opticalflow_tpu_torch.ops import _build
from opticalflow_tpu_torch.ops._launch import raw_stream
from opticalflow_tpu_torch.ops.correlation import correlation_plain
from opticalflow_tpu_torch.scripts._timing import device_ms

__all__ = ["SHAPES", "VARIANTS", "main"]

# (name, B, C, H, W)
SHAPES = (("L2", 1, 32, 112, 256), ("L3", 1, 64, 56, 128),
          ("L4", 1, 96, 28, 64), ("L5", 1, 128, 14, 32),
          ("L6", 1, 196, 7, 16), ("L2 B=8", 8, 32, 112, 256),
          ("L3 B=8", 8, 64, 56, 128), ("L4 B=8", 8, 96, 28, 64),
          ("1088x1920 L2", 1, 32, 272, 480), ("1088x1920 L3", 1, 64, 136, 240),
          ("1088x1920 L4", 1, 96, 68, 120))
COMBOS = ((0, 0),) + tuple((t, s) for t in (16, 32) for s in (1, 2, 4, 8))

_NG = "static constexpr int NG = TW == 32 ? 3 : 9; "
_CC = "static constexpr int CC = TW == 32 ? 4 : 8; "
_ST = "static constexpr int STAGES = TW == 32 ? 4 : 2;"
_UNROLL = "#pragma unroll 1\n    for (int c = 0; c < cn;"
# name -> [(text in csrc/correlation_fwd.cu, its replacement)]
VARIANTS = {
    "3 dy rows a thread, both tiles": [(_NG, "static constexpr int NG = 3; ")],
    "1 dy row a thread, both tiles": [(_NG, "static constexpr int NG = 9; ")],
    "ring 4 stages x 4 channels, both tiles": [
        (_CC, "static constexpr int CC = 4; "),
        (_ST, "static constexpr int STAGES = 4;")],
    "ring 3 stages x 8 channels, both tiles": [
        (_CC, "static constexpr int CC = 8; "),
        (_ST, "static constexpr int STAGES = 3;")],
    "channel loop unrolled by 2": [
        (_UNROLL, _UNROLL.replace("unroll 1", "unroll 2"))],
}


def _bind(lib: ctypes.CDLL) -> Callable:
    fn = lib.corr_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _build_variants() -> Dict[str, Callable]:
    """One ``nvcc`` per variant, all started together."""
    source = (_build.CSRC_DIR / "correlation_fwd.cu").read_text()
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is no longer "
                                   "in correlation_fwd.cu")
            text = text.replace(old, new)
        src, lib = out / f"variant{i}.cu", out / f"variant{i}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC_DIR), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in log.splitlines() if "Used " in line})
        print(f"built variant {name!r}: registers {regs}", flush=True)
        fns[name] = _bind(ctypes.CDLL(str(lib)))
    return fns


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", action="store_true",
                   help="also build and sweep the source variants")
    p.add_argument("--iters", type=int, default=100)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_corr needs a CUDA device")
    fns = {"as committed": _bind(_build.load_library("correlation_fwd"))}
    if args.variants:
        fns.update(_build_variants())
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape_name, b, c, h, w in SHAPES:
        f1 = torch.randn(b, c, h, w, generator=g, device="cuda")
        f2 = torch.randn(b, c, h, w, generator=g, device="cuda")
        ref = correlation_plain(f1, f2, pad_size=4, max_displacement=4)
        out = torch.empty_like(ref)
        for name, fn in fns.items():
            cells = []
            for tile, split in COMBOS:
                if split > 1 and (c // split < 4 or b * h * w > 200000):
                    continue     # a split the plan never takes at this size

                def call(_):
                    err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b,
                             c, h, w, 4, 0, tile, split, 0, raw_stream(0))
                    if err:
                        raise RuntimeError(f"cudaError {err}")

                call(0)
                torch.cuda.synchronize()
                worst = float((out - ref).abs().max())
                if not worst <= 1e-5:
                    raise AssertionError(f"{shape_name} {name} tile {tile} "
                                         f"split {split}: off by {worst:.3e}")
                us = device_ms(call, args.iters) * 1e3
                rows.append({"shape": shape_name, "variant": name,
                             "tile": tile, "split": split, "us": us})
                cells.append(f"{'auto' if tile == 0 else f'{tile}/{split}'} "
                             f"{us:.2f}")
            print(f"{shape_name:13s} {name}: " + "  ".join(cells), flush=True)
    return rows


if __name__ == "__main__":
    main()
