"""Sweep a correlation kernel's tile and channel split on the card.

    python -m opticalflow_tpu_torch.scripts.sweep_corr [--fused | --bwd]
        [--variants] [--iters N] [--flow-px PX]

Without ``--fused`` the correlation kernel (``csrc/correlation_fwd.cu``):
for every correlation level of a 448×1024 frame (B=1 and, at levels 2-4,
B=8) and of a 1088×1920 frame, float32, it times the kernel with the card
alone (``scripts/_timing.device_ms``: the calls queued behind a spin
kernel) at the tile and split the C entry point chooses and at every forced
tile (16, 32 columns) × split (1, 2, 4, 8), after checking each against the
plain version.  With ``--fused`` the fused warp⊕correlation kernel
(``csrc/fused_warp_corr.cu``) the same way, at levels 2-5 (B=1, B=8) and
level 2 of 1088×1920, with flows of ``--flow-px`` pixels (default 3).
With ``--bwd`` the correlation backward kernel (``csrc/correlation_bwd.cu``)
at the 5 levels of a 320×896 training crop (B=4) and of a 448×1024 frame
(B=1), float32 and bfloat16, at its own plan and every forced tile (16, 32
columns) × split (1-32), each checked against ``correlation_bwd_plain``.
The plan's rule in each source (``make_plan``, ``make_bwd_plan``) was set
from these tables.

``--variants`` also builds, under ``_build/sweep/``, copies of the source
with one constant changed each (rows of dy a thread owns, the ring's shape,
the channel loop's unrolling, blocks per SM; for the backward also the
pixels and tile rows a thread owns, the tile's rows, the ring's element
type and how it is filled) and
sweeps them the same way,
so a design choice can be re-examined on another card without editing the
kernel.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from typing import Callable, Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.ops import _build
from opticalflow_tpu_torch.ops._launch import raw_stream
from opticalflow_tpu_torch.ops.correlation import (correlation_bwd_plain,
                                                   correlation_plain)
from opticalflow_tpu_torch.ops.fused_warpcorr import (fused_warp_corr_plain,
                                                      prep_gather)
from opticalflow_tpu_torch.scripts._timing import device_ms

__all__ = ["SHAPES", "VARIANTS", "FUSED_SHAPES", "FUSED_VARIANTS", "COMBOS",
           "BWD_SHAPES", "BWD_VARIANTS", "BWD_COMBOS", "main"]

# (name, B, C, H, W)
SHAPES = (("L2", 1, 32, 112, 256), ("L3", 1, 64, 56, 128),
          ("L4", 1, 96, 28, 64), ("L5", 1, 128, 14, 32),
          ("L6", 1, 196, 7, 16), ("L2 B=8", 8, 32, 112, 256),
          ("L3 B=8", 8, 64, 56, 128), ("L4 B=8", 8, 96, 28, 64),
          ("1088x1920 L2", 1, 32, 272, 480), ("1088x1920 L3", 1, 64, 136, 240),
          ("1088x1920 L4", 1, 96, 68, 120))
FUSED_SHAPES = (("L2", 1, 32, 112, 256), ("L3", 1, 64, 56, 128),
                ("L4", 1, 96, 28, 64), ("L5", 1, 128, 14, 32),
                ("L2 B=8", 8, 32, 112, 256), ("L3 B=8", 8, 64, 56, 128),
                ("L4 B=8", 8, 96, 28, 64), ("L5 B=8", 8, 128, 14, 32),
                ("1088x1920 L2", 1, 32, 272, 480))
COMBOS = ((0, 0),) + tuple((t, s) for t in (16, 32) for s in (1, 2, 4, 8))
# the backward: the levels of a 320x896 crop at B=4 (a training step) and of
# a 448x1024 frame at B=1
BWD_SHAPES = (("L2 B=4", 4, 32, 80, 224), ("L3 B=4", 4, 64, 40, 112),
              ("L4 B=4", 4, 96, 20, 56), ("L5 B=4", 4, 128, 10, 28),
              ("L6 B=4", 4, 196, 5, 14), ("L2 B=1", 1, 32, 112, 256),
              ("L3 B=1", 1, 64, 56, 128), ("L4 B=1", 1, 96, 28, 64),
              ("L5 B=1", 1, 128, 14, 32), ("L6 B=1", 1, 196, 7, 16))
BWD_COMBOS = ((0, 0),) + tuple((t, s) for t in (16, 32)
                               for s in (1, 2, 4, 8, 16, 32))

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
# a variant whose name starts so computes something else: it is timed, not
# checked
DIAGNOSTIC = "diagnostic: "
_FLOAD = "load_f(const float* p) { return __ldg(p); }"
_FNG = "static constexpr int NG = 9; "
_FCC = "static constexpr int CC = 4; "
_FBOUNDS = "::NT, TW == 32 ? 1 : 2)\nfused_warp_corr_kernel"
# name -> [(text in csrc/fused_warp_corr.cu, its replacement)]
FUSED_VARIANTS = {
    "3 dy rows a thread in the wide tile": [
        (_FNG, "static constexpr int NG = TW == 32 ? 3 : 9; ")],
    "2 channels a stage": [(_FCC, "static constexpr int CC = 2; ")],
    "8 channels a stage": [(_FCC, "static constexpr int CC = 8; ")],
    "narrow tile not held to two blocks an SM": [
        (_FBOUNDS, _FBOUNDS.replace(", TW == 32 ? 1 : 2)", ")"))],
    "channel loop unrolled by 2": [
        (_UNROLL, _UNROLL.replace("unroll 1", "unroll 2"))],
    # what the gather's loads cost: everything else, at a constant
    DIAGNOSTIC + "corner loads replaced by a constant": [
        (_FLOAD, "load_f(const float* p) { return 1.0f; }")],
    DIAGNOSTIC + "corner loads past L1 (ld.global.cg)": [
        (_FLOAD, "load_f(const float* p) { float r; asm volatile("
                 "\"ld.global.cg.f32 %0, [%1];\" : \"=f\"(r) : \"l\"(p)); "
                 "return r; }")],
    DIAGNOSTIC + "one corner load a value instead of four": [
        (f"v[k][c][{i}] = load_f({at});", f"v[k][c][{i}] = v[k][c][0];")
        for i, at in ((1, "p + (INNER ? 1 : dx1)"), (2, "q"),
                      (3, "q + (INNER ? 1 : dx1)"))],
}
_BPX = "constexpr int BPX = 4; "
_BDR = "constexpr int BDR = 1; "
_BCC = "constexpr int BCC = 4; "
_BST = "constexpr int BSTAGES = 3; "
_BTR = "static constexpr int TR = 4; "
_BMINB = "static constexpr int MINB = TW == 32 ? 2 : 4; "
_BUNROLL = "#pragma unroll 2\n    for (int c = 0; c < BCC; ++c)"
_BRING = "template <typename T> using Ring = T;"
# name -> [(text in csrc/correlation_bwd.cu, its replacement)]
BWD_VARIANTS = {
    "8 pixels a thread": [(_BPX, "constexpr int BPX = 8; ")],
    "2 rows a thread, on a diagonal": [(_BDR, "constexpr int BDR = 2; ")],
    "2 channels a stage": [(_BCC, "constexpr int BCC = 2; ")],
    "8 channels a stage": [(_BCC, "constexpr int BCC = 8; ")],
    "ring of 2 stages": [(_BST, "constexpr int BSTAGES = 2; ")],
    "ring of 4 stages": [(_BST, "constexpr int BSTAGES = 4; ")],
    "8-row tiles, one block an SM": [
        (_BTR, "static constexpr int TR = 8; "),
        (_BMINB, "static constexpr int MINB = 1; ")],
    "held to 1 block an SM": [
        (_BMINB, "static constexpr int MINB = 1; ")],
    "channel loop not unrolled": [
        (_BUNROLL, _BUNROLL.replace("unroll 2", "unroll 1"))],
    "weights through __ldg (the read-only path), as the first version": [
        ("float ld(const float* p) { return *p; }",
         "float ld(const float* p) { return __ldg(p); }"),
        ("u = *reinterpret_cast<const unsigned short*>(p);",
         "u = __ldg(reinterpret_cast<const unsigned short*>(p));")],
    "reduction with all nine loads in flight": [
        ("#pragma unroll 3\n        for (int tj = 0; tj < ND; ++tj)",
         "#pragma unroll\n        for (int tj = 0; tj < ND; ++tj)")],
    # bfloat16 widened to float32 as it is copied (element loads through
    # registers), and both dtypes filled so (the first version's fill)
    "bfloat16 widened into a float32 ring": [
        (_BRING, _BRING.replace("= T;", "= float;"))],
    "element copies into a float32 ring, both dtypes": [
        (_BRING, _BRING.replace("= T;", "= float;")),
        ("constexpr bool kCopy = sizeof(R) == sizeof(T);",
         "constexpr bool kCopy = false;")],
    # what the weights' loads and the partial sums' reduction cost
    DIAGNOSTIC + "no weights loaded (all zero)": [
        ("const bool rowok = tj >= 0 && tj < ND && yy >= 0 && yy < H;",
         "const bool rowok = false;")],
    DIAGNOSTIC + "no reduction of the partial sums": [
        ("it < cn * QT; it += L::NT", "it < 0; it += L::NT")],
}


class Target(NamedTuple):
    """What the sweep needs to know of a kernel."""
    source: str           # csrc/<source>.cu
    symbol: str           # its C entry point
    argtypes: list        # the entry point's ctypes, device and stream included
    shapes: tuple
    variants: dict
    tol: float            # absolute, against the plain version, float32


CORR = Target("correlation_fwd", "corr_fwd",
              [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
              SHAPES, VARIANTS, 1e-5)
BWD = Target("correlation_bwd", "corr_bwd",
             [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
             BWD_SHAPES, BWD_VARIANTS, 1e-5)
FUSED = Target("fused_warp_corr", "fused_warp_corr",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
               + [ctypes.c_int] * 3 + [ctypes.c_void_p],
               FUSED_SHAPES, FUSED_VARIANTS, 1e-4)
THR = 0.9999


def _bind(lib: ctypes.CDLL, target: Target) -> Callable:
    fn = getattr(lib, target.symbol)
    fn.argtypes = target.argtypes
    fn.restype = ctypes.c_int
    return fn


def _build_variants(target: Target) -> Dict[str, Callable]:
    """One ``nvcc`` per variant, all started together."""
    source = (_build.CSRC_DIR / f"{target.source}.cu").read_text()
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(target.variants.items()):
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is no longer "
                                   f"in {target.source}.cu")
            text = text.replace(old, new)
        src = out / f"{target.source}_variant{i}.cu"
        lib = src.with_suffix(".so")
        src.write_text(text)
        # the headers the source includes are found beside the original
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
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line and "0 bytes spill stores, 0 "
                         "bytes spill loads" not in line})
        print(f"built variant {name!r}: registers {regs}"
              + (f"  SPILLS {spills}" if spills else ""), flush=True)
        fns[name] = _bind(ctypes.CDLL(str(lib)), target)
    return fns


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fused", action="store_true",
                   help="sweep the fused warp+correlation kernel")
    p.add_argument("--bwd", action="store_true",
                   help="sweep the correlation backward kernel")
    p.add_argument("--variants", action="store_true",
                   help="also build and sweep the source variants")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--flow-px", type=float, default=3.0,
                   help="scale of the random flow (--fused)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_corr needs a CUDA device")
    if args.fused and args.bwd:
        p.error("--fused and --bwd are two different kernels")
    target = FUSED if args.fused else BWD if args.bwd else CORR
    fns = {"as committed": _bind(_build.load_library(target.source), target)}
    if args.variants:
        fns.update(_build_variants(target))
    if args.bwd:
        return _sweep_bwd(fns, args.iters)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape_name, b, c, h, w in target.shapes:
        f1 = torch.randn(b, c, h, w, generator=g, device="cuda")
        f2 = torch.randn(b, c, h, w, generator=g, device="cuda")
        if args.fused:
            flow = torch.randn(b, 2, h, w, generator=g,
                               device="cuda") * args.flow_px
            ref = fused_warp_corr_plain(f1, f2, flow, mask_threshold=THR)
            # outputs reached by a warped pixel whose mask sum is within
            # 1e-6 of the threshold are not compared
            _, _, wv = prep_gather(flow, h, w, 0.0)
            near = ((wv.sum(1, keepdim=True) - THR).abs() < 1e-6).float()
            keep = (F.max_pool2d(near, 9, 1, 4) == 0).float()
        else:
            ref = correlation_plain(f1, f2, pad_size=4, max_displacement=4)
            keep = 1.0
        out = torch.empty_like(ref)
        for name, fn in fns.items():
            cells = []
            for tile, split in COMBOS:
                if split > 1 and (c // split < 4 or b * h * w > 200000):
                    continue     # a split the plan never takes at this size

                def call(_):
                    if args.fused:
                        err = fn(f1.data_ptr(), f2.data_ptr(),
                                 flow.data_ptr(), out.data_ptr(), b, c, h, w,
                                 4, 0, THR, tile, split, 0, raw_stream(0))
                    else:
                        err = fn(f1.data_ptr(), f2.data_ptr(),
                                 out.data_ptr(), b, c, h, w, 4, 0, tile,
                                 split, 0, raw_stream(0))
                    if err:
                        raise RuntimeError(f"cudaError {err}")

                call(0)
                torch.cuda.synchronize()
                worst = float(((out - ref).abs() * keep).max())
                if not (worst <= target.tol or name.startswith(DIAGNOSTIC)):
                    raise AssertionError(f"{shape_name} {name} tile {tile} "
                                         f"split {split}: off by {worst:.3e}")
                us = device_ms(call, args.iters) * 1e3
                rows.append({"shape": shape_name, "variant": name,
                             "tile": tile, "split": split, "us": us})
                cells.append(f"{'auto' if tile == 0 else f'{tile}/{split}'} "
                             f"{us:.2f}")
            print(f"{shape_name:13s} {name}: " + "  ".join(cells), flush=True)
    return rows


def _device_us(call: Callable, iters: int, tries: int = 3) -> float:
    """``device_ms`` in µs, asked again (up to ``tries`` times) when the
    host fell behind the spin kernel, which a busy host sometimes does."""
    for attempt in range(tries):
        try:
            return device_ms(call, iters) * 1e3
        except RuntimeError:
            if attempt == tries - 1:
                raise
    raise AssertionError("unreachable")


def _sweep_bwd(fns: Dict[str, Callable], iters: int) -> List[dict]:
    """Every backward variant at every forced plan, float32 and bfloat16,
    each checked against the plain version: within 1e-5 (float32) or 1e-2
    (bfloat16) of the largest gradient."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        dt = str(dtype)[6:]
        sums = {}
        for shape_name, b, c, h, w in BWD_SHAPES:
            f1, f2 = (torch.randn(b, c, h, w, generator=g, device="cuda")
                      .to(dtype) for _ in range(2))
            gv = torch.randn(b, 81, h, w, generator=g,
                             device="cuda").to(dtype)
            ref = correlation_bwd_plain(f1, f2, gv, max_displacement=4)
            scale = max(float(r.float().abs().max()) for r in ref)
            tol = (1e-5 if code == 0 else 1e-2) * scale
            d1, d2 = torch.empty_like(f1), torch.empty_like(f1)
            for name, fn in fns.items():
                cells = []
                for tile, split in BWD_COMBOS:
                    if split > 1 and c // split < 4:
                        continue     # a split the plan never takes

                    def call(_):
                        err = fn(f1.data_ptr(), f2.data_ptr(), gv.data_ptr(),
                                 d1.data_ptr(), d2.data_ptr(), b, c, h, w, 4,
                                 code, tile, split, 0, raw_stream(0))
                        if err:
                            raise RuntimeError(f"cudaError {err}")

                    call(0)
                    torch.cuda.synchronize()
                    worst = max(float((d.float() - r.float()).abs().max())
                                for d, r in zip((d1, d2), ref))
                    if not (worst <= tol or name.startswith(DIAGNOSTIC)):
                        raise AssertionError(
                            f"{shape_name} {dt} {name} tile {tile} split "
                            f"{split}: off by {worst:.3e} > {tol:.3e}")
                    us = _device_us(call, iters)
                    rows.append({"shape": shape_name, "dtype": dt,
                                 "variant": name, "tile": tile,
                                 "split": split, "us": us})
                    if tile == 0:
                        sums[name, shape_name[-3:]] = sums.get(
                            (name, shape_name[-3:]), 0.0) + us
                    plan = "auto" if tile == 0 else f"{tile}/{split}"
                    cells.append(f"{plan} {us:.2f}")
                print(f"{shape_name:7s} {dt:8s} {name}: " + "  ".join(cells),
                      flush=True)
        for (name, batch), us in sums.items():
            print(f"5 levels, {batch} {dt}, own plan, {name}: {us:.2f} us",
                  flush=True)
    return rows


if __name__ == "__main__":
    main()
