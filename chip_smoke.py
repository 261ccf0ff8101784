#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``opticalflow_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from the
sources there.  Every phase fails loudly (an assertion or exception exits
non-zero, and no result line is printed):

  1. build the four kernels (one ``nvcc`` each, started together) and
     print the build time and the compiler's register/shared-memory report
     (no instantiation may spill);
  2. hold the correlation kernel (K1/K2) against its plain PyTorch version
     on the card: every level of a 448x1024 input at B=1 and B=8, the
     1088x1920 level-2 shape and a ragged shape, float32 and bfloat16; then,
     per level at 448x1024 (B=1, B=8) and at 1088x1920, in float32 and
     bfloat16: two runs bit-equal, the tile, grid and channel split the
     kernel chose, its time on the card alone, by CUDA events back to back
     and the host's time to queue it, beside its bound and the plain
     version;
  3. hold the fused warp+correlation kernel (K3) against its plain version:
     levels 2-5 of 448x1024 at B=1 and B=8, the ragged 9x45x20 and the
     1088x1920 level 2, float32 and bfloat16, both mask thresholds, flows
     of x3 and x20 px; then its probe entry point, which checks it and, per
     level 2-5 at B=1 and B=8 in float32 and bfloat16, prints the plan the
     kernel chose, that two runs gave the same bits, and its time on the
     card alone, by events and on the host beside the composed path's
     (warp, then K1) and the bound, for noise flows of x3 and x20 px and a
     smooth flow;
  4. hold the row gather kernel (K4) against its plain version, exactly and
     NaN rows included; then its probe entry point, beside
     ``torch.index_select``, with the wrapper's host time by piece; and the
     card's time for the smallest launch through the shared launch path
     (one row), the floor under every B=1 time above;
  5. the main path through its entry points: the single-pair CLI on the
     real golden frames with fake reference weights, in pad mode against
     ``tests/goldens/real_pair_pad.flo`` and in its default resize mode
     against ``real_pair.flo``, and ``FlowEngine`` in pad_ref mode against
     ``real_pair_padref.flo``, 5 kernel launches each, OpenCV never
     imported;
  6. full width: ``FlowEngine`` in pad and resize mode at Sintel 436x1024,
     float32, B=1 and B=8 — pairs/s, latency, peak memory, and the host
     resize alone; the forward alone by CUDA events;
  7. hold the correlation backward kernel (B1) against its plain version:
     every level of a 320x896 training crop at B=4 and of a 448x1024 frame
     at B=1, float32 and bfloat16, two runs bit-equal; per level its time
     on the card alone and by events beside its bound and the plain
     version, and its plan (tile, split, blocks an SM, registers);
  8. the training step at full width (``train.trainer``, the multiscale
     loss, AdamW lr 1e-4, wd 1e-4, clip 1.0, a seeded batch of 4 x 320x896):
     in float32 parity mode one step's gradients through K1 and B1 against
     the same step through the plain correlation; then 10 steps in the
     fast mode, which must lower the loss, 5 K1 and 5 B1 launches each —
     ms per step and pairs/s;
  9. evaluation: synthetic KITTI 2015 (375x1242, 16-bit GT written by the
     port from the engine's own flow, ~30% invalid) and Sintel (436x1024,
     ``.flo`` GT) trees through ``cli/infer_kitti`` and ``cli/eval_sintel``
     at batch 2 (the last chunk padded): EPE within the PNG's 1/64 px and
     below 1e-3 — pairs/s;
 10. the training CLI (``cli/train.main`` with the fake weights as
     ``--pretrained``): (a) the multiscale regime at 4x320x896 over 2
     epochs on a synthetic KITTI training tree (16 pairs of 375x1242, a
     smooth known motion, ~30% invalid; --val-frac 0.25): three
     uninterrupted runs, and one preempted by SIGTERM after its first step
     and resumed, which must start from the state the preempted run saved,
     bit for bit (parameters, AdamW's moments and step counts, learning
     rates, step), log steps 1..N once each, see the same batches (CRC-32
     of their images) and end within 4x the largest pairwise spread of the
     uninterrupted runs in parameters and per-step losses; (b) the epipolar
     regime (--epi-soft-w 0.1, 384x512) on frames of a moving camera:
     finite losses and Sampson term, masks neither empty nor full, 10 K1
     and 5 B1 launches a step; (c) the CLI's samples/s (its own print,
     and its steady rate from the steps' start times in a 4-epoch run
     without validation), the loader alone and the step alone on a batch
     on the card;
 11. streaming video: on the card, K1/K2 against the plain correlation at
     every level the video path gives it (768x1280 and 1088x1920, B=4,
     float32 and bfloat16, phase 2's tolerances), the I420 unpack
     bit-exact to ``io/yuv``, the grid decimation within 1e-4 of the
     host's, and in float32 parity mode the i420 runner against the bgr
     runner fed I420-round-tripped frames (1e-4); then
     ``cli/extract_video`` with the fake weights on a 240-frame 720x1280
     moving clip (.y4m, written by the port) at B=4 in bfloat16, in each
     mode (arrows with both uploads, color, vanish --shrink 0.75, topview;
     40-240 frames each) and in arrows on a 64-frame 1080x1920 clip: each
     output's frame count and size (N-1 frames), 5 K1 launches a window,
     (B+1) frames' bytes uploaded a window (I420: 1.5 bytes a pixel,
     unpadded); each run's fps from its first frame read to its writer's
     release, its fill, and the host's busy ms a frame and share of the
     run by stage and thread (decode, warp, upload, issue, wait, draw,
     encode); the forward alone; the engine's ``resize_fixed`` (engine
     and ``cli/infer_kitti``) against the port on the CPU (1e-4) and
     ``flow_from_batch`` against the pad path;
 12. serving: ``cli/serve`` in a child process at its defaults (bfloat16
     fast, --max-batch 8, --max-delay-ms 5, auto buckets, --warmup
     436x1024) with the fake weights; 16 client threads send 128 raw
     requests of moving 436x1024 pairs, then one client 16 in a row (the
     B=1 bucket), then 4 JSON requests of the same frames as base64 PNGs,
     which must return the raw route's bytes; /healthz and /metrics
     (requests, errors, batches); a burst of 16 drained by SIGTERM (every
     answer 200, exit code 0); K1 5 times a batch and a warm-up forward;
     requests/s, p50/p90/p99 latency of both, mean occupancy, the dispatch
     thread's share of the burst in the engine and in the host resize,
     peak memory; a float32 parity-mode ``FlowServer`` in this process,
     each response within 1e-4 mean EPE of ``flow_from_pair``; the engine
     alone at B=8 and B=1 in the CLI's mode;
 13. export: the float32 parity model exported with the correlation
     operator (``dynamic="all"``), loaded and run at 1x448x1024,
     4x448x1024, 1x64x64 and 2x1088x1920 against the eager model
     (epe_mean < 1e-5, agree@0.25 100%), 5 K1 launches a call; an
     artifact of the plain correlation (static, 1x448x1024) against it;
     ``cli/parity`` at 1x448x1024 (PARITY: PASS, its report PNG); export
     time and each forward by CUDA events beside the eager model's;
 14. one JSON line listing every kernel with its launches on its path,
     error, times and bound; the card's name and power limit; the result
     line.

Each kernel's launch count is set to 0 just before its path and read just
after: the CLI and engine for K1, the probe entry points for K3 and K4, the
training steps for B1 (and K1 there), the eval CLIs (K1), the training
CLI's runs (K1 and B1), the video CLIs' runs (K1), the serving CLI (K1,
counted in its own process from 0) and the parity-mode server's burst, the
loaded artifacts and the parity CLI (K1).
The weights are random: ``tests/oracles/torch_pwcnet.py``'s ``OraclePWC``
from ``torch.manual_seed(0)``, ×0.5 (the recipe the goldens were made with).
The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(ROOT, "tests", "goldens")

MD = 4
ND2 = (2 * MD + 1) ** 2
# (name, H, W, C) of the correlation inputs at each pyramid level of a
# 448x1024 frame (the Sintel 436x1024 padded to /64)
LEVELS = (("L2", 112, 256, 32), ("L3", 56, 128, 64), ("L4", 28, 64, 96),
          ("L5", 14, 32, 128), ("L6", 7, 16, 196))
# the same levels of a 1088x1920 frame (the Pallas windowed kernel's domain)
LEVELS_1080 = (("L2", 272, 480, 32), ("L3", 136, 240, 64),
               ("L4", 68, 120, 96), ("L5", 34, 60, 128),
               ("L6", 17, 30, 196))
# level 2 of 1088x1920, and a shape whose W is not a multiple of the
# kernels' 32-column tile nor H of their 4-row tile
EXTRA_SHAPES = (("L2@1088x1920", 272, 480, 32), ("ragged", 9, 45, 20))
FULL_H, FULL_W = 436, 1024
# the training crop and batch (the JAX cli/train.py defaults --crop 320 896,
# --batch 4) and the correlation inputs at each of its pyramid levels
TRAIN_B, TRAIN_H, TRAIN_W = 4, 320, 896
TRAIN_LEVELS = (("L2", 80, 224, 32), ("L3", 40, 112, 64),
                ("L4", 20, 56, 96), ("L5", 10, 28, 128), ("L6", 5, 14, 196))
KITTI_H, KITTI_W = 375, 1242


def log(msg: str) -> None:
    print(msg, flush=True)


def epe(a, b) -> float:
    import numpy as np
    return float(np.mean(np.hypot(*(a - b).transpose(2, 0, 1))))


def corr_bound(b: int, h: int, w: int, c: int, itemsize: int = 4):
    """Least time for one correlation call on features of ``itemsize``
    bytes: f1 and f2 read once, the 81 maps written once, against the FMAs
    it must do at the float32 rate (bfloat16 features at the tensor cores'
    bfloat16 rate).  Returns (bound_ms, "bytes" | "operations")."""
    from opticalflow_tpu_torch.scripts._timing import (BF16_FLOPS_PER_S,
                                                       FP32_FLOPS_PER_S,
                                                       bound)
    return bound((2 * b * c * h * w + b * ND2 * h * w) * itemsize,
                 2.0 * b * ND2 * c * h * w,
                 FP32_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S)


def corr_bwd_bound(b: int, h: int, w: int, c: int, itemsize: int = 4):
    """Least time for one backward call: f1, f2 and the volume's gradient
    read once, d1 and d2 written once, against its 4·81·C·B·H·W operations
    (float32 rate; bfloat16 at the tensor cores' rate, as for K1)."""
    from opticalflow_tpu_torch.scripts._timing import (BF16_FLOPS_PER_S,
                                                       FP32_FLOPS_PER_S,
                                                       bound)
    n = b * h * w
    return bound(itemsize * n * (2 * c + ND2) + itemsize * n * 2 * c,
                 4.0 * ND2 * c * n,
                 FP32_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S)


def summed(rows, key_ms="ms"):
    """One forward's worth of per-level rows: the sums of the times and
    bounds, and what bounds the sum."""
    t_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    total = sum(r["bound_ms"] for r in rows)
    extra = {k: sum(r[k] for r in rows) for k in ("device_ms", "host_ms")
             if all(k in r for r in rows)}
    return {"ms": sum(r[key_ms] for r in rows), **extra,
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": total,
            "bound_by": "bytes" if t_bytes >= 0.5 * total else "operations"}


def phase_build():
    from opticalflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build(_build.KERNEL_SOURCES)
    log(f"[1] built {len(paths)} kernel(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    assert set(paths) == {"correlation_fwd", "correlation_bwd",
                          "fused_warp_corr", "row_gather"}, sorted(paths)
    for name, path in paths.items():
        report = path.with_name(path.name + ".ptxas.txt")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
            if "spill" in line:
                assert "0 bytes spill stores, 0 bytes spill loads" in line, \
                    f"{name} spills: {line.strip()}"


def corr_check(shapes, g, tag: str):
    """K1/K2 against the plain correlation on the card at each (batch,
    (name, H, W, C)) of ``shapes``, float32 and bfloat16, on random inputs;
    fails on any value over the tolerance.  Returns the max abs error by
    dtype."""
    import torch
    from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda
    from opticalflow_tpu_torch.ops.correlation import correlation_plain
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b, (name, h, w, c) in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            f1 = torch.randn(b, c, h, w, generator=g, device="cuda").to(dtype)
            f2 = torch.randn(b, c, h, w, generator=g, device="cuda").to(dtype)
            out = correlation_cuda(f1, f2, max_displacement=MD)
            ref = correlation_plain(f1, f2, pad_size=MD,
                                    max_displacement=MD)
            torch.cuda.synchronize()
            assert out.shape == ref.shape == (b, ND2, h, w), out.shape
            assert out.dtype == dtype
            err = (out.float() - ref).abs()
            if dtype == torch.float32:
                # float32 sums of <=196 products in another order
                tol = torch.full_like(ref, 1e-5)
            else:
                # one bf16 rounding of the float32 sum: 2^-9 relative,
                # doubled for the plain version's summation order
                tol = ref.abs() * 2.0 ** -8 + 1e-6
            bad = int((err > tol).sum())
            e = float(err.max())
            worst[dtype] = max(worst[dtype], e)
            log(f"{tag} {name:13s} B={b} {str(dtype)[6:]:8s} ({h}x{w}x{c}) "
                f"max|kernel-plain| {e:.3e}" + ("" if not bad else
                                                 f"  {bad} OVER TOLERANCE"))
            assert bad == 0, f"kernel disagrees with plain at {name} {dtype}"
            del f1, f2, out, ref, err, tol
    return worst


def phase_corr_vs_plain():
    """K1/K2 against the plain version, then timed.  Returns (max f32
    error, 448x1024 rows, 1088x1920 rows, bfloat16 rows)."""
    import torch
    from opticalflow_tpu_torch.ops.corr_cuda import (correlation_cuda,
                                                     launch_plan)
    from opticalflow_tpu_torch.ops.correlation import correlation_plain
    from opticalflow_tpu_torch.scripts._timing import (cuda_ms, device_ms,
                                                       host_ms)

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(b, s) for b in (1, 8) for s in LEVELS] + [
        (1, s) for s in EXTRA_SHAPES]
    worst = corr_check(shapes, g, "[2]")

    def time_levels(levels, batches, frame, dtype=torch.float32):
        rows = []
        for b in batches:
            for name, h, w, c in levels:
                f1 = torch.randn(b, c, h, w, generator=g,
                                 device="cuda").to(dtype)
                f2 = torch.randn(b, c, h, w, generator=g,
                                 device="cuda").to(dtype)

                def call(_):
                    return correlation_cuda(f1, f2, max_displacement=MD)

                # the channel split is reduced in a fixed order: two runs
                # give the same bits
                same_bits = torch.equal(call(0), call(1))
                assert same_bits, f"two runs differ at {frame} {name} B={b}"
                plan = launch_plan(b, c, h, w, dtype)
                k_ms = cuda_ms(call, 200)       # back to back from Python
                d_ms = device_ms(call, 200)     # the card alone
                h_ms = host_ms(call, 200)       # the host's time to queue one
                p_ms = cuda_ms(lambda _: correlation_plain(
                    f1, f2, pad_size=MD, max_displacement=MD), 10)
                bound_ms, bound_by = corr_bound(b, h, w, c,
                                                f1.element_size())
                rows.append({"level": name, "frame": frame, "batch": b,
                             "dtype": str(dtype)[6:], "shape": [h, w, c],
                             "ms": k_ms, "device_ms": d_ms, "host_ms": h_ms,
                             "plain_ms": p_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "same_bits": same_bits,
                             **plan})
                log(f"[2] time {frame} {name} B={b} {str(dtype)[6:]}: card "
                    f"alone {d_ms * 1e3:.2f} us  events {k_ms * 1e3:.2f} us  "
                    f"host {h_ms * 1e3:.2f} us  plain {p_ms * 1e3:.2f} us  "
                    f"bound {bound_ms * 1e3:.3f} us ({bound_by})  tile "
                    f"{plan['tile'][0]}x{plan['tile'][1]} grid "
                    f"{plan['grid']} split {plan['split']} "
                    f"({plan['channels_per_split']} ch) smem "
                    f"{plan['smem_bytes']} B  two runs bit-equal")
        return rows

    rows = time_levels(LEVELS, (1, 8), "448x1024")
    rows_1080 = time_levels(LEVELS_1080, (1,), "1088x1920")
    rows_bf16 = (time_levels(LEVELS, (1, 8), "448x1024", torch.bfloat16)
                 + time_levels(LEVELS_1080, (1,), "1088x1920",
                               torch.bfloat16))
    for what, sel in (("448x1024 B=1", [r for r in rows if r["batch"] == 1]),
                      ("448x1024 B=8", [r for r in rows if r["batch"] == 8]),
                      ("1088x1920 B=1", rows_1080)):
        log(f"[2] one forward's 5 levels, {what} f32: card alone "
            f"{sum(r['device_ms'] for r in sel) * 1e3:.2f} us, events "
            f"{sum(r['ms'] for r in sel) * 1e3:.2f} us, host "
            f"{sum(r['host_ms'] for r in sel) * 1e3:.2f} us, bound "
            f"{sum(r['bound_ms'] for r in sel) * 1e3:.3f} us")
    log(f"[2] max abs error: float32 {worst[torch.float32]:.3e}, "
        f"bfloat16 {worst[torch.bfloat16]:.3e}")
    return worst[torch.float32], rows, rows_1080, rows_bf16


def phase_fused_vs_plain():
    """K3 against its plain version.  Returns (max float32 error, max
    bfloat16 error, output pixels excluded for a mask sum within 1e-6 of
    the threshold)."""
    import torch
    import torch.nn.functional as F
    from opticalflow_tpu_torch.ops.fused_warpcorr import (
        fused_warp_corr_cuda, fused_warp_corr_plain, prep_gather)

    g = torch.Generator(device="cuda").manual_seed(3)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    excluded = 0
    shapes = [(b, s) for b in (1, 8) for s in LEVELS[:4]] + [
        (1, s) for s in EXTRA_SHAPES]
    for b, (name, h, w, c) in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            f1 = torch.randn(b, c, h, w, generator=g, device="cuda").to(dtype)
            f2 = torch.randn(b, c, h, w, generator=g, device="cuda").to(dtype)
            for px in (3.0, 20.0):
                flow = torch.randn(b, 2, h, w, generator=g,
                                   device="cuda") * px
                for thr in (0.9999, 0.999):
                    out = fused_warp_corr_cuda(f1, f2, flow,
                                               mask_threshold=thr)
                    # the plain version in float32, before the rounding to
                    # the features' dtype
                    ref = fused_warp_corr_plain(f1.float(), f2.float(), flow,
                                                mask_threshold=thr)
                    torch.cuda.synchronize()
                    assert out.shape == (b, ND2, h, w) and out.dtype == dtype
                    # a warped pixel whose mask sum is within 1e-6 of thr
                    # may decide otherwise; exclude the outputs it reaches
                    _, _, wv = prep_gather(flow, h, w, 0.0)
                    near = ((wv.sum(1, keepdim=True) - thr).abs()
                            < 1e-6).float()
                    reach = F.max_pool2d(near, 2 * MD + 1, 1, MD) > 0
                    n_excl = int(reach.sum())
                    excluded += n_excl
                    err = ((out.float() - ref).abs()
                           * (~reach).float())
                    if dtype == torch.float32:
                        # float32 sums of <=128 products and of the corner
                        # terms, in another order
                        tol = torch.full_like(ref, 1e-4)
                    else:
                        # one bf16 rounding of the float32 result, doubled
                        # for the order
                        tol = ref.abs() * 2.0 ** -8 + 1e-5
                    bad = int((err > tol).sum())
                    e = float(err.max())
                    worst[dtype] = max(worst[dtype], e)
                    log(f"[3] {name:13s} B={b} {str(dtype)[6:]:8s} "
                        f"({h}x{w}x{c}) flow x{px:g} thr {thr}: "
                        f"max|kernel-plain| {e:.3e}, {n_excl} excluded"
                        + (f"  {bad} OVER TOLERANCE" if bad else ""))
                    assert bad == 0, (f"fused kernel disagrees with plain at "
                                      f"{name} {dtype} x{px} {thr}")
    log(f"[3] max abs error: float32 {worst[torch.float32]:.3e}, bfloat16 "
        f"{worst[torch.bfloat16]:.3e}; output pixels excluded (mask sum "
        f"within 1e-6 of the threshold): {excluded}")
    return worst[torch.float32], worst[torch.bfloat16], excluded


def phase_gather_vs_plain():
    """K4 against its plain version, exact, NaN rows included; then timed
    beside the plain version at the probe's shape, and at one row.  Returns
    (max error, plain ms, one-row ms on the card alone)."""
    import torch
    from opticalflow_tpu_torch.ops.gather import (row_gather_cuda,
                                                  row_gather_plain)
    from opticalflow_tpu_torch.scripts import probe_gather
    from opticalflow_tpu_torch.scripts._timing import cuda_ms, device_ms

    g = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for n, m, c in ((probe_gather.N, probe_gather.M, probe_gather.C),
                    (37, 300, 21), (5, 64, 3), (1000, 100000, 64)):
        x = torch.randn(n, c, generator=g, device="cuda")
        idx = torch.randint(-2 * n, 2 * n, (m, 1), generator=g,
                            device="cuda", dtype=torch.int32)
        out = row_gather_cuda(x, idx)
        ref = row_gather_plain(x, idx)
        torch.cuda.synchronize()
        nan_rows = int(torch.isnan(ref).all(1).sum())
        same_nan = torch.equal(torch.isnan(out), torch.isnan(ref))
        err = float((torch.nan_to_num(out) - torch.nan_to_num(ref))
                    .abs().max())
        log(f"[4] row_gather N={n} M={m} C={c}: max|kernel-plain| {err}, "
            f"NaN rows {nan_rows} (same: {same_nan})")
        assert same_nan and err == 0.0 and nan_rows > 0
        worst = max(worst, err)
    x = torch.randn(probe_gather.N, probe_gather.C, generator=g,
                    device="cuda")
    idx = torch.randint(0, probe_gather.N, (probe_gather.M, 1), generator=g,
                        device="cuda", dtype=torch.int32)
    plain_ms = cuda_ms(lambda _: row_gather_plain(x, idx), 50)
    log(f"[4] row_gather_plain at the probe's shape: {plain_ms * 1e3:.2f} us")
    # what any launch through ops/_launch.py costs the card: one row
    one = idx[:1].contiguous()
    floor_ms = device_ms(lambda _: row_gather_cuda(x, one), 200)
    log(f"[4] launch floor: row_gather_cuda of 1 row x {probe_gather.C} "
        f"float32, card alone {floor_ms * 1e3:.2f} us (every B=1 time above "
        f"contains one)")
    return worst, plain_ms, floor_ms


def fake_reference_checkpoint(path: str):
    """Write the golden recipe's weights as a reference-layout checkpoint
    (``module.`` prefixes and the dead ``deconv2`` included); returns the
    state dict."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.torch_pwcnet import OraclePWC
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for p in net.parameters():
        p.data *= 0.5
    sd = net.state_dict_flat()
    checksum = sum(float(v.double().abs().sum()) for v in sd.values())
    log(f"[5] fake weights: {len(sd)} tensors, sum|w| = {checksum!r}")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    return sd


def phase_cli(tmp: str, counter):
    from opticalflow_tpu_torch.cli import script_pwc
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io.flo import read_flo
    from opticalflow_tpu_torch.io.images import load_image
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    sd = fake_reference_checkpoint(ckpt)
    im1, im2 = (os.path.join(GOLD, f"real_im{i}.png") for i in (1, 2))
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cuda")
    runs = (
        ("CLI pad/rgb_imagenet", "real_pair_pad.flo",
         ["--size-mode", "pad", "--preset", "rgb_imagenet",
          "--flow-scale", "1.0"]),
        # the CLI's default size mode
        ("CLI resize/bgr_unit", "real_pair.flo",
         ["--preset", "bgr_unit", "--flow-scale", "20"]),
        ("FlowEngine pad_ref/rgb_imagenet", "real_pair_padref.flo", None))
    for what, golden, flags in runs:
        before = counter.launches
        if flags is None:
            flow = engine.flow_from_pair(load_image(im1), load_image(im2),
                                         preset="rgb_imagenet",
                                         size_mode="pad_ref")
        else:
            out = os.path.join(tmp, golden)
            rc = script_pwc.main([im1, im2, out, "--ckpt", ckpt,
                                  "--device", "cuda", *flags])
            assert rc == 0, rc
            flow = read_flo(out)
        launched = counter.launches - before
        assert launched == 5, f"one forward must launch the kernel 5 " \
                              f"times, got {launched}"
        ref = read_flo(os.path.join(GOLD, golden))
        assert flow.shape == ref.shape == (180, 318, 2), flow.shape
        d = epe(flow, ref)
        log(f"[5] {what} vs {golden}: mean EPE delta {d:.3e} (bound 1e-4, "
            f"TF32 off); kernel launches {launched}")
        assert d <= 1e-4, f"{what} off the golden: {d:.3e}"
    assert "cv2" not in sys.modules, "the port imported OpenCV"
    return sd


def phase_full_width(sd, counter):
    import numpy as np
    import torch
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io import images as imio
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet

    engine = FlowEngine(PWCDCNet(), sd, flow_scale=20.0, device="cuda")
    results = {}
    for mode in ("pad", "resize"):
        rng = np.random.RandomState(0)
        flows = {}
        for b, n_batches in ((1, 20), (8, 5)):
            im1s = rng.randint(0, 256, (b, FULL_H, FULL_W, 3), np.uint8)
            # frame 2 = frame 1 shifted by (3, 5) px plus noise: coherent
            # motion
            im2s = np.roll(im1s, (3, 5), axis=(1, 2))
            im2s = np.clip(im2s + rng.randint(-8, 9, im2s.shape), 0,
                           255).astype(np.uint8)

            def run():
                return engine.flow_from_pairs(list(im1s), list(im2s),
                                              preset="bgr_unit",
                                              size_mode=mode)

            before = counter.launches
            run()                                    # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            lat = []
            t0 = time.perf_counter()
            for _ in range(n_batches):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                flow = run()                         # returns host numpy
                e.record()
                e.synchronize()
                lat.append(s.elapsed_time(e))
            wall = time.perf_counter() - t0
            launched = counter.launches - before
            assert launched == 5 * (n_batches + 1), launched
            assert flow.shape == (b, FULL_H, FULL_W, 2), flow.shape
            assert np.isfinite(flow).all(), "non-finite flow"
            flows[b] = flow
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            lat_ms = float(np.median(lat))
            results[(mode, b)] = {
                "pairs_per_s": b * n_batches / wall,
                "batch_ms_median": lat_ms, "per_pair_ms": lat_ms / b,
                "peak_mib": peak}
            log(f"[6] FlowEngine {mode} 436x1024 f32 B={b}: "
                f"{b * n_batches / wall:.2f} pairs/s, call latency median "
                f"{lat_ms:.3f} ms ({lat_ms / b:.3f} ms/pair, CUDA events "
                f"around flow_from_pairs incl. host resize/pad and "
                f"H2D/D2H), peak {peak:.0f} MiB")
        # the same pair alone and inside a batch of 8 (the last loop's)
        d = epe(flows[8][0], engine.flow_from_pair(
            im1s[0], im2s[0], preset="bgr_unit", size_mode=mode))
        log(f"[6] {mode}: B=8 row 0 vs B=1 run of the same pair: mean EPE "
            f"delta {d:.3e}")
        assert d <= 1e-4, d
    frame = np.random.RandomState(1).randint(0, 256, (FULL_H, FULL_W, 3),
                                             np.uint8)
    t0 = time.perf_counter()
    for _ in range(20):
        imio.resize_to_multiple_of_64(frame)
    resize_ms = (time.perf_counter() - t0) / 20 * 1e3
    log(f"[6] host resize_to_multiple_of_64 436x1024 -> 448x1024 uint8: "
        f"{resize_ms:.3f} ms per frame (host clock, 20 frames; a pair "
        f"needs two)")
    assert "cv2" not in sys.modules, "the port imported OpenCV"
    return engine, results


def phase_forward_time(engine):
    """Device time of the network forward alone (no host transfers)."""
    import torch
    from opticalflow_tpu_torch.scripts._timing import cuda_ms
    out = {}
    for b in (1, 8):
        x = torch.rand(b, 6, 448, 1024, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(1))
        with torch.inference_mode():
            out[b] = cuda_ms(lambda _: engine.model(x), 10 if b == 8 else 30)
        log(f"[6] forward alone 448x1024 f32 B={b}: {out[b]:.3f} ms "
            f"({out[b] / b:.3f} ms/pair)")
    return out


def phase_corr_bwd():
    """B1 against its plain version at every training and 448x1024 level,
    float32 and bfloat16, two runs bit-equal; then timed per level.
    Returns (max float32 error, max bfloat16 error, rows)."""
    import torch
    from opticalflow_tpu_torch.ops.corr_cuda import (bwd_launch_plan,
                                                     correlation_bwd_cuda)
    from opticalflow_tpu_torch.ops.correlation import correlation_bwd_plain
    from opticalflow_tpu_torch.scripts._timing import cuda_ms, device_ms

    g = torch.Generator(device="cuda").manual_seed(7)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = []
    shapes = ([(TRAIN_B, s, "320x896") for s in TRAIN_LEVELS]
              + [(1, s, "448x1024") for s in LEVELS])
    for b, (name, h, w, c), frame in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            f1, f2 = (torch.randn(b, c, h, w, generator=g,
                                  device="cuda").to(dtype) for _ in range(2))
            gv = torch.randn(b, ND2, h, w, generator=g,
                             device="cuda").to(dtype)

            def call(_):
                return correlation_bwd_cuda(f1, f2, gv, max_displacement=MD)

            got = call(0)
            ref = correlation_bwd_plain(f1, f2, gv, max_displacement=MD)
            again = call(1)
            torch.cuda.synchronize()
            same_bits = all(torch.equal(a, r) for a, r in zip(got, again))
            err = max(float((a.float() - r.float()).abs().max())
                      for a, r in zip(got, ref))
            scale = max(float(r.float().abs().max()) for r in ref)
            # float32: sums of 81 products in another order (fma against a
            # rounded product); bfloat16: one bf16 rounding of the float32
            # sum in either version, 2^-8 relative
            tol = (1e-5 if dtype == torch.float32 else 1e-2) * scale
            worst[dtype] = max(worst[dtype], err)
            plan = bwd_launch_plan(b, c, h, w, dtype)
            d_ms = device_ms(call, 100)
            k_ms = cuda_ms(call, 100)
            p_ms = cuda_ms(lambda _: correlation_bwd_plain(
                f1, f2, gv, max_displacement=MD), 3)
            bound_ms, bound_by = corr_bwd_bound(b, h, w, c,
                                                f1.element_size())
            dt = str(dtype)[6:]
            rows.append({"level": name, "frame": frame, "batch": b,
                         "dtype": dt, "shape": [h, w, c], "ms": k_ms,
                         "device_ms": d_ms, "plain_ms": p_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "max_abs_err": err, "max_abs_grad": scale,
                         "same_bits": same_bits, **plan})
            log(f"[7] {frame} {name} B={b} {dt:8s} ({h}x{w}x{c}) "
                f"max|kernel-plain| {err:.3e} (max|grad| {scale:.3e}, "
                f"bound {tol:.1e}); two runs bit-equal: {same_bits}; card "
                f"alone {d_ms * 1e3:.2f} us  events {k_ms * 1e3:.2f} us  "
                f"plain {p_ms * 1e3:.2f} us  bound {bound_ms * 1e3:.3f} us "
                f"({bound_by})  tile {plan['tile'][0]}x{plan['tile'][1]} "
                f"grid {plan['grid']} split {plan['split']} "
                f"({plan['channels_per_split']} ch) {plan['threads']} "
                f"threads, {plan['blocks_per_sm']} blocks/SM, "
                f"{plan['registers']} registers")
            assert err <= tol, f"B1 disagrees with plain at {frame} {name} " \
                               f"{dt}: {err:.3e} > {tol:.3e}"
            assert same_bits, f"two B1 runs differ at {frame} {name} {dt}"
    for frame, b in (("320x896", TRAIN_B), ("448x1024", 1)):
        for dt in ("float32", "bfloat16"):
            sel = [r for r in rows if r["frame"] == frame
                   and r["dtype"] == dt]
            log(f"[7] one step's 5 levels, {frame} B={b} {dt}: card alone "
                f"{sum(r['device_ms'] for r in sel) * 1e3:.2f} us, events "
                f"{sum(r['ms'] for r in sel) * 1e3:.2f} us, plain "
                f"{sum(r['plain_ms'] for r in sel) * 1e3:.2f} us, bound "
                f"{sum(r['bound_ms'] for r in sel) * 1e3:.3f} us")
    log(f"[7] max abs error: float32 {worst[torch.float32]:.3e}, bfloat16 "
        f"{worst[torch.bfloat16]:.3e}")
    return worst[torch.float32], worst[torch.bfloat16], rows


def train_batch(seed: int = 0):
    """A seeded batch in the JAX layout: frame 2 is frame 1 (a smooth random
    texture) moved by (5, 3) px plus noise, the GT flow that motion, ~20%
    of the pixels invalid."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(rng.rand(TRAIN_B, 3, TRAIN_H // 8,
                                       TRAIN_W // 8).astype(np.float32))
    im1 = F.interpolate(coarse, size=(TRAIN_H, TRAIN_W), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    im2 = np.roll(im1, (3, 5), axis=(1, 2))
    im2 = np.clip(im2 + rng.randn(*im2.shape).astype(np.float32) * 0.02,
                  0.0, 1.0)
    flow = np.broadcast_to(np.array([5.0, 3.0], np.float32),
                           (TRAIN_B, TRAIN_H, TRAIN_W, 2)).copy()
    return {"images": np.concatenate([im1, im2], -1).astype(np.float32),
            "flow": flow,
            "valid": (rng.rand(TRAIN_B, TRAIN_H, TRAIN_W) > 0.2).astype(
                np.float32)}


def phase_train(sd, corr_fwd, corr_bwd):
    """The training step at full width on the card.  Returns a dict of its
    results."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.models.torch_import import reference_state_dict
    from opticalflow_tpu_torch.train import trainer as T

    batch = train_batch()
    sd = reference_state_dict(sd)

    def grads_of(precision, use_cuda_corr):
        """The raw gradients of one parity-mode step (clip off, SGD at lr 0:
        the gradients stay on the parameters) and their launches."""
        model = PWCDCNet(precision=precision, use_cuda_corr=use_cuda_corr)
        model.load_state_dict(sd)
        model = model.cuda()
        cfg = T.TrainConfig(loss="multiscale", grad_clip=0.0)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        state = T.TrainState(step=0, model=model, optimizer=opt)
        f0, b0 = corr_fwd.launches, corr_bwd.launches
        _, m = T.make_train_step(model, opt, cfg)(state, batch)
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        return grads, float(m["loss"]), (corr_fwd.launches - f0,
                                         corr_bwd.launches - b0)

    def worst_ratio(ga, gb):
        """max over parameters of max|a - b| / max|b|, and its name; a
        parameter whose gradient vanishes (below a millionth of the model's
        largest: rounding noise only) is measured against that millionth."""
        top = max(float(g.abs().max()) for g in gb.values())
        return max(((float((ga[n] - gb[n]).abs().max())
                     / max(float(gb[n].abs().max()), 1e-6 * top)), n)
                   for n in gb)

    g_kernel, loss_k, launched_k = grads_of("highest", True)
    g_again, _, _ = grads_of("highest", True)
    g_plain, loss_p, launched_p = grads_of("highest", False)
    assert launched_k == (5, 5), launched_k
    assert launched_p == (0, 0), launched_p
    ratio, name = worst_ratio(g_kernel, g_plain)
    floor, fname = worst_ratio(g_again, g_kernel)
    log(f"[8] parity mode, 4x320x896 multiscale: loss through K1+B1 "
        f"{loss_k!r}, through the plain correlation {loss_p!r}; worst "
        f"parameter max|grad(K1+B1) - grad(plain)| / max|grad| = "
        f"{ratio:.3e} ({name}; bound 1e-3); the same step twice through "
        f"K1+B1: {floor:.3e} ({fname})")
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), (loss_k, loss_p)
    assert ratio <= 1e-3, f"K1+B1 gradients off the plain ones: {ratio:.3e}"

    # 10 fast-mode steps overfitting the batch (the JAX CLI's precision)
    model = PWCDCNet(precision="fast")
    model.load_state_dict(sd)
    model = model.cuda()
    cfg = T.TrainConfig(loss="multiscale", optimizer="adamw", lr=1e-4,
                        weight_decay=1e-4, grad_clip=1.0)
    state, opt = T.create_train_state(model, cfg)
    step = T.make_train_step(model, opt, cfg)
    dev_batch = T.batch_to_device(batch, torch.device("cuda"))
    dev_batch = {k: v.permute(0, 2, 3, 1).contiguous() if v.dim() == 4
                 else v for k, v in dev_batch.items()}   # NHWC, on the card
    corr_fwd.launches = corr_bwd.launches = 0   # the training path starts
    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, dev_batch)
        losses.append(float(m["loss"]))         # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    launched = (corr_fwd.launches, corr_bwd.launches)  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    step_ms = float(np.median(ms[1:]))
    log(f"[8] fast mode, 10 steps: losses {[round(x, 6) for x in losses]}; "
        f"K1/B1 launches {launched}; ms per step {[round(x, 2) for x in ms]}"
        f" (median after the first {step_ms:.2f} ms, "
        f"{TRAIN_B / step_ms * 1e3:.2f} pairs/s; batch already on the "
        f"card); peak {peak:.0f} MiB")
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    assert launched == (50, 50), launched
    return {"grad_ratio_vs_plain": ratio, "grad_ratio_run_to_run": floor,
            "loss_kernel": loss_k, "loss_plain": loss_p, "losses": losses,
            "step_ms": ms, "step_ms_median": step_ms,
            "pairs_per_s": TRAIN_B / step_ms * 1e3, "peak_mib": peak,
            "launches": {"correlation_fwd": launched[0],
                         "correlation_bwd": launched[1]}}


def write_png(path: str, img) -> None:
    from opticalflow_tpu_torch.io.images import encode_png
    with open(path, "wb") as f:
        f.write(encode_png(img))


def moving_pair(rng, h: int, w: int):
    """A uint8 frame pair: a smooth random texture, then the same moved by
    (3, 5) px plus noise."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    coarse = torch.from_numpy(rng.rand(1, 3, h // 8 + 1,
                                       w // 8 + 1).astype(np.float32))
    im1 = (F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0).numpy()
           * 255).astype(np.uint8)
    im2 = np.roll(im1, (3, 5), axis=(0, 1)).astype(np.int16)
    im2 = np.clip(im2 + rng.randint(-6, 7, im2.shape), 0, 255)
    return im1, im2.astype(np.uint8)


def run_cli(main, argv):
    """Run a CLI's main(argv); returns (rc, mean EPE it printed, wall s)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    sys.stdout.write(text)
    mean = [float(line.split(":")[1]) for line in text.splitlines()
            if line.startswith("Mean EPE:")]
    return rc, (mean[-1] if mean else float("nan")), wall


# evaluation's timed window: the synthetic 3-pair trees read this many times
# over, so the producer's start and the pipeline's fill are a small share
EVAL_REPS = 16


class Repeated:
    """``dataset`` read ``reps`` times over (its samples decoded anew on
    every read)."""

    def __init__(self, dataset, reps: int):
        self.dataset, self.reps = dataset, reps

    def __len__(self):
        return len(self.dataset) * self.reps

    def __getitem__(self, i: int):
        return self.dataset[i % len(self.dataset)]


def eval_rate(engine, dataset, **kw):
    """``evaluate_pairs`` at batch 2, warm, timed over ``EVAL_REPS`` reads
    of ``dataset``; beside it the host's decode of one sample alone and the
    engine's time a pair alone (B=2 calls on decoded frames), which say
    whether decode overlaps the card.  Returns (result, rates)."""
    import torch
    from opticalflow_tpu_torch.evaluate import evaluate_pairs
    evaluate_pairs(engine, dataset, batch=2, verbose=False, **kw)  # warm-up
    window = Repeated(dataset, EVAL_REPS)
    t0 = time.perf_counter()
    res = evaluate_pairs(engine, window, batch=2, verbose=False, **kw)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples = [dataset[i] for i in range(len(dataset))]
    decode_ms = (time.perf_counter() - t0) / len(samples) * 1e3
    ims = ([samples[0]["im1"], samples[1]["im1"]],
           [samples[0]["im2"], samples[1]["im2"]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EVAL_REPS):
        engine.flow_from_pairs(*ims, **kw)
    engine_ms = (time.perf_counter() - t0) / (2 * EVAL_REPS) * 1e3
    return res, {"pairs": len(window), "pairs_per_s": len(window) / wall,
                 "decode_ms": decode_ms, "engine_ms": engine_ms}


def phase_eval(sd, tmp, corr_fwd):
    """Evaluation through both CLIs on synthetic KITTI and Sintel trees.
    Returns a dict of its results."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import eval_sintel, infer_kitti
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.data.datasets import KittiPairsEval, SintelPairs
    from opticalflow_tpu_torch.io.flo import read_flo, write_flo
    from opticalflow_tpu_torch.io.kitti import write_flow_png
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet

    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    rng = np.random.RandomState(9)
    out = {}

    # KITTI 2015: 3 pairs, GT from the CLI's own settings at batch 1
    kroot = os.path.join(tmp, "kitti")
    for d in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(kroot, "training", d))
    gt_engine = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cuda")
    for i in range(3):
        im1, im2 = moving_pair(rng, KITTI_H, KITTI_W)
        for k, im in ((10, im1), (11, im2)):
            write_png(os.path.join(kroot, "training", "image_2",
                                   f"{i:06d}_{k}.png"), im)
        flow = gt_engine.flow_from_pair(im1, im2, preset="rgb_imagenet",
                                        size_mode="pad")
        write_flow_png(os.path.join(kroot, "training", "flow_occ",
                                    f"{i:06d}_10.png"), flow,
                       rng.rand(KITTI_H, KITTI_W) > 0.3)
    before = corr_fwd.launches
    rc, printed, wall = run_cli(infer_kitti.main, [
        "--root", kroot, "--ckpt", ckpt, "--size-mode", "pad", "--batch",
        "2", "--device", "cuda"])
    launched = corr_fwd.launches - before
    assert rc == 0 and launched == 10, (rc, launched)
    log(f"[9] cli/infer_kitti, 3 pairs 375x1242 at batch 2: mean EPE "
        f"printed {printed} (bound 0.02, the PNG's 1/64 px); {wall:.2f} s "
        f"wall, model load and first call included; K1 launches {launched}")
    assert printed <= 0.02, printed
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cuda")
    res, rate = eval_rate(engine, KittiPairsEval(kroot), preset="rgb_imagenet",
                          size_mode="pad")
    log(f"[9] evaluate_pairs on KittiPairsEval, warm, {rate['pairs']} pairs "
        f"(the 3 read {EVAL_REPS}x over) at batch 2: EPE {res['epe']!r}, "
        f"Fl-all {res['fl_all']!r}%, {rate['pairs_per_s']!r} pairs/s (PNG "
        f"decode, pad, forward, upsample, metrics); alone: host decode "
        f"{rate['decode_ms']!r} ms a sample (two frames and the 16-bit GT), "
        f"engine {rate['engine_ms']!r} ms a pair (B=2 flow_from_pairs on "
        f"decoded frames)")
    assert res["epe"] <= 0.02, res
    out["kitti"] = {"epe_printed": printed, "epe": res["epe"],
                    "fl_all": res["fl_all"], **rate}

    # Sintel: two sequences (3 and 2 frames: 3 pairs), .flo GT at batch 1
    sroot = os.path.join(tmp, "sintel")
    gt20 = FlowEngine(PWCDCNet(), sd, flow_scale=20.0, device="cuda")
    for seq, n in (("alley_1", 3), ("market_2", 2)):
        os.makedirs(os.path.join(sroot, "training", "clean", seq))
        os.makedirs(os.path.join(sroot, "training", "flow", seq))
        frames = [moving_pair(rng, FULL_H, FULL_W)[0]]
        for _ in range(n - 1):
            nxt = np.roll(frames[-1], (3, 5), axis=(0, 1))
            frames.append(nxt)
        for k, im in enumerate(frames, start=1):
            write_png(os.path.join(sroot, "training", "clean", seq,
                                   f"frame_{k:04d}.png"), im)
        for k in range(1, n):
            write_flo(os.path.join(sroot, "training", "flow", seq,
                                   f"frame_{k:04d}.flo"),
                      gt20.flow_from_pair(frames[k - 1], frames[k],
                                          preset="bgr_unit",
                                          size_mode="pad"))
    save = os.path.join(tmp, "sintel_out")
    before = corr_fwd.launches
    rc, printed, wall = run_cli(eval_sintel.main, [
        "--root", sroot, "--ckpt", ckpt, "--batch", "2", "--save-dir", save,
        "--device", "cuda"])
    launched = corr_fwd.launches - before
    assert rc == 0 and launched == 10, (rc, launched)
    # the saved .flo files against the GT, unrounded
    epes = []
    for seq, n in (("alley_1", 3), ("market_2", 2)):
        for k in range(1, n):
            pred = read_flo(os.path.join(save, f"{seq}_frame_{k:04d}.flo"))
            ref = read_flo(os.path.join(sroot, "training", "flow", seq,
                                        f"frame_{k:04d}.flo"))
            epes.append(epe(pred, ref))
    log(f"[9] cli/eval_sintel, 3 pairs 436x1024 at batch 2: mean EPE "
        f"printed {printed}, from its saved .flo files "
        f"{float(np.mean(epes))!r} "
        f"(bound 1e-3: GT from batch-1 calls); {wall:.2f} s wall; K1 "
        f"launches {launched}")
    assert max(epes) < 1e-3, epes
    res, rate = eval_rate(gt20, SintelPairs(sroot), preset="bgr_unit",
                          size_mode="pad")
    log(f"[9] evaluate_pairs on SintelPairs, warm, {rate['pairs']} pairs at "
        f"batch 2: EPE {res['epe']!r}, {rate['pairs_per_s']!r} pairs/s; "
        f"alone: host decode {rate['decode_ms']!r} ms a sample (two frames "
        f"and the .flo), engine {rate['engine_ms']!r} ms a pair")
    assert res["epe"] < 1e-3, res
    out["sintel"] = {"epe_printed": printed, "epe_saved": float(np.mean(epes)),
                     "epe": res["epe"], **rate}
    assert "cv2" not in sys.modules, "the port imported OpenCV"
    return out


# ------------------------------------------------------------ phase 10

# the training CLI's run: 16 temporal KITTI pairs (val 4, train 12: 3 steps
# an epoch at batch 4) over 2 epochs; the epipolar run: 12 frame pairs
TRAIN_PAIRS = 16
STEADY_EPOCHS = 4
# the uninterrupted runs whose pairwise spread sets the resumed run's
# trajectory tolerance (the first also hashes its batches)
UNINTERRUPTED = ("uninterrupted", "again", "third")
EPI_FRAMES = 13


def moving_frames(rng, n: int, h: int, w: int, step=(1.5, 2.5),
                  zoom: float = 1.004):
    """``n`` uint8 frames of one smooth random texture seen by a camera that
    moves sideways by ``step`` px (rows, columns) a frame and forward (the
    view shrinks by ``zoom`` a frame about its moving centre): each frame is
    a window of the texture resized to (h, w) by the port's resize."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from opticalflow_tpu_torch.io.images import resize_bilinear_u8
    bh, bw = h + 64 + int(n * step[0]), w + 64 + int(n * step[1])
    coarse = torch.from_numpy(rng.rand(1, 3, bh // 10 + 2,
                                       bw // 10 + 2).astype(np.float32))
    base = (F.interpolate(coarse, size=(bh, bw), mode="bilinear",
                          align_corners=False)[0].permute(1, 2, 0).numpy()
            * 255).astype(np.uint8)
    frames = []
    for i in range(n):
        s = zoom ** -i
        vh, vw = int(round(h * s)), int(round(w * s))
        cy = 32 + h / 2 + i * step[0]
        cx = 32 + w / 2 + i * step[1]
        y0, x0 = int(round(cy - vh / 2)), int(round(cx - vw / 2))
        frames.append(resize_bilinear_u8(base[y0:y0 + vh, x0:x0 + vw], h, w))
    return frames


def synth_kitti_train(root: str, rng) -> None:
    """A KITTI training tree: ``image_2/`` 375x1242 frames of a moving
    texture, and for each temporal pair a 16-bit ``flow_occ/`` PNG of a
    smooth known motion with ~30% of the pixels invalid."""
    import numpy as np
    from opticalflow_tpu_torch.io.kitti import write_flow_png
    for d in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(root, d))
    frames = moving_frames(rng, TRAIN_PAIRS + 1, KITTI_H, KITTI_W)
    yy, xx = np.mgrid[0:KITTI_H, 0:KITTI_W].astype(np.float32)
    for i, im in enumerate(frames):
        write_png(os.path.join(root, "image_2", f"{i:06d}_10.png"), im)
        if i < TRAIN_PAIRS:
            flow = np.stack([2.5 + (xx - KITTI_W / 2) * 0.004,
                             1.5 + (yy - KITTI_H / 2) * 0.004], axis=-1)
            write_flow_png(os.path.join(root, "flow_occ", f"{i:06d}_10.png"),
                           flow, rng.rand(KITTI_H, KITTI_W) > 0.3)


def on_cpu(obj):
    """A copy of a state dict (nested dicts and lists of tensors and plain
    values) with every tensor copied to the CPU."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: on_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(on_cpu(v) for v in obj)
    return obj


def state_diff(a, b, path="") -> list:
    """Where two copies of :func:`on_cpu` differ: tensors bit for bit (dtype,
    shape and every bit), everything else by ``==``."""
    import torch
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and bool((a.view(-1).view(torch.uint8)
                          == b.view(-1).view(torch.uint8)).all()))
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [d for k in a for d in state_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in state_diff(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


class Recorder:
    """Wraps ``train.trainer.make_train_step`` while a CLI run lasts: the
    CRC-32 of every batch's ``images`` bytes that reaches the step, in
    order, the host clock as each step starts, and, for each run in the
    block, the state its first step starts from (step, parameters, the
    optimizer's state, on the CPU); and ``checkpoints.save_train_state``:
    what each save wrote, as it was in memory (instrumentation of this
    script; the CLI is unchanged)."""

    def __init__(self, hashes: bool = True, states: bool = False):
        self.hashes = [] if hashes else None
        self.starts = []
        self.states = states
        self.first_states = []
        self.saves = []

    def __enter__(self):
        from opticalflow_tpu_torch.train import checkpoints, trainer
        self._real = real = trainer.make_train_step
        self._real_save = real_save = checkpoints.save_train_state
        rec = self

        def make(model, opt, cfg, mesh=None):
            step = real(model, opt, cfg, mesh)
            first = [True]

            def wrapped(state, batch):
                rec.starts.append(time.perf_counter())
                if rec.states and first[0]:
                    first[0] = False
                    rec.first_states.append({
                        "step": state.step,
                        "params": on_cpu(model.state_dict()),
                        "opt_state": on_cpu(opt.state_dict())})
                if rec.hashes is not None:
                    import zlib
                    rec.hashes.append(zlib.crc32(
                        batch["images"].cpu().numpy().tobytes()))
                return step(state, batch)
            return wrapped

        def save(directory, step, params, opt_state=None, metadata=None):
            if rec.states:
                rec.saves.append({"directory": directory, "step": step,
                                  "params": on_cpu(params),
                                  "opt_state": on_cpu(opt_state),
                                  "metadata": metadata})
            return real_save(directory, step, params, opt_state, metadata)

        trainer.make_train_step = make
        checkpoints.save_train_state = save
        return self

    def __exit__(self, *exc):
        from opticalflow_tpu_torch.train import checkpoints, trainer
        trainer.make_train_step = self._real
        checkpoints.save_train_state = self._real_save


def train_cli_run(argv, preempt_after_first: bool = False):
    """One ``cli/train.main`` run in this process.  With
    ``preempt_after_first`` a thread sends this process SIGTERM once the
    first step is logged.  Returns (rc, stdout, wall s)."""
    import contextlib
    import io
    import signal
    import threading
    from opticalflow_tpu_torch.cli import train as train_cli
    out_dir = argv[argv.index("--out-dir") + 1]
    log_path = os.path.join(out_dir, "metrics.jsonl")
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            if os.path.exists(log_path) and os.path.getsize(log_path) > 0:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.005)

    watcher = threading.Thread(target=watch, daemon=True)
    if preempt_after_first:
        watcher.start()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv)
    finally:
        stop.set()
        if preempt_after_first:
            watcher.join(timeout=30)
    wall = time.perf_counter() - t0
    sys.stdout.write(buf.getvalue())
    return rc, buf.getvalue(), wall


def jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f]


def epoch_rates(text: str):
    """The samples/s the CLI printed for each epoch."""
    return [float(line.split("(")[1].split()[0]) for line in text.splitlines()
            if line.startswith("epoch ") and "samples/s" in line]


def phase_train_cli(sd, tmp, corr_fwd, corr_bwd, card: str):
    """The training CLI on the card: (a) multiscale with preemption and
    resume against uninterrupted runs, (b) the epipolar regime, (c) its
    numbers.  Returns a dict of its results."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.data.datasets import KittiFlowTrain
    from opticalflow_tpu_torch.data.loader import Loader, Subset
    from opticalflow_tpu_torch.train import checkpoints as ckpt
    from opticalflow_tpu_torch.train import trainer as T

    weights = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               weights)
    rng = np.random.RandomState(10)
    kroot = os.path.join(tmp, "kitti_train")
    t0 = time.perf_counter()
    synth_kitti_train(kroot, rng)
    log(f"[10] synthetic KITTI training tree: {TRAIN_PAIRS} pairs of "
        f"{KITTI_H}x{KITTI_W} written in {time.perf_counter() - t0:.1f} s")
    base = ["--regime", "multiscale", "--data-root", kroot,
            "--pretrained", weights, "--crop", str(TRAIN_H), str(TRAIN_W),
            "--batch", str(TRAIN_B), "--epochs", "2", "--workers", "4",
            "--val-frac", "0.25", "--log-every", "1", "--device", "cuda"]

    # (a) three uninterrupted runs (their spread sets the trajectory's
    # tolerance), then a run preempted after its first step and its resume
    corr_fwd.launches = corr_bwd.launches = 0   # the training CLI starts
    runs = {}
    for name in UNINTERRUPTED:
        out = os.path.join(tmp, name)
        # the repeats hash nothing: their rate is the CLI's own
        with Recorder(hashes=name == "uninterrupted") as rec:
            rc, text, wall = train_cli_run(base + ["--out-dir", out])
        assert rc == 0, rc
        runs[name] = {"out": out, "hashes": rec.hashes, "text": text,
                      "wall": wall}
    out = os.path.join(tmp, "preempted")
    with Recorder(states=True) as rec:
        rc, text_p, _ = train_cli_run(base + ["--out-dir", out],
                                      preempt_after_first=True)
        assert rc == 0, rc
        first = [r["step"] for r in jsonl(os.path.join(out, "metrics.jsonl"))
                 if "step" in r]
        # mid-epoch, or on an epoch's last batch after its validation
        assert ("preempted: saved" in text_p
                or "preempted after epoch" in text_p), "no preemption save"
        saved = [sv for sv in rec.saves
                 if os.path.abspath(sv["directory"]) == os.path.abspath(out)]
        rc, text_r, _ = train_cli_run(base + ["--out-dir", out, "--resume"])
        assert rc == 0, rc
    assert "resumed from step" in text_r
    runs["resumed"] = {"out": out, "hashes": rec.hashes}
    # exact resume: the state the resumed run's first step starts from is,
    # bit for bit, the state the preempted run saved last (its parameters,
    # AdamW's moments and step counts, the learning rates, the step); the
    # loader's position and its seeded draws show in the batches' CRC-32
    # below
    assert saved and len(rec.first_states) == 2, (len(saved),
                                                  len(rec.first_states))
    at_save, at_resume = saved[-1], rec.first_states[1]
    assert at_resume["step"] == at_save["step"] == max(first), \
        (at_resume["step"], at_save["step"], first)
    diff = (state_diff(at_save["params"], at_resume["params"], "params")
            + state_diff(at_save["opt_state"], at_resume["opt_state"],
                         "opt_state"))
    n_tensors = (len(at_save["params"])
                 + sum(len(v) for v in at_save["opt_state"]["state"].values()))
    log(f"[10] (a) exact resume: the resumed run starts from step "
        f"{at_resume['step']}; its state against the one the preempted run "
        f"saved, bit for bit ({n_tensors} tensors: parameters, AdamW's "
        f"exp_avg, exp_avg_sq and step; "
        f"{len(at_save['opt_state']['param_groups'])} param groups): "
        f"differing {diff}")
    assert not diff, f"the resumed state differs from the saved one: {diff}"
    steps = {n: [r["step"] for r in jsonl(os.path.join(r_["out"],
                                                        "metrics.jsonl"))
                 if "step" in r] for n, r_ in runs.items()}
    n_steps = 2 * ((TRAIN_PAIRS - TRAIN_PAIRS // 4) // TRAIN_B)
    expect = list(range(1, n_steps + 1))
    log(f"[10] (a) steps logged: uninterrupted {steps['uninterrupted']}, "
        f"preempted at {first} then resumed: {steps['resumed']}")
    for n in runs:
        assert steps[n] == expect, (n, steps[n])
    assert first and max(first) < n_steps, first
    launched_a = (corr_fwd.launches, corr_bwd.launches)  # ... and ends here
    # four runs' worth of steps (5 B1 each), K1 in the steps and in the
    # validation forwards (one batch an epoch, two epochs a run)
    n_runs = len(UNINTERRUPTED) + 1
    assert launched_a[1] == n_runs * 5 * n_steps, launched_a
    assert launched_a[0] == n_runs * 5 * n_steps + n_runs * 2 * 5, launched_a
    assert runs["resumed"]["hashes"] == runs["uninterrupted"]["hashes"], \
        "the resumed run saw other batches"
    losses = {n: np.array([r["loss"] for r in jsonl(os.path.join(
        r_["out"], "metrics.jsonl")) if "step" in r]) for n, r_ in runs.items()}
    params = {n: ckpt.restore_train_state(r_["out"])["params"]
              for n, r_ in runs.items()}

    def param_gap(a, b):
        return max(float((params[a][k] - params[b][k]).abs().max())
                   for k in params[b])

    def loss_gap(a, b):
        return float(np.abs(losses[a] - losses[b]).max())

    # the card is not bit-deterministic (cuDNN's and grid_sample's
    # backwards add with atomics), so the resumed run's trajectory is held
    # to 4x the spread of the uninterrupted runs (the largest of their
    # three pairs), plus a floor of float32 rounding; the resume itself is
    # held bit for bit above
    pairs = [(a, b) for i, a in enumerate(UNINTERRUPTED)
             for b in UNINTERRUPTED[i + 1:]]
    p_spreads = [param_gap(a, b) for a, b in pairs]
    l_spreads = [loss_gap(a, b) for a, b in pairs]
    p_spread, l_spread = max(p_spreads), max(l_spreads)
    p_top = max(float(v.abs().max()) for v in params["uninterrupted"].values())
    p_tol = 4 * p_spread + 1e-6 * p_top
    l_tol = 4 * l_spread + 1e-6 * float(np.abs(losses["uninterrupted"]).max())
    p_gap, l_gap = param_gap("resumed", "uninterrupted"), loss_gap(
        "resumed", "uninterrupted")
    log(f"[10] (a) {len(runs['uninterrupted']['hashes'])} batches, the same "
        f"CRC-32 of images in the uninterrupted and resumed runs; final "
        f"parameters: resumed - uninterrupted max|d| {p_gap!r} (tolerance "
        f"{p_tol!r} = 4 x the largest of the uninterrupted runs' pairwise "
        f"{p_spreads!r} + 1e-6 x max|p|); per-step losses: {l_gap!r} "
        f"(tolerance {l_tol!r}, pairwise {l_spreads!r}); K1/B1 launches in "
        f"the {len(runs)} runs {launched_a}")
    assert p_gap <= p_tol, (p_gap, p_tol)
    assert l_gap <= l_tol, (l_gap, l_tol)
    assert np.isfinite(losses["uninterrupted"]).all()
    rates = epoch_rates(runs["again"]["text"])
    log(f"[10] (c) CLI training, multiscale 4x{TRAIN_H}x{TRAIN_W}, "
        f"--workers 4, loader on the card: {rates} samples/s by epoch (the "
        f"CLI's own print over 3-step epochs: each includes the producer's "
        f"fill, epoch 0 the first step's warm-up); whole run "
        f"{runs['again']['wall']:.2f} s wall with validation and saves; "
        f"{card}")
    # the CLI's steady rate over a longer window: all 16 pairs for 4 epochs
    # (4 steps each), no validation; the clock at each step's start gives
    # the batches' delivery intervals inside epochs 1-3 (no warm-up, no
    # producer fill)
    steady_argv = [a for a in base if a not in ("--val-frac", "0.25")]
    steady_argv[steady_argv.index("--epochs") + 1] = str(STEADY_EPOCHS)
    with Recorder(hashes=False) as rec:
        rc, text_s, wall_s = train_cli_run(
            steady_argv + ["--out-dir", os.path.join(tmp, "steady"),
                           "--save-every", "100"])
    assert rc == 0, rc
    per = TRAIN_PAIRS // TRAIN_B
    assert len(rec.starts) == STEADY_EPOCHS * per, len(rec.starts)
    gaps = [b - a for e in range(1, STEADY_EPOCHS)
            for a, b in zip(rec.starts[e * per:(e + 1) * per],
                            rec.starts[e * per + 1:(e + 1) * per])]
    steady_rate = len(gaps) * TRAIN_B / sum(gaps)
    fills = [rec.starts[e * per] - rec.starts[e * per - 1]
             for e in range(1, STEADY_EPOCHS)]
    log(f"[10] (c) CLI steady state, {STEADY_EPOCHS} epochs of {per} steps, "
        f"no validation: {steady_rate!r} samples/s over {len(gaps)} batch "
        f"intervals inside epochs 1-{STEADY_EPOCHS - 1} "
        f"({sum(gaps):.3f} s); step-to-step across an epoch boundary "
        f"(save, new producer, fill) {[round(f, 3) for f in fills]} s; "
        f"CLI prints {epoch_rates(text_s)} samples/s by epoch; whole run "
        f"{wall_s:.2f} s wall; {card}")

    # (b) the epipolar regime on frames moved by a known camera motion
    froot = os.path.join(tmp, "frames")
    os.makedirs(froot)
    for i, im in enumerate(moving_frames(rng, EPI_FRAMES, KITTI_H, KITTI_W)):
        write_png(os.path.join(froot, f"frame_{i:04d}.png"), im)
    from opticalflow_tpu_torch.cli import train as train_cli
    real_attach = train_cli._attach_epipolar
    coverage = []

    def attach(model, step, batch, args):
        out = real_attach(model, step, batch, args)
        coverage.extend(float(m) for m in out["photo_mask"].mean((1, 2)))
        return out

    epi_out = os.path.join(tmp, "epipolar")
    train_cli._attach_epipolar = attach
    corr_fwd.launches = corr_bwd.launches = 0   # the epipolar path starts
    try:
        rc, text_e, wall_e = train_cli_run([
            "--regime", "epipolar", "--data-root", froot, "--pretrained",
            weights, "--batch", str(TRAIN_B), "--epochs", "1", "--workers",
            "4", "--log-every", "1", "--epi-soft-w", "0.1", "--device",
            "cuda", "--out-dir", epi_out])
    finally:
        train_cli._attach_epipolar = real_attach
    launched = (corr_fwd.launches, corr_bwd.launches)  # ... and ends here
    assert rc == 0, rc
    recs = [r for r in jsonl(os.path.join(epi_out, "metrics.jsonl"))
            if "step" in r]
    n_epi = (EPI_FRAMES - 1) // TRAIN_B
    log(f"[10] (b) epipolar regime, {n_epi} steps at 4x384x512: losses "
        f"{[r['loss'] for r in recs]}, sampson {[r['sampson'] for r in recs]}"
        f"; mask coverage per sample {[round(c, 4) for c in coverage]}; K1/B1"
        f" launches {launched} (10 and 5 a step); {wall_e:.2f} s wall; {card}")
    assert [r["step"] for r in recs] == list(range(1, n_epi + 1))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["sampson"])
               for r in recs), recs
    assert coverage and all(0.0 < c < 1.0 for c in coverage), coverage
    assert launched == (10 * n_epi, 5 * n_epi), launched

    # (c) the loader alone (decode, reduced_affine, crop; 4 threads, no
    # card) and the step alone on a batch already on the card
    ds = KittiFlowTrain(kroot, crop_hw=(TRAIN_H, TRAIN_W), seed=0)
    t0 = time.perf_counter()
    for i in range(4):
        ds.get(i, epoch=0)
    one_ms = (time.perf_counter() - t0) / 4 * 1e3
    # one sample's pieces on one thread: decode (two frames and the
    # 16-bit GT) and reduced_affine when it warps (60% of the samples)
    from opticalflow_tpu_torch.data.augment import reduced_affine
    from opticalflow_tpu_torch.io.images import load_image
    from opticalflow_tpu_torch.io.kitti import read_flow_png
    t0 = time.perf_counter()
    for p1, p2, pf in ds.samples[:4]:
        im1, im2 = (load_image(p).astype(np.float32) / 255.0
                    for p in (p1, p2))
        flow, valid = read_flow_png(pf)
    decode_ms = (time.perf_counter() - t0) / 4 * 1e3
    warping = [s_ for s_ in range(50)
               if np.random.default_rng(s_).random() >= 0.4][:4]
    t0 = time.perf_counter()
    for s_ in warping:
        reduced_affine(im1, im2, flow, valid, np.random.default_rng(s_))
    affine_ms = (time.perf_counter() - t0) / len(warping) * 1e3
    lo = Loader(ds, TRAIN_B, num_workers=4, seed=0)
    t0 = time.perf_counter()
    n = sum(b["images"].shape[0] for _ in range(2) for b in lo)
    wall = time.perf_counter() - t0
    loader_rate = n / wall
    log(f"[10] (c) loader alone, --workers 4: {loader_rate!r} samples/s "
        f"({wall / n * 1e3!r} ms a sample, {n} samples); one thread: "
        f"{one_ms!r} ms a sample, of which decode {decode_ms!r} ms and, "
        f"on the 60% of samples it warps, reduced_affine {affine_ms!r} ms; "
        f"{card}")

    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.models.torch_import import reference_state_dict
    model = PWCDCNet(precision="fast").cuda()
    cfg = T.TrainConfig(loss="multiscale", optimizer="adamw")
    state, opt = T.create_train_state(model, cfg,
                                      params=reference_state_dict(sd))
    step = T.make_train_step(model, opt, cfg)
    # one batch through the loader, its producer finished: a decode still
    # running beside the step would hold the GIL the step's host work needs
    batch, = list(Loader(Subset(ds, range(TRAIN_B)), TRAIN_B, num_workers=4,
                         seed=0, device="cuda"))
    ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(ms[1:]))
    log(f"[10] (c) the step alone on a batch on the card: "
        f"{[round(x, 2) for x in ms]} ms (median after the first "
        f"{step_ms!r} ms, {TRAIN_B / step_ms * 1e3!r} samples/s); {card}")
    return {"steps": steps["resumed"], "preempted_at": max(first),
            "batches": len(runs["uninterrupted"]["hashes"]),
            "param_gap": p_gap, "param_tol": p_tol, "param_spread": p_spread,
            "param_spreads": p_spreads, "loss_spreads": l_spreads,
            "loss_gap": l_gap, "loss_tol": l_tol, "loss_spread": l_spread,
            "exact_resume_tensors": n_tensors,
            "cli_samples_per_s": rates,
            "cli_steady_samples_per_s": steady_rate,
            "cli_steady_intervals_s": gaps,
            "cli_wall_s": runs["again"]["wall"],
            "epipolar": {"losses": [r["loss"] for r in recs],
                         "sampson": [r["sampson"] for r in recs],
                         "mask_coverage": coverage, "wall_s": wall_e},
            "launches": {"correlation_fwd": launched_a[0] + launched[0],
                         "correlation_bwd": launched_a[1] + launched[1]},
            "launches_epipolar": {"correlation_fwd": launched[0],
                                  "correlation_bwd": launched[1]},
            "loader_samples_per_s": loader_rate,
            "loader_ms_per_sample": wall / n * 1e3,
            "sample_ms_one_thread": one_ms, "decode_ms": decode_ms,
            "reduced_affine_ms": affine_ms,
            "step_ms": ms, "step_ms_median": step_ms, "card": card}



# ------------------------------------------------------------ phase 11

# the video path: a 720p clip at B=4 in each overlay mode, one 1080p pass
# (the levels of K2's domain), bfloat16 (extract_video's default).  Each run
# is timed whole, from its first frame read to its writer's release, over
# enough pairs that the pipeline's fill (decoding and issuing the first
# depth + 1 windows before the first result) is a small share of it.
VIDEO_H, VIDEO_W, VIDEO_FRAMES = 720, 1280, 240
HD_H, HD_W, HD_FRAMES = 1080, 1920, 64
VIDEO_B = 4
FIXED_SIZE = (384, 1280)        # resize_fixed's image size, the v1 default
# (mode, flags, frames read): the modes whose draw is slow read fewer
# frames, so that each run lasts 5-8 s
VIDEO_RUNS = (("arrows", (), 240), ("arrows", ("--upload", "i420"), 160),
              ("color", (), 80), ("vanish", ("--shrink", "0.75"), 160),
              ("topview", (), 40))
# the correlation inputs of the video path: the levels of a 720p frame
# padded to 768x1280 (and LEVELS_1080 at 1080p), at B=VIDEO_B
LEVELS_768 = (("L2", 192, 320, 32), ("L3", 96, 160, 64), ("L4", 48, 80, 96),
              ("L5", 24, 40, 128), ("L6", 12, 20, 196))


def write_clip(path: str, frames) -> float:
    """``frames`` as a .y4m by the port's writer; host ms a frame."""
    from opticalflow_tpu_torch.io.video import Y4MWriter
    h, w = frames[0].shape[:2]
    t0 = time.perf_counter()
    wr = Y4MWriter(path, 30.0, (w, h))
    for f in frames:
        wr.write(f)
    wr.release()
    return (time.perf_counter() - t0) / len(frames) * 1e3


class PipelineRecorder:
    """Instruments the ``cli/extract_video`` runs made while the context
    lasts (this script's instrumentation; the CLI is unchanged): keeps the
    ``VideoFlowRunner`` each builds, the host's busy seconds by stage (the
    decode thread inside ``io/video.read_frames``, the main thread's
    top-view warps and draws, the encode thread's ``.y4m`` writes) and the
    times of the first frame read, the first draw and the writer's
    release."""

    def __enter__(self):
        from opticalflow_tpu_torch import video
        from opticalflow_tpu_torch.cli import extract_video
        from opticalflow_tpu_torch.io import video as vio
        from opticalflow_tpu_torch.viz import topview
        self.runners = runners = []
        self.busy = busy = {"decode": 0.0, "warp": 0.0, "draw": 0.0,
                            "encode": 0.0}
        self.marks = marks = {}
        self._saved = []

        def timed(stage, real, mark=None):
            def call(*a, **k):
                t0 = time.perf_counter()
                if mark:
                    marks.setdefault(mark, t0)
                try:
                    return real(*a, **k)
                finally:
                    busy[stage] += time.perf_counter() - t0
            return call

        def reads(real):
            def gen(*a, **k):
                it = real(*a, **k)
                step = timed("decode", lambda: next(it, None), "first_read")
                while (frame := step()) is not None:
                    yield frame
            return gen

        def released(real):
            def call(*a, **k):
                real(*a, **k)
                marks["released"] = time.perf_counter()
            return call

        def recorded(real):
            class Recorded(real):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    runners.append(self)
            return Recorded

        for owner, name, make in (
                (video, "VideoFlowRunner", recorded),
                (video, "read_frames", reads),
                (topview, "warp_topview", lambda r: timed("warp", r)),
                (extract_video.Overlay, "__call__",
                 lambda r: timed("draw", r, "first_draw")),
                (vio.Y4MWriter, "write", lambda r: timed("encode", r)),
                (vio.AsyncVideoWriter, "release", released)):
            real = getattr(owner, name)
            self._saved.append((owner, name, real))
            setattr(owner, name, make(real))
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._saved):
            setattr(owner, name, real)


class FlowRecorder:
    """Keeps every flow ``FlowEngine.flow_from_pairs`` returns while the
    context lasts (instrumentation of this script)."""

    def __enter__(self):
        from opticalflow_tpu_torch.engine import FlowEngine
        self._real = real = FlowEngine.flow_from_pairs
        self.flows = flows = []

        def recorded(engine, *a, **k):
            out = real(engine, *a, **k)
            flows.append(out)
            return out

        FlowEngine.flow_from_pairs = recorded
        return self

    def __exit__(self, *exc):
        from opticalflow_tpu_torch.engine import FlowEngine
        FlowEngine.flow_from_pairs = self._real


def video_cli(argv, n_frames: int, h: int, w: int):
    """``cli/extract_video.main(argv)`` in this process, instrumented, on
    ``n_frames`` frames of (h, w); checks its output (the frame count and
    size from the file's index, its first, middle and last frames decoded)
    and returns its timings: the whole run's fps, the fill, each stage's
    host ms a frame and its share of the run, and the fps the CLI printed
    (timed from its first result, as the JAX CLI's)."""
    import contextlib
    import io
    from opticalflow_tpu_torch.cli import extract_video
    from opticalflow_tpu_torch.io.video import Y4MFile
    buf = io.StringIO()
    with PipelineRecorder() as rec, contextlib.redirect_stdout(buf):
        rc = extract_video.main(argv)
    text = buf.getvalue()
    sys.stdout.write(text)
    assert rc == 0 and len(rec.runners) == 1, (rc, len(rec.runners))
    printed = [float(line.split("(")[1].split()[0])
               for line in text.splitlines() if "fps steady-state" in line]
    out = Y4MFile(argv[1])
    ow = 2 * w if "color" in argv else w
    assert len(out) == n_frames - 1, (len(out), n_frames)
    assert (out.height, out.width) == (h, ow), (out.height, out.width)
    for i in (0, len(out) // 2, len(out) - 1):
        assert out.frame(i).shape == (h, ow, 3)
    runner, marks, busy = rec.runners[0], rec.marks, rec.busy
    pairs = n_frames - 1
    run_s = marks["released"] - marks["first_read"]
    st = runner.stats
    row = {"frames": n_frames, "fps": pairs / run_s, "run_s": run_s,
           "fill_s": marks["first_draw"] - marks["first_read"],
           "cli_printed_fps": printed[-1], "runner": runner,
           "windows": st["windows"], "bytes_uploaded": st["bytes_uploaded"]}
    # host ms a frame (decode, warp: every frame read; the rest a pair)
    # and the share of the run each thread was busy in that stage
    for stage, sec, n in (("decode", busy["decode"], n_frames),
                          ("warp", busy["warp"], n_frames),
                          ("upload", st["upload_s"], pairs),
                          ("issue", st["issue_s"], pairs),
                          ("wait", st["wait_s"], pairs),
                          ("draw", busy["draw"], pairs),
                          ("encode", busy["encode"], pairs)):
        row[f"{stage}_ms"] = sec / n * 1e3
        row[f"{stage}_share"] = sec / run_s
    return row


def phase_video_checks(sd):
    """The video path's device ops against their plain versions on the
    card, before its counted run: K1/K2 at the shapes the path gives them,
    the I420 unpack, the grid decimation, and in float32 parity mode the
    i420 runner against the bgr runner fed I420-round-tripped frames."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io.yuv import i420_to_rgb, rgb_to_i420
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.scripts._timing import cuda_ms
    from opticalflow_tpu_torch.video import (VideoFlowRunner, decimate_flow,
                                             yuv_i420_to_rgb_u8)

    worst = corr_check([(VIDEO_B, s) for s in LEVELS_768 + LEVELS_1080],
                       torch.Generator(device="cuda").manual_seed(11),
                       "[11] K1 at the video path's levels")
    log(f"[11] K1 against the plain correlation at every level of 768x1280 "
        f"and 1088x1920, B={VIDEO_B}: max abs float32 "
        f"{worst[torch.float32]!r}, bfloat16 {worst[torch.bfloat16]!r} "
        f"(phase 2's tolerances)")

    rng = np.random.RandomState(12)
    frames = moving_frames(rng, 6, VIDEO_H, VIDEO_W)
    packed = np.stack([rgb_to_i420(f) for f in frames])
    dev = torch.from_numpy(packed).cuda()
    got = yuv_i420_to_rgb_u8(dev).cpu().numpy()
    for g, p in zip(got, packed):
        assert np.array_equal(g, i420_to_rgb(p)), "I420 unpack off io/yuv"
    ms = cuda_ms(lambda _: yuv_i420_to_rgb_u8(dev), 20)
    log(f"[11] yuv_i420_to_rgb_u8 on the card, 6 frames 720x1280: "
        f"bit-exact to io/yuv's numpy; {ms:.3f} ms by CUDA events")

    q = torch.from_numpy(rng.randn(VIDEO_B, 192, 320, 2).astype(np.float32)
                         * 6)
    host = decimate_flow(q, 16, VIDEO_H, VIDEO_W)
    card = decimate_flow(q.cuda(), 16, VIDEO_H, VIDEO_W).cpu()
    d_err = float((card - host).abs().max())
    log(f"[11] decimate_flow on the card vs the host: max abs {d_err!r} "
        f"(bound 1e-4)")
    assert d_err <= 1e-4, d_err

    def roundtrip(f):
        return np.ascontiguousarray(i420_to_rgb(rgb_to_i420(
            np.ascontiguousarray(f[..., ::-1])))[..., ::-1])

    kw = dict(batch=VIDEO_B, device="cuda")
    a = [f for _, _, f in VideoFlowRunner(PWCDCNet(), sd, upload="i420",
                                          **kw).run(iter(frames))]
    b = [f for _, _, f in VideoFlowRunner(PWCDCNet(), sd, upload="bgr",
                                          **kw).run(roundtrip(f)
                                                    for f in frames)]
    r_err = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    log(f"[11] float32 parity: the i420 runner against the bgr runner on "
        f"I420-round-tripped frames, 5 pairs of 720x1280: max abs "
        f"{r_err!r} (bound 1e-4)")
    assert len(a) == len(b) == 5 and r_err <= 1e-4, (len(a), r_err)
    return {"k1_err_f32": worst[torch.float32],
            "k1_err_bf16": worst[torch.bfloat16],
            "k1_shapes": [[VIDEO_B, *s[1:]] for s in LEVELS_768 + LEVELS_1080],
            "i420_ms": ms, "decimate_err": d_err, "runner_i420_err": r_err}


def log_video_row(what: str, row, card: str) -> None:
    log(f"[11] extract_video {what} B={VIDEO_B} bf16, {row['frames']} "
        f"frames: {row['fps']!r} fps over the whole run ({row['run_s']!r} s "
        f"from the first frame read to the writer's release; the fill to "
        f"the first result {row['fill_s']!r} s; the CLI printed "
        f"{row['cli_printed_fps']} fps, timed from its first result); "
        f"{row['windows']} windows, K1 {row['k1_launches']} launches; host "
        f"ms a frame and share of the run busy: decode thread "
        f"{row['decode_ms']:.2f} ({row['decode_share']:.0%}), warp "
        f"{row['warp_ms']:.2f} ({row['warp_share']:.0%}), upload "
        f"{row['upload_ms']:.2f} ({row['upload_share']:.0%}), issue "
        f"{row['issue_ms']:.2f} ({row['issue_share']:.0%}), readback wait "
        f"{row['wait_ms']:.2f} ({row['wait_share']:.0%}), draw "
        f"{row['draw_ms']:.2f} ({row['draw_share']:.0%}), encode thread "
        f"{row['encode_ms']:.2f} ({row['encode_share']:.0%}) [{card}]")


def phase_video(sd, tmp, corr_fwd, card: str):
    """The video CLIs on the card: every overlay mode on a 720p clip, one
    1080p pass, their outputs checked; K1 launches and upload bytes per
    window; each run's fps over the whole run and host ms a frame by
    stage.  Returns its results."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io.video import read_frames

    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    rng = np.random.RandomState(11)
    clip = os.path.join(tmp, "clip720.y4m")
    encode_ms = write_clip(clip, moving_frames(rng, VIDEO_FRAMES, VIDEO_H,
                                               VIDEO_W))
    t0 = time.perf_counter()
    n_alone = len(list(read_frames(clip, max_frames=20)))
    decode_ms = (time.perf_counter() - t0) / n_alone * 1e3
    log(f"[11] clip: {VIDEO_FRAMES} frames {VIDEO_H}x{VIDEO_W} .y4m; host "
        f"alone, one thread: encode {encode_ms:.2f} ms a frame (RGB->I420, "
        f"write), decode {decode_ms:.2f} ms a frame (read, I420->RGB; "
        f"{n_alone} frames) [{card}]")
    h64, w64 = -(-VIDEO_H // 64) * 64, -(-VIDEO_W // 64) * 64
    results = {"encode_ms": encode_ms, "decode_ms": decode_ms, "modes": {}}
    for mode, extra, n in VIDEO_RUNS:
        name = mode + ("_i420" if "i420" in extra else "")
        before = corr_fwd.launches
        row = video_cli([clip, os.path.join(tmp, f"out_{name}.y4m"), "--ckpt",
                         ckpt, "--mode", mode, "--batch", str(VIDEO_B),
                         "--device", "cuda", "--max-frames", str(n), *extra],
                        n, VIDEO_H, VIDEO_W)
        row["k1_launches"] = launched = corr_fwd.launches - before
        windows = row["windows"]
        assert windows == -(-(n - 1) // VIDEO_B), windows
        assert launched == 5 * windows, (launched, windows)
        row["bytes_per_window"] = per_window = \
            row.pop("bytes_uploaded") / windows
        want = (VIDEO_B + 1) * (VIDEO_H * VIDEO_W * 3 // 2 if "i420" in extra
                                else h64 * w64 * 3)
        assert per_window == want, (per_window, want)
        del row["runner"]
        results["modes"][name] = row
        log_video_row(f"--mode {mode} {' '.join(extra)} {VIDEO_H}x{VIDEO_W}"
                      f" ({per_window:.0f} bytes uploaded a window)", row,
                      card)

    # 1080p: the correlation levels of K2's domain
    hd = os.path.join(tmp, "clip1080.y4m")
    write_clip(hd, moving_frames(rng, HD_FRAMES, HD_H, HD_W))
    before = corr_fwd.launches
    row = video_cli([hd, os.path.join(tmp, "out1080.y4m"), "--ckpt", ckpt,
                     "--mode", "arrows", "--batch", str(VIDEO_B), "--device",
                     "cuda"], HD_FRAMES, HD_H, HD_W)
    row["k1_launches"] = launched = corr_fwd.launches - before
    windows = row["windows"]
    assert launched == 5 * windows == 5 * -(-(HD_FRAMES - 1) // VIDEO_B), \
        (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    results["modes"]["arrows_1080"] = row
    log_video_row(f"--mode arrows {HD_H}x{HD_W}", row, card)
    assert "cv2" not in sys.modules, "the port imported OpenCV"
    return results


def phase_video_forward(sd, card: str):
    """The video CLIs' forward alone (bf16 fast, B=4) by CUDA events."""
    import torch
    from opticalflow_tpu_torch.cli.extract_flow import build_model
    from opticalflow_tpu_torch.models.torch_import import reference_state_dict
    from opticalflow_tpu_torch.scripts._timing import cuda_ms
    model = build_model("new", "bfloat16")
    model.load_state_dict(reference_state_dict(sd))
    model = model.cuda().eval()
    out = {}
    for h, w in ((768, 1280), (1088, 1920)):
        x = torch.rand(VIDEO_B, 6, h, w, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
        with torch.inference_mode():
            out[f"{h}x{w}"] = ms = cuda_ms(lambda _: model(x), 10)
        log(f"[11] forward alone {h}x{w} B={VIDEO_B} bf16 fast: {ms:.3f} ms "
            f"({ms / VIDEO_B:.3f} ms a pair) [{card}]")
    return out


def phase_video_engine(sd, tmp):
    """The engine's leftovers on the card: ``resize_fixed`` on the golden
    pair through the engine and through ``cli/infer_kitti`` against the
    port on the CPU, and ``flow_from_batch`` against the pad path."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import infer_kitti
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io.images import (load_image,
                                                 pad_to_multiple_of_64,
                                                 preprocess_pair)
    from opticalflow_tpu_torch.io.kitti import write_flow_png
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet

    im1, im2 = (load_image(os.path.join(GOLD, f"real_im{i}.png"))
                for i in (1, 2))
    kw = dict(preset="rgb_imagenet", size_mode="resize_fixed",
              image_size=FIXED_SIZE)
    cpu = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cpu")
    ref = cpu.flow_from_pair(im1, im2, **kw)
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cuda")
    d_engine = epe(engine.flow_from_pair(im1, im2, **kw), ref)

    kroot = os.path.join(tmp, "kitti_fixed", "training")
    for d in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(kroot, d))
    write_png(os.path.join(kroot, "image_2", "000000_10.png"), im1)
    write_png(os.path.join(kroot, "image_2", "000000_11.png"), im2)
    write_flow_png(os.path.join(kroot, "flow_occ", "000000_10.png"), ref,
                   np.ones(ref.shape[:2], bool))
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    with FlowRecorder() as rec:
        rc, printed, _ = run_cli(infer_kitti.main, [
            "--root", os.path.dirname(kroot), "--ckpt", ckpt, "--size-mode",
            "resize_fixed", "--image-size", *map(str, FIXED_SIZE), "--batch",
            "1", "--device", "cuda"])
    assert rc == 0 and len(rec.flows) == 1, (rc, len(rec.flows))
    d_cli = epe(rec.flows[0][0], ref)
    log(f"[11] resize_fixed ({FIXED_SIZE[0]}x{FIXED_SIZE[1]}) on the golden pair, "
        f"card against the port on the CPU: engine mean EPE {d_engine:.3e}, "
        f"cli/infer_kitti {d_cli:.3e} (bound 1e-4); its printed EPE against "
        f"that flow as a 16-bit PNG {printed} (the PNG's 1/64 px)")
    assert d_engine <= 1e-4 and d_cli <= 1e-4 and printed <= 0.02

    x, _, _ = pad_to_multiple_of_64(preprocess_pair(im1, im2,
                                                    preset="rgb_imagenet"))
    got = engine.flow_from_batch(x, align_corners=True)[0, :180, :318]
    pad = engine.flow_from_pair(im1, im2, preset="rgb_imagenet",
                                size_mode="pad")
    d_batch = float(np.abs(got.cpu().numpy() - pad).max())
    log(f"[11] flow_from_batch (align_corners) against the pad path on the "
        f"same input: max abs {d_batch!r} (bound 1e-4)")
    assert d_batch <= 1e-4
    return {"resize_fixed_epe": d_engine, "infer_kitti_epe": d_cli,
            "flow_from_batch_err": d_batch}


# ------------------------------------------------------------ phase 12

# serving at Sintel size: 16 moving pairs; 16 client threads send 128 raw
# requests, then one client 16 in a row (the B=1 bucket), then 4 JSON ones;
# a burst of 16 is drained by SIGTERM
SERVE_PAIRS = 16
SERVE_CLIENTS = 16
SERVE_CONCURRENT = 128
SERVE_JSON = 4
# the serving CLI, run in a child process by this script with its own
# instrumentation (the CLI is unchanged): K1's count set to 0 before main
# and read after it returns; the FlowServer's final metrics; every engine
# call of the dispatch thread (start, end, batch, host /64 resize seconds
# inside it); the card's peak memory.  One JSON line after main returns.
SERVE_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from opticalflow_tpu_torch import serve as S
from opticalflow_tpu_torch.cli import serve as cli
from opticalflow_tpu_torch.engine import FlowEngine
from opticalflow_tpu_torch.io import images as imio
from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda

servers, calls, resize_s = [], [], [0.0]


class Server(S.FlowServer):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        servers.append(self)


def timed_pairs(self, im1s, im2s, _real=FlowEngine.flow_from_pairs, **kw):
    r0, t0 = resize_s[0], time.perf_counter()
    out = _real(self, im1s, im2s, **kw)
    calls.append((t0, time.perf_counter(), len(im1s), resize_s[0] - r0))
    return out


def timed_resize(img, _real=imio.resize_to_multiple_of_64):
    t0 = time.perf_counter()
    out = _real(img)
    resize_s[0] += time.perf_counter() - t0
    return out


S.FlowServer = Server
FlowEngine.flow_from_pairs = timed_pairs
imio.resize_to_multiple_of_64 = timed_resize
correlation_cuda.launches = 0
rc = cli.main(sys.argv[2:])
print("SERVE_CHILD " + json.dumps({
    "rc": rc, "launches": correlation_cuda.launches,
    "metrics": servers[0].metrics.snapshot(),
    "buckets": servers[0].bucket_sizes, "calls": calls,
    "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}), flush=True)
sys.exit(rc)
"""


def post(conn, body, headers):
    """One POST /v1/flow on a kept-alive connection: (status, body bytes,
    seconds from the request's first byte to the response's last)."""
    t0 = time.perf_counter()
    conn.request("POST", "/v1/flow", body, headers)
    resp = conn.getresponse()
    data = resp.read()
    return resp.status, data, time.perf_counter() - t0


def get_json(port: int, path: str):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        assert resp.status == 200, (path, resp.status)
        return json.loads(resp.read())
    finally:
        conn.close()


def flo_array(data: bytes, h: int, w: int):
    import struct
    import numpy as np
    tag, fw, fh = struct.unpack("<fii", data[:12])
    assert abs(tag - 202021.25) < 1e-3 and (fh, fw) == (h, w), (tag, fh, fw)
    return np.frombuffer(data[12:], "<f4").reshape(h, w, 2)


def percentiles(seconds) -> dict:
    """p50/p90/p99 in ms, by the same rule as ``ServerMetrics.snapshot``."""
    s = sorted(seconds)
    return {f"p{int(q * 100)}": s[min(len(s) - 1, int(q * len(s)))] * 1e3
            for q in (0.50, 0.90, 0.99)}


def burst(port: int, jobs, headers, clients: int):
    """``jobs`` (pair index, body) sent by ``clients`` threads, each on its
    own kept-alive connection, every thread's share in order.  Returns
    [(pair index, status, body, seconds)] and the burst's wall seconds."""
    import http.client
    import threading
    results = []
    lock = threading.Lock()

    def client(share):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for i, body in share:
                r = post(conn, body, headers)
                with lock:
                    results.append((i, *r))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(jobs[k::clients],))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "a client hung"
    return results, wall


def start_serving_cli(argv):
    """The serving CLI in a child process (:data:`SERVE_CHILD`); returns
    (process, its port, its output lines: a list the reader thread keeps
    appending to until the child exits, the reader thread)."""
    import queue
    import subprocess
    import threading
    proc = subprocess.Popen([sys.executable, "-c", SERVE_CHILD, ROOT, *argv],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, ports = [], queue.Queue()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on http://"):
                ports.put(int(line.split("http://")[1].split()[0]
                              .rsplit(":", 1)[1]))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.perf_counter() + 300
    while True:
        try:
            return proc, ports.get(timeout=1.0), lines, reader
        except queue.Empty:
            if proc.poll() is not None or time.perf_counter() > deadline:
                proc.kill()
                raise AssertionError("the serving CLI did not come up:\n"
                                     + "".join(lines[-40:]))


def dispatch_share(calls, t0: float, t1: float) -> dict:
    """The dispatch thread's engine calls inside [t0, t1] (its clock and this
    process's are both CLOCK_MONOTONIC): busy share of the window, the host
    /64 resize's share, mean batch, ms a call."""
    inside = [c for c in calls if c[0] >= t0 and c[1] <= t1]
    busy = sum(c[1] - c[0] for c in inside)
    return {"calls": len(inside), "busy_share": busy / (t1 - t0),
            "resize_share": sum(c[3] for c in inside) / (t1 - t0),
            "mean_batch": (sum(c[2] for c in inside) / len(inside)
                           if inside else 0.0),
            "ms_per_call": busy / len(inside) * 1e3 if inside else 0.0}


def phase_serve(sd, tmp, counter, card: str):
    """The serving CLI on the card at its defaults, then a float32
    parity-mode server in this process and the engine alone.  Returns a
    dict of its results."""
    import base64
    import http.client
    import signal
    import threading
    import numpy as np
    import torch
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io.images import encode_png
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.serve import FlowServer, make_http_server

    t_phase = time.perf_counter()
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    frames = moving_frames(np.random.RandomState(12), SERVE_PAIRS + 1,
                           FULL_H, FULL_W)
    pairs = list(zip(frames[:-1], frames[1:]))
    bodies = [a.tobytes() + b.tobytes() for a, b in pairs]
    raw = {"Content-Type": "application/octet-stream",
           "X-Frame-Shape": f"{FULL_H}x{FULL_W}x3", "X-Timeout": "120"}

    # 1. the CLI at its defaults (bfloat16 fast, max batch 8, 5 ms, auto
    # buckets), warmed up at Sintel size
    t0 = time.perf_counter()
    proc, port, lines, reader = start_serving_cli(
        ["--ckpt", ckpt, "--port", "0", "--warmup", f"{FULL_H}x{FULL_W}",
         "--device", "cuda"])
    startup_s = time.perf_counter() - t0
    try:
        # 2. concurrent traffic, then one client in a row, then JSON
        jobs = [(i % SERVE_PAIRS, bodies[i % SERVE_PAIRS])
                for i in range(SERVE_CONCURRENT)]
        t_c0 = time.perf_counter()
        conc, wall_c = burst(port, jobs, raw, SERVE_CLIENTS)
        t_c1 = time.perf_counter()
        m_c = get_json(port, "/metrics")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        t_s0 = time.perf_counter()
        seq = [post(conn, body, raw) for body in bodies]
        t_s1 = time.perf_counter()
        m_s = get_json(port, "/metrics")
        json_resp = []
        for i in range(SERVE_JSON):
            req = json.dumps({k: base64.b64encode(encode_png(im)).decode()
                              for k, im in zip(("im1", "im2"), pairs[i])})
            json_resp.append(post(conn, req.encode(),
                                  {"Content-Type": "application/json"}))
        conn.close()
        # 3. the probes
        health = get_json(port, "/healthz")
        m_all = get_json(port, "/metrics")
        # 6. a burst of 16 on fresh connections, SIGTERM once the first
        # answer is back (all 16 were accepted long before: a batch takes
        # far longer than 16 connects)
        drained, first = [], threading.Event()

        def one(i):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            try:
                drained.append((i, *post(c, bodies[i], raw)))
            finally:
                c.close()
                first.set()

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(SERVE_PAIRS)]
        for t in threads:
            t.start()
        assert first.wait(120), "no answer in the SIGTERM burst"
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(timeout=300)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    reader.join(timeout=60)                 # the child's last lines
    child = [json.loads(ln.split(" ", 1)[1]) for ln in lines
             if ln.startswith("SERVE_CHILD ")]
    assert rc == 0 and child, (rc, "".join(lines[-40:]))
    child = child[0]
    for (i, status, data, _) in conc + drained:
        assert status == 200, (i, status, data[:200])
        f = flo_array(data, FULL_H, FULL_W)
        assert np.isfinite(f).all(), i
    assert all(status == 200 for status, _, _ in seq + json_resp)
    assert len(drained) == SERVE_PAIRS, len(drained)
    # the JSON route decodes the same frames: the same bytes as the raw
    # requests of the same pairs, which rode the same B=1 bucket
    for i, (_, data, _) in enumerate(json_resp):
        assert data == seq[i][1], f"JSON pair {i} differs from the raw one"
    n_total = SERVE_CONCURRENT + 2 * SERVE_PAIRS + SERVE_JSON
    assert health == {"ok": True}, health
    assert m_c["requests"] == SERVE_CONCURRENT and m_c["errors"] == 0, m_c
    assert m_s["batches"] - m_c["batches"] == SERVE_PAIRS, (m_s, m_c)
    assert m_all["requests"] == n_total - SERVE_PAIRS, m_all
    final = child["metrics"]
    assert final["requests"] == n_total and final["errors"] == 0, final
    # 5. K1: 5 launches a dispatched batch, and a warm-up forward per
    # bucket and size mode
    warm = len(child["buckets"]) * 2
    assert child["launches"] == 5 * (final["batches"] + warm), \
        (child["launches"], final["batches"], warm)
    occupancy_c = SERVE_CONCURRENT / m_c["batches"]
    lat_c = percentiles([r[3] for r in conc])
    lat_s = percentiles([r[2] for r in seq])
    share = dispatch_share(child["calls"], t_c0, t_c1)
    share_s = dispatch_share(child["calls"], t_s0, t_s1)
    rps = SERVE_CONCURRENT / wall_c
    log(f"[12] serving CLI (bfloat16 fast, --max-batch 8, --max-delay-ms 5, "
        f"buckets {child['buckets']}), {FULL_H}x{FULL_W} raw requests: "
        f"startup with warm-up {startup_s:.1f} s; {SERVE_CONCURRENT} from "
        f"{SERVE_CLIENTS} clients in {wall_c:.3f} s = {rps!r} requests/s, "
        f"latency p50/p90/p99 {lat_c['p50']:.1f} / {lat_c['p90']:.1f} / "
        f"{lat_c['p99']:.1f} ms, {m_c['batches']} batches, mean occupancy "
        f"{occupancy_c:.2f}; dispatch thread in the engine "
        f"{share['busy_share']:.1%} of the burst ({share['ms_per_call']:.1f}"
        f" ms a call, host /64 resize {share['resize_share']:.1%} of the "
        f"burst); {card}")
    log(f"[12] one client, {SERVE_PAIRS} in a row (the B=1 bucket): "
        f"latency p50/p90/p99 {lat_s['p50']:.1f} / {lat_s['p90']:.1f} / "
        f"{lat_s['p99']:.1f} ms; dispatch in the engine "
        f"{share_s['ms_per_call']:.1f} ms a call; {SERVE_JSON} JSON (base64 "
        f"PNG) requests: the raw route's bytes; /healthz {health}; /metrics "
        f"requests {m_all['requests']} errors {m_all['errors']}")
    log(f"[12] SIGTERM during a burst of {SERVE_PAIRS}: {len(drained)} "
        f"answered 200, exit code {rc}; the server's totals: {final}; K1 "
        f"launches in the CLI {child['launches']} = 5 x ({final['batches']} "
        f"batches + {warm} warm-up forwards); peak {child['peak_mib']:.0f} "
        f"MiB")

    # 4. fidelity: a float32 parity-mode server in this process, each
    # response against the engine's own flow_from_pair
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=20.0, device="cuda")
    server = FlowServer(engine, max_batch=8, max_delay_ms=5)
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        engine.flow_from_pairs([pairs[0][0]] * 8, [pairs[0][1]] * 8)
        before = counter.launches
        parity, _ = burst(httpd.server_address[1],
                          [(i, bodies[i]) for i in range(SERVE_PAIRS)], raw,
                          8)
        launched_p = counter.launches - before
        batches_p = server.metrics.snapshot()["batches"]
    finally:
        httpd.shutdown()
        server.close()
        httpd.server_close()
    assert launched_p == 5 * batches_p, (launched_p, batches_p)
    epes = []
    for i, status, data, _ in parity:
        assert status == 200, (i, status)
        epes.append(epe(flo_array(data, FULL_H, FULL_W),
                        engine.flow_from_pair(*pairs[i])))
    log(f"[12] float32 parity-mode server, {len(parity)} concurrent "
        f"requests in {batches_p} batches: each response against "
        f"flow_from_pair of its pair, mean EPE max {max(epes)!r} (bound "
        f"1e-4); K1 {launched_p} launches")
    assert max(epes) <= 1e-4, max(epes)

    # 7. the engine alone, bfloat16 fast (the CLI's model), resize mode
    fast = FlowEngine(PWCDCNet(dtype=torch.bfloat16, precision="fast"), sd,
                      flow_scale=20.0, device="cuda")
    im1s, im2s = [p[0] for p in pairs[:8]], [p[1] for p in pairs[:8]]
    fast.flow_from_pairs(im1s, im2s)
    fast.flow_from_pair(*pairs[0])
    t0 = time.perf_counter()
    for _ in range(4):
        fast.flow_from_pairs(im1s, im2s)
    alone_b8 = 32 / (time.perf_counter() - t0)
    lat1 = []
    for a, b in pairs:
        t0 = time.perf_counter()
        fast.flow_from_pair(a, b)
        lat1.append(time.perf_counter() - t0)
    alone_b1 = percentiles(lat1)
    log(f"[12] FlowEngine.flow_from_pairs alone, bfloat16 fast, resize, "
        f"{FULL_H}x{FULL_W}: B=8 {alone_b8!r} pairs/s (the server: "
        f"{rps / alone_b8:.2f} of it); B=1 latency p50/p90/p99 "
        f"{alone_b1['p50']:.1f} / {alone_b1['p90']:.1f} / "
        f"{alone_b1['p99']:.1f} ms; phase 12 took "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return {"requests_per_s": rps, "concurrent_wall_s": wall_c,
            "latency_ms": lat_c, "sequential_latency_ms": lat_s,
            "mean_occupancy": occupancy_c, "batches": m_c["batches"],
            "dispatch": share, "dispatch_sequential": share_s,
            "peak_mib": child["peak_mib"], "startup_s": startup_s,
            "final_metrics": final, "drained": len(drained),
            "launches_cli": child["launches"], "launches_parity": launched_p,
            "parity_epe_max": max(epes),
            "engine_alone_b8_pairs_per_s": alone_b8,
            "engine_alone_b1_latency_ms": alone_b1,
            "server_over_engine": rps / alone_b8, "card": card}


# ------------------------------------------------------------ phase 13

# the shapes an artifact of dynamic="all" runs at: Sintel padded (B=1 and
# B=4), a 64-pixel side (level 6 is 1 pixel wide), 1080p (K2's domain)
EXPORT_SHAPES = ((1, 448, 1024), (4, 448, 1024), (1, 64, 64),
                 (2, 1088, 1920))


def artifact_check(fn, model, b, h, w, counter, seed: int):
    """``fn`` against the eager ``model`` ×20 on ``parity_check``'s input
    (``RandomState(seed).rand`` of the NHWC shape, transposed): its
    parity report and its K1 launches."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.utils.metrics import parity_report
    x = np.random.RandomState(seed).rand(b, h, w, 6).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))).cuda()
    before = counter.launches
    got = fn(xt)
    torch.cuda.synchronize()
    launched = counter.launches - before
    with torch.inference_mode():
        want = model(xt) * 20.0
    rep = parity_report(got.permute(0, 2, 3, 1).cpu().numpy(),
                        want.permute(0, 2, 3, 1).cpu().numpy())
    return xt, got, rep, launched


def phase_export(sd, tmp, counter, card: str):
    """Export and parity on the card.  Returns a dict of its results."""
    import contextlib
    import io
    import torch
    from opticalflow_tpu_torch.cli import parity as parity_cli
    from opticalflow_tpu_torch.export import export_program, load_exported
    from opticalflow_tpu_torch.io.images import decode_png
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.models.torch_import import reference_state_dict
    from opticalflow_tpu_torch.scripts._timing import cuda_ms
    from opticalflow_tpu_torch.utils.metrics import parity_report

    t_phase = time.perf_counter()
    weights = reference_state_dict(sd)

    def parity_model(use_cuda_corr=True):
        m = PWCDCNet(use_cuda_corr=use_cuda_corr)
        m.load_state_dict(weights)
        return m.cuda().eval()

    # 1. the float32 parity model, with the kernel's operator, dynamic="all"
    model = parity_model()
    path = os.path.join(tmp, "kernel.pt2")
    t0 = time.perf_counter()
    export_program(model, path, dynamic="all")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = load_exported(path)
    load_s = time.perf_counter() - t0
    assert art.metadata["precision"] == "highest", art.metadata
    # 3. the same model with the plain correlation, exported at the first
    # shape (a dynamic export of its 405 shifted products traces for 95 s
    # on a CPU core, a static one for 19 s)
    plain_model = parity_model(use_cuda_corr=False)
    plain_path = os.path.join(tmp, "plain.pt2")
    b0, h0, w0 = EXPORT_SHAPES[0]
    t0 = time.perf_counter()
    export_program(plain_model, plain_path, input_shape=(b0, 6, h0, w0))
    plain_export_s = time.perf_counter() - t0
    plain = load_exported(plain_path)
    log(f"[13] exported the float32 parity model (dynamic='all') in "
        f"{export_s:.1f} s (loaded in {load_s:.1f} s), with the plain "
        f"correlation at {b0}x6x{h0}x{w0} in {plain_export_s:.1f} s")

    # 2. each shape: the eager model's flow, K1 5 times a call; at the
    # first, the plain artifact against the kernel artifact
    rows = []
    for k, (b, h, w) in enumerate(EXPORT_SHAPES):
        xt, got, rep, launched = artifact_check(art, model, b, h, w, counter,
                                                seed=k)
        n = 20 if b * h * w <= 448 * 1024 else 5
        with torch.inference_mode():
            ms = cuda_ms(lambda _: art(xt), n)
            ms_eager = cuda_ms(lambda _: model(xt) * 20.0, n)
        row = {"shape": [b, 6, h, w], "epe_mean": rep["epe_mean"],
               "agree@0.25": rep["agree@0.25"], "launches": launched,
               "ms": ms, "eager_ms": ms_eager}
        rows.append(row)
        log(f"[13] artifact at {b}x6x{h}x{w}: against the eager model epe_mean "
            f"{rep['epe_mean']!r}, agree@0.25 {rep['agree@0.25']}% (bounds "
            f"< 1e-5, 100); K1 {launched} launches; forward by CUDA events: "
            f"artifact {ms:.3f} ms, eager {ms_eager:.3f} ms")
        assert rep["epe_mean"] < 1e-5 and rep["agree@0.25"] == 100.0, rep
        assert launched == 5, launched
        if k:
            continue
        before = counter.launches
        got_plain = plain(xt)
        torch.cuda.synchronize()
        plain_launched = counter.launches - before
        rep_plain = parity_report(got_plain.permute(0, 2, 3, 1).cpu().numpy(),
                                  got.permute(0, 2, 3, 1).cpu().numpy())
        row.update({"plain_vs_kernel_epe_mean": rep_plain["epe_mean"],
                    "plain_vs_kernel_agree@0.25": rep_plain["agree@0.25"],
                    "plain_launches": plain_launched,
                    "plain_ms": cuda_ms(lambda _: plain(xt), 5)})
        log(f"[13] the plain artifact at {b}x6x{h}x{w} against the kernel "
            f"artifact: epe_mean {rep_plain['epe_mean']!r}, agree@0.25 "
            f"{rep_plain['agree@0.25']}% (the same bounds); K1 "
            f"{plain_launched}; forward {row['plain_ms']:.3f} ms")
        assert rep_plain["epe_mean"] < 1e-5, rep_plain
        assert rep_plain["agree@0.25"] == 100.0, rep_plain
        assert plain_launched == 0, plain_launched

    # the host's cost of a call through the PyTorch operator (the node an
    # artifact holds) beside the wrapper the eager model calls, at level 6
    # of 448x1024 (the smallest launch of a forward), in turns
    from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda
    from opticalflow_tpu_torch.scripts._timing import host_ms
    g = torch.Generator(device="cuda").manual_seed(13)
    f1, f2 = (torch.randn(1, 196, 7, 16, generator=g, device="cuda")
              for _ in range(2))
    op = torch.ops.opticalflow_tpu_torch.correlation
    issue_us = {"operator": [], "wrapper": []}
    with torch.inference_mode():
        for _ in range(2):
            issue_us["wrapper"].append(host_ms(
                lambda _: correlation_cuda(f1, f2), 2000) * 1e3)
            issue_us["operator"].append(host_ms(
                lambda _: op(f1, f2, 4), 2000) * 1e3)
    log(f"[13] host time to issue one K1 call at 1x196x7x16 (2000 calls, "
        f"twice each, in turns): through torch.ops.opticalflow_tpu_torch."
        f"correlation {[round(v, 2) for v in issue_us['operator']]} us, the "
        f"ctypes wrapper alone {[round(v, 2) for v in issue_us['wrapper']]} "
        f"us")

    # 4. the parity CLI at 1x448x1024: exports (static), checks, reports
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    png = os.path.join(tmp, "parity.png")
    buf = io.StringIO()
    before = counter.launches
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = parity_cli.main(["--ckpt", ckpt, "--artifact",
                              os.path.join(tmp, "model.pt2"), "--shape", "1",
                              "448", "1024", "--report-image", png,
                              "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    cli_launches = counter.launches - before
    text = buf.getvalue()
    rep_cli = json.loads(text[text.index("{"):text.rindex("}") + 1])
    with open(png, "rb") as f:
        fig = decode_png(f.read())
    log(f"[13] cli/parity --shape 1 448 1024: rc {rc}, "
        f"{text.strip().splitlines()[-1]!r}, epe_mean "
        f"{rep_cli['epe_mean']!r}, report {fig.shape}, {cli_s:.1f} s, K1 "
        f"{cli_launches} launches; phase 13 took "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    assert rc == 0 and "PARITY: PASS" in text, text[-400:]
    assert fig.ndim == 3 and fig.shape[2] == 3, fig.shape
    assert cli_launches == 10, cli_launches    # the model's and the artifact's
    return {"export_s": export_s, "load_s": load_s,
            "plain_export_s": plain_export_s, "shapes": rows,
            "issue_us": issue_us,
            "launches": sum(r["launches"] for r in rows) + cli_launches,
            "cli": {"rc": rc, "epe_mean": rep_cli["epe_mean"],
                    "seconds": cli_s, "launches": cli_launches},
            "card": card}


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "opticalflow_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(opticalflow_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from opticalflow_tpu_torch.ops.corr_cuda import (correlation_bwd_cuda,
                                                     correlation_cuda)
    from opticalflow_tpu_torch.ops.fused_warpcorr import fused_warp_corr_cuda
    from opticalflow_tpu_torch.ops.gather import row_gather_cuda
    from opticalflow_tpu_torch.scripts import (probe_fused_warpcorr,
                                               probe_gather)
    counters = (correlation_cuda, correlation_bwd_cuda, fused_warp_corr_cuda,
                row_gather_cuda)

    def zero_counts():
        for k in counters:
            k.launches = 0

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    k1_err, k1_rows, k2_rows, k1_rows_bf16 = phase_corr_vs_plain()
    k3_err, k3_err_bf16, k3_excluded = phase_fused_vs_plain()

    zero_counts()                           # K3's path starts here
    log("[3] probe_fused_warpcorr.main():")
    k3_rows = probe_fused_warpcorr.main([])
    k3_launches = fused_warp_corr_cuda.launches   # ... and ends here
    assert k3_launches > 0 and k3_rows
    for dtype in ("float32", "bfloat16"):
        for b in (1, 8):
            sel = [r for r in k3_rows
                   if r["batch"] == b and r["dtype"] == dtype]
            fused, comp = (sum(r[k] for r in sel) * 1e3 for k in
                           ("fused_device_ms", "composed_device_ms"))
            log(f"[3] levels 2-5 of 448x1024, B={b} {dtype}: card alone "
                f"fused {fused:.2f} us, composed {comp:.2f} us "
                f"({comp / fused:.2f}x), bound "
                f"{sum(r['bound_ms'] for r in sel) * 1e3:.2f} us")

    k4_err, k4_plain_ms, launch_floor_ms = phase_gather_vs_plain()
    zero_counts()                           # K4's path starts here
    log("[4] probe_gather.main():")
    k4_rows = probe_gather.main([])
    k4_launches = row_gather_cuda.launches  # ... and ends here
    assert k4_launches > 0 and k4_rows["kernel"]["correct"]

    zero_counts()                           # the main path starts here
    with tempfile.TemporaryDirectory() as tmp:
        sd = phase_cli(tmp, correlation_cuda)
    engine, _ = phase_full_width(sd, correlation_cuda)
    k1_launches = correlation_cuda.launches  # ... and ends here
    assert k1_launches > 0
    phase_forward_time(engine)

    b1_err, b1_err_bf16, b1_rows = phase_corr_bwd()
    train = phase_train(sd, correlation_cuda, correlation_bwd_cuda)
    b1_launches = train["launches"]["correlation_bwd"]
    zero_counts()                           # the eval path starts here
    with tempfile.TemporaryDirectory() as tmp:
        evals = phase_eval(sd, tmp, correlation_cuda)
    eval_launches = correlation_cuda.launches  # ... and ends here
    assert eval_launches > 0
    with tempfile.TemporaryDirectory() as tmp:
        train_cli = phase_train_cli(sd, tmp, correlation_cuda,
                                    correlation_bwd_cuda, card_line())

    t_video = time.perf_counter()
    video_checks = phase_video_checks(sd)
    zero_counts()                           # the video path starts here
    with tempfile.TemporaryDirectory() as tmp:
        video = phase_video(sd, tmp, correlation_cuda, card_line())
        video_launches = correlation_cuda.launches   # ... and ends here
        assert video_launches > 0
        video["forward_ms"] = phase_video_forward(sd, card_line())
        video["engine"] = phase_video_engine(sd, tmp)
    video["checks"] = video_checks
    video["card"] = card_line()
    video["phase_s"] = time.perf_counter() - t_video
    log(f"[11] phase 11 took {video['phase_s']:.1f} s")

    zero_counts()                           # the serving path starts here
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(sd, tmp, correlation_cuda, card_line())
    # ... and ends here: the CLI's launches (counted in its process from 0)
    # and the parity-mode server's (this process, its burst alone)
    serve_launches = serve["launches_cli"] + serve["launches_parity"]
    assert serve_launches > 0
    zero_counts()                           # the export path starts here
    with tempfile.TemporaryDirectory() as tmp:
        export = phase_export(sd, tmp, correlation_cuda, card_line())
    export_launches = export["launches"]    # ... and ends here
    assert export_launches > 0 and correlation_cuda.launches >= \
        export_launches

    # one forward's worth: the levels of a 448x1024 pair, B=1, float32
    k1 = summed([r for r in k1_rows if r["batch"] == 1])
    k2 = summed(k2_rows)
    k3_f32_b1 = [r for r in k3_rows
                 if r["batch"] == 1 and r["dtype"] == "float32"]
    k3 = summed(k3_f32_b1, "fused_ms")
    b1 = summed([r for r in b1_rows if r["frame"] == "320x896"
                 and r["dtype"] == "float32"])
    kernels = [
        {"name": "correlation_fwd", "route": "cuda",
         "source": "opticalflow_tpu_torch/csrc/correlation_fwd.cu",
         "replaces": "opticalflow_tpu/ops/pallas_corr.py:113",
         "also_replaces": "opticalflow_tpu/ops/pallas_corr.py:138",
         "launches": k1_launches, "max_abs_err": k1_err, **k1,
         "library_ms": None, "per_level": k1_rows,
         "per_level_bf16": k1_rows_bf16,
         # K2's domain: one forward's worth at 1088x1920, B=1, float32
         "at_1088x1920": {**k2, "per_level": k2_rows},
         # its launches on the training path (5 per step) and the eval path
         "launches_train": train["launches"]["correlation_fwd"],
         "launches_eval": eval_launches, "eval": evals,
         # the training CLI's runs (phase 10: steps, validation, masks)
         "launches_train_cli": train_cli["launches"]["correlation_fwd"],
         # the video CLIs' runs (phase 11: 5 a window, 720p and 1080p)
         "launches_video": video_launches, "video": video,
         # the serving CLI and a parity-mode server (phase 12: 5 a batch)
         "launches_serve": serve_launches, "serve": serve,
         # loaded artifacts and the parity CLI (phase 13: 5 a call)
         "launches_export": export_launches, "export": export},
        {"name": "correlation_bwd", "route": "cuda",
         "source": "opticalflow_tpu_torch/csrc/correlation_bwd.cu",
         # no TPU kernel: the JAX custom_vjp's backward is lax
         "replaces": "opticalflow_tpu/ops/pallas_corr.py:253",
         "launches": b1_launches, "max_abs_err": b1_err,
         "max_abs_err_bf16": b1_err_bf16,
         # one training step's worth: the 5 levels of 320x896, B=4, float32
         **b1, "library_ms": None,
         # per level of that step: the plan the kernel chose
         "plan": [{k: r[k] for k in ("level", "tile", "split",
                                     "channels_per_split", "threads",
                                     "blocks_per_sm", "registers")}
                  for r in b1_rows if r["frame"] == "320x896"
                  and r["dtype"] == "float32"],
         "per_level": b1_rows, "train_step": train,
         "launches_train_cli": train_cli["launches"]["correlation_bwd"],
         "train_cli": train_cli},
        {"name": "fused_warp_corr", "route": "cuda",
         "source": "opticalflow_tpu_torch/csrc/fused_warp_corr.cu",
         "replaces": "scripts/probe_fused_warpcorr.py:80",
         "launches": k3_launches, "max_abs_err": k3_err,
         "max_abs_err_bf16": k3_err_bf16, "excluded_pixels": k3_excluded,
         **k3, "library_ms": None,
         # no single PyTorch call computes it; the composed path (warp,
         # then K1) is the yardstick
         "composed_ms": sum(r["composed_ms"] for r in k3_f32_b1),
         # the same with the host out of the way (calls queued behind a
         # spin kernel)
         "device_ms": sum(r["fused_device_ms"] for r in k3_f32_b1),
         "composed_device_ms": sum(r["composed_device_ms"]
                                   for r in k3_f32_b1),
         # per level 2-5 (B=1, float32): the plan chosen and the card's time
         "plan": [r["plan"] for r in k3_f32_b1],
         "per_level_device_ms": [r["fused_device_ms"] for r in k3_f32_b1],
         "per_shape": k3_rows},
        {"name": "row_gather", "route": "cuda",
         "source": "opticalflow_tpu_torch/csrc/row_gather.cu",
         "replaces": "scripts/probe_gather.py:26",
         "launches": k4_launches, "max_abs_err": k4_err,
         "ms": k4_rows["kernel"]["ms"], "plain_ms": k4_plain_ms,
         "bound_ms": k4_rows["kernel"]["bound_ms"],
         "bound_by": k4_rows["kernel"]["bound_by"],
         "library_ms": k4_rows["index_select"]["ms"],
         "host_ms": k4_rows["kernel"]["host_ms"],
         "library_host_ms": k4_rows["index_select"]["host_ms"],
         "device_ms": k4_rows["kernel"]["device_ms"],
         "library_device_ms": k4_rows["index_select"]["device_ms"],
         "wrapper_pieces": k4_rows["wrapper_pieces"],
         # the smallest launch through the shared launch path (one row)
         "launch_floor_ms": launch_floor_ms,
         "at_1M_rows": {"ms": k4_rows["kernel_large"]["ms"],
                        "library_ms": k4_rows["index_select_large"]["ms"],
                        "bound_ms": k4_rows["kernel_large"]["bound_ms"]}},
    ]
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
