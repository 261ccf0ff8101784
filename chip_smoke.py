#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``opticalflow_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from the
sources there.  Every phase fails loudly (an assertion or exception exits
non-zero, and no result line is printed):

  1. build the three kernels (one ``nvcc`` each, started together) and
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
  7. one JSON line listing every kernel with its launches on its path,
     error, times and bound; the card's name and power limit; the result
     line.

Each kernel's launch count is set to 0 just before its path and read just
after: the CLI and engine for K1, the probe entry points for K3 and K4.
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
    assert set(paths) == {"correlation_fwd", "fused_warp_corr",
                          "row_gather"}, sorted(paths)
    for name, path in paths.items():
        report = path.with_name(path.name + ".ptxas.txt")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
            if "spill" in line:
                assert "0 bytes spill stores, 0 bytes spill loads" in line, \
                    f"{name} spills: {line.strip()}"


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
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    shapes = [(b, s) for b in (1, 8) for s in LEVELS] + [
        (1, s) for s in EXTRA_SHAPES]
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
            log(f"[2] {name:13s} B={b} {str(dtype)[6:]:8s} ({h}x{w}x{c}) "
                f"max|kernel-plain| {e:.3e}" + ("" if not bad else
                                                 f"  {bad} OVER TOLERANCE"))
            assert bad == 0, f"kernel disagrees with plain at {name} {dtype}"

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
    from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda
    from opticalflow_tpu_torch.ops.fused_warpcorr import fused_warp_corr_cuda
    from opticalflow_tpu_torch.ops.gather import row_gather_cuda
    from opticalflow_tpu_torch.scripts import (probe_fused_warpcorr,
                                               probe_gather)
    counters = (correlation_cuda, fused_warp_corr_cuda, row_gather_cuda)

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

    # one forward's worth: the levels of a 448x1024 pair, B=1, float32
    k1 = summed([r for r in k1_rows if r["batch"] == 1])
    k2 = summed(k2_rows)
    k3_f32_b1 = [r for r in k3_rows
                 if r["batch"] == 1 and r["dtype"] == "float32"]
    k3 = summed(k3_f32_b1, "fused_ms")
    kernels = [
        {"name": "correlation_fwd", "route": "cuda",
         "source": "opticalflow_tpu_torch/csrc/correlation_fwd.cu",
         "replaces": "opticalflow_tpu/ops/pallas_corr.py:113",
         "also_replaces": "opticalflow_tpu/ops/pallas_corr.py:138",
         "launches": k1_launches, "max_abs_err": k1_err, **k1,
         "library_ms": None, "per_level": k1_rows,
         "per_level_bf16": k1_rows_bf16,
         # K2's domain: one forward's worth at 1088x1920, B=1, float32
         "at_1088x1920": {**k2, "per_level": k2_rows}},
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
