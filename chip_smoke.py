#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``opticalflow_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from the
sources there.  Every phase fails loudly (an assertion or exception exits
non-zero, and no result line is printed):

  1. build the kernels (``nvcc``, first use) and print the build time and
     the compiler's register/shared-memory report;
  2. hold the correlation kernel against its plain PyTorch version on the
     card: every level of a 448x1024 input at B=1 and B=8, the 1088x1920
     level-2 shape and a ragged shape, float32 and bfloat16; then time it
     per level beside its bound and the plain version;
  3. the main path through its entry point: the single-pair CLI on the
     real golden frames with fake reference weights, against
     ``tests/goldens/real_pair_pad.flo``, counting 5 kernel launches;
  4. full width: ``FlowEngine`` in pad mode at Sintel 436x1024 (padded to
     448x1024), float32, B=1 and B=8 — pairs/s, latency, peak memory;
  5. one JSON line listing every kernel with its launches, error and times;
  6. the card's name and power limit, then the result line.

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

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores, which the kernel's FMAs use.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
MD = 4
ND2 = (2 * MD + 1) ** 2
# (name, H, W, C) of the correlation inputs at each pyramid level of a
# 448x1024 frame (the Sintel 436x1024 padded to /64)
LEVELS = (("L2", 112, 256, 32), ("L3", 56, 128, 64), ("L4", 28, 64, 96),
          ("L5", 14, 32, 128), ("L6", 7, 16, 196))
# level 2 of a 1088x1920 frame (the Pallas windowed kernel's domain), and
# a shape whose W is not a multiple of the kernel's 32-column tile
EXTRA_SHAPES = (("L2@1088x1920", 272, 480, 32), ("ragged", 9, 45, 20))
FULL_H, FULL_W = 436, 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def epe(a, b) -> float:
    import numpy as np
    return float(np.mean(np.hypot(*(a - b).transpose(2, 0, 1))))


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def corr_bound(b: int, h: int, w: int, c: int, itemsize: int):
    """Least time for one correlation call: f1 and f2 read once, the 81
    maps written once, against the FMAs it must do.  Returns
    (bound_ms, "bytes" | "operations")."""
    nbytes = (2 * b * c * h * w + b * ND2 * h * w) * itemsize
    flops = 2.0 * b * ND2 * c * h * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from opticalflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build(_build.KERNEL_SOURCES)
    log(f"[1] built {len(paths)} kernel(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        report = path.with_name(path.name + ".ptxas.txt")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")


def phase_kernel_vs_plain():
    """Returns (max f32 error, per-level timing rows)."""
    import torch
    from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda
    from opticalflow_tpu_torch.ops.correlation import correlation_plain

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

    rows = []
    for b in (1, 8):
        for name, h, w, c in LEVELS:
            f1 = torch.randn(b, c, h, w, generator=g, device="cuda")
            f2 = torch.randn(b, c, h, w, generator=g, device="cuda")
            k_ms = cuda_ms(lambda: correlation_cuda(f1, f2,
                                                    max_displacement=MD),
                           200)
            p_ms = cuda_ms(lambda: correlation_plain(
                f1, f2, pad_size=MD, max_displacement=MD), 20)
            bound_ms, bound_by = corr_bound(b, h, w, c, 4)
            rows.append({"level": name, "batch": b, "shape": [h, w, c],
                         "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by})
            log(f"[2] time {name} B={b} f32: kernel {k_ms * 1e3:.2f} us  "
                f"plain {p_ms * 1e3:.2f} us  bound {bound_ms * 1e3:.3f} us "
                f"({bound_by})")
    log(f"[2] max abs error: float32 {worst[torch.float32]:.3e}, "
        f"bfloat16 {worst[torch.bfloat16]:.3e}")
    return worst[torch.float32], rows


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
    log(f"[3] fake weights: {len(sd)} tensors, sum|w| = {checksum!r}")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    return sd


def phase_cli(tmp: str, counter):
    from opticalflow_tpu_torch.cli import script_pwc
    from opticalflow_tpu_torch.io.flo import read_flo
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    sd = fake_reference_checkpoint(ckpt)
    out = os.path.join(tmp, "real_pair_pad.flo")
    before = counter.launches
    rc = script_pwc.main([os.path.join(GOLD, "real_im1.png"),
                          os.path.join(GOLD, "real_im2.png"), out,
                          "--ckpt", ckpt, "--size-mode", "pad",
                          "--preset", "rgb_imagenet", "--flow-scale", "1.0",
                          "--device", "cuda"])
    assert rc == 0, rc
    launched = counter.launches - before
    assert launched == 5, f"one forward must launch the kernel 5 times, " \
                          f"got {launched}"
    flow = read_flo(out)
    golden = read_flo(os.path.join(GOLD, "real_pair_pad.flo"))
    assert flow.shape == golden.shape == (180, 318, 2), flow.shape
    d = epe(flow, golden)
    log(f"[3] CLI pad/rgb_imagenet vs real_pair_pad.flo: mean EPE delta "
        f"{d:.3e} (bound 1e-4, TF32 off); kernel launches {launched}")
    assert d <= 1e-4, f"CLI output off the golden: {d:.3e}"
    return sd


def phase_full_width(sd, counter):
    import numpy as np
    import torch
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet

    engine = FlowEngine(PWCDCNet(), sd, flow_scale=20.0, device="cuda")
    rng = np.random.RandomState(0)
    results = {}
    flows = {}
    for b, n_batches in ((1, 20), (8, 5)):
        im1s = rng.randint(0, 256, (b, FULL_H, FULL_W, 3), np.uint8)
        # frame 2 = frame 1 shifted by (3, 5) px plus noise: coherent motion
        im2s = np.roll(im1s, (3, 5), axis=(1, 2))
        im2s = np.clip(im2s + rng.randint(-8, 9, im2s.shape), 0,
                       255).astype(np.uint8)

        def run():
            return engine.flow_from_pairs(list(im1s), list(im2s),
                                          preset="bgr_unit", size_mode="pad")

        before = counter.launches
        run()                                        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        t0 = time.perf_counter()
        for _ in range(n_batches):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            flow = run()                             # returns host numpy
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
        results[b] = {"pairs_per_s": b * n_batches / wall,
                      "batch_ms_median": lat_ms,
                      "per_pair_ms": lat_ms / b, "peak_mib": peak}
        log(f"[4] FlowEngine pad 436x1024 f32 B={b}: "
            f"{results[b]['pairs_per_s']:.2f} pairs/s, call latency median "
            f"{lat_ms:.3f} ms ({lat_ms / b:.3f} ms/pair, CUDA events around "
            f"flow_from_pairs incl. H2D/D2H), peak {peak:.0f} MiB")
    # the same pair alone and inside a batch of 8 (the last loop's) agree
    d = epe(flows[8][0], engine.flow_from_pair(im1s[0], im2s[0],
                                               preset="bgr_unit",
                                               size_mode="pad"))
    log(f"[4] B=8 row 0 vs B=1 run of the same pair: mean EPE delta {d:.3e}")
    assert d <= 1e-4, d
    return engine, results


def phase_forward_time(engine):
    """Device time of the network forward alone (no host transfers)."""
    import torch
    out = {}
    for b in (1, 8):
        x = torch.rand(b, 6, 448, 1024, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(1))
        with torch.inference_mode():
            out[b] = cuda_ms(lambda: engine.model(x), 10 if b == 8 else 30)
        log(f"[4] forward alone 448x1024 f32 B={b}: {out[b]:.3f} ms "
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

    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    max_err, rows = phase_kernel_vs_plain()

    correlation_cuda.launches = 0            # the main path starts here
    with tempfile.TemporaryDirectory() as tmp:
        sd = phase_cli(tmp, correlation_cuda)
    engine, _ = phase_full_width(sd, correlation_cuda)
    launches = correlation_cuda.launches     # ... and ends here
    assert launches > 0
    phase_forward_time(engine)

    b1 = [r for r in rows if r["batch"] == 1]
    t_bytes = sum(r["bound_ms"] for r in b1 if r["bound_by"] == "bytes")
    kernel = {
        "name": "correlation_fwd", "route": "cuda",
        "source": "opticalflow_tpu_torch/csrc/correlation_fwd.cu",
        "replaces": "opticalflow_tpu/ops/pallas_corr.py:113",
        "also_replaces": "opticalflow_tpu/ops/pallas_corr.py:138",
        "launches": launches, "max_abs_err": max_err,
        # one forward's worth: the 5 levels of a 448x1024 pair, B=1, f32
        "ms": sum(r["ms"] for r in b1),
        "plain_ms": sum(r["plain_ms"] for r in b1),
        "bound_ms": sum(r["bound_ms"] for r in b1),
        "bound_by": ("bytes" if t_bytes >= 0.5 * sum(r["bound_ms"] for r in b1)
                     else "operations"),
        "library_ms": None,
        "per_level": rows,
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
