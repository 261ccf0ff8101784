"""Fused warp⊕correlation against the composed path on the card.

Counterpart of the JAX package's ``scripts/probe_fused_warpcorr.py``.  Every
warp in the model feeds a correlation (``models/pwcnet.py``, levels 2-5),
so the question is whether computing the masked bilinear warp inside the
correlation kernel (``ops/fused_warpcorr.py``, the warped tensor never in
device memory) beats the composed path: ``warp_with_mask`` (grid_sample)
then the correlation kernel.

    python -m opticalflow_tpu_torch.scripts.probe_fused_warpcorr [B [H W C]] \\
        [--device cuda|cpu]

First it checks the fused function against the composed one at 2×16×32×8
with flows of ×2 px.  On the card it then times both by CUDA events, with
the flow perturbed per iteration as the JAX probe does, in float32 and
bfloat16: at B H W C if given, else at levels 2-5 of a 448×1024 frame
(112×256×32, 56×128×64, 28×64×96, 14×32×128) at B=1 and B=8; beside each,
the plan the kernel chose (tile, grid, channel split), whether two runs
gave the same bits, the host's time to issue one call and the card's time
alone (the calls queued behind a spin kernel, so the host cannot hold the
card back).  The flows are noise of ×3 px, every pixel its own, which
scatters the gather's reads; the card-alone times are also taken with
noise of ×20 px and with a smooth flow (noise of ×3 px at an eighth of the
size, enlarged bilinearly, as a flow estimate is).  With ``--device cpu``
the check runs the plain version and timing is skipped.
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from opticalflow_tpu_torch.engine import resolve_device
from opticalflow_tpu_torch.ops.correlation import correlation
from opticalflow_tpu_torch.ops.fused_warpcorr import (MD, fused_warp_corr,
                                                      fused_warp_corr_plain,
                                                      launch_plan)
from opticalflow_tpu_torch.ops.warp import warp_with_mask
from opticalflow_tpu_torch.scripts._timing import (BF16_FLOPS_PER_S,
                                                   FP32_FLOPS_PER_S, bound,
                                                   cuda_ms, device_ms,
                                                   host_ms)

__all__ = ["composed", "fused_bound", "main", "LEVELS"]

ND2 = (2 * MD + 1) ** 2
# (name, H, W, C) of the warped levels of a 448x1024 frame
LEVELS = (("L2", 112, 256, 32), ("L3", 56, 128, 64), ("L4", 28, 64, 96),
          ("L5", 14, 32, 128))


def composed(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
             mask_threshold: float = 0.9999) -> torch.Tensor:
    """The model's path (``models/pwcnet.py``): warp, cast to the feature
    dtype, correlation (the kernel on a CUDA tensor)."""
    warped = warp_with_mask(f2, flow, mask_threshold=mask_threshold)
    return correlation(f1, warped.to(f1.dtype).contiguous(), pad_size=MD,
                       max_displacement=MD)


def fused_bound(b: int, h: int, w: int, c: int, dtype: torch.dtype):
    """Least time of one fused call on features of ``dtype``: f1, f2 and
    the float32 flow read once, 81 maps written once, against
    2·81·C·H·W + 8·C·H·W flops (correlation FMAs and the four-corner
    weighted sum) per image, at the tensor cores' rate for bfloat16
    operands and the float32 rate otherwise."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * c + ND2) * b * h * w * itemsize + 2 * 4 * b * h * w
    flops = (2.0 * ND2 + 8.0) * b * c * h * w
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    return bound(nbytes, flops, rate)


def _nchw(a: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2))).to(device=device, dtype=dtype)


def _time_shape(b, h, w, c, dtype, device, rng) -> dict:
    f1 = _nchw(rng.randn(b, h, w, c).astype(np.float32), device, dtype)
    f2 = _nchw(rng.randn(b, h, w, c).astype(np.float32), device, dtype)
    flow = _nchw((rng.randn(b, h, w, 2) * 3).astype(np.float32), device)
    first = fused_warp_corr(f1, f2, flow)
    same_bits = torch.equal(first, fused_warp_corr(f1, f2, flow))
    err = float((first.float() - composed(f1, f2, flow).float()).abs().max())
    iters = 50
    # the flow perturbed per iteration, as the JAX probe does; made before
    # the timed loop, so only the functions are timed
    flows = [flow + i * 1e-6 for i in range(iters)]

    def fused(i):
        return fused_warp_corr(f1, f2, flows[i % iters])

    def comp(i):
        return composed(f1, f2, flows[i % iters])

    # other flows, card alone: noise of x20 px, and a smooth field
    coarse = _nchw((rng.randn(b, max(h // 8, 2), max(w // 8, 2), 2)
                    * 3).astype(np.float32), device)
    others = {"x20": flow * (20.0 / 3.0),
              "smooth": F.interpolate(coarse, size=(h, w), mode="bilinear",
                                      align_corners=True).contiguous()}
    extra = {}
    for name, fl in others.items():
        extra[f"fused_device_ms_{name}"] = device_ms(
            lambda _: fused_warp_corr(f1, f2, fl), 30)
        extra[f"composed_device_ms_{name}"] = device_ms(
            lambda _: composed(f1, f2, fl), 30)

    b_ms, b_by = fused_bound(b, h, w, c, dtype)
    return {"shape": [h, w, c], "batch": b, "dtype": str(dtype)[6:],
            "plan": launch_plan(b, c, h, w, dtype,
                                device_index=device.index or 0),
            "same_bits": same_bits,
            "fused_ms": cuda_ms(fused, iters),
            "composed_ms": cuda_ms(comp, iters),
            "plain_ms": cuda_ms(lambda i: fused_warp_corr_plain(
                f1, f2, flows[i]), 5, warmup=1),
            "fused_host_ms": host_ms(fused, iters),
            "composed_host_ms": host_ms(comp, iters),
            "fused_device_ms": device_ms(fused, 30),
            "composed_device_ms": device_ms(comp, 30),
            **extra,
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err_vs_composed": err}


def main(argv=None) -> List[dict]:
    """Runs the probe; returns the timing rows (none on the CPU)."""
    p = argparse.ArgumentParser(
        description="fused warp+correlation vs warp_with_mask -> correlation")
    p.add_argument("bhwc", nargs="*", type=int, metavar="B [H W C]")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if len(args.bhwc) not in (0, 1, 4):
        p.error("give B, or B H W C, or nothing")
    device = resolve_device(args.device)
    rng = np.random.RandomState(0)

    # correctness at the JAX probe's small shape (flows of x2 px)
    fs, gs, hs, cs = 2, 16, 32, 8
    tf1 = _nchw(rng.randn(fs, gs, hs, cs).astype(np.float32), device)
    tf2 = _nchw(rng.randn(fs, gs, hs, cs).astype(np.float32), device)
    tfl = _nchw((rng.randn(fs, gs, hs, 2) * 2).astype(np.float32), device)
    with torch.inference_mode():
        err = float((fused_warp_corr(tf1, tf2, tfl)
                     - composed(tf1, tf2, tfl)).abs().max())
    print(f"correctness vs composed (2x16x32x8 f32, {device.type}): max abs "
          f"err {err:.2e}", flush=True)
    if not err < 1e-4:
        raise AssertionError(f"fused disagrees with composed: {err:.3e}")
    if device.type != "cuda":
        print("not on the GPU — timing skipped (the plain version ran)")
        return []

    if len(args.bhwc) == 4:
        shapes = [tuple(args.bhwc)]
    else:
        batches = args.bhwc or [1, 8]
        shapes = [(b, h, w, c) for b in batches for _, h, w, c in LEVELS]
    rows = []
    with torch.inference_mode():
        for b, h, w, c in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                r = _time_shape(b, h, w, c, dtype, device, rng)
                rows.append(r)
                if not r["same_bits"]:
                    raise AssertionError(f"two runs differ at B={b} "
                                         f"{h}x{w}x{c} {r['dtype']}")
                plan = r["plan"]
                print(f"B={b} {h}x{w}x{c} {r['dtype']:8s} tile "
                      f"{plan['tile'][0]}x{plan['tile'][1]} grid "
                      f"{plan['grid']} split {plan['split']} "
                      f"({plan['channels_per_split']} ch)  two runs "
                      f"bit-equal  card alone: fused "
                      f"{r['fused_device_ms'] * 1e3:.2f} us, composed "
                      f"{r['composed_device_ms'] * 1e3:.2f} us "
                      f"({r['composed_device_ms'] / r['fused_device_ms']:.2f}"
                      f"x); flows x20 px {r['fused_device_ms_x20'] * 1e3:.2f}"
                      f" / {r['composed_device_ms_x20'] * 1e3:.2f}; smooth "
                      f"{r['fused_device_ms_smooth'] * 1e3:.2f} / "
                      f"{r['composed_device_ms_smooth'] * 1e3:.2f}  events: "
                      f"fused {r['fused_ms'] * 1e3:.2f} us, composed "
                      f"{r['composed_ms'] * 1e3:.2f} us "
                      f"({r['composed_ms'] / r['fused_ms']:.2f}x)  host to "
                      f"issue: fused {r['fused_host_ms'] * 1e3:.1f} us, "
                      f"composed {r['composed_host_ms'] * 1e3:.1f} us  bound "
                      f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})  "
                      f"plain {r['plain_ms'] * 1e3:.1f} us  "
                      f"max|fused-composed| "
                      f"{r['max_abs_err_vs_composed']:.2e}", flush=True)
    return rows


if __name__ == "__main__":
    main()
