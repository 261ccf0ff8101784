"""Where a forward's (or a train step's) device time goes, profiled on the GPU.

    python -m opticalflow_tpu_torch.cli.profile_forward --batch 1 \\
        [--height 448 --width 1024 --dtype float32 --precision highest] \\
        [--train] [--trace forward_trace.json]

Random weights from a seed (timing does not depend on their values).  After
warm-up, ``torch.profiler`` records ``--iters`` forwards, or with
``--train`` as many train steps (``train.trainer``: the multiscale loss,
AdamW, clip 1.0, a random batch already on the card); the script prints
the device time by kernel group and by kernel, the wall time per call, and
the summed kernel time over the wall time (below 1: the device idles,
waiting on the host; above 1: kernels overlap on several streams).  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

# kernel-name substrings → group, first match wins
_GROUPS = (("correlation (hand-written)", ("corr_fwd",)),
           ("correlation backward (hand-written)", ("corr_bwd",)),
           ("optimizer (foreach AdamW)", ("multi_tensor_apply",)),
           ("warp (grid_sample)", ("grid_sampler",)),
           # cuDNN's convolutions, including the pieces of its FFT
           # algorithm (complex GEMVs, transforms) and its layout transposes
           ("convolution", ("conv", "cudnn", "xmma", "gemm", "gemv", "sm80_",
                            "sm90_", "implicit", "winograd", "dgrad", "wgrad",
                            "fft", "region_transform", "complex",
                            "nchwtonhwc", "nhwctonchw", "tensortransform")),
           ("concat", ("cat",)),
           ("resize / interpolate", ("upsample", "interpolate")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise / other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--height", type=int, default=448)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32")
    p.add_argument("--precision", choices=("highest", "fast"),
                   default="highest")
    p.add_argument("--train", action="store_true",
                   help="profile train steps instead of forwards")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--trace", default=None,
                   help="also write a Chrome trace to this path")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet

    if not torch.cuda.is_available():
        raise RuntimeError("profile_forward needs a CUDA device")
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = PWCDCNet(dtype=dtype, precision=args.precision,
                     generator=torch.Generator().manual_seed(0))
    model = model.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, w = args.batch, args.height, args.width
    if args.train:
        from opticalflow_tpu_torch.train import trainer as T
        cfg = T.TrainConfig(loss="multiscale")
        state, opt = T.create_train_state(model, cfg)
        step = T.make_train_step(model, opt, cfg)
        batch = {"images": torch.rand(b, h, w, 6, device=dev, generator=gen),
                 "flow": torch.randn(b, h, w, 2, device=dev, generator=gen),
                 "valid": torch.ones(b, h, w, device=dev)}
        call, scope, what = (lambda: step(state, batch), torch.enable_grad,
                             "train step")
    else:
        x = torch.rand(b, 6, h, w, device=dev, generator=gen)
        call, scope, what = (lambda: model(x), torch.inference_mode,
                             "forward")
    with scope():
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                call()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # kernels and copies only: a user annotation (the optimizer's step
    # region) spans kernels that are counted already
    kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA") and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    total = sum(us for _, us, _ in kernels)
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")
    groups = {}
    for name, us, _ in kernels:
        groups[_group(name)] = groups.get(_group(name), 0.0) + us
    n = args.iters
    print(f"{torch.cuda.get_device_name(0)}: {what} {args.batch}x"
          f"{args.height}x{args.width} {args.dtype}/{args.precision}, "
          f"{n} iters: wall {wall_us / n / 1e3:.3f} ms/{what}, device "
          f"{total / n / 1e3:.3f} ms/{what}, kernel-time/wall "
          f"{total / wall_us:.3f}")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:28s} {us / n / 1e3:8.3f} ms  {us / total:6.1%}")
    print(f"  top kernels (device ms per {what}, launches per {what}):")
    for name, us, count in sorted(kernels, key=lambda k: -k[1])[:args.top]:
        print(f"    {us / n / 1e3:8.3f}  {count / n:5.1f}  {name[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
