"""Canonical single-pair CLI on the GPU: image pair in → Middlebury ``.flo``.

Counterpart of ``opticalflow_tpu.cli.script_pwc`` with the reference's
public contract (``script_pwc.py:30-83``): positional im1, im2, out with
the reference's defaults; distorting resize to ceil(/64)·64, BGR, /255;
model output ×20 resized back with u·W/W64, v·H/H64; ``.flo`` with tag
202021.25.  ``--device`` picks ``cuda`` (the default) or ``cpu``.

    python -m opticalflow_tpu_torch.cli.script_pwc im1.png im2.png out.flo \\
        --ckpt pwc_net.pth.tar --device cuda
"""

from __future__ import annotations

import argparse
import os
import sys

from opticalflow_tpu_torch.io.flo import write_flo
from opticalflow_tpu_torch.io.images import load_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PWC-Net optical flow: frame pair -> .flo (PyTorch/CUDA)")
    p.add_argument("im1", nargs="?", default="data/frame_0010.png")
    p.add_argument("im2", nargs="?", default="data/frame_0011.png")
    p.add_argument("out", nargs="?", default="./tmp/frame_0010.flo")
    p.add_argument("--ckpt", default="./pwc_net.pth.tar",
                   help="reference torch .pth(.tar) checkpoint to load")
    p.add_argument("--variant", choices=("new", "old"), default="new")
    p.add_argument("--preset", default="bgr_unit",
                   help="preprocessing preset (bgr_unit for canonical weights)")
    p.add_argument("--flow-scale", type=float, default=20.0)
    p.add_argument("--size-mode", choices=("resize", "pad"), default="resize")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.train.checkpoints import load_params

    model = PWCDCNet(variant=args.variant,
                     dtype=torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    engine = FlowEngine(model, load_params(args.ckpt),
                        flow_scale=args.flow_scale, device=args.device)
    im1 = load_image(args.im1)
    im2 = load_image(args.im2)
    flow = engine.flow_from_pair(im1, im2, preset=args.preset,
                                 size_mode=args.size_mode)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    write_flo(args.out, flow)
    print(f"wrote {args.out}  ({flow.shape[0]}x{flow.shape[1]}, "
          f"|flow| max {abs(flow).max():.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
