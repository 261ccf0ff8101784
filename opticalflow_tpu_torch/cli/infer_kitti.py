"""KITTI evaluation CLI on the GPU (the ``inference_kitti.py`` equivalent).

Counterpart of ``opticalflow_tpu.cli.infer_kitti`` with the same flags plus
``--device {cuda,cpu}`` (default ``cuda``).  Example::

    python -m opticalflow_tpu_torch.cli.infer_kitti --root /data/kitti2015 \\
        --ckpt ckpt.pth.tar --year 2015 --flow flow_occ --save-dir out/

``--data-parallel`` takes only 1 (multi-GPU evaluation is ROADMAP Queue 1
item 6).  ``--size-mode resize_fixed`` is the v1 script's PIL-bilinear
resize to ``--image-size`` (default 384 1280), in numpy.
"""

from __future__ import annotations

import argparse
import sys


def check_data_parallel(value: str) -> None:
    """One card only: multi-GPU evaluation is not ported yet."""
    if str(value) != "1":
        raise SystemExit(
            f"--data-parallel {value}: the PyTorch port evaluates on one "
            "GPU; multi-GPU runs are ROADMAP Queue 1 item 6")


def build_parser():
    p = argparse.ArgumentParser(description="KITTI flow evaluation "
                                            "(PyTorch/CUDA)")
    p.add_argument("--root", required=True, help="KITTI dataset root")
    p.add_argument("--ckpt", required=True,
                   help="reference torch .pth(.tar) checkpoint")
    p.add_argument("--year", type=int, choices=(2012, 2015), default=2015)
    p.add_argument("--flow", dest="flow_kind", default="flow_occ",
                   choices=("flow_occ", "flow_noc"))
    p.add_argument("--variant", choices=("new", "old"), default="new")
    p.add_argument("--preset", default="rgb_imagenet",
                   help="rgb_imagenet matches the repo's fine-tuned ckpts; "
                        "bgr_unit for the canonical weights")
    p.add_argument("--flow-scale", type=float, default=1.0,
                   help="1.0 for GT-space checkpoints, 20.0 for canonical")
    p.add_argument("--size-mode", default="pad",
                   choices=("pad", "pad_ref", "resize", "resize_fixed"),
                   help="pad = corrected v2 pipeline (default); pad_ref = "
                        "the reference's exact inference_kitti.py order; "
                        "resize_fixed = the v1 script's PIL resize to "
                        "--image-size")
    p.add_argument("--image-size", type=int, nargs=2, metavar=("H", "W"),
                   default=None,
                   help="fixed /64 input size for --size-mode resize_fixed")
    p.add_argument("--save-dir", default=None,
                   help="optionally dump predicted flows as KITTI PNGs")
    p.add_argument("--batch", type=int, default=8,
                   help="pairs per batched forward")
    p.add_argument("--dispatch-chunk", type=int, default=None,
                   help="run each batch as consecutive forwards of this "
                        "size (bounds activation memory)")
    p.add_argument("--data-parallel", default="1", metavar="1",
                   help="cards per batch; the port takes only 1")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--limit", type=int, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_data_parallel(args.data_parallel)
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.evaluate import evaluate_kitti
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.train.checkpoints import load_params

    engine = FlowEngine(PWCDCNet(variant=args.variant),
                        load_params(args.ckpt), flow_scale=args.flow_scale,
                        device=args.device,
                        dispatch_chunk=args.dispatch_chunk)
    if args.size_mode == "resize_fixed" and args.image_size is None:
        args.image_size = [384, 1280]   # the v1 script's default
    res = evaluate_kitti(engine, args.root, year=args.year,
                         flow_kind=args.flow_kind, preset=args.preset,
                         size_mode=args.size_mode,
                         image_size=args.image_size,
                         batch=args.batch, save_dir=args.save_dir,
                         limit=args.limit)
    return 0 if res["num_pairs"] else 1


if __name__ == "__main__":
    sys.exit(main())
