"""KITTI evaluation CLI on the GPU (the ``inference_kitti.py`` equivalent).

Counterpart of ``opticalflow_tpu.cli.infer_kitti`` with the same flags plus
``--device {cuda,cuda:N,cpu}`` (default ``cuda``).  Example::

    python -m opticalflow_tpu_torch.cli.infer_kitti --root /data/kitti2015 \\
        --ckpt ckpt.pth.tar --year 2015 --flow flow_occ --save-dir out/

``--data-parallel N`` shards each evaluation batch over N ranks, one
process per card::

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m opticalflow_tpu_torch.cli.infer_kitti ... --data-parallel 2

(every rank reads the whole dataset and gets every flow; rank 0 writes the
files and prints the summary).  ``--size-mode resize_fixed`` is the v1
script's PIL-bilinear resize to ``--image-size`` (default 384 1280), in
numpy.
"""

from __future__ import annotations

import argparse
import re
import sys


def device_flag(value: str) -> str:
    """``--device``: ``cuda`` (this rank's card), ``cuda:N`` or ``cpu``."""
    if value in ("cuda", "cpu") or re.fullmatch(r"cuda:\d+", value):
        return value
    raise argparse.ArgumentTypeError(
        f"expected cuda, cuda:N or cpu, got {value!r}")


def add_data_parallel_args(p: argparse.ArgumentParser, what: str) -> None:
    """``--data-parallel`` and ``--device``: the flags the eval and serving
    CLIs share."""
    p.add_argument("--data-parallel", default="1", metavar="N|all",
                   help=f"shard {what} over N ranks, one process per card, "
                        "launched by python -m torch.distributed.run "
                        "--nproc-per-node N ('all' = the launched ranks, or "
                        "a one-rank group when nothing was launched); "
                        "default 1 = one process")
    p.add_argument("--device", type=device_flag, default="cuda",
                   metavar="cuda|cuda:N|cpu",
                   help="cuda = this rank's card (its LOCAL_RANK); ranks "
                        "that outnumber the cards share one (cuda:0) over "
                        "gloo")


def data_parallel_mesh(args, command: str):
    """The mesh the ``--data-parallel`` flags ask for, or None; a bad spec
    exits with its message (``command`` is named in the launch hint)."""
    from opticalflow_tpu_torch.parallel.mesh import resolve_data_parallel
    try:
        return resolve_data_parallel(args.data_parallel, device=args.device,
                                     command=command)
    except ValueError as e:
        raise SystemExit(str(e))


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
                        "size (bounds activation memory; mutually exclusive "
                        "with --data-parallel)")
    add_data_parallel_args(p, "each evaluation batch (--batch must divide "
                              "by N)")
    p.add_argument("--limit", type=int, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from opticalflow_tpu_torch.parallel.mesh import check_eval_cli_mesh_args
    mesh = data_parallel_mesh(args, "opticalflow_tpu_torch.cli.infer_kitti")
    check_eval_cli_mesh_args(mesh, args.dispatch_chunk, args.batch)
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.evaluate import evaluate_kitti
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.train.checkpoints import load_params

    engine = FlowEngine(PWCDCNet(variant=args.variant),
                        load_params(args.ckpt), flow_scale=args.flow_scale,
                        device=args.device if mesh is None else None,
                        dispatch_chunk=args.dispatch_chunk, mesh=mesh)
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
