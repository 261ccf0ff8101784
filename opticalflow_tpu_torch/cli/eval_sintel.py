"""MPI-Sintel EPE evaluation CLI on the GPU (the README:36 benchmark:
clean 1.83 / final 2.31 with the canonical weights).

Counterpart of ``opticalflow_tpu.cli.eval_sintel`` with the same flags plus
``--device {cuda,cuda:N,cpu}`` (default ``cuda``)::

    python -m opticalflow_tpu_torch.cli.eval_sintel --root /data/sintel \\
        --ckpt pwc_net.pth.tar --render clean

``--data-parallel N`` as in ``cli/infer_kitti``.
"""

from __future__ import annotations

import argparse
import sys

from opticalflow_tpu_torch.cli.infer_kitti import (add_data_parallel_args,
                                                   data_parallel_mesh)


def build_parser():
    p = argparse.ArgumentParser(description="Sintel EPE evaluation "
                                            "(PyTorch/CUDA)")
    p.add_argument("--root", required=True, help="MPI-Sintel root")
    p.add_argument("--render", choices=("clean", "final"), default="clean")
    p.add_argument("--ckpt", required=True,
                   help="reference torch .pth(.tar) checkpoint")
    p.add_argument("--variant", choices=("new", "old"), default="new")
    p.add_argument("--preset", default="bgr_unit")
    p.add_argument("--flow-scale", type=float, default=20.0)
    p.add_argument("--save-dir", default=None,
                   help="optionally dump predicted flows as .flo files")
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
    mesh = data_parallel_mesh(args, "opticalflow_tpu_torch.cli.eval_sintel")
    check_eval_cli_mesh_args(mesh, args.dispatch_chunk, args.batch)
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.evaluate import evaluate_sintel
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.train.checkpoints import load_params

    engine = FlowEngine(PWCDCNet(variant=args.variant),
                        load_params(args.ckpt), flow_scale=args.flow_scale,
                        device=args.device if mesh is None else None,
                        dispatch_chunk=args.dispatch_chunk, mesh=mesh)
    res = evaluate_sintel(engine, args.root, render=args.render,
                          preset=args.preset, batch=args.batch,
                          save_dir=args.save_dir, limit=args.limit)
    return 0 if res["num_pairs"] else 1


if __name__ == "__main__":
    sys.exit(main())
