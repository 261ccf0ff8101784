"""Export and parity CLI on the GPU (the ``pth2onnx.py`` +
``onnx_pth_compare.py`` equivalent): export the model as a ``torch.export``
program, run the model and the artifact on the same input, and report the
numerical agreement, with an optional 2×2 comparison image.

Counterpart of ``opticalflow_tpu.cli.parity`` with the same flags (the
artifact defaults to ``model.pt2``) plus ``--device {cuda,cpu}`` (default
``cuda``); ``--shape B H W`` is the JAX CLI's.  The model is the float32
parity model (TF32 off), as the JAX CLI's.  Exits 0 and prints
``PARITY: PASS`` when ``epe_mean <= 0.01``::

    python -m opticalflow_tpu_torch.cli.parity --ckpt pwc_net.pth.tar \\
        --shape 1 448 1024 --report-image parity.png
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(
        description="Export a torch.export artifact and check numerical "
                    "parity (PyTorch/CUDA)")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--artifact", default="model.pt2",
                   help="output/input artifact path")
    p.add_argument("--variant", choices=("new", "old"), default="new")
    p.add_argument("--shape", type=int, nargs=3, default=(1, 256, 256),
                   metavar=("B", "H", "W"))
    p.add_argument("--flow-scale", type=float, default=20.0)
    p.add_argument("--report-image", default=None,
                   help="write the 2x2 comparison figure here (PNG)")
    p.add_argument("--skip-export", action="store_true",
                   help="reuse an existing artifact")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from opticalflow_tpu_torch.engine import resolve_device
    from opticalflow_tpu_torch.export import export_program, parity_check
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.train.checkpoints import load_params

    device = resolve_device(args.device)
    model = PWCDCNet(variant=args.variant)
    model.load_state_dict(load_params(args.ckpt))
    model = model.to(device)
    b, h, w = args.shape
    input_shape = (b, 6, h, w)
    if not args.skip_export:
        path = export_program(model, args.artifact, input_shape=input_shape,
                              flow_scale=args.flow_scale)
        print(f"exported {path}")
    rep = parity_check(model, args.artifact, input_shape=input_shape,
                       flow_scale=args.flow_scale,
                       report_image=args.report_image)
    print(json.dumps(rep, indent=2))
    ok = rep.get("epe_mean", 1.0) <= 0.01
    print("PARITY:", "PASS" if ok else "FAIL", "(epe_mean <= 0.01)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
