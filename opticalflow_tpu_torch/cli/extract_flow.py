"""Single-pair flow extractor with visual outputs on the GPU (the
``pwc_extract_flow.py`` equivalent).

Counterpart of ``opticalflow_tpu.cli.extract_flow`` with the same flags
plus ``--device`` (default ``cuda``) and ``--dtype`` (default ``float32``,
the precision the JAX extractor runs in; ``bfloat16`` is the fast mode):
pad to /64, infer, and write ``<stem>.flo``, ``<stem>_flow.npy``, the Middlebury
colour-wheel ``<stem>_color.png`` (the port's PNG encoder) and, where
matplotlib is installed, the quiver figure ``<stem>_quiver.png``::

    python -m opticalflow_tpu_torch.cli.extract_flow im1.png im2.png \\
        --ckpt pwc_net.pth.tar --out-dir flow_out
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(
        description="Extract flow for one frame pair with visualizations "
                    "(PyTorch/CUDA)")
    p.add_argument("im1", help="first frame: PNG or JPEG (read by the port's "
                               "own decoders), or another format imageio or "
                               "PIL reads")
    p.add_argument("im2", help="second frame, as im1")
    p.add_argument("--out-dir", default="flow_out")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--variant", choices=("new", "old"), default="new")
    p.add_argument("--preset", default="rgb_unit",
                   help="the reference extractor feeds RGB /255 "
                        "(pwc_extract_flow.py:141-180)")
    p.add_argument("--flow-scale", type=float, default=1.0)
    p.add_argument("--step", type=int, default=16)
    p.add_argument("--quiver-scale", type=float, default=1.0)
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def build_model(variant: str, dtype: str):
    """PWCDCNet in the CLI's numeric mode: float32 parity mode, or bf16
    with TF32 ("fast"), as the JAX video CLIs pair them."""
    import torch
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    if dtype == "bfloat16":
        return PWCDCNet(variant=variant, dtype=torch.bfloat16,
                        precision="fast")
    return PWCDCNet(variant=variant)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io.flo import write_flo
    from opticalflow_tpu_torch.io.images import encode_png, load_image
    from opticalflow_tpu_torch.runtime.flowviz import flow_to_color_native
    from opticalflow_tpu_torch.train.checkpoints import load_params
    from opticalflow_tpu_torch.viz.overlay import quiver_figure

    engine = FlowEngine(build_model(args.variant, args.dtype),
                        load_params(args.ckpt), flow_scale=args.flow_scale,
                        device=args.device)
    im1 = load_image(args.im1)
    im2 = load_image(args.im2)
    flow = engine.flow_from_pair(im1, im2, preset=args.preset,
                                 size_mode="pad")

    os.makedirs(args.out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.im1))[0]
    np.save(os.path.join(args.out_dir, f"{stem}_flow.npy"), flow)
    write_flo(os.path.join(args.out_dir, f"{stem}.flo"), flow)
    with open(os.path.join(args.out_dir, f"{stem}_color.png"), "wb") as f:
        f.write(encode_png(flow_to_color_native(flow)))
    outs = ".flo,_flow.npy,_color.png"
    try:
        quiver_figure(im1, flow,
                      os.path.join(args.out_dir, f"{stem}_quiver.png"),
                      step=args.step, scale=args.quiver_scale)
        outs += ",_quiver.png"
    except ImportError as e:
        print(f"note: no _quiver.png: {e}", file=sys.stderr)
    print(f"wrote {args.out_dir}/{stem}{{{outs}}}  |flow| max "
          f"{abs(flow).max():.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
