"""Checkpoint converter: a reference torch ``.pth(.tar)`` ⇄ the port's own
training checkpoint.

Counterpart of ``opticalflow_tpu.cli.convert_ckpt``.  The forward
direction reads any reference checkpoint layout into the port's native
format (``train/checkpoints.save_train_state``: a ``step_0`` directory with
the source and variant as metadata), which ``--pretrained``/``--ckpt`` and
``--resume`` read; ``--to-torch`` writes a port checkpoint (a ``step_N`` or
run directory) back as a reference-loadable ``{"state_dict": ...}``::

    python -m opticalflow_tpu_torch.cli.convert_ckpt pwc_net.pth.tar ckpt_dir
    python -m opticalflow_tpu_torch.cli.convert_ckpt ckpt_dir out.pth.tar --to-torch

An Orbax directory of the JAX package is refused: reading it needs orbax
and JAX, which the GPU machine does not have.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(description="Convert PWC-Net checkpoints "
                                            "(PyTorch port)")
    p.add_argument("src", help="source checkpoint (.pth/.pth.tar, or a "
                               "checkpoint directory of the port)")
    p.add_argument("dst", help="destination (a checkpoint directory, or a "
                               ".pth.tar with --to-torch)")
    p.add_argument("--variant", choices=("new", "old"), default="new")
    p.add_argument("--to-torch", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.train import checkpoints as C

    if os.path.isdir(args.src) and C.latest_step(args.src) is None \
            and not os.path.isfile(os.path.join(args.src, C.STATE_FILE)):
        raise SystemExit(
            f"{args.src!r} is a directory without a checkpoint of the "
            "PyTorch port (an Orbax checkpoint of the JAX package? orbax "
            "and JAX are not on the GPU machine: turn it into a .pth.tar "
            "with the JAX package's convert_ckpt --to-torch where JAX is "
            "installed)")
    params = C.load_params(args.src)
    # strict: a checkpoint of the other variant, or a partial one, fails
    PWCDCNet(variant=args.variant).load_state_dict(params)
    if args.to_torch:
        torch.save({"state_dict": params}, args.dst)
        print(f"wrote torch checkpoint {args.dst} ({len(params)} tensors)")
        return 0
    path = C.save_train_state(args.dst, 0, params,
                              metadata={"source": args.src,
                                        "variant": args.variant})
    print(f"wrote checkpoint {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
