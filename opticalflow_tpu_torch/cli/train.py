"""Training CLI on the GPU covering all four reference regimes.

  --regime charbonnier : supervised KITTI fine-tune, full-res masked
                         Charbonnier (``train.py``)
  --regime multiscale  : supervised multiscale loss + AdamW + grad clip
                         (``train2.py``)
  --regime pseudo      : self-supervised proxy-label (SSIM+L1 photometric +
                         smoothness) on consecutive frames (``train_pseudo.py``)
  --regime epipolar    : pseudo + per-sample epipolar inlier masking /
                         optional Sampson penalty (``train_fundamental.py``)

Counterpart of ``opticalflow_tpu.cli.train`` with the same flags and
defaults plus ``--device {cuda,cpu}`` (default ``cuda``)::

    python -m opticalflow_tpu_torch.cli.train --regime multiscale \\
        --data-root KITTI/training --pretrained pwc_net.pth.tar

One card: the batch is the card's; ``--distributed`` and the ``--dist-*``
flags raise (multi-GPU training is ROADMAP Queue 1 item 6).  The loader
prefetches batches onto the card; checkpoints are the port's torch format
(``train/checkpoints.py``) with the loader's position, the best validation
metric and the plateau's count, so ``--resume`` continues where a run
stopped, mid-epoch after a SIGTERM: the run finishes its step (and, on an
epoch's last batch, the epoch's validation), saves, and exits 0.  Metrics
go to ``<out-dir>/metrics.jsonl`` (and TensorBoard events with
``--tensorboard`` where tensorboardX is installed), the loss curve to
``loss_curve.png`` where matplotlib is.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description="PWC-Net training (PyTorch/CUDA)")
    p.add_argument("--regime", default="multiscale",
                   choices=("charbonnier", "multiscale", "pseudo", "epipolar"))
    p.add_argument("--data-root", required=True,
                   help="KITTI training root (supervised) or a directory of "
                        "frames (self-supervised)")
    p.add_argument("--list-file", default=None)
    p.add_argument("--out-dir", default="runs/default")
    p.add_argument("--pretrained", default=None,
                   help="torch .pth(.tar) file or a checkpoint directory of "
                        "this port to start from")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--val-frac", type=float, default=0.0,
                   help="held-out fraction for per-epoch validation "
                        "(best-by-metric checkpointing, train2.py style)")
    p.add_argument("--plateau-factor", type=float, default=0.0,
                   help="ReduceLROnPlateau factor (0 disables; train2 "
                        "used the torch default 0.1)")
    p.add_argument("--plateau-patience", type=int, default=3)
    p.add_argument("--crop", type=int, nargs=2, default=(320, 896))
    p.add_argument("--size", type=int, nargs=2, default=(384, 512),
                   help="frame size for self-supervised regimes")
    p.add_argument("--flow-scale", type=float, default=1.0)
    p.add_argument("--lambda-photo", type=float, default=0.0)
    p.add_argument("--lambda-smooth", type=float, default=0.0)
    p.add_argument("--epi-tau", type=float, default=1.0)
    p.add_argument("--epi-stride", type=int, default=6)
    p.add_argument("--epi-soft-w", type=float, default=0.1)
    p.add_argument("--variant", choices=("new", "old"), default="new")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 network compute (f32 flow heads/optimizer)")
    p.add_argument("--grad-accum", type=int, default=1, metavar="K",
                   help="split each batch into K micro-batches, average "
                        "grads, one optimizer update: K× effective batch at "
                        "the activation memory of batch/K")
    p.add_argument("--remat", nargs="?", const="full", default="off",
                   choices=("off", "full", "l2"),
                   help="recompute activations in the backward: 'l2' only "
                        "the level-2 estimator and the context network "
                        "(the largest activations), 'full' the whole "
                        "forward. Bare --remat = full")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training: not ported (one card)")
    p.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--dist-num-processes", type=int, default=None)
    p.add_argument("--dist-process-id", type=int, default=None)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--save-every", type=int, default=1, metavar="EPOCHS")
    p.add_argument("--log-every", type=int, default=10, metavar="STEPS")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write train/val scalars as TensorBoard events "
                        "under <out-dir>/tb (JSONL metrics are always "
                        "written)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def _make_dataset(args):
    if args.regime in ("charbonnier", "multiscale"):
        from opticalflow_tpu_torch.data.datasets import KittiFlowTrain
        return KittiFlowTrain(args.data_root, list_file=args.list_file,
                              crop_hw=tuple(args.crop), seed=args.seed)
    from opticalflow_tpu_torch.data.datasets import ConsecutiveFrames
    return ConsecutiveFrames(args.data_root, size_hw=tuple(args.size))


def _check_one_card(args) -> None:
    if (args.distributed or args.dist_coordinator
            or args.dist_num_processes is not None
            or args.dist_process_id is not None):
        raise SystemExit(
            "--distributed / --dist-*: the PyTorch port trains on one GPU; "
            "multi-GPU training is ROADMAP Queue 1 item 6")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _check_one_card(args)
    import signal
    import threading

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to train on the CPU)")
    device = torch.device(args.device)

    from opticalflow_tpu_torch.data.loader import Loader, train_val_split
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.train import checkpoints as ckpt
    from opticalflow_tpu_torch.train.trainer import (PlateauController,
                                                     TrainConfig,
                                                     create_train_state,
                                                     make_eval_metrics_step,
                                                     make_train_step)

    regime_to_loss = {"charbonnier": "charbonnier_full",
                      "multiscale": "multiscale", "pseudo": "proxy",
                      "epipolar": "proxy_epipolar"}
    cfg = TrainConfig(
        loss=regime_to_loss[args.regime],
        optimizer="adam" if args.regime != "multiscale" else "adamw",
        lr=args.lr, weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        plateau_factor=args.plateau_factor,
        plateau_patience=args.plateau_patience,
        lambda_photo=args.lambda_photo, lambda_smooth=args.lambda_smooth,
        epi_soft_weight=args.epi_soft_w if args.regime == "epipolar" else 0.0,
        flow_scale=args.flow_scale,
        remat={"off": False, "full": True, "l2": "l2"}[args.remat],
        grad_accum=args.grad_accum)

    gen = torch.Generator().manual_seed(args.seed)
    model = PWCDCNet(variant=args.variant,
                     dtype=torch.bfloat16 if args.bf16 else torch.float32,
                     precision="fast", generator=gen).to(device)
    params = ckpt.load_params(args.pretrained) if args.pretrained else None
    state, opt = create_train_state(model, cfg, params=params)
    print(f"device: {device} | regime: {args.regime}")

    ds = _make_dataset(args)
    val_loader = None
    if args.val_frac > 0:
        ds, val_ds = train_val_split(ds, args.val_frac, seed=args.seed)
        if val_ds is not None:
            # keep every val sample: no shuffling, no drop_last, and a batch
            # no larger than the split itself
            val_loader = Loader(val_ds, min(args.batch, len(val_ds)),
                                shuffle=False, drop_last=False,
                                num_workers=args.workers, seed=args.seed,
                                device=device)
    loader = Loader(ds, args.batch, num_workers=args.workers,
                    seed=args.seed, device=device)

    start_epoch = 0
    best_metric = float("inf")
    plateau = PlateauController(cfg)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.resume and ckpt.latest_step(args.out_dir) is not None:
        restored = ckpt.restore_train_state(args.out_dir)
        model.load_state_dict(restored["params"])
        if "opt_state" in restored:
            opt.load_state_dict(restored["opt_state"])
        state.step = int(restored["step"])
        meta = restored.get("metadata", {})
        # a preemption save is mid-epoch: re-enter the SAME epoch and let
        # the loader skip to the saved batch offset
        start_epoch = int(meta.get("epoch", 0)) \
            + (0 if meta.get("mid_epoch") else 1)
        if "loader" in meta:
            loader.restore(json.loads(meta["loader"]))
        # the validation's best and the plateau's count carry on, so a
        # resumed run saves best/ and cuts the learning rate where an
        # uninterrupted run would
        best_metric = float(meta.get("best_metric", best_metric))
        plateau.best = float(meta.get("plateau_best", plateau.best))
        plateau.bad_epochs = int(meta.get("plateau_bad_epochs", 0))
        print(f"resumed from step {state.step} (epoch {start_epoch}"
              + (f", batch {loader.state()['batch']}"
                 if meta.get("mid_epoch") else "") + ")")

    def save(directory, metadata):
        return ckpt.save_train_state(directory, state.step,
                                     model.state_dict(), opt.state_dict(),
                                     metadata=metadata)

    def save_progress(epoch, mid_epoch):
        return save(args.out_dir, {
            "epoch": epoch, "regime": args.regime, "mid_epoch": mid_epoch,
            "loader": json.dumps(loader.state()),
            "best_metric": best_metric, "plateau_best": plateau.best,
            "plateau_bad_epochs": plateau.bad_epochs})

    step_fn = make_train_step(model, opt, cfg)
    eval_fn = make_eval_metrics_step(model, cfg) if val_loader else None
    log_path = os.path.join(args.out_dir, "metrics.jsonl")

    # Preemption: a SIGTERM (a managed machine's notice before eviction)
    # is flagged; the in-flight step finishes, a resumable checkpoint with
    # the loader's position is saved, and the run exits 0.  On the epoch's
    # last batch the epoch is finished first (its validation and save).
    preempt = threading.Event()
    try:
        old_handler = signal.signal(signal.SIGTERM,
                                    lambda s, f: preempt.set())
    except ValueError:      # not on the main thread (library/test use)
        old_handler = None
    tb = _open_tensorboard(args)
    # close (flush) the tb writer and put the signal handler back on every
    # exit path: normal return, preemption, and loader/step exceptions
    try:
        history = []
        for epoch in range(start_epoch, args.epochs):
            loader.epoch = epoch
            # >0 only on a mid-epoch (preemption) resume; __iter__ consumes it
            skip = loader.state()["batch"]
            t0 = time.perf_counter()
            epoch_loss, nsteps = 0.0, 0
            for batch in loader:
                if args.regime == "epipolar":
                    batch = _attach_epipolar(model, state.step, batch, args)
                state, metrics = step_fn(state, batch)
                nsteps += 1
                loss = float(metrics["loss"])
                epoch_loss += loss
                if nsteps % args.log_every == 0:
                    rec = {"epoch": epoch, "step": state.step,
                           **{k: float(v) for k, v in metrics.items()}}
                    with open(log_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                    if tb:
                        tb.scalars("train", metrics, state.step)
                    print(f"e{epoch} s{state.step} "
                          + " ".join(f"{k}={float(v):.4f}"
                                     for k, v in metrics.items()))
                if preempt.is_set():
                    break
            if preempt.is_set():
                done = skip + nsteps
                if done < len(loader):
                    path = save_progress(epoch, mid_epoch=True)
                    print(f"preempted: saved {path} (epoch {epoch}, "
                          f"batch {done}/{len(loader)})")
                    return 0
                # the epoch's last batch ran: the loop left the loader
                # before it closed the epoch, so close it here, then
                # validate and save as at any epoch's end
                loader.restore({"epoch": epoch + 1, "batch": 0,
                                "seed": loader.seed})
            dt = time.perf_counter() - t0
            if nsteps:   # a zero-step epoch has no meaningful loss to log
                mean_loss = epoch_loss / nsteps
                ips = nsteps * args.batch / max(dt, 1e-9)
                print(f"epoch {epoch}: loss={mean_loss:.4f} "
                      f"({ips:.1f} samples/s, {dt:.1f}s)")
                if tb:
                    tb.scalars("epoch", {"loss": mean_loss,
                                         "samples_per_sec": ips}, epoch)
                history.append((epoch, mean_loss))

            vals = []
            if val_loader is not None:
                # the held-out samples are drawn per (seed, epoch, idx): key
                # them to the training epoch, not to this process's count of
                # passes, so a resumed run validates on the same samples
                val_loader.epoch = epoch
            for vbatch in val_loader if val_loader is not None else ():
                if args.regime == "epipolar":
                    vbatch = _attach_epipolar(model, state.step, vbatch,
                                              args)
                vm = eval_fn(vbatch)
                vals.append(({k: float(v) for k, v in vm.items()},
                             vbatch["images"].shape[0]))
            if vals:
                total = sum(n for _, n in vals)   # sample-weighted, not
                agg = {k: sum(v[k] * n for v, n in vals) / total  # batch-mean
                       for k in vals[0][0]}
                key_metric = agg.get("epe", agg["loss"])
                print("val: " + " ".join(f"{k}={v:.4f}"
                                         for k, v in agg.items()))
                if tb:
                    tb.scalars("val", agg, epoch)
                with open(log_path, "a") as f:
                    f.write(json.dumps({"epoch": epoch, "val": agg}) + "\n")
                state = plateau.step(state, key_metric)
                if key_metric < best_metric:
                    best_metric = key_metric
                    path = save(os.path.join(args.out_dir, "best"),
                                {"epoch": epoch, "metric": key_metric,
                                 "regime": args.regime})
                    print(f"best model saved ({key_metric:.4f}) -> {path}")

            if ((epoch + 1) % args.save_every == 0
                    or epoch == args.epochs - 1 or preempt.is_set()):
                path = save_progress(epoch, mid_epoch=False)
                print(f"saved {path}")
            if preempt.is_set():
                print(f"preempted after epoch {epoch}")
                return 0
        _plot_history(history, os.path.join(args.out_dir, "loss_curve.png"))
    finally:
        if tb:
            tb.close()
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
    return 0


class _TBWriter:
    """Thin tensorboardX scalar writer."""

    def __init__(self, logdir):
        from tensorboardX import SummaryWriter  # optional dependency
        self._w = SummaryWriter(logdir)

    def scalars(self, prefix, metrics, step):
        for k, v in metrics.items():
            self._w.add_scalar(f"{prefix}/{k}", float(v), step)

    def close(self):
        self._w.flush()
        self._w.close()


def _open_tensorboard(args):
    if not args.tensorboard:
        return None
    try:
        return _TBWriter(os.path.join(args.out_dir, "tb"))
    except ImportError as e:  # optional: JSONL metrics are always written
        print(f"--tensorboard disabled (tensorboardX unavailable: {e})")
        return None


def epipolar_generator(seed: int, step: int, device):
    """The RANSAC draws' generator for one step: seeded by (seed + 1,
    step), so a resumed run replays the masks of the run it continues."""
    import numpy as np
    import torch
    mixed = np.random.SeedSequence([seed + 1, step]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) << 32 | int(mixed[1]))


def _attach_epipolar(model, step: int, batch, args):
    """Per-batch epipolar mask and fundamental matrix from the model's
    current prediction (train_fundamental.py:435-500), on the model's
    device: a forward without gradients, flow2 upsampled to the frame, one
    RANSAC per sample."""
    import torch
    from opticalflow_tpu_torch.geometry.epipolar import epipolar_mask_and_f
    from opticalflow_tpu_torch.train.losses import _flow_to_image_res
    from opticalflow_tpu_torch.train.trainer import batch_to_device

    device = next(model.parameters()).device
    x = batch_to_device({"images": batch["images"]}, device)["images"]
    with torch.no_grad():
        flow2 = model(x) * args.flow_scale
        full = _flow_to_image_res(flow2, x.shape[2], x.shape[3])
        gen = epipolar_generator(args.seed, step, device)
        masks, fs = zip(*(epipolar_mask_and_f(fl, gen, tau=args.epi_tau,
                                              stride=args.epi_stride)
                          for fl in full))
    batch = dict(batch)
    batch["photo_mask"] = torch.stack(masks).float()
    batch["fundamental"] = torch.stack(fs).float()
    return batch


def _plot_history(history, path):
    if not history:
        return
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        ep, losses = zip(*history)
        plt.figure(figsize=(6, 4))
        plt.plot(ep, losses, marker="o")
        plt.xlabel("epoch")
        plt.ylabel("loss")
        plt.grid(True, alpha=0.3)
        plt.tight_layout()
        plt.savefig(path)
        plt.close()
    except Exception as e:  # viz must never kill a training run
        print(f"loss-curve plot skipped: {e}")


if __name__ == "__main__":
    sys.exit(main())
