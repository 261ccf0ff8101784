"""The rank side of ``tests/test_torch_parallel.py`` and
``tests/test_torch_spatial.py``: one process of a gloo world on the CPU.

    python tests/torch_parallel_ranks.py PORT RANK WORLD WORKDIR GROUP...

Joins the world over ``tcp://127.0.0.1:PORT`` (``parallel.mesh``), reads
the inputs the test wrote to ``WORKDIR/inputs.pt``, runs each GROUP of
rank-side checks in order, and saves what each gave to
``WORKDIR/rank{RANK}.pt``.  Every rank runs every group: their collectives
must meet.  The tests compare the results with the single-process port and
the JAX package.
"""

import contextlib
import io
import os
import signal
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import torch  # noqa: E402

from opticalflow_tpu_torch.parallel import mesh as meshlib  # noqa: E402


def _model(inputs, precision="highest"):
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    model = PWCDCNet(variant="new", precision=precision)
    model.load_state_dict(inputs["sd"])
    return model


def _raises(fn):
    """The message of what ``fn`` raised (None if it returned)."""
    try:
        fn()
    except (ValueError, SystemExit) as e:
        return str(e)
    return None


def group_train(inputs, mesh, out):
    """One multiscale AdamW step on this rank's rows; the same with
    grad_accum=2 on a batch of 4."""
    from opticalflow_tpu_torch.train import trainer as TT
    for name, batch, accum in (("train", inputs["batch"], 1),
                               ("accum", inputs["batch4"], 2)):
        model = _model(inputs)
        cfg = TT.TrainConfig(loss="multiscale", grad_accum=accum)
        state, opt = TT.create_train_state(model, cfg)
        step = TT.make_train_step(model, opt, cfg, mesh=mesh)
        state, m = step(state, meshlib.shard_batch(batch, mesh, accum))
        out[name] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}}
    # the eval step's metrics over the global batch
    ev = TT.make_eval_metrics_step(_model(inputs), TT.TrainConfig(),
                                   mesh=mesh)
    out["eval_step"] = {k: float(v) for k, v in ev(
        meshlib.shard_batch(inputs["batch"], mesh)).items()}


def group_infer(inputs, mesh, out, workdir):
    """The engine (a ragged N=3), evaluate_pairs and a lockstep server."""
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.evaluate import evaluate_pairs
    from opticalflow_tpu_torch.serve import FlowServer
    engine = FlowEngine(_model(inputs), inputs["sd"], mesh=mesh)
    im1s, im2s = inputs["im1s"], inputs["im2s"]
    out["pairs"] = {mode: engine.flow_from_pairs(im1s[:3], im2s[:3],
                                                 size_mode=mode)
                    for mode in ("pad", "resize")}
    out["batch_flow"] = engine.flow_from_batch(inputs["x64"]).numpy()
    out["batch_odd"] = _raises(lambda: engine.flow_from_batch(
        inputs["x64"][:1]))
    ds = [{"im1": a, "im2": b, "flow": g, "stem": f"p{i}"}
          for i, (a, b, g) in enumerate(zip(im1s, im2s, inputs["gts"]))]
    save = os.path.join(workdir, f"eval_rank{mesh.rank}")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out["eval"] = evaluate_pairs(engine, ds, size_mode="pad", batch=2,
                                     save_dir=save, verbose=True)
    out["eval_printed"] = printed.getvalue()
    out["eval_saved"] = sorted(os.listdir(save)) if os.path.isdir(save) \
        else []
    out["eval_odd_batch"] = _raises(lambda: evaluate_pairs(
        engine, ds, batch=3, verbose=False))
    server = FlowServer(engine, max_batch=2, max_delay_ms=1)
    out["buckets"] = server.bucket_sizes
    out["serve"] = server.flow(im1s[0], im2s[0], size_mode="pad")
    server.close()
    out["bad_max_batch"] = _raises(lambda: FlowServer(engine, max_batch=3))


def group_video(inputs, mesh, out):
    """The video runner over the mesh: 6 frames at B=2 (windows of 2, 2
    and 1 pairs) in bgr, and in i420 with grid_step; rank 0 reads the
    frames, the other rank passes None."""
    from opticalflow_tpu_torch.video import VideoFlowRunner
    for name, kw in (("bgr", {}), ("i420", {"upload": "i420",
                                             "grid_step": 16})):
        runner = VideoFlowRunner(_model(inputs), None, batch=2, mesh=mesh,
                                 **kw)
        frames = iter(inputs["video"]) if mesh.rank == 0 else None
        out[f"video_{name}"] = [(a.copy(), b.copy(), f.copy())
                                for a, b, f in runner.run(frames)]
        out[f"video_{name}_stats"] = dict(runner.stats)
    out["video_odd"] = _raises(lambda: VideoFlowRunner(
        _model(inputs), None, batch=3, mesh=mesh))


def _slab(x, mesh):
    """This rank's contiguous slab of H."""
    loc = x.shape[2] // mesh.world
    return x[:, :, mesh.rank * loc:(mesh.rank + 1) * loc]


def group_spatial(inputs, mesh, out):
    """Tiled (tile batch over the ranks) and halo exchange (a slab each)."""
    from opticalflow_tpu_torch.parallel import spatial
    model = _model(inputs).eval()
    x = inputs["x256"]                          # (1, 6, 256, 64)
    out["tiled"] = spatial.tiled_quarter_flow(model, x, tile_h=128, halo=64,
                                              mesh=mesh)
    out["tiled_odd"] = _raises(lambda: spatial.tiled_quarter_flow(
        model, torch.zeros(1, 6, 192, 64), tile_h=64, halo=64, mesh=mesh))
    slab = _slab(x, mesh)
    out["halo"] = spatial.halo_exchange_quarter_flow(model, slab, halo=64,
                                                     mesh=mesh)
    # slabs of 256 > 2·halo: each window is a part of the frame
    out["halo_wide"] = spatial.halo_exchange_quarter_flow(
        model, _slab(inputs["x512"], mesh), halo=64, mesh=mesh)
    out["halo_errors"] = [
        _raises(lambda: spatial.halo_exchange_quarter_flow(
            model, torch.zeros(1, 6, 96, 64), mesh=mesh)),
        _raises(lambda: spatial.halo_exchange_quarter_flow(
            model, slab, halo=128, mesh=mesh)),
        _raises(lambda: spatial.halo_exchange_quarter_flow(
            model, slab, mesh=None))]


def group_halo3(inputs, mesh, out):
    """The halo exchange over 3 ranks, slabs of 192 > 2·halo: both edge
    windows slide to the border, rank 1's is centred on its slab."""
    from opticalflow_tpu_torch.parallel import spatial
    out["halo3"] = spatial.halo_exchange_quarter_flow(
        _model(inputs).eval(), _slab(inputs["x576"], mesh), halo=64,
        mesh=mesh)


def group_replicate(inputs, mesh, out):
    """Rank 1 holds other weights: replicate must raise on every rank."""
    model = _model(inputs)
    if mesh.rank == 1:
        with torch.no_grad():
            next(model.parameters()).add_(1e-3)
    out["divergent"] = _raises(lambda: meshlib.replicate(model, mesh))
    out["same"] = _raises(lambda: meshlib.replicate(_model(inputs), mesh))


def _cli_steps(argv, signal_at=None):
    """Run the train CLI; returns (rc, steps it ran, stdout).  With
    ``signal_at`` this rank raises SIGTERM on itself after that step."""
    from opticalflow_tpu_torch.cli import train as cli
    from opticalflow_tpu_torch.train import trainer as TT
    real, steps = TT.make_train_step, []

    def counting(model, opt, cfg, **kw):
        step = real(model, opt, cfg, **kw)

        def wrapped(state, batch):
            state, m = step(state, batch)
            steps.append(state.step)
            if state.step == signal_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, m
        return wrapped

    printed = io.StringIO()
    TT.make_train_step = counting
    try:
        with contextlib.redirect_stdout(printed):
            try:
                rc = cli.main(argv)
            except SystemExit as e:
                rc = str(e)
    finally:
        TT.make_train_step = real
    return rc, steps, printed.getvalue()


def group_train_cli(inputs, mesh, out, workdir):
    """A 2-rank --distributed epoch (the samples each rank loads recorded),
    a SIGTERM on rank 1 after step 1 and the resume, and a --resume whose
    ranks see different latest steps."""
    from opticalflow_tpu_torch.cli import train as cli
    from opticalflow_tpu_torch.data.datasets import KittiFlowTrain
    seen = []

    class Recording(KittiFlowTrain):
        def get(self, i, epoch=0):
            seen.append(i)
            return super().get(i, epoch=epoch)

    real_make = cli._make_dataset
    cli._make_dataset = lambda args: Recording(
        args.data_root, crop_hw=tuple(args.crop), seed=args.seed)
    base = ["--regime", "multiscale", "--data-root", inputs["kitti"],
            "--crop", "64", "64", "--batch", "2", "--workers", "1",
            "--log-every", "1", "--seed", "0", "--device", "cpu",
            "--distributed"]
    try:
        run = os.path.join(workdir, "run")
        out["cli_epoch"] = _cli_steps(base + ["--out-dir", run,
                                              "--epochs", "1"])
        out["cli_seen"] = sorted(seen)
        stop = os.path.join(workdir, "stopped")
        out["cli_stop"] = _cli_steps(base + ["--out-dir", stop,
                                             "--epochs", "1"],
                                     signal_at=1 if mesh.rank == 1 else None)
        out["cli_resume"] = _cli_steps(base + ["--out-dir", stop,
                                               "--epochs", "1", "--resume"])
        # rank 1 resumes from an empty directory
        apart = stop if mesh.rank == 0 else os.path.join(workdir, "empty")
        out["cli_apart"] = _cli_steps(base + ["--out-dir", apart,
                                              "--epochs", "2", "--resume"])
        out["cli_val"] = _cli_steps(base + ["--out-dir", run, "--epochs",
                                            "1", "--val-frac", "0.25"])
    finally:
        cli._make_dataset = real_make


GROUPS = {"train": group_train, "infer": group_infer,
          "spatial": group_spatial, "halo3": group_halo3,
          "replicate": group_replicate, "video": group_video,
          "train_cli": group_train_cli}


def main() -> int:
    port, rank, world, workdir = sys.argv[1:5]
    torch.set_num_threads(1)
    meshlib.distributed_init(f"127.0.0.1:{port}", int(world), int(rank),
                             backend="gloo", device="cpu", timeout_s=300)
    mesh = meshlib.make_mesh("cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    out = {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend}
    for name in sys.argv[5:]:
        fn = GROUPS[name]
        args = (inputs, mesh, out) + ((workdir,) if name in (
            "infer", "train_cli") else ())
        try:
            fn(*args)
        except BaseException:
            traceback.print_exc()
            raise
    torch.save(out, os.path.join(workdir, f"rank{mesh.rank}.pt"))
    meshlib.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
