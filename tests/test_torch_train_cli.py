"""The port's training CLI (``opticalflow_tpu_torch/cli/train.py``) end to end
on the CPU, on tiny synthetic trees written by the port's PNG encoder, at
crop 64x64 and batch 2 (the full-width model, random weights): the cases
``tests/test_train_cli.py`` holds the JAX CLI to, among them preemption and
resume bit-identical to an uninterrupted run; and one multiscale step on
the port loader's first batch against the JAX step on the JAX loader's
first batch from the same weights (one JAX gradient compile).
"""

import dataclasses
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu.data import loader as jloader
from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet
from opticalflow_tpu.train import trainer as JT
from opticalflow_tpu_torch.cli import train as cli
from opticalflow_tpu_torch.data import datasets, loader
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.models.torch_import import state_dict_from_jax
from opticalflow_tpu_torch.train import checkpoints as ckpt
from opticalflow_tpu_torch.train import trainer as TT
from test_torch_train_data import (smooth_frames, synth_kitti, write_png,
                                   MASK_AGREE)

BASE = ["--crop", "64", "64", "--batch", "2", "--workers", "2",
        "--log-every", "1", "--seed", "0", "--device", "cpu"]


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _steps(out):
    return [r["step"] for r in _records(out) if "step" in r]


@pytest.fixture(scope="module")
def kitti12(tmp_path_factory):
    """12 temporal pairs of 72x96 frames: 6 steps an epoch at batch 2."""
    return synth_kitti(str(tmp_path_factory.mktemp("kitti12")),
                       n_images=13, h=72, w=96)


def test_train_cli_one_epoch(kitti12, tmp_path):
    """One multiscale epoch with a ragged validation split (3 of 12): JSONL
    metrics, the val record, best/ and epoch checkpoints, the loss curve
    and the TensorBoard events where tensorboardX is installed."""
    out = str(tmp_path / "run")
    assert cli.main(["--regime", "multiscale", "--data-root", kitti12,
                     "--out-dir", out, "--epochs", "1", "--val-frac", "0.25",
                     "--tensorboard", *BASE]) == 0
    recs = _records(out)
    assert _steps(out) == [1, 2, 3, 4]          # 9 train samples, drop_last
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["epe"])
               for r in recs if "step" in r)
    val = [r["val"] for r in recs if "val" in r]
    assert len(val) == 1 and set(val[0]) == {"loss", "epe"}
    assert ckpt.latest_step(out) == 4
    assert ckpt.latest_step(os.path.join(out, "best")) == 4
    meta = ckpt.restore_train_state(out)["metadata"]
    assert meta["epoch"] == 0 and json.loads(meta["loader"]) == {
        "epoch": 1, "batch": 0, "seed": 0}
    assert os.path.isfile(os.path.join(out, "loss_curve.png"))
    import importlib.util
    if importlib.util.find_spec("tensorboardX") is not None:
        events = [n for n in os.listdir(os.path.join(out, "tb"))
                  if "tfevents" in n]
        assert events


def _final_params(out):
    return ckpt.restore_train_state(out)["params"]


def test_train_cli_preemption_saves_and_resumes_bit_identically(kitti12,
                                                                tmp_path):
    """SIGTERM after the first logged step saves a resumable checkpoint
    with the loader's position and exits 0; --resume re-enters the same
    epoch at the saved batch, so the steps are 1..12 once each, and the
    final parameters, optimizer state and per-step losses are the bits of
    an uninterrupted run (deterministic order and augmentation per (seed,
    epoch, idx), the optimizer state saved)."""
    out = str(tmp_path / "run")
    argv = ["--regime", "multiscale", "--data-root", kitti12,
            "--out-dir", out, "--epochs", "2", "--save-every", "100", *BASE]
    log = os.path.join(out, "metrics.jsonl")

    def preempt_after_first_step():
        for _ in range(6000):
            if os.path.exists(log) and os.path.getsize(log) > 0:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.01)

    before = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=preempt_after_first_step, daemon=True)
    t.start()
    try:
        assert cli.main(argv) == 0
        t.join(timeout=60)
        assert not t.is_alive()
        # the CLI puts the handler it found back
        assert signal.getsignal(signal.SIGTERM) is before
        preempted_at = max(_steps(out))
        assert preempted_at < 12, "preemption raced past the whole run"
        assert ckpt.latest_step(out) == preempted_at
        meta = ckpt.restore_train_state(out)["metadata"]
        assert meta["mid_epoch"] == (preempted_at % 6 != 0)
    finally:
        signal.signal(signal.SIGTERM, before)

    assert cli.main(argv + ["--resume"]) == 0
    assert _steps(out) == list(range(1, 13)), "steps lost or repeated"
    assert os.path.isfile(os.path.join(out, "loss_curve.png"))

    out2 = str(tmp_path / "uninterrupted")
    assert cli.main([a if a != out else out2 for a in argv]) == 0
    assert _steps(out2) == list(range(1, 13))
    losses = [[r["loss"] for r in _records(o) if "step" in r]
              for o in (out, out2)]
    assert losses[0] == losses[1]
    a, b = (ckpt.restore_train_state(o) for o in (out, out2))
    assert a["step"] == b["step"] == 12
    for name in b["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    for k, sb in b["opt_state"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a["opt_state"]["state"][k][key], sb[key])


def _run_preempted_at(argv, at_step):
    """Run the CLI with a SIGTERM raised right after step ``at_step``."""
    real_step = TT.make_train_step

    def step_then_signal(model, opt, cfg):
        step = real_step(model, opt, cfg)

        def wrapped(state, batch):
            state, m = step(state, batch)
            if state.step == at_step:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, m
        return wrapped

    before = signal.getsignal(signal.SIGTERM)
    TT.make_train_step = step_then_signal
    try:
        assert cli.main(argv) == 0
    finally:
        TT.make_train_step = real_step
        signal.signal(signal.SIGTERM, before)


def test_train_cli_preemption_on_an_epochs_last_batch(kitti12, tmp_path):
    """A SIGTERM that lands while the epoch's last batch runs saves an
    end-of-epoch checkpoint: the resume starts the next epoch and logs no
    zero-step epoch."""
    out = str(tmp_path / "run")
    argv = ["--regime", "multiscale", "--data-root", kitti12,
            "--out-dir", out, "--epochs", "2", "--save-every", "100", *BASE]
    _run_preempted_at(argv, 6)
    meta = ckpt.restore_train_state(out)["metadata"]
    assert meta["mid_epoch"] is False
    assert json.loads(meta["loader"]) == {"epoch": 1, "batch": 0, "seed": 0}
    assert cli.main(argv + ["--resume"]) == 0
    assert _steps(out) == list(range(1, 13))


@pytest.mark.parametrize("at_step", [6, 8])
def test_train_cli_resume_keeps_validation_and_plateau(kitti12, tmp_path,
                                                       at_step):
    """With --val-frac and --plateau-factor, a run preempted mid-epoch
    (step 6: epoch 1, batch 2 of 4) or on an epoch's last batch (step 8)
    and resumed validates every epoch once, keeps best/ at the step and
    metric an uninterrupted run keeps, and cuts the learning rate at the
    same epochs: the best metric and the plateau's count are in the
    checkpoint.  At lr 3e-3 the validation EPE does not fall every epoch,
    so a resume that forgot either would save best/ or cut the rate
    elsewhere."""
    out, out2 = str(tmp_path / "run"), str(tmp_path / "uninterrupted")
    argv = ["--regime", "multiscale", "--data-root", kitti12,
            "--out-dir", out, "--epochs", "4", "--save-every", "100",
            "--val-frac", "0.25", "--plateau-factor", "0.5",
            "--plateau-patience", "1", "--lr", "3e-3", *BASE]
    _run_preempted_at(argv, at_step)
    assert cli.main(argv + ["--resume"]) == 0
    assert cli.main([a if a != out else out2 for a in argv]) == 0
    for o in (out, out2):
        assert _steps(o) == list(range(1, 17)), "steps lost or repeated"
    vals = [[r for r in _records(o) if "val" in r] for o in (out, out2)]
    assert [r["epoch"] for r in vals[0]] == [0, 1, 2, 3]
    assert vals[0] == vals[1]
    a, b = (ckpt.restore_train_state(os.path.join(o, "best"))
            for o in (out, out2))
    assert a["step"] == b["step"] and a["metadata"] == b["metadata"]
    a, b = (ckpt.restore_train_state(o) for o in (out, out2))
    lrs = [[g["lr"] for g in s["opt_state"]["param_groups"]] for s in (a, b)]
    assert lrs[0] == lrs[1]
    for name in b["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    for i, im in enumerate(smooth_frames(np.random.default_rng(3), 6, 90,
                                         120)):
        write_png(str(root / f"frame_{i:04d}.png"), im)
    return str(root)


@pytest.mark.parametrize("regime", ["pseudo", "epipolar"])
def test_train_cli_self_supervised_regimes(frames_dir, tmp_path, regime):
    """A frame directory at --size 64 128: finite losses, the Sampson
    metric in the epipolar regime (--epi-soft-w 0.1, the default), and the
    masks replayed from (seed + 1, step)."""
    out = str(tmp_path / regime)
    assert cli.main(["--regime", regime, "--data-root", frames_dir,
                     "--out-dir", out, "--epochs", "1", "--size", "64",
                     "128", "--epi-stride", "4", *BASE]) == 0
    recs = [r for r in _records(out) if "step" in r]
    assert [r["step"] for r in recs] == [1, 2]
    keys = {"loss", "photo", "smooth", "grad_norm"}
    if regime == "epipolar":
        keys.add("sampson")
    for r in recs:
        assert keys <= set(r) and all(np.isfinite(r[k]) for k in keys)
    assert ("sampson" in recs[0]) == (regime == "epipolar")


def test_attach_epipolar_is_reproducible_per_step():
    """The masks and F of a batch depend on (seed, step) only: the same
    step gives the same bits, another step other draws."""
    model = PWCDCNet(generator=torch.Generator().manual_seed(0))
    args = cli.build_parser().parse_args(
        ["--data-root", "x", "--regime", "epipolar", "--epi-stride", "4"])
    rng = np.random.default_rng(0)
    batch = {"images": rng.random((2, 64, 64, 6)).astype(np.float32)}
    a = cli._attach_epipolar(model, 5, batch, args)
    b = cli._attach_epipolar(model, 5, batch, args)
    assert a["photo_mask"].shape == (2, 64, 64)
    assert a["fundamental"].shape == (2, 3, 3)
    for k in ("photo_mask", "fundamental"):
        assert torch.equal(a[k], b[k])
    g5 = cli.epipolar_generator(0, 5, "cpu")
    g6 = cli.epipolar_generator(0, 6, "cpu")
    assert not torch.equal(torch.rand(8, generator=g5),
                           torch.rand(8, generator=g6))


def test_train_cli_refuses_what_is_not_ported(kitti12, tmp_path):
    for extra in (["--distributed"], ["--dist-coordinator", "h:1"],
                  ["--dist-num-processes", "2"]):
        with pytest.raises(SystemExit, match="Queue 1 item 6"):
            cli.main(["--data-root", kitti12, "--out-dir",
                      str(tmp_path / "r"), *BASE, *extra])
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\x00")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        cli.main(["--regime", "pseudo", "--data-root", str(video),
                  "--out-dir", str(tmp_path / "v"), *BASE])


def test_train_cli_starts_from_pretrained_weights(kitti12, tmp_path):
    """--pretrained takes a reference .pth.tar and a checkpoint directory
    of this port: with lr 0 the saved weights are the ones given."""
    ref = PWCDCNet(generator=torch.Generator().manual_seed(7))
    pth = str(tmp_path / "w.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               ref.state_dict().items()}}, pth)
    runs = []
    for src in (pth, None):
        out = str(tmp_path / f"run{len(runs)}")
        start = src if src else runs[-1]
        assert cli.main(["--data-root", kitti12, "--out-dir", out,
                         "--epochs", "1", "--lr", "0", "--weight-decay",
                         "0", "--pretrained", start, *BASE]) == 0
        runs.append(out)
        for k, v in _final_params(out).items():
            assert torch.equal(v, ref.state_dict()[k]), k


def test_multiscale_step_on_first_batches_matches_jax(kitti12):
    """The port loader's first batch against the JAX loader's (seed 0,
    epoch 0, the same shuffle), then one multiscale AdamW step on each from
    the same weights (×0.5, as the trainer tests): loss and epe within
    1e-4 relative (the batches differ by the augmentation's rounding, up to
    1e-5 on images and 1e-4 px on flow), gradients within 1e-2 relative +
    1e-3 of the largest."""
    ds = datasets.KittiFlowTrain(kitti12, crop_hw=(64, 64), seed=0)
    jds = jdatasets.KittiFlowTrain(kitti12, crop_hw=(64, 64), seed=0)
    batch = next(iter(loader.Loader(ds, 2, seed=0, num_workers=2)))
    jbatch = next(iter(jloader.Loader(jds, 2, seed=0, num_workers=2)))
    np.testing.assert_allclose(batch["images"], jbatch["images"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(batch["flow"], jbatch["flow"], rtol=0,
                               atol=1e-4)
    assert (batch["valid"] == jbatch["valid"]).mean() >= MASK_AGREE

    jmodel = JaxPWCDCNet(variant="new", precision="highest",
                         use_pallas_corr=False)
    params = jax.jit(lambda r, x: jmodel.init(r, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)))["params"]
    params = jax.tree.map(lambda p: np.asarray(p) * 0.5, params)
    cfg = TT.TrainConfig(loss="multiscale")
    jcfg = JT.TrainConfig(**dataclasses.asdict(cfg))
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT._compute_loss(jmodel, p, jb, jcfg), has_aux=True))(
            params)

    model = PWCDCNet(variant="new", precision="highest")
    state, opt = TT.create_train_state(model, cfg, params=params)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)   # keep the grads
    state, m = TT.make_train_step(model, opt, dataclasses.replace(
        cfg, grad_clip=0.0))(state, batch)
    for k in ("loss", "epe"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    grads = state_dict_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in model.named_parameters():
        g_ref = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=1e-2,
                                   atol=1e-3 * np.abs(g_ref).max(),
                                   err_msg=name)
