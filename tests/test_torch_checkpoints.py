"""The port's training checkpoints (``train/checkpoints.py``): save →
restore bit-exact for the model and the optimizer (Adam moments, step,
learning rates), ``latest_step`` over the JAX layout, a save that is cut
short leaving no checkpoint, and ``load_params`` on a port directory and on
directories that are not the port's."""

import json
import os

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.train import checkpoints as ckpt
from opticalflow_tpu_torch.train import trainer as TT


def _small_model(seed=0):
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(),
                                torch.nn.Conv2d(4, 2, 1))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return model


def _steps(model, opt, n, seed=1):
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        x = torch.randn(2, 3, 8, 8, generator=g)
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()


def _assert_same_state(a, b):
    """Two (nested) state dicts equal bit for bit."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same_state(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_state(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_save_restore_is_bit_exact_and_training_continues_alike(tmp_path,
                                                                optimizer):
    cfg = TT.TrainConfig(optimizer=optimizer, lr=1e-2, plateau_factor=0.5)
    model = _small_model()
    opt = TT.make_optimizer(cfg, model.parameters())
    _steps(model, opt, 3)
    opt.param_groups[0]["lr"] *= 0.5          # a plateau cut, kept too
    meta = {"epoch": 2, "mid_epoch": True, "loader": json.dumps(
        {"epoch": 2, "batch": 5, "seed": 0})}
    path = ckpt.save_train_state(str(tmp_path), 3, model.state_dict(),
                                 opt.state_dict(), metadata=meta)
    assert path == os.path.join(str(tmp_path), "step_3")
    assert os.listdir(path) == [ckpt.STATE_FILE]

    restored = ckpt.restore_train_state(str(tmp_path))
    assert restored["step"] == 3 and restored["metadata"] == meta
    model2 = _small_model(seed=9)
    opt2 = TT.make_optimizer(cfg, model2.parameters())
    model2.load_state_dict(restored["params"])
    opt2.load_state_dict(restored["opt_state"])
    _assert_same_state(model2.state_dict(), model.state_dict())
    _assert_same_state(opt2.state_dict(), opt.state_dict())
    assert all("exp_avg_sq" in s for s in opt2.state.values())
    # the same further steps from both give the same bits
    _steps(model, opt, 2, seed=4)
    _steps(model2, opt2, 2, seed=4)
    _assert_same_state(model2.state_dict(), model.state_dict())


def test_full_model_round_trip(tmp_path):
    """PWCDCNet's state and an AdamW state after one real step."""
    model = PWCDCNet(generator=torch.Generator().manual_seed(0))
    cfg = TT.TrainConfig()
    state, opt = TT.create_train_state(model, cfg)
    rng = np.random.RandomState(0)
    batch = {"images": rng.rand(1, 64, 64, 6).astype(np.float32),
             "flow": rng.randn(1, 64, 64, 2).astype(np.float32),
             "valid": np.ones((1, 64, 64), np.float32)}
    state, _ = TT.make_train_step(model, opt, cfg)(state, batch)
    ckpt.save_train_state(str(tmp_path), state.step, model.state_dict(),
                          opt.state_dict())
    out = ckpt.restore_train_state(str(tmp_path / "step_1"))
    _assert_same_state(out["params"], model.state_dict())
    _assert_same_state(out["opt_state"], opt.state_dict())
    assert "metadata" not in out


def test_latest_step_and_resaving(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    assert ckpt.latest_step(str(tmp_path)) is None
    model = _small_model()
    for step in (2, 10, 7):
        ckpt.save_train_state(str(tmp_path), step, model.state_dict(),
                              metadata={"epoch": step})
    (tmp_path / "step_99.meta.json").write_text("{}")   # no directory
    (tmp_path / "step_x").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 10
    # saving a step again replaces it whole
    with torch.no_grad():
        model[0].weight.add_(1.0)
    ckpt.save_train_state(str(tmp_path), 10, model.state_dict(),
                          metadata={"epoch": 11})
    out = ckpt.restore_train_state(str(tmp_path))
    assert out["metadata"] == {"epoch": 11} and "opt_state" not in out
    _assert_same_state(out["params"], {k: v for k, v in
                                       model.state_dict().items()})
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".")]


def test_a_save_cut_short_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    """A failure while the state file is written (a full disk, a kill)
    leaves no step directory and no temporary one: the previous checkpoint
    stays the latest."""
    model = _small_model()
    ckpt.save_train_state(str(tmp_path), 1, model.state_dict())

    def fail(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(torch, "save", fail)
    with pytest.raises(OSError, match="no space"):
        ckpt.save_train_state(str(tmp_path), 2, model.state_dict())
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert sorted(os.listdir(tmp_path)) == ["step_1"]


def test_load_params_reads_port_directories(tmp_path):
    model = PWCDCNet(generator=torch.Generator().manual_seed(1))
    ckpt.save_train_state(str(tmp_path), 4, model.state_dict())
    for path in (str(tmp_path), str(tmp_path / "step_4")):
        sd = ckpt.load_params(path)
        fresh = PWCDCNet()
        fresh.load_state_dict(sd)                  # strict
        _assert_same_state(fresh.state_dict(), model.state_dict())


def test_load_params_refuses_other_directories(tmp_path):
    """An Orbax-style directory (or one with no checkpoint at all) is not
    the port's: NotImplementedError naming the ROADMAP item; a step
    directory that does not exist: FileNotFoundError."""
    orbax = tmp_path / "orbax" / "step_3"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    for path in (tmp_path / "orbax", orbax, tmp_path / "orbax" / ".."):
        with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
            ckpt.load_params(str(path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path / "run" / "step_8"))
