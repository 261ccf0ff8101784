"""The port's FlowEngine and CLI on the CPU against the real-frame goldens
that ``tests/test_real_golden.py`` holds the JAX engine to."""

import os

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch.cli import script_pwc
from opticalflow_tpu_torch.engine import FlowEngine, resolve_device
from opticalflow_tpu_torch.io.flo import read_flo
from opticalflow_tpu_torch.io.images import load_image
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from oracles.torch_pwcnet import OraclePWC

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def fake_sd():
    # identical recipe to scripts/make_real_golden.py and
    # tests/test_real_golden.py: the port loads the oracle's state dict as is
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for p in net.parameters():
        p.data *= 0.5
    return net.state_dict_flat()


@pytest.fixture(scope="module")
def frames():
    return (load_image(os.path.join(GOLD, "real_im1.png")),
            load_image(os.path.join(GOLD, "real_im2.png")))


def _epe(a, b):
    return float(np.mean(np.hypot(*(a - b).transpose(2, 0, 1))))


@pytest.mark.parametrize("mode,preset,scale,golden", [
    ("resize", "bgr_unit", 20.0, "real_pair.flo"),
    ("pad", "rgb_imagenet", 1.0, "real_pair_pad.flo"),
    ("pad_ref", "rgb_imagenet", 1.0, "real_pair_padref.flo")])
def test_engine_reproduces_goldens(fake_sd, frames, mode, preset, scale,
                                   golden):
    engine = FlowEngine(PWCDCNet(), fake_sd, flow_scale=scale, device="cpu")
    flow = engine.flow_from_pair(*frames, preset=preset, size_mode=mode)
    ref = read_flo(os.path.join(GOLD, golden))
    assert flow.shape == ref.shape == (180, 318, 2)
    assert flow.dtype == np.float32
    d = _epe(flow, ref)
    # the bound tests/test_real_golden.py holds the JAX engine to
    assert d <= 1e-6, f"{mode}: mean EPE delta vs golden {d:.3e}"


def test_batched_pairs_match_single(fake_sd, frames):
    engine = FlowEngine(PWCDCNet(), fake_sd, device="cpu", dispatch_chunk=1)
    im1, im2 = frames
    both = engine.flow_from_pairs([im1, im2], [im2, im1], size_mode="pad")
    one = engine.flow_from_pair(im2, im1, size_mode="pad")
    assert both.shape == (2, 180, 318, 2)
    np.testing.assert_allclose(both[1], one, atol=1e-6)


def test_cli_writes_readable_flo(tmp_path, fake_sd, frames):
    ckpt = str(tmp_path / "fake.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in fake_sd.items()}}, ckpt)
    out = str(tmp_path / "sub" / "out.flo")
    rc = script_pwc.main([os.path.join(GOLD, "real_im1.png"),
                          os.path.join(GOLD, "real_im2.png"), out,
                          "--ckpt", ckpt, "--size-mode", "pad",
                          "--preset", "rgb_imagenet", "--flow-scale", "1.0",
                          "--device", "cpu"])
    assert rc == 0
    flow = read_flo(out)
    engine = FlowEngine(PWCDCNet(), fake_sd, flow_scale=1.0, device="cpu")
    np.testing.assert_array_equal(
        flow, engine.flow_from_pair(*frames, preset="rgb_imagenet",
                                    size_mode="pad"))
    assert _epe(flow, read_flo(os.path.join(GOLD, "real_pair_pad.flo"))) \
        <= 1e-6


def test_no_device_without_gpu_raises(fake_sd, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        FlowEngine(PWCDCNet(), fake_sd)
    with pytest.raises(RuntimeError):
        FlowEngine(PWCDCNet(), fake_sd, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_rejects_bad_input(fake_sd):
    engine = FlowEngine(PWCDCNet(), fake_sd, device="cpu")
    z = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(TypeError):
        engine.flow_from_pair(z / 255.0 + 0.001, z)
    with pytest.raises(ValueError, match="preset"):
        engine.flow_from_pair(z, z, preset="bgr")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.flow_from_pair(z, z, size_mode="resize_fixed")
    with pytest.raises(ValueError, match="common frame shape"):
        engine.flow_from_pairs([z, z[:32]], [z, z[:32]])
    # the quarter-res flow would be downsampled, where the JAX engine
    # antialiases: refused rather than silently different
    small = np.zeros((12, 40, 3), np.uint8)
    with pytest.raises(ValueError, match="16x16"):
        engine.flow_from_pair(small, small, size_mode="resize")
    # pad_ref's quarter-by-full-pad slice would be empty here
    with pytest.raises(ValueError, match="empty"):
        engine.flow_from_pair(small, small, size_mode="pad_ref")


def test_warmup_and_exact_64_frames_skip_cv2(fake_sd, monkeypatch):
    """/64-sized frames need no resize, so the resize mode never imports
    cv2 for them (the GPU machine may have none)."""
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("cv2 blocked")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    engine = FlowEngine(PWCDCNet(), fake_sd, device="cpu")
    engine.warmup(64, 128, size_modes=("resize", "pad"))
    z = np.full((64, 128, 3), 7, np.uint8)
    assert engine.flow_from_pair(z, z).shape == (64, 128, 2)
