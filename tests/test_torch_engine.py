"""The port's FlowEngine and CLI on the CPU against the real-frame goldens
that ``tests/test_real_golden.py`` holds the JAX engine to."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
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
    with pytest.raises(ValueError, match="image_size"):
        engine.flow_from_pair(z, z, size_mode="resize_fixed")
    with pytest.raises(ValueError, match="multiple of 64"):
        engine.flow_from_pair(z, z, size_mode="resize_fixed",
                              image_size=(100, 128))
    with pytest.raises(ValueError, match="common frame shape"):
        engine.flow_from_pairs([z, z[:32]], [z, z[:32]])
    # pad_ref's quarter-by-full-pad slice would be empty here
    small = np.zeros((12, 40, 3), np.uint8)
    with pytest.raises(ValueError, match="empty"):
        engine.flow_from_pair(small, small, size_mode="pad_ref")


@pytest.mark.parametrize("h,w", [(12, 40), (9, 7), (30, 15)])
def test_tiny_frame_resize_matches_jax_image_resize(fake_sd, monkeypatch, h,
                                                    w):
    """Under 16 px a side the quarter-res flow (16 px at least) shrinks on
    its way back to the frame size: the engine antialiases there as the JAX
    engine's ``jax.image.resize(method="linear")`` does, on the same
    quarter-res flow."""
    import jax
    import jax.numpy as jnp
    engine = FlowEngine(PWCDCNet(), fake_sd, device="cpu")
    seen = {}
    quarter = engine._quarter_flow_u8

    def keep(x, preset):
        seen["q"] = quarter(x, preset)
        return seen["q"]

    monkeypatch.setattr(engine, "_quarter_flow_u8", keep)
    rng = np.random.RandomState(h * w)
    im1, im2 = (rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                for _ in range(2))
    flow = engine.flow_from_pair(im1, im2, size_mode="resize")
    q = seen["q"].permute(0, 2, 3, 1).numpy()
    h64, w64 = 4 * q.shape[1], 4 * q.shape[2]
    ref = jax.image.resize(jnp.asarray(q), (1, h, w, 2), method="linear")
    ref = np.asarray(ref * jnp.asarray([w / w64, h / h64], jnp.float32))
    assert flow.shape == (h, w, 2)
    np.testing.assert_allclose(flow, ref[0], atol=1e-5, rtol=1e-5)


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


def test_resize_mode_reproduces_golden_without_opencv(fake_sd, frames,
                                                      monkeypatch):
    """The default size mode on frames that are not /64 (180x318): the
    numpy resize stands in for cv2, which is never imported."""
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("cv2 blocked")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    engine = FlowEngine(PWCDCNet(), fake_sd, device="cpu")
    flow = engine.flow_from_pair(*frames)
    assert _epe(flow, read_flo(os.path.join(GOLD, "real_pair.flo"))) <= 1e-6


# ------------------------------------------------ PIL bilinear, resize_fixed

def _pil_size_pairs():
    """(src, dst) sizes: shrinking and enlarging, odd, and size 1."""
    rng = np.random.RandomState(0)
    sides = [1, 2, 3, 5, 7, 13, 31, 64, 97, 180, 318]
    pairs = [((int(rng.choice(sides)), int(rng.choice(sides))),
              (int(rng.choice(sides)), int(rng.choice(sides))))
             for _ in range(200)]
    return pairs + [((180, 318), (192, 320)), ((180, 318), (384, 1280)),
                    ((48, 80), (180, 318)), ((96, 320), (375, 1242))]


def test_pil_bilinear_u8_bit_exact_to_pil():
    from PIL import Image
    from opticalflow_tpu_torch.io.pil_resize import resize_pil_bilinear_u8
    rng = np.random.RandomState(1)
    for (h, w), (oh, ow) in _pil_size_pairs():
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(resize_pil_bilinear_u8(img, oh, ow),
                                      want, err_msg=f"{(h, w)}->{(oh, ow)}")


def test_pil_bilinear_f32_within_one_ulp_of_pil():
    """Mode ``F``: both passes sum in double and store float32; within one
    float32 ulp of PIL (0 ulp measured against PIL 12)."""
    from PIL import Image
    from opticalflow_tpu_torch.io.pil_resize import resize_pil_bilinear_f32
    rng = np.random.RandomState(2)
    worst = 0
    for (h, w), (oh, ow) in _pil_size_pairs():
        f = (rng.randn(h, w) * 10).astype(np.float32)
        want = np.asarray(Image.fromarray(f).resize((ow, oh), Image.BILINEAR))
        got = resize_pil_bilinear_f32(f, oh, ow)
        assert got.shape == want.shape and got.dtype == np.float32
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        worst = max(worst, int(ulp.max()))
    assert worst <= 1, worst


@pytest.fixture(scope="module")
def jax_engine(fake_sd):
    from opticalflow_tpu.engine import FlowEngine as JaxFlowEngine
    from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet
    from opticalflow_tpu.models.torch_import import import_state_dict
    params = import_state_dict({k: v.numpy() for k, v in fake_sd.items()},
                               variant="new")
    return JaxFlowEngine(JaxPWCDCNet(variant="new", precision="highest",
                                     use_pallas_corr=False), params,
                         flow_scale=1.0)


def test_resize_fixed_matches_jax_engine(fake_sd, frames, jax_engine):
    """The v1 path on the golden pair (180x318 through 192x320), the same
    weights: ≤1e-6 mean EPE against the JAX engine (PIL there, numpy in
    the port)."""
    engine = FlowEngine(PWCDCNet(), fake_sd, flow_scale=1.0, device="cpu")
    kw = dict(preset="rgb_imagenet", size_mode="resize_fixed",
              image_size=(192, 320))
    flow = engine.flow_from_pair(*frames, **kw)
    ref = jax_engine.flow_from_pair(*frames, **kw)
    assert flow.shape == ref.shape == (180, 318, 2)
    assert _epe(flow, ref) <= 1e-6, _epe(flow, ref)


@pytest.mark.parametrize("align_corners", [False, True])
def test_flow_from_batch_matches_jax_engine(fake_sd, frames, jax_engine,
                                            align_corners):
    """(B, H64, W64, 6) preprocessed input in the JAX layout → flow at
    out_size on the engine's device: ≤1e-6 mean EPE against the JAX
    engine, and at the default size the pad path's flow before its crop."""
    from opticalflow_tpu_torch.io.images import (pad_to_multiple_of_64,
                                                 preprocess_pair)
    x, _, _ = pad_to_multiple_of_64(preprocess_pair(*frames,
                                                    preset="rgb_imagenet"))
    engine = FlowEngine(PWCDCNet(), fake_sd, flow_scale=1.0, device="cpu")
    for size in ((180, 318), None):
        got = engine.flow_from_batch(x, out_size=size,
                                     align_corners=align_corners)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        want = np.asarray(jax_engine.flow_from_batch(
            x, out_size=size, align_corners=align_corners))
        assert got.shape == want.shape
        assert _epe(got[0].numpy(), want[0]) <= 1e-6
    if align_corners:       # the pad mode upsamples with align_corners
        pad = engine.flow_from_pair(*frames, preset="rgb_imagenet",
                                    size_mode="pad")
        np.testing.assert_allclose(got[0, :180, :318].numpy(), pad,
                                   atol=1e-5)
