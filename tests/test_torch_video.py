"""The port's streaming video runner (``video.py``) and I420 conversions
(``io/yuv.py``) against OpenCV and the JAX package's ``video.py`` on the
same seeded frames.

Tolerances: I420 in both directions bit-exact (to cv2 and to JAX);
``decimate_flow`` within 1e-6 of JAX's (float32, the same expression);
the runner with the full model (float32 parity mode, 60x120 frames padded
to 64x128, B=2) within 1e-6 mean EPE of the JAX runner, ``bgr`` and
``i420`` uploads; the runner's logic (pairing, the partial window,
presets, upload-once) with a torch twin of
``tests/test_video_runner.StubFlow`` exactly as that test holds JAX's.
Two full-model JAX compiles: the bgr and the i420 runner.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from opticalflow_tpu import video as jvideo
from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet
from opticalflow_tpu.models.torch_import import import_state_dict
from opticalflow_tpu_torch import video
from opticalflow_tpu_torch.io import yuv
from opticalflow_tpu_torch.io.video import Y4MWriter
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.parallel import mesh as meshlib
from oracles.torch_pwcnet import OraclePWC

cv2 = pytest.importorskip("cv2")


class StubFlow(nn.Module):
    """Torch twin of ``tests/test_video_runner.StubFlow``: quarter-res
    "flow" = the mean of each input's channels over 4x4 blocks."""

    def __init__(self):
        super().__init__()
        self.gain = nn.Parameter(torch.ones(()))

    def forward(self, x):
        pooled = F.avg_pool2d(x, 4, 4)
        u = pooled[:, :3].mean(dim=1, keepdim=True)
        v = pooled[:, 3:].mean(dim=1, keepdim=True)
        return torch.cat([u, v], dim=1) * self.gain


def _frames(n, h=96, w=130, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(n)]


def _blurred(n, h, w, seed):
    """Video-like frames: smooth chroma, as ``tests/test_i420.py`` uses."""
    return [cv2.GaussianBlur(f, (0, 0), 1.5) for f in _frames(n, h, w, seed)]


@pytest.fixture
def runner():
    return video.VideoFlowRunner(StubFlow(), preset="rgb_unit",
                                 flow_scale=2.0, batch=3, depth=1,
                                 device="cpu")


# ------------------------------------------------------------------ I420

@pytest.mark.parametrize("h,w", [(64, 128), (70, 64), (94, 130)])
def test_i420_both_directions_bit_exact(h, w):
    """h % 4 != 0 (70, 94) puts the U/V boundary inside a packed row."""
    rng = np.random.RandomState(1)
    rgb = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    packed = yuv.rgb_to_i420(rgb)
    np.testing.assert_array_equal(packed,
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420))
    yuvs = (rng.rand(3, h * 3 // 2, w) * 255).astype(np.uint8)
    got = video.yuv_i420_to_rgb_u8(torch.from_numpy(yuvs)).numpy()
    want_jax = np.asarray(jax.jit(jvideo.yuv_i420_to_rgb_u8)(
        jnp.asarray(yuvs)))
    np.testing.assert_array_equal(got, want_jax)
    for k in range(3):
        want = cv2.cvtColor(yuvs[k], cv2.COLOR_YUV2RGB_I420)
        np.testing.assert_array_equal(got[k], want)
        np.testing.assert_array_equal(yuv.i420_to_rgb(yuvs[k]), want)


def test_i420_refuses_odd_sides():
    with pytest.raises(ValueError, match="even"):
        yuv.rgb_to_i420(np.zeros((5, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="I420"):
        video.yuv_i420_to_rgb_u8(torch.zeros(1, 10, 7, dtype=torch.uint8))
    assert yuv.pad_to_even(np.zeros((5, 7, 3), np.uint8)).shape == (6, 8, 3)


# ------------------------------------------------------------------ decimate

def test_decimate_flow_matches_jax_and_host_resize():
    from opticalflow_tpu_torch.viz.overlay import resize_flow_np
    h, w, step = 96, 130, 16          # padded 128x192 -> quarter 32x48
    q = (np.random.RandomState(5).rand(1, 32, 48, 2) * 12 - 6).astype(
        np.float32)
    got = video.decimate_flow(torch.from_numpy(q), step, h, w).numpy()
    want = np.asarray(jvideo.decimate_flow(jnp.asarray(q), step, h, w))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ys, xs = np.mgrid[0:h:step, 0:w:step]
    np.testing.assert_allclose(got[0], resize_flow_np(q[0], h, w)[ys, xs],
                               atol=3e-4)


# ------------------------------------------------------------------ logic

def test_pairing_and_counts(runner):
    frames = _frames(8)
    outs = list(runner.run(iter(frames)))
    assert len(outs) == 7
    np.testing.assert_array_equal(outs[0][0], frames[0])
    np.testing.assert_array_equal(outs[0][1], frames[1])
    np.testing.assert_array_equal(outs[-1][0], frames[6])
    np.testing.assert_array_equal(outs[-1][1], frames[7])
    assert runner.stats["windows"] == 3   # 3 + 3 + a partial window of 1


def test_quarter_res_and_padding(runner):
    for _, _, q in runner.run(iter(_frames(4, h=96, w=130))):
        assert q.shape == (128 // 4, 192 // 4, 2)
        assert np.isfinite(q).all()


def test_partial_batch_values_match_full(runner):
    frames = _frames(5, seed=3)         # 4 pairs = batch(3) + partial(1)
    a = [q for _, _, q in runner.run(iter(frames))]
    b = [q for _, _, q in runner.run(iter(frames))]
    assert len(a) == 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # the last pair alone, in a window padded from 2 frames to 4
    (_, _, last), = list(runner.run(iter(frames[3:])))
    np.testing.assert_array_equal(last, a[-1])


@pytest.mark.parametrize("upload,shape,nbytes", [
    ("bgr", (4, 128, 192, 3), 4 * 128 * 192 * 3),
    ("i420", (4, 144, 130), 4 * 144 * 130)])
def test_each_frame_uploaded_once(upload, shape, nbytes):
    """The device step takes (B+1)-frame windows, interior frames not
    duplicated into pair tensors; i420 windows are the unpadded even
    frames at 1.5 bytes a pixel."""
    r = video.VideoFlowRunner(StubFlow(), flow_scale=2.0, batch=3,
                              upload=upload, device="cpu")
    shapes = []
    orig = r._step

    def spy(frames, fh, fw):
        shapes.append(tuple(frames.shape))
        return orig(frames, fh, fw)

    r._step = spy
    outs = list(r.run(iter(_frames(7))))    # 6 pairs = 2 windows of 3
    assert len(outs) == 6
    assert shapes == [shape, shape]
    assert r.stats["bytes_uploaded"] == 2 * nbytes


def test_preset_applied(runner):
    f = [np.full((64, 64, 3), 128, np.uint8)] * 2
    (_, _, q), = list(runner.run(iter(f)))
    np.testing.assert_allclose(q[..., 0], (128 / 255.0) * 2.0, atol=1e-5)


@pytest.mark.parametrize("preset", ["rgb_unit", "bgr_unit", "rgb_imagenet"])
def test_presets_match_jax_stub(preset):
    """The same stub in both packages: every preset, a partial window,
    a grid readback."""
    from test_video_runner import StubFlow as JaxStub
    frames = _frames(6, h=60, w=100, seed=7)
    jmodel = JaxStub()
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 6)))["params"]
    for grid in (None, 16):
        kw = dict(preset=preset, flow_scale=2.0, batch=2, grid_step=grid)
        want = [q for _, _, q in jvideo.VideoFlowRunner(
            jmodel, params, **kw).run(iter(frames))]
        got = [q for _, _, q in video.VideoFlowRunner(
            StubFlow(), device="cpu", **kw).run(iter(frames))]
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_i420_runner_equals_bgr_runner_on_roundtripped_frames():
    kw = dict(preset="rgb_unit", flow_scale=2.0, batch=3, device="cpu")
    frames = _blurred(5, 96, 130, seed=2)

    def roundtrip(f_bgr):
        rgb = np.ascontiguousarray(f_bgr[..., ::-1])
        back = cv2.cvtColor(cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420),
                            cv2.COLOR_YUV2RGB_I420)
        return np.ascontiguousarray(back[..., ::-1])

    a = [q for _, _, q in video.VideoFlowRunner(
        StubFlow(), upload="i420", **kw).run(iter(frames))]
    b = [q for _, _, q in video.VideoFlowRunner(
        StubFlow(), upload="bgr", **kw).run(roundtrip(f) for f in frames)]
    assert len(a) == len(b) == 4
    for qa, qb in zip(a, b):
        np.testing.assert_allclose(qa, qb, atol=1e-5, rtol=1e-5)


def test_refusals():
    with pytest.raises(ValueError, match="upload"):
        video.VideoFlowRunner(StubFlow(), upload="nv12", device="cpu")
    with pytest.raises(ValueError, match="preset"):
        video.VideoFlowRunner(StubFlow(), preset="bgr", device="cpu")
    # the mesh runner (once not ported): a mesh that is not a Mesh, a batch
    # the ranks do not divide (JAX's message) and a device not the mesh's
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        video.VideoFlowRunner(StubFlow(), mesh=object(), device="cpu")
    two = meshlib.Mesh(group=None, rank=0, world=2,
                       device=torch.device("cpu"), backend="gloo")
    jax_mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    with pytest.raises(ValueError) as jax_err:
        jvideo.VideoFlowRunner(JaxPWCDCNet(variant="new"), None, batch=3,
                               mesh=jax_mesh)
    with pytest.raises(ValueError, match=str(jax_err.value)):
        video.VideoFlowRunner(StubFlow(), batch=3, mesh=two)
    with pytest.raises(ValueError, match="not the mesh's"):
        video.VideoFlowRunner(StubFlow(), batch=2, mesh=two, device="cuda")


def test_no_gpu_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        video.VideoFlowRunner(StubFlow())


def test_frame_pairs_from_video_decodes_in_a_thread(tmp_path):
    path = str(tmp_path / "clip.y4m")
    frames = _blurred(6, 40, 64, seed=4)
    wr = Y4MWriter(path, 25.0, (64, 40))
    for f in frames:
        wr.write(f)
    wr.release()
    got = list(video.frame_pairs_from_video(path))
    assert len(got) == 6
    # the frames cv2.VideoCapture reads (FFmpeg's yuv4mpeg and swscale)
    cap = cv2.VideoCapture(path)
    for g in got:
        ok, want = cap.read()
        assert ok
        np.testing.assert_array_equal(g, want)
    cap.release()
    assert len(list(video.frame_pairs_from_video(path, max_frames=5,
                                                 stride=2))) == 3
    with open(path, "r+b") as fh:      # a truncated last frame: raised here
        fh.truncate(fh.seek(0, 2) - 10)
    with pytest.raises(ValueError, match="truncated"):
        list(video.frame_pairs_from_video(path))


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def fake_weights():
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for p in net.parameters():
        p.data *= 0.5
    sd = net.state_dict_flat()
    return sd, import_state_dict({k: v.numpy() for k, v in sd.items()},
                                 variant="new")


@pytest.mark.parametrize("upload", ["bgr", "i420"])
def test_runner_matches_jax_runner_full_model(fake_weights, upload):
    """The full model in float32 parity mode, both uploads, a partial last
    window (5 pairs at B=2), quarter-res output: ≤1e-6 mean EPE."""
    sd, params = fake_weights
    frames = _blurred(6, 60, 120, seed=11)
    kw = dict(preset="rgb_unit", flow_scale=1.0, batch=2, upload=upload)
    jmodel = JaxPWCDCNet(variant="new", precision="highest",
                         use_pallas_corr=False)
    want = [q for _, _, q in jvideo.VideoFlowRunner(
        jmodel, params, **kw).run(iter(frames))]
    got = [q for _, _, q in video.VideoFlowRunner(
        PWCDCNet(), sd, device="cpu", **kw).run(iter(frames))]
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.shape == b.shape == (16, 32, 2)
        epe = float(np.mean(np.hypot(*(a - b).transpose(2, 0, 1))))
        assert epe <= 1e-6, epe
