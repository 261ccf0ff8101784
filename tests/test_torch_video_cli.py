"""The port's video CLIs (``cli/extract_video``, ``cli/extract_flow``,
``cli/capture_frame``) on the CPU against the JAX package's functions on
the same decoded frames (the port decodes ``.y4m`` itself; OpenCV's FFmpeg
decode of the same file differs by a few levels, so the JAX side is fed
the port's frames, as its CLIs would feed their own).

Tolerances: the flows agree to 1e-6 mean EPE (float32 parity mode); the
arrows, vanish and topview frames equal the JAX pipeline's (0 pixels of
any frame differ on this clip; an arrow end could round the other way
only where the two flows straddle a half pixel within 1e-6); the colour
frames within one level on at most 1e-4 of their values (measured: one
value of one frame, 2.8e-5 of its 36000, and one of the 18000 of
``extract_flow``'s colour PNG, 5.6e-5: the native wheel is held to numpy
within a level).  One JAX runner compile and one engine compile.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from opticalflow_tpu import video as jvideo  # noqa: E402
from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet  # noqa
from opticalflow_tpu.models.torch_import import import_state_dict  # noqa
from opticalflow_tpu.runtime import flowviz as jfv  # noqa: E402
from opticalflow_tpu.viz import overlay as jov  # noqa: E402
from opticalflow_tpu.viz import topview as jtv  # noqa: E402
from opticalflow_tpu.viz import vanishing as jvp  # noqa: E402
from opticalflow_tpu_torch.cli import (capture_frame, extract_flow,  # noqa
                                       extract_video)
from opticalflow_tpu_torch.io import video as vio  # noqa: E402
from opticalflow_tpu_torch.io.flo import read_flo  # noqa: E402
from opticalflow_tpu_torch.io.images import decode_png, encode_png  # noqa
from oracles.torch_pwcnet import OraclePWC  # noqa: E402

H, W = 60, 100          # padded to 64x128 on the way in
N_FRAMES = 6


def _moving_frames(n, h, w, seed=0):
    """A smooth texture moving 2 px right and 1 px down a frame."""
    rng = np.random.RandomState(seed)
    base = cv2.GaussianBlur((rng.rand(h + 40, w + 40, 3) * 255).astype(
        np.uint8), (0, 0), 2.0)
    return [np.ascontiguousarray(base[20 - i:20 - i + h, 20 - 2 * i:
                                      20 - 2 * i + w]) for i in range(n)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The fake reference checkpoint, a .y4m clip written by the port, its
    decoded frames, and the JAX runner (float32, one compile) over them."""
    tmp = tmp_path_factory.mktemp("video_cli")
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for p in net.parameters():
        p.data *= 0.5
    sd = net.state_dict_flat()
    ckpt = str(tmp / "fake.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    clip = str(tmp / "clip.y4m")
    wr = vio.Y4MWriter(clip, 25.0, (W, H))
    for f in _moving_frames(N_FRAMES, H, W):
        wr.write(f)
    wr.release()
    frames = list(vio.read_frames(clip))
    params = import_state_dict({k: v.numpy() for k, v in sd.items()},
                               variant="new")
    runner = jvideo.VideoFlowRunner(
        JaxPWCDCNet(variant="new", precision="highest",
                    use_pallas_corr=False), params, batch=2)
    return {"tmp": tmp, "ckpt": ckpt, "clip": clip, "frames": frames,
            "runner": runner, "params": params}


def _jax_flows(setup, frames):
    return [q for _, _, q in setup["runner"].run(iter(frames))]


def _run_cli(setup, mode, *extra):
    out = str(setup["tmp"] / f"out_{mode}_{'_'.join(extra)}".replace(".", ""))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = extract_video.main([setup["clip"], out, "--ckpt", setup["ckpt"],
                                 "--mode", mode, "--batch", "2", "--dtype",
                                 "float32", "--device", "cpu", *extra])
    assert rc == 0
    text = buf.getvalue()
    assert "9.37M params" in text, text
    assert f"{N_FRAMES - 1} frame pairs" in text and "fps steady-state" in text
    return list(vio.read_frames(out))


@pytest.fixture(scope="module")
def jax_flows(setup):
    return _jax_flows(setup, setup["frames"])


@pytest.mark.parametrize("mode,extra", [
    ("arrows", ()), ("arrows", ("--no-decimate",)),
    ("vanish", ("--shrink", "0.75")), ("vanish", ())])
def test_arrow_modes_match_jax_pipeline(setup, jax_flows, mode, extra):
    got = _run_cli(setup, mode, *extra)
    frames = setup["frames"]
    assert len(got) == N_FRAMES - 1
    for k, (frame, q) in enumerate(zip(frames, jax_flows)):
        if mode == "arrows":
            want = jov.arrow_overlay(frame, q, step=16, title="PWC-Net (TPU)")
        elif extra:
            want = jvp.vanish_frame(frame, q, step=16, shrink_ratio=0.75,
                                    title="PWC-Net VP (TPU)")
        else:
            full = jfv.resize_flow_native(q, H, W)
            want = jvp.draw_vanishing_point(
                jov.arrow_overlay(frame, full, step=16),
                jvp.estimate_vanishing_point(full, step=16))
        assert got[k].shape == (H, W, 3)
        np.testing.assert_array_equal(got[k], want, err_msg=f"frame {k}")


def test_color_mode_matches_jax_pipeline(setup, jax_flows):
    got = _run_cli(setup, "color")
    for frame, q, g in zip(setup["frames"], jax_flows, got):
        want = jov.side_by_side(frame, jfv.flow_to_color_native(
            jfv.resize_flow_native(q, H, W))[..., ::-1])
        assert g.shape == (H, 2 * W, 3)
        np.testing.assert_array_equal(g[:, :W], frame)
        diff = np.abs(g.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


def test_topview_mode_matches_jax_pipeline(setup):
    m = jtv.perspective_matrix(W, H)
    warped = [jtv.warp_topview(f, m) for f in setup["frames"]]
    got = _run_cli(setup, "topview")
    for frame, q, g in zip(warped, _jax_flows(setup, warped), got):
        full = jov.resize_flow_np(q, H, W)
        want = jtv.draw_direction_arrows(frame, full, step=20, scale=5.0,
                                         dominant=jtv.dominant_direction(full))
        np.testing.assert_array_equal(g, want)


def test_i420_upload_close_to_bgr_upload(setup):
    """--upload i420 on frames that already went through 4:2:0 once: the
    frames it draws on are the same, the flows a chroma round trip apart,
    and the arrows drawn from them the same (0 pixels differ)."""
    a = _run_cli(setup, "arrows", "--upload", "i420")
    b = _run_cli(setup, "arrows")
    assert len(a) == len(b) == N_FRAMES - 1
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_what_is_not_ported_raises(setup):
    base = [setup["clip"], str(setup["tmp"] / "x"), "--ckpt", setup["ckpt"],
            "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        extract_video.main(base + ["--mode", "compare"])
    mp4 = setup["tmp"] / "clip.mp4"
    mp4.write_bytes(b"\x00\x00\x00\x18ftypmp42")
    with pytest.raises(ValueError, match="H.264"):
        extract_video.main([str(mp4)] + base[1:])


def test_no_gpu_raises_unless_cpu_is_asked(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_video.main([setup["clip"], str(setup["tmp"] / "y"),
                            "--ckpt", setup["ckpt"]])
    im = str(setup["tmp"] / "im.png")
    with open(im, "wb") as f:
        f.write(encode_png(np.zeros((8, 8, 3), np.uint8)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_flow.main([im, im, "--ckpt", setup["ckpt"]])


def test_extract_flow_matches_jax_cli(setup, tmp_path):
    """Both CLIs on the same two PNG frames: the .flo and .npy within
    1e-6 mean EPE, the colour PNG within one level, a quiver PNG from
    each (the JAX CLI needs matplotlib for it)."""
    from opticalflow_tpu.cli import extract_flow as jextract_flow
    paths = []
    for i, f in enumerate(setup["frames"][:2]):
        p = str(tmp_path / f"frame{i}.png")
        with open(p, "wb") as fh:
            fh.write(encode_png(f[..., ::-1]))
        paths.append(p)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_flow.main([*paths, "--ckpt", setup["ckpt"],
                                  "--out-dir", ours, "--device", "cpu"]) == 0
        assert jextract_flow.main([*paths, "--ckpt", setup["ckpt"],
                                   "--out-dir", theirs]) == 0
    a, b = read_flo(f"{ours}/frame0.flo"), read_flo(f"{theirs}/frame0.flo")
    assert a.shape == b.shape == (H, W, 2)
    assert float(np.mean(np.hypot(*(a - b).transpose(2, 0, 1)))) <= 1e-6
    np.testing.assert_array_equal(np.load(f"{ours}/frame0_flow.npy"), a)
    with open(f"{ours}/frame0_color.png", "rb") as f:
        ca = decode_png(f.read())
    with open(f"{theirs}/frame0_color.png", "rb") as f:
        cb = decode_png(f.read())
    diff = np.abs(ca.astype(int) - cb.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    assert os.path.getsize(f"{ours}/frame0_quiver.png") > 0


def test_capture_frame(setup, tmp_path):
    """Frame 3 of the clip as PNG: the port's decode of it, and within
    OpenCV's FFmpeg decode of the same file (the JAX CLI's) by its rounding
    (3 levels measured)."""
    from opticalflow_tpu.cli import capture_frame as jcapture
    out, jout = str(tmp_path / "f3.png"), str(tmp_path / "j3.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([setup["clip"], "3", out]) == 0
        assert jcapture.main([setup["clip"], "3", jout]) == 0
    with open(out, "rb") as f:
        got = decode_png(f.read())[..., ::-1]
    np.testing.assert_array_equal(got, setup["frames"][3])
    assert np.abs(got.astype(int) - cv2.imread(jout).astype(int)).max() <= 3
    with contextlib.redirect_stderr(io.StringIO()):
        assert capture_frame.main([setup["clip"], str(N_FRAMES), out]) == 1
        assert capture_frame.main([str(tmp_path / "none.y4m"), "0"]) == 1
