"""The port's video CLIs (``cli/extract_video``, ``cli/extract_flow``,
``cli/capture_frame``) on the CPU against the JAX package's functions on
the same decoded frames (the port decodes ``.y4m`` itself; OpenCV's FFmpeg
decode of the same file differs by a few levels, so the JAX side is fed
the port's frames, as its CLIs would feed their own; an ``.mp4`` the port
decodes to cv2's frames exactly).

Tolerances: the flows agree to 1e-6 mean EPE (float32 parity mode); the
arrows, vanish and topview frames equal the JAX pipeline's (0 pixels of
any frame differ on this clip; an arrow end could round the other way
only where the two flows straddle a half pixel within 1e-6); the colour
frames within one level on at most 1e-4 of their values (measured: one
value of one frame, 2.8e-5 of its 36000, and one of the 18000 of
``extract_flow``'s colour PNG, 5.6e-5: the native wheel is held to numpy
within a level).  One JAX runner compile and one engine compile.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import io
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from make_video_fixtures import h264_field_mp4  # noqa: E402
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


def test_what_is_not_ported_raises(setup, monkeypatch):
    """Compare mode, once not ported, writes frames twice the clip's
    width; field-coded H.264 in MP4 and H.263 muxed into an MPEG transport stream
    (which cv2 does not open either) are refused naming ROADMAP item 8, a
    truncated MP4 saying so, an .mpg output naming what
    the port writes; Motion JPEG in AVI, once refused, runs: the frames
    the CLI reads are cv2.VideoCapture's (MPEG-2 in an .mpg runs too:
    test_torch_mpeg12.py)."""
    base = [setup["clip"], str(setup["tmp"] / "x"), "--ckpt", setup["ckpt"],
            "--device", "cpu"]
    got = _run_cli(setup, "compare")
    assert len(got) == N_FRAMES - 1
    assert all(g.shape == (H, 2 * W, 3) for g in got)
    fixtures = os.path.join(os.path.dirname(__file__), "goldens", "video")
    mp4 = open(os.path.join(fixtures, "moving_176x144.mp4"), "rb").read()
    h264, cut = setup["tmp"] / "h264.mp4", setup["tmp"] / "cut.mp4"
    h264.write_bytes(h264_field_mp4(str(setup["tmp"] / "field.mp4")))
    cut.write_bytes(mp4[:len(mp4) - 50])
    ts = os.path.join(fixtures, "ts_h263_128x96.ts")
    for path, match in ((str(h264), "H.264.*frame_mbs_only.*Queue 1 item 8"),
                        (str(cut), "truncated"),
                        (ts, "private data.*item 8")):
        with pytest.raises(ValueError, match=match):
            extract_video.main([path] + base[1:])
    # MPEG-2 in a program stream, once refused, is read; the CLI writes
    # MPEG-4 Part 2 where cv2's mp4v writer opens, and refuses the rest
    with pytest.raises(ValueError, match="mp4v writer does not open"):
        extract_video.main([setup["clip"], str(setup["tmp"] / "o.mxf")]
                           + base[2:])
    import opticalflow_tpu_torch.video as tvideo
    mjpg, seen = os.path.join(fixtures, "mjpg.avi"), []
    read = tvideo.read_frames

    def recording(*args, **kwargs):
        for frame in read(*args, **kwargs):
            seen.append(frame)
            yield frame
    monkeypatch.setattr(tvideo, "read_frames", recording)
    out = str(setup["tmp"] / "mjpg_arrows")
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_video.main([mjpg, out] + base[2:]) == 0
    cap = cv2.VideoCapture(mjpg)
    want = [cap.read()[1] for _ in range(2)]
    cap.release()
    assert len(seen) == 2 and len(os.listdir(out)) == 1
    for g, w in zip(seen, want):
        np.testing.assert_array_equal(g, w)


def test_extract_video_mp4_in_and_out(setup, monkeypatch):
    """A cv2-written mp4v .mp4 in, an .mp4 out: the overlay frames handed
    to the encoder equal the JAX pipeline's on the same decoded frames, and
    cv2 reads the output with the clip's frame count, fps and size."""
    src = str(setup["tmp"] / "cv2_clip.mp4")
    cw = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (W, H))
    for f in _moving_frames(N_FRAMES, H, W):
        cw.write(f)
    cw.release()
    frames = list(vio.read_frames(src))
    cap = cv2.VideoCapture(src)
    for f in frames:
        ok, want = cap.read()
        np.testing.assert_array_equal(f, want)
    drawn = []
    write = vio.Mpeg4Writer.write
    monkeypatch.setattr(vio.Mpeg4Writer, "write",
                        lambda self, frame: (drawn.append(frame.copy()),
                                             write(self, frame)))
    out = str(setup["tmp"] / "arrows.mp4")
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_video.main([src, out, "--ckpt", setup["ckpt"],
                                   "--batch", "2", "--dtype", "float32",
                                   "--device", "cpu"]) == 0
    flows = _jax_flows(setup, frames)
    assert len(drawn) == N_FRAMES - 1
    for k, (frame, q) in enumerate(zip(frames, flows)):
        want = jov.arrow_overlay(frame, q, step=16, title="PWC-Net (TPU)")
        np.testing.assert_array_equal(drawn[k], want, err_msg=f"frame {k}")
    cap = cv2.VideoCapture(out)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == N_FRAMES - 1
    assert cap.get(cv2.CAP_PROP_FPS) == 25.0
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH),
            cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (W, H)
    got = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        got.append(f)
    assert len(got) == N_FRAMES - 1
    for a, b in zip(got, vio.read_frames(out)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def port_flows(setup):
    """The port's runner over the clip's frames (the CLI's defaults for
    compare mode: no decimation), float32 on the CPU."""
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.train.checkpoints import load_params
    from opticalflow_tpu_torch.video import VideoFlowRunner
    runner = VideoFlowRunner(PWCDCNet(variant="new"),
                             load_params(setup["ckpt"]), batch=2,
                             device="cpu")
    return [q for _, _, q in runner.run(iter(setup["frames"]))]


@pytest.mark.parametrize("method", ["farneback", "dis", "lucaskanade_dense"])
def test_compare_mode_draws_both_flows(setup, port_flows, method):
    """Each frame is the ``side_by_side`` of the network's arrows
    (``title="PWC-Net"``) and the baseline's lime arrows, built from the
    port's parts, pixel for pixel; and with cv2's own baseline flow the
    right half is the JAX package's ``arrow_overlay(..., color="lime")``
    pixel for pixel (the two baselines are within 1e-3 px)."""
    from opticalflow_tpu_torch.viz import overlay as ov
    got = _run_cli(setup, "compare", "--compare-method", method)
    frames = setup["frames"]
    assert len(got) == len(frames) - 1
    for k, (f1, f2) in enumerate(zip(frames[:-1], frames[1:])):
        assert got[k].shape == (H, 2 * W, 3)
        base = ov.opencv_flow(f1, f2, method, device="cpu")
        want = ov.side_by_side(
            ov.arrow_overlay(f1, port_flows[k], title="PWC-Net"),
            ov.arrow_overlay(f1, base, title=method, color="lime"))
        np.testing.assert_array_equal(got[k], want, err_msg=f"frame {k}")
        cv2_base = jov.opencv_flow(f1, f2, method)
        np.testing.assert_array_equal(
            ov.arrow_overlay(f1, cv2_base, title=method, color="lime"),
            jov.arrow_overlay(f1, cv2_base, title=method, color="lime"))
        assert np.hypot(*(base - cv2_base).transpose(2, 0, 1)).mean() <= 1e-3


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
