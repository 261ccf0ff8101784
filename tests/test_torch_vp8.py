"""The port's VP8 decoder (``runtime/vp8``) behind ``io/video``, in WebM,
Matroska and AVI, against OpenCV's FFmpeg (``cv2.VideoCapture`` runs
FFmpeg's native vp8 decoder and swscale) and the JAX package's cv2-based
readers.

Tolerance: 0 throughout.  VP8's reconstruction is exact integer arithmetic
and the conversion is swscale's, so every frame equals cv2's bit for bit:
on the committed fixtures (``tests/goldens/video/vp8_*``, written by cv2's
libvpx or byte patches of what it wrote, each frame's digest in the
manifest, which the GPU machine checks without cv2), through seeking, and
on frames patched to be hidden or damaged.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch

from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame, extract_video
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.runtime import vp8
from opticalflow_tpu_torch.runtime.mpeg4 import i420_to_bgr
from make_video_fixtures import moving_clip

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
VP8 = sorted(n for n in MANIFEST if n.startswith("vp8_"))
WEBM = os.path.join(FIXTURES, "vp8_176x144.webm")


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            cap.release()
            return out
        out.append(frame)


def _cv2_seek(path, i):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, i)
    ok, frame = cap.read()
    cap.release()
    assert ok
    return frame


def _cv2_info(path):
    cap = cv2.VideoCapture(path)
    info = {"fps": cap.get(cv2.CAP_PROP_FPS),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    cap.release()
    return info


def _same(a, b):
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {k}")


def _samples(path):
    box = MkvFile(path)
    with open(path, "rb") as f:
        return [box.sample(f, i) for i in range(len(box.sizes))]


# ---------------------------------------------------------------- fixtures

@pytest.mark.parametrize("name", VP8)
def test_fixture_frames_equal_cv2_and_the_manifest(name, monkeypatch):
    # the digests were taken with the manifest's FFmpeg threads (the
    # clamping_type stream's colour depends on them; cv2 and the port both
    # read OPENCV_FFMPEG_THREADS)
    monkeypatch.setenv("OPENCV_FFMPEG_THREADS",
                       str(_MANIFEST["ffmpeg_threads"]))
    path = os.path.join(FIXTURES, name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in got] == \
        MANIFEST[name]["sha256"]


@pytest.mark.parametrize("name", VP8)
def test_fixture_info_and_seeks_equal_cv2(name):
    """fps, size and count as cv2 reports them; seeks to frames 0, 5, 13
    and the last as a CAP_PROP_POS_FRAMES seek reads them (key frames at
    0, 12 and 24)."""
    path = os.path.join(FIXTURES, name)
    assert vio.video_info(path) == _cv2_info(path)
    n = MANIFEST[name]["frames"]
    for i in sorted({min(i, n - 1) for i in (0, 5, 13, n - 1)}):
        np.testing.assert_array_equal(vio.read_frame(path, i),
                                      _cv2_seek(path, i), err_msg=f"{i}")


def test_manifest_lists_each_fixtures_features():
    """The manifest's ``vp8_features`` are what the decoder meets in each
    file; the version patches reach bilinear prediction and full-pel
    chroma, the 176x144 stream golden references and split MVs."""
    for name in ("vp8_176x144.webm", "vp8_version3.webm"):
        dec = vp8.Decoder(name)
        for s in _samples(os.path.join(FIXTURES, name)):
            dec.decode(s)
        assert dec.features == MANIFEST[name]["vp8_features"], name
    assert {"bilinear", "full_pel_chroma"} <= set(
        MANIFEST["vp8_version3.webm"]["vp8_features"])
    assert {"split_mv", "golden_ref", "b_pred"} <= set(
        MANIFEST["vp8_176x144.webm"]["vp8_features"])


def test_frame_header_sizes_and_keyframes():
    frames = _samples(WEBM)
    assert vp8.frame_size(frames[0]) == (176, 144)
    assert [i for i, f in enumerate(frames) if vp8.is_keyframe(f)] == \
        [0, 12, 24] == MkvFile(WEBM).keyframes
    assert vp8.frame_size(frames[1]) is None
    patched = os.path.join(FIXTURES, "vp8_175x143.webm")
    assert vp8.frame_size(_samples(patched)[12]) == (175, 143)


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_clamping_type_sets_the_range_of_each_ffmpeg_thread(threads,
                                                            monkeypatch):
    """``vp8_clamping.webm`` sets the key frames' clamping_type bit, which
    FFmpeg takes for full range.  Each of its frame threads keeps the bit
    of the last key frame it decoded itself, frames going to the threads in
    turn: one thread converts every frame at full range, eight the key
    frames' threads' only.  The port follows cv2 at each thread count; the
    video range it converted at before is off on the full-range frames."""
    monkeypatch.setenv("OPENCV_FFMPEG_THREADS", str(threads))
    path = os.path.join(FIXTURES, "vp8_clamping.webm")
    want = _cv2_frames(path)
    video = vio.EncodedVideo(path)
    assert video.threads == threads
    full = []
    got = []
    for _, planes in video.planes():
        full.append(video.full_range)
        got.append(i420_to_bgr(*planes, video.full_range))
    _same(got, want)
    assert full == [(i % threads) in {k % threads for k in (0, 12, 24)
                                       if k <= i} for i in range(26)]
    for i in (i for i, f in enumerate(full) if f):
        assert not np.array_equal(i420_to_bgr(*_planes(path)[i]), want[i])


def _planes(path):
    return [p for _, p in vio.EncodedVideo(path).planes()]


# ------------------------------------------------- hidden and bad frames

def test_hidden_frame_is_passed_over_as_cv2_does(tmp_path):
    """A frame patched to show_frame = 0 still updates the references
    and hands over no picture: the port's frames are cv2's."""
    data = bytearray(open(WEBM, "rb").read())
    box = MkvFile(WEBM)
    off = box.offsets[5]
    data[off] &= ~0x10
    path = str(tmp_path / "hidden.webm")
    with open(path, "wb") as f:
        f.write(bytes(data))
    want = _cv2_frames(path)
    got = list(vio.read_frames(path))
    assert len(got) == len(want) == 25
    _same(got, want)
    dec = vp8.Decoder()
    assert [dec.decode(s) is None for s in _samples(path)].count(True) == 1
    assert "hidden_frames" in dec.features


@pytest.mark.parametrize("damage,match", [
    ("first_partition", "first partition runs past"),
    ("start_code", "start code"),
    ("inter_first", "inter frame before any key frame"),
    ("short", "fewer than 3 bytes")])
def test_frames_ffmpeg_refuses_raise(damage, match):
    frames = _samples(WEBM)
    dec = vp8.Decoder("clip")
    if damage == "inter_first":
        bad = frames[1]
    elif damage == "short":
        bad = frames[0][:2]
    elif damage == "start_code":
        bad = frames[0][:3] + b"\0" + frames[0][4:]
    else:                                 # first partition size > the data
        bad = frames[0][:200]
    with pytest.raises(ValueError, match=match):
        dec.decode(bad)


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["vp8_176x144.webm", "vp8_176x144.avi",
                                  "vp8_176x144.mkv", "mkv_mp4v_176x144.mkv"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = os.path.join(FIXTURES, name)
    _same(list(vio.read_frames(path, max_frames=20, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=20, stride=2)))


def test_jax_consecutive_frames_equal():
    ds = datasets.ConsecutiveFrames(WEBM, size_hw=(64, 96), stride=2)
    jds = jdatasets.ConsecutiveFrames(WEBM, size_hw=(64, 96), stride=2)
    assert ds.index == jds.index
    # in order (one open decoder), then out of order (seeks)
    for i in (0, 1, 2, 15, 16, 5, 23):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_jax_capture_frame_equals(tmp_path):
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([WEBM, "17", a]) == 0
        assert jcapture.main([WEBM, "17", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))


def test_extract_video_webm_in_mkv_out(tmp_path, monkeypatch):
    """The video CLI over a cv2-written VP8 .webm: the frames it reads are
    cv2.VideoCapture's, and cv2 reads its .mkv output with the clip's
    count (one frame a pair), fps and size, frame for frame as the port."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from oracles.torch_pwcnet import OraclePWC
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for p in net.parameters():
        p.data *= 0.5
    ckpt = str(tmp_path / "fake.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               net.state_dict_flat().items()}}, ckpt)
    src = str(tmp_path / "clip.webm")
    wr = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"VP80"), 25.0, (96, 64))
    for f in moving_clip(64, 96, 5, seed=9, speed=3.0):
        wr.write(f)
    wr.release()
    import opticalflow_tpu_torch.video as tvideo
    seen, read = [], tvideo.read_frames

    def recording(*args, **kwargs):
        for frame in read(*args, **kwargs):
            seen.append(frame)
            yield frame
    monkeypatch.setattr(tvideo, "read_frames", recording)
    out = str(tmp_path / "arrows.mkv")
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_video.main([src, out, "--ckpt", ckpt, "--batch", "2",
                                   "--dtype", "float32", "--device",
                                   "cpu"]) == 0
    _same(seen, _cv2_frames(src))
    assert _cv2_info(out) == vio.video_info(out) == {
        "fps": 25.0, "width": 96, "height": 64, "frames": 4}
    _same(_cv2_frames(out), list(vio.read_frames(out)))


def test_key_frame_of_another_size_is_scaled_back_as_cv2_does():
    """libvpx's VP8 encoder takes a key frame to shrink a stream (frame 6,
    to 128x96): cv2 scales those frames back to the first size through
    swscale's bicubic scaler, luma and chroma; so does the port, and every
    seek reads cv2's frame."""
    name = "vp8_resize.webm"
    path = os.path.join(FIXTURES, name)
    video = vio.EncodedVideo(path)
    assert [p[0].shape for _, p in video.planes()] == \
        [(144, 176)] * 6 + [(96, 128)] * 6
    assert video.keyframes == [0, 6]
    want = MANIFEST[name]
    frames = list(video)
    _same(frames, _cv2_frames(path))
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == \
        want["sha256"]
    for t, hit in want["seeks"].items():
        assert hashlib.sha256(video.frame(int(t)).tobytes()).hexdigest() == \
            want["sha256"][hit], t
