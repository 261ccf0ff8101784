"""The port's FFV1 decoder (``runtime/ffv1``) behind ``io/video`` in
Matroska, AVI, MP4 and QuickTime, against OpenCV's FFmpeg
(``cv2.VideoCapture`` runs FFmpeg's ffv1 decoder and swscale's packed
copy) and the JAX package's cv2-based readers.

Tolerance: 0 throughout.  FFV1 is lossless integer coding and the
conversion a byte copy (BGR0/BGRA → BGR24, grey replicated) or swscale's
4:2:0 arithmetic, so every frame equals cv2's bit for bit: on the
committed fixtures (``tests/goldens/video/ffv1_*``: cv2's writer in four
containers, colour and grey, and the 3-frame Sintel clip; libavcodec's
encoder for versions 0-3, the default and custom range-coder tables, 6
and 12 slices, grey, 4:2:0 with and without alpha, odd sizes), through
every seek cv2 makes and in the CLIs.  The library is built once for the
module (g++, a few seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os
import sys

import cv2
import numpy as np
import pytest

from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.avi import AviFile, codec_of
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.runtime import ffv1
from opticalflow_tpu_torch.runtime.mpeg4 import Unsupported

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
FFV1 = sorted(n for n in MANIFEST if n.startswith("ffv1_"))
MKV = os.path.join(FIXTURES, "ffv1_48x32.mkv")


@pytest.fixture(scope="module", autouse=True)
def library():
    return ffv1.load()


def _path(name):
    return os.path.join(FIXTURES, name)


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            cap.release()
            return out
        out.append(frame)


def _cv2_info(path):
    cap = cv2.VideoCapture(path)
    info = {"fps": cap.get(cv2.CAP_PROP_FPS),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    cap.release()
    return info


def _digest(frame):
    return hashlib.sha256(np.ascontiguousarray(frame).tobytes()).hexdigest()


def _same(a, b):
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {k}")


def _stream(name):
    v = vio.EncodedVideo(_path(name))
    with open(v.path, "rb") as f:
        return v, [v.box.sample(f, i) for i in range(v.samples)]


# ---------------------------------------------------------------- fixtures

def test_fixtures_cover_the_containers_versions_and_coders():
    assert {"ffv1_48x32.mkv", "ffv1_48x32.avi", "ffv1_48x32.mp4",
            "ffv1_48x32.mov", "ffv1_grey_48x32.mkv",
            "ffv1_sintel_436x1024.mkv", "ffv1_rgb_53x37.mkv",
            "ffv1_yuv420_53x37.mkv", "ffv1_v0_yuv420_32x24.mkv",
            "ffv1_v1_32x24.mkv", "ffv1_v2_yuv420_32x24.mkv",
            "ffv1_slices12_48x32.mkv"} <= set(FFV1)
    assert os.path.getsize(_path("ffv1_sintel_436x1024.mkv")) <= 1 << 20
    assert not any("port_refuses" in MANIFEST[n] for n in FFV1)


@pytest.mark.parametrize("name", FFV1)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", FFV1)
def test_video_info_equals_cv2(name):
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", FFV1)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """Non-key frames keep the contexts of the frame before: a seek
    decodes from the key frame before the target, and reads cv2's frame."""
    path = _path(name)
    want = MANIFEST[name]
    video = vio.EncodedVideo(path)
    for t, hit in want["seeks"].items():
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", FFV1)
def test_manifest_features_are_the_decoders(name):
    v, packets = _stream(name)
    dec = v._decoder()
    for p in packets:
        dec.decode(p)
    assert dec.features == MANIFEST[name]["ffv1_features"]


def test_what_each_fixture_reaches_and_what_none_does():
    need = {"ffv1_48x32.mkv": {"golomb", "golomb_runs", "slices", "rgb",
                               "alpha", "version_3", "crc",
                               "non_key_frames"},
            "ffv1_range_32x24.mkv": {"range_custom"},
            "ffv1_range_default_32x24.mkv": {"range_default"},
            "ffv1_v0_yuv420_32x24.mkv": {"version_0_1", "yuv420"},
            "ffv1_v1_32x24.mkv": {"version_0_1", "rgb", "range_custom"},
            "ffv1_v2_yuv420_32x24.mkv": {"version_2", "yuv420"},
            "ffv1_grey_48x32.mkv": {"grey"},
            "ffv1_yuva420_32x24.mkv": {"yuv420", "alpha"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["ffv1_features"]), name
    reached = {f for n in FFV1 for f in MANIFEST[n]["ffv1_features"]}
    assert _MANIFEST["ffv1_unreached"] == [f for f in ffv1.FEATURES
                                           if f not in reached]
    assert _MANIFEST["ffv1_unreached"] == ["initial_states"]


@pytest.mark.parametrize("name,slices", [("ffv1_48x32.mkv", 4),
                                         ("ffv1_range_32x24.mkv", 6),
                                         ("ffv1_slices12_48x32.mkv", 12)])
def test_slice_counts(name, slices):
    """cv2's writer gives FFmpeg a slice per thread (4 here, by the writer's
    CPUs); libavcodec's 6 and 12: each stream's packets end in as many
    slice trailers, and every one decodes to cv2's frames."""
    _, packets = _stream(name)
    data = packets[0]
    n, end = 0, len(data)
    while end > 8:
        size = int.from_bytes(data[end - 8:end - 5], "big")
        end -= size + 8
        n += 1
    assert n == slices and end == 0


# ------------------------------------------------------------- containers

def test_containers_carry_the_extradata_and_keyframes():
    mkv = MkvFile(MKV)
    avi = AviFile(_path("ffv1_48x32.avi"))
    mp4 = Mp4File(_path("ffv1_48x32.mp4"))
    mov = Mp4File(_path("ffv1_48x32.mov"))
    for box in (mkv, avi, mp4, mov):
        assert box.codec == "ffv1" and len(box.dsi) == 42
        assert box.dsi == mkv.dsi
    assert codec_of("FFV1", "x.avi") == "ffv1"
    for name in ("ffv1_48x32.mkv", "ffv1_48x32.avi", "ffv1_48x32.mp4"):
        assert vio.EncodedVideo(_path(name)).keyframes == [0, 12]
    _, packets = _stream("ffv1_48x32.mkv")
    assert [ffv1.is_keyframe(p) for p in packets] == [True] + [False] * 11 \
        + [True, False]


# ------------------------------------------------------------- refusals

def test_damaged_slices_raise_value_error():
    v, packets = _stream("ffv1_48x32.mkv")
    bad = bytearray(packets[0])
    bad[len(bad) // 3] ^= 0x40
    with pytest.raises(ValueError, match="CRC"):
        v._decoder().decode(bytes(bad))
    with pytest.raises(ValueError, match="corrupt FFV1"):
        v._decoder().decode(packets[0][:len(packets[0]) // 2])
    with pytest.raises(ValueError, match="non-key frame"):
        v._decoder().decode(packets[1])
    with pytest.raises(ValueError, match="CRC"):
        ffv1.Decoder(48, 32, v.box.dsi[:-1] + bytes([v.box.dsi[-1] ^ 1]))


def test_corrupt_packets_raise_only_value_error():
    rng = np.random.default_rng(3)
    v, packets = _stream("ffv1_v1_32x24.mkv")
    raised = 0
    for trial in range(60):
        dec = v._decoder()
        for k, pkt in enumerate(packets[:4]):
            data = bytearray(pkt)
            if k == trial % 4:
                if trial % 3 == 0:
                    data = data[:int(rng.integers(0, len(data)))]
                else:
                    for _ in range(int(rng.integers(1, 6))):
                        data[int(rng.integers(0, len(data)))] ^= int(
                            rng.integers(1, 256))
            try:
                dec.decode(bytes(data))
            except ValueError:
                raised += 1
    assert raised > 5


@pytest.mark.parametrize("pix,what", [("yuv422p", "chroma shifts 1,0"),
                                      ("yuv420p10le", "10 bits")])
def test_other_formats_raise_unsupported_naming_item_8(pix, what):
    """libavcodec's 4:2:2 and 10-bit streams (the 10-bit one fed 8-bit
    rows: its samples do not matter, its header does)."""
    sys.path.insert(0, os.path.dirname(__file__))
    from make_video_fixtures import Lavc, moving_clip
    ext, packets = Lavc().encode_ffv1(moving_clip(24, 32, 2, seed=4),
                                      pix=pix, coder=1)
    with pytest.raises(Unsupported, match=f"{what}.*item 8"):
        dec = ffv1.Decoder(32, 24, ext, what=pix)
        for p, _ in packets:
            dec.decode(p)


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["ffv1_48x32.avi", "ffv1_grey_48x32.mkv",
                                  "ffv1_48x32.mov"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=10, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=10, stride=2)))


@pytest.mark.parametrize("name", ["ffv1_48x32.mp4", "ffv1_v2_yuv420_32x24.mkv"])
def test_jax_consecutive_frames_equal(name):
    path = _path(name)
    ds = datasets.ConsecutiveFrames(path, size_hw=(32, 48), stride=2)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(32, 48), stride=2)
    assert ds.index == jds.index
    for i in (0, 1, 2, 9, 4, 11, 6):
        if i < len(ds.index):
            np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                          err_msg=f"pair {i}")


@pytest.mark.parametrize("name", ["ffv1_48x32.mkv", "ffv1_sintel_436x1024.mkv"])
def test_jax_capture_frame_equals(tmp_path, name):
    path = _path(name)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "1", a]) == 0
        assert jcapture.main([path, "1", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))
