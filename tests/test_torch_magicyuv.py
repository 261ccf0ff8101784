"""MagicYUV behind ``io/video`` (``runtime/magicyuv``) against OpenCV's
FFmpeg and the JAX package's cv2-based readers, in AVI, Matroska and
QuickTime.

Tolerance: 0 throughout.  MagicYUV is lossless integer coding and the
conversions are byte copies (GBR(A)P → BGR24, grey replicated) or
swscale's YUV arithmetic (``runtime/mpeg4.yuv_to_bgr``), so every frame
equals cv2's bit for bit: on the committed fixtures (``tests/goldens/
video``, group ``magicyuv``: cv2's writer in each container; libavcodec's
encoder for every 8-bit layout and predictor, slices at odd sizes;
headers rewritten to BT.709, full range, no predictor and a raw slice),
through every seek cv2 makes and in the JAX package's readers.  The
library is built once for the module (g++, a few seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os
import struct
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
from opticalflow_tpu_torch.runtime import magicyuv
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
MAGY = sorted(n for n, e in MANIFEST.items() if e["group"] == "magicyuv")


@pytest.fixture(scope="module", autouse=True)
def library():
    return magicyuv.load()


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


def _packets(name):
    v = vio.EncodedVideo(_path(name))
    with open(v.path, "rb") as f:
        return [v.box.sample(f, i) for i in range(v.samples)]


def _make():
    sys.path.insert(0, os.path.dirname(__file__))
    import make_video_fixtures
    return make_video_fixtures


# ---------------------------------------------------------------- fixtures

def test_fixtures_cover_what_cv2_writes_and_reads():
    """cv2's writer: M8Y0 in .avi/.mkv/.mov; libavcodec's every 8-bit
    layout and predictor; the full-width clip the card run reads."""
    need = {f"magy_96x64.{ext}" for ext in ("avi", "mkv", "mov")}
    need |= {f"magy_{pix}_{pred}_48x32.avi"
             for pix in ("gbrp", "gbrap", "yuv444p", "yuv422p", "yuv420p",
                         "yuva444p", "gray")
             for pred in ("left", "gradient", "median")}
    need |= {"magy_sintel_436x1024.avi", "magy_raw_slice_yuv444p_48x32.avi"}
    assert need <= set(MAGY)
    assert os.path.getsize(_path("magy_sintel_436x1024.avi")) < 1 << 20
    total = sum(os.path.getsize(_path(n)) for n in MAGY)
    assert total <= 700_000, total
    assert not any("port_refuses" in MANIFEST[n] for n in MAGY)


@pytest.mark.parametrize("name", MAGY)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", MAGY)
def test_video_info_equals_cv2(name):
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", MAGY)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """Every packet is a key frame: each seek reads its own frame, as
    cv2's does."""
    want = MANIFEST[name]
    video = vio.EncodedVideo(_path(name))
    assert want["seeks"] == {str(t): t for t in range(want["decoded"])}
    for t, hit in want["seeks"].items():
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", MAGY)
def test_manifest_features_are_the_decoders(name):
    dec = magicyuv.Decoder()
    for p in _packets(name):
        dec.decode(p)
    assert dec.features == MANIFEST[name]["magicyuv_features"]


def test_what_each_fixture_reaches_and_what_none_does():
    need = {"magy_96x64.mov": {"left", "yuv420"},
            "magy_gbrap_gradient_48x32.avi": {"gradient", "gbrap"},
            "magy_yuva444p_median_48x32.avi": {"median", "yuva444"},
            "magy_gray_median_slices2_53x37.avi": {"gray", "slices",
                                                   "odd_size"},
            "magy_bt709_full_yuv420p_48x32.avi": {"bt709", "full_range"},
            "magy_nopred_yuv420p_48x32.avi": {"other_pred"},
            "magy_raw_slice_yuv444p_48x32.avi": {"raw_slice", "yuv444"},
            "magy_gbrp_median_slices3_53x37.avi": {"gbrp", "slices"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["magicyuv_features"]), name
    reached = {f for n in MAGY for f in MANIFEST[n]["magicyuv_features"]}
    assert _MANIFEST["magicyuv_unreached"] == [
        f for f in magicyuv.FEATURES if f not in reached] == []


# ------------------------------------------------------------- containers

def test_containers_carry_the_fourcc():
    """cv2 writes M8Y0 under each container's AVI fourcc (Matroska's
    V_MS/VFW/FOURCC, QuickTime's sample entry); FFmpeg maps riff.c's
    MagicYUV tags in any case."""
    for box in (AviFile(_path("magy_96x64.avi")),
                MkvFile(_path("magy_96x64.mkv")),
                Mp4File(_path("magy_96x64.mov"))):
        assert (box.codec, box.tag) == ("magicyuv", "M8Y0")
    for tag in ("M8Y0", "M8RG", "M8RA", "M8G0", "M8Y2", "M8Y4", "M8YA",
                "MAGY", "m8y0", "M0Y2"):
        assert codec_of(tag, "x.avi") == "magicyuv", tag
    assert vio.EncodedVideo(_path("magy_96x64.mkv")).keyframes == [0, 1, 2]
    assert magicyuv.frame_size(_packets("magy_96x64.avi")[0]) == (96, 64)
    assert magicyuv.frame_size(b"MAGX" + bytes(40)) is None


def test_other_magicyuv_fourccs_write_the_same_stream(tmp_path):
    """cv2 picks the pixel format, not the fourcc: M8RG and M8G0 give
    M8Y0's 4:2:0 frames."""
    frames = _make().moving_clip(32, 48, 2, seed=7)
    want = None
    for fourcc in ("M8Y0", "M8RG", "M8G0"):
        path = str(tmp_path / f"{fourcc}.avi")
        _make()._cv2_write(path, frames, fourcc)
        got = list(vio.read_frames(path))
        _same(got, _cv2_frames(path))
        want = want or got
        _same(got, want)


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("patch,what", [
    (lambda p: p[:9] + bytes([0x6c]) + p[10:], "10-bit"),
    (lambda p: p[:9] + bytes([0x76]) + p[10:], "10-bit"),
    (lambda p: p[:9] + bytes([0x6f]) + p[10:], "12-bit"),
    (lambda p: p[:9] + bytes([0x71]) + p[10:], "14-bit"),
    (lambda p: p[:12] + bytes([p[12] | 2]) + p[13:], "interlaced")])
def test_layouts_left_out_raise_unsupported_naming_item_8(patch, what):
    packet = _packets("magy_yuv422p_left_48x32.avi")[0]
    with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
        magicyuv.Decoder(what="crafted").decode(patch(packet))


def test_left_out_layouts_raise_through_the_readers(tmp_path):
    packets = _packets("magy_yuv420p_left_48x32.avi")
    path = str(tmp_path / "interlaced.avi")
    _make().lossless_avi(path, [_make().magy_with(p, flags=2)
                                for p in packets], 48, 32, "M8Y0")
    with pytest.raises(Unsupported, match=f"interlaced.*{ITEM_8}"):
        list(vio.read_frames(path))


def test_damaged_packets_raise_value_error():
    packets = _packets("magy_yuv420p_median_slices5_53x37.avi")
    dec = magicyuv.Decoder()
    for bad, match in ((packets[0][:30], "shorter"),
                       (b"MAGX" + packets[0][4:], "MAGY"),
                       (packets[0][:8] + b"\x06" + packets[0][9:], "version"),
                       (packets[0][:200], "past the packet")):
        with pytest.raises(ValueError, match=f"corrupt MagicYUV.*{match}"):
            magicyuv.Decoder().decode(bad)
    dec.decode(packets[0])
    rng = np.random.default_rng(5)
    for _ in range(30):     # damage never crashes, nor reads out of bounds
        data = bytearray(packets[1])
        for _ in range(4):
            data[int(rng.integers(0, len(data)))] ^= int(rng.integers(1, 256))
        try:
            magicyuv.Decoder().decode(bytes(data))
        except ValueError:
            pass


def test_header_fields_are_where_ffmpeg_reads_them():
    p = _packets("magy_bt709_full_yuv420p_48x32.avi")[0]
    assert p[:4] == b"MAGY" and p[8] == 7 and p[9] == 0x69
    assert (p[11], p[12]) == (2, 4)
    assert struct.unpack("<IIII", p[16:32]) == (48, 32, 48, 32)
    dec = magicyuv.Decoder()
    y, u, v = dec.decode(p)
    assert (dec.matrix, dec.full_range, dec.shifts) == ("bt709", True,
                                                         (1, 1))
    assert y.shape == (32, 48) and u.shape == v.shape == (16, 24)


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["magy_96x64.avi", "magy_96x64.mkv",
                                  "magy_96x64.mov",
                                  "magy_gbrap_median_48x32.avi",
                                  "magy_yuv422p_median_slices3_53x37.avi"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=10, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=10, stride=2)))


def test_jax_consecutive_frames_equal():
    path = _path("magy_yuv444p_gradient_48x32.avi")
    ds = datasets.ConsecutiveFrames(path, size_hw=(32, 48), stride=1)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(32, 48), stride=1)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_jax_capture_frame_equals(tmp_path):
    path = _path("magy_sintel_436x1024.avi")
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "1", a]) == 0
        assert jcapture.main([path, "1", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))
