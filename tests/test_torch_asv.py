"""ASUS V1 and V2 behind ``io/video`` (``runtime/asv``) against OpenCV's
FFmpeg and the JAX package's cv2-based readers, in AVI, Matroska and
QuickTime.

Tolerance: 0 throughout.  The decoder is FFmpeg's integer arithmetic (its
dequantisation over int16 coefficients, the simple IDCT) and the
conversion swscale's (``runtime/mpeg4.i420_to_bgr``), so every frame
equals cv2's bit for bit: on the committed fixtures (``tests/goldens/
video``, group ``asv``: cv2's writer in each container; libavcodec's
encoders at sizes that are not a multiple of 16 and three quantisers, and
without extradata), through every seek cv2 makes and in the JAX package's
readers.  The library is built once for the module (g++, a few seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os
import re

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
from opticalflow_tpu_torch.runtime import asv

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
ASV = sorted(n for n, e in MANIFEST.items() if e["group"] == "asv")
SOURCE = os.path.join(os.path.dirname(asv.__file__), "asv.cpp")


@pytest.fixture(scope="module", autouse=True)
def library():
    return asv.load()


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

def test_fixtures_cover_what_cv2_writes_and_reads():
    """cv2's writer: ASV1 and ASV2 in .avi/.mkv/.mov; the full-width clip
    the card run reads."""
    need = {f"asv_{t}_96x64.{ext}" for t in ("asv1", "asv2")
            for ext in ("avi", "mkv", "mov")}
    need |= {"asv_sintel_436x1024.avi", "asv_asv1_noext_72x40.avi",
             "asv_asv2_noext_72x40.avi"}
    assert need <= set(ASV)
    assert os.path.getsize(_path("asv_sintel_436x1024.avi")) < 1 << 20
    total = sum(os.path.getsize(_path(n)) for n in ASV)
    assert total <= 200_000, total
    assert not any("port_refuses" in MANIFEST[n] for n in ASV)


@pytest.mark.parametrize("name", ASV)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", ASV)
def test_video_info_equals_cv2(name):
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", ASV)
def test_every_seek_reads_the_frame_cv2_reads(name):
    want = MANIFEST[name]
    video = vio.EncodedVideo(_path(name))
    assert want["seeks"] == {str(t): t for t in range(want["decoded"])}
    for t, hit in want["seeks"].items():
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", ASV)
def test_manifest_features_are_the_decoders(name):
    v, packets = _stream(name)
    dec = v._decoder()
    for p in packets:
        dec.decode(p)
    assert dec.features == MANIFEST[name]["asv_features"]


def test_what_each_fixture_reaches_and_what_none_does():
    need = {"asv_asv1_96x64.mov": {"asv1", "escape"},
            "asv_asv2_96x64.mkv": {"asv2"},
            "asv_asv1_noext_72x40.avi": {"default_qscale", "partial_column",
                                         "partial_row"},
            "asv_sintel_436x1024.avi": {"asv2", "partial_row", "escape"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["asv_features"]), name
    reached = {f for n in ASV for f in MANIFEST[n]["asv_features"]}
    assert _MANIFEST["asv_unreached"] == [
        f for f in asv.FEATURES if f not in reached] == []


# ------------------------------------------------------------- the codes

def _table(name):
    """(code, length) pairs of one of asv.cpp's tables."""
    with open(SOURCE) as f:
        src = f.read()
    body = src[src.index(f"{name}["):]
    body = body[body.index("{") + 1:body.index("};")]
    return [(int(c, 0), int(n)) for c, n in
            re.findall(r"\{\s*(0x[0-9A-Fa-f]+|\d+),\s*(\d+)\}", body)]


@pytest.mark.parametrize("name,lsb_first,complete", [
    ("kCcp", False, False), ("kLevel", False, True), ("kDcCcp", True, True),
    ("kAcCcp", True, True), ("kLevel2", True, True)])
def test_code_tables_are_prefix_free(name, lsb_first, complete):
    """The tables read out of libavcodec are prefix codes in the order
    their reader takes the bits (ASV1's from the top bit, ASV2's from bit
    0); the coefficient-pattern and level codes of ASV2 fill their code
    space, as ASV1's level code does; its pattern code leaves 00000
    unused."""
    words = []
    for code, n in _table(name):
        w = format(code, f"0{n}b")
        words.append(w[::-1] if lsb_first else w)
    assert len(set(words)) == len(words)
    assert not any(a != b and b.startswith(a) for a in words for b in words)
    kraft = sum(2.0 ** -len(w) for w in words)
    assert kraft == 1.0 if complete else kraft < 1.0


def test_damaged_packets_raise_value_error():
    v, packets = _stream("asv_asv2_q4_53x37.avi")
    with pytest.raises(ValueError, match="corrupt ASUS V2.*13 bits"):
        v._decoder().decode(packets[0][:5])
    v1, p1 = _stream("asv_asv1_q1_53x37.avi")
    rng = np.random.default_rng(9)
    for video, data0 in ((v, packets[1]), (v1, p1[1])):
        for _ in range(30):   # damage never crashes, nor reads out of bounds
            data = bytearray(data0)
            for _ in range(4):
                data[int(rng.integers(0, len(data)))] ^= int(
                    rng.integers(1, 256))
            try:
                video._decoder().decode(bytes(data))
            except ValueError:
                pass


# ------------------------------------------------------------- containers

def test_containers_carry_the_fourcc_and_extradata():
    """cv2's muxers carry the encoder's 8 bytes of extradata (the inverse
    quantiser, then ASUS) in each container."""
    for tag in ("asv1", "asv2"):
        boxes = (AviFile(_path(f"asv_{tag}_96x64.avi")),
                 MkvFile(_path(f"asv_{tag}_96x64.mkv")),
                 Mp4File(_path(f"asv_{tag}_96x64.mov")))
        for box in boxes:
            assert (box.codec, box.tag) == ("asv", tag.upper())
            assert box.dsi == boxes[0].dsi and box.dsi[4:8] == b"ASUS"
    assert AviFile(_path("asv_asv2_noext_72x40.avi")).dsi == b""
    assert codec_of("asv2", "x.avi") == "asv"


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["asv_asv1_96x64.avi", "asv_asv1_96x64.mkv",
                                  "asv_asv1_96x64.mov", "asv_asv2_96x64.avi",
                                  "asv_asv2_96x64.mkv", "asv_asv2_96x64.mov",
                                  "asv_asv1_q1_53x37.avi"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=10, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=10, stride=2)))


def test_jax_consecutive_frames_equal():
    path = _path("asv_asv2_96x64.mov")
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=1)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=1)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_jax_capture_frame_equals(tmp_path):
    path = _path("asv_sintel_436x1024.avi")
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "1", a]) == 0
        assert jcapture.main([path, "1", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))
