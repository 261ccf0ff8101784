"""JPEG-LS behind ``io/video`` (``runtime/jpegls``) against OpenCV's
FFmpeg, the frames written and the JAX package's cv2-based readers: cv2's
writer's ``MJLS`` in AVI, Matroska, QuickTime, NUT and ASF, and
libavcodec's encoder (through ctypes) for one grey component and for an
LSE marker.

Tolerance: 0 throughout.  JPEG-LS is lossless and the decoder is FFmpeg's
jpegls decoder's integer coding (context modelling, run mode, limited
Golomb codes), its rgb24 handed to cv2 as a copy, so every frame equals
cv2's and the frame written, bit for bit: on the committed fixtures
(``tests/goldens/video``, group ``jpegls``), through every seek cv2 makes,
in the JAX package's readers, and on damaged files (no crash: a frame or
``ValueError``).  The library is built once for the module (g++, a few
seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from opticalflow_tpu import video as jvideo
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.asf import AsfFile
from opticalflow_tpu_torch.io.avi import AviFile, codec_of
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.io.nut import NutFile
from opticalflow_tpu_torch.runtime import jpegls
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
JLS = sorted(n for n, e in MANIFEST.items() if e["group"] == "jpegls")


@pytest.fixture(scope="module", autouse=True)
def library():
    return jpegls.load()


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


def _packet(name, i=0):
    v = vio.EncodedVideo(_path(name))
    with open(v.path, "rb") as f:
        return v.box.sample(f, i)


def test_fixtures_cover_what_cv2_writes_and_the_encoders_layouts():
    assert {f"jpegls_96x64.{e}" for e in ("avi", "mkv", "mov", "nut", "wmv")
            } | {"jpegls_gray_53x37.avi", "jpegls_lse_96x64.avi",
                 "jpegls_sintel_436x1024.avi"} <= set(JLS)
    assert os.path.getsize(_path("jpegls_sintel_436x1024.avi")) < 400_000
    assert sum(os.path.getsize(_path(n)) for n in JLS) <= 700_000
    reached = {f for n in JLS for f in MANIFEST[n]["jpegls_features"]}
    assert reached == set(jpegls.FEATURES)


@pytest.mark.parametrize("name", JLS)
def test_frames_equal_cv2_the_manifest_and_the_frames_written(name):
    """Lossless: the frames read equal cv2's and the ones written (their
    digests in the manifest), in cv2's component order."""
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    digests = [_digest(f) for f in got]
    assert digests == MANIFEST[name]["sha256"]
    assert digests == MANIFEST[name]["written_sha256"]
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", JLS)
def test_every_seek_reads_the_frame_cv2_reads(name):
    want = MANIFEST[name]
    assert want["seeks"] == {str(t): t for t in range(want["decoded"])}
    video = vio.EncodedVideo(_path(name))
    for t, hit in want["seeks"].items():
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", JLS)
def test_manifest_features_are_the_decoders(name):
    v = vio.EncodedVideo(_path(name))
    dec = v._decoder()
    with open(v.path, "rb") as f:
        for i in range(v.samples):
            dec.decode(v.box.sample(f, i))
    assert dec.features == MANIFEST[name]["jpegls_features"]


def test_containers_name_the_codec():
    boxes = [cls(_path(f"jpegls_96x64.{e}")) for cls, e in (
        (AviFile, "avi"), (MkvFile, "mkv"), (Mp4File, "mov"),
        (NutFile, "nut"), (AsfFile, "wmv"))]
    assert [b.codec for b in boxes] == ["jpegls"] * 5
    assert codec_of("mjls", "x") == "jpegls"


def _sos(packet):
    return packet.index(b"\xff\xda")


@pytest.mark.parametrize("how,what", [
    ("near", "near-lossless"), ("ilv2", "ILV 2"), ("palette", "palette"),
    ("bits", "12-bit"), ("dri", "restart intervals"),
    ("oversize", "LSE type 4")])
def test_what_the_port_does_not_read_raises_item_8(how, what):
    p = bytearray(_packet("jpegls_96x64.avi"))
    s = _sos(p)
    if how == "near":
        p[s + 4 + 2 * 3 + 1] = 2
    elif how == "ilv2":
        p[s + 4 + 2 * 3 + 2] = 2
    elif how == "palette":
        p[s:s] = b"\xff\xf8\x00\x05\x02\x01\x03"
    elif how == "oversize":
        p[s:s] = b"\xff\xf8\x00\x03\x04"
    elif how == "bits":
        p[p.index(b"\xff\xf7") + 4] = 12
    else:
        p[s:s] = b"\xff\xdd\x00\x04\x00\x10"
    with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
        jpegls.Decoder("x").decode(bytes(p))


def test_damaged_pictures_raise_value_error_or_read():
    dec = jpegls.Decoder("x")
    with pytest.raises(ValueError, match="no SOI"):
        dec.decode(b"\0\0\0\0")
    with pytest.raises(ValueError, match="corrupt JPEG-LS"):
        dec.decode(_packet("jpegls_96x64.avi")[:60])
    rng = np.random.default_rng(41)
    for src in (_packet("jpegls_96x64.avi", 1), _packet("jpegls_gray_53x37.avi"),
                _packet("jpegls_lse_96x64.avi")):
        for _ in range(25):
            data = bytearray(src)
            for _ in range(3):
                data[int(rng.integers(0, len(data)))] ^= int(
                    rng.integers(1, 256))
            try:
                dec.decode(bytes(data))
            except ValueError:
                pass


@pytest.mark.parametrize("name", ["jpegls_96x64.mov", "jpegls_gray_53x37.avi"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=10, stride=1)),
          list(jvideo.frame_pairs_from_video(path, max_frames=10, stride=1)))
