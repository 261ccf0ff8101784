"""SpeedHQ behind ``io/video`` (``runtime/speedhq``) against OpenCV's
FFmpeg, libavcodec's own planes and the JAX package's cv2-based readers:
cv2's writer's ``SHQ0`` in AVI, Matroska, QuickTime, NUT and ASF.

Tolerance: 0 throughout.  The decoder is FFmpeg's speedhq decoder's
integer arithmetic (its little-endian VLCs, dequantisation over int16
coefficients, the simple IDCT) and the conversion swscale's
(``runtime/mpeg4.i420_to_bgr``, chroma sited at the centre), so every
frame equals cv2's bit for bit, and every plane libavcodec's (digests in
the manifest, taken through ctypes): on the committed fixtures
(``tests/goldens/video``, group ``speedhq``), through every seek cv2
makes, in the JAX package's readers, and on damaged packets (no crash: a
frame or ``ValueError``).  The library is built once for the module (g++,
a few seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import hashlib
import json
import os
import re

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
from opticalflow_tpu_torch.runtime import speedhq
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
SHQ = sorted(n for n, e in MANIFEST.items() if e["group"] == "speedhq")
SOURCE = os.path.join(os.path.dirname(speedhq.__file__), "speedhq.cpp")


@pytest.fixture(scope="module", autouse=True)
def library():
    return speedhq.load()


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


def test_fixtures_cover_what_cv2_writes():
    assert {f"speedhq_96x64.{e}" for e in ("avi", "mkv", "mov", "nut", "wmv")
            } | {"speedhq_96x37.avi", "speedhq_noise_176x144.avi",
                 "speedhq_sintel_436x1024.avi"} <= set(SHQ)
    assert sum(os.path.getsize(_path(n)) for n in SHQ) <= 200_000
    reached = {f for n in SHQ for f in MANIFEST[n]["speedhq_features"]}
    assert reached == set(speedhq.FEATURES)


@pytest.mark.parametrize("name", SHQ)
def test_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", SHQ)
def test_planes_equal_libavcodecs(name):
    """Each packet's planes against libavcodec's (through ctypes, when the
    fixtures were made): the decoder alone, before the conversion."""
    v, packets = _stream(name)
    dec = v._decoder()
    digests = [hashlib.sha256(b"".join(np.ascontiguousarray(p).tobytes()
                                       for p in dec.decode(pk))).hexdigest()
               for pk in packets]
    assert digests == MANIFEST[name]["speedhq_planes"]
    assert dec.features == MANIFEST[name]["speedhq_features"]


@pytest.mark.parametrize("name", SHQ)
def test_every_seek_reads_the_frame_cv2_reads(name):
    want = MANIFEST[name]
    assert want["seeks"] == {str(t): t for t in range(want["decoded"])}
    video = vio.EncodedVideo(_path(name))
    for t, hit in want["seeks"].items():
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t


def test_containers_name_the_codec():
    boxes = [cls(_path(f"speedhq_96x64.{e}")) for cls, e in (
        (AviFile, "avi"), (MkvFile, "mkv"), (Mp4File, "mov"),
        (NutFile, "nut"), (AsfFile, "wmv"))]
    assert [(b.codec, b.tag.upper()) for b in boxes] == [
        ("speedhq", "SHQ0")] * 5
    assert codec_of("shq2", "x") == "speedhq"


def test_the_ac_code_is_prefix_free_and_mpeg2s_first_codes_reversed():
    """speedhq.c's codes as read (each reversed: the reader takes bit 0
    first) are a prefix code; its shortest ones are MPEG-2's table B-15
    codes (run 0, levels 1-3; the escape 000001 and end of block 0110)."""
    with open(SOURCE) as f:
        src = f.read()
    body = src[src.index("kAc[123]"):]
    body = body[body.index("{") + 1:body.index("};")]
    codes = [(int(c, 16), int(n)) for c, n in
             re.findall(r"\{0x([0-9A-F]+), (\d+)\}", body)]
    assert len(codes) == 123
    words = [format(c, f"0{n}b")[::-1] for c, n in codes]
    assert len(set(words)) == len(words)
    assert not any(a != b and b.startswith(a) for a in words for b in words)
    assert words[:3] == ["10", "110", "0111"]
    assert words[-2:] == ["000001", "0110"]


@pytest.mark.parametrize("tag", ["SHQ1", "SHQ2", "SHQ4", "SHQ7", "SHQ9"])
def test_other_layouts_raise_item_8(tag):
    with pytest.raises(Unsupported, match=f"{tag}.*{ITEM_8}"):
        speedhq.Decoder(96, 64, tag, what="x")


def test_interlaced_and_narrow_pictures_raise_item_8():
    _, packets = _stream("speedhq_96x64.avi")
    p = bytearray(packets[0])
    p[1:4] = (40).to_bytes(3, "little")      # a second field at byte 40
    with pytest.raises(Unsupported, match=f"two fields.*{ITEM_8}"):
        speedhq.Decoder(96, 64, what="x").decode(bytes(p))
    with pytest.raises(Unsupported, match=f"multiple of 16.*{ITEM_8}"):
        speedhq.Decoder(104, 64, what="x").decode(packets[0])


def test_damaged_packets_raise_value_error_or_read():
    _, packets = _stream("speedhq_noise_176x144.avi")
    dec = speedhq.Decoder(176, 144, what="x")
    with pytest.raises(ValueError, match="corrupt SpeedHQ"):
        dec.decode(packets[0][:3])
    with pytest.raises(ValueError, match="quality 100"):
        dec.decode(b"\x64" + packets[0][1:])
    rng = np.random.default_rng(51)
    for src in packets[:2]:
        for _ in range(25):
            data = bytearray(src)
            for _ in range(3):
                data[int(rng.integers(0, len(data)))] ^= int(
                    rng.integers(1, 256))
            try:
                dec.decode(bytes(data))
            except ValueError:
                pass


@pytest.mark.parametrize("name", ["speedhq_96x64.mkv", "speedhq_96x37.avi"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=10, stride=1)),
          list(jvideo.frame_pairs_from_video(path, max_frames=10, stride=1)))
