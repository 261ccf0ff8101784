"""TIFF behind ``io/video`` (``runtime/tiff``) against OpenCV's FFmpeg and
the JAX package's cv2-based readers: cv2's writer's ``tiff`` in AVI,
Matroska (``V_QUICKTIME``), QuickTime and NUT, and PIL's files as image2
sequences (``%d.tif``).

Tolerance: 0 throughout.  The decoder is FFmpeg's tiff decoder's reading
(PackBits, LZW, Deflate, Predictor 2, both byte orders, strips) and the
conversion swscale's (``runtime/mpeg4.i420_to_bgr`` for its YCbCr 4:2:0,
a copy for RGB, grey replicated, 16-bit grey rounded), so every frame
equals cv2's bit for bit: on the committed fixtures (``tests/goldens/
video``, groups ``tiff`` and ``tiff_seq``), through every seek cv2 makes,
in the JAX package's readers, and on damaged files (no crash: a frame or
``ValueError``).  The library is built once for the module (g++, a few
seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os
import shutil
import struct

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
from opticalflow_tpu_torch.io.nut import NutFile
from opticalflow_tpu_torch.runtime import tiff
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
TIFF = sorted(n for n, e in MANIFEST.items() if e["group"] == "tiff")
SEQ = sorted(n for n, e in MANIFEST.items() if e["group"] == "tiff_seq")


@pytest.fixture(scope="module", autouse=True)
def library():
    return tiff.load()


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


# ---------------------------------------------------------------- fixtures

def test_fixtures_cover_what_cv2_and_pil_write():
    """cv2's writer in the four containers it writes ``tiff`` into; PIL's
    sequences in every compression, grey 8 and 16, big-endian and
    Predictor 2; together well under the fixtures' budget."""
    assert {f"tiff_96x64.{e}" for e in ("avi", "mkv", "mov", "nut")
            } | {"tiff_53x37.avi"} <= set(TIFF)
    assert len(SEQ) == 10 and all(n.endswith("_%d.tif") for n in SEQ)
    total = sum(os.path.getsize(_path(n)) for n in TIFF) + sum(
        os.path.getsize(_path(n % i)) for n in SEQ for i in range(3))
    assert total <= 400_000, total
    reached = {f for n in TIFF + SEQ for f in MANIFEST[n]["tiff_features"]}
    assert reached == set(tiff.FEATURES)


@pytest.mark.parametrize("name", TIFF + SEQ)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", TIFF + SEQ)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """Every picture is a key frame: each seek lands exactly (NUT's too,
    where cv2 counts one frame short)."""
    want = MANIFEST[name]
    assert want["seeks"] == {str(t): t for t in range(want["decoded"])}
    for t, hit in want["seeks"].items():
        assert _digest(vio.read_frame(_path(name), int(t))) == \
            want["sha256"][hit], t


@pytest.mark.parametrize("name", TIFF)
def test_manifest_features_are_the_decoders(name):
    v = vio.EncodedVideo(_path(name))
    dec = v._decoder()
    with open(v.path, "rb") as f:
        for i in range(v.samples):
            dec.decode(v.box.sample(f, i))
    assert dec.features == MANIFEST[name]["tiff_features"]


def test_containers_name_the_codec():
    """riff.c's TIFF tag in any case (cv2's AVI and NUT writers fall back
    to ``tiff``), QuickTime's ``tiff`` entry, and Matroska's V_QUICKTIME
    sample description (matroskadec's get_qt_codec)."""
    boxes = (AviFile(_path("tiff_96x64.avi")), MkvFile(_path("tiff_96x64.mkv")),
             Mp4File(_path("tiff_96x64.mov")), NutFile(_path("tiff_96x64.nut")))
    assert [b.codec for b in boxes] == ["tiff"] * 4
    assert codec_of("TIFF", "x") == codec_of("tiff", "x") == "tiff"


# ------------------------------------------------------- what is refused

def _tiff_file(entries, data=b"\0" * 64, le=True):
    """A one-IFD TIFF: ``entries`` (tag, type, count, value) with SHORT
    and LONG values inline, the image bytes after the IFD."""
    e = "<" if le else ">"
    n = len(entries)
    ifd_end = 8 + 2 + 12 * n + 4
    out = (b"II*\0" if le else b"MM\0*") + struct.pack(e + "I", 8)
    out += struct.pack(e + "H", n)
    for tag, typ, count, value in sorted(entries):
        if value == "data":
            value = ifd_end
        raw = (struct.pack(e + "HH", value, 0) if typ == 3 and count == 1
               else struct.pack(e + "I", value))
        out += struct.pack(e + "HHI", tag, typ, count) + raw
    return out + b"\0" * 4 + data


def _entries(**over):
    base = {256: (3, 1, 8), 257: (3, 1, 8), 258: (3, 1, 8), 259: (3, 1, 1),
            262: (3, 1, 1), 273: (4, 1, "data"), 277: (3, 1, 1),
            278: (3, 1, 8), 279: (4, 1, 64)}
    base.update({int(k[1:]): v for k, v in over.items()})
    return [(t, *v) for t, v in base.items() if v is not None]


@pytest.mark.parametrize("over,what", [
    ({"t322": (3, 1, 8), "t323": (3, 1, 8), "t324": (4, 1, 200),
      "t325": (4, 1, 64)}, "tiles"),
    ({"t259": (3, 1, 7)}, "JPEG compression"),
    ({"t259": (3, 1, 6)}, "JPEG compression"),
    ({"t284": (3, 1, 2)}, "planar configuration 2"),
    ({"t262": (3, 1, 3)}, "a palette"),
    ({"t262": (3, 1, 5), "t277": (3, 1, 4)}, "photometric 5"),
    ({"t262": (3, 1, 0)}, "photometric 0"),
    ({"t339": (3, 1, 3), "t258": (3, 1, 32)}, "float or signed"),
    ({"t258": (3, 1, 4)}, "4 bits a pixel"),
    ({"t262": (3, 1, 6), "t277": (3, 1, 3),
      "t530": (3, 2, 1 | 1 << 16)}, "subsampling 1x1"),
    ({"t266": (3, 1, 2)}, "FillOrder 2"),
    ({"t259": (3, 1, 2)}, "CCITT")])
def test_what_ffmpeg_reads_and_the_port_does_not_raises_item_8(over, what):
    data = _tiff_file(_entries(**over))
    with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
        tiff.Decoder("x.tif").decode(data)


def test_a_handmade_file_reads_as_cv2_reads_it(tmp_path):
    """The hand-built file of the refusal cases reads as cv2 reads it
    where nothing is refused (8x8 grey, one strip, big-endian too)."""
    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, 64, np.uint8).tobytes()
    for le in (True, False):
        path = tmp_path / f"g{int(le)}_0.tif"
        path.write_bytes(_tiff_file(_entries(), img, le))
        pattern = str(tmp_path / f"g{int(le)}_%d.tif")
        _same(list(vio.read_frames(pattern)), _cv2_frames(pattern))


def test_cv2s_ycbcr_pictures_read_as_an_image_sequence(tmp_path):
    """Each picture of cv2's odd-size TIFF AVI written out as a file of a
    ``%d.tif`` sequence: image2 reads its YCbCr 4:2:0 as the container
    path does, and as cv2 reads the sequence."""
    v = vio.EncodedVideo(_path("tiff_53x37.avi"))
    with open(v.path, "rb") as f:
        for i in range(v.samples):
            (tmp_path / f"y_{i}.tif").write_bytes(v.box.sample(f, i))
    pattern = str(tmp_path / "y_%d.tif")
    got = list(vio.read_frames(pattern))
    _same(got, _cv2_frames(pattern))
    _same(got, list(vio.read_frames(_path("tiff_53x37.avi"))))


def test_damaged_files_raise_value_error_or_read():
    """Truncated headers and IFDs raise ``ValueError``; random damage to a
    strip, an IFD or a length never crashes (a frame or ``ValueError``)."""
    dec = tiff.Decoder("x.tif")
    with pytest.raises(ValueError, match="corrupt TIFF"):
        dec.decode(b"II*\0")
    with pytest.raises(ValueError, match="IFD offset past"):
        dec.decode(b"II*\0" + struct.pack("<I", 1000) + bytes(20))
    rng = np.random.default_rng(32)
    sources = [open(_path("tifseq_lzw_rgb_53x37_%d.tif" % 0), "rb").read(),
               open(_path("tifseq_deflate_rgb_53x37_%d.tif" % 1), "rb").read(),
               open(_path("tifseq_pred_gray16_53x37_%d.tif" % 2), "rb").read()]
    v = vio.EncodedVideo(_path("tiff_53x37.avi"))
    with open(v.path, "rb") as f:
        sources.append(v.box.sample(f, 0))
    for src in sources:
        for _ in range(25):
            data = bytearray(src)
            for _ in range(3):
                data[int(rng.integers(0, len(data)))] ^= int(
                    rng.integers(1, 256))
            try:
                dec.decode(bytes(data))
            except ValueError:
                pass


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["tiff_96x64.avi", "tiff_96x64.mkv",
                                  "tifseq_lzw_rgb_53x37_%d.tif",
                                  "tifseq_raw_gray16_53x37_%d.tif"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=10, stride=1)),
          list(jvideo.frame_pairs_from_video(path, max_frames=10, stride=1)))


def test_jax_consecutive_frames_and_capture_frame_over_a_tif_pattern(
        tmp_path):
    """``frames/%06d.tif``, the layout a time-lapse is delivered in:
    ``ConsecutiveFrames`` and ``capture_frame`` give the JAX package's
    pairs and frame."""
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):
        shutil.copy(_path("tifseq_pred_rgb_53x37_%d.tif" % i),
                    frames / f"{i:06d}.tif")
    path = str(frames / "%06d.tif")
    ds = datasets.ConsecutiveFrames(path, size_hw=(37, 53), stride=1)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(37, 53), stride=1)
    assert ds.index == jds.index and len(ds.index) == 2
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "1", a]) == 0
        assert jcapture.main([path, "1", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))
