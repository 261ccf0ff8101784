"""A census of what ``cv2.VideoWriter`` writes here against the port's
reader: every (fourcc, container) pair that cv2's writer opens and whose
file ``cv2.VideoCapture`` reads back at least one frame from, each with
the outcome the port must give.

``READ_EQUAL`` pairs read through ``io.video.read_frames`` to cv2's frames
bit for bit (count and pixels); ``REFUSED`` pairs would raise
``Unsupported`` naming ROADMAP Queue 1 item 8, and none is left: SpeedHQ,
JPEG-LS, TIFF and VP9 in FLV, the last ones, are read.  Each case writes a 96x64 clip of 3
frames of seeded blurred noise into ``tmp_path`` with cv2 and reads it
with both; cv2's writer picks the codec's tag itself where a container
refuses the fourcc (its "fallback" tags), which is the file a user gets.
The table was made by scanning fourccs by the codecs libavcodec here
encodes against the extensions cv2 writes (``.avi``, ``.mkv``, ``.mov``,
``.mp4``, ``.nut``, ``.wmv``, ``.flv``, ``.webm``, ``.ts``, ``.mpg``,
``.3gp``); a pair cv2 cannot write or reads nothing from is left out, and
so is H.263, whose encoder takes only the standard sizes.  A pair moving
from ``REFUSED`` to ``READ_EQUAL`` is how a later slice shows its codec;
a claim that the reader side is done has to empty ``REFUSED``.

Tolerance: 0.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.avi import codec_of
from opticalflow_tpu_torch.io.video import read_frames
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
# the committed files of the repaired tags and layouts (group tag)
TAGS = sorted(n for n, e in MANIFEST.items() if e["group"] == "tag")

_ALL6 = ("avi", "mkv", "mov", "mp4", "nut", "wmv")
_NO_MP4 = ("avi", "mkv", "mov", "nut", "wmv")
_RAW = ("avi", "mkv", "nut", "wmv")
_MPEG4 = _ALL6 + ("mpg", "3gp")
_MPEG12 = _ALL6 + ("mpg",)

# fourcc -> the extensions whose files the port reads equal to cv2
READ_EQUAL = {
    "mp4v": _MPEG4, "XVID": _MPEG4, "DIVX": _MPEG4, "DX50": _MPEG4,
    "FMP4": _MPEG4, "3IV2": _MPEG4,
    "MJPG": _ALL6, "LJPG": _ALL6, "MJ2C": _ALL6, "mjp2": _ALL6,
    "MPNG": _ALL6, "PNG1": _ALL6, "png ": _ALL6, "FFV1": _ALL6,
    "mpg1": _MPEG12, "PIM1": _MPEG12, "MPEG": _MPEG12, "mpg2": _MPEG12,
    "PIM2": _MPEG12,
    "drac": _ALL6 + ("ts",),
    "VP80": ("avi", "mkv", "nut", "wmv", "webm"),
    "VP90": ("avi", "mkv", "mp4", "nut", "wmv", "webm", "flv"),
    "VP09": ("avi", "mkv", "mp4", "nut", "wmv", "webm", "flv"),
    "SHQ0": _NO_MP4, "MJLS": _NO_MP4, "tiff": ("avi", "mkv", "mov", "nut"),
    "FLV1": _NO_MP4 + ("flv",), "s263": _RAW + ("flv",),
    "MP42": _NO_MP4, "DIV3": _NO_MP4, "WMV1": _NO_MP4, "WMV2": _NO_MP4,
    "SNOW": _NO_MP4, "HFYU": _NO_MP4, "FFVH": _NO_MP4, "ASV1": _NO_MP4,
    "ASV2": _NO_MP4, "yuv4": _NO_MP4, "RGBA": _NO_MP4,
    **{t: _NO_MP4 for t in ("ULY0", "ULY2", "ULY4", "ULRG", "ULRA", "ULH0",
                             "ULH2", "ULH4", "M8Y0", "M8Y2", "M8Y4", "M8RG",
                             "M8RA", "M8G0", "MAGY")},
    **{t: _RAW for t in ("I420", "IYUV", "YV12", "Y800", "GREY", "Y8  ",
                         "NV12", "Y41B", "\0\0\0\0")},
}
# fourcc -> the extensions whose files the port refuses, naming item 8
REFUSED: dict = {}

CASES = ([(f, e, "read equal") for f, exts in READ_EQUAL.items()
          for e in exts]
         + [(f, e, "refused") for f, exts in REFUSED.items() for e in exts])


def _clip():
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.integers(0, 256, (200, 260, 3), np.uint8),
                            (0, 0), 3)
    return [base[10 + 2 * t:74 + 2 * t, 10 + 3 * t:106 + 3 * t].copy()
            for t in range(3)]


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            cap.release()
            return out
        out.append(frame)


def test_the_census_covers_the_slices_codecs_and_the_refused_ones():
    """Every codec the port reads through a fourcc cv2 writes is in the
    table, JPEG 2000, the repaired tags and raw layouts, SpeedHQ, JPEG-LS,
    TIFF and VP9 in FLV among them; no pair is refused: the reader side is
    done."""
    assert {"MJ2C", "mjp2", "3IV2", "LJPG", "NV12", "Y41B", "Y8  ",
            "yuv4", "SHQ0", "MJLS", "tiff"} <= set(READ_EQUAL)
    assert "flv" in READ_EQUAL["VP90"] and "flv" in READ_EQUAL["VP09"]
    assert REFUSED == {}
    assert len(CASES) == len({(f, e) for f, e, _ in CASES})


@pytest.mark.parametrize("fourcc,ext,outcome", CASES,
                         ids=[f"{f.strip() or 'raw'}-{e}" for f, e, _ in CASES])
def test_cv2_writers_file_reads_as_the_census_says(tmp_path, fourcc, ext,
                                                   outcome):
    path = os.path.join(str(tmp_path), f"clip.{ext}")
    code = 0 if fourcc == "\0\0\0\0" else cv2.VideoWriter_fourcc(*fourcc)
    writer = cv2.VideoWriter(path, code, 25.0, (96, 64))
    assert writer.isOpened(), (fourcc, ext)
    for frame in _clip():
        writer.write(frame)
    writer.release()
    want = _cv2_frames(path)
    assert want, f"cv2 reads nothing of its own {fourcc!r} .{ext} file"
    if outcome == "refused":
        with pytest.raises(Unsupported, match=ITEM_8):
            list(read_frames(path))
        return
    got = list(read_frames(path))
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")


def _digest(frame):
    return hashlib.sha256(np.ascontiguousarray(frame).tobytes()).hexdigest()


def test_riff_tags_name_their_codecs():
    """riff.c's tags the census repaired, as FFmpeg picks the codec from a
    BITMAPINFOHEADER (AVI, Matroska's V_MS/VFW/FOURCC, NUT, ASF)."""
    assert codec_of("3IV2", "x") == codec_of("3iv2", "x") == "mpeg4"
    assert codec_of("LJPG", "x") == "mjpeg"
    assert codec_of("yuv4", "x") == "yuv4"
    for tag in ("NV12", "Y41B", "Y8  "):
        assert codec_of(tag, "x") == "raw", tag


@pytest.mark.parametrize("name", TAGS)
def test_tag_fixtures_read_as_cv2_reads_them(name):
    """The committed files of the repaired tags and layouts (cv2's writer,
    64x48): frames, fps, size and count as the manifest records cv2's,
    and each recorded seek's frame."""
    want = MANIFEST[name]
    path = os.path.join(FIXTURES, name)
    assert [_digest(f) for f in read_frames(path)] == want["sha256"]
    assert vio.video_info(path) == {k: want[k] for k in (
        "fps", "width", "height", "frames")}
    video = vio.EncodedVideo(path)
    for t, hit in want["seeks"].items():
        assert hit is not None
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t
