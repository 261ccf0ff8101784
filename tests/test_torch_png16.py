"""16-bit PNG image sequences read as ``cv2.VideoCapture`` reads them:
FFmpeg's PNG decoder hands over rgb48be, rgba64be, gray16be or ya16be,
and swscale converts them to BGR24; the port reproduces that conversion
(``runtime/mpeg4.rgb48_to_bgr``, ``ffmpeg_dsp.h``'s ``rgb48_to_bgr``)
behind ``io/video``.  Against cv2 itself and the JAX package's cv2-based
readers.

Tolerance: 0 throughout.  swscale's path for 16-bit colour goes through
its internal video-range YUV at 15 bits and back (full chroma), which
rounds each sample off by ±1 about one time in 26; the port follows it
integer for integer, so every pixel equals cv2's.  The conversion is
pixel-local, so the committed sheet of 65,536 random triples
(``tests/goldens/video/png16_triples_256x256_0.png``) pins it triple by
triple; the manifest holds cv2's digests for the GPU machine.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.images import decode_png, encode_png
from opticalflow_tpu_torch.runtime import mpeg4

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
PNG16 = sorted(n for n in MANIFEST if n.startswith("png16_"))
SHEET = os.path.join(FIXTURES, "png16_triples_256x256_%d.png")


def _cv2_all(path):
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


def reference_rgb48_to_bgr(rgb: np.ndarray) -> np.ndarray:
    """swscale's rgb48 → BGR24 in numpy, from its C code: rgb48ToY_c /
    rgb48ToUV_c (BT.601 at video range, RGB2YUV_SHIFT 15), hScale16To15's
    identity filter, yuv2rgb_write_full's BGR24 with
    ff_yuv2rgb_c_init_tables' video-range coefficients."""
    s = 1 << 15
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    y = (int(0.299 * 219 / 255 * s + 0.5) * r
         + int(0.587 * 219 / 255 * s + 0.5) * g
         + int(0.114 * 219 / 255 * s + 0.5) * b + (0x2001 << 14)) >> 15
    u = (-int(0.169 * 224 / 255 * s + 0.5) * r
         - int(0.331 * 224 / 255 * s + 0.5) * g
         + int(0.500 * 224 / 255 * s + 0.5) * b + (0x10001 << 14)) >> 15
    v = (int(0.500 * 224 / 255 * s + 0.5) * r
         - int(0.419 * 224 / 255 * s + 0.5) * g
         - int(0.081 * 224 / 255 * s + 0.5) * b + (0x10001 << 14)) >> 15
    y, u, v = (np.minimum(c >> 1, 32767) for c in (y, u, v))
    yy = (y * 4 - (16 << 9)) * 9539 + (1 << 21)
    uu, vv = (u - (128 << 7)) * 4, (v - (128 << 7)) * 4
    out = np.stack([yy + uu * 16525, yy + vv * -6660 + uu * -3209,
                    yy + vv * 13075], -1)
    big = ((out < 0) | (out >= 1 << 30)).any(-1, keepdims=True)
    out = np.where(big, np.clip(out, 0, (1 << 30) - 1), out)
    return (out >> 22).astype(np.uint8)


def _ya16_png(grey: np.ndarray, alpha: np.ndarray) -> bytes:
    """A colour type 4 (grey + alpha) 16-bit PNG, written by hand."""
    h, w = grey.shape
    raw = np.stack([grey, alpha], -1).astype(">u2").reshape(h, w * 2)
    rows = b"".join(b"\0" + r.tobytes() for r in raw)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 4, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------- fixtures

def test_fixtures_are_the_three_sequences():
    assert PNG16 == ["png16_rgb_53x37_%d.png", "png16_rgba_53x37_%d.png",
                     "png16_triples_256x256_%d.png"]
    img = decode_png(open(SHEET % 0, "rb").read())
    assert img.dtype == np.uint16 and img.shape == (256, 256, 3)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) == 65536


@pytest.mark.parametrize("name", PNG16)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = os.path.join(FIXTURES, name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_all(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", PNG16)
def test_video_info_equals_cv2(name):
    path = os.path.join(FIXTURES, name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


# ----------------------------------------------------------- the rule

def test_conversion_equals_swscales_arithmetic_in_numpy():
    """The C conversion equals the numpy transcription of swscale's code on
    the committed sheet, random triples, RGBA (alpha ignored) and the
    extremes."""
    rng = np.random.default_rng(16)
    sheet = decode_png(open(SHEET % 0, "rb").read())
    rnd = rng.integers(0, 65536, (64, 128, 3), dtype=np.uint16)
    edge = np.array([0, 1, 255, 256, 32767, 32768, 65279, 65280, 65534,
                     65535], np.uint16)
    ext = np.array(np.meshgrid(edge, edge, edge)).reshape(3, -1).T[None]
    for rgb in (sheet, rnd, ext):
        np.testing.assert_array_equal(mpeg4.rgb48_to_bgr(rgb),
                                      reference_rgb48_to_bgr(rgb))
    rgba = np.concatenate([rnd, rng.integers(0, 65536, rnd.shape[:2] + (1,),
                                             dtype=np.uint16)], -1)
    np.testing.assert_array_equal(mpeg4.rgb48_to_bgr(rgba),
                                  mpeg4.rgb48_to_bgr(rnd))
    with pytest.raises(ValueError):
        mpeg4.rgb48_to_bgr(rnd[..., :2])


def test_rounding_is_not_a_shift():
    """swscale's round trip misses ``(x + 128) >> 8`` for about 1 sample
    in 26, R and B more often than G: the reason 16-bit colour cannot be
    rounded sample by sample as 16-bit grey is."""
    sheet = decode_png(open(SHEET % 0, "rb").read())
    got = mpeg4.rgb48_to_bgr(sheet)[..., ::-1].astype(np.int64)
    naive = np.minimum((sheet.astype(np.int64) + 128) >> 8, 255)
    miss = (got != naive).mean((0, 1))
    assert 0.02 < miss.mean() < 0.06 and miss[0] > 2 * miss[1] < miss[2]
    assert np.abs(got - naive).max() == 1


@pytest.mark.parametrize("kind", ["rgb", "rgba", "grey", "grey_alpha"])
def test_every_16bit_flavour_reads_as_cv2(tmp_path, kind):
    """Extremes and a full ramp in each 16-bit PNG flavour FFmpeg's decoder
    hands over (rgb48be, rgba64be, gray16be, ya16be) against live cv2:
    grey and grey+alpha rounded to 8 bits as before, colour through YUV."""
    ramp = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    if kind in ("rgb", "rgba"):
        img = np.stack([ramp, ramp.T, ramp[::-1]], -1)
        if kind == "rgba":
            img = np.concatenate([img, ramp[..., None] ^ 0x5A5A], -1)
        data = encode_png(img)
    elif kind == "grey":
        data = encode_png(ramp)
    else:
        data = _ya16_png(ramp, ramp.T)
    (tmp_path / "1.png").write_bytes(data)
    path = str(tmp_path / "%d.png")
    _same(list(vio.read_frames(path)), _cv2_all(path))


# ------------------------------------------------------- the JAX package

def test_jax_frame_pairs_from_video_equal_read_frames():
    path = os.path.join(FIXTURES, "png16_rgba_53x37_%d.png")
    _same(list(vio.read_frames(path)),
          list(jvideo.frame_pairs_from_video(path)))


def test_jax_consecutive_frames_equal():
    path = os.path.join(FIXTURES, "png16_rgb_53x37_%d.png")
    ds = datasets.ConsecutiveFrames(path, size_hw=(32, 48))
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(32, 48))
    assert ds.index == jds.index and len(ds.index) == 1
    np.testing.assert_array_equal(ds[0]["images"], jds[0]["images"])


def test_jax_capture_frame_equals(tmp_path):
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([SHEET, "0", a]) == 0
        assert jcapture.main([SHEET, "0", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))
