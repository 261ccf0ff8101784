"""Lossless intra video behind ``io/video`` against OpenCV's FFmpeg and the
JAX package's cv2-based readers: HuffYUV and FFVHuff (``runtime/huffyuv``),
Ut Video (``runtime/utvideo``) and PNG in AVI, Matroska and QuickTime, PNG
in MP4, Motion JPEG in QuickTime, and raw Y800/GREY/YV12/RGBA and 32-bit
BI_RGB.

Tolerance: 0 throughout.  The codecs are lossless integer coding and the
conversions byte copies (packed and planar RGB → BGR24, grey replicated)
or swscale's YUV arithmetic (``runtime/mpeg4.yuv_to_bgr``), so every frame
equals cv2's bit for bit: on the committed fixtures
(``tests/goldens/video``, group ``lossless``: cv2's writer in each
container; libavcodec's encoders for every HuffYUV/FFVHuff predictor and
layout, the classic tables, interlaced lines, per-frame tables, Ut Video's
layouts, predictors, slices and BT.709; PNG's flavours; odd sizes), through
every seek cv2 makes and in the CLIs.  Each library is built once for the
module (g++, a few seconds).
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
from opticalflow_tpu_torch.io.avi import AviFile, AviWriter, codec_of
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.runtime import huffyuv, utvideo
from opticalflow_tpu_torch.runtime.mpeg4 import (ITEM_8, Unsupported,
                                                  i420_to_bgr, yuv_to_bgr)

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
LOSSLESS = sorted(n for n, e in MANIFEST.items() if e["group"] == "lossless")
HUFFYUV = [n for n in LOSSLESS if "huffyuv_features" in MANIFEST[n]]
UTVIDEO = [n for n in LOSSLESS if "utvideo_features" in MANIFEST[n]]


@pytest.fixture(scope="module", autouse=True)
def libraries():
    return huffyuv.load(), utvideo.load()


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


def _make():
    sys.path.insert(0, os.path.dirname(__file__))
    import make_video_fixtures
    return make_video_fixtures


# ---------------------------------------------------------------- fixtures

def test_fixtures_cover_what_cv2_writes_and_reads():
    """cv2's writer: HFYU, FFVH, ULY0 and MPNG in .avi/.mkv/.mov, MPNG in
    .mp4 (mp4v, objectTypeIndication 0x6D), MJPG in .mov (the jpeg entry),
    Y800/YV12/RGBA raw; and the full-width clips the card run reads."""
    need = {f"{stem}_96x64.{ext}" for stem in ("hfyu", "ffvh", "ut_uly0",
                                               "png")
            for ext in ("avi", "mkv", "mov")}
    need |= {"png_96x64.mp4", "mjpg_96x64.mov", "raw_y800_48x32.avi",
             "raw_y800_48x32.mkv", "raw_yv12_48x32.avi", "raw_yv12_48x32.mkv",
             "raw_rgba_48x32.avi", "raw_rgba_48x32.mkv", "raw_rgba_48x32.mov",
             "raw_grey_48x32.avi", "raw_y800_50x36.avi", "raw_bgr0_53x37.avi",
             "hfyu_sintel_436x1024.avi", "ut_sintel_436x1024.avi"}
    assert need <= set(LOSSLESS)
    assert os.path.getsize(_path("hfyu_sintel_436x1024.avi")) < 1 << 20
    total = sum(os.path.getsize(_path(n)) for n in LOSSLESS)
    assert total <= 2_500_000, total
    assert not any("port_refuses" in MANIFEST[n] for n in LOSSLESS)


@pytest.mark.parametrize("name", LOSSLESS)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", LOSSLESS)
def test_video_info_equals_cv2(name):
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", LOSSLESS)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """Every packet is a key frame: each seek reads its own frame, as
    cv2's does."""
    want = MANIFEST[name]
    video = vio.EncodedVideo(_path(name))
    assert want["seeks"] == {str(t): t for t in range(want["decoded"])}
    for t, hit in want["seeks"].items():
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", HUFFYUV + UTVIDEO)
def test_manifest_features_are_the_decoders(name):
    v, packets = _stream(name)
    dec = v._decoder()
    for p in packets:
        dec.decode(p)
    key = "huffyuv_features" if name in HUFFYUV else "utvideo_features"
    assert dec.features == MANIFEST[name][key]


def test_what_each_fixture_reaches_and_what_none_does():
    need = {"hfyu_96x64.avi": {"left", "decorrelate", "rgb24",
                               "extradata_tables"},
            "ffvh_96x64.mkv": {"yuv420"},
            "hfyu_yuv422_median_48x32.avi": {"median", "yuv422"},
            "hfyu_rgb32_plane_48x32.avi": {"plane", "rgb32", "decorrelate"},
            "hfyu_classic_yuv422_plane_48x32.avi": {"classic_tables",
                                                    "plane"},
            "hfyu_classic_rgb24_left_48x32.avi": {"classic_tables",
                                                  "decorrelate"},
            "hfyu_interlaced_yuv422p_median_48x32.avi": {"interlaced",
                                                         "median"},
            "ffvh_yuv420p_median_context_48x32.avi": {"context", "median"},
            "ffvh_gray_median_53x37.avi": {"version_3", "gray", "odd_width"},
            "ffvh_gbrap_median_48x32.avi": {"gbrap", "alpha"},
            "ffvh_yuv410p_median_48x32.avi": {"yuv410"},
            "ut_uly0_96x64.mov": {"left", "yuv420"},
            "ut_ulrg_gradient_48x32.avi": {"gradient", "rgb"},
            "ut_ulra_median_slices3_53x37.avi": {"alpha", "slices"},
            "ut_ulh4_median_slices4_53x37.avi": {"bt709", "yuv444"},
            "ut_ulrg_grey_48x32.avi": {"single_symbol"},
            "ut_uly2_none_48x32.avi": {"none", "yuv422"}}
    for name, feats in need.items():
        key = "huffyuv_features" if name in HUFFYUV else "utvideo_features"
        assert feats <= set(MANIFEST[name][key]), name
    for key, mod, names in (("huffyuv", huffyuv, HUFFYUV),
                            ("utvideo", utvideo, UTVIDEO)):
        reached = {f for n in names for f in MANIFEST[n][f"{key}_features"]}
        assert _MANIFEST[f"{key}_unreached"] == [
            f for f in mod.FEATURES if f not in reached] == []


# ------------------------------------------------------------- containers

def test_containers_carry_the_fourcc_bit_count_and_extradata():
    avi = AviFile(_path("hfyu_96x64.avi"))
    mkv = MkvFile(_path("hfyu_96x64.mkv"))
    mov = Mp4File(_path("hfyu_96x64.mov"))
    for box in (avi, mkv, mov):
        assert (box.codec, box.tag, box.bpc) == ("huffyuv", "HFYU", 24)
        assert box.dsi == avi.dsi and box.dsi[:4] == b"\x40\x18\x20\x00"
    ut = [AviFile(_path("ut_uly0_96x64.avi")), MkvFile(_path(
        "ut_uly0_96x64.mkv")), Mp4File(_path("ut_uly0_96x64.mov"))]
    assert {(b.codec, b.tag, len(b.dsi)) for b in ut} == {
        ("utvideo", "ULY0", 16)}
    for name, codec in (("png_96x64.avi", "png"), ("png_96x64.mkv", "png"),
                        ("png_96x64.mov", "png"), ("png_96x64.mp4", "png"),
                        ("mjpg_96x64.mov", "mjpeg"),
                        ("raw_rgba_48x32.mov", "raw"),
                        ("raw_y800_48x32.mkv", "raw"),
                        ("raw_yv12_48x32.avi", "raw")):
        assert vio.EncodedVideo(_path(name)).box.codec == codec, name
    assert Mp4File(_path("png_96x64.mov")).tag == "png "
    assert Mp4File(_path("mjpg_96x64.mov")).tag == "jpeg"
    for tag, codec in (("HFYU", "huffyuv"), ("ffvh", "huffyuv"),
                       ("ULH2", "utvideo"), ("MPNG", "png"), ("png ", "png"),
                       ("Y800", "raw"), ("GREY", "raw"), ("YV12", "raw"),
                       ("RGBA", "raw"), ("jpeg", "mjpeg"), ("I420", "i420")):
        assert codec_of(tag, "x.avi") == codec, tag
    for name in ("hfyu_96x64.avi", "ut_uly0_96x64.mkv", "png_96x64.mov"):
        assert vio.EncodedVideo(_path(name)).keyframes == [0, 1, 2]


def test_y800_rows_are_read_4_bytes_apart_as_ffmpeg_reads_them():
    """cv2 writes I420-sized packets under Y800; FFmpeg's rawvideo decoder
    aligns a grey row to 4 bytes where the packet holds that many, so a
    50-wide frame's rows start 52 bytes apart."""
    v, packets = _stream("raw_y800_50x36.avi")
    assert len(packets[0]) == 50 * 36 * 3 // 2
    (y,) = v._raw(packets[0])
    a = np.frombuffer(packets[0], np.uint8)
    np.testing.assert_array_equal(y[5], a[5 * 52:5 * 52 + 50])
    frame = vio.read_frame(v.path, 0)
    assert not np.array_equal(frame[5, :, 0], a[5 * 50:5 * 50 + 50])


def test_yv12_swaps_the_chroma_planes_and_bi_rgb_is_bottom_up():
    v, packets = _stream("raw_yv12_48x32.avi")
    y, u, vv = v._raw(packets[0])
    a = np.frombuffer(packets[0], np.uint8)
    np.testing.assert_array_equal(vv.ravel(), a[48 * 32:48 * 32 + 24 * 16])
    np.testing.assert_array_equal(u.ravel(), a[48 * 32 + 24 * 16:])
    box = AviFile(_path("raw_bgr0_53x37.avi"))
    assert box.bottom_up and box.bpc == 32
    v, packets = _stream("raw_bgr0_53x37.avi")
    rows = np.frombuffer(packets[0], np.uint8).reshape(37, 53, 4)
    np.testing.assert_array_equal(v._raw(packets[0]), rows[::-1, :, :3])


def test_yuv_to_bgr_is_i420_to_bgr_at_4_2_0():
    rng = np.random.default_rng(0)
    for h, w in ((32, 48), (37, 53)):
        y = rng.integers(0, 256, (h, w), np.uint8)
        u, v = (rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), np.uint8)
                for _ in range(2))
        np.testing.assert_array_equal(yuv_to_bgr(y, u, v, (1, 1)),
                                      i420_to_bgr(y, u, v))
    with pytest.raises(ValueError, match="do not match"):
        yuv_to_bgr(y, u, v, (1, 0))


def test_classic_tables_are_complete_huffman_codes():
    """HuffYUV 2.1.1's fixed tables, read out of libavcodec, make complete
    prefix codes (the fixtures coded with them decode to cv2's frames)."""
    mk = _make()
    for shift, add in (("kClassicShiftLuma", "kClassicAddLuma"),
                       ("kClassicShiftChroma", "kClassicAddChroma")):
        codes = mk._classic_code(mk._cpp_bytes(shift, "huffyuv.cpp"),
                                 mk._cpp_bytes(add, "huffyuv.cpp"))
        assert sum(2.0 ** -n for _, n in codes) == 1.0
        words = {format(c, f"0{n}b") for c, n in codes}
        assert len(words) == 256
        assert not any(w[:k] in words for w in words for k in range(1, len(w)))


# ------------------------------------------------------------- refusals

def _ffvh(pix, **opts):
    mk = _make()
    return mk.Lavc().encode_intra(mk.moving_clip(32, 48, 1, seed=4),
                                  "ffvhuff", pix, **opts)


@pytest.mark.parametrize("pix,patch,what", [
    ("gbrp", lambda e: e[:1] + bytes([0x90]) + e[2:], "10-bit"),
    ("yuv444p", lambda e: e[:1] + bytes([e[1] | 5]) + e[2:], "odd size"),
    ("rgb24", lambda e: bytes([2 | e[0] & 64]) + e[1:], "median predictor")])
def test_huffyuv_layouts_left_out_raise_unsupported_naming_item_8(
        pix, patch, what):
    ext, _ = _ffvh(pix)
    w, h = (53, 37) if what == "odd size" else (48, 32)
    with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
        huffyuv.Decoder(w, h, 24, patch(ext), what=pix)


def test_huffyuv_damaged_packets_raise_value_error():
    v, packets = _stream("ffvh_yuv420p_median_context_48x32.avi")
    with pytest.raises(ValueError, match="corrupt HuffYUV"):
        v._decoder().decode(packets[0][:40])
    bad = bytes([packets[0][0] ^ 0xFF]) + packets[0][1:]
    with pytest.raises(ValueError, match="corrupt HuffYUV"):
        v._decoder().decode(bad)
    rng = np.random.default_rng(5)
    for _ in range(20):     # damage never crashes, nor reads out of bounds
        data = bytearray(packets[1])
        for _ in range(4):
            data[int(rng.integers(0, len(data)))] ^= int(rng.integers(1, 256))
        try:
            v._decoder().decode(bytes(data))
        except ValueError:
            pass


@pytest.mark.parametrize("tag,flags,what", [
    ("UQY2", 0, "10-bit"), ("UMY2", 0, "packed"), ("ULY2", 0x800,
                                                   "interlaced")])
def test_utvideo_layouts_left_out_raise_unsupported_naming_item_8(
        tag, flags, what):
    v, _ = _stream("ut_uly2_left_48x32.avi")
    ext = v.box.dsi[:12] + struct.pack(
        "<I", struct.unpack("<I", v.box.dsi[12:])[0] | flags)
    with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
        utvideo.Decoder(48, 32, tag, ext, what=tag)


def test_utvideo_damaged_packets_raise_value_error():
    v, packets = _stream("ut_ulh0_median_slices5_48x32.avi")
    with pytest.raises(ValueError, match="corrupt Ut Video"):
        v._decoder().decode(packets[0][:300])
    with pytest.raises(ValueError, match="odd dimensions"):
        utvideo.Decoder(53, 37, "ULY0", v.box.dsi)
    rng = np.random.default_rng(6)
    for _ in range(20):     # damage never crashes, nor reads out of bounds
        data = bytearray(packets[1])
        for _ in range(4):
            data[int(rng.integers(0, len(data)))] ^= int(rng.integers(1, 256))
        try:
            v._decoder().decode(bytes(data))
        except ValueError:
            pass


def test_apng_style_packets_and_other_codecs_raise_naming_item_8(tmp_path):
    """A packet of APNG frame chunks without a PNG signature, 24-bit
    BI_RGB and raw video in QuickTime (cv2 reads none of it); Snow and
    Dirac, once queued here, read as cv2 reads them."""
    v, packets = _stream("png_96x64.avi")
    apng = tmp_path / "apng.avi"
    body = packets[0][8:]
    mux = AviWriter(str(apng), (96, 64), (25, 1), fourcc="MPNG")
    mux.write(packets[0], True)
    mux.write(body.replace(b"IDAT", b"fdAT"), True)
    mux.release()
    with pytest.raises(Unsupported, match=f"APNG.*{ITEM_8}"):
        list(vio.read_frames(str(apng)))
    dib = tmp_path / "dib24.avi"
    mux = AviWriter(str(dib), (48, 32), (25, 1), fourcc="\0\0\0\0", bpc=24)
    mux.write(bytes(48 * 32 * 3), True)
    mux.release()
    with pytest.raises(Unsupported, match=f"24-bit BI_RGB.*{ITEM_8}"):
        list(vio.read_frames(str(dib)))
    frames = _make().moving_clip(32, 48, 2, seed=6)
    for fourcc, ext, what in (("I420", "mov", "'raw '"),):
        path = str(tmp_path / f"{fourcc}.{ext}")
        _make()._cv2_write(path, frames, fourcc)
        with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
            vio.EncodedVideo(path)
    for fourcc in ("SNOW", "drac"):
        path = str(tmp_path / f"{fourcc}.avi")
        _make()._cv2_write(path, frames, fourcc)
        _same(list(vio.read_frames(path)), _cv2_frames(path))
    # MS-MPEG4 v1 (riff.c's MPG4 and MP41): libavcodec has no encoder of
    # it, so a crafted BITMAPINFOHEADER names it
    for fourcc in ("MPG4", "MP41", "mpg4"):
        path = str(tmp_path / f"{fourcc}.avi")
        mux = AviWriter(path, (48, 32), (25, 1), fourcc=fourcc)
        mux.write(bytes(64), True)
        mux.release()
        with pytest.raises(Unsupported, match=f"MS-MPEG4 v1.*{ITEM_8}"):
            vio.EncodedVideo(path)


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["hfyu_96x64.mkv", "ffvh_96x64.avi",
                                  "ut_uly0_96x64.mov", "png_96x64.mp4",
                                  "mjpg_96x64.mov", "raw_rgba_48x32.mkv",
                                  "ut_ulh2_left_slices7_52x37.avi",
                                  "ffvh_yuva422p_median_48x32.avi"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=10, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=10, stride=2)))


@pytest.mark.parametrize("name", ["hfyu_yuv422_plane_48x32.avi",
                                  "ut_ulrg_median_48x32.avi"])
def test_jax_consecutive_frames_equal(name):
    path = _path(name)
    ds = datasets.ConsecutiveFrames(path, size_hw=(32, 48), stride=1)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(32, 48), stride=1)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


@pytest.mark.parametrize("name", ["hfyu_sintel_436x1024.avi",
                                  "ut_sintel_436x1024.avi", "png_96x64.mkv"])
def test_jax_capture_frame_equals(tmp_path, name):
    path = _path(name)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "1", a]) == 0
        assert jcapture.main([path, "1", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))
