"""Motion JPEG and image sequences in the port against ``cv2.VideoCapture``
and the JAX package on the CPU.

``cv2.VideoCapture`` (OpenCV 5.0 with FFmpeg 8 here) decodes a Motion JPEG
frame or an image-sequence file with FFmpeg's mjpeg decoder and converts it
with swscale; the port's ``runtime/jpeg`` FFmpeg flavour and
``runtime/ffmpeg_dsp.h`` do the same arithmetic, so every frame is held to
cv2's bit for bit: MJPEG in AVI (cv2's writer, and DHT-less frames muxed by
the port's ``AviWriter``) and in ``.mp4`` (``mp4v`` with
objectTypeIndication 0x6C), ``%06d.jpg`` sequences over every sampling,
grey, progressive, restart intervals and odd sizes (which take swscale's
unscaled, half-chroma and full-chroma paths), ``%d.png`` sequences of
every 8-bit PNG flavour and 16-bit grey, image2's rules (first index 0-4,
reading stops at a gap, one plain file), and ``video_info``'s fps, size
and count.  The JAX package's ``frame_pairs_from_video``,
``ConsecutiveFrames`` and ``capture_frame`` give the same frames and pairs
exactly.  Tolerance: none anywhere (every comparison is equality).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from opticalflow_tpu_torch.cli import capture_frame  # noqa: E402
from opticalflow_tpu_torch.data import datasets  # noqa: E402
from opticalflow_tpu_torch.io import video as vio  # noqa: E402
from opticalflow_tpu_torch.io.avi import AviWriter  # noqa: E402
from opticalflow_tpu_torch.io.images import encode_png  # noqa: E402
from opticalflow_tpu_torch.runtime import _native, jpeg, mpeg4  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
VIDEO = os.path.join(HERE, "goldens", "video")
JPEGS = os.path.join(HERE, "goldens", "jpeg")
sys.path.insert(0, HERE)
from make_video_fixtures import moving_clip, strip_dht  # noqa: E402

ITEM_8 = "Queue 1 item 8"
SF = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
      "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
      "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
      "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
      "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _cv2_all(path: str) -> list:
    cap = cv2.VideoCapture(path)
    assert cap.isOpened(), path
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


def _cv2_info(path: str) -> dict:
    cap = cv2.VideoCapture(path)
    info = {"fps": cap.get(cv2.CAP_PROP_FPS),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    cap.release()
    return info


def _cv2_frame(path: str, index: int):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, index)
    ok, f = cap.read()
    cap.release()
    return f if ok else None


def _same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _textures(n, h, w, seed=0):
    return moving_clip(h, w, n, seed=seed, speed=3.0)


# ------------------------------------------------------------ fixtures

_JPEG_MANIFEST = json.load(open(os.path.join(JPEGS, "manifest.json")))
_VIDEO_MANIFEST = json.load(open(os.path.join(VIDEO, "manifest.json")))


@pytest.mark.parametrize("name", sorted(_JPEG_MANIFEST["files"]))
def test_jpeg_fixture_decodes_to_videocaptures_digest(name):
    """Every committed JPEG through the FFmpeg flavour: the digest of the
    frame cv2.VideoCapture read from it when the fixtures were made (what
    chip_smoke.py phase 18 checks on the GPU machine)."""
    with open(os.path.join(JPEGS, name), "rb") as f:
        data = f.read()
    got = jpeg.decode_jpeg_ffmpeg(data, name)
    assert got.shape == tuple(_JPEG_MANIFEST["files"][name]["shape"])
    assert _digest(got) == _JPEG_MANIFEST["files"][name]["sha256_videocapture"]


@pytest.mark.parametrize("name", ["mjpg.avi", "mjpg_176x144.mp4",
                                  "mjpg_nodht_176x144.avi"])
def test_mjpeg_fixture_matches_manifest_and_cv2(name):
    path = os.path.join(VIDEO, name)
    rec = _VIDEO_MANIFEST["files"][name]
    got = list(vio.read_frames(path))
    assert [_digest(g) for g in got] == rec["sha256"]
    _same(got, _cv2_all(path))
    assert vio.video_info(path) == {k: rec[k] for k in
                                    ("fps", "width", "height", "frames")}
    np.testing.assert_array_equal(vio.read_frame(path, len(got) - 1),
                                  got[-1])


# ------------------------------------------------------ cv2-written MJPEG

@pytest.mark.parametrize("ext, w, h", [(".avi", 53, 37), (".avi", 64, 48),
                                       (".mp4", 48, 30)])
def test_cv2_written_mjpeg_reads_as_videocapture(tmp_path, ext, w, h):
    """cv2.VideoWriter's Motion JPEG (an odd side cropped to even, as its
    writer crops it): every frame, a seek (every frame a keyframe) and
    video_info equal cv2's."""
    path = str(tmp_path / f"clip{ext}")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 12.0, (w, h))
    assert wr.isOpened()
    for f in _textures(7, h, w, seed=w):
        wr.write(f)
    wr.release()
    want = _cv2_all(path)
    assert len(want) == 7
    _same(list(vio.read_frames(path)), want)
    _same(list(vio.read_frames(path, max_frames=5, stride=2)), want[0:5:2])
    np.testing.assert_array_equal(vio.read_frame(path, 4), _cv2_frame(path, 4))
    assert vio.video_info(path) == _cv2_info(path)
    video = vio.EncodedVideo(path)
    assert video.keyframes == list(range(7))
    np.testing.assert_array_equal(video.read(5), want[5])
    np.testing.assert_array_equal(video.read(6), want[6])
    np.testing.assert_array_equal(video.read(1), want[1])
    video.close()


# ------------------------------------------------------ JPEG sequences

# (name, height, width, imencode parameters): 4:2:0 and 4:2:2 at an even
# height take swscale's unscaled path; at an odd height, and 4:4:0 and
# 4:1:1, its scaler with half-width chroma (MMX rows, C last rows); an odd
# width and 4:4:4 its full-chroma output
_JPEG_FLAVOURS = [
    ("420_even", 48, 64, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["420"]]),
    ("420_odd_height", 37, 64, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["420"]]),
    ("420_odd", 37, 53, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["420"]]),
    ("420_two_rows", 7, 16, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["420"]]),
    ("422_even", 36, 53, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["422"]]),
    ("422_odd_height", 37, 52, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["422"]]),
    ("444", 37, 53, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["444"]]),
    ("440", 36, 52, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["440"]]),
    ("440_odd", 9, 7, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["440"]]),
    ("411", 36, 52, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["411"]]),
    ("411_odd", 37, 53, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SF["411"]]),
    ("grey", 37, 53, None),
    ("progressive", 37, 53, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    ("restart", 36, 52, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    ("optimized", 30, 40, [cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                           cv2.IMWRITE_JPEG_QUALITY, 97]),
    ("one_pixel", 1, 1, []),
]


@pytest.mark.parametrize("name, h, w, params", _JPEG_FLAVOURS,
                         ids=[f[0] for f in _JPEG_FLAVOURS])
def test_jpeg_sequence_reads_as_videocapture(tmp_path, name, h, w, params):
    """A ``%06d.jpg`` sequence of three frames, its first index 0-4: every
    frame, a frame by index and video_info equal cv2's."""
    frames = _textures(3, h, w, seed=h * w % 97)
    first = len(name) % 5
    for i, f in enumerate(frames):
        img = f[..., 1] if params is None else f
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 88]
                               + (params or []))
        assert ok
        (tmp_path / f"{first + i:06d}.jpg").write_bytes(enc.tobytes())
    path = str(tmp_path / "%06d.jpg")
    want = _cv2_all(path)
    assert len(want) == 3
    _same(list(vio.read_frames(path)), want)
    np.testing.assert_array_equal(vio.read_frame(path, 2), _cv2_frame(path, 2))
    assert vio.video_info(path) == _cv2_info(path)


# ------------------------------------------------------ PNG sequences

def _pil_png(img, mode=None, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "PNG", **kw)
    return buf.getvalue()


def _png_flavour(kind: str, rng) -> bytes:
    h, w = 11, 14
    rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
    if kind == "rgb":
        return encode_png(rgb)
    if kind == "rgba":
        return encode_png(rng.integers(0, 256, (h, w, 4), np.uint8))
    if kind == "grey":
        return encode_png(rgb[..., 0])
    if kind == "grey_alpha":
        return _pil_png(rng.integers(0, 256, (h, w, 2), np.uint8), "LA")
    if kind == "palette":
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                     colors=23).save(buf, "PNG")
        return buf.getvalue()
    if kind == "grey_1bit":
        return _pil_png(rng.integers(0, 2, (h, w)).astype(bool))
    if kind == "grey_4bit":
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(rgb[..., 0]).save(buf, "PNG", bits=4)
        return buf.getvalue()
    if kind == "grey_16bit":
        return encode_png(rng.integers(0, 65536, (h, w)).astype(np.uint16))
    if kind == "grey_alpha_16bit":
        return _grey_alpha16(rng, h, w)
    raise AssertionError(kind)


def _grey_alpha16(rng, h, w) -> bytes:
    """A colour type 4 (grey + alpha) 16-bit PNG, written by hand."""
    import struct
    import zlib
    px = rng.integers(0, 65536, (h, w, 2)).astype(">u2")
    rows = np.zeros((h, 1 + w * 4), np.uint8)
    rows[:, 1:] = px.view(np.uint8).reshape(h, -1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 4, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb", "rgba", "grey", "grey_alpha",
                                  "palette", "grey_1bit", "grey_4bit",
                                  "grey_16bit", "grey_alpha_16bit"])
def test_png_sequence_reads_as_videocapture(tmp_path, kind):
    """A ``%d.png`` sequence (unpadded names, first index 1) of each PNG
    flavour: swscale's BGR24 (alpha dropped, grey replicated, 16-bit grey
    rounded to 8 bits) equals cv2's frames."""
    rng = np.random.default_rng(len(kind))
    for i in range(1, 4):
        (tmp_path / f"{i}.png").write_bytes(_png_flavour(kind, rng))
    path = str(tmp_path / "%d.png")
    want = _cv2_all(path)
    assert len(want) == 3
    _same(list(vio.read_frames(path)), want)
    assert vio.video_info(path) == _cv2_info(path)


@pytest.mark.parametrize("kind,ext", [
    ("RGB-raw", ".tif"), ("RGB-packbits", ".tiff"), ("RGB-tiff_lzw", ".tif"),
    ("RGB-tiff_adobe_deflate", ".tif"), ("L-tiff_lzw", ".tif"),
    ("I;16-packbits", ".tif"), ("I;16B-raw", ".tiff")])
def test_tiff_sequence_reads_as_videocapture(tmp_path, kind, ext):
    """A ``%06d.tif`` (or ``.tiff``) sequence as PIL writes it, in each
    compression and layout (Predictor 2 and the committed sequences are in
    tests/test_torch_tiff.py): FFmpeg's tiff decoder and swscale's BGR24
    (RGB copied, grey replicated, 16-bit grey rounded) equal cv2's frames,
    and image2's count and 25 fps."""
    from PIL import Image
    mode, comp = kind.split("-")
    rng = np.random.default_rng(len(kind))
    for i in range(3):
        f = _textures(1, 29, 43)[0] if i else rng.integers(
            0, 256, (29, 43, 3), np.uint8)
        if mode == "RGB":
            im = Image.fromarray(np.ascontiguousarray(f[..., ::-1]))
        elif mode == "L":
            im = Image.fromarray(np.ascontiguousarray(f[..., 0]))
        else:
            g = f[..., 0].astype(np.uint16) * 251 + i
            im = Image.frombytes(mode, (43, 29), g.astype(
                ">u2" if mode == "I;16B" else "<u2").tobytes())
        im.save(str(tmp_path / f"{i:06d}{ext}"), compression=comp)
    path = str(tmp_path / f"%06d{ext}")
    want = _cv2_all(path)
    assert len(want) == 3
    _same(list(vio.read_frames(path)), want)
    assert vio.video_info(path) == _cv2_info(path)
    assert vio.is_sequence(path)


# ------------------------------------------------------ image2's rules

def test_image2_first_index_gap_padding_and_one_file(tmp_path):
    """The first index lies in 0-4 (cv2 opens nothing past it); the count
    is image2's, and reading stops at the first missing file (cv2's read
    fails there, and at a seek past it); ``%d`` does not match zero-padded
    names; one plain file is a one-frame video at 25 fps."""
    data = [cv2.imencode(".jpg", f)[1].tobytes() for f in _textures(6, 24, 32)]
    for first in (4, 5):
        d = tmp_path / f"start{first}"
        d.mkdir()
        for i in range(3):
            (d / f"{first + i:03d}.jpg").write_bytes(data[i])
        path = str(d / "%03d.jpg")
        if first == 4:
            _same(list(vio.read_frames(path)), _cv2_all(path))
            assert vio.video_info(path) == _cv2_info(path)
        else:
            assert not cv2.VideoCapture(path).isOpened()
            with pytest.raises(FileNotFoundError, match="range 0-4"):
                vio.video_info(path)
    gap = tmp_path / "gap"
    gap.mkdir()
    for i in (0, 1, 2, 4, 5):
        (gap / f"{i:06d}.jpg").write_bytes(data[i])
    path = str(gap / "%06d.jpg")
    want = _cv2_all(path)
    assert len(want) == 3
    _same(list(vio.read_frames(path)), want)
    assert vio.video_info(path) == _cv2_info(path)
    assert vio.video_info(path)["frames"] == 6
    assert _cv2_frame(path, 4) is None
    with pytest.raises(ValueError, match="missing"):
        vio.read_frame(path, 4)
    np.testing.assert_array_equal(vio.read_frame(path, 1), _cv2_frame(path, 1))
    unpadded = str(gap / "%d.jpg")
    assert not cv2.VideoCapture(unpadded).isOpened()
    with pytest.raises(FileNotFoundError):
        list(vio.read_frames(unpadded))
    one = str(gap / "000002.jpg")
    _same(list(vio.read_frames(one)), _cv2_all(one))
    info = _cv2_info(one)
    assert vio.video_info(one) == {"fps": info["fps"], "width": 32,
                                   "height": 24, "frames": 1}
    assert vio.frame_filename("a/%6d_%%.png", 7) == "a/000007_%.png"
    assert vio.frame_filename("a/%d_%d.png", 7) is None


# ------------------------------------------------- nothing falls back

def _set_sof(data: bytes, marker: int, precision=None) -> bytes:
    out = bytearray(data)
    i = out.find(b"\xff\xc0")
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def test_declined_and_corrupt_frames_raise(tmp_path, monkeypatch):
    """Arithmetic coding, lossless, 12-bit, CMYK and RGB JPEG and
    interlaced Motion JPEG raise Unsupported naming ROADMAP item 8;
    corrupt data raises ValueError; none of them reaches the libjpeg
    flavour.  A 16-bit colour PNG, refused until swscale's conversion was
    reproduced, reads as cv2 reads it."""
    from PIL import Image

    def no_fallback(*a, **k):
        raise AssertionError("handed to the libjpeg flavour")
    monkeypatch.setattr(jpeg, "decode_jpeg", no_fallback)
    rgb = _textures(1, 16, 24)[0]
    good = cv2.imencode(".jpg", rgb)[1].tobytes()
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, "JPEG")
    cmyk = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", keep_rgb=True)
    cases = [(_set_sof(good, 0xC9), "arithmetic"),
             (_set_sof(good, 0xC3), "lossless"),
             (_set_sof(good, 0xC1, precision=12), "12-bit"),
             (cmyk, "4-component"), (buf.getvalue(), "RGB JPEG")]
    for i, (data, what) in enumerate(cases):
        (tmp_path / f"{i:06d}.jpg").write_bytes(data)
        path = str(tmp_path / f"{i:06d}.jpg")
        with pytest.raises(mpeg4.Unsupported, match=f"{what}.*{ITEM_8}"):
            vio.read_frame(path, 0)
    (tmp_path / "cut.jpg").write_bytes(good[:len(good) // 2])
    with pytest.raises(ValueError, match="corrupt JPEG"):
        vio.read_frame(str(tmp_path / "cut.jpg"), 0)
    fields = str(tmp_path / "fields.avi")
    mux = AviWriter(fields, (24, 32), (25, 1), fourcc="MJPG")
    mux.write(good, True)
    mux.release()
    with pytest.raises(mpeg4.Unsupported, match=f"interlaced.*{ITEM_8}"):
        vio.video_info(fields)
    (tmp_path / "deep.png").write_bytes(
        encode_png(np.zeros((4, 4, 3), np.uint16)))
    np.testing.assert_array_equal(vio.read_frame(str(tmp_path / "deep.png"),
                                                 0),
                                  _cv2_all(str(tmp_path / "deep.png"))[0])


# ------------------------------------------------------ the JAX package

@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """A 6-frame ``%06d.jpg`` sequence at 37x53 (4:2:0, odd sides) and an
    MJPEG AVI of DHT-less frames at 48x64, muxed by the port."""
    tmp = tmp_path_factory.mktemp("mjpeg_sources")
    frames = _textures(6, 37, 53, seed=11)
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp / f"{i + 1:06d}.jpg"), f)
    avi = str(tmp / "clip.avi")
    mux = AviWriter(avi, (64, 48), (30, 1), fourcc="MJPG")
    for f in _textures(6, 48, 64, seed=12):
        mux.write(strip_dht(cv2.imencode(".jpg", f)[1].tobytes()), True)
    mux.release()
    return {"pattern": str(tmp / "%06d.jpg"), "avi": avi, "tmp": tmp}


@pytest.mark.parametrize("which", ["pattern", "avi"])
def test_frames_pairs_and_capture_match_jax(sources, tmp_path, which):
    """frame_pairs_from_video, ConsecutiveFrames (stride 2, shrunk to
    24x32) and capture_frame give the JAX package's frames, pairs and
    samples exactly."""
    from opticalflow_tpu import video as jvideo
    from opticalflow_tpu.cli import capture_frame as jcapture
    from opticalflow_tpu.data import datasets as jdatasets
    from opticalflow_tpu_torch.video import frame_pairs_from_video
    path = sources[which]
    want = list(jvideo.frame_pairs_from_video(path))
    assert len(want) == 6
    _same(list(frame_pairs_from_video(path)), want)
    _same(list(frame_pairs_from_video(path, max_frames=5, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=5, stride=2)))
    ds = datasets.ConsecutiveFrames(path, size_hw=(24, 32), stride=2)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(24, 32), stride=2)
    assert ds.index == jds.index and len(ds) == 4
    for i in (3, 0, 1):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"])
    out, jout = str(tmp_path / "p.png"), str(tmp_path / "j.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "4", out]) == 0
        assert jcapture.main([path, "4", jout]) == 0
    np.testing.assert_array_equal(cv2.imread(out), cv2.imread(jout))
    np.testing.assert_array_equal(cv2.imread(out), want[4])


def test_consecutive_frames_globs_png_and_jpg_as_jax(tmp_path):
    """A directory of a.png, b.jpeg and c.jpg: the JAX class globs
    ``*.png`` and ``*.jpg`` only, and so does the port's: the same length,
    pairs and samples (the directory's frames are loaded as images, by
    libjpeg's rules, in both)."""
    from opticalflow_tpu.data import datasets as jdatasets
    a, b, c = _textures(3, 30, 40, seed=5)
    (tmp_path / "a.png").write_bytes(encode_png(a[..., ::-1]))
    cv2.imwrite(str(tmp_path / "b.jpeg"), b)
    cv2.imwrite(str(tmp_path / "c.jpg"), c)
    ds = datasets.ConsecutiveFrames(str(tmp_path), size_hw=(16, 24))
    jds = jdatasets.ConsecutiveFrames(str(tmp_path), size_hw=(16, 24))
    assert ds.frames == jds.frames == [str(tmp_path / "a.png"),
                                       str(tmp_path / "c.jpg")]
    assert ds.index == jds.index == [(0, 1)] and len(ds) == 1
    np.testing.assert_array_equal(ds[0]["images"], jds[0]["images"])


# ------------------------------------------------------ the build

def test_library_digest_covers_included_headers(tmp_path):
    """``runtime/_native.library_path`` hashes the local headers a source
    includes: an edited ``ffmpeg_dsp.h`` names a new library for both
    sources that include it (``mpeg4.cpp`` includes ``mpeg_common.h``
    too)."""
    runtime = os.path.dirname(jpeg.__file__)
    for name in ("jpeg.cpp", "mpeg4.cpp", "ffmpeg_dsp.h", "mpeg_common.h"):
        shutil.copy(os.path.join(runtime, name), tmp_path / name)
    from pathlib import Path
    srcs = [Path(tmp_path / "jpeg.cpp"), Path(tmp_path / "mpeg4.cpp")]
    flags = ("-O3",)
    before = [_native.library_path(s, flags) for s in srcs]
    assert [p.name for p in _native.sources(srcs[0])] == ["jpeg.cpp",
                                                           "ffmpeg_dsp.h"]
    header = tmp_path / "ffmpeg_dsp.h"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [_native.library_path(s, flags) for s in srcs]
    assert all(x != y for x, y in zip(before, after))
    assert before[0].name.startswith("libjpeg-")
