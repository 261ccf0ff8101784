"""The port's Matroska/WebM demuxer and muxer (``io/mkv``) behind
``io/video``, against OpenCV's FFmpeg (``cv2.VideoCapture``,
``cv2.VideoWriter``) and the JAX package's cv2-based readers.

Tolerance: 0 throughout: every frame of the committed Matroska fixtures
(``tests/goldens/video/mkv_*``: fourccs ``mp4v``, ``MJPG`` and ``I420``
written into ``.mkv`` by cv2), of the unknown-size and Cue-less WebMs, and
of files built here element by element (header stripping, BlockGroups)
equals cv2's; fps, size and count are cv2's (a file without a Duration
excepted: cv2 reports a negative count, the port counts the blocks); a
``.mkv`` the port writes reads back in cv2 as the encoder's
reconstruction.  The codecs, compressions and lacings the port does not
read raise, naming ROADMAP Queue 1 item 8.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest

from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import mkv
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.runtime import mpeg4
from opticalflow_tpu_torch.runtime.mpeg4 import Unsupported
from make_video_fixtures import moving_clip

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
MKV = sorted(n for n in MANIFEST if n.startswith("mkv_"))
MP4V = os.path.join(FIXTURES, "mkv_mp4v_176x144.mkv")
WEBM = os.path.join(FIXTURES, "vp8_176x144.webm")


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            cap.release()
            return out
        out.append(frame)


def _cv2_seek(path, i):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, i)
    ok, frame = cap.read()
    cap.release()
    assert ok
    return frame


def _cv2_info(path):
    cap = cv2.VideoCapture(path)
    info = {"fps": cap.get(cv2.CAP_PROP_FPS),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    cap.release()
    return info


def _same(a, b):
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {k}")


def _void(data: bytes, at: int, total: int) -> bytes:
    """``total`` bytes at ``at`` overwritten by an EBML Void."""
    return (data[:at] + b"\xec" + bytes([0x80 | total - 2])
            + b"\0" * (total - 2) + data[at + total:])


def _cv2_write(path, frames, fourcc, fps):
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()


def _build(codec_id: bytes, frames, *, extra_track=b"", extra_video=b"",
           keys=None, group=False, laced=False, strip=b"") -> bytes:
    """A Matroska file built element by element around ``frames``: one
    176x144 video track under ``codec_id`` (``extra_track`` appended to
    its entry, ``extra_video`` to its Video element), one Cluster;
    SimpleBlocks, or BlockGroups (a ReferenceBlock on each non-key frame);
    ``strip`` cut from each frame's front."""
    el, u = mkv._el, mkv._uint_el
    keys = keys if keys is not None else [True] + [False] * (len(frames) - 1)
    blocks = b""
    for t, (frame, key) in enumerate(zip(frames, keys)):
        body = frame[len(strip):]
        flags = (0x80 if key and not group else 0) | (0x02 if laced else 0)
        block = b"\x81" + struct.pack(">hB", 40 * t, flags) + body
        if group:
            ref = b"" if key else u(mkv.REFERENCE_BLOCK, 40)
            blocks += el(mkv.BLOCK_GROUP, el(mkv.BLOCK, block) + ref)
        else:
            blocks += el(mkv.SIMPLE_BLOCK, block)
    track = el(mkv.TRACK_ENTRY, u(mkv.TRACK_NUMBER, 1) + u(mkv.TRACK_TYPE, 1)
               + el(mkv.CODEC_ID, codec_id)
               + u(mkv.DEFAULT_DURATION, 40_000_000)
               + el(mkv.VIDEO, u(mkv.PIXEL_WIDTH, 176)
                    + u(mkv.PIXEL_HEIGHT, 144) + extra_video) + extra_track)
    info = el(mkv.INFO, u(mkv.TIMECODE_SCALE, 1_000_000)
              + el(mkv.DURATION, struct.pack(">d", 40.0 * len(frames))))
    segment = (info + el(mkv.TRACKS, track)
               + el(mkv.CLUSTER, u(mkv.TIMECODE, 0) + blocks))
    return el(mkv.EBML, el(mkv.DOCTYPE, b"webm")) + el(mkv.SEGMENT, segment)


def _frames_of(path, n=None):
    box = mkv.MkvFile(path)
    with open(path, "rb") as f:
        return [box.sample(f, i) for i in range(n or len(box.sizes))]


def _webm_frames(n=None):
    return _frames_of(WEBM, n)


# ---------------------------------------------------------------- fixtures

@pytest.mark.parametrize("name", MKV)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = os.path.join(FIXTURES, name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in got] == \
        MANIFEST[name]["sha256"]


@pytest.mark.parametrize("name", MKV + ["vp8_unknown_sizes.webm",
                                        "vp8_no_cues.webm"])
def test_fixture_info_and_seeks_equal_cv2(name):
    path = os.path.join(FIXTURES, name)
    assert vio.video_info(path) == _cv2_info(path)
    n = MANIFEST[name]["frames"]
    for i in sorted({min(i, n - 1) for i in (0, 5, 13, n - 1)}):
        np.testing.assert_array_equal(vio.read_frame(path, i),
                                      _cv2_seek(path, i), err_msg=f"{i}")


def test_unknown_sizes_and_missing_cues_index_the_same_blocks():
    """An unknown-size Segment and Clusters end where the next element of
    a level above begins: the same blocks, keyframes and timestamps as the
    file with its sizes and without its Cues (both patches of one file cv2
    wrote); Cues are not needed for them."""
    unknown, no_cues = (mkv.MkvFile(os.path.join(FIXTURES, n)) for n in (
        "vp8_unknown_sizes.webm", "vp8_no_cues.webm"))
    assert (unknown.sizes, unknown.keyframes, unknown.times) == \
        (no_cues.sizes, no_cues.keyframes, no_cues.times)
    assert len(unknown.sizes) == 13 and unknown.keyframes == [0, 12]
    assert unknown.times == [40 * i for i in range(13)]


# -------------------------------------------------------- fps and count

@pytest.mark.parametrize("fps", [25.0, 30000 / 1001, 24.0, 12.5])
def test_rates_without_default_duration_and_duration_equal_cv2(tmp_path,
                                                                fps):
    """fps: DefaultDuration reduced (av_reduce), or without it FFmpeg's
    guess from the block timestamps; the count: Duration times fps.
    Without a Duration cv2's count is negative garbage (AV_NOPTS_VALUE
    scaled); the port counts the blocks, every one of which cv2 reads."""
    src = str(tmp_path / "src.webm")
    _cv2_write(src, moving_clip(48, 64, 26, seed=2), "VP80", fps)
    data = open(src, "rb").read()
    no_dd = _void(data, data.index(b"\x23\xe3\x83\x84"), 8)
    no_dur = _void(data, data.index(b"\x44\x89\x88"), 11)
    for tag, body in (("src", data), ("no_dd", no_dd), ("no_dur", no_dur)):
        path = str(tmp_path / f"{tag}.webm")
        with open(path, "wb") as f:
            f.write(body)
        want, got = _cv2_info(path), vio.video_info(path)
        if tag == "no_dur":
            assert want["frames"] < 0
            want["frames"] = len(_cv2_frames(path))
        assert got == want, tag


def test_short_duration_counts_less_but_every_block_reads(tmp_path):
    """A Duration that understates the blocks: the count is cv2's (Duration
    times fps), and reading goes on to the last block, as cv2's does."""
    body = _build(b"V_VP8", _webm_frames(14)).replace(
        struct.pack(">d", 40.0 * 14), struct.pack(">d", 40.0 * 11))
    path = str(tmp_path / "short.webm")
    with open(path, "wb") as f:
        f.write(body)
    assert vio.video_info(path) == _cv2_info(path)
    assert vio.video_info(path)["frames"] == 11
    _same(list(vio.read_frames(path)), _cv2_frames(path))
    assert len(list(vio.read_frames(path))) == 14


def test_av_reduce_and_standard_rates():
    assert mkv.av_reduce(10 ** 9, 33366700, 30000) == (2997, 100)
    assert mkv.av_reduce(10 ** 9, 3000003, 30000) == (1000, 3)
    assert mkv.av_reduce(10 ** 9, 40_000_000, 30000) == (25, 1)
    assert mkv.std_rate(299) == 25 * 12 * 1001
    assert mkv.std_rate(30 * 12 + 30 + 3) == 24 * 1000 * 12


# ------------------------------------------------------ built files

def test_blockgroups_and_header_stripping_read_as_cv2(tmp_path):
    """BlockGroups (a keyframe: no ReferenceBlock) index the keyframes of
    the SimpleBlock file; a track whose ContentCompression strips the
    start-code prefix every MPEG-4 sample begins with (as mkvmerge writes
    it) reads with it put back: the frames are cv2's."""
    frames = _webm_frames(14)
    keys = [i in (0, 12) for i in range(14)]
    vops = _frames_of(MP4V, 14)
    start = b"\x00\x00\x01"
    assert all(v.startswith(start) for v in vops)
    strip = mkv._el(mkv.CONTENT_ENCODINGS, mkv._el(
        mkv.CONTENT_ENCODING, mkv._el(mkv.CONTENT_COMPRESSION, mkv._uint_el(
            mkv.COMP_ALGO, 3) + mkv._el(mkv.COMP_SETTINGS, start))))
    vol = mkv._el(mkv.CODEC_PRIVATE, mkv.MkvFile(MP4V).dsi)
    for tag, body in (
            ("group", _build(b"V_VP8", frames, keys=keys, group=True)),
            ("plain", _build(b"V_VP8", frames, keys=keys)),
            ("strip", _build(b"V_MPEG4/ISO/ASP", vops, keys=keys,
                             extra_track=vol + strip, strip=start))):
        path = str(tmp_path / f"{tag}.mkv")
        with open(path, "wb") as f:
            f.write(body)
        assert mkv.MkvFile(path).keyframes == [0, 12], tag
        got = list(vio.read_frames(path))
        assert len(got) == 14
        _same(got, _cv2_frames(path))


@pytest.mark.parametrize("codec,name", [
    (b"V_VP9", "VP9"), (b"V_AV1", "AV1"), (b"V_MPEG4/ISO/AVC", "H.264"),
    (b"V_MPEGH/ISO/HEVC", "HEVC"), (b"V_THEORA", "Theora"),
    (b"V_FFV1", "FFV1")])
def test_other_codecs_raise_naming_item_8(tmp_path, codec, name):
    """Codecs the port does not decode, and VP9 in a profile it does not
    read: a crafted profile-2 (10-bit) key frame.  MPEG-2 (``V_MPEG2``),
    once among them, reads: test_mpeg1_and_mpeg2_in_matroska_read; so does
    FFV1 (``V_FFV1``, tests/test_torch_ffv1.py): its track here opens, and
    its VP8 payloads raise as a corrupt FFV1 stream, not as a codec the
    port does not read.  H.264 (``V_MPEG4/ISO/AVC``) is read now
    (tests/test_torch_h264.py); a track of it without its avcC
    CodecPrivate, which cv2 reads no frame of, raises ``ValueError``."""
    frames = _webm_frames(2)
    if codec == b"V_VP9":
        head = int("10" "01" "0010" + format(0x498342, "024b") + "0" * 8, 2)
        frames = [head.to_bytes(5, "big") + bytes(16)] * 2
    path = str(tmp_path / "x.mkv")
    with open(path, "wb") as f:
        f.write(_build(codec, frames))
    if codec == b"V_MPEG4/ISO/AVC":
        assert _cv2_frames(path) == []
        with pytest.raises(ValueError, match="without its avcC") as err:
            list(vio.read_frames(path))
        assert not isinstance(err.value, Unsupported)
        return
    if codec == b"V_FFV1":
        assert mkv.MkvFile(path).codec == "ffv1"
        with pytest.raises(ValueError, match="corrupt FFV1") as err:
            list(vio.read_frames(path))
        assert not isinstance(err.value, Unsupported)
        return
    with pytest.raises(Unsupported, match=f"{name}.*Queue 1 item 8"):
        vio.video_info(path)


def test_mpeg1_and_mpeg2_in_matroska_read():
    """cv2's writer's MPEG-1 and MPEG-2 in Matroska (``V_MPEG1``,
    ``V_MPEG2``; the sequence headers in band), once refused, read as
    cv2.VideoCapture reads them."""
    fixtures = os.path.join(os.path.dirname(__file__), "goldens", "video")
    for v in (1, 2):
        path = os.path.join(fixtures, f"mpeg{v}_176x144.mkv")
        box = mkv.MkvFile(path)
        assert (box.codec, box.tag) == ("mpeg12", f"V_MPEG{v}")
        _same(list(vio.read_frames(path)), _cv2_frames(path))


@pytest.mark.parametrize("what,match", [
    ("zlib", "zlib-compressed"), ("encrypted", "encrypted"),
    ("laced", "laced video block"), ("raw", "FourCC 'UYVY'")])
def test_what_the_port_does_not_read_raises_naming_item_8(tmp_path, what,
                                                          match):
    el, u = mkv._el, mkv._uint_el
    codec, kw = b"V_VP8", {}
    if what == "zlib":
        kw["extra_track"] = el(mkv.CONTENT_ENCODINGS, el(
            mkv.CONTENT_ENCODING, el(mkv.CONTENT_COMPRESSION,
                                     u(mkv.COMP_ALGO, 0))))
    elif what == "encrypted":
        kw["extra_track"] = el(mkv.CONTENT_ENCODINGS, el(
            mkv.CONTENT_ENCODING, el(mkv.CONTENT_ENCRYPTION, b"")))
    elif what == "laced":
        kw["laced"] = True
    else:
        codec = b"V_UNCOMPRESSED"
        kw["extra_video"] = el(mkv.COLOUR_SPACE, b"UYVY")
    path = str(tmp_path / "x.mkv")
    with open(path, "wb") as f:
        f.write(_build(codec, _webm_frames(2), **kw))
    with pytest.raises(Unsupported, match=f"{match}.*Queue 1 item 8"):
        list(vio.read_frames(path))


def test_vfw_fourcc_track_reads_through_avi_rules(tmp_path):
    """V_MS/VFW/FOURCC: the BITMAPINFOHEADER's biCompression picks the
    codec as in AVI (VP80 here), cv2 reads the same frames."""
    bih = struct.pack("<IiiHH4sIiiII", 40, 176, 144, 1, 24, b"VP80", 0, 0,
                      0, 0, 0)
    path = str(tmp_path / "vfw.mkv")
    with open(path, "wb") as f:
        f.write(_build(b"V_MS/VFW/FOURCC", _webm_frames(14),
                       extra_track=mkv._el(mkv.CODEC_PRIVATE, bih)))
    _same(list(vio.read_frames(path)), _cv2_frames(path))


def test_truncated_file_raises(tmp_path):
    data = open(WEBM, "rb").read()
    box = mkv.MkvFile(WEBM)
    path = str(tmp_path / "cut.webm")
    with open(path, "wb") as f:
        f.write(data[:box.offsets[20] + 10])
    with pytest.raises(ValueError, match="truncated"):
        list(vio.read_frames(path))


# ---------------------------------------------------------------- writer

@pytest.mark.parametrize("fps", [25.0, 30000 / 1001])
def test_port_written_mkv_reads_in_cv2_as_the_reconstruction(tmp_path, fps):
    """``.mkv`` out (MPEG-4 Part 2, as cv2's ``mp4v`` writer lays it out):
    cv2 decodes every frame to the encoder's reconstruction, with the
    written count and fps, and seeks into the second GOP; ``.webm`` out
    raises, as cv2's mp4v writer does not open on it."""
    frames = moving_clip(64, 96, 26, seed=11, speed=2.5)
    path = str(tmp_path / "out.mkv")
    wr = vio.Mpeg4Writer(path, fps, (96, 64), keep_recon=True)
    for f in frames:
        wr.write(f)
    wr.release()
    _same(_cv2_frames(path), [mpeg4.i420_to_bgr(*r) for r in wr.recon])
    info = _cv2_info(path)
    assert info["frames"] == 26 and info["fps"] == pytest.approx(fps, 1e-4)
    assert vio.video_info(path) == info
    np.testing.assert_array_equal(vio.read_frame(path, 14),
                                  _cv2_seek(path, 14))
    with pytest.raises(ValueError, match="WebM"):
        vio.AsyncVideoWriter(str(tmp_path / "out.webm"), 25.0, (96, 64))
    assert not cv2.VideoWriter(str(tmp_path / "cv2.webm"),
                               cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                               (96, 64)).isOpened()


# ------------------------------------------------------- the JAX package

def test_jax_consecutive_frames_and_capture_frame_on_mkv(tmp_path):
    ds = datasets.ConsecutiveFrames(MP4V, size_hw=(64, 96), stride=1)
    jds = jdatasets.ConsecutiveFrames(MP4V, size_hw=(64, 96), stride=1)
    assert ds.index == jds.index
    for i in (0, 1, 14, 3):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([MP4V, "13", a]) == 0
        assert jcapture.main([MP4V, "13", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))


@pytest.mark.parametrize("codec,horz,vert,rng", [
    ("vp8", 1, 1, 0), ("vp8", 1, 2, 0), ("vp8", 2, 1, 2), ("vp8", 0, 0, 2),
    ("mpeg4", 1, 1, 2), ("mpeg4", 2, 2, 0), ("i420", 1, 2, 2),
    ("i420", 1, 1, 0), ("i420", 0, 0, 2)])
def test_colour_siting_and_range_reach_the_conversion(tmp_path, codec, horz,
                                                      vert, rng):
    """A Colour element's chroma siting and range, as FFmpeg hands them to
    swscale, at an odd height (the scaler): VP8 takes the siting and its
    decoder's video range; MPEG-4 Part 2 the range and its decoder's left
    siting; raw I420 both.  Every frame equals cv2's."""
    el, u = mkv._el, mkv._uint_el
    colour = el(mkv.COLOUR, (u(mkv.CHROMA_SITING_HORZ, horz) if horz else
                             b"") + (u(mkv.CHROMA_SITING_VERT, vert) if vert
                                     else b"") + (u(mkv.RANGE, rng) if rng
                                                  else b""))
    if codec == "vp8":
        body = _build(b"V_VP8", _frames_of(
            os.path.join(FIXTURES, "vp8_175x143.webm"), 3),
            extra_video=colour)
        size = b"\xb0\x81\xaf\xba\x81\x8f"             # 175x143
    elif codec == "mpeg4":
        from opticalflow_tpu_torch.io.mp4 import Mp4File
        src = os.path.join(FIXTURES, "mpeg4_176x143.mp4")
        box = Mp4File(src)
        with open(src, "rb") as f:
            vops = [box.sample(f, i) for i in range(3)]
        body = _build(b"V_MPEG4/ISO/ASP", vops, extra_video=colour,
                      extra_track=el(mkv.CODEC_PRIVATE, box.dsi))
        size = b"\xb0\x81\xb0\xba\x81\x8f"             # 176x143
    else:
        rng_ = np.random.default_rng(horz + 3 * vert + rng)
        planes = [rng_.integers(0, 256, 64 * 47 + 2 * 32 * 24,
                                np.uint8).tobytes() for _ in range(2)]
        body = _build(b"V_UNCOMPRESSED", planes, keys=[True, True],
                      extra_video=colour + el(mkv.COLOUR_SPACE, b"I420"))
        size = b"\xb0\x81\x40\xba\x81\x2f"             # 64x47
    path = str(tmp_path / "colour.mkv")
    with open(path, "wb") as f:
        f.write(body.replace(b"\xb0\x81\xb0\xba\x81\x90", size))
    assert vio.video_info(path)["height"] % 2
    _same(list(vio.read_frames(path)), _cv2_frames(path))


def test_h263_under_vfw_fourcc_reads_as_cv2():
    """cv2 writes H.263 into Matroska as V_MS/VFW/FOURCC with an H263
    BITMAPINFOHEADER: the AVI rules pick the H.263 decoder; frames, count
    and every seek are cv2's."""
    name = "h263_176x144.mkv"
    path = os.path.join(FIXTURES, name)
    box = mkv.MkvFile(path)
    assert (box.codec, box.tag) == ("h263", "H263")
    want = MANIFEST[name]
    assert vio.video_info(path) == {k: want[k] for k in
                                    ("fps", "width", "height", "frames")}
    assert [hashlib.sha256(f.tobytes()).hexdigest()
            for f in vio.read_frames(path)] == want["sha256"]
    video = vio.EncodedVideo(path)
    for t, hit in want["seeks"].items():
        assert hashlib.sha256(video.frame(int(t)).tobytes()).hexdigest() == \
            want["sha256"][hit], t


@pytest.mark.parametrize("fourcc", ["NV12", "Y41B", "Y8", "yuv4"])
def test_raw_layouts_and_yuv4_read_as_cv2_reads_them(fourcc):
    """cv2's Matroska of raw NV12, Y41B and ``Y8  `` (V_UNCOMPRESSED with
    that FourCC) and of libavcodec's yuv4 (V_MS/VFW/FOURCC): NV12 goes
    through swscale's scaler as its interleaved chroma does, Y41B is
    yuv411p."""
    path = os.path.join(os.path.dirname(__file__), "goldens", "video",
                        f"tag_{fourcc}_64x48.mkv")
    box = mkv.MkvFile(path)
    assert box.codec == ("yuv4" if fourcc == "yuv4" else "raw")
    _same(list(vio.read_frames(path)), _cv2_frames(path))
