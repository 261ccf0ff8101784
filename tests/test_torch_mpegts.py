"""The port's MPEG transport stream demuxer (``io/mpegts``), elementary
stream reader (``io/elementary``) and MPEG-4 Part 2 in program streams
(``io/mpegps``) behind ``io/video``, against OpenCV's FFmpeg
(``cv2.VideoCapture``) and the JAX package's cv2-based readers.

Tolerance: 0 throughout.  The decoders are the port's bit-exact MPEG-1/2,
MPEG-4 Part 2 and H.263 ones, so every frame equals cv2's bit for bit; the
count, fps and the frame every ``CAP_PROP_POS_FRAMES`` seek reads are
cv2's, FFmpeg's quirks included (an MPEG-1 transport stream read at twice
its rate, a seek that lands a GOP late or reads nothing, an elementary
stream's negative count).  The fixtures are ``tests/goldens/video/``'s
``*.ts``, ``*.m2ts``, ``*.mts``, ``*.m1v``, ``*.m2v``, ``*.mpv``,
``*.h263``, ``*.263`` and ``mpeg4_*.mpg``; the manifest holds cv2's
digests, counts and seeks, which the GPU machine checks without cv2.
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

from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.elementary import ElementaryFile, nopts_count
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.io.mpegpes import mpeg4_vol_rate, split_starts
from opticalflow_tpu_torch.io.mpegps import MpegPsFile
from opticalflow_tpu_torch.io.mpegts import MpegTsFile, packet_size
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
from make_video_fixtures import Lavf, with_stream_type

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
TS_EXTS = (".ts", ".m2ts", ".mts")
ES_EXTS = (".m1v", ".m2v", ".mpv", ".h263", ".263")
TS = sorted(n for n in MANIFEST if n.endswith(TS_EXTS)
            and not n.startswith("ts_"))
ES = sorted(n for n in MANIFEST if n.endswith(ES_EXTS))
PS4 = sorted(n for n in MANIFEST if n.startswith("mpeg4_")
             and n.endswith(".mpg"))
ALL = TS + ES + PS4
TS2 = os.path.join(FIXTURES, "mpeg2_176x144.ts")
# an elementary stream whose bit rate gives cv2 a count of 2 or more: FFmpeg's
# generic index seek, which the port refuses
GENERIC_SEEK = {"mpeg2_cbr_176x144.m2v"}


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

def test_fixtures_cover_the_containers_codecs_and_quirks():
    assert {"mpeg2_176x144.ts", "mpeg2_176x144.m2ts", "mpeg2_176x144.mts",
            "mpeg1_176x144.ts", "mpeg4_176x144.ts",
            "mpeg2_sintel_436x1024.ts", "mpeg2_split_gaps_176x144.ts",
            "mpeg1_type1_176x144.ts"} <= set(TS)
    assert {"mpeg1_176x144.m1v", "mpeg2_176x144.m2v", "mpeg2_64x48.mpv",
            "h263_176x144.h263", "h263_128x96.263",
            "mpeg2_cbr_176x144.m2v"} <= set(ES)
    assert PS4 == ["mpeg4_176x144.mpg"]
    # the quirks cv2 shows on them
    assert MANIFEST["mpeg1_176x144.ts"]["fps"] == 50.0
    assert MANIFEST["mpeg2_176x144.m2v"]["frames"] == -192153584101141
    assert MANIFEST["mpeg1_176x144.m1v"]["frames"] == 0
    assert MANIFEST["mpeg2_176x144.ts"]["seeks"]["0"] == 12
    assert MANIFEST["mpeg2_sintel_436x1024.ts"]["seeks"]["1"] is None
    assert MANIFEST["mpeg4_176x144.mpg"]["frames"] < MANIFEST[
        "mpeg4_176x144.mpg"]["decoded"]


@pytest.mark.parametrize("name", ALL)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", ALL)
def test_video_info_equals_cv2(name):
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", [n for n in ALL if n not in GENERIC_SEEK])
def test_every_seek_reads_the_frame_cv2_reads(name):
    """A CAP_PROP_POS_FRAMES seek on a capture just opened reads the frame
    the manifest records cv2 reading, or nothing where cv2 reads nothing."""
    path = _path(name)
    want = MANIFEST[name]
    video = vio.EncodedVideo(path)
    for t, hit in want["seeks"].items():
        if hit is None:
            assert video.seek_target(int(t)) is None, t
            with pytest.raises(ValueError, match="reads no frame"):
                video.frame(int(t))
        else:
            assert _digest(video.frame(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", sorted(GENERIC_SEEK))
def test_a_seek_through_the_generic_index_is_refused(name):
    video = vio.EncodedVideo(_path(name))
    assert video.frames >= 2
    for t in MANIFEST[name]["seeks"]:
        with pytest.raises(Unsupported, match="generic index seek.*item 8"):
            video.frame(int(t))


@pytest.mark.parametrize("name", ["mpeg2_176x144.ts", "mpeg1_176x144.ts",
                                  "mpeg4_176x144.ts", "mpeg4_176x144.mpg"])
def test_seeks_equal_live_cv2(name):
    path = _path(name)
    frames = _cv2_frames(path)
    for i in (0, 3, 13, 17, 25):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, want = cap.read()
        cap.release()
        if not ok:
            with pytest.raises(ValueError):
                vio.read_frame(path, i)
            continue
        np.testing.assert_array_equal(vio.read_frame(path, i), want,
                                      err_msg=f"{i}")
        assert any(np.array_equal(want, f) for f in frames)


# ------------------------------------------------------------ the demuxer

def test_packet_sizes_and_pids():
    ts, m2ts = MpegTsFile(TS2), MpegTsFile(_path("mpeg2_176x144.m2ts"))
    assert (ts.raw, ts.pos47, ts.pid, ts.stream_type) == (188, 0, 0x100, 2)
    # the M2TS muxer: 4-byte headers, its own PMT and video PIDs
    assert (m2ts.raw, m2ts.pos47, m2ts.pid) == (192, 4, 0x1011)
    assert MpegTsFile(_path("mpeg4_176x144.ts")).codec == "mpeg4"
    assert MpegTsFile(_path("mpeg1_type1_176x144.ts")).stream_type == 1
    assert packet_size(b"\x00" * 100) is None


def test_fec_packets_of_204_bytes(tmp_path):
    """16 bytes after each packet (DVB's FEC): the probe finds 204, the
    frames are the same."""
    data = open(TS2, "rb").read()
    path = str(tmp_path / "fec.ts")
    with open(path, "wb") as f:
        for k in range(0, len(data), 188):
            f.write(data[k:k + 188] + bytes(range(16)))
    assert MpegTsFile(path).raw == 204
    _same(list(vio.read_frames(path)), list(vio.read_frames(TS2)))


def test_split_pes_packets_and_continuity_gaps():
    """libavcodec's MPEG-2 muxed with pictures split over two PES packets
    (the second without timestamps, starting mid-picture) and continuity
    counters that jump: FFmpeg keeps the bytes and the frames."""
    box = MpegTsFile(_path("mpeg2_split_gaps_176x144.ts"))
    assert box.gaps == 5
    assert len(box.pes) == 26 + len(range(0, 26, 3))
    assert sum(p.pts is None for p in box.pes) == len(range(0, 26, 3))
    assert all(t is not None for t in box.pts)


def test_bounded_pes_and_stream_type_1():
    box = MpegTsFile(_path("mpeg1_type1_176x144.ts"))
    assert (box.codec, box.mpeg2, box.fps, box.r_frame_rate) == (
        "mpeg12", False, 50.0, 50)


def test_unbounded_pes_starts_at_the_pusi():
    box = MpegTsFile(TS2)
    data = open(TS2, "rb").read()
    for p in box.pes:
        assert data[p.pos] == 0x47 and data[p.pos + 1] & 0x40
        assert data[p.pos + 4:p.pos + 7] == b"\x00\x00\x01" or data[
            p.pos + 5 + data[p.pos + 4]:p.pos + 8 + data[p.pos + 4]] == \
            b"\x00\x00\x01"


_with_stream_type = with_stream_type


@pytest.mark.parametrize("st,name", [(0x1B, "H.264"), (0x24, "HEVC"),
                                     (0xEA, "VC-1")])
def test_other_video_in_a_transport_stream_raises_naming_it(tmp_path, st,
                                                             name):
    """HEVC and VC-1 raise naming their type and item 8.  H.264 (0x1B) is
    read: the MPEG-2 payload relabelled so reads as FFmpeg's probe reads it
    (the first two PES packets split by the h264 parser, then MPEG-2; the
    pictures they held concealed by the MPEG-2 decoder): cv2's 30 frames,
    bit for bit, and its fps, size and count."""
    path = str(tmp_path / "other.ts")
    _with_stream_type(TS2, path, st)
    if st == 0x1B:
        want = _cv2_frames(path)
        assert len(want) == 30
        _same(list(vio.read_frames(path)), want)
        assert vio.video_info(path) == _cv2_info(path)
        return
    with pytest.raises(Unsupported, match=f"{name}.*0x{st:02x}.*item 8"):
        vio.EncodedVideo(path)


@pytest.mark.parametrize("name,frames", [
    ("mpeg2_176x144.ts", 30), ("mpeg2_sintel_436x1024.ts", 13),
    ("mpeg2_pts_only_176x144.ts", 0),
    ("mpeg2_sintel_low_delay_436x1024.ts", 0),
    ("mpeg2_split_gaps_176x144.ts", 0)])
def test_mpeg2_under_the_h264_type_reads_as_ffmpegs_probe_reads_it(
        tmp_path, name, frames):
    """MPEG-2 relabelled 0x1B (H.264).  Where each of the first two PES
    packets carries a DTS other than its PTS, FFmpeg's h264 parser splits
    them (slices without a picture header among the packets, which its
    MPEG-2 decoder passes over; what the parser held back is lost) and its
    probe switches the stream to MPEG-2: the port hands its decoder
    libavformat's packets and reads cv2's frames (those from the cut
    pictures concealed as error_resilience.c conceals them), fps, size,
    count and every seek.  Elsewhere nothing switches: cv2 reads no frame
    and the port raises ``ValueError`` (no H.264 there)."""
    path = str(tmp_path / "relabelled.ts")
    _with_stream_type(_path(name), path, 0x1B)
    want = _cv2_frames(path)
    assert len(want) == frames
    if not frames:
        with pytest.raises(ValueError):
            list(vio.read_frames(path))
        return
    video = vio.EncodedVideo(path)
    with open(path, "rb") as f:
        mine = [video.box.sample(f, i) for i in range(video.samples)]
    assert mine == [p for p, _, _ in Lavf().packets(path)]
    _same(list(vio.read_frames(path)), want)
    assert vio.video_info(path) == _cv2_info(path)
    for t in range(frames):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, t)
        ok, frame = cap.read()
        cap.release()
        if not ok:
            with pytest.raises(ValueError, match="reads no frame"):
                video.frame(t)
            continue
        np.testing.assert_array_equal(video.frame(t), frame, err_msg=f"{t}")


def test_mpeg1_under_the_h264_type_raises_naming_item_8(tmp_path):
    """MPEG-1 relabelled 0x1B: FFmpeg's probe reads it as MPEG video too
    (cv2 reads 29 frames); the port refuses it."""
    path = str(tmp_path / "relabelled.ts")
    _with_stream_type(_path("mpeg1_176x144.ts"), path, 0x1B)
    assert len(_cv2_frames(path)) == 29
    with pytest.raises(Unsupported, match=f"MPEG-1 video under.*{ITEM_8}"):
        vio.EncodedVideo(path)


@pytest.mark.parametrize("name", ["ts_h263_128x96.ts", "ts_ffv1_48x32.ts"])
def test_h263_and_ffv1_in_a_transport_stream_are_refused(name):
    """FFmpeg's muxer writes them as private data (0x06); cv2 opens no video
    there (count -1, no frame) and the port refuses them."""
    assert MANIFEST[name]["decoded"] == 0 and MANIFEST[name]["frames"] == -1
    assert _cv2_info(_path(name))["frames"] == -1
    with pytest.raises(Unsupported, match="0x06.*private data"):
        vio.EncodedVideo(_path(name))
    assert "0x06" in MANIFEST[name]["port_refuses"]


def test_writing_the_new_kinds_is_refused(tmp_path):
    """Elementary streams stay refused (cv2's mp4v writer opens none);
    transport streams are written (tests/test_torch_video_out.py)."""
    for ext in (".m2v", ".h263"):
        with pytest.raises(ValueError, match="cannot write.*elementary"):
            vio.AsyncVideoWriter(str(tmp_path / f"x{ext}"), 25, (64, 48))


def test_a_seek_search_builds_ffmpegs_index():
    """``MpegTsFile.seek`` keeps the {DTS: pos} entries ``mpegts_get_dts``
    adds; a second search starts from them and lands where the first did."""
    box = MpegTsFile(TS2)
    index: dict = {}
    ts = box.start_time + 3600 * 14
    first = box.seek(ts, index)
    assert index and all(box.pes[0].pos <= p < box.size
                         for p in index.values())
    assert box.seek(ts, index) == first
    assert box.seek(box.start_time - 1, {}) == box.pes[0].es


# ------------------------------------ PES headers with a PTS alone

PTS_ONLY = ("mpeg2_pts_only_176x144.ts", "mpeg2_pts_only_176x144.m2ts",
            "mpeg1_pts_only_176x144.ts")


@pytest.mark.parametrize("name", PTS_ONLY)
def test_pts_only_headers_seek_where_cv2_does(name):
    """B-pictures muxed with a PTS alone in each PES header (DTS = PTS):
    FFmpeg's ``compute_pkt_fields`` takes an I- or P-picture's DTS away
    (a decoding delay and DTS = PTS) and gives it the PTS of the last I- or
    P-picture read since the search's flush, so ``ff_gen_search`` lands a
    GOP late and seeks to 0-12 read frames 12 and 13 in cv2.  The port
    reads cv2's frame at every seek; it read frames 0-12 before it
    followed FFmpeg here."""
    want = MANIFEST[name]["seeks"]
    assert [want[str(t)] for t in range(13)] == [12] + [13] * 12
    video = vio.EncodedVideo(_path(name))
    assert {t: video.seek_target(int(t)) for t in want} == want


@pytest.mark.parametrize("name", PTS_ONLY[:2])
def test_pts_only_seeks_equal_live_cv2(name):
    path = _path(name)
    for i in (0, 5, 12, 14, 21):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, want = cap.read()
        cap.release()
        assert ok
        np.testing.assert_array_equal(vio.read_frame(path, i), want,
                                      err_msg=f"{i}")


def test_pts_only_read_timestamp_passes_over_the_first_picture():
    """``mpegts_get_dts`` from the file's start: the I-picture's DTS is
    taken away and no I- or P-picture came before it, so it is passed
    over; the P-picture after it carries the I-picture's PTS.  With the
    DTS written (the same pictures in ``mpeg2_split_gaps_176x144.ts``'s
    muxing) the I-picture's own DTS is read."""
    box = MpegTsFile(_path("mpeg2_pts_only_176x144.ts"))
    assert box.delay and box.types[:2] == [1, 2]
    index: dict = {}
    pos, dts = box._read_ts(0, None, index)
    assert (pos, dts) == (box._parsed[1][0], box.pts[0])
    assert index == {box.pts[0]: pos}
    real = MpegTsFile(_path("mpeg2_split_gaps_176x144.ts"))
    assert real._read_ts(0, None, {}) == (real.pes[0].pos, real.dts[0])


def test_pts_only_program_stream_stays_exact():
    """The same pictures with a PTS alone in a program stream: FFmpeg's
    PES index lands on each picture asked for (every seek exact, in cv2 and
    the port)."""
    name = "mpeg2_pts_only_176x144.mpg"
    want = MANIFEST[name]["seeks"]
    assert want == {str(t): t for t in range(30)}
    video = vio.EncodedVideo(_path(name))
    assert {t: video.seek_target(int(t)) for t in want} == want


# ---------------------------------------------------- pictures and timing

def test_mpeg4_split_and_vol_rate():
    box = MpegTsFile(_path("mpeg4_176x144.ts"))
    assert box.rate == 25 and box.keyframes == [0, 12, 24]
    with open(box.path, "rb") as f:
        first = box.sample(f, 0)
    assert mpeg4_vol_rate(first) == 25
    assert first.startswith(b"\x00\x00\x01\xb0")       # VOS, VO, VOL, VOP
    starts, pictures, total = split_starts(
        [(0, b"\x00\x00\x01\xb0\x01\x00\x00\x01\xb6\x10\x20"
             b"\x00\x00\x01\xb6\x50\x60")], "mpeg4")
    assert (starts, pictures, total) == ([0, 11], [5, 11], 17)


def test_h263_split_at_picture_start_codes():
    starts, pictures, _ = split_starts(
        [(0, b"\x00\x00\x80\x02\x11\x00\x00\x82\x06\x22")], "h263")
    assert starts == pictures == [0, 5]


def test_program_stream_mpeg4_is_read_h264_refused(tmp_path):
    box = MpegPsFile(_path("mpeg4_176x144.mpg"))
    assert (box.codec, box.rate, box.keyframes) == ("mpeg4", 25, [0, 12, 24])
    data = bytearray(open(_path("mpeg4_176x144.mpg"), "rb").read())
    i = data.find(b"\x00\x00\x01\xb0")
    data[i:i + 6] = b"\x00\x00\x00\x01\x67\x42"        # an H.264 SPS
    path = str(tmp_path / "h264.mpg")
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(Unsupported, match="H.264.*item 8"):
        MpegPsFile(path)


def test_an_elementary_stream_in_a_program_stream_name_points_there(tmp_path):
    path = str(tmp_path / "raw.mpg")
    with open(path, "wb") as f:
        f.write(open(_path("mpeg2_176x144.m2v"), "rb").read())
    with pytest.raises(ValueError, match="io/elementary"):
        MpegPsFile(path)


def test_elementary_counts_follow_opencvs_arithmetic():
    assert nopts_count(25.0) == -192153584101141
    assert nopts_count(30.0) == int(np.floor(
        float(-(1 << 63)) * (1 / 1200000) * 30 + 0.5))
    m1 = ElementaryFile(_path("mpeg1_176x144.m1v"))
    assert (m1.bit_rate, m1.frames) == (0x3FFFF * 400, 0)
    assert ElementaryFile(_path("mpeg2_176x144.m2v")).bit_rate == 0
    cbr = ElementaryFile(_path("mpeg2_cbr_176x144.m2v"))
    assert cbr.bit_rate and cbr.frames == MANIFEST[
        "mpeg2_cbr_176x144.m2v"]["frames"]


def test_h263_at_29_97_hz_reads_at_25():
    """The raw demuxers' default rate: cv2 reports 25 fps for H.263 whose
    source formats run at 29.97 Hz."""
    assert vio.video_info(_path("h263_176x144.h263"))["fps"] == 25.0


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["mpeg2_176x144.ts", "mpeg1_176x144.m1v",
                                  "h263_176x144.h263", "mpeg4_176x144.mpg"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=10, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=10, stride=2)))


@pytest.mark.parametrize("name", ["mpeg2_176x144.ts", "mpeg1_176x144.ts",
                                  "mpeg4_176x144.ts", "mpeg4_176x144.mpg"])
def test_jax_consecutive_frames_equal(name):
    """In order (one open decoder), then out of order: every other read a
    seek on the same capture (FFmpeg's index kept between them)."""
    path = _path(name)
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    assert ds.index == jds.index
    for i in (0, 1, 2, 19, 4, 21, 6, 25, 16, 9):
        if i < len(ds.index):
            np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                          err_msg=f"pair {i}")


@pytest.mark.parametrize("name,frame", [("mpeg2_176x144.ts", 13),
                                        ("mpeg4_176x144.ts", 20),
                                        ("mpeg2_176x144.m2ts", 7)])
def test_jax_capture_frame_equals(tmp_path, name, frame):
    path = _path(name)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, str(frame), a]) == 0
        assert jcapture.main([path, str(frame), b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))


def test_capture_frame_where_cv2_reads_nothing(tmp_path):
    """A seek into the Sintel .ts reads nothing in cv2 (the JAX CLI exits
    1): the port's CLI exits 1 too."""
    path = _path("mpeg2_sintel_436x1024.ts")
    out = str(tmp_path / "x.png")
    with contextlib.redirect_stderr(io.StringIO()):
        assert jcapture.main([path, "5", out]) == 1
        assert capture_frame.main([path, "5", out]) == 1
