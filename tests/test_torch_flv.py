"""Sorenson H.263 (``runtime/h263``'s Sorenson reading) in Flash Video
(``io/flv``), AVI, Matroska and QuickTime against OpenCV's FFmpeg and the
JAX package's cv2-based readers.

Tolerance: 0 throughout.  The decoder is FFmpeg's integer arithmetic (the
simple IDCT, H.263's dequantisation and half-pel prediction) and the
conversion swscale's (``runtime/mpeg4.i420_to_bgr``), so every frame
equals cv2's bit for bit: on the committed fixtures (``tests/goldens/
video``, group ``sorenson``: cv2's writer in each container; libavcodec's
``flv`` encoder at quantiser 1, an odd size, a standard size code and the
Sintel pair; H.263 pictures re-headed as version 0; disposable pictures),
through every seek cv2 makes and in the JAX package's readers.  The
library is built once for the module (g++, a few seconds).
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
from opticalflow_tpu_torch.io.avi import AviFile, codec_of
from opticalflow_tpu_torch.io.flv import FlvFile, av_d2q
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.runtime import h263
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
FLV = sorted(n for n, e in MANIFEST.items() if e["group"] == "sorenson")
VP9 = sorted(n for n, e in MANIFEST.items() if e["group"] == "flv_vp9")
# a disposable picture right after the first key frame: FFmpeg skips it
# in a capture just opened, not after a seek
NEAR_KEY = "flv_disposable_key_96x64.flv"
# one right after the later key frame alone: shown in order and after a seek
LATER_KEY = "flv_disposable_later_key_96x64.flv"


@pytest.fixture(scope="module", autouse=True)
def library():
    return h263.load()


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


def _packets(name):
    v = vio.EncodedVideo(_path(name))
    with open(v.path, "rb") as f:
        return [v.box.sample(f, i) for i in range(v.samples)]


# ---------------------------------------------------------------- fixtures

def test_fixtures_cover_what_cv2_writes_and_reads():
    """cv2's writer: FLV1 in .flv (codec id 2), .avi, .mkv and .mov; the
    full-width clip the card run reads."""
    need = {f"flv_96x64.{ext}" for ext in ("flv", "avi", "mkv", "mov")}
    need |= {"flv_sintel_436x1024.flv", "flv_v0_128x96.flv",
             "flv_q1_128x96.flv", "flv_disposable_96x64.flv", NEAR_KEY,
             LATER_KEY}
    assert need <= set(FLV)
    assert os.path.getsize(_path("flv_sintel_436x1024.flv")) < 1 << 20
    total = sum(os.path.getsize(_path(n)) for n in FLV)
    assert total <= 500_000, total
    assert not any("port_refuses" in MANIFEST[n] for n in FLV)
    assert MANIFEST["flv_sintel_436x1024.flv"]["decoded"] == 13


@pytest.mark.parametrize("name", FLV)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", FLV)
def test_video_info_equals_cv2(name):
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", FLV)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """OpenCV's seek lands on the key frame before its target (FFmpeg's
    generic index seek in FLV, the index elsewhere) and counts on: every
    recorded seek reads its own packet's picture (in NEAR_KEY, where the
    sequential read skips packet 1, seek t reads frame t - 1 of it and
    seek 1 a picture it never shows)."""
    want = MANIFEST[name]
    video = vio.EncodedVideo(_path(name))
    seeks = {str(t): t for t in range(want["decoded"])}
    if name == NEAR_KEY:
        seeks.update({str(t): t - 1 for t in range(2, want["decoded"])},
                     **{"1": -1})
    assert want["seeks"] == seeks
    for t, hit in want["seeks"].items():
        digest = (want["seek_sha256"][t] if hit == -1 else
                  want["sha256"][hit])
        assert _digest(video.frame(int(t))) == digest, t
        video.close()       # a capture just opened: read(t) seeks
        assert _digest(video.read(int(t))) == digest, t


def test_a_disposable_picture_after_the_first_key_frame():
    """FFmpeg skips a disposable picture while it holds no last picture:
    a capture just opened reads 13 of the 14; after OpenCV's seek (its
    first read decoded pictures before it) none is skipped, and a seek to
    1 reads packet 1's picture, as cv2's does."""
    want = MANIFEST[NEAR_KEY]
    assert want["decoded"] == 13 and want["frames"] == 14
    video = vio.EncodedVideo(_path(NEAR_KEY))
    dec = video._decoder()
    out = [dec.decode(p) for p in _packets(NEAR_KEY)]
    assert [i for i, p in enumerate(out) if p is None] == [1]
    assert {"flv_disposable", "flv_dropped"} <= set(dec.sorenson_features)
    dec = video._decoder(seeking=True)
    assert all(dec.decode(p) is not None for p in _packets(NEAR_KEY))
    assert "flv_dropped" not in dec.sorenson_features
    cap = cv2.VideoCapture(_path(NEAR_KEY))
    cap.set(cv2.CAP_PROP_POS_FRAMES, 1)
    ok, frame = cap.read()
    assert ok
    np.testing.assert_array_equal(video.frame(1), frame)
    assert _digest(frame) == want["seek_sha256"]["1"]
    # reading on from a capture just opened skips packet 1, as cv2's does
    video.close()
    assert _digest(video.read(0)) == want["sha256"][0]
    assert _digest(video.read(1)) == want["sha256"][1]


def test_reading_on_past_a_skipped_disposable_picture():
    """cv2 counts its reads, not the packets: read(t) in order is cv2's
    t-th read, packet t + 1 from t = 1 on, with no seek between; the
    14th read finds no frame, as cv2's does."""
    video = vio.EncodedVideo(_path(NEAR_KEY))
    want = _cv2_frames(_path(NEAR_KEY))
    assert len(want) == 13
    for t, frame in enumerate(want):
        np.testing.assert_array_equal(video.read(t), frame, err_msg=str(t))
    with pytest.raises(ValueError, match="frame 13 did not decode"):
        video.read(13)


def test_a_disposable_picture_after_a_later_key_frame():
    """A seek to packet 13 decodes it from key frame 12: FFmpeg shows it,
    as it shows packet 1 after a seek in NEAR_KEY, where a decoder that
    had just started at a key frame would skip it."""
    video = vio.EncodedVideo(_path(LATER_KEY))
    assert video.keyframes == [0, 12]
    assert h263.sorenson_header(_packets(LATER_KEY)[13])["disposable"]
    assert [i for i, _ in video.planes(12)] == [12]
    assert [i for i, _ in video.planes(12, seeking=True)] == [12, 13]
    cap = cv2.VideoCapture(video.path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, 13)
    ok, frame = cap.read()
    cap.release()
    assert ok
    np.testing.assert_array_equal(video.frame(13), frame)
    video.close()
    np.testing.assert_array_equal(video.read(13), frame)
    assert _digest(frame) == MANIFEST[LATER_KEY]["sha256"][13]


@pytest.mark.parametrize("name", FLV)
def test_manifest_features_are_the_decoders(name):
    dec = h263.Decoder(sorenson=True)
    for p in _packets(name):
        dec.decode(p)
    assert dec.features + dec.sorenson_features == \
        MANIFEST[name]["flv_features"]


def test_what_each_fixture_reaches_and_what_none_does():
    need = {"flv_96x64.flv": {"flv_version_1", "flv_custom_size", "escape",
                              "p_pictures"},
            "flv_q1_128x96.flv": {"flv_escape_11"},
            "flv_v0_128x96.flv": {"flv_version_0", "mv4", "escape"},
            "flv_disposable_96x64.flv": {"flv_disposable"},
            LATER_KEY: {"flv_disposable"},
            "flv_sintel_436x1024.flv": {"skipped_mb", "intra_mb_in_p"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["flv_features"]), name
    reached = {f for n in FLV for f in MANIFEST[n]["flv_features"]}
    assert _MANIFEST["flv_unreached"] == [
        f for f in h263.SORENSON_FEATURES if f not in reached] == []


# ------------------------------------------------------------- headers

def test_sorenson_headers_are_not_h263_headers():
    """A version-1 header never passes H.263's 22-bit PSC test, so the
    Sorenson reader is its own; each size code and picture type."""
    packets = _packets("flv_96x64.flv")
    head = h263.sorenson_header(packets[0])
    assert head == {"version": 1, "intra": True, "disposable": False,
                    "size": (96, 64)}
    assert [h263.is_intra(p, sorenson=True) for p in packets] == \
        [i in (0, 12) for i in range(14)]
    assert not any(h263.is_intra(p) for p in packets)
    assert h263.picture_size(packets[0]) is None
    assert h263.picture_size(_packets("flv_sintel_436x1024.flv")[0],
                             sorenson=True) == (1024, 436)
    assert h263.picture_size(_packets("flv_176x144.flv")[0],
                             sorenson=True) == (176, 144)
    assert h263.sorenson_header(_packets("flv_v0_128x96.flv")[0])[
        "version"] == 0
    heads = [h263.sorenson_header(p)
             for p in _packets("flv_disposable_96x64.flv")]
    assert [i for i, x in enumerate(heads) if x["disposable"]] == [5, 9]
    assert h263.sorenson_header(b"\x00\x01\x84\x40" + bytes(8)) is None
    assert h263.sorenson_header(b"junk") is None


def test_a_bad_version_is_corrupt():
    p = bytearray(_packets("flv_96x64.flv")[0])
    p[2] = p[2] & 0x80 | 5 << 2         # version 5
    with pytest.raises(ValueError, match="corrupt Sorenson.*version"):
        h263.Decoder(sorenson=True).decode(bytes(p))


def test_damaged_packets_never_crash():
    packets = _packets("flv_q1_128x96.flv")
    rng = np.random.default_rng(8)
    for _ in range(30):
        dec = h263.Decoder(sorenson=True)
        dec.decode(packets[0])
        data = bytearray(packets[1])
        for _ in range(4):
            data[int(rng.integers(4, len(data)))] ^= int(rng.integers(1, 256))
        try:
            dec.decode(bytes(data))
        except ValueError:
            pass


# ------------------------------------------------------------- containers

def test_flv_demuxer_reads_what_ffmpeg_reads():
    box = FlvFile(_path("flv_96x64.flv"))
    assert (box.codec, box.tag, box.fps, box.frames) == ("flv1", "FLV1",
                                                         25.0, 14)
    assert box.keyframes == [0, 12]
    assert box.stamps == [40 * i for i in range(14)]
    assert (box.width, box.height) == (96, 64)
    assert box.meta["videocodecid"] == 2.0
    assert [box.number(i) for i in range(14)] == list(range(14))
    assert box.numbered
    for other in (AviFile(_path("flv_96x64.avi")),
                  MkvFile(_path("flv_96x64.mkv")),
                  Mp4File(_path("flv_96x64.mov"))):
        assert (other.codec, other.tag) == ("flv1", "FLV1")
        assert other.keyframes == [0, 12]
    assert codec_of("flv1", "x.avi") == "flv1"


def test_fps_is_av_d2q_of_the_metadata_rate():
    """FFmpeg's av_d2q(rate, 1000): the closest ratio with terms up to
    1000 (the values libavutil 60 gives)."""
    for rate, want in ((25.0, (25, 1)), (12.5, (25, 2)), (29.97, (989, 33)),
                       (30000 / 1001, (989, 33)), (23.976, (983, 41)),
                       (59.94, (959, 16)), (14.985, (989, 66)),
                       (1 / 3, (1, 3))):
        assert av_d2q(rate, 1000) == want, rate


def _flv(tag_flags: bytes, body: bytes = b"\0" * 8) -> bytes:
    data = tag_flags + body
    tag = bytes([9]) + len(data).to_bytes(3, "big") + bytes(7) + data
    return (b"FLV\x01\x01" + struct.pack(">I", 9) + bytes(4) + tag
            + struct.pack(">I", 11 + len(data)))


@pytest.mark.parametrize("flags,what", [
    (b"\x17", "H.264"), (b"\x14", "VP6"), (b"\x13", "Screen video"),
    (b"\x90", "enhanced FLV")])
def test_other_flv_codecs_raise_naming_item_8(tmp_path, flags, what):
    """VP6, Screen video and an enhanced FLV tag of a FourCC the port does
    not read (here four zero bytes, which cv2 opens nothing of) raise
    naming item 8.  H.264 (codec id 7) is read now (tests/test_torch_h264.py):
    a tag of a sequence header alone, of which cv2 reads no frame, raises
    ``ValueError`` (no video frame)."""
    path = tmp_path / "other.flv"
    path.write_bytes(_flv(flags))
    if what == "H.264":
        assert _cv2_frames(str(path)) == []
        with pytest.raises(ValueError, match="no video frames") as err:
            vio.EncodedVideo(str(path))
        assert not isinstance(err.value, Unsupported)
        return
    with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}") as err:
        vio.EncodedVideo(str(path))
    if flags == b"\x90":
        assert "FourCC '\\x00\\x00\\x00\\x00' (an unknown codec)" in str(
            err.value)
        assert not cv2.VideoCapture(str(path)).isOpened()


def _rewritten(tmp_path, old: bytes, new: bytes, stamps=None) -> str:
    """flv_96x64.flv with ``old`` replaced by ``new`` (the same length) and
    each video tag's timestamp set by ``stamps(ms)``."""
    data = bytearray(open(_path("flv_96x64.flv"), "rb").read())
    assert data.count(old) == 1 and len(old) == len(new)
    data = data.replace(old, new)
    if stamps is not None:
        for offset in FlvFile(_path("flv_96x64.flv")).offsets:
            head = offset - 12          # the tag header: type, size, stamp
            ms = int.from_bytes(data[head + 4:head + 7], "big")
            data[head + 4:head + 7] = stamps(ms).to_bytes(3, "big")
    path = tmp_path / "rewritten.flv"
    path.write_bytes(bytes(data))
    return str(path)


# ------------------------------------------------- VP9 in enhanced FLV

@pytest.mark.parametrize("name", VP9)
def test_vp9_in_enhanced_flv_reads_as_cv2_reads_it(name):
    """cv2's writer's VP90 and VP09 (FFmpeg's flv muxer falls back to the
    ``vp09`` FourCC of the extended tag header): frames, fps, count and
    every seek as cv2's."""
    path, want = _path(name), MANIFEST[name]
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == want["sha256"]
    assert vio.video_info(path) == _cv2_info(path) == {
        k: want[k] for k in ("fps", "width", "height", "frames")}
    video = vio.EncodedVideo(path)
    assert want["seeks"] == {str(t): t for t in range(want["decoded"])}
    for t, hit in want["seeks"].items():
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t


def test_the_extended_tag_header_as_flvdec_reads_it():
    """SequenceStart carries the vpcC record and no frame, the Metadata
    tag (colorInfo, frame type 5) none either; CodedFrames hold the VP9
    frame right after the FourCC (no composition time: only AVC and HEVC
    carry one); the key frames are the tags of frame type 1."""
    box = FlvFile(_path("flv_vp9_96x64.flv"))
    assert (box.codec, box.tag) == ("vp9", "VP90")
    assert box.dsi[:4] == b"\x01\x00\x00\x00" and len(box.dsi) == 12
    with open(box.path, "rb") as f:
        first = box.sample(f, 0)
    assert first[0] >> 6 == 2 and first[1:4] == b"\x49\x83\x42"
    assert box.keyframes[0] == 0 and len(box.sizes) == 12


@pytest.mark.parametrize("fourcc,what", [
    (b"av01", "AV1"), (b"hvc1", "HEVC"), (b"avc1", "H.264")])
def test_other_enhanced_flv_fourccs_raise_naming_item_8(tmp_path, fourcc,
                                                        what):
    data = bytearray(open(_path("flv_vp9_96x64.flv"), "rb").read())
    assert data.count(b"vp09") == data.count(b"vp09")
    data = data.replace(b"vp09", fourcc)
    path = tmp_path / "other.flv"
    path.write_bytes(bytes(data))
    with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
        vio.EncodedVideo(str(path))


def test_an_extended_header_without_its_fourcc_or_multitrack_raises(
        tmp_path):
    for flags, body, what in ((b"\x91", b"vp", "without its FourCC"),
                              (b"\x96", b"\0" * 8, "multitrack")):
        path = tmp_path / "short.flv"
        path.write_bytes(_flv(flags, body))
        with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
            vio.EncodedVideo(str(path))


@pytest.mark.parametrize("key", ["framerate", "duration"])
def test_an_flv_without_its_rate_or_duration_raises_naming_item_8(
        tmp_path, key):
    """Without them FFmpeg guesses the rate and count from its probe,
    which the port does not reproduce."""
    path = _rewritten(tmp_path, key.encode(), key[:-1].encode() + b"X")
    with pytest.raises(Unsupported, match=f"onMetaData {key}.*{ITEM_8}"):
        vio.EncodedVideo(path)


def test_a_seek_numbered_otherwise_than_the_frames_raises_naming_item_8(
        tmp_path):
    """Timestamps 80 ms apart at a metadata rate of 25: OpenCV numbers the
    frames 0, 2, 4, ...; the sequential read is cv2's, a seek raises."""
    path = _rewritten(tmp_path, b"framerate", b"framerate",
                      stamps=lambda ms: 2 * ms)
    video = vio.EncodedVideo(path)
    assert not video.box.numbered
    assert [video.box.number(i) for i in range(3)] == [0, 2, 4]
    _same(list(vio.read_frames(path)), _cv2_frames(path))
    np.testing.assert_array_equal(video.read(0), _cv2_frames(path)[0])
    for t in (0, 3):
        with pytest.raises(Unsupported, match=f"numbers otherwise.*{ITEM_8}"):
            video.frame(t)


def test_truncated_and_written_flv(tmp_path):
    data = open(_path("flv_96x64.flv"), "rb").read()
    cut = tmp_path / "cut.flv"
    cut.write_bytes(data[:len(data) - 100])
    with pytest.raises(ValueError, match="truncated"):
        vio.EncodedVideo(str(cut))
    with pytest.raises(ValueError, match="FLV holds Sorenson"):
        vio.AsyncVideoWriter(str(tmp_path / "out.flv"), 25, (96, 64))


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["flv_96x64.flv", "flv_96x64.avi",
                                  "flv_96x64.mkv", "flv_96x64.mov",
                                  "flv_v0_128x96.flv"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=14, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=14, stride=2)))


def test_jax_consecutive_frames_equal():
    path = _path("flv_96x64.flv")
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=3)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=3)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_jax_consecutive_frames_past_a_skipped_disposable_picture():
    """Stride 1 over NEAR_KEY reads on without a seek, as the JAX class's
    capture does; the last pair's frame 13, which cv2 never reads, fails
    in both."""
    path = _path(NEAR_KEY)
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=1)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=1)
    assert ds.index == jds.index and len(ds.index) == 13
    for i in range(12):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")
    with pytest.raises(ValueError, match="frame 13"):
        ds[12]
    with pytest.raises(RuntimeError, match="frame 13"):
        jds[12]


def test_jax_capture_frame_equals(tmp_path):
    path = _path("flv_sintel_436x1024.flv")
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "5", a]) == 0
        assert jcapture.main([path, "5", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))
