"""NUT (``io/nut``), FFmpeg's own container, against OpenCV's FFmpeg and the
JAX package's cv2-based readers.

Tolerance: 0 throughout.  The demuxer hands each decoder the packets
FFmpeg's ``nut`` demuxer hands it (bytes, pts and key flags equal
libavformat's on every fixture), and the codecs are the port's bit-exact
ones, so every frame equals cv2's: on the committed fixtures
(``tests/goldens/video``, group ``nut``: cv2's writer with every fourcc the
port decodes, an odd size, 29.97 fps, and cv2's bytes cut or damaged;
Dirac in NUT is in group ``dirac``), through every seek cv2 makes (NUT's
index, FFmpeg's syncpoint search without one, none at all in a stream
with no key frame) and in the JAX package's readers.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import hashlib
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from make_video_fixtures import (NUT_FOURCCS, NUT_SHORT, Lavf, _cv2_write,
                                 moving_clip, nut_crafted)
from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import nut as nutmod
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.nut import (FEATURES, MAIN, STREAM, NutFile,
                                          _Reader, crc)
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
# every .nut fixture of group nut, Dirac's (group dirac) and the cut
# VOPs' (group cut_vop); the other codecs' groups hold .nut files of their
# own, tested with their codec
NUT = sorted(n for n in MANIFEST if n.endswith(".nut")
             and MANIFEST[n]["group"] in ("nut", "dirac", "cut_vop"))
OPENED = [n for n in NUT if "nut_features" in MANIFEST[n]]
TRUNCATED = "nut_craft_truncated_96x64.nut"
# cut inside a P-VOP: FFmpeg conceals it with the vectors it guessed
PVOP = "nut_craft_truncated_pvop_96x64.nut"
# VOPs cut short at 176x144: P-VOPs through guess_mv's search from a slice
# that ended early and from a failed macroblock, and guess_dc's spatial
# concealment; I-VOPs whose undamaged macroblocks' SAD chooses the
# temporal and the spatial path
CUT_VOPS = sorted(n for n, e in MANIFEST.items() if e["group"] == "cut_vop")
READ = OPENED


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

def test_fixtures_cover_every_fourcc_the_port_reads():
    """One .nut a fourcc cv2's writer puts there (25 frames; the lossless
    and raw ones 6), H.263 at 128x96, fourcc 0 (raw I420), an odd size,
    29.97 fps, the crafted files and Dirac's; the nut and dirac groups
    under about 2.5 MB together."""
    need = {f"nut_{c}_96x64.nut" for c in NUT_FOURCCS}
    need |= {"nut_H263_128x96.nut", "nut_raw_96x64.nut", "nut_odd_53x37.nut",
             "nut_ntsc_96x64.nut", "dirac_96x64.nut",
             "dirac_sintel_436x1024.nut"}
    need |= {f"nut_craft_{c}_96x64.nut" for c in (
        "noindex", "badsyncpoint", "badmain", "truncated",
        "truncated_pvop")}
    need |= {f"pvop_{c}_176x144.nut" for c in ("ended", "search", "spatial")}
    need |= {f"ivop_sad_{c}_176x144.nut" for c in ("temporal", "spatial")}
    assert need == set(NUT)
    codecs = {NutFile(_path(n)).codec for n in OPENED}
    assert codecs == {"mpeg4", "mjpeg", "mpeg12", "flv1", "msmpeg4v2",
                      "msmpeg4v3", "wmv1", "wmv2", "snow", "vp8", "vp9",
                      "ffv1", "huffyuv", "magicyuv", "utvideo", "png", "asv",
                      "raw", "i420", "h263", "dirac"}
    total = sum(os.path.getsize(_path(n)) for n, e in MANIFEST.items()
                if e["group"] in ("nut", "dirac"))
    assert total <= 2_600_000, total
    for c in NUT_FOURCCS:
        want = 6 if c in NUT_SHORT else 25
        assert MANIFEST[f"nut_{c}_96x64.nut"]["decoded"] == want, c
    assert (MANIFEST["nut_odd_53x37.nut"]["width"],
            MANIFEST["nut_odd_53x37.nut"]["height"]) == (52, 36)


@pytest.mark.parametrize("name", READ)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", OPENED)
def test_video_info_equals_cv2(name):
    """fps, size and count as cv2 reports them: the count one short of the
    frames (the last frame's pts ends the duration) but for MPEG-2, whose
    B-pictures delay every pts a frame; the last syncpoint's time without
    an index."""
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


def test_the_count_follows_the_largest_pts():
    """OpenCV's count is FFmpeg's duration times fps; the duration is the
    index's max_pts, the largest pts in the file: (frames - 1) frames of
    time where the pts run from 0, frames where MPEG-2's start one frame
    late (its start time is not taken off)."""
    for name, frames in (("nut_mp4v_96x64.nut", 24),
                         ("nut_mpg2_96x64.nut", 25),
                         ("nut_ntsc_96x64.nut", 24)):
        nut = NutFile(_path(name))
        num, den = nut.time_base
        assert nut.max_pts == round(max(nut.pts) * num * 1e6 / den)
        assert nut.frames == frames == MANIFEST[name]["frames"]
    mpg2 = NutFile(_path("nut_mpg2_96x64.nut"))
    assert mpg2.start_time == 2048 == min(mpg2.pts)
    assert NutFile(_path("nut_ntsc_96x64.nut")).rate == (2997, 100)


@pytest.mark.parametrize("name", OPENED)
def test_packets_equal_ffmpegs(name):
    """Every packet's bytes (an elided header put back), pts and key flag
    as libavformat's nut demuxer hands them over."""
    nut = NutFile(_path(name))
    want = Lavf().packets(_path(name))
    assert len(want) == len(nut.sizes)
    with open(nut.path, "rb") as f:
        for i, (data, pts, key) in enumerate(want):
            if nut.frames_[i].cut:
                assert data == nut.data[nut.frames_[i].offset:]
                continue
            assert nut.sample(f, i) == data, i
            assert (nut.pts[i], nut.keys[i]) == (pts, key), i


@pytest.mark.parametrize("name", OPENED)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """Each recorded seek reads its frame (an index into the frames cv2
    reads in order), in a capture just opened and reading on; where cv2's
    read after the seek fails (a Dirac stream: cv2's writer flags no
    packet a key frame, and FFmpeg reads on to one after any seek), the
    port's raises."""
    want = MANIFEST[name]
    video = vio.EncodedVideo(_path(name))
    assert sorted(want["seeks"], key=int) == [
        str(t) for t in range(want["decoded"])]
    for t, hit in want["seeks"].items():
        if name == PVOP and hit == 23:
            with pytest.raises(Unsupported, match=ITEM_8):
                video.frame(int(t))
            continue
        if hit is None:
            assert video.seek_target(int(t)) is None
            with pytest.raises(ValueError, match="reads no frame"):
                video.frame(int(t))
            continue
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t
        if t != "0":        # a capture just opened reads frame 0 unsought
            video.close()
            assert _digest(video.read(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", OPENED)
def test_manifest_features_are_the_demuxers(name):
    assert NutFile(_path(name)).features == MANIFEST[name]["nut_features"]


def test_what_each_fixture_reaches_and_what_none_does():
    """Key frames and their syncpoints, an index with entries and without
    (one syncpoint; no key frame), no index, a resync, a cut frame,
    MPEG-2's reordered pts; what cv2's writer never writes (version 4
    headers, elided headers, reserved fields, headers repeated past 8 MB)
    no fixture reaches."""
    need = {"nut_mp4v_96x64.nut": {"main_header_v3", "syncpoints",
                                   "coded_pts", "size_msb", "coded_flags",
                                   "key_frames", "index", "extradata",
                                   "info_rate", "elision_headers"},
            "nut_mpg2_96x64.nut": {"pts_reordered"},
            "nut_MJPG_96x64.nut": {"index_without_entries"},
            "dirac_96x64.nut": {"no_key_frames", "index_without_entries"},
            "nut_craft_noindex_96x64.nut": {"no_index"},
            "nut_craft_badsyncpoint_96x64.nut": {"resync", "index"},
            TRUNCATED: {"truncated_frame", "no_index"},
            PVOP: {"truncated_frame", "no_index"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["nut_features"]), name
    reached = {f for n in OPENED for f in MANIFEST[n]["nut_features"]}
    assert _MANIFEST["nut_unreached"] == [
        f for f in FEATURES if f not in reached] == [
        "main_header_v4", "elided_header", "reserved_fields",
        "repeated_headers"]


# ------------------------------------------------------------- crafted

def test_crafted_files_are_cv2s_bytes_cut_or_damaged():
    """The crafted fixtures are ``nut_crafted`` of the mp4v fixture."""
    for name, data in nut_crafted(_path("nut_mp4v_96x64.nut")).items():
        with open(_path(f"nut_craft_{name}_96x64.nut"), "rb") as f:
            assert f.read() == data, name


def test_a_main_header_that_fails_its_checksum_opens_nothing():
    """cv2 opens nothing (its count -1); the port raises ValueError."""
    name = "nut_craft_badmain_96x64.nut"
    assert MANIFEST[name]["decoded"] == 0 and MANIFEST[name]["frames"] == -1
    assert "main header" in MANIFEST[name]["port_refuses"]
    with pytest.raises(ValueError, match="no valid NUT main header"):
        vio.video_info(_path(name))


def test_a_syncpoint_that_fails_its_checksum_is_resynced_over():
    """FFmpeg resyncs at the next startcode after the damaged syncpoint:
    the frames between it and the next syncpoint are lost, in cv2 and in
    the port alike."""
    name = "nut_craft_badsyncpoint_96x64.nut"
    nut = NutFile(_path(name))
    good = NutFile(_path("nut_mp4v_96x64.nut"))
    assert nut.pts == good.pts[:12] + good.pts[24:]
    assert MANIFEST[name]["decoded"] == 13


def test_a_frame_cut_short_reads_up_to_it_then_raises_naming_item_8():
    """FFmpeg hands the decoder what is left of the last frame and conceals
    the rest.  An I-VOP cut in half (its data fails at macroblock 11 of 24,
    so all 24 are damaged and almost none undamaged: FFmpeg takes them from
    the picture before, then deblocks their edges by the vectors it copied)
    reads all 25 frames, equal to cv2's; a P-VOP cut in half (the data ends
    its slice after macroblock 15, whose 16 keep their vectors: guess_mv
    searches for the 8 missing ones' vectors, rendering each candidate from
    the last picture) reads cv2's 24 frames, the concealed one included."""
    assert MANIFEST[TRUNCATED]["decoded"] == 25
    assert "port_refuses" not in MANIFEST[TRUNCATED]
    assert [_digest(f) for f in vio.read_frames(_path(TRUNCATED))] == \
        MANIFEST[TRUNCATED]["sha256"]
    assert MANIFEST[PVOP]["decoded"] == 24
    assert "port_refuses" not in MANIFEST[PVOP]
    assert [_digest(f) for f in vio.read_frames(_path(PVOP))] == \
        MANIFEST[PVOP]["sha256"]
    video = vio.EncodedVideo(_path(PVOP))
    dec = video._decoder()
    with open(video.path, "rb") as f:
        for i in range(video.samples):
            dec.decode(video.box.sample(f, i), cut=video._cut(i))
    assert dec.concealment == {"type": "P", "macroblock": 16,
                               "slice_ended": True, "kept": 16,
                               "searched": True, "spatial": False}


@pytest.mark.parametrize("name", CUT_VOPS)
def test_cut_vops_conceal_as_ffmpeg_conceals_them(name):
    """Each cut VOP reads to cv2's frames, the concealed last one
    included, along the path its manifest entry records: guess_mv's search
    where more than half the longer side's count of macroblocks keep their
    vectors (from a slice the data ended early, and from a macroblock that
    failed: its vector what its decoding left), and guess_dc's spatial
    concealment where the kept macroblocks of a P-VOP are mostly intra, or
    an I-VOP's undamaged ones differ from the picture before more than
    that picture from itself a row down (their SAD)."""
    want = MANIFEST[name]
    assert [_digest(f) for f in vio.read_frames(_path(name))] == \
        want["sha256"]
    video = vio.EncodedVideo(_path(name))
    dec = video._decoder()
    with open(video.path, "rb") as f:
        for i in range(video.samples):
            dec.decode(video.box.sample(f, i), cut=video._cut(i))
    assert dec.concealment == want["mpeg4_concealment"]
    assert dec.concealment["searched"]
    paths = {n: MANIFEST[n]["mpeg4_concealment"] for n in CUT_VOPS}
    assert [(p["type"], p["slice_ended"], p["spatial"])
            for p in paths.values()] == [
        ("I", False, True), ("I", False, False), ("P", True, False),
        ("P", False, False), ("P", False, True)]


def test_a_vop_cut_inside_its_header_or_first_macroblock(tmp_path):
    """Cut so early that fewer bits follow the VOP's header than half its
    macroblocks (here inside the header or the first macroblock), FFmpeg
    hands over no picture for it (cv2 reads one frame fewer), nor does the
    port; cut right after its start code, FFmpeg reads its
    padding (an I-VOP that is not coded) and hands over the picture before
    again, and so does the port (cv2's 24 frames)."""
    data = open(_path("nut_mp4v_96x64.nut"), "rb").read()
    pvop = NutFile(_path("nut_mp4v_96x64.nut")).frames_[-2]
    for keep in (5, 6, 7, 8):           # the header's, the macroblock's
        path = str(tmp_path / f"cut{keep}.nut")
        with open(path, "wb") as f:
            f.write(data[:pvop.offset + keep])
        _same(list(vio.read_frames(path)), _cv2_frames(path))
        assert len(_cv2_frames(path)) == 23
    path = str(tmp_path / "cut4.nut")
    with open(path, "wb") as f:
        f.write(data[:pvop.offset + 4])
    assert len(_cv2_frames(path)) == 24
    _same(list(vio.read_frames(path)), _cv2_frames(path))


# the MPEG-4 clips whose last P-VOP is cut at every position (cv2's
# writer at 25 and at 29.97 fps: a time increment of 5 and of 15 bits; at
# 64x48 under 3IV2; at 53x37; the port's encoder at 176x144 with a VOP
# that ends in stuffing, one whose concealment searches vectors, and one
# concealed spatially): a VOP with fewer bits after its header than half
# its macroblocks dropped, one whose first macroblock fails concealed, an
# intra macroblock whose DC comes out negative failed, a VOP whose last
# macroblock reads into the padding concealed from its last packet on
SWEPT = ["nut_mp4v_96x64.nut", "nut_ntsc_96x64.nut", "tag_3IV2_64x48.nut",
         "pvop_ended_176x144.nut", "pvop_search_176x144.nut",
         "pvop_spatial_176x144.nut", "nut_odd_53x37.nut"]


@pytest.mark.parametrize("name", SWEPT)
def test_every_cut_of_the_last_pvop_reads_as_cv2_reads_it(name, tmp_path):
    """The file cut at every byte of its last P-VOP, from right after the
    start code to one byte short of its end: each reads cv2's frames (the
    picture before handed over again, the VOP dropped, or the VOP
    concealed, as FFmpeg does at that position)."""
    data = open(_path(name), "rb").read()
    frames = NutFile(_path(name)).frames_
    pvop = [x for x in frames if not x.key][-1]
    assert pvop.size > 20
    for keep in range(4, pvop.size):
        path = str(tmp_path / f"cut{keep}.nut")
        with open(path, "wb") as f:
            f.write(data[:pvop.offset + keep])
        _same(list(vio.read_frames(path)), _cv2_frames(path))


def _v(n):
    """``ffio_read_varlen``'s coding of ``n``."""
    out = [n & 127]
    n >>= 7
    while n:
        out.append(128 | n & 127)
        n >>= 7
    return bytes(reversed(out))


def _packet_at(data, code):
    """(start, body start, end) of the first packet of startcode ``code``."""
    at = data.find(code.to_bytes(8, "big"))
    r = _Reader(data, at + 8)
    size = r.v()
    return at, r.pos, r.pos + size


def _repacket(data, code, body):
    """``data`` with its first packet of ``code`` given a new body (its
    checksum recomputed)."""
    at, _, end = _packet_at(data, code)
    new = code.to_bytes(8, "big") + _v(len(body) + 4) + body
    return data[:at] + new + crc(body).to_bytes(4, "big") + data[end:]


def _main_body(data, version=None, streams=None, flags=None,
               code_flags=0):
    """The main header's body rewritten: its version (4 adds a minor
    version and the flags), stream count, and every frame-code run's flags
    or'ed with ``code_flags``."""
    _, start, end = _packet_at(data, MAIN)
    r = _Reader(data, start)
    assert r.v() == 3                           # what cv2's writer writes
    out = [_v(version or 3)]
    if version == 4:
        out.append(_v(0))                       # the minor version
    n = r.v()
    out.append(_v(streams or n))
    out.append(_v(r.v()))                       # max_distance
    tbs = r.v()
    out.append(_v(tbs))
    for _ in range(2 * tbs):
        out.append(_v(r.v()))
    codes = 0
    mul = 1
    while codes < 256:
        fl, fields = r.v(), r.v()
        out += [_v(fl | code_flags), _v(fields)]
        vals = [r.v() for _ in range(fields)]
        out += [_v(x) for x in vals]
        if fields > 1:
            mul = vals[1]
        size = vals[3] if fields > 3 else 0
        count = vals[5] if fields > 5 else mul - size
        codes += count + (codes <= ord("N") < codes + count)
    out.append(data[r.pos:end - 4])             # the elision headers
    if flags is not None:
        out.append(_v(flags))
    return b"".join(out)


def test_what_cv2s_writer_never_writes_raises_naming_item_8(tmp_path):
    """Two streams, broadcast mode (a version 4 header's flag), side or
    meta data on every frame, a stream of another class than video and a
    fourcc the port does not read (HEVC) each raise ``Unsupported`` naming
    item 8; the headers rewritten keep their checksums.  ``H264`` is read
    now: over MPEG-4 Part 2 samples, of which cv2 reads no frame, it
    raises ``ValueError`` as a corrupt H.264 stream."""
    with open(_path("nut_mp4v_96x64.nut"), "rb") as f:
        data = f.read()
    # the rewriter writes the header back as it was
    assert _repacket(data, MAIN, _main_body(data)) == data
    _, sstart, send = _packet_at(data, STREAM)
    stream = data[sstart:send - 4]
    cases = {
        "2 streams": _repacket(data, MAIN, _main_body(data, streams=2)),
        "broadcast": _repacket(data, MAIN, _main_body(
            data, version=4, flags=nutmod.NUT_BROADCAST)),
        "side or meta data": _repacket(data, MAIN, _main_body(
            data, code_flags=nutmod.FLAG_SM_DATA)),
        "class 1": _repacket(data, STREAM, stream[:1] + _v(1) + stream[2:]),
        "HEVC": _repacket(data, STREAM, stream.replace(b"mp4v", b"HEVC")),
    }
    for what, body in cases.items():
        path = tmp_path / "x.nut"
        path.write_bytes(body)
        with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
            list(vio.read_frames(str(path)))
    path = tmp_path / "h264.nut"
    path.write_bytes(_repacket(data, STREAM, stream.replace(b"mp4v",
                                                           b"H264")))
    assert _cv2_frames(str(path)) == []
    with pytest.raises(ValueError, match="corrupt H.264") as err:
        list(vio.read_frames(str(path)))
    assert not isinstance(err.value, Unsupported)


def test_damaged_files_raise_value_error_or_resync_and_never_crash(tmp_path):
    """Random bytes flipped anywhere in a file: the demuxer refuses it with
    ValueError, or resyncs as FFmpeg does and hands over what it finds."""
    with open(_path("nut_VP80_96x64.nut"), "rb") as f:
        data = f.read()
    rng = np.random.default_rng(25)
    path = tmp_path / "d.nut"
    for _ in range(40):
        bad = bytearray(data)
        for _ in range(4):
            bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        path.write_bytes(bytes(bad))
        try:
            nut = NutFile(str(path))
            with open(path, "rb") as f:
                for i in range(len(nut.sizes)):
                    nut.sample(f, i)
        except ValueError:
            pass


def test_crc_is_ffmpegs_av_crc_ieee():
    """``AV_CRC_32_IEEE`` from 0: the CRC-32/POSIX register without its
    final inversion; from all ones, CRC-32/MPEG-2."""
    assert nutmod.crc(b"123456789") == 0x765E7680 ^ 0xFFFFFFFF
    assert nutmod.crc(b"123456789", 0xFFFFFFFF) == 0x0376E6E7


# ---------------------------------------------------- without OpenCV

def test_reading_needs_no_opencv():
    code = ("import sys\n"
            "from opticalflow_tpu_torch.io import video as vio\n"
            "for n in ('nut_mp4v_96x64.nut', 'nut_FFV1_96x64.nut'):\n"
            f"    assert len(list(vio.read_frames('{FIXTURES}/' + n))) > 0\n"
            "print('cv2' in sys.modules, 'PIL' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["nut_mp4v_96x64.nut", "nut_mpg2_96x64.nut",
                                  "nut_HFYU_96x64.nut", "nut_ntsc_96x64.nut"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=14, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=14, stride=2)))


def test_jax_consecutive_frames_equal():
    path = _path("nut_VP90_96x64.nut")
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=3)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=3)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_capture_frame_agrees_with_jax(tmp_path, capsys):
    """Both CLIs write the same PNG of a NUT frame after a seek."""
    path = _path("nut_SNOW_96x64.nut")
    outs = []
    for cli, name in ((jcapture, "jax.png"), (capture_frame, "port.png")):
        out = str(tmp_path / name)
        assert cli.main([path, "13", out]) == 0
        outs.append(cv2.imread(out))
    np.testing.assert_array_equal(*outs)


def test_a_clip_written_at_an_odd_rate_reads_as_cv2_reads_it(tmp_path):
    """A NUT written now at 15000/1001 fps: fps, count and frames as cv2's."""
    path = str(tmp_path / "slow.nut")
    _cv2_write(path, moving_clip(48, 64, 9, seed=26), "mp4v",
               fps=15000 / 1001)
    assert vio.video_info(path) == _cv2_info(path)
    _same(list(vio.read_frames(path)), _cv2_frames(path))
