"""H.264 (``runtime/h264``) in MP4, QuickTime, Matroska, AVI, MPEG-TS, NUT,
ASF and raw streams against OpenCV's FFmpeg, cv2's bundled libavcodec and
the JAX package's cv2-based readers: the CAVLC fixtures here, their CABAC
twins in ``test_torch_h264_cabac.py``.

Tolerance: 0 throughout.  H.264 decoding is exact by the standard, and the
decoder is FFmpeg's where FFmpeg chooses (which pictures come out and when,
the DC-only inverse transforms, the crop it hands over), so every frame
equals cv2's bit for bit and every picture's planes equal libavcodec's: on
the committed fixtures (``tests/goldens/video``, group ``h264``: streams of
the seeded syntax writer ``tests/h264_syntax.py``, muxed by cv2's
libavformat: I_PCM, every intra mode, every P partition and P_Skip,
several and long-term references with list modification and MMCO 1-6,
explicit weights, SPS and PPS scaling lists with both fall-back rules, both
chroma QP offsets with QP 0-51, deblocking with its three modes and
offsets over several slices a picture, POC types 0-2, the VUI's reorder
depth, range, matrix and chroma site, crops, a recovery point, constrained
intra prediction, vectors far outside the picture), through every seek cv2
makes, and in the JAX package's readers and CLIs.  What the port does not
read raises ``Unsupported`` naming ROADMAP Queue 1 item 8; damaged streams
raise ``ValueError`` and never crash.  The library is built once for the
module (g++, a few seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import io
import os
import subprocess
import sys
from fractions import Fraction

import cv2
import numpy as np
import pytest
import torch

import h264_checks as hc
import h264_syntax as hs
from make_video_fixtures import H264_CONTAINERS, Lavc, Lavf, h264_write
from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame, extract_video
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.io.mpegpes import split_h264
from opticalflow_tpu_torch.runtime import h264
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = hc.MANIFEST


@pytest.fixture(scope="module", autouse=True)
def library():
    return h264.load()


# ---------------------------------------------------------------- fixtures

@pytest.mark.parametrize("name", hc.CAVLC)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    hc.frames_equal_cv2_and_the_manifest(name)


@pytest.mark.parametrize("name", hc.CAVLC)
def test_video_info_equals_cv2(name):
    hc.video_info_equals_cv2(name)


@pytest.mark.parametrize("name", hc.CAVLC)
def test_every_seek_reads_the_frame_cv2_reads(name):
    hc.every_seek_reads_cv2s_frame(name)


@pytest.mark.parametrize("name", hc.CAVLC)
def test_manifest_features_are_the_decoders(name):
    hc.features_are_the_decoders(name)


@pytest.mark.parametrize("name", hc.CAVLC)
def test_planes_equal_libavcodecs(name):
    hc.planes_equal_libavcodecs(name)


def test_each_fixture_exists_in_both_entropy_coders():
    assert len(hc.H264) == 2 * len(hc.CAVLC)
    assert [n.replace("_cavlc", "_cabac") for n in hc.CAVLC] == hc.CABAC
    assert {n.rsplit(".", 1)[1] for n in hc.H264
            if n.startswith("h264_clip_")} == {
        e[1:] for e in H264_CONTAINERS}
    assert all("cavlc" in MANIFEST[n]["h264_features"] for n in hc.CAVLC)


def test_what_each_fixture_reaches_and_what_none_does():
    """Every syntax element and tool the port decodes is reached by a
    fixture, every intra mode, and each at a picture or slice edge where
    the mode can be: the manifest's unreached list holds only the modes
    that predict from the top, the left and the corner, which no block
    lacking a neighbour can use."""
    reached = {f for n in hc.H264 for f in MANIFEST[n]["h264_features"]}
    names = set(h264.FEATURES) | set(h264.MODES)
    unreached = hc.MANIFEST_ALL["h264_unreached"]
    assert reached | set(unreached) == names
    assert not reached & set(unreached)
    assert unreached == ["i4x4_4_edge", "i4x4_5_edge", "i4x4_6_edge",
                         "i8x8_4_edge", "i8x8_5_edge", "i8x8_6_edge",
                         "i16x16_3_edge", "chroma_3_edge"]
    by = {n: set(MANIFEST[n]["h264_features"]) for n in hc.H264}
    assert {"mmco1", "mmco2", "mmco3", "mmco4", "mmco5", "mmco6",
            "long_term_list_mod"} <= by["h264_longterm_96x64_cavlc.mkv"]
    assert {"fallback_a", "fallback_b", "default_list", "sps_scaling",
            "pps_scaling"} <= by["h264_scaling_sps_96x64_cabac.mp4"]
    assert {"recovery_point", "non_idr_i"} <= \
        by["h264_recovery_96x64_cavlc.ts"]
    assert {"reorder_guessed"} <= by["h264_guess_96x64_cavlc.mkv"]
    assert {"left_crop_dropped"} <= by["h264_leftcrop_86x56_cabac.avi"]
    assert "p_8x8ref0" in by["h264_p_176x144_cavlc.avi"]


# -------------------------------------------------------------- the writer

@pytest.mark.parametrize("cabac", [False, True])
def test_the_syntax_writers_streams_decode_in_cv2(cabac, tmp_path):
    """A stream of random intra and inter macroblocks at 80x48 decodes in
    cv2's libavcodec with no error logged as damage, to the port's planes:
    the writer and the decoder agree with FFmpeg on every bin."""
    sps = [hs.Sps(mb_w=5, mb_h=3, max_num_ref_frames=2)]
    pps = [hs.Pps(cabac=cabac, transform_8x8=True)]
    mix = ("P", "SKIP", "I4", "I8", "I16", "PCM")
    pics = [hs.Pic(idr=True, mb_types=("I4", "I8", "I16", "PCM"))] + [
        hs.Pic(kind="P", mb_types=mix) for _ in range(4)]
    aus = hs.write_stream(7, sps, pps, pics)
    ref = Lavc().decode(aus, "h264")
    dec = h264.Decoder()
    mine = [p for au in aus for p in dec.decode(au)] + dec.flush()
    assert len(ref) == len(mine) == 5
    for a, b in zip(ref, mine):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    out = str(tmp_path / "w.h264")
    with open(out, "wb") as f:
        f.write(b"".join(aus))
    assert len(hc.cv2_frames(out)) == 5


def test_avcc_and_length_prefix_round_trip():
    sps, pps = [hs.Sps()], [hs.Pps()]
    rec = hs.avcc(sps, pps, 2)
    assert rec[0] == 1 and rec[4] & 3 == 1 and rec[5] & 31 == 1
    info = h264.probe(rec)
    assert (info.width, info.height) == (96, 64)
    aus = hs.write_stream(1, sps, pps, [hs.Pic(idr=True)])
    pref = hs.length_prefixed(aus[0], 2)
    assert h264.nal_units(pref, 2)[0][0] & 31 == 5
    assert h264.is_keyframe(pref, 2)


# ----------------------------------------------------------- stream parts

def test_probe_reads_the_cropped_size_and_the_vui():
    s = hs.Sps(mb_w=6, mb_h=4, crop=(2, 8, 2, 6), vui=dict(
        full_range=True, matrix=1, chroma_loc=2, fps=(30000, 1001),
        reorder=1))
    info = h264.probe(b"\0\0\1" + hs.sps_nal(s))
    assert (info.width, info.height) == (86, 56)
    assert info.full_range and info.matrix == "bt709"
    assert info.chroma == (0, 0) and info.reorder == 1
    assert info.fps == Fraction(30000, 1001)
    assert h264.probe(b"\0\0\1\x09\xf0") is None


@pytest.mark.parametrize("name", ["h264_deblock_96x64_cavlc.ts",
                                  "h264_recovery_96x64_cavlc.ts",
                                  "h264_clip_cavlc.ts"])
def test_transport_stream_access_units_are_ffmpegs(name):
    """The access units the port splits a transport stream's PES payload
    into (``split_h264``: FFmpeg's h264 parser) are the packets FFmpeg's
    demuxer hands its decoder."""
    video = vio.EncodedVideo(hc.path(name))
    with open(video.path, "rb") as f:
        mine = [video.box.sample(f, i) for i in range(video.samples)]
    theirs = [p for p, _, _ in Lavf().packets(video.path)]
    assert [m.lstrip(b"\0") for m in mine] == [t.lstrip(b"\0")
                                               for t in theirs]


def test_the_parser_split_ends_access_units_at_ffmpegs_boundaries():
    """An access unit ends before an AUD, SEI, SPS or PPS after its slices,
    or before a slice whose first macroblock is not past the last one's."""
    sl = [hs.SliceSpec(0, 10), hs.SliceSpec(10, 14)]
    aus = hs.write_stream(3, [hs.Sps()], [hs.Pps()],
                          [hs.Pic(idr=True, slices=sl),
                           hs.Pic(kind="P", mb_types=("P",), slices=sl)])
    data = aus[0] + b"\0\0\0\1\x09\xf0" + aus[1]
    starts, slices = split_h264(data)
    assert starts == [0, len(aus[0])]
    assert len(slices) == 2


def test_a_damaged_sei_message_is_passed_over_as_ffmpeg_does(tmp_path):
    """An SEI message cut short (a user-data payload longer than its NAL
    unit) is logged and passed over by FFmpeg: cv2 reads both pictures,
    and so does the port."""
    aus = hs.write_stream(1, [hs.Sps()], [hs.Pps()],
                          [hs.Pic(idr=True, mb_types=("I16",)),
                           hs.Pic(kind="P", mb_types=("P",))])
    aus[1] = b"\0\0\0\1" + hs.nal(0, 6, b"\x05\xff\x01\x02") + aus[1]
    p = str(tmp_path / "sei.h264")
    with open(p, "wb") as f:
        f.write(b"".join(aus))
    hc.same(list(vio.read_frames(p)), hc.cv2_frames(p))
    assert len(hc.cv2_frames(p)) == 2


# ---------------------------------------------------------------- refusals

def _pcm_pics(n=2):
    return [hs.Pic(idr=True, mb_types=("PCM",))] + [
        hs.Pic(mb_types=("PCM",)) for _ in range(n - 1)]


def _refused(sps, pps, pics, match, cv2_reads=None, tmp=None, prefix=b""):
    aus = hs.write_stream(5, sps, pps, pics)
    aus[-1] = prefix + aus[-1] if prefix else aus[-1]
    dec = h264.Decoder()
    with pytest.raises(Unsupported, match=f"{match}.*{ITEM_8}"):
        for au in aus:
            dec.decode(au)
        dec.flush()
    if cv2_reads is not None:
        p = str(tmp / "refused.h264")
        with open(p, "wb") as f:
            f.write(b"".join(aus))
        assert len(hc.cv2_frames(p)) == cv2_reads
        with pytest.raises(Unsupported, match=ITEM_8):
            list(vio.read_frames(p))


def test_all_skipped_b_slices_read_as_cv2_reads_them(tmp_path):
    """All-skipped B slices (B pictures are read since they were refused
    here): cv2's 2 frames, bit for bit."""
    aus = hs.write_stream(5, [hs.Sps(max_num_ref_frames=1)], [hs.Pps()],
                          [hs.Pic(idr=True, mb_types=("I16",)),
                           hs.Pic(kind="B", ref_idc=0, mb_types=("SKIP",),
                                  skips=1.0)])
    p = str(tmp_path / "b.h264")
    with open(p, "wb") as f:
        f.write(b"".join(aus))
    want = hc.cv2_frames(p)
    assert len(want) == 2
    hc.same(list(vio.read_frames(p)), want)


@pytest.mark.parametrize("slice_type", [3, 4, 8, 9])
def test_sp_and_si_slices_raise_naming_item_8(slice_type):
    """A slice header naming an SP or SI slice (types 3 and 4, or 8 and 9
    for a picture of one type), after a picture the port reads."""
    sps, pps = [hs.Sps()], [hs.Pps()]
    aus = hs.write_stream(5, sps, pps, [hs.Pic(idr=True, mb_types=("I16",))])
    bw = hs.BitWriter()
    bw.ue(0)             # first_mb_in_slice
    bw.ue(slice_type)
    bw.ue(0)             # pic_parameter_set_id
    bw.u(4, 1)           # frame_num
    bw.trailing()
    dec = h264.Decoder()
    assert len(dec.decode(aus[0])) == 1
    with pytest.raises(Unsupported, match=f"SP and SI slices.*{ITEM_8}"):
        dec.decode(b"\0\0\0\1" + hs.nal(1, 1, bw.bytes()))


def test_field_coding_raises_naming_item_8(tmp_path):
    """frame_mbs_only_flag 0 (frame pictures of a stream that may hold
    fields or MBAFF)."""
    _refused([hs.Sps(frame_mbs_only=False)], [hs.Pps()], _pcm_pics(),
             "frame_mbs_only_flag 0", 2, tmp_path)


@pytest.mark.parametrize("sps,match", [
    (hs.Sps(profile=244, chroma_format=3), "chroma_format_idc 3"),
    (hs.Sps(profile=122, chroma_format=2), "chroma_format_idc 2"),
    (hs.Sps(profile=110, bit_depth=10), "bit depth of 10"),
    (hs.Sps(profile=244, bypass=True), "transform_bypass")])
def test_other_layouts_and_lossless_raise_naming_item_8(sps, match,
                                                        tmp_path):
    """4:4:4 and 4:2:2, more than 8 bits, and lossless coding (I_PCM
    streams, which cv2 decodes)."""
    _refused([sps], [hs.Pps()], _pcm_pics(), match, 2, tmp_path)


def test_slice_groups_raise_naming_item_8():
    _refused([hs.Sps()], [hs.Pps(slice_groups=2)], _pcm_pics(1),
             "slice groups")


def test_data_partitioning_raises_naming_item_8():
    _refused([hs.Sps()], [hs.Pps()], _pcm_pics(1), "data partitioning",
             prefix=b"\0\0\0\1" + hs.nal(2, 2, b"\x80"))


def test_redundant_pictures_raise_naming_item_8(tmp_path):
    _refused([hs.Sps()], [hs.Pps(redundant_pic_cnt_present=True)],
             [hs.Pic(idr=True, mb_types=("I16",)),
              hs.Pic(mb_types=("I16",), redundant_pic_cnt=1)],
             "redundant pictures")


def test_a_frame_num_gap_raises_naming_item_8():
    """FFmpeg conceals the pictures a gap in frame_num leaves out."""
    _refused([hs.Sps(max_num_ref_frames=2)], [hs.Pps()],
             [hs.Pic(idr=True, mb_types=("I16",)),
              hs.Pic(kind="P", mb_types=("P",), frame_num=3)],
             "gap in frame_num")


def test_a_missing_reference_raises_naming_item_8():
    """A P picture before any reference: FFmpeg substitutes one."""
    _refused([hs.Sps(max_num_ref_frames=2)], [hs.Pps()],
             [hs.Pic(kind="P", mb_types=("P",), frame_num=1)],
             "names no picture")


def test_an_avc1_entry_without_its_avcc_raises_value_error(tmp_path):
    """cv2 reads no frame of an avc1 track whose sample entry lost its
    avcC; the port raises ``ValueError``."""
    src = open(hc.path("h264_clip_cavlc.mp4"), "rb").read()
    i = src.find(b"avcC")
    bad = src[:i] + b"xxxx" + src[i + 4:]
    p = str(tmp_path / "noavcc.mp4")
    with open(p, "wb") as f:
        f.write(bad)
    assert hc.cv2_frames(p) == []
    with pytest.raises(ValueError, match="without its avcC"):
        Mp4File(p)


def test_damaged_streams_raise_value_error_and_never_crash():
    """Bytes flipped, cut and inserted in the packets of a CAVLC and a
    CABAC clip (in a child process, so that a crash would show): every
    stream decodes or raises ValueError."""
    code = (
        "import random, sys\n"
        "sys.path[:0] = ['tests']\n"
        "from opticalflow_tpu_torch.io import video as vio\n"
        "from opticalflow_tpu_torch.runtime import h264\n"
        "rng = random.Random(24)\n"
        "n = 0\n"
        "for name in ('h264_p_176x144_cavlc.avi',\n"
        "             'h264_intra_96x64_cabac.mkv',\n"
        "             'h264_weighted_96x64_cabac.mov'):\n"
        "    v = vio.EncodedVideo('tests/goldens/video/' + name)\n"
        "    with open(v.path, 'rb') as f:\n"
        "        pk = [v.box.sample(f, i) for i in range(v.samples)]\n"
        "    for trial in range(120):\n"
        "        q = list(pk)\n"
        "        k = rng.randrange(len(q))\n"
        "        b = bytearray(q[k])\n"
        "        op = trial % 3\n"
        "        if op == 0:\n"
        "            for _ in range(rng.randint(1, 8)):\n"
        "                j = rng.randrange(len(b))\n"
        "                b[j] ^= 1 << rng.randrange(8)\n"
        "        elif op == 1:\n"
        "            del b[rng.randrange(1, len(b)):]\n"
        "        else:\n"
        "            j = rng.randrange(len(b))\n"
        "            b[j:j] = bytes(rng.randrange(256) for _ in range(9))\n"
        "        q[k] = bytes(b)\n"
        "        dec = h264.Decoder(extradata=v.box.dsi)\n"
        "        try:\n"
        "            for p in q:\n"
        "                dec.decode(p)\n"
        "            dec.flush()\n"
        "        except ValueError:\n"
        "            n += 1\n"
        "print('ok', n)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")
    assert int(res.stdout.split()[1]) > 0


# ---------------------------------------------------- without OpenCV

def test_reading_needs_no_opencv():
    code = ("import sys\n"
            "from opticalflow_tpu_torch.io import video as vio\n"
            "for n in ('h264_clip_cavlc.mp4', 'h264_clip_cabac.ts',\n"
            "          'h264_poc2_96x64_cabac.h264'):\n"
            f"    assert len(list(vio.read_frames('{hc.FIXTURES}/' + n))) > 0\n"
            "print('cv2' in sys.modules, 'PIL' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["h264_clip_cavlc.mp4", "h264_clip_cabac.mkv",
                                  "h264_clip_cavlc.ts",
                                  "h264_p_176x144_cabac.avi"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    p = hc.path(name)
    hc.same(list(vio.read_frames(p, max_frames=14, stride=2)),
            list(jvideo.frame_pairs_from_video(p, max_frames=14, stride=2)))


@pytest.mark.parametrize("name,hw,stride", [
    ("h264_clip_cabac.mp4", (64, 96), 1), ("h264_clip_cavlc.avi", (64, 96), 3),
    ("h264_poc1_96x64_cabac.mkv", (64, 96), 2)])
def test_jax_consecutive_frames_equal(name, hw, stride):
    """Pairs read in order (stride 1: no seek) or by seeking, equal."""
    p = hc.path(name)
    ds = datasets.ConsecutiveFrames(p, size_hw=hw, stride=stride)
    jds = jdatasets.ConsecutiveFrames(p, size_hw=hw, stride=stride)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_capture_frame_agrees_with_jax(tmp_path):
    """Both CLIs write the same PNG of an H.264 frame after a seek."""
    p = hc.path("h264_clip_cabac.mov")
    outs = []
    for cli, name in ((jcapture, "jax.png"), (capture_frame, "port.png")):
        out = str(tmp_path / name)
        assert cli.main([p, "8", out]) == 0
        outs.append(cv2.imread(out))
    np.testing.assert_array_equal(*outs)


def test_extract_video_reads_cv2s_frames(tmp_path, monkeypatch):
    """The video CLI over an H.264 .mp4: the frames it reads are
    cv2.VideoCapture's, and cv2 reads its .avi output with the clip's
    count less one (one frame a pair), fps and size."""
    sys.path.insert(0, os.path.dirname(__file__))
    from oracles.torch_pwcnet import OraclePWC
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for q in net.parameters():
        q.data *= 0.5
    ckpt = str(tmp_path / "fake.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               net.state_dict_flat().items()}}, ckpt)
    src = str(tmp_path / "clip.mp4")
    sps = [hs.Sps(mb_w=6, mb_h=4, max_num_ref_frames=1)]
    pics = [hs.Pic(idr=True, mb_types=("I16", "I4"))] + [
        hs.Pic(kind="P", mb_types=("P", "SKIP")) for _ in range(3)]
    h264_write(src, sps, [hs.Pps(cabac=True, transform_8x8=True)], pics, 11)
    import opticalflow_tpu_torch.video as tvideo
    seen, read = [], tvideo.read_frames

    def recording(*args, **kwargs):
        for frame in read(*args, **kwargs):
            seen.append(frame)
            yield frame
    monkeypatch.setattr(tvideo, "read_frames", recording)
    out = str(tmp_path / "arrows.avi")
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_video.main([src, out, "--ckpt", ckpt, "--batch", "2",
                                   "--dtype", "float32", "--device",
                                   "cpu"]) == 0
    hc.same(seen, hc.cv2_frames(src))
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    assert cap.get(cv2.CAP_PROP_FPS) == 25.0
    assert (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) == (96, 64)
