"""H.264 B pictures (``runtime/h264``) against OpenCV's FFmpeg, cv2's
bundled libavcodec and the JAX package's cv2-based readers: the CAVLC
fixtures of group ``h264_b`` here, their CABAC twins in
``test_torch_h264_b_cabac.py``.

Tolerance: 0 throughout.  The fixtures come from the seeded syntax writer
``tests/h264_syntax.py`` (B pyramids in spatial and temporal direct mode,
with direct_8x8_inference_flag 1 and 0, every mb_type and sub_mb_type, the
three bi-prediction modes, list 1's modification and swap, long-term and
MMCO-marked references, several slices, far vectors, VUI with and without
the reorder depth, 176x144 and the 54x38 crop; a 13-frame pyramid clip in
the nine containers), muxed by cv2's libavformat with an encoder's
timestamps (pts in display order, dts decode order less the reorder depth,
the stream's ``video_delay``).  Every frame equals cv2's bit for bit, every
picture's planes libavcodec's (started, as cv2's decoder is, from the
reorder depth FFmpeg's probe found: ``h264.probe_delay``), through every
seek cv2 makes.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import io
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import h264_checks as hc
import h264_syntax as hs
from make_video_fixtures import (H264_CONTAINERS, Lavc, Lavf, _cv2_seeks,
                                 h264_write)
from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame, extract_video
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.runtime import h264
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = hc.MANIFEST


@pytest.fixture(scope="module", autouse=True)
def library():
    return h264.load()


# ---------------------------------------------------------------- fixtures

@pytest.mark.parametrize("name", hc.B_CAVLC)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    hc.frames_equal_cv2_and_the_manifest(name)


@pytest.mark.parametrize("name", hc.B_CAVLC)
def test_video_info_equals_cv2(name):
    hc.video_info_equals_cv2(name)


@pytest.mark.parametrize("name", hc.B_CAVLC)
def test_every_seek_reads_the_frame_cv2_reads(name):
    hc.every_seek_reads_cv2s_frame(name, none_read=name.endswith(".ts"))


@pytest.mark.parametrize("name", hc.B_CAVLC)
def test_manifest_features_are_the_decoders(name):
    hc.features_are_the_decoders(name)


@pytest.mark.parametrize("name", hc.B_CAVLC)
def test_planes_equal_libavcodecs(name):
    hc.planes_equal_libavcodecs(name)


@pytest.mark.parametrize("name", hc.B_CAVLC)
def test_the_starting_reorder_depth_is_ffmpegs_probes(name):
    """The depth the port's decoder starts from (``probe_delay``: FFmpeg's
    probe decoding the first packets, from MP4's ``ctts`` estimate) is the
    ``video_delay`` libavformat's probe leaves for cv2."""
    p = hc.path(name)
    assert vio.EncodedVideo(p).h264_delay == Lavf().video_delay(p) == 2


def test_each_fixture_exists_in_both_entropy_coders():
    assert len(hc.H264_B) == 2 * len(hc.B_CAVLC)
    assert [n.replace("_cavlc", "_cabac") for n in hc.B_CAVLC] == hc.B_CABAC
    assert {n.rsplit(".", 1)[1] for n in hc.H264_B
            if n.startswith("h264_b_clip_")} == {
        e[1:] for e in H264_CONTAINERS}


def test_what_the_fixtures_reach():
    """Every B feature is reached, by the CAVLC fixtures alone and by the
    CABAC ones alone; each mode by the fixture written for it."""
    assert hc.MANIFEST_ALL["h264_b_unreached"] == []
    for names in (hc.B_CAVLC, hc.B_CABAC):
        reached = {f for n in names for f in MANIFEST[n]["h264_features"]}
        assert set(h264.B_FEATURES) <= reached
    by = {n: set(MANIFEST[n]["h264_features"]) for n in hc.B_CAVLC}
    assert {"direct_spatial", "direct_8x8_inference", "col_zero",
            "b_skip", "b_reference", "b_intra"} <= \
        by["h264_b_spatial_96x64_cavlc.mp4"]
    assert {"direct_temporal", "col_intra"} <= \
        by["h264_b_temporal_96x64_cavlc.mkv"]
    assert {"direct_4x4", "direct_spatial", "direct_temporal"} <= \
        by["h264_b_inference0_96x64_cavlc.avi"]
    assert {"implicit_weights", "implicit_fallback", "long_term_l1"} <= \
        by["h264_b_implicit_96x64_cavlc.mov"]
    assert "explicit_bipred" in by["h264_b_explicit_96x64_cavlc.ts"]
    assert {"list1_mod", "list1_swap", "col_unmapped"} <= \
        by["h264_b_listmod_96x64_cavlc.mp4"]
    assert {"mmco1", "mmco4", "mmco6"} <= by["h264_b_mmco_96x64_cavlc.nut"]
    assert {"multi_slice", "reorder", "edge_mv"} <= \
        by["h264_b_slices_176x144_cavlc.mkv"]
    assert {"cropping", "chroma_loc"} <= by["h264_b_crop_54x38_cavlc.wmv"]
    assert "reorder" not in by["h264_b_crop_54x38_cavlc.wmv"]


# -------------------------------------------------------------- the writer

def _b_stream(cabac, spatial, bipred, seed, inference=True):
    """IDR, two pyramids of random B macroblocks (every type and sub type,
    intra ones among them) at 80x48."""
    sps = [hs.Sps(mb_w=5, mb_h=3, max_num_ref_frames=4,
                  direct_8x8_inference=inference)]
    pps = [hs.Pps(cabac=cabac, transform_8x8=True, weighted_bipred_idc=bipred,
                  num_ref_idx_default1=2)]
    w = dict(luma_log2=4, chroma_log2=3, luma={0: (20, -5), 1: (12, 4)},
             chroma={0: [(9, 2), (7, -3)]}, luma1={0: (11, 6)},
             chroma1={1: [(5, 1), (10, -2)]})
    mix = ("B", "SKIP", "I4", "I16")
    kw = dict(direct_spatial=spatial, num_ref_idx="all", weights=w)
    pics = [hs.Pic(idr=True, mb_types=("I4", "I16"), poc=0)]
    for b in (0, 8):
        pics += [hs.Pic(kind="P", mb_types=("P", "SKIP", "I16"), poc=b + 8),
                 hs.Pic(kind="B", mb_types=mix, poc=b + 4, **kw),
                 hs.Pic(kind="B", mb_types=mix, poc=b + 2, ref_idc=0, **kw),
                 hs.Pic(kind="B", mb_types=mix, poc=b + 6, ref_idc=0, **kw)]
    return sps, pps, hs.write_stream(seed, sps, pps, pics)


def writer_streams_decode_as_libavcodec(cabac, spatial, bipred, tmp_path):
    """A stream of random B macroblocks decodes in cv2's libavcodec to the
    port's planes, from a fresh decoder (which drops the picture its
    reorder guess finds out of order, as the port's does) and from the
    probe's depth (cv2's: every picture), and cv2 reads its frames."""
    sps, pps, aus = _b_stream(cabac, spatial, bipred, 31 + bipred)
    for delay, count in ((0, 8), (2, 9)):
        ref = Lavc().decode(aus, "h264", video_delay=delay)
        dec = h264.Decoder(delay=delay)
        mine = [p for au in aus for p in dec.decode(au)] + dec.flush()
        assert len(ref) == len(mine) == count
        for a, b in zip(ref, mine):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    out = str(tmp_path / "w.h264")
    with open(out, "wb") as f:
        f.write(b"".join(aus))
    hc.same(list(vio.read_frames(out)), hc.cv2_frames(out))


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("bipred", [0, 1, 2])
def test_the_writers_b_streams_decode_as_libavcodec(spatial, bipred,
                                                    tmp_path):
    writer_streams_decode_as_libavcodec(False, spatial, bipred, tmp_path)


def test_write_mp4_stamps_b_pictures_as_the_mov_muxer(tmp_path):
    """``write_mp4`` (the card machine's writer) with display indices: its
    ``ctts`` and ``elst`` are read by cv2 as the mov muxer's are (every
    frame, the count, fps and each seek), and by the port alike."""
    sps = [hs.Sps(mb_w=6, mb_h=4, max_num_ref_frames=4)]
    pps = [hs.Pps(cabac=True)]
    pics = [hs.Pic(idr=True, mb_types=("I16", "I4"), poc=0)]
    for b in (0, 8):
        pics += [hs.Pic(kind="P", mb_types=("P", "SKIP"), poc=b + 8),
                 hs.Pic(kind="B", mb_types=("B", "SKIP"), poc=b + 4,
                        num_ref_idx="all"),
                 hs.Pic(kind="B", mb_types=("B", "SKIP"), poc=b + 2,
                        ref_idc=0, num_ref_idx="all"),
                 hs.Pic(kind="B", mb_types=("SKIP",), skips=1.0, poc=b + 6,
                        ref_idc=0, direct_spatial=False)]
    aus = hs.write_stream(7, sps, pps, pics)
    shown, depth = hs.display_order(pics)
    p = str(tmp_path / "b.mp4")
    hs.write_mp4(p, [hs.length_prefixed(a) for a in aus],
                 [q.idr for q in pics], hs.avcc(sps, pps), 96, 64,
                 shown=shown)
    want = hc.cv2_frames(p)
    assert len(want) == 9 and depth == 2
    assert vio.video_info(p) == hc.cv2_info(p)
    hc.same(list(vio.read_frames(p)), want)
    video = vio.EncodedVideo(p)
    for t, hit in _cv2_seeks(p, want).items():
        np.testing.assert_array_equal(video.frame(int(t)), want[hit])


def test_display_order_and_depth_of_a_pyramid():
    pics = [hs.Pic(idr=True, poc=0), hs.Pic(poc=8), hs.Pic(poc=4),
            hs.Pic(poc=2), hs.Pic(poc=6), hs.Pic(idr=True, poc=0),
            hs.Pic(poc=4), hs.Pic(poc=2)]
    assert hs.display_order(pics) == ([0, 4, 2, 1, 3, 5, 7, 6], 2)
    assert hs.display_order([hs.Pic(), hs.Pic()]) == ([0, 1], 0)


# ---------------------------------------------------------------- refusals

def test_temporal_direct_from_a_picture_list_0_lacks_takes_its_first():
    """The co-located picture's reference is not in list 0 (list 0 holds
    the co-located picture alone, by its modification): FFmpeg's
    fill_colmap leaves the entry at list 0's first picture, and the port
    decodes libavcodec's planes."""
    sps = [hs.Sps(mb_w=5, mb_h=3, max_num_ref_frames=3)]
    pps = [hs.Pps(num_ref_idx_default1=2)]
    pics = [hs.Pic(idr=True, mb_types=("I16",), poc=0),
            hs.Pic(kind="P", mb_types=("P",), poc=8),
            hs.Pic(kind="B", mb_types=("SKIP", "B"), poc=4, ref_idc=0,
                   direct_spatial=False, num_ref_idx=1,
                   list_mods=[(0, 0)])]
    aus = hs.write_stream(2, sps, pps, pics)
    ref = Lavc().decode(aus, "h264", video_delay=1)
    dec = h264.Decoder(delay=1)
    mine = [p for au in aus for p in dec.decode(au)] + dec.flush()
    assert "col_unmapped" in dec.features
    assert len(ref) == len(mine) == 3
    for a, b in zip(ref, mine):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_more_than_16_references_a_list_raise_naming_item_8():
    """num_ref_idx_l1_active above 16 in a frame: FFmpeg drops the slice
    and conceals it."""
    sps = [hs.Sps(mb_w=5, mb_h=3, max_num_ref_frames=2)]
    aus = hs.write_stream(2, sps, [hs.Pps()], [
        hs.Pic(idr=True, mb_types=("I16",), poc=0),
        hs.Pic(kind="P", mb_types=("P",), poc=4),
        hs.Pic(kind="B", mb_types=("SKIP",), skips=1.0, poc=2,
               num_ref_idx1=17, ref_idc=0)])
    dec = h264.Decoder()
    with pytest.raises(Unsupported, match=f"more than 16.*{ITEM_8}"):
        for au in aus:
            dec.decode(au)


def test_damaged_b_streams_raise_value_error_and_never_crash():
    """Bytes flipped, cut and inserted in the packets of B fixtures, CAVLC
    and CABAC, spatial and temporal (in a child process, so that a crash
    would show): every stream decodes or raises ValueError."""
    code = (
        "import random, sys\n"
        "sys.path[:0] = ['tests']\n"
        "from opticalflow_tpu_torch.io import video as vio\n"
        "from opticalflow_tpu_torch.runtime import h264\n"
        "rng = random.Random(29)\n"
        "n = 0\n"
        "for name in ('h264_b_spatial_96x64_cavlc.mp4',\n"
        "             'h264_b_temporal_96x64_cabac.mkv',\n"
        "             'h264_b_inference0_96x64_cabac.avi',\n"
        "             'h264_b_implicit_96x64_cavlc.mov'):\n"
        "    v = vio.EncodedVideo('tests/goldens/video/' + name)\n"
        "    with open(v.path, 'rb') as f:\n"
        "        pk = [v.box.sample(f, i) for i in range(v.samples)]\n"
        "    for trial in range(90):\n"
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
        "        dec = h264.Decoder(extradata=v.box.dsi, delay=2)\n"
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


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["h264_b_clip_cavlc.mp4",
                                  "h264_b_clip_cabac.mkv",
                                  "h264_b_clip_cavlc.avi",
                                  "h264_b_temporal_96x64_cabac.mkv"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    p = hc.path(name)
    hc.same(list(vio.read_frames(p, max_frames=12, stride=2)),
            list(jvideo.frame_pairs_from_video(p, max_frames=12, stride=2)))


@pytest.mark.parametrize("name,stride", [
    ("h264_b_clip_cabac.mp4", 1), ("h264_b_clip_cavlc.avi", 3),
    ("h264_b_clip_cabac.flv", 2), ("h264_b_clip_cavlc.wmv", 2)])
def test_jax_consecutive_frames_equal(name, stride):
    """Pairs read in order (stride 1: no seek) or by seeking, equal (FLV's
    and ASF's count, from their durations, passes the 13 pictures: pairs
    past them are read by neither)."""
    p = hc.path(name)
    ds = datasets.ConsecutiveFrames(p, size_hw=(64, 96), stride=stride)
    jds = jdatasets.ConsecutiveFrames(p, size_hw=(64, 96), stride=stride)
    assert ds.index == jds.index
    for i, (_, b) in enumerate(ds.index):
        if b >= MANIFEST[name]["decoded"]:
            continue
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


@pytest.mark.parametrize("index", ["2", "7"])
def test_capture_frame_agrees_with_jax(index, tmp_path):
    """Both CLIs write the same PNG of a B picture after a seek."""
    p = hc.path("h264_b_clip_cabac.mov")
    outs = []
    for cli, name in ((jcapture, "jax.png"), (capture_frame, "port.png")):
        out = str(tmp_path / name)
        assert cli.main([p, index, out]) == 0
        outs.append(cv2.imread(out))
    np.testing.assert_array_equal(*outs)


def test_extract_video_reads_cv2s_frames(tmp_path, monkeypatch):
    """The video CLI over an H.264 .mp4 with B pictures: the frames it
    reads are cv2.VideoCapture's, and cv2 reads its .avi output with the
    clip's count less one, fps and size."""
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
    sps = [hs.Sps(mb_w=6, mb_h=4, max_num_ref_frames=3)]
    pics = [hs.Pic(idr=True, mb_types=("I16", "I4"), poc=0),
            hs.Pic(kind="P", mb_types=("P", "SKIP"), poc=6),
            hs.Pic(kind="B", mb_types=("B", "SKIP"), poc=2, ref_idc=0,
                   num_ref_idx="all"),
            hs.Pic(kind="B", mb_types=("B", "SKIP"), poc=4, ref_idc=0,
                   num_ref_idx="all", direct_spatial=False)]
    h264_write(src, sps, [hs.Pps(cabac=True, transform_8x8=True)], pics, 12)
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
    assert len(seen) == 4
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    assert (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) == (96, 64)
