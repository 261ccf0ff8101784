"""H.264's CABAC fixtures (``runtime/h264``) against OpenCV's FFmpeg and
cv2's bundled libavcodec: the twins of ``test_torch_h264.py``'s CAVLC
fixtures, each the same stream description written with CABAC (the seeded
syntax writer ``tests/h264_syntax.py`` derives every bin's context as the
standard does, the decoder as FFmpeg does, and cv2 judges both).

Tolerance: 0 throughout (frames, cv2's info and seeks, the decoder's
features, the planes libavcodec hands over).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)

import numpy as np
import pytest

import h264_checks as hc
import h264_syntax as hs
from make_video_fixtures import Lavc
from opticalflow_tpu_torch.runtime import h264

MANIFEST = hc.MANIFEST


@pytest.fixture(scope="module", autouse=True)
def library():
    return h264.load()


@pytest.mark.parametrize("name", hc.CABAC)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    hc.frames_equal_cv2_and_the_manifest(name)


@pytest.mark.parametrize("name", hc.CABAC)
def test_video_info_equals_cv2(name):
    hc.video_info_equals_cv2(name)


@pytest.mark.parametrize("name", hc.CABAC)
def test_every_seek_reads_the_frame_cv2_reads(name):
    hc.every_seek_reads_cv2s_frame(name)


@pytest.mark.parametrize("name", hc.CABAC)
def test_manifest_features_are_the_decoders(name):
    hc.features_are_the_decoders(name)


@pytest.mark.parametrize("name", hc.CABAC)
def test_planes_equal_libavcodecs(name):
    hc.planes_equal_libavcodecs(name)


@pytest.mark.parametrize("name", hc.CABAC)
def test_each_cabac_fixture_reaches_what_its_cavlc_twin_does(name):
    """The same stream in CABAC (the writer's same seed: the same
    macroblocks, modes, vectors and levels) reaches the same tools and
    intra modes as its CAVLC twin, but for the entropy coder and
    P_8x8ref0 (CABAC has no binarisation of it: the writer codes P_8x8
    with references 0), so each context is checked on a picture whose CAVLC
    twin passes."""
    mine = set(MANIFEST[name]["h264_features"])
    twin = set(MANIFEST[name.replace("_cabac", "_cavlc")]["h264_features"])
    assert "cabac" in mine and "cavlc" in twin
    coder = {"cabac", "cavlc", "p_8x8ref0", "p_8x8", "level_escape"}
    assert mine - coder == twin - coder
    if "p_8x8ref0" in twin:
        assert "p_8x8" in mine


@pytest.mark.parametrize("qp,init", [(0, 0), (12, 1), (26, 2), (51, 0)])
def test_every_context_initialises_as_ffmpegs_at_each_qp(qp, init):
    """P slices at slice QP ``qp`` and cabac_init_idc ``init`` (and an I
    slice at the same QP) decode to libavcodec's planes: each table of
    context initialisations read right at the QPs where the clip of
    (m * qp >> 4) + n bites."""
    sps = [hs.Sps(mb_w=4, mb_h=3, max_num_ref_frames=1)]
    pps = [hs.Pps(cabac=True, init_qp=qp, transform_8x8=True)]
    sl = [hs.SliceSpec(0, 12, cabac_init_idc=init)]
    mix = ("P", "SKIP", "I4", "I8", "I16")
    pics = [hs.Pic(idr=True, mb_types=("I4", "I8", "I16"), qp_deltas=0,
                   slices=sl)] + [hs.Pic(kind="P", mb_types=mix, slices=sl,
                                         qp_deltas=0) for _ in range(2)]
    aus = hs.write_stream(40 + qp, sps, pps, pics)
    ref = Lavc().decode(aus, "h264")
    dec = h264.Decoder()
    mine = [p for au in aus for p in dec.decode(au)] + dec.flush()
    assert len(ref) == len(mine) == 3
    for a, b in zip(ref, mine):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
