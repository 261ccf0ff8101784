"""H.264 B pictures' CABAC fixtures (``runtime/h264``) against OpenCV's
FFmpeg and cv2's bundled libavcodec: the twins of ``test_torch_h264_b.py``'s
CAVLC fixtures, each the same stream description written with CABAC (the
writer codes each B context as the standard derives it: mb_skip_flag
24-26, mb_type 27-35, sub_mb_type 36-39, refIdxZeroFlag for direct
neighbours, list 1's mvd; the decoder as FFmpeg does; cv2 judges both).

Tolerance: 0 throughout.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)

import pytest

import h264_checks as hc
from make_video_fixtures import Lavf
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.runtime import h264
from test_torch_h264_b import writer_streams_decode_as_libavcodec

MANIFEST = hc.MANIFEST


@pytest.fixture(scope="module", autouse=True)
def library():
    return h264.load()


@pytest.mark.parametrize("name", hc.B_CABAC)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    hc.frames_equal_cv2_and_the_manifest(name)


@pytest.mark.parametrize("name", hc.B_CABAC)
def test_video_info_equals_cv2(name):
    hc.video_info_equals_cv2(name)


@pytest.mark.parametrize("name", hc.B_CABAC)
def test_every_seek_reads_the_frame_cv2_reads(name):
    hc.every_seek_reads_cv2s_frame(name, none_read=name.endswith(".ts"))


@pytest.mark.parametrize("name", hc.B_CABAC)
def test_manifest_features_are_the_decoders(name):
    hc.features_are_the_decoders(name)


@pytest.mark.parametrize("name", hc.B_CABAC)
def test_planes_equal_libavcodecs(name):
    hc.planes_equal_libavcodecs(name)


@pytest.mark.parametrize("name", hc.B_CABAC)
def test_the_starting_reorder_depth_is_ffmpegs_probes(name):
    p = hc.path(name)
    assert vio.EncodedVideo(p).h264_delay == Lavf().video_delay(p) == 2


@pytest.mark.parametrize("name", hc.B_CABAC)
def test_each_cabac_fixture_reaches_what_its_cavlc_twin_does(name):
    """The same stream in CABAC (the writer's same seed: the same
    macroblocks, references and vectors) reaches the same tools as its
    CAVLC twin, but for the entropy coder."""
    twin = name.replace("_cabac", "_cavlc")
    a = set(MANIFEST[name]["h264_features"]) - {"cabac"}
    # CABAC has no binarisation of P_8x8ref0 (the writer codes P_8x8)
    b = set(MANIFEST[twin]["h264_features"]) - {"cavlc", "p_8x8ref0"}
    assert a == b


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("bipred", [0, 1, 2])
def test_the_writers_b_streams_decode_as_libavcodec(spatial, bipred,
                                                    tmp_path):
    writer_streams_decode_as_libavcodec(True, spatial, bipred, tmp_path)
