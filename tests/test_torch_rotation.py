"""A video's display matrix, turned as ``cv2.VideoCapture`` turns it
(``io/orientation``): frames, sizes and seeks against OpenCV 5's FFmpeg
backend (``CAP_PROP_ORIENTATION_AUTO`` on, its default) and the JAX
package's cv2-based readers.

Tolerance: 0 throughout.  The fixtures (group ``rotation``) patch ``tkhd``
matrices into committed MPEG-4 Part 2, H.263 and H.264 files (.mp4 and
.mov; one of B pictures whose ``elst`` shifts the track) at 90, 180 and
270 degrees, mirrored at 0 and 90, and at 45 (which cv2 leaves unturned);
and Matroska Projections written by cv2's libavformat from display matrix
side data.  AVI, MPEG-TS, NUT, ASF and FLV carry no matrix cv2 reads.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import io
import os
import sys

import cv2
import numpy as np
import pytest
import torch

import h264_checks as hc
import h264_syntax as hs
from make_video_fixtures import (Lavf, _cv2_seeks, patch_tkhd,
                                 rotation_matrix)
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame, extract_video
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.orientation import (matrix_angle,
                                                  projection_matrix)

MANIFEST = hc.MANIFEST
ROTATED = sorted(n for n, e in MANIFEST.items() if e["group"] == "rotation")


def _meta(p):
    cap = cv2.VideoCapture(p)
    angle = cap.get(cv2.CAP_PROP_ORIENTATION_META)
    cap.release()
    return int(angle)


@pytest.mark.parametrize("name", ROTATED)
def test_rotated_frames_equal_cv2_and_the_manifest(name):
    hc.frames_equal_cv2_and_the_manifest(name)


@pytest.mark.parametrize("name", ROTATED)
def test_rotated_video_info_equals_cv2(name):
    """Width and height swapped at 90 and 270 (and only there)."""
    hc.video_info_equals_cv2(name)


@pytest.mark.parametrize("name", ROTATED)
def test_rotated_seeks_read_cv2s_frames(name):
    hc.every_seek_reads_cv2s_frame(name)


@pytest.mark.parametrize("name", ROTATED)
def test_the_angle_is_cv2s(name):
    p = hc.path(name)
    assert vio.EncodedVideo(p).rotation == _meta(p)


def test_the_fixtures_cover_each_angle_and_container():
    angles = {n: _meta(hc.path(n)) for n in ROTATED}
    assert set(angles.values()) == {45, 90, 180, 270}
    for ext in ("mp4", "mov", "mkv"):
        assert {a for n, a in angles.items() if n.endswith(ext)} >= {90, 270}
    assert {n.split("_")[1] for n in ROTATED} == {"mpeg4", "h263", "h264",
                                                 "h264b"}


@pytest.mark.parametrize("deg,mirror", [(30, False), (135, False),
                                        (-45, False), (200, False),
                                        (270, True), (180, True),
                                        (89.9, False), (90.6, False)])
def test_any_matrix_turns_as_cv2_turns_it(deg, mirror, tmp_path):
    """A matrix at any angle, mirrored or not: the port's angle is cv2's
    (rounded to whole degrees), and so are its frames and size (turned at
    90, 180 and 270 alone)."""
    p = str(tmp_path / "r.mp4")
    patch_tkhd(hc.path("h264_clip_cavlc.mp4"), p, rotation_matrix(deg, mirror))
    assert vio.EncodedVideo(p).rotation == _meta(p)
    assert vio.video_info(p) == hc.cv2_info(p)
    hc.same(list(vio.read_frames(p)), hc.cv2_frames(p))


def test_a_scaled_matrix_turns_by_its_angle(tmp_path):
    """A matrix that scales as it turns (twice the unit): the angle
    av_display_rotation_get normalises out."""
    m = rotation_matrix(90)
    m = [2 * v if i in (0, 1, 3, 4) else v for i, v in enumerate(m)]
    assert matrix_angle(m) == 90
    p = str(tmp_path / "s.mov")
    patch_tkhd(hc.path("h264_clip_cabac.mov"), p, m)
    assert _meta(p) == 90
    hc.same(list(vio.read_frames(p)), hc.cv2_frames(p))


def test_matroska_projection_to_matrix():
    """matroskadec's rectangular Projection: roll turns counter-clockwise
    (cv2's angle is clockwise), a yaw of 180 flips (cv2 then turns by
    the angle alone, the other way); a pitch or another yaw gives no
    matrix."""
    assert matrix_angle(projection_matrix(0.0, 0.0, 90.0)) == 270
    assert matrix_angle(projection_matrix(0.0, 0.0, -90.0)) == 90
    assert matrix_angle(projection_matrix(180.0, 0.0, 90.0)) == 90
    assert projection_matrix(0.0, 0.0, 0.0) is None
    assert projection_matrix(0.0, 10.0, 90.0) is None
    assert projection_matrix(45.0, 0.0, 90.0) is None


@pytest.mark.parametrize("ext", [".avi", ".ts", ".nut", ".wmv", ".flv"])
def test_other_containers_carry_no_matrix_cv2_reads(ext, tmp_path):
    """Display matrix side data handed to libavformat's muxers for AVI,
    MPEG-TS, NUT, ASF and FLV is not written (or not read back): cv2
    reports no orientation and turns nothing, nor does the port."""
    sps, pps = [hs.Sps(max_num_ref_frames=1)], [hs.Pps()]
    aus = hs.write_stream(3, sps, pps, [hs.Pic(idr=True, mb_types=("I16",))]
                          + [hs.Pic(kind="P", mb_types=("P", "SKIP"))] * 3)
    p = str(tmp_path / f"m{ext}")
    Lavf().mux(p, [(a, i == 0) for i, a in enumerate(aus)],
               b"".join(b"\0\0\0\1" + n for n in hs.parameter_sets(sps, pps)),
               96, 64, display_matrix=rotation_matrix(90))
    assert _meta(p) == 0
    assert vio.EncodedVideo(p).rotation == 0
    assert vio.video_info(p)["width"] == hc.cv2_info(p)["width"] == 96
    hc.same(list(vio.read_frames(p)), hc.cv2_frames(p))


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["rot_h264_90.mp4", "rot_mpeg4_270.mp4",
                                  "rot_h264_270.mkv"])
def test_capture_frame_agrees_with_jax(name, tmp_path):
    """Both CLIs write the same (turned) PNG after a seek."""
    p = hc.path(name)
    outs = []
    for cli, out in ((jcapture, "jax.png"), (capture_frame, "port.png")):
        out = str(tmp_path / out)
        assert cli.main([p, "3", out]) == 0
        outs.append(cv2.imread(out))
    np.testing.assert_array_equal(*outs)
    assert outs[0].shape[:2] == (MANIFEST[name]["height"],
                                 MANIFEST[name]["width"])


@pytest.mark.parametrize("name,stride", [("rot_h264b_90.mp4", 2),
                                         ("rot_mpeg4_180.mp4", 1)])
def test_jax_consecutive_frames_equal(name, stride):
    p = hc.path(name)
    hw = (MANIFEST[name]["height"], MANIFEST[name]["width"])
    ds = datasets.ConsecutiveFrames(p, size_hw=hw, stride=stride)
    jds = jdatasets.ConsecutiveFrames(p, size_hw=hw, stride=stride)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_extract_video_writes_the_jax_clis_size(tmp_path):
    """The video CLI over a portrait (90-degree) .mp4: it reads cv2's
    turned frames, and sizes its output as the JAX CLI sizes its writer
    (cv2's CAP_PROP_FRAME_WIDTH and HEIGHT of the source: 64x96), which
    cv2 reads back at that size."""
    sys.path.insert(0, os.path.dirname(__file__))
    from oracles.torch_pwcnet import OraclePWC
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for q in net.parameters():
        q.data *= 0.5
    ckpt = str(tmp_path / "fake.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               net.state_dict_flat().items()}}, ckpt)
    src = hc.path("rot_h264_90.mp4")
    out = str(tmp_path / "arrows.avi")
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_video.main([src, out, "--ckpt", ckpt, "--batch", "2",
                                   "--max-frames", "4", "--dtype", "float32",
                                   "--device", "cpu"]) == 0
    cap = cv2.VideoCapture(src)
    jax_size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    info = hc.cv2_info(out)
    assert (info["width"], info["height"]) == jax_size == (64, 96)
    assert info["frames"] == 3
