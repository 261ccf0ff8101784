"""Checks shared by ``test_torch_h264.py`` (the CAVLC fixtures) and
``test_torch_h264_cabac.py`` (the CABAC ones): each fixture of group
``h264`` against live cv2, the manifest and cv2's bundled libavcodec.
Tolerance 0 throughout."""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from make_video_fixtures import h264_lavc_planes, plane_digest
from opticalflow_tpu_torch.io import video as vio

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST_ALL = json.load(_f)
MANIFEST = MANIFEST_ALL["files"]
H264 = sorted(n for n, e in MANIFEST.items() if e["group"] == "h264")
CAVLC = [n for n in H264 if "_cavlc" in n]
CABAC = [n for n in H264 if "_cabac" in n]
# the B picture fixtures (group h264_b)
H264_B = sorted(n for n, e in MANIFEST.items() if e["group"] == "h264_b")
B_CAVLC = [n for n in H264_B if "_cavlc" in n]
B_CABAC = [n for n in H264_B if "_cabac" in n]


def path(name):
    return os.path.join(FIXTURES, name)


def cv2_frames(p):
    cap = cv2.VideoCapture(p)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            cap.release()
            return out
        out.append(frame)


def cv2_info(p):
    cap = cv2.VideoCapture(p)
    info = {"fps": cap.get(cv2.CAP_PROP_FPS),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    cap.release()
    return info


def digest(frame):
    return hashlib.sha256(np.ascontiguousarray(frame).tobytes()).hexdigest()


def same(a, b):
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {k}")


def frames_equal_cv2_and_the_manifest(name):
    got = list(vio.read_frames(path(name)))
    same(got, cv2_frames(path(name)))
    assert [digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


def video_info_equals_cv2(name):
    p = path(name)
    assert vio.video_info(p) == cv2_info(p) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


def every_seek_reads_cv2s_frame(name, none_read=False):
    """Each recorded seek (an index cv2 read after CAP_PROP_POS_FRAMES)
    reads cv2's frame through ``frame`` and through ``read`` after a
    close; where cv2 read no frame (``none_read``: B pictures in a
    transport stream, whose seek FFmpeg lands where its decoder finds no
    co-located picture), the port reads none either and says so."""
    want = MANIFEST[name]
    video = vio.EncodedVideo(path(name))
    assert sorted(want["seeks"], key=int) == [
        str(t) for t in range(want["decoded"])]
    for t, hit in want["seeks"].items():
        if hit is None and none_read:
            with pytest.raises(ValueError, match="reads no frame"):
                video.frame(int(t))
            continue
        assert hit is not None and hit >= 0, t
        assert digest(video.frame(int(t))) == want["sha256"][hit], t
        if t != "0":
            video.close()
            assert digest(video.read(int(t))) == want["sha256"][hit], t


def features_are_the_decoders(name):
    video = vio.EncodedVideo(path(name))
    dec = video._decoder()
    with open(video.path, "rb") as f:
        for i in range(video.samples):
            dec.decode(video.box.sample(f, i))
    dec.flush()
    assert dec.features == MANIFEST[name]["h264_features"]


def planes_equal_libavcodecs(name):
    """Each picture's Y, U and V equal those cv2's bundled libavcodec's
    h264 decoder hands over (ctypes, ``Lavc.decode``, the container's avcC
    or parameter sets as its extradata), before swscale, and the digests
    the manifest recorded of them."""
    video = vio.EncodedVideo(path(name))
    mine = [p for _, p in video.planes(0)]
    ref = h264_lavc_planes(path(name))
    assert len(mine) == len(ref) == MANIFEST[name]["decoded"]
    for got, want in zip(mine, ref):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert [plane_digest(p) for p in mine] == MANIFEST[name]["h264_planes"]
