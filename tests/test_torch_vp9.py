"""The port's VP9 decoder (``runtime/vp9``) behind ``io/video``, in WebM,
Matroska, MP4 and AVI, against OpenCV's FFmpeg (``cv2.VideoCapture`` runs
FFmpeg's native vp9 decoder and swscale) and the JAX package's cv2-based
readers.

Tolerance: 0 throughout.  VP9's reconstruction is exact integer arithmetic
and the conversion is swscale's, so every frame equals cv2's bit for bit:
on the committed fixtures (``tests/goldens/video/vp9_*``: cv2's writer,
byte patches of what it wrote, and libvpx's encoder at the settings cv2's
writer does not reach; each frame's digest in the manifest, which the GPU
machine checks without cv2), through seeking, and in the CLIs.  The
library is built once for the module (g++, a few seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch

from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame, extract_video
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.runtime import vp9
from opticalflow_tpu_torch.runtime.mpeg4 import Unsupported, i420_to_bgr

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
VP9 = sorted(n for n in MANIFEST if n.startswith("vp9_"))
READ = [n for n in VP9 if "port_refuses" not in MANIFEST[n]]
WEBM = os.path.join(FIXTURES, "vp9_176x144.webm")
MP4 = os.path.join(FIXTURES, "vp9_176x144.mp4")


@pytest.fixture(scope="module", autouse=True)
def library():
    return vp9.load()


def _cv2_frames(path, threads=None):
    cap = (cv2.VideoCapture(path) if threads is None else cv2.VideoCapture(
        path, cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, threads]))
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


def _samples(path):
    box = MkvFile(path)
    with open(path, "rb") as f:
        return [box.sample(f, i) for i in range(len(box.sizes))]


# ---------------------------------------------------------------- fixtures

@pytest.mark.parametrize("name", READ)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = os.path.join(FIXTURES, name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in got] == \
        MANIFEST[name]["sha256"]


@pytest.mark.parametrize("ext", ["webm", "mkv", "mp4", "avi"])
def test_video_info_and_seeks_per_container(ext):
    """fps, size and count as cv2 reports them in each container; seeks
    into the second and third GOPs (key frames at 0, 12 and 24) as a
    CAP_PROP_POS_FRAMES seek reads them."""
    path = os.path.join(FIXTURES, f"vp9_176x144.{ext}")
    assert vio.video_info(path) == _cv2_info(path)
    for i in (13, 25, 5):
        np.testing.assert_array_equal(vio.read_frame(path, i),
                                      _cv2_seek(path, i), err_msg=f"{i}")


def test_seeks_through_superframes_and_hidden_frames():
    """The two-pass libvpx stream: hidden alt-ref frames ride in
    superframes, so a packet shows one picture or none; seeking counts
    the packets as cv2 counts its frames."""
    path = os.path.join(FIXTURES, "vp9_altref.webm")
    frames = list(vio.read_frames(path))
    video = vio.EncodedVideo(path)
    for i in (17, 18, 3, 25):
        np.testing.assert_array_equal(video.read(i), frames[i],
                                      err_msg=f"{i}")
    video.close()


def test_manifest_lists_each_fixtures_features_and_what_none_reached():
    """The manifest's ``vp9_features`` are what the decoder meets; the
    libvpx streams and the header rewrites reach what cv2's writer leaves
    out; the settings no stream reached are named (none now)."""
    for name in ("vp9_176x144.webm", "vp9_altref.webm", "vp9_aq.webm"):
        dec = vp9.Decoder(name)
        for s in _samples(os.path.join(FIXTURES, name)):
            dec.decode_all(s)
        assert dec.features == MANIFEST[name]["vp9_features"], name
    need = {"vp9_altref.webm": {"hidden_frames", "superframes", "compound",
                                "backward_adaptation"},
            "vp9_aq.webm": {"segmentation", "segment_temporal",
                            "segment_alt_q"},
            "vp9_lossless_64x48.webm": {"lossless"},
            "vp9_tiles_544x96.webm": {"tile_cols", "tile_rows"},
            "vp9_sintel_436x1024.webm": {"tile_cols"},
            "vp9_error_resilient.webm": {"error_resilient"},
            "vp9_full_range_bt709.webm": {"full_range", "color_space"},
            "vp9_176x144.webm": {"switchable_filter", "sharp_filter",
                                 "smooth_filter", "tx_32x32", "sub8x8"},
            "vp9_headers.webm": {"lf_sharpness", "q_deltas",
                                 "bilinear_filter"},
            "vp9_seg_lf.webm": {"segment_alt_lf"},
            "vp9_seg_ref_skip.webm": {"segment_ref", "segment_skip"},
            "vp9_intra_only.webm": {"intra_only", "show_existing_frame",
                                    "reset_context"},
            "vp9_resize.webm": {"scaled_reference", "size_change"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["vp9_features"]), name
    reached = {f for n in VP9 for f in MANIFEST[n]["vp9_features"]}
    assert _MANIFEST["vp9_unreached"] == [f for f in vp9.FEATURES
                                          if f not in reached]


def test_frame_header_sizes_and_keyframes():
    frames = _samples(WEBM)
    assert vp9.frame_size(frames[0]) == (176, 144)
    assert [i for i, f in enumerate(frames) if vp9.is_keyframe(f)] == \
        [0, 12, 24] == MkvFile(WEBM).keyframes
    assert vp9.frame_size(frames[1]) is None
    patched = os.path.join(FIXTURES, "vp9_175x143.webm")
    assert vp9.frame_size(_samples(patched)[12]) == (175, 143)


# ----------------------------------------------------------- colour

@pytest.mark.parametrize("name,full,matrix", [
    ("vp9_full_range.webm", True, "bt601"),
    ("vp9_bt709.webm", False, "bt709"),
    ("vp9_full_range_bt709.webm", True, "bt709")])
def test_colour_follows_the_frame_header(name, full, matrix):
    """cv2 converts with the range and matrix the VP9 header names (over
    Matroska's Range: the last fixture says broadcast range there); BT.601
    at video range, what the port did before, is off."""
    path = os.path.join(FIXTURES, name)
    video = vio.EncodedVideo(path)
    planes = [p for _, p in video.planes()]
    assert (video.full_range, video.matrix) == (full, matrix)
    want = _cv2_frames(path)
    _same([i420_to_bgr(*p, full, None, matrix) for p in planes], want)
    old = [i420_to_bgr(*p) for p in planes]
    assert max(int(np.abs(a.astype(int) - b).max())
               for a, b in zip(old, want)) >= 4


# ------------------------------------------------------------- refusals

def _header(profile: int) -> bytes:
    """A shown key frame's first bytes at a profile (3 has a reserved
    bit), with the sync code, as a 10/12-bit or 4:4:4 stream starts."""
    bits = "10" + str(profile & 1) + str(profile >> 1)
    bits += "0" if profile == 3 else ""
    bits += "0" + "0" + "1" + "0"     # show_existing, key, show, error_res
    bits += format(0x498342, "024b") + "1" * 16
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") + b"\0" * 8


@pytest.mark.parametrize("profile", [1, 2, 3])
def test_profiles_1_to_3_raise_naming_item_8(profile):
    frame = _header(profile)
    with pytest.raises(Unsupported, match=f"profile {profile}.*item 8"):
        vp9.frame_size(frame)
    with pytest.raises(Unsupported, match=f"profile {profile}.*item 8"):
        vp9.Decoder("crafted").decode(frame)


def test_reference_of_another_size_raises_naming_item_8():
    """libvpx's stream that shrinks mid-GOP predicts from references of
    the old size (scaled motion compensation), which cv2 then scales back
    to the first size: the port refuses it at that frame."""
    path = os.path.join(FIXTURES, "vp9_resize.webm")
    assert "scaled_reference" in MANIFEST["vp9_resize.webm"]["vp9_features"]
    frames = []
    with pytest.raises(Unsupported, match="another size.*item 8"):
        for f in vio.read_frames(path):
            frames.append(f)
    _same(frames, _cv2_frames(path)[:len(frames)])
    assert len(frames) == 6


def test_truncated_file_raises_value_error(tmp_path):
    data = open(WEBM, "rb").read()
    path = str(tmp_path / "cut.webm")
    with open(path, "wb") as f:
        f.write(data[:len(data) * 2 // 3])
    with pytest.raises(ValueError):
        list(vio.read_frames(path))


def test_corrupt_packets_raise_only_value_error():
    """Seeded truncations and byte flips of every packet kind (key,
    inter, superframe), in the frame header or anywhere: each decode
    returns or raises ValueError, and never crashes the process.  Damage
    past the headers mostly decodes, as FFmpeg decodes it (a tile read
    past its end reads zeros)."""
    rng = np.random.default_rng(0)
    packets = (_samples(os.path.join(FIXTURES, "vp9_altref.webm"))
               + _samples(WEBM)[:13])
    raised = 0
    for trial in range(120):
        dec = vp9.Decoder("fuzz")
        for k, pkt in enumerate(packets[:8]):
            data = bytearray(pkt)
            if k == trial % 8:
                if trial % 3 == 0:
                    data = data[:int(rng.integers(0, len(data)))]
                else:
                    span = len(data) if trial % 3 == 1 else min(12,
                                                                len(data))
                    for _ in range(int(rng.integers(1, 6))):
                        data[int(rng.integers(0, span))] ^= int(
                            rng.integers(1, 256))
            try:
                dec.decode_all(bytes(data))
            except ValueError:
                raised += 1
                break
    assert raised > 20


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("path", [WEBM, MP4])
def test_jax_frame_pairs_from_video_equal_read_frames(path):
    _same(list(vio.read_frames(path, max_frames=20, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=20, stride=2)))


@pytest.mark.parametrize("path", [WEBM, MP4])
def test_jax_consecutive_frames_equal(path):
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    assert ds.index == jds.index
    # in order (one open decoder), then out of order (seeks)
    for i in (0, 1, 2, 15, 16, 5, 23):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


@pytest.mark.parametrize("path", [WEBM, MP4])
def test_jax_capture_frame_equals(tmp_path, path):
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "17", a]) == 0
        assert jcapture.main([path, "17", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))


def test_extract_video_webm_in_mkv_out(tmp_path, monkeypatch):
    """The video CLI over a cv2-written VP9 .webm: the frames it reads are
    cv2.VideoCapture's, and cv2 reads its .mkv output with the clip's
    count (one frame a pair), fps and size, frame for frame as the port."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from oracles.torch_pwcnet import OraclePWC
    from make_video_fixtures import moving_clip
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for p in net.parameters():
        p.data *= 0.5
    ckpt = str(tmp_path / "fake.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               net.state_dict_flat().items()}}, ckpt)
    src = str(tmp_path / "clip.webm")
    wr = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"VP90"), 25.0, (96, 64))
    for f in moving_clip(64, 96, 5, seed=9, speed=3.0):
        wr.write(f)
    wr.release()
    import opticalflow_tpu_torch.video as tvideo
    seen, read = [], tvideo.read_frames

    def recording(*args, **kwargs):
        for frame in read(*args, **kwargs):
            seen.append(frame)
            yield frame
    monkeypatch.setattr(tvideo, "read_frames", recording)
    out = str(tmp_path / "arrows.mkv")
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_video.main([src, out, "--ckpt", ckpt, "--batch", "2",
                                   "--dtype", "float32", "--device",
                                   "cpu"]) == 0
    _same(seen, _cv2_frames(src))
    assert _cv2_info(out) == vio.video_info(out) == {
        "fps": 25.0, "width": 96, "height": 64, "frames": 4}
    _same(_cv2_frames(out), list(vio.read_frames(out)))
