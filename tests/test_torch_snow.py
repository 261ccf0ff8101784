"""Snow (``runtime/snow``) in AVI, Matroska, QuickTime and ASF against
OpenCV's FFmpeg and the JAX package's cv2-based readers.

Tolerance: 0 throughout.  The decoder is FFmpeg's integer arithmetic (the
range coder, the 9/7 and 5/3 lifting in 16-bit lines, h264's qpel and
mc_block's half-pel planes, the OBMC sum in FRAC_BITS) and the conversion
swscale's (``runtime/mpeg4.i420_to_bgr``/``yuv_to_bgr``), so every frame
equals cv2's bit for bit: on the committed fixtures (``tests/goldens/video``,
group ``snow``: cv2's writer in each container, at an odd size and at full
width; libavcodec's encoder with each of its tools, pixel formats and a
quantiser ladder; crafted headers), through every seek cv2 makes and in the
JAX package's readers.  The library is built once for the module (g++, a
few seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import hashlib
import json
import math
import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest

from make_video_fixtures import SnowCraft, snow_crafted
from opticalflow_tpu import video as jvideo
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.asf import AsfFile
from opticalflow_tpu_torch.io.avi import AviFile, codec_of
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.runtime import snow
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
TABLES = os.path.join(ROOT, "opticalflow_tpu_torch", "runtime",
                      "snow_tables.h")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
SNOW = sorted(n for n, e in MANIFEST.items() if e["group"] == "snow")
READ = [n for n in SNOW if "port_refuses" not in MANIFEST[n]]
CRAFTED = sorted(snow_crafted())
SINTEL = "snow_sintel_436x1024.avi"


@pytest.fixture(scope="module", autouse=True)
def library():
    return snow.load()


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


def _video(name):
    v = vio.EncodedVideo(_path(name))
    with open(v.path, "rb") as f:
        return v, [v.box.sample(f, i) for i in range(v.samples)]


# ---------------------------------------------------------------- fixtures

def test_fixtures_cover_what_cv2_writes_and_reads():
    """cv2's writer in .avi, .mkv, .mov and .wmv (25 frames, key frames at
    0, 12 and 24), from a 53x37 input (cv2 writes 52x36), .wmv at 24 fps
    and the full-width clip the card run reads; libavcodec's tools; the
    crafted headers; the group under about 1.5 MB."""
    need = {f"snow_96x64.{ext}" for ext in ("avi", "mkv", "mov", "wmv")}
    need |= {"snow_53x37.avi", "snow_24fps_96x64.wmv", SINTEL,
             "snow_lavc_53x37.avi"}
    need |= {f"snow_lavc_{t}_64x48.avi" for t in (
        "dwt53", "lossless", "qpel", "mv4", "refs3", "iter", "memc_only",
        "g1", "yuv410p", "yuv444p", "gray", "q1", "q4", "q12", "q31",
        "combo")}
    need |= {f"snow_craft_{c}_64x48.avi" for c in CRAFTED}
    assert need == set(SNOW)
    total = sum(os.path.getsize(_path(n)) for n in SNOW)
    assert total <= 1_500_000, total
    assert MANIFEST[SINTEL]["decoded"] == 13
    assert (MANIFEST[SINTEL]["width"], MANIFEST[SINTEL]["height"]) == (1024,
                                                                       436)
    assert (MANIFEST["snow_53x37.avi"]["width"],
            MANIFEST["snow_53x37.avi"]["height"]) == (52, 36)
    assert (MANIFEST["snow_lavc_53x37.avi"]["width"],
            MANIFEST["snow_lavc_53x37.avi"]["height"]) == (53, 37)
    for name in ("snow_96x64.avi", "snow_96x64.mkv", "snow_96x64.mov",
                 "snow_96x64.wmv"):
        assert MANIFEST[name]["decoded"] == 25


@pytest.mark.parametrize("name", READ)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", SNOW)
def test_video_info_equals_cv2(name):
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", READ)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """OpenCV's seek lands on a key frame at or before its target and
    counts on: every recorded seek reads its own frame, the port's from the
    last key frame before it, in a capture just opened and reading on (the
    manifest names the first frame equal to what the seek read)."""
    want = MANIFEST[name]
    video = vio.EncodedVideo(_path(name))
    assert sorted(want["seeks"], key=int) == [
        str(t) for t in range(want["decoded"])]
    for t, hit in want["seeks"].items():
        assert want["sha256"][hit] == want["sha256"][int(t)], t
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t
        video.close()       # a capture just opened: read(t) seeks
        assert _digest(video.read(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", READ)
def test_manifest_features_are_the_decoders(name):
    video, packets = _video(name)
    dec = video._decoder()
    for p in packets:
        dec.decode(p)
    assert dec.features == MANIFEST[name]["snow_features"]


def test_what_each_fixture_reaches_and_what_none_does():
    """Each tool libavcodec's encoder has is reached where it was asked
    for; what no fixture reaches is an inter frame's new decomposition
    count, which the encoder never sends."""
    need = {"snow_lavc_dwt53_64x48.avi": {"dwt53"},
            "snow_lavc_lossless_64x48.avi": {"dwt53", "lossless"},
            "snow_lavc_qpel_64x48.avi": {"qpel_vectors", "mc_h264_qpel",
                                         "mc_block", "mc_bilinear"},
            "snow_lavc_mv4_64x48.avi": {"split_blocks"},
            "snow_lavc_refs3_64x48.avi": {"several_refs", "ref_index"},
            "snow_lavc_iter_64x48.avi": {"inter_frames"},
            "snow_lavc_53x37.avi": {"intra_blocks", "mc_block"},
            "snow_lavc_yuv410p_64x48.avi": {"yuv410p", "mc_block"},
            "snow_lavc_yuv444p_64x48.avi": {"yuv444p"},
            "snow_lavc_gray_64x48.avi": {"gray"},
            "snow_lavc_combo_64x48.avi": {
                "qpel_vectors", "split_blocks", "several_refs", "ref_index",
                "intra_blocks", "mc_bilinear"},
            "snow_96x64.avi": {"key_frames", "inter_frames", "dwt97",
                               "yuv420p", "hpel_vectors", "qbias",
                               "qlog_delta", "edge_replicated"},
            SINTEL: {"intra_blocks", "mc_block", "mc_h264_qpel"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["snow_features"]), name
    assert MANIFEST["snow_lavc_g1_64x48.avi"]["snow_features"] == [
        "key_frames", "dwt97", "yuv420p"]
    reached = {f for n in READ for f in MANIFEST[n]["snow_features"]}
    assert _MANIFEST["snow_unreached"] == [
        f for f in snow.FEATURES if f not in reached] == ["count_update"]


# ---------------------------------------------------------------- tables

def _table(name):
    with open(TABLES) as f:
        src = f.read()
    body = re.search(name + r"\[\d+\] = \{(.*?)\};", src, re.S).group(1)
    return [int(x) for x in re.findall(r"\d+", body)]


@pytest.mark.parametrize("name,n", [("kObmc32", 32), ("kObmc16", 16),
                                    ("kObmc8", 8), ("kObmc4", 4)])
def test_obmc_windows_overlap_to_a_constant(name, n):
    """Each OBMC window is symmetric, and its four quadrants, which the four
    blocks around a pixel weigh it by, sum to 256 everywhere (the
    prediction's weights add up to one)."""
    w = np.array(_table(name)).reshape(n, n)
    assert (w == w.T).all() and (w == w[::-1]).all() and (w == w[:, ::-1]).all()
    h = n // 2
    assert (w[:h, :h] + w[:h, h:] + w[h:, :h] + w[h:, h:] == 256).all()


def test_qexp_and_mc_tables():
    """ff_qexp is 128 * 2^(i/32) rounded, so monotone; mc_block's weights
    are eighths, its planes the nine half-pel positions and the bilinear
    mark 0xCC."""
    with open(os.path.join(ROOT, "opticalflow_tpu_torch", "runtime",
                           "snow.cpp")) as f:
        body = re.search(r"kQExp\[kQRoot\] = \{(.*?)\};", f.read(),
                         re.S).group(1)
    qexp = [int(x) for x in re.findall(r"\d+", body)]
    assert qexp == [math.floor(128 * 2 ** (i / 32) + 0.5) for i in range(32)]
    assert all(a < b for a, b in zip(qexp, qexp[1:]))
    weight, brane, needs = (_table(n) for n in ("kWeight", "kBrane",
                                                "kNeeds"))
    assert all(0 <= a <= 8 for a in weight) and weight[0] == 8
    assert needs == [0, 1, 0, 0, 2, 4, 2, 0, 0, 1, 0, 0, 15, 0, 0, 0]
    halves = {0, 1, 2, 4, 5, 6, 8, 9, 10, 12}
    assert all(b >> 4 in halves and b & 15 in halves for b in brane)
    assert brane[0] == 0 and 0xCC in brane


# ------------------------------------------------------------- refusals

# what cv2 reads of each crafted stream: FFmpeg ignores the temporal
# fields and spatial scalability and decodes always_reset and any MC
# filter (the textured streams: intra blocks' colours, then vectors into
# them through each filter); it refuses other colour spaces and chroma
# shifts, and so does the port
CV2_DECODES = {"default": 2, "always_reset": 2, "temporal_type": 2,
               "temporal_count": 2, "scalability": 2, "htaps4": 2,
               "diag_mc0": 2, "colorspace2": 0, "shifts10": 0, "shifts33": 0,
               "textured_default": 3, "textured_htaps4": 3,
               "textured_htaps6": 3, "textured_diag_mc0": 3}
REFUSED = {"colorspace2": "colorspace_type 2",
           "shifts10": "chroma shifts 1,0", "shifts33": "chroma shifts 3,3"}
# the header fields and filters each crafted stream reaches
REACHES = {"always_reset": {"always_reset"},
           "temporal_type": {"temporal_decomposition"},
           "temporal_count": {"temporal_decomposition"},
           "scalability": {"spatial_scalability"},
           "htaps4": {"mc_filter"}, "diag_mc0": {"mc_filter", "no_diag_mc"},
           "textured_htaps4": {"mc_filter", "intra_blocks", "mc_block"},
           "textured_htaps6": {"mc_filter", "intra_blocks", "mc_block"},
           "textured_diag_mc0": {"mc_filter", "no_diag_mc", "mc_bilinear"},
           "textured_default": {"intra_blocks", "mc_block"}}


@pytest.mark.parametrize("name", CRAFTED)
def test_crafted_headers_raise_naming_item_8(name):
    """A colour space or chroma shifts FFmpeg refuses (cv2 reads no frame)
    raise Unsupported naming item 8, in the stream the fixtures hold and in
    the packets ``SnowCraft`` writes now.  Every other header value
    libavcodec's encoder never writes decodes as FFmpeg decodes it: the
    grey streams to cv2's grey frames, the textured ones (a non-default
    filter on non-zero vectors) to cv2's digests.  The manifest records
    what cv2 reads of each and what each reaches."""
    fixture = f"snow_craft_{name}_64x48.avi"
    assert MANIFEST[fixture]["decoded"] == CV2_DECODES[name]
    packets = snow_crafted()[name]
    assert packets == _video(fixture)[1]
    dec = snow.Decoder(64, 48)
    if name not in REFUSED:
        assert "port_refuses" not in MANIFEST[fixture]
        frames = [dec.decode(p) for p in packets]
        if not name.startswith("textured"):
            for y, u, v in frames:
                assert (y == 128).all() and (u == 128).all() and \
                    (v == 128).all()
        assert REACHES.get(name, set()) <= set(dec.features)
        assert [hashlib.sha256(f.tobytes()).hexdigest()
                for f in vio.read_frames(_path(fixture))] == \
            MANIFEST[fixture]["sha256"]
        return
    assert ITEM_8 in MANIFEST[fixture]["port_refuses"]
    with pytest.raises(Unsupported, match=f"{REFUSED[name]}.*{ITEM_8}"):
        for p in packets:
            dec.decode(p)
    with pytest.raises(Unsupported, match=ITEM_8):
        list(vio.read_frames(_path(fixture)))


def test_memc_only_key_frames_are_refused_as_ffmpeg_refuses_them():
    """libavcodec's ``memc_only`` writes key frames without coefficients,
    whose block tree runs past the packet: FFmpeg refuses each and cv2 reads
    no frame; the port raises ValueError."""
    name = "snow_lavc_memc_only_64x48.avi"
    assert MANIFEST[name]["decoded"] == 0 and MANIFEST[name]["frames"] == 4
    assert _cv2_frames(_path(name)) == []
    with pytest.raises(ValueError, match="ends inside its block tree"):
        list(vio.read_frames(_path(name)))


def test_a_changed_pixel_format_and_a_missing_key_frame_raise():
    """FFmpeg keeps the pixel format of the first picture and refuses a key
    frame in another; an inter frame before any key frame has nothing to
    predict from."""
    c = SnowCraft(64, 48)
    first, inter = c.key(), c.inter()
    gray = SnowCraft(64, 48).key(colorspace=1)
    dec = snow.Decoder(64, 48)
    dec.decode(first)
    with pytest.raises(ValueError, match="pixel format changed"):
        dec.decode(gray)
    with pytest.raises(ValueError, match="before the first key frame"):
        snow.Decoder(64, 48).decode(inter)
    assert len(snow.Decoder(64, 48).decode(gray)) == 1


def test_damaged_packets_raise_value_error_and_never_crash():
    for name in ("snow_lavc_combo_64x48.avi", "snow_lavc_lossless_64x48.avi",
                 "snow_lavc_yuv410p_64x48.avi"):
        video, packets = _video(name)
        with pytest.raises(ValueError, match="corrupt"):
            video._decoder().decode(packets[0][:3])
        rng = np.random.default_rng(7)
        for _ in range(20):
            dec = video._decoder()
            for p in packets[:4]:
                data = bytearray(p)
                for _ in range(3):
                    data[int(rng.integers(0, len(data)))] ^= int(
                        rng.integers(1, 256))
                try:
                    dec.decode(bytes(data))
                except ValueError:
                    pass


# ------------------------------------------------------------- containers

def test_containers_carry_the_codec():
    """AVI and ASF (the BITMAPINFOHEADER's SNOW, in any case), Matroska
    (V_SNOW) and QuickTime (the SNOW entry) all name the codec."""
    assert codec_of("SNOW", "x.avi") == codec_of("snow", "x") == "snow"
    for box in (AviFile(_path("snow_96x64.avi")),
                MkvFile(_path("snow_96x64.mkv")),
                Mp4File(_path("snow_96x64.mov")),
                AsfFile(_path("snow_96x64.wmv"))):
        assert box.codec == "snow", box
        assert box.dsi == b""


@pytest.mark.parametrize("name", READ)
def test_keyframes_are_the_key_frames(name):
    """The container's key flags are the frames whose first range-coded
    bit is the key bit."""
    video, packets = _video(name)
    keys = [i for i, p in enumerate(packets) if snow.is_keyframe(p)]
    assert video.keyframes == keys and keys[0] == 0


def test_reading_needs_no_opencv():
    """The port reads Snow in .avi and .wmv with cv2 never imported."""
    code = ("import sys\n"
            "from opticalflow_tpu_torch.io import video as vio\n"
            f"for n in ('{SINTEL}', 'snow_96x64.wmv'):\n"
            f"    assert len(list(vio.read_frames('{FIXTURES}/' + n))) > 0\n"
            "print('cv2' in sys.modules, 'PIL' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", [SINTEL, "snow_96x64.mkv", "snow_96x64.mov",
                                  "snow_96x64.wmv",
                                  "snow_lavc_yuv444p_64x48.avi"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=14, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=14, stride=2)))


@pytest.mark.parametrize("name,hw", [(SINTEL, (436, 1024)),
                                     ("snow_96x64.avi", (64, 96))])
def test_jax_consecutive_frames_equal(name, hw):
    path = _path(name)
    ds = datasets.ConsecutiveFrames(path, size_hw=hw, stride=3)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=hw, stride=3)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")
