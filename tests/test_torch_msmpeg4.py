"""MS-MPEG4 v2/v3 and WMV7/WMV8 (``runtime/msmpeg4``) in AVI, Matroska,
QuickTime and ASF against OpenCV's FFmpeg and the JAX package's cv2-based
readers.

Tolerance: 0 throughout.  The decoder is FFmpeg's integer arithmetic (the
simple IDCT or WMV8's, H.263's dequantisation and half-pel prediction)
and the conversion swscale's (``runtime/mpeg4.i420_to_bgr``), so every
frame equals cv2's bit for bit: on the committed fixtures
(``tests/goldens/video``, group ``msmpeg4``: cv2's writer in each
container; libavcodec's four encoders at four quantisers, odd sizes, a
low rate, hard edges; v3 recoded in DC and MV table 0; the Sintel pair in
WMV8), through every seek cv2 makes and in the JAX package's readers.  The
library is built once for the module (g++, a few seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import hashlib
import json
import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest

from opticalflow_tpu import video as jvideo
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.asf import AsfFile
from opticalflow_tpu_torch.io.avi import MSMPEG4_TAGS, AviFile, codec_of
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.runtime import msmpeg4
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
TABLES = os.path.join(ROOT, "opticalflow_tpu_torch", "runtime",
                      "msmpeg4_tables.h")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
MSM = sorted(n for n, e in MANIFEST.items() if e["group"] == "msmpeg4")
SINTEL = "msm_sintel_436x1024.wmv"
CODECS = {"mp42": "msmpeg4v2", "div3": "msmpeg4v3", "wmv1": "wmv1",
          "wmv2": "wmv2"}


@pytest.fixture(scope="module", autouse=True)
def library():
    return msmpeg4.load()


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
    """cv2's writer: each codec in .avi, .mkv, .mov and .wmv (.asf too for
    DIV3 and WMV2) at 96x64 and in .avi from a 53x37 input (cv2 writes
    52x36); the four ASF rates; libavcodec at four quantisers; the
    full-width clip the card run reads."""
    need = {f"msm_{c}_96x64.{ext}" for c in CODECS
            for ext in ("avi", "mkv", "mov", "wmv")}
    need |= {"msm_div3_96x64.asf", "msm_wmv2_96x64.asf", SINTEL,
             "msm_wmv2_2997_96x64.wmv", "msm_wmv2_24fps_96x64.wmv",
             "msm_div3_15fps_96x64.wmv"}
    need |= {f"msm_{c}_52x36.avi" for c in CODECS}
    need |= {f"msm_lavc_{c}_q{q}_52x36.avi" for q in (1, 4, 12, 31)
             for c in ("msmpeg4v2", "msmpeg4", "wmv1", "wmv2")}
    assert need <= set(MSM)
    assert 200_000 < os.path.getsize(_path(SINTEL)) < 400_000
    total = sum(os.path.getsize(_path(n)) for n in MSM)
    assert total <= 700_000, total
    assert not any("port_refuses" in MANIFEST[n] for n in MSM)
    assert MANIFEST[SINTEL]["decoded"] == 13
    assert (MANIFEST[SINTEL]["width"], MANIFEST[SINTEL]["height"]) == (1024,
                                                                       436)
    for c in CODECS:   # the writer rounds an odd size down
        assert (MANIFEST[f"msm_{c}_52x36.avi"]["width"],
                MANIFEST[f"msm_{c}_52x36.avi"]["height"]) == (52, 36)


@pytest.mark.parametrize("name", MSM)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", MSM)
def test_video_info_equals_cv2(name):
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", MSM)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """OpenCV's seek lands on a key frame at or before its target (the
    index in AVI, Matroska and QuickTime, ASF's Simple Index) and counts
    on: every recorded seek reads its own frame, the port's from the last
    key frame before it, in a capture just opened and reading on."""
    want = MANIFEST[name]
    video = vio.EncodedVideo(_path(name))
    assert want["seeks"] == {str(t): t for t in range(want["decoded"])}
    for t, hit in want["seeks"].items():
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t
        video.close()       # a capture just opened: read(t) seeks
        assert _digest(video.read(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", MSM)
def test_manifest_features_are_the_decoders(name):
    video, packets = _video(name)
    dec = video._decoder()
    for p in packets:
        dec.decode(p)
    assert dec.features == MANIFEST[name]["msmpeg4_features"]


def test_what_each_fixture_reaches_and_what_none_does():
    """Every table index and escape libavcodec writes is reached; what none
    reaches is what its encoders never write (AC prediction, slices,
    per-macroblock RL tables, WMV8 skip maps, a vector past the +-64 wrap,
    a coefficient run past the block)."""
    need = {"msm_lavc_msmpeg4_q4_52x36.avi": {
                "rl_luma_0", "rl_luma_1", "rl_luma_2", "rl_chroma_0",
                "rl_chroma_1", "rl_chroma_2", "rl_inter_0", "rl_inter_1",
                "rl_inter_2"},
            "msm_lavc_msmpeg4_edges_96x64.avi": {
                "escape_1", "escape_2", "escape_3", "dc_escape"},
            "msm_retable_div3_96x64.avi": {"dc_table_0", "mv_table_0"},
            "msm_retable_edges_96x64.avi": {"dc_table_0", "dc_escape"},
            "msm_lavc_wmv1_64k_96x64.avi": {"inter_intra"},
            "msm_lavc_wmv2_q1_52x36.avi": {"cbp_table_0", "escape_3"},
            "msm_lavc_wmv2_q12_52x36.avi": {"cbp_table_1"},
            "msm_lavc_wmv2_q31_52x36.avi": {"cbp_table_2"},
            "msm_div3_96x64.avi": {"flipflop", "ext_header", "mv_table_1",
                                   "p_pictures", "skip_code"},
            SINTEL: {"intra_mb_in_p", "mv_escape", "flipflop"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["msmpeg4_features"]), name
    reached = {f for n in MSM for f in MANIFEST[n]["msmpeg4_features"]}
    unreached = ["ac_pred", "slices", "mv_wrap", "per_mb_rl", "skip_map",
                 "overflow_ignored"]
    assert _MANIFEST["msmpeg4_unreached"] == [
        f for f in msmpeg4.FEATURES if f not in reached] == unreached


# ------------------------------------------------------------- the codes

def _table(name):
    """The values of one of msmpeg4_tables.h's arrays."""
    with open(TABLES) as f:
        src = f.read()
    body = re.search(name + r"\[\d+\] = \{(.*?)\};", src, re.S).group(1)
    return [int(x, 0) for x in re.findall(r"-?(?:0x[0-9A-Fa-f]+|\d+)", body)]


def _words(pairs):
    return [format(c, f"0{n}b") for c, n in pairs]


def _prefix_free(words):
    assert len(set(words)) == len(words)
    s = sorted(words)
    assert not any(b.startswith(a) for a, b in zip(s, s[1:]))
    return sum(2.0 ** -len(w) for w in words)


@pytest.mark.parametrize("name,n", [
    ("kMbI", 64), ("kCbp0", 128), ("kCbp1", 128), ("kCbp2", 128),
    ("kCbp3", 128), ("kDc0L", 120), ("kDc0C", 120), ("kDc1L", 120),
    ("kDc1C", 120), ("kRl0Codes", 133), ("kRl185Codes", 186),
    ("kRl1Codes", 149), ("kRl168Codes", 169), ("kInterIntra", 4),
    ("kV2IntraCbpc", 4), ("kV2MbType", 8)])
def test_code_tables_are_complete_prefix_codes(name, n):
    """The tables read out of libavcodec are prefix codes that fill their
    code space, in FFmpeg's symbol order (a VLC of the wrong order still
    reads, so the fixtures pin the order)."""
    v = _table(name)
    pairs = list(zip(v[::2], v[1::2]))
    assert len(pairs) == n
    assert all(c < 1 << l for c, l in pairs)
    assert _prefix_free(_words(pairs)) == 1.0


@pytest.mark.parametrize("t", [0, 1])
def test_mv_tables_from_lengths(t):
    """The motion-vector codes as ff_vlc_init_from_lengths assigns them:
    the lengths fill the code space in order; each symbol is an offset
    (x, y) pair in 0..63, the escape (0) once."""
    lens, syms = _table(f"kMv{t}Lens"), _table(f"kMv{t}Syms")
    assert len(lens) == len(syms) == 1100
    code, words = 0, []
    for n in lens:
        assert code % (1 << (32 - n)) == 0
        words.append(format(code >> (32 - n), f"0{n}b"))
        code += 1 << (32 - n)
    assert code == 1 << 32
    assert _prefix_free(words) == 1.0
    assert syms.count(0) == 1 and len(set(syms)) == 1100
    assert all(s >> 8 < 64 and s & 0xFF < 64 for s in syms)


@pytest.mark.parametrize("name,n,last", [("kRl0", 132, 85),
                                         ("kRl185", 185, 119),
                                         ("kRl1", 148, 81),
                                         ("kRl168", 168, 99)])
def test_run_level_tables(name, n, last):
    """Each code's run and level: by run, levels 1, 2, ...; the codes that
    end a block from ``last`` on."""
    run, level = _table(f"{name}Run"), _table(f"{name}Level")
    assert len(run) == len(level) == n
    assert f"inline constexpr int {name}Last = {last};" in open(TABLES).read()
    for lo, hi in ((0, last), (last, n)):
        for i in range(lo, hi):
            same = i > lo and run[i] == run[i - 1]
            assert level[i] == (level[i - 1] + 1 if same else 1), i
            assert i == lo or run[i] >= run[i - 1]


def test_scans_and_dc_scales():
    for k in range(4):
        assert sorted(_table(f"kWmv1Scan{k}")) == list(range(64))
    for name in ("kOldYDcScale", "kWmv1CDcScale", "kWmv1YDcScale"):
        v = _table(name)
        assert len(v) == 32 and v[1:5] == [8] * 4
        assert all(a <= b for a, b in zip(v[1:], v[2:]))


# ------------------------------------------------------------- refusals

def _set_bit(data, bit, value):
    b = bytearray(data)
    mask = 0x80 >> (bit & 7)
    b[bit >> 3] = b[bit >> 3] | mask if value else b[bit >> 3] & ~mask
    return bytes(b)


def test_wmv8_tools_libavcodec_never_writes_raise_naming_item_8():
    """libavcodec's wmv2 encoder sets J-pictures, mspel and ABT on in its
    extradata and never uses them: a picture that does (its header bits
    rewritten), or extradata with the loop filter or the top-left vector
    flag, raises Unsupported."""
    video, packets = _video("msm_wmv2_96x64.avi")
    ext = video.box.dsi
    # mspel, no loop filter, ABT, J-pictures, no top-left flag, RL per MB
    assert len(ext) == 4 and ext[2] >> 2 == 0b101101
    # I-picture: type, 7 bits, quantiser, then the J-type bit
    i_pic = _set_bit(packets[0], 13, 1)
    # P-picture: type, quantiser, skip type (2), cbp index (1), mspel,
    # per-macroblock ABT (inverted), ABT type
    p = packets[1]
    assert not p[0] >> 7 == 0
    cases = [(i_pic, "J-pictures"),
             (_set_bit(p, 9, 1), "mspel"),
             (_set_bit(p, 10, 0), "ABT block types chosen per macroblock"),
             (_set_bit(_set_bit(p, 11, 1), 12, 0), "ABT blocks other")]
    for data, what in cases:
        dec = msmpeg4.Decoder("wmv2", 96, 64, ext)
        if data is not i_pic:
            dec.decode(packets[0])
        with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
            dec.decode(data)
    for bit, what in ((17, "loop filter"), (20, "top-left")):
        with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
            msmpeg4.Decoder("wmv2", 96, 64, _set_bit(ext, bit, 1))
    with pytest.raises(ValueError, match="extradata of 2 bytes"):
        msmpeg4.Decoder("wmv2", 96, 64, ext[:2])


def test_v1_fourccs_raise_naming_item_8():
    for tag in ("MPG4", "MP41"):
        with pytest.raises(Unsupported, match=f"MS-MPEG4 v1.*{ITEM_8}"):
            codec_of(tag, "x.avi")


def test_damaged_packets_raise_value_error_and_never_crash():
    for name in ("msm_lavc_msmpeg4_q4_52x36.avi", "msm_lavc_wmv2_q4_52x36.avi",
                 "msm_lavc_msmpeg4v2_q4_52x36.avi"):
        video, packets = _video(name)
        with pytest.raises(ValueError, match="corrupt"):
            video._decoder().decode(packets[0][:3])
        with pytest.raises(ValueError, match="without a reference"):
            video._decoder().decode(packets[1])
        rng = np.random.default_rng(5)
        for _ in range(25):
            dec = video._decoder()
            data = bytearray(packets[0])
            for _ in range(4):
                data[int(rng.integers(1, len(data)))] ^= int(
                    rng.integers(1, 256))
            try:
                dec.decode(bytes(data))
                dec.decode(packets[1])
            except ValueError:
                pass


# ------------------------------------------------------------- containers

def test_fourccs_name_each_codec():
    """riff.c's tags of the four codecs, any case (each read by cv2 under
    its own name on a rewritten fixture when the table was drawn up)."""
    for tag, codec in MSMPEG4_TAGS.items():
        assert codec_of(tag, "x.avi") == codec_of(tag.lower(), "x") == codec
    assert {c for c in MSMPEG4_TAGS.values()} == set(msmpeg4.VERSIONS)


def test_containers_carry_the_codec_and_extradata():
    """AVI, Matroska (V_MS/VFW/FOURCC; V_MPEG4/MS/V3 for v3), QuickTime
    (the fourcc, 3IVD for v3, WMV8's extradata in glbl) and ASF all name
    the codec; only WMV8 carries extradata, the same 4 bytes in each."""
    for c, codec in CODECS.items():
        boxes = [AviFile(_path(f"msm_{c}_96x64.avi")),
                 MkvFile(_path(f"msm_{c}_96x64.mkv")),
                 Mp4File(_path(f"msm_{c}_96x64.mov")),
                 AsfFile(_path(f"msm_{c}_96x64.wmv"))]
        for box in boxes:
            assert box.codec == codec, box
            assert box.dsi == boxes[0].dsi
            assert (box.dsi != b"") == (codec == "wmv2")
    assert Mp4File(_path("msm_div3_96x64.mov")).tag == "3IVD"
    assert MkvFile(_path("msm_div3_96x64.mkv")).tag == "DIV3"


@pytest.mark.parametrize("name", MSM)
def test_keyframes_are_the_i_pictures(name):
    video, packets = _video(name)
    keys = [i for i, p in enumerate(packets)
            if msmpeg4.is_keyframe(p, video.box.codec)]
    assert video.keyframes == keys
    assert keys[0] == 0 and all(b - a == 12 for a, b in zip(keys, keys[1:]))


def test_reading_needs_no_opencv():
    """The port reads a .wmv and a DIV3 .avi with cv2 never imported."""
    code = ("import sys\n"
            "from opticalflow_tpu_torch.io import video as vio\n"
            f"for n in ('{SINTEL}', 'msm_div3_96x64.avi'):\n"
            f"    assert len(list(vio.read_frames('{FIXTURES}/' + n))) > 0\n"
            "print('cv2' in sys.modules, 'PIL' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", [SINTEL, "msm_div3_96x64.avi",
                                  "msm_wmv2_2997_96x64.wmv",
                                  "msm_mp42_96x64.mkv", "msm_wmv1_96x64.mov"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=14, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=14, stride=2)))


@pytest.mark.parametrize("name,hw", [(SINTEL, (436, 1024)),
                                     ("msm_div3_96x64.avi", (64, 96))])
def test_jax_consecutive_frames_equal(name, hw):
    path = _path(name)
    ds = datasets.ConsecutiveFrames(path, size_hw=hw, stride=3)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=hw, stride=3)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")
