"""JPEG 2000 (``runtime/jpeg2000``) in AVI, Matroska, QuickTime, MP4, NUT
and ASF against OpenCV's FFmpeg and the JAX package's cv2-based readers.

Tolerance: 0 throughout.  The decoder is FFmpeg's (the JP2 boxes and
codestream markers, the packets of the five progression orders, the MQ
decoder and tier 1, the dequantisation at FFmpeg's step sizes, the float
9/7 wavelet operation for operation without contraction, the integer 5/3,
the ICT as cv2's libavcodec runs it with FMA3, the level shift with
lrintf's rounding) and the conversion swscale's, so every frame equals
cv2's bit for bit: on the committed fixtures (``tests/goldens/video``,
group ``jpeg2000``: cv2's writer in each container at 96x64 and from a
53x37 input, 5 frames at 436x1024; libavcodec's ``jpeg2000`` encoder with
the 5/3, each progression order, tiles, SOP/EPH, layers, bare codestreams
and its pixel formats; crafted codestreams for the ICT, the RCT, POC,
COC/QCC and tile-parts), through every seek cv2 makes, in the JAX
package's readers and in the video CLIs.  Each picture's planes also
equal those libavcodec's decoder hands over, before colour.  The library
is built once for the module (g++, a few seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from make_video_fixtures import (J2K_DEEP, Lavc, j2k_segments,
                                 j2k_tile_parts, j2k_with, lossless_avi,
                                 moving_clip)
from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame, extract_video
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.asf import AsfFile
from opticalflow_tpu_torch.io.avi import AviFile, codec_of
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.io.nut import NutFile
from opticalflow_tpu_torch.runtime import jpeg2000
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
J2K = sorted(n for n, e in MANIFEST.items() if e["group"] == "jpeg2000")
SINTEL = "j2k_sintel_436x1024.avi"
CONTAINERS = ("avi", "mkv", "mov", "mp4", "nut", "wmv")
LAVC = [n for n in J2K if n.startswith(("j2k_lavc_", "j2k_craft_"))]


@pytest.fixture(scope="module", autouse=True)
def library():
    return jpeg2000.load()


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

def test_fixtures_cover_what_cv2_writes_and_the_encoders_settings():
    """cv2's writer in every container it writes JPEG 2000 into (12 frames
    at 96x64; 6 from a 53x37 input, which it writes 52x36), the
    full-width clip the card run reads (5 frames, under 1.5 MB); the
    encoder's settings and the crafted codestreams."""
    need = {f"j2k_{s}.{ext}" for s in ("96x64", "53x37")
            for ext in CONTAINERS}
    need |= {SINTEL, "j2k_lavc_tiles53_53x37.avi", "j2k_lavc_444j2k_53x37.avi"}
    need |= {f"j2k_lavc_{t}_96x64.avi" for t in (
        "dwt53", "rlcp", "rpcl", "pcrl", "cprl", "tiles", "sop_eph",
        "layers", "codestream", "rgb24", "yuv444p", "yuv422p", "yuv410p",
        "yuv411p", "yuv440p", "gray", "gray53", "rgba", "yuva420p",
        "yuva422p", "yuva444p", "yuva444p_j2k")}
    need |= {f"j2k_lavc_{p}{'_j2k' if w == 'j2k' else ''}_96x64.avi"
             for p, w in J2K_DEEP}
    need |= {f"j2k_craft_{t}_96x64.avi" for t in (
        "ict", "rct", "poc_coc_qcc", "tile_parts")}
    assert need == set(J2K)
    for ext in CONTAINERS:
        assert MANIFEST[f"j2k_96x64.{ext}"]["decoded"] == 12, ext
        assert (MANIFEST[f"j2k_53x37.{ext}"]["width"],
                MANIFEST[f"j2k_53x37.{ext}"]["height"]) == (52, 36)
    assert MANIFEST[SINTEL]["decoded"] == 5
    assert (MANIFEST[SINTEL]["width"], MANIFEST[SINTEL]["height"]) == (1024,
                                                                       436)
    assert os.path.getsize(_path(SINTEL)) < 1_500_000
    assert not [n for n in J2K if "port_refuses" in MANIFEST[n]]


@pytest.mark.parametrize("name", J2K)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", J2K)
def test_video_info_equals_cv2(name):
    """fps, size and count as cv2 reports them (NUT's one short)."""
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", J2K)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """Every frame is a key frame, so each seek cv2 makes reads its frame
    (NUT's and Matroska's where FFmpeg's seek lands), through ``frame``
    and through ``read`` after a close."""
    want = MANIFEST[name]
    video = vio.EncodedVideo(_path(name))
    assert sorted(want["seeks"], key=int) == [
        str(t) for t in range(want["decoded"])]
    for t, hit in want["seeks"].items():
        if hit is None:
            with pytest.raises(ValueError, match="reads no frame"):
                video.frame(int(t))
            continue
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t
        if t != "0":
            video.close()
            assert _digest(video.read(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", J2K)
def test_manifest_features_are_the_decoders(name):
    video, packets = _video(name)
    dec = video._decoder()
    for p in packets:
        dec.decode(p)
    assert dec.features == MANIFEST[name]["jpeg2000_features"]


def test_what_each_fixture_reaches_and_what_none_does():
    """The fixtures reach the JP2 wrapper and bare codestreams, each colr
    colour space, every pixel format the encoder lists (9 to 16 bits,
    alpha planes and palettes among them), both wavelets and both component
    transforms, the five progression orders, tiles and tile-parts, SOP and
    EPH, layers, POC, COC and QCC; the manifest lists what none reaches:
    precinct partitions, derived quantisation, and the code-block styles
    (no encoder here sets one)."""
    reached = {f for n in J2K for f in MANIFEST[n]["jpeg2000_features"]}
    assert reached | set(_MANIFEST["jpeg2000_unreached"]) == set(
        jpeg2000.FEATURES)
    assert not reached & set(_MANIFEST["jpeg2000_unreached"])
    assert _MANIFEST["jpeg2000_unreached"] == [
        "precincts", "qsty_derived", "bypass", "reset", "termall", "vsc",
        "predterm", "segsym"]
    by = {n: set(MANIFEST[n]["jpeg2000_features"]) for n in J2K}
    assert {"ict", "rgb24"} <= by["j2k_craft_ict_96x64.avi"]
    assert {"rct", "dwt53"} <= by["j2k_craft_rct_96x64.avi"]
    assert {"poc", "coc", "qcc", "rlcp", "layers"} <= \
        by["j2k_craft_poc_coc_qcc_96x64.avi"]
    assert {"tile_parts", "tiles", "sop"} <= \
        by["j2k_craft_tile_parts_96x64.avi"]
    assert {"jp2", "colr_sycc", "yuv420p", "dwt97", "lrcp"} <= \
        by["j2k_96x64.avi"]


@pytest.mark.parametrize("name", LAVC)
def test_planes_equal_libavcodecs(name):
    """Tolerance 0: each picture's planes (rgb24 packed) equal those cv2's
    bundled libavcodec's jpeg2000 decoder hands over (ctypes,
    ``Lavc.decode``), before swscale."""
    video, packets = _video(name)
    dec = video._decoder()
    mine = [dec.decode(p) for p in packets]
    assert len(mine) == MANIFEST[name]["decoded"]
    if dec.layout in ("rgb48", "rgba64", "rgba", "pal8", "ya8", "ya16"):
        # handed over converted (or alpha dropped): compare the port's
        # packed samples, before it converts them, with libavcodec's one
        # plane
        mine = [_packed(p) for p in packets]
    if not dec.layout.startswith("yuv"):
        _first_plane_equal(packets, [
            f[..., ::-1].reshape(f.shape[0], -1) if isinstance(f, np.ndarray)
            and dec.layout == "rgb24" else f if isinstance(f, np.ndarray)
            else f[0].view(np.uint8) for f in mine])
        return
    ref = Lavc().decode(packets, "jpeg2000", dec.shifts,
                        np.uint16 if dec.bits > 8 else np.uint8)
    assert len(ref) == len(mine)
    for got, want in zip(mine, ref):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _packed(packet):
    """The decoder's one packed plane of a picture, as bytes (H, bytes),
    before ``Decoder.decode`` converts or drops what cv2's conversion
    does."""
    lib = jpeg2000.load()
    dec = jpeg2000.Decoder()
    dec.decode(packet)
    out = (jpeg2000._I64 * 5)()
    lib.j2k_dec_layout(dec._h, out)
    w, h, _, _, stored = list(out)
    comps = {"rgb": 3, "rgba": 4, "ya": 2}.get(dec.layout.rstrip(
        "0123456789"), 1)
    buf = np.empty((h, w * comps * stored // 8), np.uint8)
    lib.j2k_dec_output(dec._h, buf.ctypes.data, None, None, None)
    return buf


def _first_plane_equal(packets, mine):
    """libavcodec's packed RGB, RGBA, grey with alpha and palette frames
    are one plane, its gray8 and gray16 frames one plane: its first
    plane's rows against each (H, bytes) array."""
    lavc = Lavc()
    c, a, u = lavc.ct, lavc.a, lavc.u
    ctx = a.avcodec_alloc_context3(None)
    assert a.avcodec_open2(ctx, a.avcodec_find_decoder_by_name(b"jpeg2000"),
                           None) >= 0
    frame, pkt = u.av_frame_alloc(), a.av_packet_alloc()
    for data, got in zip(packets, mine):
        assert a.av_new_packet(pkt, len(data)) >= 0
        c.memmove(c.c_void_p.from_address(pkt + 24).value, data, len(data))
        assert a.avcodec_send_packet(ctx, pkt) >= 0
        a.av_packet_unref(pkt)
        assert a.avcodec_receive_frame(ctx, frame) == 0
        h, n = got.shape
        ptr = c.c_void_p.from_address(frame).value
        stride = c.c_int.from_address(frame + 64).value
        rows = np.stack([np.frombuffer(c.string_at(ptr + r * stride, n),
                                       np.uint8) for r in range(h)])
        np.testing.assert_array_equal(got, rows)


def test_the_decoder_keeps_its_times_by_stage():
    """``Decoder.times``: tier 1, the wavelet and the output, each counted
    up by every picture (what the card run's host timing splits)."""
    _, packets = _video(SINTEL)
    dec = jpeg2000.Decoder()
    dec.decode(packets[0])
    first = dec.times
    dec.decode(packets[1])
    assert all(b > a >= 0 for a, b in zip(first, dec.times))


# ------------------------------------------------------------- refusals

def _codestream(pix="yuv420p", **opts):
    frames = moving_clip(64, 96, 1, seed=82, speed=3.0)
    return Lavc().encode_intra(frames, "jpeg2000", pix, format="j2k",
                               **opts)[1][0][0]


def _replace_segment(cs, marker, new):
    segs, rest = j2k_segments(cs)
    return b"\xff\x4f" + b"".join(new if s[:2] == marker else s
                                  for s in segs) + rest


def _insert_after(cs, marker, seg):
    segs, rest = j2k_segments(cs)
    out = []
    for s in segs:
        out.append(s)
        if s[:2] == marker:
            out.append(seg)
    return b"\xff\x4f" + b"".join(out) + rest


def _siz(cs):
    return next(s for s in j2k_segments(cs)[0] if s[:2] == b"\xff\x51")


def _cod(cs):
    return next(s for s in j2k_segments(cs)[0] if s[:2] == b"\xff\x52")


def test_crafting_keeps_the_picture():
    """The crafts the fixtures rest on: a POC naming COD's order, COC and
    QCC repeating COD's and QCD's parameters, and tile-parts split at a
    packet give the picture of the codestream they came from."""
    cs = _codestream(layer_rates="30,10", prog="rlcp")
    want = jpeg2000.Decoder().decode(cs)
    for crafted in (j2k_with(cs, poc=True), j2k_with(cs, coc=True),
                    j2k_with(cs, qcc=True)):
        assert crafted != cs
        for a, b in zip(jpeg2000.Decoder().decode(crafted), want):
            np.testing.assert_array_equal(a, b)
    sop = _codestream(sop=1, tile_width=48, tile_height=64)
    split = j2k_tile_parts(sop)
    dec = jpeg2000.Decoder()
    for a, b in zip(dec.decode(split), jpeg2000.Decoder().decode(sop)):
        np.testing.assert_array_equal(a, b)
    assert "tile_parts" in dec.features


def _cv2_reads_none(tmp_path, packet, w=96, h=64):
    path = str(tmp_path / "damaged.avi")
    lossless_avi(path, [packet], w, h, "MJ2C")
    return _cv2_frames(path) == []


def test_a_cut_tile_part_raises_as_ffmpeg_refuses_it(tmp_path):
    """A tile-part whose Psot runs past the packet (the packet cut inside
    its data): FFmpeg refuses the picture (cv2 reads no frame), the port
    raises ValueError."""
    cs = _codestream()
    cut = cs[:len(cs) // 2]
    assert _cv2_reads_none(tmp_path, cut)
    with pytest.raises(ValueError, match="Psot runs past the data"):
        jpeg2000.Decoder().decode(cut)


def test_a_bad_marker_length_raises_as_ffmpeg_refuses_it(tmp_path):
    """A main-header marker segment whose length runs past the data ends
    FFmpeg's header reading (its "Missing EOC Marker"), so no tile gets a
    coding style: cv2 reads no frame, the port raises ValueError; a
    length shorter than the segment's fields fails the segment."""
    cs = _codestream()
    segs, rest = j2k_segments(cs)
    com = next(s for s in segs if s[:2] == b"\xff\x64")
    long_com = com[:2] + (len(cs)).to_bytes(2, "big") + com[4:]
    damaged = _replace_segment(cs, b"\xff\x64", long_com)
    assert _cv2_reads_none(tmp_path, damaged)
    with pytest.raises(ValueError, match="without a coding style"):
        jpeg2000.Decoder().decode(damaged)
    cod = _cod(cs)
    short = _replace_segment(cs, b"\xff\x52", cod[:2] + b"\x00\x05"
                             + cod[4:])
    assert _cv2_reads_none(tmp_path, short)
    with pytest.raises(ValueError):
        jpeg2000.Decoder().decode(short)


def test_damaged_codestreams_raise_value_error_and_never_crash():
    """Bytes flipped anywhere in a codestream decode or raise ValueError
    (Unsupported where the damage names what no encoder here writes)."""
    cs = _codestream(pred="dwt53", tile_width=32, tile_height=32)
    rng = np.random.default_rng(12)
    for _ in range(60):
        data = bytearray(cs)
        for _ in range(4):
            data[int(rng.integers(0, len(data)))] ^= int(rng.integers(1, 256))
        try:
            jpeg2000.Decoder().decode(bytes(data))
        except ValueError:
            pass
    with pytest.raises(ValueError):
        jpeg2000.Decoder().decode(b"\xff\x4f\xff")
    with pytest.raises(ValueError, match="SOC marker not present"):
        jpeg2000.Decoder().decode(b"\x00" * 64)


def test_damaged_sop_streams_fail_where_ffmpeg_fails():
    """libavcodec's encoder with SOP markers writes pictures after a
    stream's first that its own decoder fails on (another frame's damage
    with EPH too); the port fails on the same ones, the same way:
    ValueError where FFmpeg's is INVALIDDATA (cv2 passes over the frame),
    Unsupported where it is PATCHWELCOME (too many passes), and an EPH
    after an empty packet's header skipped, as FFmpeg skips it."""
    frames = moving_clip(64, 96, 3, seed=80, speed=3.0)
    for opts, want in (({"sop": 1, "eph": 1}, [None, ValueError, Unsupported]),
                       ({"sop": 1}, [None, None, Unsupported])):
        packets = [p for p, _ in Lavc().encode_intra(
            frames, "jpeg2000", "yuv420p", format="j2k", **opts)[1]]
        dec = jpeg2000.Decoder()
        for p, kind in zip(packets, want):
            if kind is None:
                dec.decode(p)
            else:
                with pytest.raises(kind):
                    dec.decode(p)


def _with_siz_byte(cs, at, value):
    siz = bytearray(_siz(cs))
    siz[at] = value
    return _replace_segment(cs, b"\xff\x51", bytes(siz))


@pytest.mark.parametrize("what,craft", [
    ("Digital Cinema", lambda cs: _with_siz_byte(cs, 5, 3)),
    ("image offsets", lambda cs: _with_siz_byte(cs, 17, 1)),
    ("High-Throughput", lambda cs: _replace_segment(
        cs, b"\xff\x52", _cod(cs)[:12] + b"\x40" + _cod(cs)[13:])),
    ("region of interest", lambda cs: _insert_after(
        cs, b"\xff\x5c", b"\xff\x5e\x00\x05\x00\x00\x02")),
    ("packed packet headers", lambda cs: _insert_after(
        cs, b"\xff\x5c", b"\xff\x60\x00\x03\x00")),
])
def test_what_no_encoder_here_writes_raises_naming_item_8(what, craft):
    with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
        jpeg2000.Decoder().decode(craft(_codestream()))


def test_probe_reads_the_size_through_the_jp2_boxes():
    _, packets = _video("j2k_96x64.avi")
    assert packets[0][4:8] == b"jP  "
    assert jpeg2000.probe(packets[0]) == (96, 64)
    assert jpeg2000.probe(_codestream()) == (96, 64)
    assert jpeg2000.probe(b"\xff\x4f\xff\xd9") is None


# ------------------------------------------------------------- containers

def test_containers_carry_the_codec():
    """MJ2C, mjp2 and riff.c's other tags in AVI, Matroska
    (V_MS/VFW/FOURCC), NUT and ASF, in any case; the mjp2 entry in
    QuickTime; the mp4v entry with objectTypeIndication 0x6E in MP4."""
    for tag in ("MJ2C", "mjp2", "MJP2", "LJ2C", "LJ2K", "IPJ2", "AVj2"):
        assert codec_of(tag, "x.avi") == "jpeg2000", tag
    for box in (AviFile(_path("j2k_96x64.avi")),
                MkvFile(_path("j2k_96x64.mkv")),
                Mp4File(_path("j2k_96x64.mov")),
                Mp4File(_path("j2k_96x64.mp4")),
                AsfFile(_path("j2k_96x64.wmv")),
                NutFile(_path("j2k_96x64.nut"))):
        assert box.codec == "jpeg2000", box
    assert Mp4File(_path("j2k_96x64.mov")).tag == "mjp2"
    assert Mp4File(_path("j2k_96x64.mp4")).tag == "mp4v"


@pytest.mark.parametrize("tag", ["mjp2", "LJ2K", "ipj2"])
def test_riff_tags_read_as_cv2_reads_them(tmp_path, tag):
    """An AVI rewritten under another of riff.c's tags reads as cv2 reads
    it."""
    data = bytearray(open(_path("j2k_96x64.avi"), "rb").read())
    at = data.find(b"MJ2C", data.find(b"strf"))
    data[at:at + 4] = tag.encode()
    path = str(tmp_path / "tag.avi")
    open(path, "wb").write(bytes(data))
    _same(list(vio.read_frames(path)), _cv2_frames(path))


# ---------------------------------------------------- without OpenCV

def test_reading_needs_no_opencv():
    code = ("import sys\n"
            "from opticalflow_tpu_torch.io import video as vio\n"
            "for n in ('j2k_96x64.mp4', 'j2k_lavc_rgb24_96x64.avi'):\n"
            f"    assert len(list(vio.read_frames('{FIXTURES}/' + n))) > 0\n"
            "print('cv2' in sys.modules, 'PIL' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", [SINTEL, "j2k_96x64.mkv", "j2k_96x64.nut",
                                  "j2k_lavc_gray_96x64.avi"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=14, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=14, stride=2)))


@pytest.mark.parametrize("name,hw,stride", [
    (SINTEL, (436, 1024), 1), ("j2k_96x64.wmv", (64, 96), 3),
    ("j2k_96x64.mov", (64, 96), 2)])
def test_jax_consecutive_frames_equal(name, hw, stride):
    """Pairs read in order (stride 1: no seek) or by seeking, equal."""
    path = _path(name)
    ds = datasets.ConsecutiveFrames(path, size_hw=hw, stride=stride)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=hw, stride=stride)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_capture_frame_agrees_with_jax(tmp_path):
    """Both CLIs write the same PNG of a JPEG 2000 frame after a seek."""
    path = _path("j2k_96x64.mp4")
    outs = []
    for cli, name in ((jcapture, "jax.png"), (capture_frame, "port.png")):
        out = str(tmp_path / name)
        assert cli.main([path, "7", out]) == 0
        outs.append(cv2.imread(out))
    np.testing.assert_array_equal(*outs)


def test_extract_video_reads_cv2s_frames(tmp_path, monkeypatch):
    """The video CLI over a cv2-written JPEG 2000 .avi: the frames it reads
    are cv2.VideoCapture's, and cv2 reads its .avi output with the clip's
    count less one (one frame a pair), fps and size."""
    sys.path.insert(0, os.path.dirname(__file__))
    from oracles.torch_pwcnet import OraclePWC
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for p in net.parameters():
        p.data *= 0.5
    ckpt = str(tmp_path / "fake.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               net.state_dict_flat().items()}}, ckpt)
    src = str(tmp_path / "clip.avi")
    wr = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJ2C"), 25.0, (96, 64))
    for f in moving_clip(64, 96, 4, seed=9, speed=3.0):
        wr.write(f)
    wr.release()
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
    _same(seen, _cv2_frames(src))
    assert _cv2_info(out) == vio.video_info(out) == {
        "fps": 25.0, "width": 96, "height": 64, "frames": 3}
