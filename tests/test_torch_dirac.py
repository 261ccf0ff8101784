"""Dirac/VC-2 (``runtime/dirac``) in ``.drc``, AVI, ASF, Matroska,
QuickTime/MP4, MPEG-TS and NUT against OpenCV's FFmpeg and the JAX
package's cv2-based readers.

Tolerance: 0 throughout.  The decoder is FFmpeg's integer arithmetic (the
interleaved exp-Golomb coefficients of each HQ slice, their
dequantisation, the inverse wavelets over 16-bit lines with the lifting
steps cv2's libavcodec runs in x86 SIMD, the last quirk of which writes
the 8 samples before a line narrower than 8) and the conversion
swscale's (BT.709 at the range the sequence header names), so every frame
equals cv2's bit for bit: on the committed fixtures (``tests/goldens/
video``, group ``dirac``: cv2's writer in each container, at an odd size
and at full width; libavcodec's ``vc2`` encoder with each wavelet, depths
1-5, slices, quantisation matrices, bit rates, full range, 4:2:2, 4:4:4,
field coding and 10 bits), through every seek cv2 makes and in the JAX
package's readers.  The library is built once for the module (g++, a few
seconds).
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

from make_video_fixtures import Lavc, Lavf
from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.asf import AsfFile
from opticalflow_tpu_torch.io.avi import AviFile, codec_of
from opticalflow_tpu_torch.io.elementary import ElementaryFile, nopts_count
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.io.mpegts import MpegTsFile
from opticalflow_tpu_torch.io.nut import NutFile
from opticalflow_tpu_torch.runtime import dirac
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
SOURCE = os.path.join(ROOT, "opticalflow_tpu_torch", "runtime", "dirac.cpp")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
DIRAC = sorted(n for n, e in MANIFEST.items() if e["group"] == "dirac")
READ = [n for n in DIRAC if "port_refuses" not in MANIFEST[n]]
SINTEL = "dirac_sintel_436x1024.nut"
FIELDS = "dirac_lavc_interlaced_64x48.avi"
TEN_BIT = "dirac_lavc_yuv420p10_64x48.avi"
# 10- and 12-bit samples with every bit used, and at an odd size
DEEP = [f"dirac_lavc_{p}_fine_64x48.avi" for p in (
    "yuv420p10", "yuv422p10", "yuv444p10", "yuv420p12")] + [
    "dirac_lavc_yuv444p10_53x37.avi"]
CONTAINERS = ("drc", "avi", "mkv", "mov", "mp4", "ts", "nut", "wmv")


@pytest.fixture(scope="module", autouse=True)
def library():
    return dirac.load()


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
    """cv2's writer in every container it writes Dirac into (25 frames),
    from a 53x37 input (cv2 writes 52x36), the full-width clip the card
    run reads; libavcodec's vc2 encoder's settings."""
    need = {f"dirac_96x64.{ext}" for ext in CONTAINERS}
    need |= {"dirac_53x37.avi", SINTEL}
    need |= {f"dirac_lavc_{t}_64x48.avi" for t in (
        "5_3", "haar", "haar_noshift", "depth1", "depth2", "depth3",
        "depth5", "qm_flat", "qm_color", "b100k", "b50m", "fullrange",
        "interlaced", "yuv422p", "yuv444p", "yuv420p10")}
    need |= {"dirac_lavc_slices64_128x128.avi", "dirac_lavc_yuv444p_53x37.avi"}
    need |= set(DEEP)
    assert need == set(DIRAC)
    assert MANIFEST[SINTEL]["decoded"] == 13
    assert (MANIFEST[SINTEL]["width"], MANIFEST[SINTEL]["height"]) == (1024,
                                                                       436)
    assert (MANIFEST["dirac_53x37.avi"]["width"],
            MANIFEST["dirac_53x37.avi"]["height"]) == (52, 36)
    for ext in CONTAINERS:
        assert MANIFEST[f"dirac_96x64.{ext}"]["decoded"] == 25, ext


@pytest.mark.parametrize("name", READ)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = _path(name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", DIRAC)
def test_video_info_equals_cv2(name):
    """fps, size and count as cv2 reports them: the raw demuxer's 25 fps
    and OpenCV's AV_NOPTS_VALUE count in a .drc, NUT's one short."""
    path = _path(name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}
    if name.endswith(".drc"):
        assert MANIFEST[name]["frames"] == nopts_count(25) \
            == -192153584101141


@pytest.mark.parametrize("name", READ)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """Each recorded seek reads its frame: exactly where FFmpeg seeks
    (AVI, QuickTime, MP4, ASF, MPEG-TS), frame 0 in a .drc (OpenCV seeks
    nowhere at its negative count), two frames on in Matroska (cv2's
    writer flags no packet a key frame, so it writes no Cues: FFmpeg's
    generic seek reads on past the first frame after the time), and none
    in NUT (FFmpeg reads on to a key frame, and there is none)."""
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
        if t != "0":        # a capture just opened reads frame 0 unsought
            video.close()
            assert _digest(video.read(int(t))) == want["sha256"][hit], t
    if name == "dirac_96x64.mkv":
        assert [want["seeks"][str(t)] for t in range(4)] == [2, 3, 3, 3]
    if name in ("dirac_96x64.drc", "dirac_53x37.avi"):
        assert set(want["seeks"].values()) == {0}


@pytest.mark.parametrize("name", READ)
def test_manifest_features_are_the_decoders(name):
    video, packets = _video(name)
    dec = video._decoder()
    for p in packets:
        dec.decode(p)
    assert dec.features == MANIFEST[name]["dirac_features"]


def test_what_each_fixture_reaches_and_what_none_does():
    """Each setting of the vc2 encoder reaches its feature; what no
    encoder here writes (prefix bytes, reference pictures, a component's
    coefficients cut short by its length) no fixture reaches."""
    need = {"dirac_96x64.avi": {"hq_pictures", "dd97", "depth4", "yuv420p",
                                "limited_range", "custom_size", "slices",
                                "size_scaler"},
            "dirac_lavc_5_3_64x48.avi": {"legall53"},
            "dirac_lavc_haar_64x48.avi": {"haar1"},
            "dirac_lavc_haar_noshift_64x48.avi": {"haar0"},
            "dirac_lavc_depth1_64x48.avi": {"depth1"},
            "dirac_lavc_depth2_64x48.avi": {"depth2"},
            "dirac_lavc_depth3_64x48.avi": {"depth3"},
            "dirac_lavc_depth5_64x48.avi": {"depth5", "custom_qm"},
            "dirac_lavc_qm_flat_64x48.avi": {"custom_qm"},
            "dirac_lavc_qm_color_64x48.avi": {"custom_qm"},
            "dirac_lavc_fullrange_64x48.avi": {"full_range"},
            "dirac_lavc_yuv422p_64x48.avi": {"yuv422p"},
            "dirac_lavc_yuv444p_64x48.avi": {"yuv444p"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["dirac_features"]), name
    reached = {f for n in READ for f in MANIFEST[n]["dirac_features"]}
    assert _MANIFEST["dirac_unreached"] == [
        f for f in dirac.FEATURES if f not in reached] == [
        "prefix_bytes", "cut_coeffs", "reference_pictures"]


# ---------------------------------------------------------------- tables

def _table(name):
    with open(SOURCE) as f:
        body = re.search(name + r"(?:\[[^\]]*\])+ = \{(.*?)\};", f.read(),
                         re.S)
    return [int(x) for x in re.findall(r"\d+", body.group(1))]


def _quant_factor(q):
    """The specification's quant_factor (13.3.2)."""
    base = 1 << q // 4
    return (4 * base, (503829 * base + 52958) // 105917,
            (665857 * base + 58854) // 117708,
            (440253 * base + 32722) // 65444)[q % 4]


def test_quantiser_tables():
    """ff_dirac_qscale_tab is the specification's quant_factor, 4 * 2^(q/4)
    rounded, so monotone; the intra offsets are half of it, rounded up,
    but for quantisers 0 and 1 (FFmpeg's table, read from cv2's
    libavcodec), and never above it."""
    qscale = _table("kQScale")
    intra = _table("kQOffsetIntra")
    assert len(qscale) == len(intra) == 116
    assert qscale == [_quant_factor(q) for q in range(116)]
    assert all(a < b for a, b in zip(qscale, qscale[1:]))
    assert all(a <= b for a, b in zip(intra, intra[1:]))
    assert intra == [1, 2] + [(qscale[q] + 1) >> 1 for q in range(2, 116)]
    assert all(o <= f for o, f in zip(intra, qscale))
    for q in range(0, 116, 4):
        assert abs(qscale[q] - 4 * 2 ** (q / 4)) < 1


def test_default_quant_matrices_and_base_formats():
    """ff_dirac_default_qmat: each wavelet's LL offset, then three per
    level, HL and LH alike; both Haars flat past the LL band (the
    no-shift one is given its depth offset by the decoder). The base video
    formats: 21, the first VGA 4:2:0 at 24000/1001 fps."""
    q = np.array(_table("kDefaultQmat")).reshape(7, 4, 4)
    assert (q[:, 1:, 0] == 0).all() and (q[:, :, 1] == q[:, :, 2]).all()
    assert (q[3] == q[4]).all() and set(q[3, 1:, 1:].ravel()) == {0, 4}
    assert (q[0] == q[2]).all()
    formats = np.array(_table("kBaseFormats")).reshape(21, 7)
    assert list(formats[0]) == [640, 480, 2, 0, 1, 1, 0]
    assert (formats[:, 2] <= 2).all() and (formats[:, 4] <= 10).all()


# ---------------------------------------------------------------- wavelets

def _at(a, i):
    return a[min(max(i, 0), len(a) - 1)]


def _analyse(s, wavelet, shift):
    """One level of the forward transform of a line: (low, high), the
    lifting steps the inverse undoes in reverse, the samples scaled by
    ``shift`` bits first (the inverse's horizontal steps round one bit
    off, but Haar's without shift)."""
    e = [int(v) << shift for v in s[0::2]]
    o = [int(v) << shift for v in s[1::2]]
    n = len(e)
    if wavelet in ("haar0", "haar1"):
        hi = [b - a for a, b in zip(e, o)]
        return [a + ((h + 1) >> 1) for a, h in zip(e, hi)], hi
    if wavelet == "dd97":
        hi = [o[x] - ((-_at(e, x - 1) + 9 * e[x] + 9 * _at(e, x + 1)
                       - _at(e, x + 2) + 8) >> 4) for x in range(n)]
    else:
        hi = [o[x] - ((e[x] + _at(e, x + 1) + 1) >> 1) for x in range(n)]
    return [e[x] + ((_at(hi, x - 1) + hi[x] + 2) >> 2) for x in range(n)], hi


def forward(img, wavelet, depth):
    """The forward transform, laid out as the decoder lays its
    coefficients: at each level every line's low half before its high
    half, then the low lines on the even lines of the level's grid."""
    c = img.astype(np.int64).copy()
    h, w = c.shape
    shift = 0 if wavelet == "haar0" else 1
    for lvl in range(depth):
        wl, step = w >> lvl, 1 << lvl
        for r in range(0, h, step):
            lo, hi = _analyse(c[r, :wl], wavelet, shift)
            c[r, :wl] = lo + hi
        for x in range(wl):
            lo, hi = _analyse(c[::step, x], wavelet, 0)
            col = np.empty(len(lo) * 2, np.int64)
            col[0::2], col[1::2] = lo, hi
            c[::step, x] = col
    return c


@pytest.mark.parametrize("wavelet", sorted(dirac.WAVELETS))
@pytest.mark.parametrize("h,w,depth", [(64, 64, 3), (32, 128, 2),
                                       (128, 64, 4), (64, 256, 5)])
def test_inverse_wavelets_undo_a_forward_transform(wavelet, h, w, depth):
    img = np.random.default_rng(depth).integers(-128, 128, (h, w))
    coeffs = forward(img, wavelet, depth)
    assert np.abs(coeffs).max() < 1 << 15
    np.testing.assert_array_equal(
        dirac.idwt(coeffs.astype(np.int16), wavelet, depth), img)


@pytest.mark.parametrize("wavelet", sorted(dirac.WAVELETS))
def test_a_line_narrower_than_8_changes_the_8_samples_before_it(wavelet):
    """libavcodec's SSE2 vertical steps test their count after each 8
    samples: a line of 4 (a 32-wide plane's coarsest at depth 4) is run
    over the 8 samples before it, the end of the finer lines above it, as
    cv2's decoder runs it (the fixtures' 4:2:0 chroma planes are such);
    only the right half of the picture, where those samples compose to,
    and the few columns the filters reach across from it, change."""
    img = np.random.default_rng(4).integers(-128, 128, (64, 32))
    back = dirac.idwt(forward(img, wavelet, 4).astype(np.int16), wavelet, 4)
    diff = np.argwhere(back != img)
    assert len(diff) and (diff[:, 1] >= 12).all()


# ------------------------------------------------------------- refusals

class _Bits:
    def __init__(self, data, pos=0):
        self.data, self.pos = data, pos * 8

    def bit(self):
        b = self.data[self.pos >> 3] >> (7 - (self.pos & 7)) & 1
        self.pos += 1
        return b

    def ue(self):
        v = 1
        while not self.bit():
            v = v << 1 | self.bit()
        return v - 1


def _ue_bits(v):
    """The interleaved exp-Golomb code of ``v``: its bits after the
    leading one of v + 1, each after a 0, then a 1."""
    return "".join("0" + b for b in bin(v + 1)[3:]) + "1"


def _bits_of(data):
    return "".join(f"{x:08b}" for x in data)


def _to_bytes(bits):
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def _rewrite(packet, code=None, field=None, value=None):
    """A packet with its picture unit's parse code set to ``code``, or
    with ``value`` for the sequence header's first exp-Golomb value
    (``field`` 0: the major version) or the picture's wavelet index
    (``field`` 1); the unit's size follows its new length."""
    pic = dirac.split_units(packet)[1][0]
    if code is not None:
        return packet[:pic + 4] + bytes((code,)) + packet[pic + 5:]
    at = packet.find(b"BBCD\x00") if field == 0 else pic
    size = int.from_bytes(packet[at + 5:at + 9], "big")
    body = packet[at + 13:at + size]
    bits, b = _bits_of(body), _Bits(body)
    if field == 0:
        b.ue()
        new = _to_bytes(_ue_bits(value) + bits[b.pos:])
    else:
        b.pos = 32                          # past the picture number
        b.ue()
        after = b.pos
        depth = b.ue()
        for _ in range(4):                  # slices x and y, prefix, scaler
            b.ue()
        if b.bit():                         # a custom quantisation matrix
            for _ in range(1 + 3 * depth):
                b.ue()
        new = (_to_bytes(bits[:32] + _ue_bits(value) + bits[after:b.pos])
               + body[(b.pos + 7) // 8:])
    unit = (packet[at:at + 5] + (len(new) + 13).to_bytes(4, "big")
            + packet[at + 9:at + 13] + new)
    return packet[:at] + unit + packet[at + size:]


def test_rewriting_a_header_keeps_the_stream():
    """The rewriter, asked for the values the packet holds (major version
    2, wavelet 0), writes the packet back as it was, so the refusals
    below rest on the one value each changes."""
    _, packets = _video("dirac_96x64.avi")
    p = packets[0]
    assert _rewrite(p, field=0, value=2) == p
    assert _rewrite(p, field=1, value=0) == p


@pytest.mark.parametrize("what,kw", [
    ("core-syntax pictures", dict(code=0x0C)),
    ("core-syntax pictures", dict(code=0x08)),
    ("low-delay pictures", dict(code=0xC8)),
    ("Deslauriers-Dubuc \\(13,7\\) wavelet", dict(field=1, value=2)),
    ("Fidelity wavelet", dict(field=1, value=5)),
    ("Daubechies \\(9,7\\) wavelet", dict(field=1, value=6)),
    ("major version 3", dict(field=0, value=3))])
def test_what_no_encoder_here_writes_raises_naming_item_8(what, kw):
    _, packets = _video("dirac_96x64.avi")
    with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
        dirac.Decoder().decode(_rewrite(packets[0], **kw))


def test_ten_bit_samples_raise_naming_item_8_where_cv2_decodes_them():
    """10-bit samples, which cv2 decodes and the port once refused, decode
    into 16-bit planes and convert to cv2's frames: the manifest records
    no refusal, every frame equals cv2's digest."""
    assert MANIFEST[TEN_BIT]["decoded"] == 4
    assert "port_refuses" not in MANIFEST[TEN_BIT]
    assert dirac.sequence_info(_video(TEN_BIT)[1][0]).bit_depth == 10
    dec = dirac.Decoder()
    planes = dec.decode(_video(TEN_BIT)[1][0])
    assert dec.bits == 10 and all(p.dtype == np.uint16 for p in planes)
    assert "10bit" in MANIFEST[TEN_BIT]["dirac_features"]
    assert [hashlib.sha256(f.tobytes()).hexdigest()
            for f in vio.read_frames(_path(TEN_BIT))] == \
        MANIFEST[TEN_BIT]["sha256"]


@pytest.mark.parametrize("name", DEEP + [TEN_BIT])
def test_deep_samples_equal_libavcodecs_planes(name):
    """Tolerance 0: each 10- or 12-bit picture's planes equal those cv2's
    bundled libavcodec's dirac decoder hands over (ctypes, ``Lavc.decode``),
    samples below 1 << bits; the frames then equal cv2's (above)."""
    _, packets = _video(name)
    dec = dirac.Decoder()
    mine = [dec.decode(p) for p in packets]
    ref = Lavc().decode(packets, "dirac", dec.shifts, np.uint16)
    assert len(ref) == len(mine) == MANIFEST[name]["decoded"]
    for got, want in zip(mine, ref):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert int(a.max()) < 1 << dec.bits


def test_field_coding_is_refused_as_ffmpeg_refuses_it():
    """libavcodec's encoder writes picture coding mode 1 with
    ``field_order``; FFmpeg's decoder refuses it and cv2 reads no frame;
    the port raises ValueError (its size and count read as cv2's)."""
    assert MANIFEST[FIELDS]["decoded"] == 0
    assert dirac.sequence_info(_video(FIELDS)[1][0]).fields
    with pytest.raises(ValueError, match="field coding"):
        list(vio.read_frames(_path(FIELDS)))


def test_damaged_packets_raise_value_error_and_never_crash():
    """A packet cut short hands over no picture (FFmpeg passes over a
    parse unit longer than what is left of its packet); a sequence header
    cut short raises; bytes flipped anywhere decode or raise ValueError."""
    for name in ("dirac_96x64.avi", "dirac_lavc_haar_64x48.avi",
                 "dirac_lavc_yuv444p_53x37.avi"):
        video, packets = _video(name)
        assert video._decoder().decode(packets[0][:200]) is None
        with pytest.raises(ValueError, match="corrupt"):
            video._decoder().decode(packets[0][:18] + b"\0" * 13)
        rng = np.random.default_rng(11)
        for _ in range(20):
            dec = video._decoder()
            for p in packets[:3]:
                data = bytearray(p)
                for _ in range(3):
                    data[int(rng.integers(0, len(data)))] ^= int(
                        rng.integers(1, 256))
                try:
                    dec.decode(bytes(data))
                except ValueError:
                    pass


def test_a_packet_without_a_picture_hands_over_none():
    """An end of sequence alone (the last packet FFmpeg's parser cuts from
    a .drc) decodes to no picture."""
    end = b"BBCD\x10" + (13).to_bytes(4, "big") + bytes(4)
    assert dirac.Decoder().decode(end * 2) is None


# ------------------------------------------------------------- containers

def test_containers_carry_the_codec():
    """drac in AVI and ASF (any case), V_DIRAC in Matroska, the drac entry
    in QuickTime and MP4, stream type 0xD1 in a transport stream, NUT's
    fourcc and the .drc extension all name the codec."""
    assert codec_of("drac", "x.avi") == codec_of("DRAC", "x") == "dirac"
    for box in (AviFile(_path("dirac_96x64.avi")),
                MkvFile(_path("dirac_96x64.mkv")),
                Mp4File(_path("dirac_96x64.mov")),
                Mp4File(_path("dirac_96x64.mp4")),
                AsfFile(_path("dirac_96x64.wmv")),
                NutFile(_path("dirac_96x64.nut")),
                MpegTsFile(_path("dirac_96x64.ts")),
                ElementaryFile(_path("dirac_96x64.drc"))):
        assert box.codec == "dirac", box
        assert box.dsi == b""


@pytest.mark.parametrize("ext", CONTAINERS)
def test_every_picture_is_intra_whatever_the_containers_flags(ext):
    """Every packet holds one intra picture; AVI and QuickTime flag each a
    key frame, NUT and Matroska none (cv2's writer gets no key flag from
    the vc2 encoder), which only FFmpeg's seeks see."""
    video, packets = _video(f"dirac_96x64.{ext}")
    assert all(dirac.is_keyframe(p) for p in packets)
    if ext in ("avi", "mov", "mp4"):
        assert video.keyframes == list(range(25))
    if ext == "nut":
        assert not any(video.box.keys)
    if ext == "mkv":
        assert not video.box.indexed


@pytest.mark.parametrize("ext", ("drc", "ts"))
def test_parse_units_split_as_ffmpegs_parser_splits_them(ext):
    """A .drc or a transport stream's payload cut at parse units: each
    sample is the packet FFmpeg's dirac parser hands over (a sequence
    header, the encoder's name, a picture) with the end of sequence after
    it, which the decoder does not reach (a unit in the packet's last 13
    bytes); the parser's last packet, that end alone, makes no sample."""
    video, samples = _video(f"dirac_96x64.{ext}")
    want = Lavf().packets(_path(f"dirac_96x64.{ext}"))
    assert len(want) == len(samples) + 1
    end = want[-1][0]
    assert end[:5] == b"BBCD\x10" and len(end) == 13
    for s, (p, _, _) in zip(samples, want):
        assert s[:len(p)] == p and len(s) == len(p) + 13
        assert s[len(p):len(p) + 5] == b"BBCD\x10"


# ---------------------------------------------------- without OpenCV

def test_reading_needs_no_opencv():
    code = ("import sys\n"
            "from opticalflow_tpu_torch.io import video as vio\n"
            "for n in ('dirac_96x64.ts', 'dirac_96x64.drc'):\n"
            f"    assert len(list(vio.read_frames('{FIXTURES}/' + n))) > 0\n"
            "print('cv2' in sys.modules, 'PIL' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", [SINTEL, "dirac_96x64.mkv",
                                  "dirac_96x64.drc", "dirac_96x64.ts",
                                  "dirac_lavc_yuv422p_64x48.avi"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = _path(name)
    _same(list(vio.read_frames(path, max_frames=14, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=14, stride=2)))


@pytest.mark.parametrize("name,hw,stride", [
    (SINTEL, (436, 1024), 1), ("dirac_96x64.avi", (64, 96), 3),
    ("dirac_96x64.mkv", (64, 96), 3)])
def test_jax_consecutive_frames_equal(name, hw, stride):
    """Pairs read in order (stride 1: no seek) or by seeking, equal."""
    path = _path(name)
    ds = datasets.ConsecutiveFrames(path, size_hw=hw, stride=stride)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=hw, stride=stride)
    assert ds.index == jds.index
    for i in range(len(ds.index)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_jax_consecutive_frames_fail_alike_where_a_seek_reads_nothing():
    """At stride 3 the second frame read seeks: in a Dirac NUT neither
    cv2's read nor the port's finds a frame after it."""
    path = _path("dirac_96x64.nut")
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=3)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=3)
    with pytest.raises(RuntimeError, match="failed to read frame 3"):
        jds[0]
    with pytest.raises(ValueError, match="seek to frame 3 reads no frame"):
        ds[0]


@pytest.mark.parametrize("name,frame,message", [
    ("dirac_96x64.nut", 5, "failed to decode frame 5"),
    ("dirac_96x64.drc", 3, "frame 3 out of range"),
    ("dirac_96x64.mkv", 1, None)])
def test_capture_frame_agrees_with_jax(tmp_path, capsys, name, frame,
                                       message):
    """Both CLIs fail alike after a seek in a Dirac .nut (no key frame) and
    on a .drc (OpenCV's count is negative), and write the same frame of
    Matroska's quirky seek."""
    outs, errs = [], []
    for cli, out in ((jcapture, "jax.png"), (capture_frame, "port.png")):
        out = str(tmp_path / out)
        rc = cli.main([_path(name), str(frame), out])
        errs.append(capsys.readouterr().err)
        outs.append(cv2.imread(out) if rc == 0 else None)
        assert rc == (1 if message else 0)
    if message:
        assert all(e.startswith(f"error: {message}") for e in errs), errs
    else:
        np.testing.assert_array_equal(*outs)
