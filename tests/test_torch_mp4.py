"""The port's MPEG-4 Part 2 video path (``runtime/mpeg4``, ``io/mp4``,
``io/avi``, ``io/video``) against OpenCV's FFmpeg (``cv2.VideoCapture``,
``cv2.VideoWriter``) and the JAX package's cv2-based readers.

Tolerance: 0 throughout.  The decoder follows FFmpeg's simple IDCT, its
edge and 4MV clipping rules and its x86 half-pel averages, and the colour
conversion swscale's x86 yuv2rgb, so every frame equals cv2's bit for bit:
on the committed fixtures (``tests/goldens/video``, whose manifest the GPU
machine checks without cv2), on files the port's encoder writes with every
coding tool it has, and through seeking; at odd heights, which swscale
converts through its scaler from MPEG-4's left-sited chroma
(``mpeg4_176x143.mp4``, ``mpeg4_175x143.mp4``).  The encoder is held to cv2's
``mp4v`` writer on a 720p clip by PSNR and bytes, measured side by side.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest

from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.avi import AviFile
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.io.mp4 import Mp4File, Mp4Writer
from opticalflow_tpu_torch.io.yuv import i420_planes, rgb_to_i420
from opticalflow_tpu_torch.runtime import mpeg4
from make_video_fixtures import moving_clip, zero_planes

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
# the MP4 and AVI fixtures, and the VP9 ones the port reads (VP8 and
# Matroska: test_torch_vp8.py and test_torch_mkv.py; VP9's own checks and
# refusals: test_torch_vp9.py; MPEG-1/2, whose seeks have cv2's quirks:
# test_torch_mpeg12.py)
DECODED = sorted(n for n in MANIFEST if n != "mjpg.avi"
                 and not n.startswith(("vp8_", "mkv_", "mpeg1_", "mpeg2_"))
                 and "port_refuses" not in MANIFEST[n])
# NUT and Dirac, where a seek of cv2's may read nothing (a NUT stream
# without a key frame, one resynced past a damaged syncpoint), and H.264
# with B pictures (cv2 reads nothing after a seek in a transport stream,
# nor past the pictures where FLV's, ASF's and NUT's counts run on): every
# seek cv2 makes is held in test_torch_nut.py, test_torch_dirac.py and
# test_torch_h264_b*.py
SOUGHT = [n for n in DECODED if not n.startswith(("nut_", "dirac_",
                                                  "h264_b_"))]
MOVING = os.path.join(FIXTURES, "moving_176x144.mp4")


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            return out
        out.append(frame)


def _cv2_seek(path, i):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, i)
    ok, frame = cap.read()
    assert ok
    return frame


def _cv2_info(path):
    cap = cv2.VideoCapture(path)
    return {"fps": cap.get(cv2.CAP_PROP_FPS),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}


def _same(a, b):
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {k}")


# ---------------------------------------------------------------- fixtures

@pytest.mark.parametrize("name", DECODED)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = os.path.join(FIXTURES, name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in got] == \
        MANIFEST[name]["sha256"]


@pytest.mark.parametrize("name", SOUGHT)
def test_fixture_info_and_seeks_equal_cv2(name):
    path = os.path.join(FIXTURES, name)
    assert vio.video_info(path) == _cv2_info(path)
    n = MANIFEST[name]["frames"]
    # frames of the second and third GOP (I-VOPs at 0, 12, 24)
    for i in sorted({min(i, n - 1) for i in (12, 13, 20, 24, 25)}):
        np.testing.assert_array_equal(vio.read_frame(path, i),
                                      _cv2_seek(path, i), err_msg=f"{i}")


def test_raw_i420_conversion_is_swscale_exact():
    """The rawvideo fixture's full-range planes (Y below 16 too) through
    the port's conversion equal cv2's frames; its planes are read from the
    file directly, so the codec plays no part."""
    path = os.path.join(FIXTURES, "raw_i420.avi")
    avi = AviFile(path)
    assert avi.codec == "i420" and avi.tag == "I420"
    with open(path, "rb") as f:
        data = [avi.sample(f, i) for i in range(avi.frames)]
    w, h = avi.width, avi.height
    for raw, want in zip(data, _cv2_frames(path)):
        a = np.frombuffer(raw, np.uint8)
        y = a[:w * h].reshape(h, w)
        u = a[w * h:w * h * 5 // 4].reshape(h // 2, w // 2)
        v = a[w * h * 5 // 4:].reshape(h // 2, w // 2)
        assert y.min() < 16 and y.max() > 235
        np.testing.assert_array_equal(mpeg4.i420_to_bgr(y, u, v), want)


def test_bgr_to_i420_is_rgb_to_i420():
    """The C conversion every I420 writer uses equals the numpy reference,
    from BGR and from RGB, and :func:`i420_planes` splits what it packs."""
    rng = np.random.default_rng(0)
    for h, w in ((2, 2), (36, 52), (144, 176)):
        bgr = rng.integers(0, 256, (h, w, 3), np.uint8)
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        want = rgb_to_i420(rgb)
        np.testing.assert_array_equal(mpeg4.to_i420(bgr), want)
        np.testing.assert_array_equal(mpeg4.to_i420(bgr[..., ::-1], "rgb"),
                                      want)
        y, u, v = i420_planes(want)
        assert y.shape == (h, w) and u.shape == v.shape == (h // 2, w // 2)
        np.testing.assert_array_equal(
            np.concatenate([y.ravel(), u.ravel(), v.ravel()]),
            want.reshape(-1))


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["moving_176x144.mp4",
                                  "moving_176x144_xvid.avi", "odd_53x37.mp4"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = os.path.join(FIXTURES, name)
    _same(list(vio.read_frames(path, max_frames=20, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=20, stride=2)))


@pytest.mark.parametrize("name", ["moving_176x144.mp4",
                                  "moving_176x144_fmp4.avi"])
def test_jax_consecutive_frames_equal(name):
    path = os.path.join(FIXTURES, name)
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    assert ds.index == jds.index
    # in order (one open decoder), then out of order (seeks)
    for i in (0, 1, 2, 3, 15, 16, 5, 23):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


@pytest.mark.parametrize("name", ["moving_176x144.mp4",
                                  "moving_176x144_xvid.avi"])
def test_jax_capture_frame_equals(name, tmp_path):
    path = os.path.join(FIXTURES, name)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "17", a]) == 0
        assert jcapture.main([path, "17", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))


# --------------------------------------------------------------- encoder

@pytest.mark.parametrize("ext", ["mp4", "avi"])
@pytest.mark.parametrize("hw", [(144, 176), (37, 53)])
def test_encoder_round_trip_through_cv2(ext, hw, tmp_path):
    """The port's writer: cv2 decodes every frame to the port decoder's
    frame and the encoder's reconstruction; I-VOPs at 0, 12, 24 in the
    index; an odd side cropped as cv2's writer crops it."""
    h, w = hw
    frames = moving_clip(h, w, 26, seed=4, speed=3.0)
    path = str(tmp_path / f"out.{ext}")
    wr = vio.Mpeg4Writer(path, 25.0, (w, h), keep_recon=True)
    for f in frames:
        wr.write(f)
    wr.release()
    ref = _cv2_frames(path)
    _same(ref, [mpeg4.i420_to_bgr(*r) for r in wr.recon])
    _same(ref, list(vio.read_frames(path)))
    box = Mp4File(path) if ext == "mp4" else AviFile(path)
    assert box.keyframes == [0, 12, 24]
    cvpath = str(tmp_path / f"cv.{ext}")
    cw = cv2.VideoWriter(cvpath, cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                         (w, h))
    for f in frames:
        cw.write(f)
    cw.release()
    assert ref[0].shape == _cv2_frames(cvpath)[0].shape == (h & ~1, w & ~1, 3)
    assert _cv2_info(path) == vio.video_info(path) == {
        "fps": 25.0, "width": w & ~1, "height": h & ~1, "frames": 26}


def _zero_iq():
    iq = np.add.outer(np.arange(8), np.arange(8)) * 2 + 8
    pq = 16 + np.add.outer(np.arange(8), 2 * np.arange(8))
    return iq, pq


TOOLS = {
    "video packets": dict(packet_rows=1),
    "4MV": dict(mv4=True),
    "rounding": dict(rounding=1),
    "dquant": dict(dquant=1, packet_rows=2),
    "no AC prediction": dict(ac_pred=False),
    "MPEG quantisation": dict(mpeg_quant=_zero_iq(), qscale=9, dquant=1),
    "quantiser 1": dict(qscale=1, mv4=True),
    "quantiser 31": dict(qscale=31),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_coding_tools_decode_as_ffmpeg_decodes(tool, tmp_path):
    """Streams with the tools FFmpeg's writer leaves off, written by the
    port's encoder: FFmpeg's decode equals the reconstruction."""
    frames = moving_clip(64, 96, 14, seed=5, speed=4.5)
    path = str(tmp_path / "t.mp4")
    enc = mpeg4.Encoder(96, 64, 25, 1, **TOOLS[tool])
    mux = Mp4Writer(path, (96, 64), (25, 1), enc.headers)
    recon = []
    for f in frames:
        mux.write(*enc.encode(*i420_planes(mpeg4.to_i420(f))))
        recon.append(mpeg4.i420_to_bgr(*enc.recon()))
    mux.release()
    ref = _cv2_frames(path)
    _same(ref, recon)
    _same(ref, list(vio.read_frames(path)))


@pytest.mark.parametrize("mv4", [False, True])
def test_no_rounding_averages_on_zero_samples(mv4, tmp_path):
    """vop_rounding_type 1 over planes that are mostly 0: FFmpeg's x86
    no-rounding averages of 8-wide blocks are pavgb approximations that
    differ from (a + b) >> 1 at 0; the decoder reproduces them."""
    planes = zero_planes(64, 96, 14)
    path = str(tmp_path / "z.mp4")
    enc = mpeg4.Encoder(96, 64, 25, 1, rounding=1, qscale=1, mv4=mv4)
    mux = Mp4Writer(path, (96, 64), (25, 1), enc.headers)
    recon = []
    for p in planes:
        mux.write(*enc.encode(*p))
        recon.append(mpeg4.i420_to_bgr(*enc.recon()))
    mux.release()
    ref = _cv2_frames(path)
    _same(ref, recon)
    _same(ref, list(vio.read_frames(path)))


def test_not_coded_vop_is_passed_over_as_cv2_does(tmp_path):
    frames = moving_clip(48, 64, 8, seed=6)
    path = str(tmp_path / "nc.mp4")
    enc = mpeg4.Encoder(64, 48, 25, 1)
    mux = Mp4Writer(path, (64, 48), (25, 1), enc.headers)
    for t, f in enumerate(frames):
        sample, key = enc.encode(*i420_planes(mpeg4.to_i420(f)))
        if t == 3:   # P-VOP, time 3, vop_coded 0, stuffing
            bits = "01" + "0" + "1" + format(t, "05b") + "1" + "0"
            bits += "0" + "1" * ((-len(bits) - 1) % 8)
            sample = b"\0\0\1\xb6" + int(bits, 2).to_bytes(len(bits) // 8,
                                                          "big")
        mux.write(sample, key)
    mux.release()
    ref = _cv2_frames(path)
    assert len(ref) == 7 and _cv2_info(path)["frames"] == 8
    _same(list(vio.read_frames(path)), ref)


def test_encoder_quality_against_cv2_at_720p(tmp_path):
    """24 frames of a moving 720x1280 clip: the port's PSNR is at most
    0.5 dB under cv2's mp4v writer's, at no more than 1.5x its bytes
    (measured here, both sides)."""
    frames = moving_clip(720, 1280, 24, seed=7, speed=6.0)

    def psnr(decoded):
        mse = np.mean([(d.astype(np.float64) - f) ** 2
                       for d, f in zip(decoded, frames)])
        return 10 * np.log10(255.0 ** 2 / mse)

    ours, theirs = str(tmp_path / "port.mp4"), str(tmp_path / "cv2.mp4")
    wr = vio.Mpeg4Writer(ours, 30.0, (1280, 720))
    cw = cv2.VideoWriter(theirs, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                         (1280, 720))
    for f in frames:
        wr.write(f)
        cw.write(f)
    wr.release()
    cw.release()
    p_ours, p_theirs = psnr(_cv2_frames(ours)), psnr(_cv2_frames(theirs))
    b_ours, b_theirs = os.path.getsize(ours), os.path.getsize(theirs)
    assert p_ours >= p_theirs - 0.5, (p_ours, p_theirs)
    assert b_ours <= 1.5 * b_theirs, (b_ours, b_theirs)


def test_fps_is_stored_as_a_rational(tmp_path):
    frames = moving_clip(32, 48, 3)
    for fps in (30000 / 1001, 12.5, 60.0):
        for ext in ("mp4", "avi"):
            path = str(tmp_path / f"r.{ext}")
            wr = vio.Mpeg4Writer(path, fps, (48, 32))
            for f in frames:
                wr.write(f)
            wr.release()
            assert _cv2_info(path)["fps"] == pytest.approx(fps, rel=1e-9)
            assert vio.video_info(path)["fps"] == pytest.approx(fps,
                                                                rel=1e-9)


# ------------------------------------------------------------- demuxers

def _rewrite_mp4(src, dst, *, moov_first, chunk, co64):
    """``src`` (one chunk, moov last) rewritten with ``chunk`` samples a
    chunk, moov before or after mdat, stco or co64."""
    box = Mp4File(src)
    with open(src, "rb") as f:
        samples = [box.sample(f, i) for i in range(box.frames)]
        f.seek(0)
        data = f.read()
    moov_at = data.rfind(b"moov") - 4
    moov = data[moov_at:]
    ftyp = data[:data.find(b"free") - 4]

    def rebuild(buf, start, end, offsets):
        out = b""
        pos = start
        while pos < end:
            n, typ = struct.unpack(">I4s", buf[pos:pos + 8])
            body = buf[pos + 8:pos + n]
            if typ in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
                body = rebuild(buf, pos + 8, pos + n, offsets)
            elif typ == b"stsc":
                body = struct.pack(">IIIII", 0, 1, 1, chunk, 1)
            elif typ == b"stco":
                typ = b"co64" if co64 else b"stco"
                fmt = "Q" if co64 else "I"
                body = struct.pack(f">II{len(offsets)}{fmt}", 0,
                                   len(offsets), *offsets)
            out += struct.pack(">I4s", 8 + len(body), typ) + body
            pos += n
        return out

    nchunks = -(-len(samples) // chunk)
    placeholder = rebuild(moov, 0, len(moov), [0] * nchunks)
    mdat_at = len(ftyp) + (len(placeholder) if moov_first else 0)
    offsets, pos = [], mdat_at + 8
    for i, s in enumerate(samples):
        if i % chunk == 0:
            offsets.append(pos)
        pos += len(s)
    moov2 = rebuild(moov, 0, len(moov), offsets)
    mdat = struct.pack(">I4s", 8 + sum(map(len, samples)), b"mdat") + \
        b"".join(samples)
    with open(dst, "wb") as f:
        f.write(ftyp + (moov2 + mdat if moov_first else mdat + moov2))


@pytest.mark.parametrize("moov_first,chunk,co64", [
    (True, 5, False), (False, 3, True), (True, 1, True)])
def test_mp4_layouts_equal_cv2(moov_first, chunk, co64, tmp_path):
    dst = str(tmp_path / "l.mp4")
    _rewrite_mp4(MOVING, dst, moov_first=moov_first, chunk=chunk, co64=co64)
    ref = _cv2_frames(dst)
    assert len(ref) == 26
    _same(list(vio.read_frames(dst)), ref)
    np.testing.assert_array_equal(vio.read_frame(dst, 19), ref[19])


# --------------------------------------------------------------- refusals

def test_other_codecs_raise_naming_item_8(tmp_path):
    """H.264 is read now (tests/test_torch_h264.py).  An ``avc1`` entry
    over MPEG-4 Part 2 samples, its esds kept, reads as cv2.VideoCapture
    reads it (the esds's objectTypeIndication names the codec, as in
    FFmpeg's mov demuxer); H.264 the port does not read (field coding, from
    the syntax writer, muxed by libavformat) raises naming ROADMAP item 8
    from every entry point; Motion JPEG in AVI, once refused, reads as
    cv2.VideoCapture reads it."""
    import h264_syntax as hs
    from make_video_fixtures import h264_write
    renamed = tmp_path / "h264.mp4"
    renamed.write_bytes(open(MOVING, "rb").read().replace(b"mp4v", b"avc1"))
    ref = _cv2_frames(str(renamed))
    assert len(ref) == 26
    _same(list(vio.read_frames(str(renamed))), ref)
    field = str(tmp_path / "field.mp4")
    h264_write(field, [hs.Sps(frame_mbs_only=False)], [hs.Pps()],
               [hs.Pic(idr=True, mb_types=("I16",))], seed=3)
    assert len(_cv2_frames(field)) == 1
    for fn in (lambda p: list(vio.read_frames(p)), vio.video_info,
               lambda p: vio.read_frame(p, 0), datasets.ConsecutiveFrames):
        with pytest.raises(mpeg4.Unsupported,
                           match="H.264.*frame_mbs_only.*Queue 1 item 8"):
            fn(field)
    mjpg = os.path.join(FIXTURES, "mjpg.avi")
    ref = _cv2_frames(mjpg)
    assert len(ref) == 2
    _same(list(vio.read_frames(mjpg)), ref)
    np.testing.assert_array_equal(vio.read_frame(mjpg, 1), ref[1])
    assert vio.video_info(mjpg)["frames"] == 2
    assert len(datasets.ConsecutiveFrames(mjpg, size_hw=(16, 24))) == 1


def test_xvid_written_streams_raise(tmp_path):
    """FFmpeg decodes streams it takes for Xvid's (XviD user data, or fourcc
    XVID without Lavc's) with its Xvid IDCT; the port refuses them."""
    path = str(tmp_path / "x.avi")
    wr = vio.Mpeg4Writer(path, 25.0, (48, 32))
    for f in moving_clip(32, 48, 3):
        wr.write(f)
    wr.release()
    data = open(path, "rb").read()
    tagged = str(tmp_path / "tagged.avi")
    open(tagged, "wb").write(data.replace(b"FMP4", b"XVID"))
    with pytest.raises(mpeg4.Unsupported, match="Xvid.*Queue 1 item 8"):
        list(vio.read_frames(tagged))
    dec = mpeg4.Decoder()
    vop = data[data.find(b"\0\0\1\xb0"):]
    with pytest.raises(mpeg4.Unsupported, match="Xvid"):
        dec.decode(b"\0\0\1\xb2XviD0050" + vop)


def test_truncated_files_raise(tmp_path):
    data = open(MOVING, "rb").read()
    for cut, match in ((len(data) - 50, "truncated"), (2000, "truncated"),
                       (36, "no moov box")):
        p = tmp_path / f"cut{cut}.mp4"
        p.write_bytes(data[:cut])
        with pytest.raises(ValueError, match=match):
            vio.video_info(str(p))
    # counts in the tables that no file could hold: refused (stsz) or cut
    # to the sample count (stts), never allocated
    stsz = data.index(b"stsz") + 8   # version/flags, sample_size, count
    for fixed in (0, 1):
        bad = bytearray(data)
        struct.pack_into(">II", bad, stsz, fixed, 0xFFFFFFF0)
        p = tmp_path / f"stsz{fixed}.mp4"
        p.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match="stsz counts"):
            vio.video_info(str(p))
    stts = data.index(b"stts") + 8   # version/flags, entries, count, delta
    bad = bytearray(data)
    struct.pack_into(">I", bad, stts + 8, 0xFFFFFFF0)
    p = tmp_path / "stts.mp4"
    p.write_bytes(bytes(bad))
    assert vio.video_info(str(p))["frames"] == 26
    avi = open(os.path.join(FIXTURES, "moving_176x144_fmp4.avi"), "rb").read()
    p = tmp_path / "cut.avi"
    p.write_bytes(avi[:len(avi) // 2])
    with pytest.raises(ValueError, match="truncated"):
        list(vio.read_frames(str(p)))
    # a VOP cut short inside its macroblocks
    box = Mp4File(MOVING)
    with open(MOVING, "rb") as f:
        vop = box.sample(f, 0)
    dec = mpeg4.Decoder(box.dsi)
    with pytest.raises(ValueError, match="corrupt MPEG-4"):
        dec.decode(vop[:len(vop) // 3])


class _Bits:
    def __init__(self):
        self.s = ""

    def put(self, n, v):
        self.s += format(v, f"0{n}b") if n else ""
        return self

    def bytes(self):
        s = self.s + "0" + "1" * ((-len(self.s) - 1) % 8)
        return int(s, 2).to_bytes(len(s) // 8, "big")


def _vol(*, interlaced=0, sprite=0, verid=1, qpel=0, shape=0, not8=0):
    """A VOL header (after its start code) with the given fields."""
    b = _Bits().put(1, 0).put(8, 1)
    if verid != 1:
        b.put(1, 1).put(4, verid).put(3, 1)
    else:
        b.put(1, 0)
    b.put(4, 1).put(1, 0).put(2, shape).put(1, 1).put(16, 25).put(1, 1)
    b.put(1, 0).put(1, 1).put(13, 64).put(1, 1).put(13, 48).put(1, 1)
    b.put(1, interlaced).put(1, 1).put(1 if verid == 1 else 2, sprite)
    if sprite:   # the rest would be sprite fields; the decoder stops here
        return b"\0\0\1\x20" + b.bytes()
    b.put(1, not8).put(1, 0)
    if verid != 1:
        b.put(1, qpel)
    b.put(1, 1).put(1, 1).put(1, 0)
    if verid != 1:
        b.put(1, 0).put(1, 0)
    b.put(1, 0)
    return b"\0\0\1\x20" + b.bytes()


@pytest.mark.parametrize("fields,what", [
    (dict(interlaced=1), "interlaced"),
    (dict(sprite=1), "sprites / global motion compensation"),
    (dict(verid=2, sprite=2), "sprites / global motion compensation"),
    (dict(verid=2, qpel=1), "quarter-pel"),
    (dict(shape=1), "shape coding"),
    (dict(not8=1), "N-bit"),
])
def test_crafted_vol_headers_raise_naming_item_8(fields, what):
    with pytest.raises(mpeg4.Unsupported, match=f"{what}.*Queue 1 item 8"):
        mpeg4.Decoder(_vol(**fields))
    mpeg4.Decoder(_vol(verid=fields.get("verid", 1)))   # the same, plain


@pytest.mark.parametrize("vop_type,what", [(2, "B-VOPs"), (3, "S-VOPs")])
def test_crafted_vop_headers_raise_naming_item_8(vop_type, what):
    dec = mpeg4.Decoder(_vol())
    vop = _Bits().put(2, vop_type).put(1, 0).put(1, 1).put(5, 1).put(1, 1)
    with pytest.raises(mpeg4.Unsupported, match=f"{what}.*Queue 1 item 8"):
        dec.decode(b"\0\0\1\xb6" + vop.put(1, 1).put(16, 0).bytes())


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="too small"):
        vio.Mpeg4Writer(str(tmp_path / "a.mp4"), 25.0, (1, 9))
    with pytest.raises(ValueError, match="frame rate"):
        vio.Mpeg4Writer(str(tmp_path / "a.mp4"), 0.0, (16, 16))
    wr = vio.Mpeg4Writer(str(tmp_path / "a.mp4"), 25.0, (16, 16))
    with pytest.raises(ValueError, match="does not match"):
        wr.write(np.zeros((8, 8, 3), np.uint8))
    wr.release()
    # .mov is written now (tests/test_torch_video_out.py); where cv2's
    # mp4v writer does not open, the port refuses
    with pytest.raises(ValueError, match="mp4v writer does not open"):
        vio.AsyncVideoWriter(str(tmp_path / "a.mxf"), 25.0, (16, 16))


# ------------------------------------------------------- 3GP, size changes

def _manifest_seeks(path, name):
    video = vio.EncodedVideo(path)
    want = MANIFEST[name]
    for t, hit in want["seeks"].items():
        assert hashlib.sha256(video.frame(int(t)).tobytes()).hexdigest() == \
            want["sha256"][hit], t


@pytest.mark.parametrize("name,codec,entry", [
    ("mpeg4_176x144.3gp", "mpeg4", "mp4v"),
    ("h263_176x144.3gp", "h263", "s263")])
def test_3gp_reads_as_cv2(name, codec, entry):
    """ISO BMFF of the 3GPP brands: what cv2 writes for fourccs mp4v and
    s263 into .3gp reads through the MP4 demuxer, every seek as cv2's."""
    path = os.path.join(FIXTURES, name)
    box = Mp4File(path)
    assert (box.codec, box.tag) == (codec, entry)
    with open(path, "rb") as f:
        assert f.read(12)[4:11] == b"ftyp3gp"
    assert [hashlib.sha256(f.tobytes()).hexdigest()
            for f in vio.read_frames(path)] == MANIFEST[name]["sha256"]
    _manifest_seeks(path, name)


def test_vol_of_another_size_is_scaled_back_as_cv2_does():
    """Two libavcodec streams in one AVI, the second's VOL 128x96: cv2
    scales its pictures back to the stream's first size, 176x144, through
    swscale's bicubic scaler; the port converts them the same way."""
    name = "mpeg4_resize.avi"
    path = os.path.join(FIXTURES, name)
    video = vio.EncodedVideo(path)
    sizes = [p[0].shape for _, p in video.planes()]
    assert sizes == [(144, 176)] * 7 + [(96, 128)] * 6
    frames = list(video)
    assert all(f.shape == (144, 176, 3) for f in frames)
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == \
        MANIFEST[name]["sha256"]
    _manifest_seeks(path, name)


@pytest.mark.parametrize("entry,codec", [
    ("3IV2", "mpeg4"), ("XVID", "mpeg4"), ("DIVX", "mpeg4"),
    ("mpg1", "mpeg12"), ("mpg2", "mpeg12"), ("yuv4", "yuv4")])
def test_quicktime_entries_cv2_writes_read_as_cv2_reads_them(entry, codec):
    """The sample entries cv2's mov muxer writes for these fourccs (isom.c's
    3IV2, XVID and DIVX with the VOL in glbl; its m1v and m2v1 fallbacks
    for MPEG-1/2; yuv4): the codec FFmpeg's mov demuxer picks, and the
    frames cv2 reads."""
    name = f"tag_{entry}_64x48.mov"
    path = os.path.join(FIXTURES, name)
    box = Mp4File(path)
    assert box.codec == codec
    assert box.tag == {"mpg1": "m1v ", "mpg2": "m2v1"}.get(entry, entry)
    _same(list(vio.read_frames(path)), _cv2_frames(path))
