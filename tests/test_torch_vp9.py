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
    to the first size: the port reads all 12 frames at cv2's digests (it
    refused frame 6 before scaled prediction was read; the test keeps its
    name)."""
    path = os.path.join(FIXTURES, "vp9_resize.webm")
    assert "scaled_reference" in MANIFEST["vp9_resize.webm"]["vp9_features"]
    frames = list(vio.read_frames(path))
    _same(frames, _cv2_frames(path))
    assert len(frames) == 12
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == \
        MANIFEST["vp9_resize.webm"]["sha256"]
    sizes = [p[0].shape for _, p in vio.EncodedVideo(path).planes()]
    assert sizes == [(144, 176)] * 6 + [(96, 128)] * 6


@pytest.mark.parametrize("name", [n for n in VP9 if "resize" in n])
def test_size_changes_read_every_seek_as_cv2(name):
    """Each resizing stream, in WebM and AVI: the frames after a size
    change come out at the stream's first size, every seek reads the frame
    the manifest records cv2 reading.  libvpx grows a stream past its
    first size only at a key frame (``vp9_resize_small_first.webm``);
    shrinking, and growing back, it predicts from references of the other
    size."""
    path = os.path.join(FIXTURES, name)
    want = MANIFEST[name]
    assert vio.video_info(path) == {k: want[k] for k in
                                    ("fps", "width", "height", "frames")}
    video = vio.EncodedVideo(path)
    for t, hit in want["seeks"].items():
        assert hashlib.sha256(video.frame(int(t)).tobytes()).hexdigest() == \
            want["sha256"][hit], t
    assert "size_change" in want["vp9_features"]
    assert ("scaled_reference" in want["vp9_features"]) == (
        "small_first" not in name)


# the plain versions the C is held to

def _scaled_8tap_np(ref, x, y, fx, fy, dx, dy, bw, bh, filt):
    """FFmpeg's do_scaled_8tap_c in numpy, reads clamped to the plane."""
    taps = FILTERS[filt].astype(np.int64)
    ph, pw = ref.shape
    th = (((bh - 1) * dy + fy) >> 4) + 8
    rows = ref[np.clip(np.arange(y - 3, y - 3 + th), 0, ph - 1)].astype(
        np.int64)
    pos = fx + dx * np.arange(bw)
    cols = x + (pos >> 4)[:, None] + np.arange(-3, 5)[None, :]
    tmp = (rows[:, np.clip(cols, 0, pw - 1)] * taps[pos & 15][None]).sum(-1)
    tmp = np.clip((tmp + 64) >> 7, 0, 255)
    pos = fy + dy * np.arange(bh)
    win = (pos >> 4)[:, None] + np.arange(8)[None, :]
    out = (tmp[win] * taps[pos & 15][:, :, None]).sum(1)
    return np.clip((out + 64) >> 7, 0, 255).astype(np.uint8)


# libvpx's 8-tap kernels (vp9_filter.c): regular, smooth, sharp, bilinear
FILTERS = np.array([
    [[0, 0, 0, 128, 0, 0, 0, 0], [0, 1, -5, 126, 8, -3, 1, 0],
     [-1, 3, -10, 122, 18, -6, 2, 0], [-1, 4, -13, 118, 27, -9, 3, -1],
     [-1, 4, -16, 112, 37, -11, 4, -1], [-1, 5, -18, 105, 48, -14, 4, -1],
     [-1, 5, -19, 97, 58, -16, 5, -1], [-1, 6, -19, 88, 68, -18, 5, -1],
     [-1, 6, -19, 78, 78, -19, 6, -1], [-1, 5, -18, 68, 88, -19, 6, -1],
     [-1, 5, -16, 58, 97, -19, 5, -1], [-1, 4, -14, 48, 105, -18, 5, -1],
     [-1, 4, -11, 37, 112, -16, 4, -1], [-1, 3, -9, 27, 118, -13, 4, -1],
     [0, 2, -6, 18, 122, -10, 3, -1], [0, 1, -3, 8, 126, -5, 1, 0]],
    [[0, 0, 0, 128, 0, 0, 0, 0], [-3, -1, 32, 64, 38, 1, -3, 0],
     [-2, -2, 29, 63, 41, 2, -3, 0], [-2, -2, 26, 63, 43, 4, -4, 0],
     [-2, -3, 24, 62, 46, 5, -4, 0], [-2, -3, 21, 60, 49, 7, -4, 0],
     [-1, -4, 18, 59, 51, 9, -4, 0], [-1, -4, 16, 57, 53, 12, -4, -1],
     [-1, -4, 14, 55, 55, 14, -4, -1], [-1, -4, 12, 53, 57, 16, -4, -1],
     [0, -4, 9, 51, 59, 18, -4, -1], [0, -4, 7, 49, 60, 21, -3, -2],
     [0, -4, 5, 46, 62, 24, -3, -2], [0, -4, 4, 43, 63, 26, -2, -2],
     [0, -3, 2, 41, 63, 29, -2, -2], [0, -3, 1, 38, 64, 32, -1, -3]],
    [[0, 0, 0, 128, 0, 0, 0, 0], [-1, 3, -7, 127, 8, -3, 1, 0],
     [-2, 5, -13, 125, 17, -6, 3, -1], [-3, 7, -17, 121, 27, -10, 5, -2],
     [-4, 9, -20, 115, 37, -13, 6, -2], [-4, 10, -23, 108, 48, -16, 8, -3],
     [-4, 10, -24, 100, 59, -19, 9, -3], [-4, 11, -24, 90, 70, -21, 10, -4],
     [-4, 11, -23, 80, 80, -23, 11, -4], [-4, 10, -21, 70, 90, -24, 11, -4],
     [-3, 9, -19, 59, 100, -24, 10, -4], [-3, 8, -16, 48, 108, -23, 10, -4],
     [-2, 6, -13, 37, 115, -20, 9, -4], [-2, 5, -10, 27, 121, -17, 7, -3],
     [-1, 3, -6, 17, 125, -13, 5, -2], [0, 1, -3, 8, 127, -7, 3, -1]],
    [[0, 0, 0, 128 - 8 * k, 8 * k, 0, 0, 0] for k in range(16)]])


def test_scaled_8tap_equals_numpy():
    """The C filter of scaled prediction against the numpy version above:
    every filter, steps of a reference twice as large (32) down to one
    half as large (8) and between, phases, positions that reach past each
    edge of the plane, and a second prediction averaged in."""
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 256, (40, 56), np.uint8)
    n = 0
    for filt in range(4):
        for dx, dy in ((32, 32), (16, 16), (8, 8), (23, 11), (21, 29)):
            for bw, bh in ((4, 4), (8, 4), (16, 16), (64, 64)):
                x, y = (int(v) for v in rng.integers(-12, 60, 2))
                fx, fy = (int(v) for v in rng.integers(0, 16, 2))
                got = vp9.scaled_8tap(ref, x, y, fx, fy, dx, dy, bw, bh, filt)
                want = _scaled_8tap_np(ref, x, y, fx, fy, dx, dy, bw, bh, filt)
                np.testing.assert_array_equal(got, want, err_msg=str(
                    (filt, dx, dy, bw, bh, x, y, fx, fy)))
                first = rng.integers(0, 256, (bh, bw), np.uint8)
                avg = vp9.scaled_8tap(ref, x, y, fx, fy, dx, dy, bw, bh,
                                      filt, dst=first)
                np.testing.assert_array_equal(
                    avg, ((first.astype(int) + want + 1) >> 1).astype(
                        np.uint8))
                n += 1
    assert n == 80


# swscale's bicubic scaler to BGR24 at video range, BT.601, in numpy: what
# cv2 runs on a picture of another size than its stream's first

def _tdiv(a, b):
    """C's integer division (toward zero)."""
    return -(-a // b) if a < 0 else a // b


def _init_filter(src, dst, align, one, src_pos=128, dst_pos=128):
    """libswscale's initFilter for SWS_BICUBIC (B 0, C 0.6)."""
    inc = ((src << 16) + (dst >> 1)) // dst
    fone = 1 << (54 - min(int(np.log2(max(src // dst, 1))), 8))
    if abs(inc - 0x10000) < 10 and src_pos == dst_pos:
        size, pos, filt = 1, list(range(dst)), [[fone] for _ in range(dst)]
    else:
        size = 5 if inc <= 1 << 16 else 1 + (4 * src + dst - 1) // dst
        size = max(min(size, src - 2), 1)
        c_ = int(0.6 * (1 << 24))
        x_dst = ((dst_pos * inc) >> 7) - ((src_pos * 0x10000) >> 7)
        pos, filt = [], []
        for _ in range(dst):
            xx = _tdiv(x_dst - (size - 2) * (1 << 16), 1 << 17)
            pos.append(xx)
            row = []
            for j in range(size):
                d = abs((xx + j) * (1 << 17) - x_dst) << 13
                if inc > 1 << 16:
                    d = d * dst // src
                if d >= 1 << 31:
                    co = 0
                else:
                    dd, ddd = (d * d) >> 30, (((d * d) >> 30) * d) >> 30
                    if d < 1 << 30:
                        co = ((12 * (1 << 24) - 6 * c_) * ddd
                              + (-18 * (1 << 24) + 6 * c_) * dd
                              + 6 * (1 << 24) * (1 << 30))
                    else:
                        co = (-6 * c_ * ddd + 30 * c_ * dd - 48 * c_ * d
                              + 24 * c_ * (1 << 30))
                row.append(_tdiv(co, (1 << 54) // fone))
            filt.append(row)
            x_dst += 2 * inc
    cut = 0.002 * fone
    minsize = 0
    for i in range(dst - 1, -1, -1):
        f = filt[i]
        acc = 0
        for _ in range(size):
            acc += abs(f[0])
            if acc > cut or (i < dst - 1 and pos[i] >= pos[i + 1]):
                break
            f[:] = f[1:] + [0]
            pos[i] += 1
        acc, mn = 0, size
        for j in range(size - 1, 0, -1):
            acc += abs(f[j])
            if acc > cut:
                break
            mn -= 1
        minsize = max(minsize, mn)
    if minsize == 1 and align == 2:
        align = 1
    out = (minsize + align - 1) & ~(align - 1)
    filt = [(f + [0] * out)[:out] for f in filt]
    for i in range(dst):
        f = filt[i]
        if pos[i] < 0:
            for j in range(1, out):
                left = max(j + pos[i], 0)
                f[left] += f[j]
                f[j] = 0
            pos[i] = 0
        if pos[i] + out > src:
            shift = pos[i] + min(out - src, 0)
            acc = 0
            for j in range(out - 1, -1, -1):
                if pos[i] + j >= src:
                    acc += f[j]
                    f[j] = 0
            f[:] = [0 if j < shift else f[j - shift] for j in range(out)]
            pos[i] -= shift
            f[src - 1 - pos[i]] += acc
    coef = np.zeros((dst, out), np.int64)
    for i in range(dst):
        total = max((sum(filt[i]) + one // 2) // one, 1)
        err = 0
        for j in range(out):
            v = filt[i][j] + err
            iv = (v + total // 2) // total if v >= 0 else -((-v + total // 2)
                                                           // total)
            coef[i, j] = iv
            err = v - iv * total
    return np.array(pos), coef


def _hscale(plane, pos, coef):
    src = plane.astype(np.int64)
    idx = pos[:, None] + np.arange(coef.shape[1])[None, :]
    ok = idx < src.shape[1]
    val = (src[:, np.minimum(idx, src.shape[1] - 1)] * np.where(ok, coef, 0)
           ).sum(-1)
    return np.minimum(val >> 7, (1 << 15) - 1)


def _tables():
    """ff_yuv2rgb_c_init_tables' BT.601 video-range tables (the C output
    rows)."""
    cy = (1 << 16) * 255 // 219
    inv = {"crv": 104597, "cbu": 132201, "cgu": -25675, "cgv": -53279}
    k = {n: _tdiv(c * 65536 + 0x8000, cy) for n, c in inv.items()}
    yb = -(384 << 16) - 512 * cy - (16 << 16) + cy * np.arange(2048)
    ytab = np.clip((yb + 0x8000) >> 16, 0, 255)
    head = np.clip(np.arange(256 + 1024) - 512, 0, 255)
    t = {n: -(c >> 9) + ((head * c) >> 16) for n, c in k.items()}
    return ytab, t, 326 + 512


def _simd(y8, u8, v8):
    """swscale's x86 yuv2rgb on 8x-scale words (BT.601, video range)."""
    def mulhw(a, b):
        return (a * b) >> 16

    def wrap(a):
        return ((a + 32768) & 0xFFFF) - 32768
    ys = mulhw(wrap(y8 - 128), 9539)
    uu, vv = wrap(u8 - 1024), wrap(v8 - 1024)
    g = np.clip(mulhw(uu, -3209) + mulhw(vv, -6660), -32768, 32767)
    out = [ys + mulhw(uu, 16525), ys + g, ys + mulhw(vv, 13075)]
    return np.stack([np.clip(np.clip(c, -32768, 32767), 0, 255)
                     for c in out], -1)


def _scale_np(y, u, v, dw, dh):
    """Planes (Y at sw x sh) → BGR24 at dw x dh (dw even), swscale's way."""
    sh, sw = y.shape
    csh, csw = u.shape
    cdw = (dw + 1) >> 1
    lp, lc = _init_filter(sw, dw, 4, 1 << 14)
    lvp, lvc = _init_filter(sh, dh, 2, 1 << 12)
    cp, cc = _init_filter(csw, cdw, 4, 1 << 14)
    cvp, cvc = _init_filter(csh, dh, 2, 1 << 12)
    y15, u15, v15 = (_hscale(y, lp, lc), _hscale(u, cp, cc),
                     _hscale(v, cp, cc))
    ytab, tab, base = _tables()
    out = np.zeros((dh, dw, 3), np.int64)
    cols = np.arange(dw) >> 1
    for r in range(dh):
        lrows = y15[lvp[r]:lvp[r] + lvc.shape[1]]
        urows = u15[cvp[r]:cvp[r] + cvc.shape[1]]
        vrows = v15[cvp[r]:cvp[r] + cvc.shape[1]]
        assert lvc.shape[1] > 2    # the general vertical filter
        if r < dh - 2:
            def acc(rows, c):
                s = np.full(rows.shape[1], 4, np.int64)
                for j in range(len(c)):
                    s = ((s + ((rows[j] * c[j]) >> 16) + 32768) & 0xFFFF) \
                        - 32768
                return s
            out[r] = _simd(acc(lrows, lvc[r]), acc(urows, cvc[r])[cols],
                           acc(vrows, cvc[r])[cols])
        else:
            yy = ((1 << 18) + (lrows * lvc[r][:, None]).sum(0)) >> 19
            uu = ((1 << 18) + (urows * cvc[r][:, None]).sum(0)) >> 19
            vv = ((1 << 18) + (vrows * cvc[r][:, None]).sum(0)) >> 19
            uu = np.clip(uu, -512, 767)[cols] + 512
            vv = np.clip(vv, -512, 767)[cols] + 512
            out[r] = np.stack([ytab[base + tab["cbu"][uu] + yy],
                               ytab[base + tab["cgu"][uu] + tab["cgv"][vv]
                                    + yy],
                               ytab[base + tab["crv"][vv] + yy]], -1)
    return out.astype(np.uint8)


@pytest.mark.parametrize("src,dst", [((128, 96), (176, 144)),
                                     ((176, 144), (128, 96)),
                                     ((88, 72), (176, 144)),
                                     ((512, 218), (1024, 436)),
                                     ((130, 98), (176, 144))])
def test_scaler_at_unequal_sizes_equals_numpy(src, dst):
    """``i420_to_bgr(..., size=)``, the conversion of a picture of another
    size than its stream's, against the numpy version of swscale's scaler
    above: luma and chroma scaled, the x86 rows and the last two rows'
    lookup tables."""
    rng = np.random.default_rng(sum(src + dst))
    (sw, sh), (dw, dh) = src, dst
    y = rng.integers(0, 256, (sh, sw), np.uint8)
    u = rng.integers(0, 256, ((sh + 1) // 2, (sw + 1) // 2), np.uint8)
    v = rng.integers(0, 256, u.shape, np.uint8)
    np.testing.assert_array_equal(i420_to_bgr(y, u, v, size=dst),
                                  _scale_np(y, u, v, dw, dh))


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
