"""Regenerate ``tests/goldens/video/``: the video files the port's MPEG-4
Part 2 decoder, demuxers and colour conversion are held to where OpenCV is
absent (the GPU machine), and ``manifest.json`` with, for each file, the
SHA-256 of every frame ``cv2.VideoCapture`` decodes from it (BGR bytes) and
its ``CAP_PROP_FPS``, ``_FRAME_WIDTH``, ``_FRAME_HEIGHT`` and
``_FRAME_COUNT``.

    python tests/make_video_fixtures.py              # the files and manifest
    python tests/make_video_fixtures.py --manifest   # the manifest alone
    python tests/make_video_fixtures.py --new h263p_fixtures ...
        # only the named fixture functions' files (stream_fixtures if none
        # is named), their manifest entries added to the others

Needs OpenCV with FFmpeg (the manifest records the versions).  cv2's
Matroska muxer writes random UIDs, so rewriting the files changes the
``.mkv``/``.webm`` bytes cv2 wrote (not their frames): to add a fixture,
write it from a fixture function through ``--new`` (``--manifest`` keeps
each file's recorded group and refuses a file no function wrote).  The frames
are seeded blurred noise, panned a few pixels a frame (``moving_clip``):

  * ``moving_176x144.mp4``: 26 frames (three GOPs) by ``cv2.VideoWriter``
    with fourcc ``mp4v``; ``moving_176x144_xvid.avi`` and ``..._fmp4.avi``
    the same frames with ``XVID`` and ``FMP4`` (VOL headers in band);
  * ``odd_53x37.mp4``: a 53x37 input, which cv2 crops to a 52x36 stream;
  * ``still_64x48.mp4``: one frame 14 times (P-VOPs of skipped blocks);
  * ``raw_i420.avi``: ``I420`` rawvideo by cv2, its frames then overwritten
    with seeded full-range planes (Y below 16 and above 235, chroma at
    both ends): it holds the YUV → BGR conversion alone;
  * ``mjpg.avi``: Motion JPEG by ``cv2.VideoWriter`` (fourcc ``MJPG``:
    Lavc's encoder, its own DQT and optimised DHT, 4:2:0);
  * ``mjpg_176x144.mp4``: fourcc ``MJPG`` into ``.mp4``, which cv2 writes
    under the sample entry ``mp4v`` with objectTypeIndication 0x6C;
  * ``mjpg_nodht_176x144.avi``: PIL's baseline JPEGs (the standard Huffman
    tables) with their DHT segments cut, as camera Motion JPEG comes, muxed
    by the port's ``AviWriter(fourcc="MJPG")``;
  * ``tools_h263.mp4`` and ``tools_mpegq.avi``: written by the port's own
    encoder with the coding tools FFmpeg's writer leaves off (video
    packets, 4MV, alternating rounding over planes full of zeros, a
    per-macroblock quantiser, AC prediction; MPEG quantisation with custom
    matrices), so FFmpeg's decode of them is on record too;
  * ``mpeg4_176x143.mp4`` and ``mpeg4_175x143.mp4``: ``moving_176x144.mp4``
    with the VOL's 13-bit width and height and the ``mp4v`` sample entry's
    patched (the same 11x9 macroblock grid): odd heights, which swscale
    converts through its scaler;
  * VP8 (fourcc ``VP80``, libvpx through cv2's FFmpeg): ``vp8_176x144``
    as ``.webm``, ``.mkv`` and ``.avi``, the moving clip's 26 frames (key
    frames at 0, 12, 24); ``vp8_still_64x48.webm`` (skipped macroblocks);
    ``vp8_odd_53x37.webm`` (cv2 crops it to 52x36);
    ``vp8_175x143.webm`` (the 176x144 WebM with every key frame's size and
    the track's PixelWidth/PixelHeight patched: cropped from the same
    macroblock grid, converted through swscale's scaler);
    ``vp8_version{1,2,3}.webm`` (a 13-frame stream, key frames at 0 and
    12, with every frame's version bits patched: bilinear prediction,
    full-pel chroma at 3); the same stream unpatched but for its Segment's
    and Clusters' sizes rewritten to unknown, as MediaRecorder leaves them
    (``vp8_unknown_sizes.webm``), or its Cues overwritten by a Void
    (``vp8_no_cues.webm``);
    ``vp8_sintel_436x1024.webm``: 13 frames alternating the committed
    Sintel JPEG pair (``tests/goldens/jpeg/sintel_im{1,2}.jpg``), key
    frames at 0 and 12, which the card run decodes;
  * ``mkv_mp4v_176x144.mkv``, ``mkv_mjpg_176x144.mkv`` and
    ``mkv_i420_64x48.mkv``: fourccs ``mp4v``, ``MJPG`` and ``I420`` into
    Matroska (``V_MPEG4/ISO/ASP`` with the VOL as CodecPrivate,
    ``V_MJPEG``, ``V_UNCOMPRESSED``).

  * MPEG-1 and MPEG-2 (fourccs ``PIM1`` and ``MPG2``): the moving clip's
    40 frames as ``mpeg1_176x144`` and ``mpeg2_176x144`` in ``.mpg``
    (cv2's program stream muxer), ``.avi``, ``.mkv`` and ``.mp4``; the
    ``.mpg`` files with every sequence header's size patched to 175x143
    (MPEG-1's centred and MPEG-2's left chroma site at an odd height);
    ``mpeg2_53x37.mpg`` (cv2 crops it to 52x36, patched back);
    ``mpeg2_still_64x48.mpg`` and ``mpeg1_still_176x144.mpg`` (skipped
    macroblocks, address escapes); ``mpeg2_sintel_436x1024.mpg``, the
    Sintel pair's 13 frames, which the card run decodes, and
    ``mpeg2_sintel_head_436x1024.mpg``, its first 10 pictures remuxed by
    ``ps_mux`` with a PTS on each (every seek exact), which the card run's
    pseudo regime trains on; and, from cv2's
    bundled libavcodec through ctypes (``Lavc``) muxed by ``ps_mux``:
    ``mpeg2_tools.mpg`` (intra VLC table, non-linear quantiser, 10-bit DC,
    a BT.709 colour description, closed GOPs, adaptive quantisation; its
    headers rewritten with custom matrices, a quant matrix extension with
    chroma matrices, alternate scan and broken_link), ``mpeg2_dc9.mpg``
    and ``mpeg2_dc11.mpg``, ``mpeg2_low_delay.mpg``,
    ``mpeg1_matrices.mpg`` (custom matrices at quantiser 1: FFmpeg's
    oddification turns a 0 into -1) and ``mpeg2_interlaced.mpg``
    (interlaced frames, which the port refuses).

  * pictures that change size (cv2 scales them back to the stream's
    first size): ``vp9_resize_grow.webm`` (libvpx shrinks at frame 4 and
    grows back at 9, both mid-GOP), ``vp9_resize_small_first.webm`` (the
    first frames the smaller), ``vp9_resize_176x144.avi`` (fourcc ``VP90``,
    the port's AVI muxer), ``vp9_resize_sintel_436x1024.webm`` (the Sintel
    pair's 13 frames, 218x512 from frame 5 on), which the card run decodes;
    ``vp8_resize.webm`` (a key frame at the new size); ``mpeg4_resize.avi``
    and ``mpeg2_resize.mpg`` (two libavcodec streams one after the other: a
    new VOL or sequence header; FFmpeg drops the MPEG-2 picture it held
    back for display there);
  * H.263 (fourccs ``H263`` and ``s263``): ``h263_{128x96,176x144,352x288}``
    ``.avi`` by cv2's writer, ``h263_176x144`` as ``.3gp``, ``.mov`` and
    ``.mkv``, and ``mpeg4_176x144.3gp`` (``mp4v`` into 3GP); from cv2's
    bundled libavcodec through ``Lavc``, muxed by the port's AVI muxer:
    ``h263_sintel_704x576.avi`` (the Sintel pair at 4CIF, which the card
    run decodes), ``h263_obmc_176x144.avi`` (advanced prediction: 8x8
    vectors and overlapped motion compensation, DQUANT),
    ``h263_mv4_176x144.avi`` (8x8 vectors with DQUANT, no OBMC),
    ``h263_gob_352x288.avi`` (GOB headers, eight PSUPP bytes in each
    picture header, MCBPC stuffing before each I-picture's first
    macroblock) and ``h263_resize.avi`` (QCIF, then sub-QCIF);
  * transport streams, elementary streams and FFV1 (``stream_fixtures``;
    ``--new`` writes these alone and adds their manifest entries):
    ``mpeg2_176x144.{ts,m2ts,mts}``, ``mpeg1_176x144.ts`` (read at 50
    fps), ``mpeg4_176x144.{ts,mpg}``, ``mpeg2_sintel_436x1024.ts`` and a
    low-delay one (``ts_mux``) the card run's pseudo regime reads;
    libavcodec's MPEG-2 with split PES packets and continuity gaps, MPEG-1
    under stream type 0x01; H.263 and FFV1 muxed into ``ts_*.ts`` (neither
    cv2 nor the port reads them); ``.m1v``, ``.m2v``, ``.mpv``, ``.h263``,
    ``.263`` and a constant-bit-rate ``.m2v``; FFV1 from cv2's writer in
    ``.mkv``/``.avi``/``.mp4``/``.mov``, grey, the Sintel pair's 3 frames,
    and from libavcodec (``Lavc.encode_ffv1``) in Matroska: versions 0-2,
    both range-coder tables, 6 and 12 slices, grey, 4:2:0 with and without
    alpha, odd sizes;
  * H.263+ (``h263p_fixtures``): libavcodec's ``h263p`` (PLUSPTYPE
    headers, alternating rounding) with Annexes D (``umv``), F (``obmc``,
    ``+mv4``), I and T (``+aic``), J (``+loop``), K (``structured_slices``
    with ``ps=400``) and S (``aiv``) alone and combined
    (``h263_plus_*_176x144.avi``, ``h263_plus_*_352x288.avi``), the
    standard clock (``h263_plus_176x144``, also as ``.h263``, ``.mkv``
    under V_MS/VFW/FOURCC and ``.3gp`` under ``s263``), custom formats at
    100x60 and 320x240 and a custom clock (1/25), a size change, an
    intra-only stream with INTRA_MODE and DQUANT rewritten
    (``rewrite_aic_intra``: AC prediction, Annex T's DQUANT codes) and
    the Sintel pair at 436x1024, which the card run decodes;
  * transport and program streams whose PES headers carry a PTS alone
    over B-pictures (``pts_only_fixtures``: ``mpeg2_pts_only_176x144``
    as ``.ts``, ``.m2ts`` and ``.mpg``, ``mpeg1_pts_only_176x144.ts``;
    cv2's seeks to 0-12 in the transport streams land a GOP late);
  * 16-bit colour PNG sequences by ``cv2.imwrite`` (``png16_fixtures``:
    ``png16_rgb_53x37_%d.png``, ``png16_rgba_53x37_%d.png`` and
    ``png16_triples_256x256_%d.png``, 65,536 random triples), one manifest
    entry a pattern;
  * lossless intra video (``lossless_fixtures``: HuffYUV, FFVHuff, Ut
    Video, PNG, raw layouts; ``hfyu_*``, ``ffvh_*``, ``ut_*``, ``png_*``,
    ``raw_*``);
  * MagicYUV (``magicyuv_fixtures``, ``magy_*``), Sorenson H.263
    (``sorenson_fixtures``, ``flv_*``, in ``.flv`` by ``flv_mux``) and ASUS
    V1/V2 (``asv_fixtures``, ``asv_*``), each with the Sintel pair at
    436x1024, which the card run decodes;
  * MS-MPEG4 and WMV7/8 (``msmpeg4_fixtures``, ``msm_*``) and Snow
    (``snow_fixtures``, ``snow_*``: cv2's writer in .avi, .mkv, .mov and
    .wmv, libavcodec's encoder with each of its tools, the crafted headers
    of ``SnowCraft``), with the Sintel pair at 436x1024 too.

Each VP8 file's manifest entry lists the header features and coding modes
the port's decoder met in it (``vp8_features``, ``runtime/vp8.FEATURES``);
each VP9 and MPEG-1/2 file's likewise (``vp9_features``,
``mpeg12_features``, ``h263_features``; ``magicyuv_features``,
``flv_features``, ``asv_features``, ``msmpeg4_features``,
``snow_features``), and each MPEG-1/2, H.263,
``.3gp`` and size-changing file's the frame a ``CAP_PROP_POS_FRAMES`` seek
to each index reads (``seeks``: an index into its sequential frames, or
null where cv2 reads none).  Every entry names the fixture function that
wrote its file (``group``: ``h263p`` for ``h263p_fixtures``), by which
each phase of ``chip_smoke.py`` takes its fixtures.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import math
import struct
import sys

from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "goldens", "video")
GOP = 12


def moving_clip(h: int, w: int, n: int, seed: int = 0,
                speed: float = 2.0) -> list:
    """n BGR frames of seeded blurred noise, panned ``speed`` px a frame
    across and 0.7 of that down."""
    import cv2
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (2 * h + 256, 2 * w + 256, 3), np.uint8)
    base = cv2.GaussianBlur(base, (0, 0), 3)
    return [base[64 + int(t * speed * 0.7):64 + int(t * speed * 0.7) + h,
                 64 + int(t * speed):64 + int(t * speed) + w].copy()
            for t in range(n)]


def zero_planes(h: int, w: int, n: int, seed: int = 1) -> list:
    """n moving I420 frames (Y, U, V) whose samples are mostly 0-3: the
    no-rounding half-pel averages differ from exact ones only at 0."""
    rng = np.random.default_rng(seed)
    y = (rng.integers(0, 4, (h + 80, w + 80)) *
         rng.integers(0, 2, (h + 80, w + 80))).astype(np.uint8)
    c = rng.integers(0, 3, (h // 2 + 40, w // 2 + 40)).astype(np.uint8)
    out = []
    for t in range(n):
        oy, ox = (2 * t) % 40 + t % 3, (3 * t) % 40
        cu = c[t % 20:t % 20 + h // 2, t % 17:t % 17 + w // 2]
        out.append((y[oy:oy + h, ox:ox + w], cu, 255 - cu))
    return out


def frame_digest(frame: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(frame).tobytes()).hexdigest()


def cv2_frames(path: str) -> list:
    import cv2
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def cv2_info(path: str) -> dict:
    import cv2
    cap = cv2.VideoCapture(path)
    info = {"fps": cap.get(cv2.CAP_PROP_FPS),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    cap.release()
    return info


def _cv2_write(path: str, frames: list, fourcc: str, fps: float = 25.0,
               color: bool = True):
    import cv2
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h),
                         isColor=color)
    assert wr.isOpened(), path
    for f in frames:
        wr.write(f)
    wr.release()


def _fill_raw_frames(path: str, w: int, h: int, seed: int = 2) -> None:
    """Overwrite every ``00db``/``00dc`` chunk of a raw AVI with seeded
    full-range I420 planes."""
    rng = np.random.default_rng(seed)
    data = bytearray(open(path, "rb").read())
    need = w * h * 3 // 2
    pos = data.find(b"movi") + 4
    while pos + 8 <= len(data):
        fcc, n = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if fcc == b"idx1":
            break
        if fcc[2:] in (b"db", b"dc"):
            assert n == need, (n, need)
            data[pos + 8:pos + 8 + n] = rng.integers(0, 256, n,
                                                     np.uint8).tobytes()
        pos += 8 + n + (n & 1)
    open(path, "wb").write(bytes(data))


def _port_write(path: str, planes: list, **codec) -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.avi import AviWriter
    from opticalflow_tpu_torch.io.mp4 import Mp4Writer
    from opticalflow_tpu_torch.runtime.mpeg4 import Encoder
    h, w = planes[0][0].shape
    avi = path.endswith(".avi")
    enc = Encoder(w, h, 25, 1, inband=avi, **codec)
    mux = (AviWriter(path, (w, h), (25, 1)) if avi else
           Mp4Writer(path, (w, h), (25, 1), enc.headers))
    for p in planes:
        mux.write(*enc.encode(*p))
    mux.release()


def strip_dht(data: bytes) -> bytes:
    """A JPEG file without its DHT segments (the standard tables apply)."""
    out, p = bytearray(data[:2]), 2
    while p < len(data):
        marker = data[p + 1]
        if marker == 0xDA:
            return bytes(out + data[p:])
        n = data[p + 2] << 8 | data[p + 3]
        if marker != 0xC4:
            out += data[p:p + 2 + n]
        p += 2 + n
    return bytes(out)


def mjpeg_avi(path: str, jpegs: list, fps: int = 25) -> None:
    """JPEG files → a Motion JPEG AVI through the port's RIFF muxer."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.avi import AviWriter
    from opticalflow_tpu_torch.runtime.jpeg import jpeg_size
    h, w = jpeg_size(jpegs[0])
    mux = AviWriter(path, (w, h), (fps, 1), fourcc="MJPG")
    for data in jpegs:
        mux.write(data, True)
    mux.release()


def _pil_jpegs(frames: list, quality: int = 75) -> list:
    import io
    from PIL import Image
    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(f[..., ::-1])).save(
            buf, "JPEG", quality=quality)
        out.append(buf.getvalue())
    return out


def _bgr_planes(frames: list) -> list:
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.yuv import i420_planes
    from opticalflow_tpu_torch.runtime.mpeg4 import to_i420
    return [i420_planes(to_i420(f)) for f in frames]


class _BitPos:
    """Reads an MPEG-4 VOL's fields, keeping the bit position."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | (self.data[self.pos >> 3] >> (7 - (self.pos & 7)) & 1)
            self.pos += 1
        return v


def _vol_size_bits(data: bytes, start: int) -> int:
    """The bit position of video_object_layer_width in the VOL whose start
    code begins at ``start`` (a rectangular VOL, ISO 14496-2 6.2.3)."""
    b = _BitPos(data, 8 * (start + 4))
    b.read(1 + 8)                       # random access, object type
    if b.read(1):                       # is_object_layer_identifier
        b.read(4 + 3)
    if b.read(4) == 15:                 # aspect_ratio_info: extended PAR
        b.read(16)
    if b.read(1):                       # vol_control_parameters
        b.read(2 + 1)
        if b.read(1):                   # vbv_parameters
            b.read(79)
    assert b.read(2) == 0, "not a rectangular VOL"
    b.read(1)
    res = b.read(16)
    b.read(1)
    if b.read(1):                       # fixed_vop_rate
        b.read(max(1, (res - 1).bit_length()))
    b.read(1)
    return b.pos


def _put_bits(data: bytearray, pos: int, n: int, v: int) -> None:
    for k in range(n):
        bit = v >> (n - 1 - k) & 1
        byte, sh = (pos + k) >> 3, 7 - ((pos + k) & 7)
        data[byte] = data[byte] & ~(1 << sh) | bit << sh


def patch_mpeg4_size(src: str, dst: str, w: int, h: int) -> None:
    """An ``mp4v`` MP4 whose VOL (in the esds) and sample entry say w x h."""
    data = bytearray(open(src, "rb").read())
    vol = data.find(b"\x00\x00\x01\x20")
    assert vol >= 0
    pos = _vol_size_bits(bytes(data), vol)
    _put_bits(data, pos, 13, w)         # width, a marker, height
    _put_bits(data, pos + 14, 13, h)
    entry = data.find(b"mp4v", data.find(b"stsd")) - 4
    data[entry + 32:entry + 36] = struct.pack(">HH", w, h)
    open(dst, "wb").write(bytes(data))


def _mkv_frames(path: str) -> list:
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.mkv import MkvFile
    return MkvFile(path).offsets


def patch_vp8_size(src: str, dst: str, w: int, h: int) -> None:
    """A VP8 WebM whose key frames and PixelWidth/PixelHeight say w x h
    (within the same macroblock grid)."""
    data = bytearray(open(src, "rb").read())
    for off in _mkv_frames(src):
        if not data[off] & 1:           # a key frame
            assert data[off + 3:off + 6] == b"\x9d\x01\x2a"
            data[off + 6:off + 10] = struct.pack("<HH", w, h)
    tracks = data.find(b"\x16\x54\xae\x6b")
    for eid, v in ((b"\xb0\x81", w), (b"\xba\x81", h)):
        at = data.find(eid, tracks)
        data[at + 2] = v
    open(dst, "wb").write(bytes(data))


def patch_vp8_version(src: str, dst: str, version: int) -> None:
    """Every frame's 3-bit version field set to ``version``."""
    data = bytearray(open(src, "rb").read())
    for off in _mkv_frames(src):
        data[off] = data[off] & ~0x0E | version << 1
    open(dst, "wb").write(bytes(data))


def _ebml_sizes(data: bytes, eid: bytes) -> list:
    """(offset of the size field, its length) of each top-level element
    ``eid`` inside the Segment (Clusters, Cues) or of the Segment."""
    out, at = [], data.find(eid)
    while at >= 0:
        first = data[at + len(eid)]
        n = next(k for k in range(1, 9) if first & (0x80 >> (k - 1)))
        out.append((at + len(eid), n))
        at = data.find(eid, at + 1)
    return out


def unknown_sizes(src: str, dst: str) -> None:
    """The Segment's and every Cluster's size rewritten to 'unknown' (all
    ones, in the size field's own length)."""
    data = bytearray(open(src, "rb").read())
    for eid in (b"\x18\x53\x80\x67", b"\x1f\x43\xb6\x75"):
        for at, n in _ebml_sizes(bytes(data), eid):
            data[at:at + n] = ((1 << (7 * n + 1)) - 1).to_bytes(n, "big")
    open(dst, "wb").write(bytes(data))


def without_cues(src: str, dst: str) -> None:
    """The Cues element (the last match: the SeekHead names it too)
    overwritten by a Void of its length."""
    data = bytearray(open(src, "rb").read())
    at, n = _ebml_sizes(bytes(data), b"\x1c\x53\xbb\x6b")[-1]
    size = int.from_bytes(data[at:at + n], "big") & ((1 << (7 * n)) - 1)
    total = 4 + n + size
    data[at - 4:at - 4 + total] = (b"\xec" + (1 << 56 | total - 9).to_bytes(
        8, "big") + b"\0" * (total - 9))
    open(dst, "wb").write(bytes(data))


# ------------------------------------------------------------------- VP8
# the clamping_type bit of a key frame: its first partition re-encoded with
# the bit set, bool for bool (RFC 6386's boolean coder; the key-frame
# header and mode syntax of section 19.2, the probabilities vp8.cpp holds)

def _cpp_table(name: str, source: str = "vp8.cpp") -> list:
    """The integers of ``const ... name[...] = {...};`` in a runtime
    source (runtime/vp8.cpp unless named)."""
    import re
    src = open(os.path.join(os.path.dirname(HERE), "opticalflow_tpu_torch",
                            "runtime", source)).read()
    body = re.search(name + r"(\[\d+\])+ = \{(.*?)\};", src, re.S).group(2)
    return [int(x, 0) for x in re.findall(r"-?(?:0x[0-9a-fA-F]+|\d+)", body)]


class _BoolReader:
    """RFC 6386 section 7's decoder, recording every (probability, bit)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8) | data[1]
        self.range, self.count = 255, 0
        self.log = []

    def read(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            bit, self.range = 1, self.range - split
            self.value -= big
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(
                    self.data) else 0
                self.pos += 1
        self.log.append((prob, bit))
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read(128)
        return v

    def tree(self, tree: list, probs: list) -> int:
        i = 0
        while True:
            i = tree[i + self.read(probs[i >> 1])]
            if i <= 0:
                return -i


def _bool_encode(log: list) -> bytes:
    """RFC 6386 section 7.3's encoder over a list of (probability, bit)."""
    out = bytearray()
    rng, bottom, bit_count = 255, 0, 24

    def carry():
        i = len(out) - 1
        while i >= 0 and out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    for prob, bit in log:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                carry()
            bottom = (bottom << 1) & 0xFFFFFFFF
            bit_count -= 1
            if not bit_count:
                out.append((bottom >> 24) & 0xFF)
                bottom &= (1 << 24) - 1
                bit_count = 8
    c, v = bit_count, bottom   # flush
    if v & (1 << (32 - c)):
        carry()
    v = (v << (c & 7)) & 0xFFFFFFFF
    for _ in range(c >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def _vp8_key_partition(part: bytes, mbw: int, mbh: int) -> _BoolReader:
    """Read a VP8 key frame's first partition through its macroblock
    modes, logging every bool."""
    r = _BoolReader(part)
    r.read(128)                                      # colour space
    r.read(128)                                      # clamping type
    update_map = False
    if r.read(128):                                  # segmentation
        update_map = r.read(128)
        if r.read(128):
            r.read(128)
            for bits in [7] * 4 + [6] * 4:
                if r.read(128):
                    r.literal(bits + 1)
        seg_probs = [255, 255, 255]
        if update_map:
            for i in range(3):
                if r.read(128):
                    seg_probs[i] = r.literal(8)
    r.literal(1 + 6 + 3)             # filter type, level, sharpness
    if r.read(128) and r.read(128):                  # lf deltas
        for _ in range(8):
            if r.read(128):
                r.literal(7)
    r.literal(2)                                     # partitions
    r.literal(7)                                     # y_ac_qi
    for _ in range(5):
        if r.read(128):
            r.literal(5)
    r.read(128)                                      # refresh_entropy_probs
    for p in _cpp_table("kCoefUpdateProbs"):
        if r.read(p):
            r.literal(8)
    skip_prob = r.literal(8) if r.read(128) else None
    kf_y, kf_uv = _cpp_table("kKfYmodeProbs"), _cpp_table("kKfUvModeProbs")
    bmode = _cpp_table("kKfBmodeProbs")
    y_tree = [-4, 2, 4, 6, 0, -1, -2, -3]            # B_PRED = 4
    uv_tree = [0, 2, -1, 4, -2, -3]
    b_tree = [0, 2, -1, 4, -2, 6, 8, 12, -3, 10, -5, -6, -4, 14, -7, 16,
              -8, -9]
    implied = {0: 0, 1: 2, 2: 3, 3: 1}               # DC, V, H, TM -> B_*
    above = [[0] * 4 for _ in range(mbw)]
    for my in range(mbh):
        left = [0] * 4
        for mx in range(mbw):
            if update_map:
                r.tree([2, 4, 0, -1, -2, -3], seg_probs)
            if skip_prob is not None:
                r.read(skip_prob)
            ymode = r.tree(y_tree, kf_y)
            if ymode == 4:
                modes = [0] * 16
                for b in range(16):
                    a = above[mx][b & 3] if b < 4 else modes[b - 4]
                    lft = left[b >> 2] if b & 3 == 0 else modes[b - 1]
                    k = (a * 10 + lft) * 9
                    modes[b] = r.tree(b_tree, bmode[k:k + 9])
            else:
                modes = [implied[ymode]] * 16
            above[mx] = modes[12:16]
            left = [modes[3], modes[7], modes[11], modes[15]]
            r.tree(uv_tree, kf_uv)
    return r


def set_vp8_clamping(src: str, dst: str) -> None:
    """A VP8 stream whose key frames set clamping_type (their first
    partitions re-encoded, the frame tags' partition sizes rewritten),
    muxed anew into WebM."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.mkv import MkvFile
    box = MkvFile(src)
    packets = []
    with open(src, "rb") as f:
        for i in range(len(box.sizes)):
            frame = box.sample(f, i)
            key = not frame[0] & 1
            if key:
                tag = frame[0] | frame[1] << 8 | frame[2] << 16
                first = tag >> 5
                w, h = struct.unpack("<HH", frame[6:10])
                mbw, mbh = ((w & 0x3FFF) + 15) // 16, ((h & 0x3FFF) + 15) // 16
                log = _vp8_key_partition(frame[10:10 + first], mbw, mbh).log
                part = _bool_encode(log[:1] + [(128, 1)] + log[2:])
                tag = (tag & 0x1F) | len(part) << 5
                frame = (bytes([tag & 0xFF, tag >> 8 & 0xFF, tag >> 16])
                         + frame[3:10] + part + frame[10 + first:])
            packets.append((frame, key))
    _webm(dst, packets, box.width, box.height, b"V_VP8")


def _webm(path: str, packets: list, w: int, h: int, codec: bytes = b"V_VP9",
          fps: int = 25, colour_range=None, private: bytes = b"",
          doctype: bytes = b"webm") -> None:
    """(frame, keyframe) packets → a minimal WebM (or Matroska, by
    ``doctype``): one track with DefaultDuration, ``private`` as its
    CodecPrivate and, if given, a Colour Range; a Cluster from each
    keyframe; Duration; no Cues."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io import mkv
    ebml = mkv._el(mkv.EBML, mkv._uint_el(0x4286, 1) + mkv._uint_el(0x42F7, 1)
                   + mkv._uint_el(0x42F2, 4) + mkv._uint_el(0x42F3, 8)
                   + mkv._el(mkv.DOCTYPE, doctype) + mkv._uint_el(0x4287, 4)
                   + mkv._uint_el(0x4285, 2))
    info = mkv._el(mkv.INFO, mkv._uint_el(mkv.TIMECODE_SCALE, 1_000_000)
                   + mkv._el(mkv.DURATION,
                             struct.pack(">d", len(packets) * 1000.0 / fps)))
    video = (mkv._uint_el(mkv.PIXEL_WIDTH, w)
             + mkv._uint_el(mkv.PIXEL_HEIGHT, h))
    if colour_range is not None:
        video += mkv._el(mkv.COLOUR, mkv._uint_el(mkv.RANGE, colour_range))
    track = mkv._el(mkv.TRACK_ENTRY, mkv._uint_el(mkv.TRACK_NUMBER, 1)
                    + mkv._uint_el(mkv.TRACK_UID, 1)
                    + mkv._uint_el(mkv.TRACK_TYPE, 1)
                    + mkv._el(mkv.CODEC_ID, codec)
                    + (mkv._el(mkv.CODEC_PRIVATE, private) if private else b"")
                    + mkv._uint_el(mkv.DEFAULT_DURATION, 10 ** 9 // fps)
                    + mkv._el(mkv.VIDEO, video))
    clusters, cur = b"", []

    def flush():
        nonlocal clusters, cur
        if cur:
            base = cur[0][0] * 1000 // fps
            body = mkv._uint_el(mkv.TIMECODE, base) + b"".join(
                mkv._el(mkv.SIMPLE_BLOCK, b"\x81" + struct.pack(
                    ">hB", i * 1000 // fps - base, 0x80 if key else 0) + data)
                for i, data, key in cur)
            clusters += mkv._el(mkv.CLUSTER, body)
            cur = []

    for i, (data, key) in enumerate(packets):
        if key:
            flush()
        cur.append((i, data, key))
    flush()
    with open(path, "wb") as f:
        f.write(ebml + mkv._el(mkv.SEGMENT, info + mkv._el(mkv.TRACKS, track)
                               + clusters))


def _vp8_features(path: str) -> list:
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    v = EncodedVideo(path)
    dec = v._decoder()
    with open(path, "rb") as f:
        for i in range(len(v.box.sizes)):
            dec.decode(v.box.sample(f, i))
    return dec.features


# ------------------------------------------------------------------- VP9
class Vpx:
    """libvpx's VP9 encoder (or its VP8 one, ``codec="vp8"``; cv2's bundled
    ``libvpx``) through ctypes, for the settings cv2's writer does not
    reach.  The configuration is ``vpx_codec_enc_config_default``'s, its
    fields set at the public ``vpx_codec_enc_cfg_t`` offsets (``OFF``); each
    setting is checked on the stream by the port's decoder (``vp9_features``
    in the manifest)."""

    CTRL = {"cpu_used": 13, "auto_alt_ref": 14, "arnr_maxframes": 21,
            "arnr_strength": 22, "lossless": 32, "tile_columns": 33,
            "tile_rows": 34, "frame_parallel": 35, "aq_mode": 36,
            "color_space": 46, "color_range": 51}
    OFF = {"threads": 4, "w": 12, "h": 16, "tb_num": 28, "tb_den": 32,
           "error_resilient": 36, "pass": 40, "lag": 44, "bitrate": 112,
           "kf_min": 164, "kf_max": 168}

    def __init__(self, codec: str = "vp9"):
        import ctypes
        import glob
        import cv2
        libs = os.path.join(os.path.dirname(cv2.__file__), os.pardir,
                            "opencv_python.libs")
        L = ctypes.CDLL(sorted(glob.glob(os.path.join(libs, "libvpx*")))[0])
        c, P = ctypes, ctypes.c_void_p
        self.iface = f"vpx_codec_{codec}_cx"
        for name, res, args in (
                (self.iface, P, []),
                ("vpx_codec_enc_config_default", c.c_int, [P, P, c.c_uint]),
                ("vpx_codec_enc_init_ver", c.c_int, [P, P, P, c.c_long, c.c_int]),
                ("vpx_codec_enc_config_set", c.c_int, [P, P]),
                ("vpx_img_alloc", P, [P, c.c_int, c.c_uint, c.c_uint, c.c_uint]),
                ("vpx_img_free", None, [P]),
                ("vpx_codec_encode", c.c_int, [P, P, c.c_int64, c.c_ulong,
                                               c.c_long, c.c_ulong]),
                ("vpx_codec_get_cx_data", P, [P, P]),
                ("vpx_codec_destroy", c.c_int, [P])):
            fn = getattr(L, name)
            fn.restype, fn.argtypes = res, args
        self.L, self.c = L, ctypes

    def encode(self, planes: list, w: int, h: int, cfg=None, ctrls=None,
               two_pass: bool = False, resize=None) -> list:
        """I420 planes → [(packet, keyframe)], 25 fps, good quality;
        ``resize``: (frame, (w, h)), or a list of them, where the encoder's
        size changes (the planes scaled to it by ``_resize_plane``)."""
        if two_pass:
            stats = self._run(planes, w, h, dict(cfg or {}, **{"pass": 1}),
                              ctrls, resize, None)
            return self._run(planes, w, h, dict(cfg or {}, **{"pass": 2}),
                             ctrls, resize, stats)
        return self._run(planes, w, h, cfg or {}, ctrls, resize, None)

    def _run(self, planes, w, h, cfg, ctrls, resize, stats_in):
        L, c = self.L, self.c
        iface = getattr(L, self.iface)()
        buf = c.create_string_buffer(4096)
        assert L.vpx_codec_enc_config_default(iface, buf, 0) == 0
        settings = dict(w=w, h=h, tb_num=1, tb_den=25, threads=1,
                        bitrate=400, kf_min=0, kf_max=12, lag=0)
        settings.update(cfg)
        for k, v in settings.items():
            struct.pack_into("<I", buf, self.OFF[k], v)
        if stats_in is not None:
            sbuf = c.create_string_buffer(stats_in, len(stats_in))
            struct.pack_into("<QQ", buf, 80, c.addressof(sbuf), len(stats_in))
        ctx = c.create_string_buffer(1024)
        for abi in range(1, 100):   # VPX_ENCODER_ABI_VERSION of this build
            rc = L.vpx_codec_enc_init_ver(ctx, iface, buf, 0, abi)
            if rc != 3:             # VPX_CODEC_ABI_MISMATCH
                break
        assert rc == 0, rc
        for k, v in (ctrls or {}).items():
            assert L.vpx_codec_control_(ctx, self.CTRL[k], c.c_int(v)) == 0, k
        out, stats = [], []

        def drain():
            it = c.c_void_p(0)
            while True:
                pkt = L.vpx_codec_get_cx_data(ctx, c.byref(it))
                if not pkt:
                    return
                kind = c.c_int.from_address(pkt).value
                data = c.string_at(c.c_void_p.from_address(pkt + 8).value,
                                   c.c_size_t.from_address(pkt + 16).value)
                if kind == 1:       # first-pass statistics
                    stats.append(data)
                elif kind == 0:
                    key = c.c_uint32.from_address(pkt + 40).value & 1
                    out.append((data, bool(key)))

        cw, ch = w, h
        changes = dict([resize] if resize and isinstance(resize[0], int)
                       else resize or [])
        for i, (y, u, v) in enumerate(planes):
            if i in changes:
                cw, ch = changes[i]
                struct.pack_into("<II", buf, self.OFF["w"], cw, ch)
                assert L.vpx_codec_enc_config_set(ctx, buf) == 0
            if (cw, ch) != (w, h):
                y, u, v = (_resize_plane(p, (cw + s) >> s, (ch + s) >> s)
                           for p, s in ((y, 0), (u, 1), (v, 1)))
            img = L.vpx_img_alloc(None, 0x102, cw, ch, 1)   # I420
            ptrs = (c.c_void_p * 4).from_address(img + 48)
            strides = (c.c_int * 4).from_address(img + 80)
            for k, p in enumerate((y, u, v)):
                p = np.ascontiguousarray(p)
                for r in range(p.shape[0]):
                    c.memmove(ptrs[k] + r * strides[k], p[r].ctypes.data,
                              p.shape[1])
            assert L.vpx_codec_encode(ctx, img, i, 1, 0, 1000000) == 0
            L.vpx_img_free(img)
            drain()
        while True:                 # flush the lagged frames
            n = len(out) + len(stats)
            assert L.vpx_codec_encode(ctx, None, 0, 1, 0, 1000000) == 0
            drain()
            if len(out) + len(stats) == n:
                break
        L.vpx_codec_destroy(ctx)
        return b"".join(stats) if cfg.get("pass") == 1 else out


def _resize_plane(p: np.ndarray, w: int, h: int) -> np.ndarray:
    import cv2
    return cv2.resize(p, (w, h), interpolation=cv2.INTER_AREA)


def bgr_i420(frame: np.ndarray) -> tuple:
    """BGR → I420 planes (cv2's BT.601 conversion; an odd side padded by
    replication, the planes cropped back: (H+1)//2 x (W+1)//2 chroma)."""
    import cv2
    h, w = frame.shape[:2]
    pad = cv2.copyMakeBorder(frame, 0, h % 2, 0, w % 2, cv2.BORDER_REPLICATE)
    H, W = pad.shape[:2]
    flat = cv2.cvtColor(pad, cv2.COLOR_BGR2YUV_I420).ravel()
    q = (H // 2) * (W // 2)
    y = flat[:H * W].reshape(H, W)[:h, :w]
    u = flat[H * W:H * W + q].reshape(H // 2, W // 2)
    v = flat[H * W + q:].reshape(H // 2, W // 2)
    return y.copy(), u.copy(), v.copy()


def smooth_clip(n: int, h: int = 144, w: int = 176) -> list:
    """n BGR frames of slow sinusoids, each channel drifting its own way:
    content libvpx predicts from both sides of an alt-ref frame."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([128 + 100 * np.sin((xx + 3 * t) / 17 + yy / 29),
                              128 + 90 * np.cos((yy - 2 * t) / 13),
                              128 + 80 * np.sin((xx + yy + 4 * t) / 23)], -1),
                    0, 255).astype(np.uint8) for t in range(n)]


def patch_vp9_size(src: str, dst: str, w: int, h: int) -> None:
    """A VP9 WebM whose key frames and PixelWidth/PixelHeight say w x h
    (within the same 8x8 grid): profile 0 key frames carry the size at
    bits 36-67 after the sync code and colour bits."""
    data = bytearray(open(src, "rb").read())
    for off in _mkv_frames(src):
        if data[off] >> 6 == 2 and not data[off] & 0x3C:   # profile 0 key
            bits = int.from_bytes(data[off:off + 9], "big")
            bits &= ~(((1 << 32) - 1) << 4)
            bits |= ((w - 1) << 16 | (h - 1)) << 4
            data[off:off + 9] = bits.to_bytes(9, "big")
    tracks = data.find(b"\x16\x54\xae\x6b")
    for eid, v in ((b"\xb0\x81", w), (b"\xba\x81", h)):
        at = data.find(eid, tracks)
        data[at + 2] = v
    open(dst, "wb").write(bytes(data))


def _vp9_features(path: str) -> tuple:
    """(features the port's decoder met in a VP9 file, its refusal or
    None)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    from opticalflow_tpu_torch.runtime.mpeg4 import Unsupported
    v = EncodedVideo(path)
    dec = v._decoder()
    refused = None
    with open(path, "rb") as f:
        try:
            for i in range(len(v.box.sizes)):
                dec.decode_all(v.box.sample(f, i))
        except Unsupported as e:
            refused = str(e).split(": ", 1)[1]
    return dec.features, refused


class Vp9Header:
    """A profile-0 VP9 frame's uncompressed header as a list of fields
    ``[name, bits, value]`` in bitstream order, and the byte where the
    compressed header starts; :meth:`bytes` writes it back (fields edited,
    inserted or removed) followed by the rest of the frame.  ``sizes``
    holds the 8 reference slots' (width, height), which an inter frame's
    size may come from; parse a stream's frames in order."""

    SEG_BITS = (8, 6, 2, 0)

    def __init__(self, frame: bytes, sizes: list):
        self.frame, self.fields, self.pos = frame, [], 0
        self._parse(sizes)

    def _f(self, name: str, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | (self.frame[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
            self.pos += 1
        self.fields.append([name, n, v])
        return v

    def _parse(self, sizes: list) -> None:
        f = self._f
        f("marker", 2), f("profile_low", 1), f("profile_high", 1)
        if f("show_existing", 1):
            f("show_idx", 3)
            self.end = None
            return
        key = f("frame_type", 1) == 0
        show, er = f("show_frame", 1), f("error_res", 1)
        intra_only = 0 if key or show else f("intra_only", 1)
        if not key and not er:
            f("reset_ctx", 2)
        w = h = None
        if key or intra_only:
            f("sync", 24)
            if key:
                f("color_space", 3), f("color_range", 1)
            refresh = 0xFF if key else f("refresh", 8)
            w, h = f("w", 16) + 1, f("h", 16) + 1
        else:
            refresh = f("refresh", 8)
            idx = []
            for _ in range(3):
                idx.append(f("ref_idx", 3))
                f("sign_bias", 1)
            for i in range(3):
                if f("found_ref", 1):
                    w, h = sizes[idx[i]]
                    break
            if w is None:
                w, h = f("w", 16) + 1, f("h", 16) + 1
        if f("render_diff", 1):
            f("render_w", 16), f("render_h", 16)
        if not key and not intra_only:
            f("allow_hp", 1)
            if not f("switchable", 1):
                f("filter", 2)
        if not er:
            f("refresh_ctx", 1), f("parallel", 1)
        f("ctx_idx", 2)
        f("lf_level", 6), f("sharpness", 3)
        if f("lf_delta_enabled", 1) and f("lf_delta_update", 1):
            for i in range(6):
                if f("lf_delta_coded", 1):
                    f("lf_delta", 7)
        f("base_q", 8)
        for k in ("y_dc", "uv_dc", "uv_ac"):
            if f(f"dq_{k}_coded", 1):
                f(f"dq_{k}", 5)
        if f("seg_enabled", 1):
            if f("seg_update_map", 1):
                for _ in range(7):
                    if f("seg_tree_coded", 1):
                        f("seg_tree", 8)
                if f("seg_temporal", 1):
                    for _ in range(3):
                        if f("seg_pred_coded", 1):
                            f("seg_pred", 8)
            if f("seg_update_data", 1):
                f("seg_abs", 1)
                for i in range(8):
                    for j in range(4):
                        if f(f"seg_feature_{i}_{j}", 1) and j < 3:
                            f(f"seg_value_{i}_{j}", self.SEG_BITS[j])
                            if j < 2:
                                f(f"seg_sign_{i}_{j}", 1)
        sb = (w + 63) // 64
        lo, hi = 0, 1
        while (64 << lo) < sb:
            lo += 1
        while (sb >> hi) >= 4:
            hi += 1
        for _ in range(lo, hi - 1):
            if not f("tile_col_inc", 1):
                break
        if f("tile_rows", 1):
            f("tile_rows_inc", 1)
        f("header_size", 16)
        self.end = (self.pos + 7) >> 3
        for i in range(8):
            if refresh >> i & 1:
                sizes[i] = (w, h)

    def find(self, name: str) -> int:
        return next(i for i, fl in enumerate(self.fields) if fl[0] == name)

    def bytes(self) -> bytes:
        bits = "".join(format(v, f"0{n}b") for _, n, v in self.fields if n)
        bits += "0" * (-len(bits) % 8)
        head = int(bits, 2).to_bytes(len(bits) // 8, "big")
        return head + (self.frame[self.end:] if self.end else b"")


def _superframe(frames: list) -> bytes:
    """Frames joined with a superframe index (4-byte sizes)."""
    marker = 0xC0 | 3 << 3 | (len(frames) - 1)
    index = bytes([marker]) + b"".join(struct.pack("<I", len(f))
                                       for f in frames) + bytes([marker])
    return b"".join(frames) + index


def vp9_header_fixtures() -> None:
    """Streams whose uncompressed headers are rewritten to reach what
    neither cv2's writer nor libvpx here sets; each decodes as FFmpeg
    decodes the bits it is given (cv2 is the oracle):

      * ``vp9_headers.webm``: cv2's 176x144 stream with loop-filter
        sharpness 3, y/uv delta quantisers -3/+2/-2 on every frame and the
        bilinear filter on frames that fix their filter;
      * ``vp9_seg_lf.webm``: libvpx's aq stream with an alt-LF value on
        every segment of the frames that update segment data;
      * ``vp9_intra_only.webm``: cv2's stream with key frame 12 turned into
        a hidden intra-only frame (refresh all slots, reset_frame_context
        3) in a superframe with a show_existing_frame of slot 0;
      * ``vp9_seg_ref_skip.webm``: the aq stream's inter frames that update
        segment data given a reference feature (LAST) on segment 1 and the
        skip feature on segment 2: the tiles are then read as other syntax
        than was written, which FFmpeg decodes without complaint (reading
        zeros past a tile's end) and the port decodes as it does."""
    src = os.path.join(OUT, "vp9_176x144.webm")
    box_frames = _mkv_samples(src)
    out, sizes = [], [None] * 8
    for data, key in box_frames:
        hd = Vp9Header(data, sizes)
        hd.fields[hd.find("sharpness")][2] = 3
        for k, v in (("y_dc", -3), ("uv_dc", 2), ("uv_ac", -2)):
            i = hd.find(f"dq_{k}_coded")
            if hd.fields[i][2]:
                hd.fields[i + 1][2] = abs(v) << 1 | (v < 0)
            else:
                hd.fields[i][2] = 1
                hd.fields.insert(i + 1, [f"dq_{k}", 5, abs(v) << 1 | (v < 0)])
        if any(fl[0] == "filter" for fl in hd.fields):
            hd.fields[hd.find("filter")][2] = 3
        out.append((hd.bytes(), key))
    _webm(os.path.join(OUT, "vp9_headers.webm"), out, 176, 144)

    out, sizes = [], [None] * 8
    for data, key in _mkv_samples(os.path.join(OUT, "vp9_aq.webm")):
        hd = Vp9Header(data, sizes)
        for seg in range(8):
            name = f"seg_feature_{seg}_1"
            if any(fl[0] == name for fl in hd.fields):
                i = hd.find(name)
                v = 2 * seg - 7
                hd.fields[i][2] = 1
                rest = [[f"seg_value_{seg}_1", 6, abs(v)],
                        [f"seg_sign_{seg}_1", 1, int(v < 0)]]
                if i + 1 < len(hd.fields) and hd.fields[i + 1][0] == \
                        f"seg_value_{seg}_1":
                    hd.fields[i + 1:i + 3] = rest
                else:
                    hd.fields[i + 1:i + 1] = rest
        out.append((hd.bytes(), key))
    _webm(os.path.join(OUT, "vp9_seg_lf.webm"), out, 176, 144)

    out, sizes = [], [None] * 8
    for data, key in _mkv_samples(os.path.join(OUT, "vp9_aq.webm")):
        hd = Vp9Header(data, sizes)
        if not key and any(fl[0] == "seg_feature_1_2" for fl in hd.fields):
            i = hd.find("seg_feature_1_2")
            hd.fields[i][2] = 1
            hd.fields.insert(i + 1, ["seg_value_1_2", 2, 1])
            hd.fields[hd.find("seg_feature_2_3")][2] = 1
        out.append((hd.bytes(), key))
    _webm(os.path.join(OUT, "vp9_seg_ref_skip.webm"), out, 176, 144)

    out, sizes = [], [None] * 8
    for n, (data, key) in enumerate(box_frames):
        if n == 12:
            hd = Vp9Header(data, sizes)
            f = hd.fields
            f[hd.find("frame_type")][2] = 1
            f[hd.find("show_frame")][2] = 0
            at = hd.find("sync")
            f[at:at] = [["intra_only", 1, 1], ["reset_ctx", 2, 3]]
            del f[hd.find("color_space"):hd.find("color_range") + 1]
            f.insert(hd.find("w"), ["refresh", 8, 0xFF])
            show_slot0 = bytes([0b10001000])
            data, key = _superframe([hd.bytes(), show_slot0]), False
        out.append((data, key))
    _webm(os.path.join(OUT, "vp9_intra_only.webm"), out, 176, 144)


def _mkv_samples(path: str) -> list:
    """(frame, keyframe) of each block of a Matroska file."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.mkv import MkvFile
    box = MkvFile(path)
    with open(path, "rb") as f:
        return [(box.sample(f, i), i in box.keyframes)
                for i in range(len(box.sizes))]


def vp9_fixtures() -> None:
    """The VP9 files: cv2's writer (fourcc VP90), then libvpx's encoder;
    and the VP8 WebM with clamping_type set, whose colour, like theirs,
    depends on FFmpeg's decoder threads."""
    set_vp8_clamping(os.path.join(OUT, "vp8_176x144.webm"),
                     os.path.join(OUT, "vp8_clamping.webm"))
    moving = moving_clip(144, 176, 26)
    for ext in ("webm", "mkv", "mp4", "avi"):
        _cv2_write(os.path.join(OUT, f"vp9_176x144.{ext}"), moving, "VP90")
    _cv2_write(os.path.join(OUT, "vp9_still_64x48.webm"),
               moving_clip(48, 64, 1, seed=3) * 14, "VP90")
    webm = os.path.join(OUT, "vp9_176x144.webm")
    patch_vp9_size(webm, os.path.join(OUT, "vp9_175x143.webm"), 175, 143)
    patch_vp9_size(webm, os.path.join(OUT, "vp9_176x143.webm"), 176, 143)
    im1, im2 = sintel_pair()
    _cv2_write(os.path.join(OUT, "vp9_sintel_436x1024.webm"),
               [im1 if i % 2 == 0 else im2 for i in range(13)], "VP90")
    vpx = Vpx()

    def lib(name, frames, cfg=None, ctrls=None, **kw):
        planes = [bgr_i420(f) for f in frames]
        h, w = frames[0].shape[:2]
        colour = kw.pop("colour_range", None)
        packets = vpx.encode(planes, w, h, cfg, ctrls, **kw)
        _webm(os.path.join(OUT, name), packets, w, h, colour_range=colour)

    noise = moving_clip(144, 176, 26, seed=11, speed=3.0)
    lib("vp9_odd_53x37.webm", moving_clip(37, 53, 26, seed=1, speed=5.0),
        ctrls=dict(cpu_used=4))
    lib("vp9_altref.webm", smooth_clip(26), dict(lag=25, kf_max=60,
                                                 bitrate=200),
        dict(cpu_used=1, auto_alt_ref=1, frame_parallel=0), two_pass=True)
    lib("vp9_aq.webm", noise, ctrls=dict(cpu_used=4, aq_mode=3,
                                         frame_parallel=0))
    lib("vp9_lossless_64x48.webm", moving_clip(48, 64, 8, seed=14),
        ctrls=dict(cpu_used=4, lossless=1))
    lib("vp9_tiles_544x96.webm", moving_clip(96, 544, 14, seed=12),
        ctrls=dict(cpu_used=4, tile_columns=2, tile_rows=2,
                   frame_parallel=0))
    lib("vp9_error_resilient.webm", noise[:13], dict(error_resilient=1),
        dict(cpu_used=4))
    short = smooth_clip(6)
    lib("vp9_full_range.webm", short, ctrls=dict(cpu_used=4, color_space=1,
                                                 color_range=1))
    lib("vp9_bt709.webm", short, ctrls=dict(cpu_used=4, color_space=2))
    lib("vp9_full_range_bt709.webm", short, ctrls=dict(
        cpu_used=4, color_space=2, color_range=1), colour_range=1)
    lib("vp9_resize.webm", noise[:12], dict(kf_max=60), dict(cpu_used=4),
        resize=(6, (128, 96)))
    vp9_header_fixtures()


def resize_fixtures() -> None:
    """Streams whose pictures change size, which cv2 hands to swscale at
    the stream's first size: VP9 from libvpx (scaled references mid-GOP),
    VP8 (a key frame at the new size), and MPEG-4 Part 2 and MPEG-2 as two
    libavcodec streams one after the other (a new VOL or sequence header)."""
    vpx = Vpx()
    noise = moving_clip(144, 176, 26, seed=11, speed=3.0)
    planes = [bgr_i420(f) for f in noise[:14]]
    # shrinks at 4, grows back to the first size at 9 (no key frame)
    _webm(os.path.join(OUT, "vp9_resize_grow.webm"),
          vpx.encode(planes, 176, 144, dict(kf_max=60), dict(cpu_used=4),
                     resize=[(4, (128, 96)), (9, (176, 144))]), 176, 144)
    # starts at 128x96; libvpx takes a key frame to grow past it
    small = [tuple(_resize_plane(p, (s + 1) // (1 + k), (t + 1) // (1 + k))
                   for p, (s, t), k in zip(pl, ((128, 96),) * 3, (0, 1, 1)))
             for pl in planes[:12]]
    _webm(os.path.join(OUT, "vp9_resize_small_first.webm"),
          vpx.encode(small, 128, 96, dict(kf_max=60), dict(cpu_used=4),
                     resize=(6, (176, 144))), 128, 96)
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.avi import AviWriter
    mux = AviWriter(os.path.join(OUT, "vp9_resize_176x144.avi"), (176, 144),
                    (25, 1), fourcc="VP90")
    for data, key in vpx.encode(planes[:12], 176, 144, dict(kf_max=60),
                                dict(cpu_used=4), resize=(5, (88, 72))):
        mux.write(data, key)
    mux.release()
    im1, im2 = sintel_pair()
    sintel = [bgr_i420(im1 if i % 2 == 0 else im2) for i in range(13)]
    _webm(os.path.join(OUT, "vp9_resize_sintel_436x1024.webm"),
          vpx.encode(sintel, 1024, 436, dict(kf_max=60, bitrate=1500),
                     dict(cpu_used=4), resize=(5, (512, 218))), 1024, 436)
    _webm(os.path.join(OUT, "vp8_resize.webm"),
          Vpx("vp8").encode(planes[:12], 176, 144, dict(kf_max=60),
                            dict(cpu_used=4), resize=(6, (128, 96))),
          176, 144, b"V_VP8")
    lavc = Lavc()
    big = [bgr_i420(f) for f in noise[:7]]
    little = [bgr_i420(cv2_resize(f, 128, 96)) for f in noise[7:13]]
    mux = AviWriter(os.path.join(OUT, "mpeg4_resize.avi"), (176, 144),
                    (25, 1))
    for part in (big, little):
        for i, (data, _, _) in enumerate(lavc.encode(part, codec="mpeg4")):
            mux.write(data, i == 0)
    mux.release()
    pk = [(d, t, t) for d, t, _ in lavc.encode(big, bf=0)]
    pk += [(d, t + len(big), t + len(big))
           for d, t, _ in lavc.encode(little, bf=0)]
    ps_mux(os.path.join(OUT, "mpeg2_resize.mpg"), pk)


def cv2_resize(frame: np.ndarray, w: int, h: int) -> np.ndarray:
    import cv2
    return cv2.resize(frame, (w, h), interpolation=cv2.INTER_AREA)


# ------------------------------------------------------------- MPEG-1/2

class Lavc:
    """cv2's bundled libavcodec's ``mpeg1video``/``mpeg2video`` encoder
    through ctypes, for the coding tools cv2's writer leaves off: the
    encoder's options go in as an AVDictionary (``intra_vlc``,
    ``non_linear_quant``, ``alternate_scan``, ``intra_dc_precision``,
    ``colorspace`` with ``seq_disp_ext``, ``flags=+cgop``), the frame's
    size, format and pts at AVFrame's public offsets, a packet's fields at
    AVPacket's.  Each setting is checked on the stream by the port's
    decoder (``mpeg12_features`` in the manifest)."""

    def __init__(self):
        import ctypes
        import glob
        import cv2
        libs = os.path.join(os.path.dirname(cv2.__file__), os.pardir,
                            "opencv_python.libs")
        lib = lambda n: sorted(glob.glob(os.path.join(libs, f"lib{n}-*")))[0]  # noqa: E731
        self.ct = c = ctypes
        self.u = c.CDLL(lib("avutil"), mode=c.RTLD_GLOBAL)
        self.a = c.CDLL(lib("avcodec"))
        P, I = c.c_void_p, c.c_int
        for L, name, res, args in (
                (self.a, "avcodec_find_encoder_by_name", P, [c.c_char_p]),
                (self.a, "avcodec_find_decoder_by_name", P, [c.c_char_p]),
                (self.a, "avcodec_send_packet", I, [P, P]),
                (self.a, "avcodec_receive_frame", I, [P, P]),
                (self.a, "av_new_packet", I, [P, I]),
                (self.a, "avcodec_alloc_context3", P, [P]),
                (self.a, "avcodec_open2", I, [P, P, P]),
                (self.a, "avcodec_send_frame", I, [P, P]),
                (self.a, "avcodec_receive_packet", I, [P, P]),
                (self.a, "av_packet_alloc", P, []),
                (self.a, "av_packet_unref", None, [P]),
                (self.u, "av_opt_set", I, [P, c.c_char_p, c.c_char_p, I]),
                (self.u, "av_dict_set", I, [P, c.c_char_p, c.c_char_p, I]),
                (self.u, "av_frame_alloc", P, []),
                (self.u, "av_frame_get_buffer", I, [P, I]),
                (self.u, "av_frame_make_writable", I, [P])):
            fn = getattr(L, name)
            fn.restype, fn.argtypes = res, args

    def encode(self, planes: list, codec: str = "mpeg2video",
               fps=25, pix: str = "yuv420p", **opts) -> list:
        """Planes of pixel format ``pix`` (I420 by default; ``lavc_planes``'
        formats) → (packet, pts, dts) in frames, in decode order; ``fps`` a
        number or a time base's reciprocal as ``"30000/1001"``."""
        c, a, u = self.ct, self.a, self.u
        h, w = planes[0][0].shape
        u.av_get_pix_fmt.restype, u.av_get_pix_fmt.argtypes = c.c_int, [
            c.c_char_p]
        enc = a.avcodec_find_encoder_by_name(codec.encode())
        ctx = a.avcodec_alloc_context3(enc)
        for k, v in (("video_size", f"{w}x{h}"), ("pixel_format", pix),
                     ("time_base", "/".join(str(fps).split("/")[::-1])
                      if "/" in str(fps) else f"1/{fps}"),
                     ("g", "12"), ("b", "1000000"),
                     ("bf", "2" if codec == "mpeg2video" else "0")):
            assert u.av_opt_set(ctx, k.encode(), v.encode(), 1) >= 0, k
        d = c.c_void_p()
        for k, v in opts.items():
            u.av_dict_set(c.byref(d), k.encode(), str(v).encode(), 0)
        assert a.avcodec_open2(ctx, enc, c.byref(d)) >= 0, opts
        frame, pkt = u.av_frame_alloc(), a.av_packet_alloc()
        ints = (c.c_int * 30).from_address(frame)
        # width, height, format
        ints[26], ints[27], ints[29] = w, h, u.av_get_pix_fmt(pix.encode())
        assert u.av_frame_get_buffer(frame, 0) >= 0
        out = []

        def drain():
            while a.avcodec_receive_packet(ctx, pkt) == 0:
                pts, dts = (c.c_int64.from_address(pkt + o).value
                            for o in (8, 16))
                data = c.c_void_p.from_address(pkt + 24).value
                size = c.c_int.from_address(pkt + 32).value
                out.append((c.string_at(data, size), pts, dts))
                a.av_packet_unref(pkt)

        for n, pl in enumerate(planes):
            assert u.av_frame_make_writable(frame) >= 0
            ptrs = (c.c_void_p * 8).from_address(frame)
            strides = (c.c_int * 8).from_address(frame + 64)
            for k, p in enumerate(pl):
                p = np.ascontiguousarray(p)
                for r in range(p.shape[0]):
                    c.memmove(ptrs[k] + r * strides[k], p[r].ctypes.data,
                              p[r].nbytes)
            c.c_int64.from_address(frame + 136).value = n   # pts
            assert a.avcodec_send_frame(ctx, frame) >= 0
            drain()
        a.avcodec_send_frame(ctx, None)
        drain()
        return out


    def decode(self, packets: list, codec: str, shifts=(1, 1),
               dtype=np.uint8, extradata: bytes = b"",
               video_delay: int = 0, tag: str = "", size=None) -> list:
        """Packets → the (Y, U, V) planes libavcodec's ``codec`` decoder
        hands over (its pixel format's: ``shifts`` the chroma subsampling,
        ``dtype`` uint16 for samples deeper than 8 bits), read at AVFrame's
        data (0), linesize (64), width and height (104, 108); ``extradata``
        goes in through AVCodecParameters (offsets 16 and 24), and
        ``video_delay`` (at 120: the decoder's starting has_b_frames, as
        FFmpeg's probe leaves it for cv2), the fourcc ``tag`` (at 8) and
        the container's (width, height) ``size`` (at 72, 76: SpeedHQ's
        decoder takes both from its container)."""
        c, a, u = self.ct, self.a, self.u
        ctx = a.avcodec_alloc_context3(None)
        if extradata or video_delay or tag or size:
            a.avcodec_parameters_alloc.restype = c.c_void_p
            a.avcodec_parameters_to_context.argtypes = [c.c_void_p,
                                                        c.c_void_p]
            u.av_mallocz.restype = c.c_void_p
            u.av_mallocz.argtypes = [c.c_size_t]
            par = a.avcodec_parameters_alloc()
            buf = u.av_mallocz(len(extradata) + 64)
            c.memmove(buf, extradata, len(extradata))
            c.c_void_p.from_address(par + 16).value = buf
            c.c_int.from_address(par + 24).value = len(extradata)
            c.c_int.from_address(par + 0).value = 0     # video
            c.c_int.from_address(par + 120).value = video_delay
            if tag:
                c.c_uint32.from_address(par + 8).value = int.from_bytes(
                    tag.encode("latin1"), "little")
            if size:
                c.c_int.from_address(par + 72).value = size[0]
                c.c_int.from_address(par + 76).value = size[1]
            assert a.avcodec_parameters_to_context(ctx, par) >= 0
        dec = a.avcodec_find_decoder_by_name(codec.encode())
        assert a.avcodec_open2(ctx, dec, None) >= 0, codec
        frame, pkt = u.av_frame_alloc(), a.av_packet_alloc()
        out = []

        def drain():
            while a.avcodec_receive_frame(ctx, frame) == 0:
                ints = (c.c_int * 30).from_address(frame)
                w, h = ints[26], ints[27]
                ptrs = (c.c_void_p * 8).from_address(frame)
                strides = (c.c_int * 8).from_address(frame + 64)
                planes = []
                for k in range(3):
                    pw = w if not k else -(-w >> shifts[0])
                    ph = h if not k else -(-h >> shifts[1])
                    rows = [np.frombuffer(c.string_at(
                        ptrs[k] + r * strides[k],
                        pw * np.dtype(dtype).itemsize), dtype)
                        for r in range(ph)]
                    planes.append(np.stack(rows))
                out.append(tuple(planes))

        for data in packets:
            assert a.av_new_packet(pkt, len(data)) >= 0
            c.memmove(c.c_void_p.from_address(pkt + 24).value, data,
                      len(data))
            assert a.avcodec_send_packet(ctx, pkt) >= 0
            a.av_packet_unref(pkt)
            drain()
        a.avcodec_send_packet(ctx, None)
        drain()
        return out

    def encode_ffv1(self, frames: list, pix: str = "bgr0", gop: int = 12,
                    **opts) -> tuple:
        """BGR frames → (extradata, [(packet, keyframe)]) from libavcodec's
        ``ffv1`` encoder in pixel format ``pix`` (``bgr0``, ``gray``,
        ``yuv420p``, ``yuva420p``); ``opts`` are its options (``level``,
        ``coder``, ``slices``, ``context``, ``threads``, ``strict``)."""
        return self.encode_intra(frames, "ffv1", pix, g=gop, **opts)

    def encode_intra(self, frames: list, codec: str, pix: str,
                     quality=None, **opts) -> tuple:
        """BGR frames → (extradata, [(packet, keyframe)]) from libavcodec's
        encoder ``codec`` (``ffv1``, ``huffyuv``, ``ffvhuff``, ``utvideo``,
        ...) in pixel format ``pix`` (``lavc_planes``' formats); ``opts``
        are its options (``pred``, ``context``, ``slices``, ``flags``,
        ...), set on the context before it opens; ``quality`` each frame's
        AVFrame.quality (a lambda: the quantiser times FF_QP2LAMBDA, 118),
        which ``flags=+qscale`` encoders such as ``snow`` code at."""
        c, a, u = self.ct, self.a, self.u
        u.av_get_pix_fmt.restype, u.av_get_pix_fmt.argtypes = c.c_int, [
            c.c_char_p]
        a.avcodec_parameters_alloc.restype = c.c_void_p
        a.avcodec_parameters_from_context.argtypes = [c.c_void_p, c.c_void_p]
        h, w = frames[0].shape[:2]
        enc = a.avcodec_find_encoder_by_name(codec.encode())
        assert enc, codec
        ctx = a.avcodec_alloc_context3(enc)
        for k, v in (("video_size", f"{w}x{h}"), ("pixel_format", pix),
                     ("time_base", "1/25"),
                     *((k, str(v)) for k, v in opts.items())):
            assert u.av_opt_set(ctx, k.encode(), v.encode(), 1) >= 0, k
        assert a.avcodec_open2(ctx, enc, None) >= 0, (codec, pix, opts)
        par = a.avcodec_parameters_alloc()
        a.avcodec_parameters_from_context(par, ctx)
        ext = c.string_at(c.c_void_p.from_address(par + 16).value,
                          c.c_int.from_address(par + 24).value)
        frame, pkt = u.av_frame_alloc(), a.av_packet_alloc()
        ints = (c.c_int * 30).from_address(frame)
        ints[26], ints[27], ints[29] = w, h, u.av_get_pix_fmt(pix.encode())
        assert u.av_frame_get_buffer(frame, 0) >= 0
        out = []

        def drain():
            while a.avcodec_receive_packet(ctx, pkt) == 0:
                data = c.c_void_p.from_address(pkt + 24).value
                size = c.c_int.from_address(pkt + 32).value
                key = c.c_int.from_address(pkt + 40).value & 1
                out.append((c.string_at(data, size), bool(key)))
                a.av_packet_unref(pkt)

        for n, f in enumerate(frames):
            assert u.av_frame_make_writable(frame) >= 0
            ptrs = (c.c_void_p * 8).from_address(frame)
            strides = (c.c_int * 8).from_address(frame + 64)
            for k, pl in enumerate(lavc_planes(f, pix)):
                pl = np.ascontiguousarray(pl)
                for r in range(pl.shape[0]):
                    c.memmove(ptrs[k] + r * strides[k], pl[r].ctypes.data,
                              pl[r].nbytes)
            c.c_int64.from_address(frame + 136).value = n
            if quality is not None:
                c.c_int.from_address(frame + 160).value = quality
            assert a.avcodec_send_frame(ctx, frame) >= 0
            drain()
        a.avcodec_send_frame(ctx, None)
        drain()
        return ext, out


class Lavf:
    """cv2's bundled libavformat through ctypes: a file's video packets as
    FFmpeg's demuxer hands them to its decoder (``av_read_frame`` after
    ``avformat_find_stream_info``): (bytes, pts, key flag) each, the pts in
    the stream's time base, by AVPacket's public offsets."""

    def __init__(self):
        import ctypes
        import glob
        import cv2
        libs = os.path.join(os.path.dirname(cv2.__file__), os.pardir,
                            "opencv_python.libs")
        lib = lambda n: sorted(glob.glob(os.path.join(libs, f"lib{n}-*")))[0]  # noqa: E731
        self.ct = c = ctypes
        u = c.CDLL(lib("avutil"), mode=c.RTLD_GLOBAL)
        self.a = c.CDLL(lib("avcodec"), mode=c.RTLD_GLOBAL)
        self.f = c.CDLL(lib("avformat"))
        P = c.c_void_p
        for L, name, res, args in (
                (self.f, "avformat_open_input", c.c_int,
                 [c.POINTER(P), c.c_char_p, P, P]),
                (self.f, "avformat_find_stream_info", c.c_int, [P, P]),
                (self.f, "av_read_frame", c.c_int, [P, P]),
                (self.f, "avformat_close_input", None, [c.POINTER(P)]),
                (self.a, "av_packet_alloc", P, []),
                (self.a, "av_packet_free", None, [c.POINTER(P)]),
                (self.a, "av_packet_unref", None, [P]),
                (u, "av_log_set_level", None, [c.c_int])):
            fn = getattr(L, name)
            fn.restype, fn.argtypes = res, args
        u.av_log_set_level(-8)              # quiet
        self.u = u
        for L, name, res, args in (
                (self.f, "avformat_alloc_output_context2", c.c_int,
                 [c.POINTER(P), P, c.c_char_p, c.c_char_p]),
                (self.f, "avformat_new_stream", P, [P, P]),
                (self.f, "avio_open", c.c_int, [P, c.c_char_p, c.c_int]),
                (self.f, "avio_closep", c.c_int, [P]),
                (self.f, "avformat_write_header", c.c_int, [P, P]),
                (self.f, "av_interleaved_write_frame", c.c_int, [P, P]),
                (self.f, "av_write_trailer", c.c_int, [P]),
                (self.f, "avformat_free_context", None, [P]),
                (self.a, "av_new_packet", c.c_int, [P, c.c_int]),
                (u, "av_mallocz", P, [c.c_size_t])):
            fn = getattr(L, name)
            fn.restype, fn.argtypes = res, args

    def mux(self, path: str, packets: list, extradata: bytes, width: int,
            height: int, fps: int = 25, fmt: Optional[str] = None,
            codec_id: int = 27, video_delay: int = 0,
            display_matrix: Optional[list] = None) -> None:
        """(bytes, key) packets of one video stream (``codec_id``: 27,
        AV_CODEC_ID_H264) → ``path`` by libavformat's muxer for its
        extension (or ``fmt``): the stream's codecpar (type, codec, size,
        yuv420p, ``extradata``, ``video_delay`` at 120: the reorder depth an
        encoder's B-frames give, from which the muxers write composition
        offsets, edit lists, PES PTS and DTS, FLV composition times) at
        AVCodecParameters' offsets, pts = dts = the packet's index at
        ``fps`` (or (bytes, key, pts, dts) in frame periods), through
        av_interleaved_write_frame; ``display_matrix`` (nine integers) as
        the stream's AV_PKT_DATA_DISPLAYMATRIX side data, which the mov
        muxer writes into ``tkhd`` and the Matroska one as a
        ``Projection``'s pose."""
        c, f, a, u = self.ct, self.f, self.a, self.u
        ctx = c.c_void_p()
        assert f.avformat_alloc_output_context2(
            c.byref(ctx), None, fmt.encode() if fmt else None,
            path.encode()) >= 0, path
        st = f.avformat_new_stream(ctx, None)
        par = c.c_void_p.from_address(st + 16).value
        c.c_int.from_address(par).value = 0                 # video
        c.c_int.from_address(par + 4).value = codec_id
        c.c_int.from_address(par + 44).value = 0            # yuv420p
        c.c_int.from_address(par + 72).value = width
        c.c_int.from_address(par + 76).value = height
        c.c_int.from_address(par + 120).value = video_delay
        if display_matrix is not None:
            new = self.a.av_packet_side_data_new
            new.restype = c.c_void_p
            new.argtypes = [c.c_void_p, c.c_void_p, c.c_int, c.c_size_t,
                            c.c_int]
            sd = new(par + 32, par + 40, 5, 36, 0)   # DISPLAYMATRIX
            data = c.c_void_p.from_address(sd).value
            for k, v in enumerate(display_matrix):
                c.c_int32.from_address(data + 4 * k).value = v
        if extradata:
            buf = u.av_mallocz(len(extradata) + 64)
            c.memmove(buf, extradata, len(extradata))
            c.c_void_p.from_address(par + 16).value = buf
            c.c_int.from_address(par + 24).value = len(extradata)
        for off, v in ((32, (1, fps)), (88, (fps, 1))):     # time_base, fps
            c.c_int.from_address(st + off).value = v[0]
            c.c_int.from_address(st + off + 4).value = v[1]
        pb = ctx.value + 32
        assert f.avio_open(pb, path.encode(), 2) >= 0, path
        assert f.avformat_write_header(ctx, None) >= 0, path
        num, den = (c.c_int.from_address(st + 32).value,
                    c.c_int.from_address(st + 36).value)
        step = den // (fps * num)
        pkt = a.av_packet_alloc()
        for i, (data, key, *stamps) in enumerate(packets):
            pts, dts = stamps or (i, i)
            assert a.av_new_packet(pkt, len(data)) >= 0
            c.memmove(c.c_void_p.from_address(pkt + 24).value, data, len(data))
            c.c_int64.from_address(pkt + 8).value = pts * step
            c.c_int64.from_address(pkt + 16).value = dts * step
            c.c_int.from_address(pkt + 36).value = 0            # stream
            c.c_int.from_address(pkt + 40).value = int(key)     # flags
            c.c_int64.from_address(pkt + 64).value = step       # duration
            assert f.av_interleaved_write_frame(ctx, pkt) >= 0, (path, i)
        assert f.av_write_trailer(ctx) >= 0
        f.avio_closep(pb)
        f.avformat_free_context(ctx)

    def video_delay(self, path: str) -> int:
        """The first stream's ``video_delay`` (AVCodecParameters offset 120)
        after ``avformat_find_stream_info``: the reorder depth FFmpeg's
        probe found, which cv2's decoder starts from."""
        c, f = self.ct, self.f
        ctx = c.c_void_p()
        assert f.avformat_open_input(c.byref(ctx), path.encode(), None,
                                     None) == 0, path
        f.avformat_find_stream_info(ctx, None)
        st = c.c_void_p.from_address(
            c.c_void_p.from_address(ctx.value + 48).value).value
        delay = c.c_int.from_address(
            c.c_void_p.from_address(st + 16).value + 120).value
        f.avformat_close_input(c.byref(ctx))
        return delay

    def packets(self, path: str) -> list:
        c, f, a = self.ct, self.f, self.a
        ctx = c.c_void_p()
        assert f.avformat_open_input(c.byref(ctx), path.encode(), None,
                                     None) == 0, path
        f.avformat_find_stream_info(ctx, None)
        pkt = c.c_void_p(a.av_packet_alloc())
        out = []
        while f.av_read_frame(ctx, pkt) == 0:
            p = pkt.value
            pts = c.c_int64.from_address(p + 8).value
            data = c.c_void_p.from_address(p + 24).value
            size = c.c_int.from_address(p + 32).value
            key = bool(c.c_int.from_address(p + 40).value & 1)
            out.append((c.string_at(data, size), pts, key))
            a.av_packet_unref(p)
        a.av_packet_free(c.byref(pkt))
        f.avformat_close_input(c.byref(ctx))
        return out


# the chroma subsampling (horizontal, vertical shift) of lavc_planes' YUV
# formats
YUV_SHIFTS = {"yuv444p": (0, 0), "yuv422p": (1, 0), "yuv420p": (1, 1),
              "yuv411p": (2, 0), "yuv440p": (0, 1), "yuv410p": (2, 2),
              "yuva444p": (0, 0), "yuva422p": (1, 0), "yuva420p": (1, 1)}


def lavc_planes(f: np.ndarray, pix: str) -> list:
    """A BGR frame as the planes of libavcodec pixel format ``pix``: packed
    ``bgr0``/``bgra``/``rgb24``/``rgba`` (alpha from the red channel),
    ``gray`` (the green channel), planar ``gbrp``/``gbrap``, and the
    ``YUV_SHIFTS`` formats (cv2's BT.601 YUV, chroma taken at every
    (1 << shift)-th sample; the alpha of ``yuva*`` from the red channel);
    ``yuv420p``, ``yuva420p`` and any other format through ``bgr_i420``
    (a 10-bit format fed 8-bit rows: its samples do not matter, its header
    does)."""
    import cv2
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    if pix in ("bgr0", "bgra"):
        x = np.zeros_like(b) if pix == "bgr0" else r[:, ::-1]
        return [np.stack([b, g, r, x], 2).reshape(f.shape[0], -1)]
    if pix in ("rgb24", "rgba"):
        chans = [r, g, b] + ([b[::-1]] if pix == "rgba" else [])
        return [np.stack(chans, 2).reshape(f.shape[0], -1)]
    if pix == "gray":
        return [g]
    if pix in ("gbrp", "gbrap"):
        return [g, b, r] + ([r[:, ::-1]] if pix == "gbrap" else [])
    hs, vs = YUV_SHIFTS.get(pix, (1, 1))
    if (hs, vs) == (1, 1):
        planes = list(bgr_i420(f))
    else:
        y, cr, cb = cv2.split(cv2.cvtColor(f, cv2.COLOR_BGR2YCrCb))
        planes = [y, cb[::1 << vs, ::1 << hs], cr[::1 << vs, ::1 << hs]]
    return planes + ([r] if pix.startswith("yuva") else [])


def _cpp_bytes(name: str, source: str) -> list:
    """The integers of ``const uint8_t name[...] = {...};`` in a runtime
    source."""
    import re
    with open(os.path.join(os.path.dirname(HERE), "opticalflow_tpu_torch",
                           "runtime", source)) as f:
        body = re.search(name + r"\[\d+\] = \{(.*?)\};", f.read(), re.S)
    return [int(v) for v in body.group(1).replace("\n", " ").split(",")
            if v.strip()]


def _classic_code(shift: list, add: list) -> list:
    """(code, length) of each symbol of a HuffYUV 2.1.1 table: the lengths
    run-length coded as read_len_table reads them, the codes as given."""
    bits = "".join(f"{b:08b}" for b in shift)
    lens, pos = [], 0
    while len(lens) < 256:
        rep, val = int(bits[pos:pos + 3], 2), int(bits[pos + 3:pos + 8], 2)
        pos += 8
        if rep == 0:
            rep = int(bits[pos:pos + 8], 2)
            pos += 8
        lens += [val] * rep
    return list(zip(add, lens))


def huffyuv_classic(frames: list, kind: str) -> tuple:
    """BGR frames → (biBitCount, packets) of HuffYUV 2.1.1 without
    extradata, which FFmpeg decodes with its fixed tables (huffyuv.cpp's
    kClassic*): ``kind`` ``"yuv422_left"`` (bit count 16), ``"rgb24_left"``
    (26: left prediction, G, B-G, R-G) or ``"yuv422_plane"`` (19), each
    symbol coded as decode_slice reads it back."""
    luma = _classic_code(_cpp_bytes("kClassicShiftLuma", "huffyuv.cpp"),
                         _cpp_bytes("kClassicAddLuma", "huffyuv.cpp"))
    chroma = _classic_code(_cpp_bytes("kClassicShiftChroma", "huffyuv.cpp"),
                           _cpp_bytes("kClassicAddChroma", "huffyuv.cpp"))
    out = []
    for f in frames:
        h, w = f.shape[:2]
        bits = []

        def put(table, v):
            code, n = table[v & 255]
            bits.append(format(code, f"0{n}b"))

        if kind.startswith("yuv422"):
            y, cr, cb = (p.astype(int) for p in
                         cv2_split_ycrcb(f))
            u, v = cb[:, ::2], cr[:, ::2]
            plane = kind.endswith("plane")
            bits.append("".join(f"{x:08b}" for x in
                                (v[0, 0], y[0, 1], u[0, 0], y[0, 0])))
            ly, lu, lv = y[0, 1], u[0, 0], v[0, 0]
            for r in range(h):
                x0 = 2 if r == 0 else 0
                ry, ru, rv = y[r].copy(), u[r].copy(), v[r].copy()
                if plane and r > 0:   # the line above added after the left
                    ry, ru, rv = ry - y[r - 1], ru - u[r - 1], rv - v[r - 1]
                for x in range(x0, w, 2):
                    c = x // 2
                    put(luma, ry[x] - ly)
                    ly = ry[x]
                    put(chroma, ru[c] - lu)
                    lu = ru[c]
                    put(luma, ry[x + 1] - ly)
                    ly = ry[x + 1]
                    put(chroma, rv[c] - lv)
                    lv = rv[c]
        else:
            bgr = f.astype(int)
            last = bgr[h - 1, 0]
            bits.append("".join(f"{x:08b}" for x in
                                (last[2], last[1], last[0], 0)))
            left = last.copy()
            for r in range(h - 1, -1, -1):
                for x in range(1 if r == h - 1 else 0, w):
                    d = (bgr[r, x] - left) & 255
                    left = bgr[r, x]
                    put(luma, d[1])
                    put(luma, d[0] - d[1])
                    put(luma, d[2] - d[1])
        stream = "".join(bits)
        stream += "0" * (-len(stream) % 32)
        words = int(stream, 2).to_bytes(len(stream) // 8, "big")
        out.append(b"".join(words[i:i + 4][::-1]
                            for i in range(0, len(words), 4)))
    bpc = {"yuv422_left": 16, "yuv422_plane": 19, "rgb24_left": 26}[kind]
    return bpc, out


def cv2_split_ycrcb(f: np.ndarray) -> tuple:
    """cv2's BT.601 Y, Cr, Cb planes of a BGR frame."""
    import cv2
    return cv2.split(cv2.cvtColor(f, cv2.COLOR_BGR2YCrCb))


def _ts_bytes(prefix: int, t: int) -> bytes:
    return bytes((prefix << 4 | (t >> 29 & 0xE) | 1, t >> 22 & 0xFF,
                  (t >> 14 & 0xFE) | 1, t >> 7 & 0xFF, (t << 1 & 0xFE) | 1))


def ps_mux(path: str, packets: list, fps: int = 25) -> None:
    """(packet, pts, dts) in frames → an MPEG-2 program stream: a pack
    header and a PES packet with PTS and DTS for each picture (continued in
    PES packets without timestamps past 64 KiB), then the end code."""
    tick = 90000 // fps
    out = bytearray()
    for data, pts, dts in packets:
        p, d = 45000 + pts * tick, 45000 + dts * tick
        scr = max(d - 9000, 0)
        out += (b"\x00\x00\x01\xba" + bytes((
            0x44 | (scr >> 27 & 0x38) | (scr >> 28 & 3), scr >> 20 & 0xFF,
            (scr >> 12 & 0xF8) | 4 | (scr >> 13 & 3), scr >> 5 & 0xFF,
            (scr << 3 & 0xF8) | 4, 1, 1, 0x89, 0xC3, 0xF8)))
        first = True
        for k in range(0, len(data), 60000):
            chunk = data[k:k + 60000]
            head = (bytes((0x81, 0xC0, 10)) + _ts_bytes(3, p) +
                    _ts_bytes(1, d) if first and p != d else
                    bytes((0x81, 0x80, 5)) + _ts_bytes(2, p) if first else
                    bytes((0x81, 0, 0)))
            out += (b"\x00\x00\x01\xe0" + struct.pack(">H", len(head) +
                                                      len(chunk))
                    + head + chunk)
            first = False
    out += b"\x00\x00\x01\xb9"
    with open(path, "wb") as f:
        f.write(bytes(out))


def ps_head(src: str, dst: str, n: int) -> None:
    """The first ``n`` pictures (decode order) of the program stream
    ``src`` remuxed by ``ps_mux``, each PES packet stamped with its
    picture's PTS alone.  cv2's muxer starts a picture in a PES packet
    stamped with an earlier picture's DTS, so a seek near the start of
    its file lands past the first GOP (and reads nothing); here each seek
    reads the frame asked for, and a shuffled reader such as the pseudo
    regime's can read the clip."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    v = EncodedVideo(src)
    with open(src, "rb") as f:
        ps_mux(dst, [(v.box.sample(f, i), v.display[i], v.display[i])
                     for i in range(n)])


def _bits(data: bytes) -> str:
    return "".join(f"{b:08b}" for b in data)


def _bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _matrix_bits(m: np.ndarray) -> str:
    """A quantiser matrix (raster order) as the stream holds it: 64 bytes
    in zigzag order."""
    zz = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
          33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56,
          57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38,
          31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    flat = np.asarray(m, np.uint8).reshape(64)
    return "".join(f"{flat[z]:08b}" for z in zz)


# custom matrices for the rewritten headers: small steps at low
# frequencies (an MPEG-1 intra step under 8 dequantises a level 1 to 0, which
# FFmpeg's oddification turns into -1)
MATRIX_INTRA = np.add.outer(np.arange(8), np.arange(8)) * 3 + 4
MATRIX_INTRA[0, 0] = 8
MATRIX_INTER = 12 + np.add.outer(np.arange(8), 2 * np.arange(8))
MATRIX_CHROMA_INTRA = 40 - np.add.outer(np.arange(8), np.arange(8)) * 2
MATRIX_CHROMA_INTER = 20 + np.add.outer(2 * np.arange(8), np.arange(8))


def with_matrices(packet: bytes) -> bytes:
    """Every sequence header of ``packet`` with MATRIX_INTRA and
    MATRIX_INTER loaded (both load flags were 0: an 8-byte body)."""
    out, pos = bytearray(), 0
    while True:
        i = packet.find(b"\x00\x00\x01\xb3", pos)
        if i < 0:
            return bytes(out + packet[pos:])
        body = packet[i + 4:i + 12]
        bits = _bits(body)
        assert bits[62:64] == "00", "the sequence header loads a matrix"
        new = (bits[:62] + "1" + _matrix_bits(MATRIX_INTRA) + "1"
               + _matrix_bits(MATRIX_INTER))
        out += packet[pos:i + 4] + _bytes(new)
        pos = i + 12


def with_quant_extension(packet: bytes) -> bytes:
    """A quant matrix extension (all four matrices, the chroma ones apart)
    after ``packet``'s picture coding extension."""
    i = next((k for k in range(len(packet) - 4)
              if packet[k:k + 4] == b"\x00\x00\x01\xb5"
              and packet[k + 4] >> 4 == 8), -1)
    assert i >= 0
    j = packet.find(b"\x00\x00\x01", i + 4)
    ext = b"\x00\x00\x01\xb5" + _bytes(
        "0011" + "1" + _matrix_bits(MATRIX_INTRA) + "1"
        + _matrix_bits(MATRIX_INTER) + "1" + _matrix_bits(MATRIX_CHROMA_INTRA)
        + "1" + _matrix_bits(MATRIX_CHROMA_INTER))
    return packet[:j] + ext + packet[j:]


def with_alternate_scan(packet: bytes) -> bytes:
    """``packet`` with its picture coding extension's alternate_scan set
    (cv2's encoder turns the sequence interlaced when asked for it)."""
    i = next(k for k in range(len(packet) - 4)
             if packet[k:k + 4] == b"\x00\x00\x01\xb5"
             and packet[k + 4] >> 4 == 8)
    b = bytearray(packet)
    b[i + 7] |= 0x04
    return bytes(b)


def with_gop_flags(packet: bytes, closed=None, broken=None) -> bytes:
    """``packet``'s GOP header with closed_gop / broken_link set."""
    i = packet.find(b"\x00\x00\x01\xb8")
    if i < 0:
        return packet
    b = bytearray(packet)
    for bit, val in ((0x40, closed), (0x20, broken)):
        if val is not None:
            b[i + 7] = b[i + 7] | bit if val else b[i + 7] & ~bit
    return bytes(b)


def patch_mpeg12_size(src: str, dst: str, w: int, h: int) -> None:
    """Copy ``src`` with every sequence header's 12-bit width and height
    set to ``w``x``h`` (the same macroblock grid: a crop)."""
    data = bytearray(open(src, "rb").read())
    i = data.find(b"\x00\x00\x01\xb3")
    n = 0
    while i >= 0:
        data[i + 4:i + 7] = bytes((w >> 4, (w & 15) << 4 | h >> 8, h & 255))
        n += 1
        i = data.find(b"\x00\x00\x01\xb3", i + 4)
    assert n
    open(dst, "wb").write(bytes(data))


def _mpeg12_features(path: str) -> tuple:
    """(the port's decoder's features over the file, what it refuses or
    None)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    from opticalflow_tpu_torch.runtime.mpeg4 import Unsupported
    v = EncodedVideo(path)
    dec = v._decoder()
    try:
        with open(path, "rb") as f:
            for i in range(v.samples):
                dec.decode(v.box.sample(f, i))
    except Unsupported as e:
        return dec.features, str(e).split(": ", 1)[1]
    return dec.features, None


def _h263_features(path: str) -> tuple:
    """(the port's H.263 decoder's features over the file, what it refuses
    or None)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    from opticalflow_tpu_torch.runtime.mpeg4 import Unsupported
    v = EncodedVideo(path)
    dec = v._decoder()
    try:
        with open(path, "rb") as f:
            for i in range(v.samples):
                dec.decode(v.box.sample(f, i))
    except Unsupported as e:
        return dec.features, str(e).split(": ", 1)[1]
    return dec.features, None


def _cv2_seek_frame(path: str, t: int) -> np.ndarray:
    """The frame a CAP_PROP_POS_FRAMES seek to ``t`` reads."""
    import cv2
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, t)
    ok, f = cap.read()
    cap.release()
    assert ok, (path, t)
    return f


def _cv2_seeks(path: str, frames: list) -> dict:
    """{index: the decoded frame (its index in ``frames``) a
    CAP_PROP_POS_FRAMES seek to it reads, or None}, for every index."""
    import cv2
    out = {}
    for t in range(len(frames)):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, t)
        ok, f = cap.read()
        cap.release()
        hits = [i for i, g in enumerate(frames) if ok and
                np.array_equal(f, g)]
        out[str(t)] = hits[0] if hits else (None if not ok else -1)
    return out


def mpeg12_fixtures() -> None:
    """The MPEG-1/2 files: cv2's writer (fourccs PIM1 and MPG2) in four
    containers, size patches, the Sintel clip; libavcodec's encoder with
    the tools cv2's writer leaves off, and rewritten headers, muxed by
    ``ps_mux``."""
    moving = moving_clip(144, 176, 40)
    for fcc, name in (("PIM1", "mpeg1"), ("MPG2", "mpeg2")):
        for ext in ("mpg", "avi", "mkv", "mp4"):
            _cv2_write(os.path.join(OUT, f"{name}_176x144.{ext}"), moving,
                       fcc)
        mpg = os.path.join(OUT, f"{name}_176x144.mpg")
        patch_mpeg12_size(mpg, os.path.join(OUT, f"{name}_175x143.mpg"),
                          175, 143)
    small = os.path.join(OUT, "mpeg2_53x37.mpg")
    _cv2_write(small, moving_clip(37, 53, 26, seed=1, speed=5.0), "MPG2")
    patch_mpeg12_size(small, small, 53, 37)
    _cv2_write(os.path.join(OUT, "mpeg2_still_64x48.mpg"),
               moving_clip(48, 64, 1, seed=3) * 14, "MPG2")
    # runs of more than 33 skipped macroblocks: the address escape
    _cv2_write(os.path.join(OUT, "mpeg1_still_176x144.mpg"),
               moving_clip(144, 176, 1, seed=3) * 5, "PIM1")
    im1, im2 = sintel_pair()
    sintel = os.path.join(OUT, "mpeg2_sintel_436x1024.mpg")
    _cv2_write(sintel, [im1 if i % 2 == 0 else im2 for i in range(13)],
               "MPG2")
    ps_head(sintel, os.path.join(OUT, "mpeg2_sintel_head_436x1024.mpg"), 10)
    lavc = Lavc()
    planes = [bgr_i420(f) for f in moving_clip(144, 176, 13, seed=9,
                                               speed=3.0)]
    pk = lavc.encode(planes, intra_vlc=1, non_linear_quant=1, qmax=28,
                     intra_dc_precision=2, colorspace="bt709",
                     seq_disp_ext="always", flags="+cgop",
                     sc_threshold=1000000000, scplx_mask=0.5)
    pk = [(with_alternate_scan(with_gop_flags(with_matrices(p),
                                              broken=True)), t, d)
          for p, t, d in pk]
    pk = [(with_quant_extension(p) if i % 3 == 1 else p, t, d)
          for i, (p, t, d) in enumerate(pk)]
    ps_mux(os.path.join(OUT, "mpeg2_tools.mpg"), pk)
    # the encoder's alternate scan comes with interlaced frames, which
    # swscale will not convert for cv2 and the port refuses
    ps_mux(os.path.join(OUT, "mpeg2_interlaced.mpg"),
           lavc.encode(planes[:4], alternate_scan=1))
    for prec in (1, 3):
        ps_mux(os.path.join(OUT, f"mpeg2_dc{8 + prec}.mpg"),
               lavc.encode(planes[:7], intra_dc_precision=prec))
    pk = lavc.encode(planes, codec="mpeg1video", qmin=1, qmax=1)
    ps_mux(os.path.join(OUT, "mpeg1_matrices.mpg"),
           [(with_matrices(p), t, d) for p, t, d in pk])
    ps_mux(os.path.join(OUT, "mpeg2_low_delay.mpg"),
           lavc.encode(planes[:7], bf=0, flags="+low_delay"))


# ------------------------------------------------------------------ H.263

def objects_clip(h: int, w: int, n: int, seed: int = 5) -> list:
    """n BGR frames: three blurred-noise patches moving each its own way
    over a still background (skipped macroblocks, 8x8 vectors at their
    edges)."""
    import cv2
    rng = np.random.default_rng(seed)
    bg = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8), (0, 0), 2)
    obj = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8), (0, 0),
                           1.5)
    out = []
    for t in range(n):
        f = bg.copy()
        for k, (y0, x0, sh, sw, vy, vx) in enumerate((
                (20, 10, 40, 50, 1.5, 2.5), (70, 90, 50, 60, -1.0, -3.5),
                (30, 120, 24, 24, 3.0, -1.0))):
            y = int(y0 + vy * t) % (h - sh)
            x = int(x0 + vx * t) % (w - sw)
            f[y:y + sh, x:x + sw] = obj[k * 10:k * 10 + sh, k * 20:k * 20 + sw]
        out.append(f)
    return out


def with_psupp(packet: bytes, psupp: bytes = b"PSUPP-8b") -> bytes:
    """An H.263 picture with ``psupp`` (8 bytes, which keeps the rest of the
    picture byte-aligned) in its header, PEI set before each byte; an
    I-picture's first macroblock behind 8 MCBPC stuffing codes (72 bits)."""
    bits = _bits(packet)
    assert bits[:22] == "0" * 16 + "100000" and bits[49] == "0"
    extra = "".join("1" + f"{b:08b}" for b in psupp)
    stuffing = "000000001" * 8 if bits[38] == "0" else ""
    return _bytes(bits[:49] + extra + bits[49] + stuffing + bits[50:])


def h263_avi(path: str, parts: list, psupp: bool = False,
             codec: str = "h263", fps: int = 25, **opts) -> list:
    """Lists of BGR frames → one AVI (fourcc ``H263``) of libavcodec's
    ``codec`` (``h263``, or ``h263p`` for H.263+) streams one after another
    (a part of another size changes the picture size), encoded at a time
    base of 1/``fps``; keyframes flagged at the I-pictures.  Returns the
    packets."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.avi import AviWriter
    from opticalflow_tpu_torch.runtime.h263 import is_intra
    lavc = Lavc()
    h, w = parts[0][0].shape[:2]
    rate = tuple(int(x) for x in str(fps).split("/")) if "/" in str(fps) \
        else (fps, 1)
    mux = AviWriter(path, (w, h), rate, fourcc="H263")
    out = []
    for frames in parts:
        for data, _, _ in lavc.encode([bgr_i420(f) for f in frames],
                                      codec=codec, fps=fps, **opts):
            data = with_psupp(data) if psupp else data
            mux.write(data, is_intra(data))
            out.append(data)
    mux.release()
    return out


def h263_fixtures() -> None:
    """The H.263 files: cv2's writer (fourccs H263 and s263) at three sizes
    and in four containers; libavcodec's encoder for the Sintel clip at
    4CIF, advanced prediction (Annex F), 8x8 vectors with DQUANT, GOB
    headers (with PSUPP bytes in every picture header) and a size change;
    and MPEG-4 Part 2 in .3gp."""
    for w, h in ((128, 96), (176, 144), (352, 288)):
        _cv2_write(os.path.join(OUT, f"h263_{w}x{h}.avi"),
                   moving_clip(h, w, 14, seed=21), "H263")
    moving = moving_clip(144, 176, 14, seed=22)
    _cv2_write(os.path.join(OUT, "h263_176x144.3gp"), moving, "s263")
    for ext in ("mov", "mkv"):
        _cv2_write(os.path.join(OUT, f"h263_176x144.{ext}"), moving, "H263")
    _cv2_write(os.path.join(OUT, "mpeg4_176x144.3gp"), moving, "mp4v")
    # (libavcodec at 1 Mb/s: cv2's writer makes 600 KB of it)
    im1, im2 = (cv2_resize(im, 704, 576) for im in sintel_pair())
    h263_avi(os.path.join(OUT, "h263_sintel_704x576.avi"),
             [[im1 if i % 2 == 0 else im2 for i in range(13)]], b=1000000)
    objects = objects_clip(144, 176, 14)
    h263_avi(os.path.join(OUT, "h263_obmc_176x144.avi"), [objects], obmc=1,
             flags="+mv4", b=200000, scplx_mask=0.5, lumi_mask=0.3)
    h263_avi(os.path.join(OUT, "h263_mv4_176x144.avi"), [objects],
             flags="+mv4", b=150000, scplx_mask=0.8, p_mask=0.5)
    h263_avi(os.path.join(OUT, "h263_gob_352x288.avi"),
             [objects_clip(288, 352, 8, seed=23)], psupp=True, ps=400,
             b=400000)
    h263_avi(os.path.join(OUT, "h263_resize.avi"),
             [moving[:7], [cv2_resize(f, 128, 96) for f in moving[7:]]])


# ----------------------------------------------------------------- H.263+

def _vlc_codes(name: str, source: str) -> dict:
    """{bit string: index} of a ``Code`` table in a runtime source."""
    v = _cpp_table(name, source)
    return {format(c, f"0{n}b"): i for i, (c, n) in
            enumerate(zip(v[::2], v[1::2])) if n}


def _read_vlc(bits: str, pos: int, codes: dict) -> tuple:
    for n in range(1, 14):
        if bits[pos:pos + n] in codes:
            return codes[bits[pos:pos + n]], pos + n
    raise ValueError(f"no code at bit {pos}")


def _plus_header_end(bits: str) -> tuple:
    """(the bit after an H.263+ I-picture header as libavcodec's h263p
    writes it, with UFEP 1 and no slices; the OPPTYPE flags)"""
    pos = 22 + 8 + 5
    assert bits[pos:pos + 3] == "111" and bits[pos + 3:pos + 6] == "001"
    fmt = int(bits[pos + 6:pos + 9], 2)
    flags = bits[pos + 9:pos + 20]
    pcf, umv, ss = flags[0] == "1", flags[1] == "1", flags[6] == "1"
    pos += 6 + 18 + 9 + 1
    if fmt == 6:
        pos += 4 + 9 + 1 + 9 + (16 if bits[pos:pos + 4] == "1111" else 0)
    if pcf:
        pos += 8 + 2
    if umv:
        pos += 1 if bits[pos] == "1" else 2
    if ss:
        pos += 2
    assert not ss, "slice-structured headers are not walked"
    pos += 5
    while bits[pos] == "1":     # PEI, PSUPP
        pos += 9
    return pos + 1, flags


def rewrite_aic_intra(packet: bytes, mbs: int) -> bytes:
    """An Annex I I-picture of libavcodec's h263p with two fields rewritten
    macroblock by macroblock: INTRA_MODE (the encoder writes 0, DC
    prediction only) to 0, 10 (AC prediction from above, the alternate
    horizontal scan) and 11 (from the left, the vertical scan), the same
    levels read with AC prediction and another scan; and DQUANT, which the
    encoder writes in the baseline's 2-bit code although Annex T is on
    (FFmpeg's decoder misreads it), to Annex T's code for the same QUANT:
    its table's two codes where one reaches it, else every other time the
    5-bit value.  ``mbs``: the picture's macroblocks (one slice)."""
    mcbpc = _vlc_codes("kIntraMcbpc", "mpeg_common.h")
    cbpy = _vlc_codes("kCbpy", "mpeg_common.h")
    tcoef = _vlc_codes("kAicTcoef", "h263.cpp")
    table = np.array(_cpp_table("kModifiedQuant", "h263.cpp")).reshape(2, 32)
    bits = _bits(packet)
    pos, flags = _plus_header_end(bits)
    assert flags[4] == "1" and flags[10] == "1", "Annexes I and T"
    q = int(bits[pos - 6:pos - 1], 2)      # PQUANT (no PSUPP here)
    out = [bits[:pos]]
    for k in range(mbs):
        start = pos
        while True:
            c, pos = _read_vlc(bits, pos, mcbpc)
            if c != 8:
                break
        assert bits[pos] == "0"
        out.append(bits[start:pos] + ("0", "10", "11")[k % 3])
        start = pos = pos + 1
        y, pos = _read_vlc(bits, pos, cbpy)
        out.append(bits[start:pos])
        if c & 4:
            prev = q
            q = min(max(q + (-1, -2, 1, 2)[int(bits[pos:pos + 2], 2)], 1), 31)
            pos += 2
            short = [b for b in (0, 1) if table[b][prev] == q]
            out.append("1" + str(short[0]) if short and k % 2 else
                       "0" + format(q, "05b"))
        start = pos
        cbp = (c & 3) | y << 2
        for n in range(6):
            if not cbp >> (5 - n) & 1:
                continue
            while True:
                i, pos = _read_vlc(bits, pos, tcoef)
                if i == 102:
                    last = bits[pos] == "1"
                    pos += 1 + 6 + 8 + (11 if bits[pos + 7:pos + 15]
                                        == "10000000" else 0)
                else:
                    last = i >= 58
                    pos += 1
                if last:
                    break
        out.append(bits[start:pos])
    out.append(bits[pos:])
    return _bytes("".join(out))


def _bih(w: int, h: int, fourcc: bytes) -> bytes:
    """A BITMAPINFOHEADER (Matroska's V_MS/VFW/FOURCC CodecPrivate)."""
    return struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3,
                       0, 0, 0, 0)


def _box_tree(data: bytes, path: list, new: bytes) -> bytes:
    """ISO BMFF boxes ``data`` with the box at ``path`` (types, from the
    top) replaced by ``new``, the sizes of its parents mended."""
    out, at = b"", 0
    while at < len(data):
        size, kind = struct.unpack(">I4s", data[at:at + 8])
        box = data[at:at + size]
        if kind == path[0]:
            if len(path) == 1:
                box = new
            else:
                skip = 16 if kind == b"stsd" else 8
                body = _box_tree(box[skip:], path[1:], new)
                box = struct.pack(">I", skip + len(body)) + box[4:skip] + body
        out += box
        at += size
    return out


def s263_3gp(path: str, packets: list, w: int, h: int, fps: int = 25) -> None:
    """H.263 packets → a .3gp: the port's ISO BMFF writer with its sample
    entry an ``s263`` with a ``d263`` box, as FFmpeg's mov muxer writes
    H.263 into 3GP."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.mp4 import Mp4Writer
    from opticalflow_tpu_torch.runtime.h263 import is_intra
    mux = Mp4Writer(path, (w, h), (fps, 1), b"")
    for data in packets:
        mux.write(data, is_intra(data))
    mux.release()
    d263 = struct.pack(">I4s4sBBB", 15, b"d263", b"FFMP", 0, 10, 0)
    entry = (b"s263" + b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16
             + struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1)
             + b"\0" * 32 + struct.pack(">Hh", 0x18, -1) + d263)
    entry = struct.pack(">I", 4 + len(entry)) + entry
    data = open(path, "rb").read()
    at = data.rfind(b"moov") - 4
    moov = _box_tree(data[at:], [b"moov", b"trak", b"mdia", b"minf", b"stbl",
                                 b"stsd", b"mp4v"], entry)
    with open(path, "wb") as f:
        f.write(data[:at] + moov)


def h263p_fixtures() -> None:
    """The H.263+ files: libavcodec's ``h263p`` encoder (PLUSPTYPE
    headers; P-pictures alternate the rounding type), each annex alone
    and combined at 176x144 and 352x288 — Annex D (``umv``), F (``obmc``
    with ``+mv4``), I with T (``+aic``; the encoder writes INTRA_MODE 0
    only, and DQUANT in a code Annex T does not have, so an intra-only
    stream has both rewritten: ``rewrite_aic_intra``), J (``+loop``), K
    (``structured_slices`` with ``ps``), S (``aiv``); custom formats (100x60, 320x240 and the Sintel pair at
    436x1024) and clocks (1/25; 1001/30000 is the standard clock); a size
    change; in AVI (``H263``), raw ``.h263``, Matroska (V_MS/VFW/FOURCC)
    and 3GP (``s263``)."""
    objects = objects_clip(144, 176, 14)
    cif = objects_clip(288, 352, 8, seed=23)
    low = dict(b=120000)
    out = lambda n: os.path.join(OUT, n)  # noqa: E731
    plain = h263_avi(out("h263_plus_176x144.avi"), [objects], codec="h263p",
                     fps="30000/1001", **low)
    for name, frames, opts in (
            ("umv", objects, dict(umv=1)),
            ("aiv", objects, dict(aiv=1, b=120000)),
            ("loop", objects, dict(flags="+loop", b=100000)),
            ("obmc", objects, dict(obmc=1, flags="+mv4")),
            ("aic", objects, dict(flags="+aic")),
            ("umv_aiv", objects, dict(umv=1, aiv=1)),
            ("aic_loop_ss_obmc", objects, dict(flags="+aic+loop",
                                               structured_slices=1, obmc=1)),
            ("slices_352x288", cif, dict(structured_slices=1, ps=400)),
            ("aic_352x288", cif, dict(flags="+aic", b=300000)),
            ("all_352x288", cif, dict(structured_slices=1, ps=400, umv=1,
                                      aiv=1, obmc=1, flags="+aic+loop+mv4",
                                      b=400000))):
        size = "" if "x" in name else "_176x144"
        h263_avi(out(f"h263_plus_{name}{size}.avi"), [frames[:10]],
                 codec="h263p", **{**low, **opts})
    h263_avi(out("h263_plus_100x60.avi"), [moving_clip(60, 100, 14, seed=24)],
             codec="h263p", umv=1, flags="+aic+loop", b=100000)
    h263_avi(out("h263_plus_320x240.avi"), [moving_clip(240, 320, 8,
                                                         seed=25)],
             codec="h263p", flags="+aic", b=300000)
    h263_avi(out("h263_plus_resize.avi"),
             [objects[:7], [cv2_resize(f, 128, 96) for f in objects[7:]]],
             codec="h263p", flags="+aic+loop", **low)
    # Annex I's AC prediction and Annex T's DQUANT: I-pictures alone
    # (adaptive quantisation), INTRA_MODE and DQUANT rewritten
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.avi import AviWriter
    from opticalflow_tpu_torch.runtime.h263 import is_intra
    mux = AviWriter(out("h263_plus_aic_intra_176x144.avi"), (176, 144),
                    (25, 1), fourcc="H263")
    for data, _, _ in Lavc().encode([bgr_i420(f) for f in objects[:6]],
                                    codec="h263p", flags="+aic", g=1,
                                    scplx_mask=0.5, lumi_mask=0.3, b=400000):
        mux.write(rewrite_aic_intra(data, 99), True)
    mux.release()
    # containers
    with open(out("h263_plus_176x144.h263"), "wb") as f:
        f.write(b"".join(plain))
    _webm(out("h263_plus_176x144.mkv"), [(p, is_intra(p)) for p in plain],
          176, 144, codec=b"V_MS/VFW/FOURCC", private=_bih(176, 144, b"H263"),
          doctype=b"matroska")
    s263_3gp(out("h263_plus_176x144.3gp"), plain, 176, 144)
    # the Sintel pair for the card (13 pictures, the pair alternating)
    im1, im2 = sintel_pair()
    h263_avi(out("h263_plus_sintel_436x1024.avi"),
             [[im1 if i % 2 == 0 else im2 for i in range(13)]],
             codec="h263p", umv=1, flags="+aic+loop", b=300000, qmin=8)


# -------------------------------------- transport, elementary streams, FFV1

def _crc32_mpeg(data: bytes) -> int:
    """The CRC-32 of MPEG-2 sections (polynomial 0x04C11DB7, MSB first)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = (crc << 1 ^ (0x04C11DB7 if crc & 0x80000000 else 0)
                   ) & 0xFFFFFFFF
    return crc


def psi_section(table_id: int, ext: int, body: bytes) -> bytes:
    """A PSI section (PAT, PMT) with its header and CRC."""
    n = 5 + len(body) + 4
    sec = bytes((table_id, 0xB0 | n >> 8, n & 0xFF, ext >> 8, ext & 0xFF,
                 0xC1, 0, 0)) + body
    return sec + struct.pack(">I", _crc32_mpeg(sec))


def ts_mux(path: str, packets: list, stream_type: int = 2, fps: int = 25,
           split=(), gaps=(), bounded: bool = False, m2ts: bool = False,
           pts_only: bool = False) -> None:
    """(packet, pts, dts) in frames → an MPEG transport stream (PAT, a PMT
    on PID 0x1000, the video on PID 0x100, stuffing in adaptation fields):
    the pictures whose index is in ``split`` go in two PES packets, the
    second without timestamps and starting in the middle of the picture;
    the video packets whose number is in ``gaps`` jump their continuity
    counter by 3 (their bytes kept); ``bounded`` writes each PES packet's
    length (else 0, unbounded, as FFmpeg's muxer writes video); ``m2ts``
    puts a 4-byte arrival timestamp before each packet (192-byte packets);
    ``pts_only`` stamps every picture with its PTS alone (DTS = PTS, as
    some muxers and broadcast captures write it)."""
    tick = 90000 // fps
    cc: dict = {}
    out = bytearray()

    def packet(pid, payload, start):
        c = cc.get(pid, 0)
        cc[pid] = (c + 1) & 15
        hdr = bytes((0x47, (0x40 if start else 0) | pid >> 8, pid & 0xFF,
                     (0x30 if len(payload) < 184 else 0x10) | c))
        if len(payload) < 184:
            room = 183 - len(payload)
            hdr += bytes((room,)) + (b"\x00" + b"\xff" * (room - 1)
                                     if room else b"")
        if m2ts:
            out.extend(struct.pack(">I", (len(out) // 192 * 1200) & 0x3FFFFFFF))
        out.extend(hdr + payload)

    pat = psi_section(0, 1, struct.pack(">HH", 1, 0xF000))
    pmt = psi_section(2, 1, struct.pack(">HH", 0xE100, 0xF000)
                      + bytes((stream_type,)) + struct.pack(">HH", 0xE100,
                                                            0xF000))
    for pid, sec in ((0, pat), (0x1000, pmt)):
        packet(pid, b"\x00" + sec + b"\xff" * (183 - len(sec)), True)
    count = 0
    for k, (data, pts, dts) in enumerate(packets):
        p, d = 126000 + pts * tick, 126000 + dts * tick
        d = p if pts_only else d
        parts = ([data[:len(data) // 2], data[len(data) // 2:]]
                 if k in split else [data])
        for j, part in enumerate(parts):
            head = (bytes((0x81, 0xC0, 10)) + _ts_bytes(3, p) +
                    _ts_bytes(1, d) if j == 0 and p != d else
                    bytes((0x81, 0x80, 5)) + _ts_bytes(2, p) if j == 0 else
                    bytes((0x81, 0, 0)))
            n = len(head) + len(part) if bounded else 0
            pes = (b"\x00\x00\x01\xe0" + struct.pack(">H", n) + head
                   + part)
            for at in range(0, len(pes), 184):
                count += 1
                if count in gaps:
                    cc[0x100] = (cc.get(0x100, 0) + 3) & 15
                packet(0x100, pes[at:at + 184], at == 0)
    with open(path, "wb") as f:
        f.write(bytes(out))


def _ffv1_features(path: str) -> tuple:
    """(the port's FFV1 decoder's features over the file, what it refuses
    or None)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    from opticalflow_tpu_torch.runtime.mpeg4 import Unsupported
    v = EncodedVideo(path)
    dec = v._decoder()
    try:
        with open(path, "rb") as f:
            for i in range(v.samples):
                dec.decode(v.box.sample(f, i))
    except Unsupported as e:
        return dec.features, str(e).split(": ", 1)[1]
    return dec.features, None


LOSSLESS = ("hfyu_", "ffvh_", "ut_", "png_", "raw_", "mjpg_96x64")


def _lossless_features(path: str) -> list:
    """The port's HuffYUV, Ut Video, MagicYUV, ASV or MS-MPEG4/WMV
    decoder's features over the file."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    v = EncodedVideo(path)
    dec = v._decoder()
    with open(path, "rb") as f:
        for i in range(v.samples):
            dec.decode(v.box.sample(f, i))
    return dec.features


def stream_fixtures() -> None:
    """This slice's files: MPEG transport streams (cv2's writer in .ts,
    .m2ts and .mts; libavcodec's low-delay MPEG-2 of the Sintel pair,
    MPEG-2 with split PES packets and
    continuity gaps, MPEG-1 under stream type 0x01 in bounded PES packets,
    both muxed by ``ts_mux``; H.263 and FFV1 muxed as private data, which
    neither cv2 nor the port reads), elementary streams (.m1v, .m2v, .mpv,
    .h263, .263; a constant-bit-rate .m2v from libavcodec), MPEG-4 Part 2
    in a program stream, and FFV1 (cv2's writer in four containers, colour
    and grey; libavcodec's versions 0-3, range coders, slice counts,
    4:2:0, alpha and odd sizes in Matroska)."""
    moving = moving_clip(144, 176, 30, seed=12)
    for ext in ("ts", "m2ts", "mts"):
        _cv2_write(os.path.join(OUT, f"mpeg2_176x144.{ext}"),
                   moving if ext != "mts" else moving[:14], "MPG2")
    _cv2_write(os.path.join(OUT, "mpeg1_176x144.ts"), moving, "PIM1")
    _cv2_write(os.path.join(OUT, "mpeg4_176x144.ts"), moving, "mp4v")
    _cv2_write(os.path.join(OUT, "mpeg4_176x144.mpg"), moving, "mp4v")
    im1, im2 = sintel_pair()
    sintel = [im1 if i % 2 == 0 else im2 for i in range(13)]
    _cv2_write(os.path.join(OUT, "mpeg2_sintel_436x1024.ts"), sintel, "MPG2")
    lavc = Lavc()
    # cv2's MPEG-2 .ts lands a picture late on any seek (its I-picture's DTS
    # is before the start time) and reads nothing after a seek into the
    # Sintel one; a low-delay stream (no B-pictures, DTS = PTS) seeks
    # exactly: what the card run's pseudo regime trains on
    ts_mux(os.path.join(OUT, "mpeg2_sintel_low_delay_436x1024.ts"),
           lavc.encode([bgr_i420(f) for f in sintel[:10]], bf=0,
                       flags="+low_delay"))
    planes = [bgr_i420(f) for f in moving_clip(144, 176, 26, seed=13,
                                               speed=3.0)]
    ts_mux(os.path.join(OUT, "mpeg2_split_gaps_176x144.ts"),
           lavc.encode(planes), split=set(range(0, 26, 3)),
           gaps={4, 9, 31, 32, 70})
    ts_mux(os.path.join(OUT, "mpeg1_type1_176x144.ts"),
           lavc.encode(planes[:14], codec="mpeg1video"), stream_type=1,
           bounded=True)
    small = moving_clip(96, 128, 8, seed=14)
    _cv2_write(os.path.join(OUT, "ts_h263_128x96.ts"), small, "H263")
    _cv2_write(os.path.join(OUT, "ts_ffv1_48x32.ts"),
               moving_clip(32, 48, 3, seed=14), "FFV1")
    # elementary streams
    _cv2_write(os.path.join(OUT, "mpeg2_176x144.m2v"), moving, "MPG2")
    _cv2_write(os.path.join(OUT, "mpeg1_176x144.m1v"), moving, "PIM1")
    _cv2_write(os.path.join(OUT, "h263_176x144.h263"), moving, "H263")
    # cv2 picks the raw muxer by .m2v and .h263 alone: renamed after
    for name, ext, frames, fcc in (
            ("mpeg2_64x48.mpv", ".m2v", moving_clip(48, 64, 14, seed=15),
             "MPG2"), ("h263_128x96.263", ".h263", small, "H263")):
        tmp = os.path.join(OUT, name + ext)
        _cv2_write(tmp, frames, fcc)
        os.replace(tmp, os.path.join(OUT, name))
    cbr = lavc.encode([bgr_i420(f) for f in moving_clip(144, 176, 7,
                                                         seed=16)],
                      maxrate=1000000, minrate=1000000, bufsize=400000)
    with open(os.path.join(OUT, "mpeg2_cbr_176x144.m2v"), "wb") as f:
        f.write(b"".join(p for p, _, _ in cbr))
    # FFV1
    clip = moving_clip(32, 48, 14, seed=11)
    for ext in ("mkv", "avi", "mp4", "mov"):
        _cv2_write(os.path.join(OUT, f"ffv1_48x32.{ext}"), clip, "FFV1")
    _cv2_write(os.path.join(OUT, "ffv1_grey_48x32.mkv"),
               [f[..., 1].copy() for f in clip], "FFV1", color=False)
    _cv2_write(os.path.join(OUT, "ffv1_sintel_436x1024.mkv"), sintel[:3],
               "FFV1")
    tiny = moving_clip(24, 32, 14, seed=17)
    odd = moving_clip(37, 53, 4, seed=18)
    for name, frames, opts in (
            ("ffv1_range_32x24", tiny, dict(coder=1, slices=6, context=1)),
            ("ffv1_range_default_32x24", tiny, dict(coder=-2)),
            ("ffv1_slices12_48x32", clip, dict(coder=0, slices=12)),
            ("ffv1_v0_yuv420_32x24", tiny, dict(pix="yuv420p", level=0,
                                                coder=0)),
            ("ffv1_v1_32x24", tiny, dict(level=1, coder=2)),
            ("ffv1_v2_yuv420_32x24", tiny, dict(pix="yuv420p", level=2,
                                                coder=1, strict=-2)),
            ("ffv1_grey_range_32x24", tiny, dict(pix="gray", coder=1)),
            ("ffv1_yuva420_32x24", tiny, dict(pix="yuva420p", coder=1)),
            ("ffv1_rgb_53x37", odd, dict(coder=1, slices=4)),
            ("ffv1_yuv420_53x37", odd, dict(pix="yuv420p", coder=0))):
        ext, pk = lavc.encode_ffv1(frames, **opts)
        h, w = frames[0].shape[:2]
        _webm(os.path.join(OUT, name + ".mkv"), pk, w, h, codec=b"V_FFV1",
              private=ext, doctype=b"matroska")


def pts_only_fixtures() -> None:
    """Transport streams whose PES headers carry a PTS alone (DTS = PTS,
    as some muxers and broadcast captures write them) over B-pictures:
    MPEG-2 in 188- and 192-byte packets, MPEG-1 under stream type 0x01;
    and the same MPEG-2 pictures in a program stream."""
    lavc = Lavc()
    planes = [bgr_i420(f) for f in moving_clip(144, 176, 30, seed=31)]
    mpeg2 = lavc.encode(planes)
    ts_mux(os.path.join(OUT, "mpeg2_pts_only_176x144.ts"), mpeg2,
           pts_only=True)
    ts_mux(os.path.join(OUT, "mpeg2_pts_only_176x144.m2ts"), mpeg2,
           pts_only=True, m2ts=True)
    ts_mux(os.path.join(OUT, "mpeg1_pts_only_176x144.ts"),
           lavc.encode(planes, codec="mpeg1video", bf=2), stream_type=1,
           pts_only=True)
    ps_mux(os.path.join(OUT, "mpeg2_pts_only_176x144.mpg"),
           [(d, p, p) for d, p, _ in mpeg2])


PNG16 = ("png16_rgb_53x37_%d.png", "png16_rgba_53x37_%d.png",
         "png16_triples_256x256_%d.png")


def png16_fixtures() -> None:
    """16-bit colour PNG sequences as ``cv2.imwrite`` writes them: RGB and
    RGBA at 53x37 (two frames each), and one 256x256 RGB picture of
    65,536 random triples (swscale's conversion is pixel-local, so the
    sheet pins it triple by triple)."""
    import cv2
    rng = np.random.default_rng(20)
    for pattern, shape, n in zip(PNG16, ((37, 53, 3), (37, 53, 4),
                                         (256, 256, 3)), (2, 2, 1)):
        for i in range(n):
            cv2.imwrite(os.path.join(OUT, pattern % i),
                        rng.integers(0, 65536, shape, dtype=np.uint16))


def lossless_avi(path: str, packets: list, w: int, h: int, fourcc: str,
                 extradata: bytes = b"", bpc: int = 24) -> None:
    """Intra packets → an AVI by the port's muxer: ``fourcc`` with
    ``extradata`` after the BITMAPINFOHEADER and ``bpc`` as its
    ``biBitCount``, every frame a keyframe."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.avi import AviWriter
    mux = AviWriter(path, (w, h), (25, 1), fourcc=fourcc,
                    extradata=extradata, bpc=bpc)
    for data in packets:
        mux.write(data, True)
    mux.release()


def lossless_mkv(path: str, packets: list, w: int, h: int, fourcc: str,
                 extradata: bytes = b"", bpc: int = 24) -> None:
    """Intra packets → Matroska under ``V_MS/VFW/FOURCC``: a
    BITMAPINFOHEADER with ``fourcc`` and ``bpc``, then ``extradata``, as
    FFmpeg's matroska muxer writes AVI-only codecs."""
    bih = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), w, h, 1, bpc,
                      fourcc.encode("latin1"), w * h * 3, 0, 0, 0, 0)
    _webm(path, [(p, True) for p in packets], w, h,
          codec=b"V_MS/VFW/FOURCC", private=bih + extradata,
          doctype=b"matroska")


def with_frame_pred(packet: bytes, pred: int) -> bytes:
    """A Ut Video packet with its frame information's predictor (bits 8-9
    of the last 4 bytes) set to ``pred``: a packet coded with none (the
    samples themselves) read as gradient (2) or median (3) residuals, which
    FFmpeg's decoder restores as it restores any."""
    info = struct.unpack("<I", packet[-4:])[0] & ~0x300 | pred << 8
    return packet[:-4] + struct.pack("<I", info)


HUFFYUV_BPC = {"yuv422p": 16, "yuv420p": 12, "rgb24": 24, "bgra": 32}
UT_FOURCC = {"gbrp": "ULRG", "gbrap": "ULRA", "yuv420p": "ULY0",
             "yuv422p": "ULY2", "yuv444p": "ULY4"}


def png_flavour(f: np.ndarray, kind: str) -> bytes:
    """A BGR frame as a PNG file of one flavour: cv2's ``rgb``, ``rgba``,
    ``gray``, ``gray16``, ``rgb48`` and ``rgba64``; PIL's ``palette`` (64
    colours), ``graya`` (grey and alpha), ``mono`` (1 bit) and ``gray4``
    (a 16-colour palette at 4 bits)."""
    import io
    import cv2
    from PIL import Image
    a = np.concatenate([f, f[..., :1]], 2)
    if kind in ("rgb", "rgba", "gray", "gray16", "rgb48", "rgba64"):
        img = {"rgb": f, "rgba": a, "gray": f[..., 1],
               "gray16": f[..., 1].astype(np.uint16) * 257 + 3,
               "rgb48": f.astype(np.uint16) * 251,
               "rgba64": a.astype(np.uint16) * 255}[kind]
        return cv2.imencode(".png", img)[1].tobytes()
    b = io.BytesIO()
    if kind == "palette":
        Image.fromarray(f[..., ::-1]).quantize(64).save(b, "PNG")
    elif kind == "graya":
        Image.fromarray(np.stack([f[..., 1], f[..., 2]], 2), "LA").save(
            b, "PNG")
    elif kind == "mono":
        Image.fromarray(f[..., 1] > 128).save(b, "PNG")
    else:
        Image.fromarray(f[..., 1]).convert(
            "P", palette=Image.ADAPTIVE, colors=16).save(b, "PNG", bits=4)
    return b.getvalue()


def lossless_fixtures() -> None:
    """Lossless intra video as cv2 writes and reads it (HuffYUV, FFVHuff,
    Ut Video and PNG in .avi, .mkv and .mov, PNG in .mp4, Motion JPEG in
    .mov, raw Y800/GREY/YV12/RGBA), and from libavcodec's encoders
    (``Lavc.encode_intra``) what cv2's writer leaves out: HuffYUV's
    predictors over 4:2:2, RGB24 and RGB32, its classic tables
    (``huffyuv_classic``) and interlaced lines; FFVHuff's 4:2:0
    predictors, per-frame tables and version-3 layouts at odd sizes; Ut
    Video's layouts, predictors (gradient by ``with_frame_pred``), slices,
    BT.709 and one-symbol planes; PNG's flavours; 32-bit BI_RGB; and the
    Sintel pair at 436x1024 (HuffYUV 4:2:2, cv2's Ut Video), which the
    card run decodes."""
    def out(name):
        return os.path.join(OUT, name)
    clip = moving_clip(64, 96, 3, seed=21)
    for fcc, stem in (("HFYU", "hfyu"), ("FFVH", "ffvh"), ("ULY0", "ut_uly0"),
                      ("MPNG", "png")):
        for ext in ("avi", "mkv", "mov") + (("mp4",) if fcc == "MPNG" else ()):
            _cv2_write(out(f"{stem}_96x64.{ext}"), clip, fcc)
    _cv2_write(out("mjpg_96x64.mov"), clip, "MJPG")
    small = moving_clip(32, 48, 3, seed=22)
    for fcc in ("Y800", "YV12", "RGBA"):
        for ext in ("avi", "mkv") + (("mov",) if fcc == "RGBA" else ()):
            _cv2_write(out(f"raw_{fcc.lower()}_48x32.{ext}"), small, fcc)
    _cv2_write(out("raw_grey_48x32.avi"), small, "GREY")
    # I420-sized packets: a 50-wide grey row is read 52 apart
    _cv2_write(out("raw_y800_50x36.avi"), moving_clip(36, 50, 3, seed=23),
               "Y800")
    odd = moving_clip(37, 53, 3, seed=24)
    lossless_avi(out("raw_bgr0_53x37.avi"), [
        np.concatenate([f, np.zeros_like(f[..., :1])], 2)[::-1].tobytes()
        for f in odd], 53, 37, "\0\0\0\0", bpc=32)
    lavc = Lavc()
    tiny = moving_clip(32, 48, 3, seed=25)
    # HuffYUV: each predictor over 4:2:2, RGB24 and RGB32 (the median is
    # refused on RGB by the encoder, as FFmpeg's decoder decodes none)
    for pix, tag in (("yuv422p", "yuv422"), ("rgb24", "rgb24"),
                     ("bgra", "rgb32")):
        for pred in ("left", "plane", "median"):
            if pred == "median" and pix != "yuv422p":
                continue
            ext, pk = lavc.encode_intra(tiny, "huffyuv", pix, pred=pred)
            lossless_avi(out(f"hfyu_{tag}_{pred}_48x32.avi"),
                         [p for p, _ in pk], 48, 32, "HFYU", ext,
                         HUFFYUV_BPC[pix])
    ext, pk = lavc.encode_intra(tiny, "huffyuv", "yuv422p", pred="median")
    lossless_mkv(out("hfyu_yuv422_median_48x32.mkv"), [p for p, _ in pk],
                 48, 32, "HFYU", ext, 16)
    for kind in ("yuv422_left", "yuv422_plane", "rgb24_left"):
        bpc, pk = huffyuv_classic(tiny, kind)
        lossless_avi(out(f"hfyu_classic_{kind}_48x32.avi"), pk, 48, 32,
                     "HFYU", bpc=bpc)
    for codec, pix, pred in (("huffyuv", "yuv422p", "median"),
                             ("huffyuv", "rgb24", "plane"),
                             ("ffvhuff", "yuv420p", "median"),
                             ("ffvhuff", "yuv444p", "plane")):
        ext, pk = lavc.encode_intra(tiny, codec, pix, pred=pred,
                                    flags="+ilme")
        stem = "hfyu" if codec == "huffyuv" else "ffvh"
        lossless_avi(out(f"{stem}_interlaced_{pix}_{pred}_48x32.avi"),
                     [p for p, _ in pk], 48, 32, stem.upper(), ext,
                     HUFFYUV_BPC.get(pix, 24))
    # FFVHuff: 4:2:0's predictors, per-frame tables, version 3 at 8 bits
    for pix, pred, opts, size in (
            ("yuv420p", "plane", {}, (48, 32)),
            ("yuv420p", "median", {}, (52, 37)),
            ("yuv420p", "median", {"context": 1}, (48, 32)),
            ("yuv422p", "left", {"context": 1}, (48, 32)),
            ("gray", "median", {}, (53, 37)),
            ("gbrp", "plane", {}, (53, 37)),
            ("gbrap", "median", {}, (48, 32)),
            ("yuv444p", "median", {}, (53, 37)),
            ("yuv411p", "left", {}, (48, 32)),
            ("yuv440p", "plane", {}, (48, 32)),
            ("yuv410p", "median", {}, (48, 32)),
            ("yuva444p", "left", {}, (48, 32)),
            ("yuva422p", "median", {}, (48, 32)),
            ("yuva420p", "plane", {}, (48, 32))):
        w, h = size
        frames = tiny if size == (48, 32) else moving_clip(h, w, 3, seed=26)
        ext, pk = lavc.encode_intra(frames, "ffvhuff", pix, pred=pred,
                                    **opts)
        ctx = "_context" if opts else ""
        lossless_avi(out(f"ffvh_{pix}_{pred}{ctx}_{w}x{h}.avi"),
                     [p for p, _ in pk], w, h, "FFVH", ext,
                     HUFFYUV_BPC.get(pix, 24))
    # Ut Video: each layout and predictor, slices, BT.709, odd sizes, a
    # grey picture's one-symbol planes, gradient read from a none packet
    for pix in UT_FOURCC:
        for pred in ("none", "left", "median"):
            ext, pk = lavc.encode_intra(tiny, "utvideo", pix, pred=pred)
            packets = [p for p, _ in pk]
            fcc = UT_FOURCC[pix]
            lossless_avi(out(f"ut_{fcc.lower()}_{pred}_48x32.avi"), packets,
                         48, 32, fcc, ext)
            if pred == "none":
                lossless_avi(out(f"ut_{fcc.lower()}_gradient_48x32.avi"),
                             [with_frame_pred(p, 2) for p in packets], 48,
                             32, fcc, ext)
    for pix, pred, slices, size, bt709 in (
            ("yuv420p", "median", 5, (48, 32), True),
            ("yuv422p", "left", 7, (52, 37), True),
            ("yuv444p", "median", 4, (53, 37), True),
            ("gbrap", "median", 3, (53, 37), False),
            ("gbrp", "left", 4, (48, 32), False)):
        w, h = size
        frames = tiny if size == (48, 32) else moving_clip(h, w, 3, seed=27)
        opts = {"colorspace": "bt709"} if bt709 else {}
        ext, pk = lavc.encode_intra(frames, "utvideo", pix, pred=pred,
                                    slices=slices, **opts)
        fcc = UT_FOURCC[pix].replace("Y", "H") if bt709 else UT_FOURCC[pix]
        lossless_avi(out(f"ut_{fcc.lower()}_{pred}_slices{slices}_{w}x{h}"
                         ".avi"), [p for p, _ in pk], w, h, fcc, ext)
        if pix == "yuv422p":
            lossless_mkv(out(f"ut_{fcc.lower()}_{pred}_{w}x{h}.mkv"),
                         [p for p, _ in pk], w, h, fcc, ext)
    grey = [np.repeat(f[..., 1:2], 3, 2) for f in tiny]
    ext, pk = lavc.encode_intra(grey, "utvideo", "gbrp", pred="median")
    lossless_avi(out("ut_ulrg_grey_48x32.avi"), [p for p, _ in pk], 48, 32,
                 "ULRG", ext)
    # PNG's flavours, one PNG file a chunk
    for kind in ("rgba", "gray", "gray16", "rgb48", "rgba64", "palette",
                 "graya", "mono", "gray4"):
        lossless_avi(out(f"png_{kind}_53x37.avi"),
                     [png_flavour(f, kind) for f in odd], 53, 37, "MPNG")
    # the Sintel pair at full width
    pair = sintel_pair()
    ext, pk = lavc.encode_intra(pair, "huffyuv", "yuv422p", pred="median")
    lossless_avi(out("hfyu_sintel_436x1024.avi"), [p for p, _ in pk], 1024,
                 436, "HFYU", ext, 16)
    _cv2_write(out("ut_sintel_436x1024.avi"), pair, "ULY0")


# ------------------------------------- MagicYUV, Sorenson H.263, ASUS V1/V2

def _magy_slices(packet: bytes) -> tuple:
    """(header size, slice count, planes, [[slice start] for each plane]) of
    a MagicYUV packet, the starts absolute, as FFmpeg's decoder reads its
    header."""
    header, = struct.unpack("<I", packet[4:8])
    height, sh = struct.unpack("<II", packet[20:24] + packet[28:32])
    n = (height + sh - 1) // sh
    planes = {0x65: 3, 0x66: 4, 0x67: 3, 0x68: 3, 0x69: 3, 0x6a: 4,
              0x6b: 1}[packet[9]]
    offs = struct.unpack(f"<{n * planes}I", packet[36:36 + 4 * n * planes])
    return header, n, planes, [[header + offs[p * n + j] for j in range(n)]
                               for p in range(planes)]


def magy_with(packet: bytes, matrix=None, flags=None, pred=None) -> bytes:
    """A MagicYUV packet with its header's colour matrix byte (1 BT.601, 2
    BT.709), its flags byte (4: full range; 2: interlaced) or every slice's
    predictor byte set (0: none, which FFmpeg leaves as residuals)."""
    data = bytearray(packet)
    if matrix is not None:
        data[11] = matrix
    if flags is not None:
        data[12] = flags
    if pred is not None:
        for starts in _magy_slices(packet)[3]:
            for start in starts:
                data[start + 1] = pred
    return bytes(data)


def magy_raw_plane(packet: bytes, plane: np.ndarray) -> bytes:
    """A one-slice, left-predicted MagicYUV packet with its first plane's
    slice replaced by a raw one (flags byte 1): ``plane``'s left residuals
    (each line's first sample from the one above) as bytes, which FFmpeg's
    decoder copies and then restores as any residuals."""
    header, n, planes, starts = _magy_slices(packet)
    assert n == 1 and packet[starts[0][0] + 1] == 1
    p = plane.astype(np.int16)
    res = np.empty_like(p)
    res[:, 1:] = p[:, 1:] - p[:, :-1]
    res[0, 0] = p[0, 0]
    res[1:, 0] = p[1:, 0] - p[:-1, 0]
    raw = bytes([1, 1]) + (res & 0xFF).astype(np.uint8).tobytes()
    a, b = starts[0][0], starts[1][0]
    data = bytearray(packet[:a] + raw + packet[b:])
    for k in range(1, planes):
        off = struct.unpack("<I", data[36 + 4 * k:40 + 4 * k])[0]
        data[36 + 4 * k:40 + 4 * k] = struct.pack("<I",
                                                  off + len(raw) - (b - a))
    return bytes(data)


def flv_mux(path: str, packets: list, w: int, h: int, fps: int = 25,
            kinds=None) -> None:
    """Sorenson H.263 packets (key frames by their picture headers) → an
    FLV as FFmpeg's muxer writes one: the header, an onMetaData script tag
    (duration, width, height, framerate, videocodecid 2), one video tag a
    packet at its millisecond time (frame type 1 key, 2 inter, or
    ``kinds[i]``), each tag closed by its size."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.runtime.h263 import is_intra

    def num(key, v):
        return struct.pack(">H", len(key)) + key + b"\0" + struct.pack(">d", v)

    step = round(1000 / fps)
    meta = (b"\x02" + struct.pack(">H", 10) + b"onMetaData" + b"\x08"
            + struct.pack(">I", 5) + num(b"duration", len(packets) * step
                                          / 1000)
            + num(b"width", w) + num(b"height", h) + num(b"framerate", fps)
            + num(b"videocodecid", 2) + b"\0\0\x09")

    def tag(kind, stamp, body):
        head = bytes([kind]) + len(body).to_bytes(3, "big") + (
            stamp & 0xFFFFFF).to_bytes(3, "big") + bytes([stamp >> 24]) \
            + b"\0\0\0"
        return head + body + struct.pack(">I", 11 + len(body))

    out = b"FLV\x01\x01" + struct.pack(">I", 9) + b"\0\0\0\0" + tag(18, 0,
                                                                    meta)
    for i, data in enumerate(packets):
        kind = kinds[i] if kinds else (1 if is_intra(data, True) else 2)
        out += tag(9, i * step, bytes([kind << 4 | 2]) + data)
    with open(path, "wb") as f:
        f.write(out)


def _sorenson_type_bit(bits: str) -> int:
    """The bit at which a Sorenson picture header's 2-bit type starts."""
    code = int(bits[30:33], 2)
    return 33 + (16 if code == 0 else 32 if code == 1 else 0)


def sorenson_with(packet: bytes, kind=None, deblock=None) -> bytes:
    """A Sorenson picture with its header's type (0 I, 1 P, 2 disposable P)
    or deblocking flag rewritten."""
    bits = _bits(packet)
    at = _sorenson_type_bit(bits)
    if kind is not None:
        bits = bits[:at] + format(kind, "02b") + bits[at + 2:]
    if deblock is not None:
        bits = bits[:at + 2] + str(deblock) + bits[at + 3:]
    return _bytes(bits)[:len(packet)]


# H.263's source format → Sorenson's size code
_SORENSON_CODE = {1: 4, 2: 3, 3: 2}


def sorenson_from_h263(packet: bytes) -> bytes:
    """A baseline H.263 picture (no PLUSPTYPE, no CPM, no PEI) re-headed as
    a Sorenson version-0 picture: the same macroblock layer, which version
    0 reads with H.263's escape."""
    bits = _bits(packet)
    assert bits[:22] == "0" * 16 + "100000" and bits[49:51] == "00"
    tr, fmt, inter = bits[22:30], int(bits[35:38], 2), bits[38]
    quant = bits[43:48]
    head = ("0" * 16 + "1" + "00000" + tr + format(_SORENSON_CODE[fmt], "03b")
            + "0" + inter + "0" + quant + "0")
    return _bytes(head + bits[50:])


def _flv_features(path: str) -> list:
    """The port's H.263 decoder's features and Sorenson features over a
    Sorenson file."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    v = EncodedVideo(path)
    dec = v._decoder()
    with open(path, "rb") as f:
        for i in range(v.samples):
            dec.decode(v.box.sample(f, i))
    return dec.features + dec.sorenson_features


def magicyuv_fixtures() -> None:
    """MagicYUV as cv2 writes and reads it (``M8Y0`` in .avi, .mkv and
    .mov: 4:2:0, left prediction), and from libavcodec's encoder
    (``Lavc.encode_intra``) what cv2's writer leaves out: each 8-bit layout
    (GBRP, GBRAP, 4:4:4, 4:2:2, 4:2:0, YUVA 4:4:4, grey) with each
    predictor, slices at odd sizes, headers rewritten to BT.709 and full
    range (``magy_with``), residuals left unpredicted, a raw slice
    (``magy_raw_plane``); and the Sintel pair at 436x1024 (cv2's writer),
    which the card run decodes."""
    def out(name):
        return os.path.join(OUT, name)
    clip = moving_clip(64, 96, 3, seed=31)
    for ext in ("avi", "mkv", "mov"):
        _cv2_write(out(f"magy_96x64.{ext}"), clip, "M8Y0")
    lavc = Lavc()
    tiny = moving_clip(32, 48, 2, seed=32)
    for pix in ("gbrp", "gbrap", "yuv444p", "yuv422p", "yuv420p",
                "yuva444p", "gray"):
        for pred in ("left", "gradient", "median"):
            _, pk = lavc.encode_intra(tiny, "magicyuv", pix, pred=pred)
            lossless_avi(out(f"magy_{pix}_{pred}_48x32.avi"),
                         [p for p, _ in pk], 48, 32, "M8Y0")
    odd = moving_clip(37, 53, 2, seed=33)
    for pix, slices in (("gbrp", 3), ("yuv444p", 4), ("yuv422p", 3),
                        ("yuv420p", 5), ("gray", 2)):
        _, pk = lavc.encode_intra(odd, "magicyuv", pix, pred="median",
                                  slices=slices)
        lossless_avi(out(f"magy_{pix}_median_slices{slices}_53x37.avi"),
                     [p for p, _ in pk], 53, 37, "M8Y0")
    for pix, kw, stem in (("yuv422p", {"matrix": 2}, "bt709"),
                          ("yuv444p", {"flags": 4}, "full"),
                          ("yuv420p", {"matrix": 2, "flags": 4},
                           "bt709_full"),
                          ("yuv420p", {"pred": 0}, "nopred"),
                          ("gray", {"flags": 4}, "full")):
        _, pk = lavc.encode_intra(tiny, "magicyuv", pix, pred="left")
        lossless_avi(out(f"magy_{stem}_{pix}_48x32.avi"),
                     [magy_with(p, **kw) for p, _ in pk], 48, 32, "M8Y0")
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.runtime.magicyuv import Decoder
    _, pk = lavc.encode_intra(tiny, "magicyuv", "yuv444p", pred="left")
    dec = Decoder()
    lossless_avi(out("magy_raw_slice_yuv444p_48x32.avi"),
                 [magy_raw_plane(p, dec.decode(p)[0]) for p, _ in pk], 48, 32,
                 "M8Y0")
    _cv2_write(out("magy_sintel_436x1024.avi"), sintel_pair(), "M8Y0")


def sorenson_fixtures() -> None:
    """Sorenson H.263 (fourcc ``FLV1``) as cv2 writes and reads it in .flv,
    .avi, .mkv and .mov (14 frames, key frames at 0 and 12), and from
    libavcodec's ``flv`` encoder muxed by ``flv_mux``: quantiser 1 over
    hard edges (11-bit escapes), an odd size, 176x144 (a standard size
    code) and the Sintel pair's 13 frames at 436x1024 (16-bit size
    fields), which the card run reads; version 0 (``h263`` pictures with
    8x8 vectors re-headed, ``sorenson_from_h263``: H.263's escapes);
    disposable pictures with the deblocking flag set, mid GOP and right
    after the key frames (FFmpeg skips the one after the first key frame
    in a capture just opened, and none after a seek: the manifest's
    ``seek_sha256`` holds the frame a seek to it reads), and right after
    the later key frame alone (a seek to it reads it)."""
    def out(name):
        return os.path.join(OUT, name)
    clip = moving_clip(64, 96, 14, seed=34)
    for ext in ("flv", "avi", "mkv", "mov"):
        _cv2_write(out(f"flv_96x64.{ext}"), clip, "FLV1")
    lavc = Lavc()

    def flv(frames, **opts):
        return [d for d, _, _ in lavc.encode([bgr_i420(f) for f in frames],
                                             codec="flv", **opts)]
    # hard edges at quantiser 1: levels past version 1's 7-bit escape and,
    # in H.263 pictures re-headed as version 0 (at 128x96, a size H.263
    # names), 8x8 vectors
    rng = np.random.default_rng(40)
    cells = (rng.integers(0, 2, (12, 16, 3)) * 255).astype(np.uint8)
    edges = cells.repeat(8, 0).repeat(8, 1)
    sharp = [np.roll(edges, 3 * i, axis=1) for i in range(4)]
    flv_mux(out("flv_q1_128x96.flv"), flv(sharp, qmin=1, qmax=1), 128, 96)
    h263 = [d for d, _, _ in lavc.encode([bgr_i420(f) for f in sharp],
                                         codec="h263", qmin=1, qmax=1,
                                         flags="+mv4")]
    flv_mux(out("flv_v0_128x96.flv"), [sorenson_from_h263(p) for p in h263],
            128, 96)
    flv_mux(out("flv_176x144.flv"),
            flv(moving_clip(144, 176, 4, seed=35, speed=3.0)), 176, 144)
    flv_mux(out("flv_53x37.flv"), flv(moving_clip(37, 53, 14, seed=36)),
            53, 37)
    base = flv(clip)
    mid = [sorenson_with(p, kind=2 if i in (5, 9) else None, deblock=1)
           for i, p in enumerate(base)]
    flv_mux(out("flv_disposable_96x64.flv"), mid, 96, 64,
            kinds=[1 if i in (0, 12) else 3 if i in (5, 9) else 2
                   for i in range(len(mid))])
    near = [sorenson_with(p, kind=2) if i in (1, 13) else p
            for i, p in enumerate(base)]
    flv_mux(out("flv_disposable_key_96x64.flv"), near, 96, 64,
            kinds=[1 if i in (0, 12) else 3 if i in (1, 13) else 2
                   for i in range(len(near))])
    # one right after the later key frame alone: the sequential read shows
    # it, and the seek to it decodes it right after that key frame
    later = [sorenson_with(p, kind=2) if i == 13 else p
             for i, p in enumerate(base)]
    flv_mux(out("flv_disposable_later_key_96x64.flv"), later, 96, 64,
            kinds=[1 if i in (0, 12) else 3 if i == 13 else 2
                   for i in range(len(later))])
    im1, im2 = sintel_pair()
    flv_mux(out("flv_sintel_436x1024.flv"),
            flv([im1 if i % 2 == 0 else im2 for i in range(13)], b=300000,
                qmin=8), 1024, 436)


def asv_fixtures() -> None:
    """ASUS V1 and V2 as cv2 writes and reads them (``ASV1``, ``ASV2`` in
    .avi, .mkv and .mov), and from libavcodec's ``asv1``/``asv2`` encoders
    at sizes that are not a multiple of 16 (partial macroblocks) and three
    quantisers, one muxed without extradata (FFmpeg's default inverse
    quantiser); and the Sintel pair at 436x1024 in ASV2 (cv2's writer),
    which the card run decodes."""
    def out(name):
        return os.path.join(OUT, name)
    clip = moving_clip(64, 96, 3, seed=37)
    for fcc in ("ASV1", "ASV2"):
        for ext in ("avi", "mkv", "mov"):
            _cv2_write(out(f"asv_{fcc.lower()}_96x64.{ext}"), clip, fcc)
    lavc = Lavc()
    odd = moving_clip(37, 53, 2, seed=38)
    for codec in ("asv1", "asv2"):
        for q in (1, 4, 12):
            ext, pk = lavc.encode_intra(odd, codec, "yuv420p",
                                        global_quality=118 * q,
                                        flags="+qscale")
            lossless_avi(out(f"asv_{codec}_q{q}_53x37.avi"),
                         [p for p, _ in pk], 53, 37, codec.upper(), ext)
        ext, pk = lavc.encode_intra(moving_clip(40, 72, 2, seed=39), codec,
                                    "yuv420p")
        lossless_avi(out(f"asv_{codec}_noext_72x40.avi"), [p for p, _ in pk],
                     72, 40, codec.upper())
    _cv2_write(out("asv_sintel_436x1024.avi"), sintel_pair(), "ASV2")


# ------------------------------------------------------- MS-MPEG4 / WMV

def _guid(text: str) -> bytes:
    import uuid
    return uuid.UUID(text).bytes_le


def _asf_object(g: str, body: bytes) -> bytes:
    return _guid(g) + struct.pack("<Q", 24 + len(body)) + body


def asf_mux(path: str, packets: list, w: int, h: int, fourcc: str,
            extradata: bytes = b"", fps=25, packet_size: int = 3200,
            multiple: bool = True, ec: bool = True,
            preroll: int = 3100) -> None:
    """MS-MPEG4/WMV packets (key frames by their picture headers) → an ASF
    file laid out as FFmpeg's asf muxer lays one out: the Header Object
    (File Properties: ``packet_size``-byte data packets, the play duration
    and ``preroll``; Stream Properties: stream 1, video, the
    BITMAPINFOHEADER with ``extradata``), the Data Object (each packet
    error correction data where ``ec``, WORD padding, then several payloads
    where ``multiple``, else one; each payload's replicated data the media
    object's size and presentation time, ms from ``preroll``; a picture
    split over as many packets as it needs), and a Simple Index Object (a
    second an entry: the packet where the last key frame at or before it
    starts)."""
    from fractions import Fraction
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.avi import codec_of
    from opticalflow_tpu_torch.runtime.msmpeg4 import is_keyframe
    codec = codec_of(fourcc, path)
    rate = Fraction(fps).limit_denominator(1001)
    stamps = [int(i / rate * 1000 + Fraction(1, 2))
              for i in range(len(packets) + 1)]
    head = (b"\x82\0\0" if ec else b"") + bytes([0x11 if multiple else 0x10,
                                                0x5D])
    fixed = len(head) + 2 + 4 + 2 + (1 if multiple else 0)
    per = 17 if multiple else 15
    out, cur, starts = [], [], []   # data packets, payloads, (ms, packet)

    def flush():
        body = b"".join(cur)
        pad = packet_size - fixed - len(body)
        send = struct.unpack("<I", cur[0][11:15])[0] if cur else 0
        data = head + struct.pack("<HIH", pad, send, 0)
        if multiple:
            data += bytes([0x80 | len(cur)])
        out.append(data + body + b"\0" * pad)
        cur.clear()

    for i, data in enumerate(packets):
        key = is_keyframe(data, codec)
        if key:
            starts.append((stamps[i], len(out)))
        off = 0
        while off < len(data):
            used = fixed + sum(len(c) for c in cur)
            room = packet_size - used - per
            if room <= 0 or (cur and not multiple):
                flush()
                continue
            chunk = data[off:off + room]
            pl = (bytes([0x81 if key else 0x01, (i + 1) & 0xFF])
                  + struct.pack("<IBII", off, 8, len(data),
                                stamps[i] + preroll))
            if multiple:
                pl += struct.pack("<H", len(chunk))
            cur.append(pl + chunk)
            off += len(chunk)
            if not multiple:
                flush()
    if cur:
        flush()
    play = (stamps[-1] + preroll) * 10000
    file_id = bytes(range(16))
    bmp = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), w, h, 1, 24,
                      fourcc.encode("latin1"), w * h * 3, 0, 0, 0, 0)
    tsd = struct.pack("<IIBH", w, h, 2, len(bmp) + len(extradata)) + bmp \
        + extradata
    stream = (_guid("BC19EFC0-5B4D-11CF-A8FD-00805F5C442B")
              + _guid("20FB5700-5B55-11CF-A8FD-00805F5C442B")
              + struct.pack("<QIIHI", 0, len(tsd), 0, 1, 0) + tsd)
    index_n = play // 10_000_000 + 1
    entries = b""
    for k in range(index_n):
        t = max(k * 1000 - preroll, 0)
        at = [n for ms, n in starts if ms <= t] or [starts[0][1]]
        entries += struct.pack("<IH", at[-1], 1)
    index = _asf_object("33000890-E5B1-11CF-89F4-00A0C90349CB",
                        file_id + struct.pack("<QII", 10_000_000, 1, index_n)
                        + entries)
    data_obj = _asf_object("75B22636-668E-11CF-A6D9-00AA0062CE6C",
                           file_id + struct.pack("<QH", len(out), 0x101)
                           + b"".join(out))

    def header(total: int) -> bytes:
        props = file_id + struct.pack(
            "<QQQQQQIIII", total, 0, len(out), play, play - preroll * 10000,
            preroll, 2, packet_size, packet_size, 1000000)
        objs = [_asf_object("8CABDCA1-A947-11CF-8EE4-00C00C205365", props),
                _asf_object("B7DC0791-A9B7-11CF-8EE6-00C00C205365", stream)]
        return _asf_object("75B22630-668E-11CF-A6D9-00AA0062CE6C",
                           struct.pack("<IBB", len(objs), 1, 2)
                           + b"".join(objs))

    total = len(header(0)) + len(data_obj) + len(index)
    with open(path, "wb") as f:
        f.write(header(total) + data_obj + index)


def msmpeg4_avi(path: str, packets: list, w: int, h: int, fourcc: str,
                extradata: bytes = b"") -> None:
    """MS-MPEG4/WMV packets → an AVI by the port's muxer, its key frames
    (the I-pictures) flagged in ``idx1``."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.avi import AviWriter, codec_of
    from opticalflow_tpu_torch.runtime.msmpeg4 import is_keyframe
    codec = codec_of(fourcc, path)
    mux = AviWriter(path, (w, h), (25, 1), fourcc=fourcc,
                    extradata=extradata)
    for data in packets:
        mux.write(data, is_keyframe(data, codec))
    mux.release()


def _msm_codes(name: str) -> list:
    """(code, length) pairs of one of ``msmpeg4_tables.h``'s tables."""
    v = _cpp_table(name, "msmpeg4_tables.h")
    return list(zip(v[::2], v[1::2]))


class _MsmWalker:
    """MS-MPEG4 v3 pictures walked syntax element by element in Python, for
    ``msmpeg4_retable``: each picture rebuilt with its DC differences and
    motion vectors coded in other tables than libavcodec's encoder picks
    (it always takes DC and MV table 1), every other bit copied."""

    def __init__(self):
        def vlc(pairs, syms=None):
            return {format(c, f"0{n}b"): (syms[i] if syms else i)
                    for i, (c, n) in enumerate(pairs)}
        self.mb_i = vlc(_msm_codes("kMbI"))
        self.cbp = vlc(_msm_codes("kCbp3"))
        self.dcs = [[_msm_codes(f"kDc{t}{c}") for c in "LC"] for t in (0, 1)]
        self.mv = []
        for t in (0, 1):
            lens = _cpp_table(f"kMv{t}Lens", "msmpeg4_tables.h")
            syms = _cpp_table(f"kMv{t}Syms", "msmpeg4_tables.h")
            code, pairs = 0, []
            for n in lens:                 # ff_vlc_init_from_lengths' codes
                pairs.append((code >> (32 - n), n))
                code += 1 << (32 - n)
            self.mv.append((pairs, syms))
        # ff_rl_table: (codes with the escape last, the first ending code)
        self.rl = []
        for name, last in (("kRl0", 85), ("kRl185", 119), (None, 67),
                           ("kRl1", 81), ("kRl168", 99), ("mpeg_inter", 58)):
            if name is None:
                pairs = _msm_common("kIntraTcoef")
            elif name == "mpeg_inter":
                pairs = _msm_common("kInterTcoef")
            else:
                pairs = _msm_codes(f"{name}Codes")
            self.rl.append((vlc(pairs), len(pairs) - 1, last))

    def read(self, codes: dict) -> int:
        for n in range(1, 27):
            w = self.bits[self.pos:self.pos + n]
            if w in codes:
                self.pos += n
                return codes[w]
        raise ValueError(f"no code at bit {self.pos}")

    def take(self, n: int) -> str:
        self.pos += n
        return self.bits[self.pos - n:self.pos]

    def copy(self, n: int) -> None:
        self.out.append(self.take(n))

    def code012(self) -> int:
        b = self.take(1)
        self.out.append(b)
        if b == "0":
            return 0
        b = self.take(1)
        self.out.append(b)
        return 1 + int(b)

    def block_ac(self, rl: int) -> None:
        codes, esc, last_at = self.rl[rl]
        while True:
            start = self.pos
            sym = self.read(codes)
            if sym != esc:
                last = sym >= last_at
                self.pos += 1
            elif self.bits[self.pos] == "1" or self.bits[self.pos + 1] == "1":
                self.pos += 1 if self.bits[self.pos] == "1" else 2
                sym = self.read(codes)
                last = sym >= last_at
                self.pos += 1
            else:
                self.pos += 2
                last = self.bits[self.pos] == "1"
                self.pos += 15
            self.out.append(self.bits[start:self.pos])
            if last:
                return

    def dc(self, chroma: bool) -> None:
        pairs = self.dcs[self.src_dc][chroma]
        sym = self.read({format(c, f"0{n}b"): i
                         for i, (c, n) in enumerate(pairs)})
        c, n = self.dcs[self.dst_dc][chroma][sym]
        self.out.append(format(c, f"0{n}b"))
        if sym == 119:
            self.copy(9)
        elif sym:
            self.copy(1)

    def motion(self) -> None:
        pairs, syms = self.mv[self.src_mv]
        sym = self.read({format(c, f"0{n}b"): syms[i]
                         for i, (c, n) in enumerate(pairs)})
        if not sym:
            sym = int(self.take(6), 2) << 8 | int(self.take(6), 2)
        pairs, syms = self.mv[self.dst_mv]
        if sym in syms:
            c, n = pairs[syms.index(sym)]
            self.out.append(format(c, f"0{n}b"))
        else:
            c, n = pairs[syms.index(0)]
            self.out.append(format(c, f"0{n}b")
                            + format(sym >> 8, "06b") + format(sym & 63,
                                                               "06b"))

    def picture(self, data: bytes, mb_w: int, mb_h: int, dc_table: int,
                mv_table: int) -> bytes:
        self.bits = "".join(format(b, "08b") for b in data)
        self.pos, self.out = 0, []
        intra = self.bits[:2] == "00"
        self.copy(7)                               # type, quantiser
        if intra:
            self.copy(5)                           # slice code
            rl_chroma, rl = self.code012(), self.code012()
            self.src_dc, self.src_mv = int(self.take(1)), 1
            self.out.append(str(dc_table))
            coded = {}
        else:
            skip = self.take(1)
            self.out.append(skip)
            rl = rl_chroma = self.code012()
            self.src_dc, self.src_mv = int(self.take(1)), int(self.take(1))
            self.out.append(f"{dc_table}{mv_table}")
        self.dst_dc, self.dst_mv = dc_table, mv_table
        for y in range(mb_h):
            for x in range(mb_w):
                if intra:
                    start = self.pos
                    code = self.read(self.mb_i)
                    self.out.append(self.bits[start:self.pos])
                    cbp = 0
                    for i in range(6):
                        val = code >> (5 - i) & 1
                        if i < 4:      # ff_msmpeg4_coded_block_pred
                            bx, by = 2 * x + (i & 1), 2 * y + (i >> 1)
                            a = coded.get((bx - 1, by), 0)
                            b = coded.get((bx - 1, by - 1), 0)
                            c = coded.get((bx, by - 1), 0)
                            val ^= a if b == c else c
                            coded[bx, by] = val
                        cbp |= val << (5 - i)
                    mb_intra = True
                else:
                    if skip == "1":
                        self.copy(1)
                        if self.bits[self.pos - 1] == "1":
                            continue
                    start = self.pos
                    code = self.read(self.cbp)
                    self.out.append(self.bits[start:self.pos])
                    mb_intra, cbp = not code & 0x40, code & 0x3F
                    if not mb_intra:
                        self.motion()
                if mb_intra:
                    self.copy(1)                   # ac_pred
                for i in range(6):
                    if mb_intra:
                        self.dc(i >= 4)
                    if cbp >> (5 - i) & 1:
                        self.block_ac(rl if mb_intra and i < 4 else
                                      3 + rl_chroma if mb_intra else 3 + rl)
        rest = self.bits[self.pos:]
        if intra:                                  # the extension header
            rest = rest[:17]
        out = "".join(self.out) + rest
        out += "0" * (-len(out) % 8)
        return bytes(int(out[i:i + 8], 2) for i in range(0, len(out), 8))


def _msm_common(name: str) -> list:
    v = _cpp_table(name, "mpeg_common.h")
    return list(zip(v[::2], v[1::2]))


def msmpeg4_retable(packets: list, w: int, h: int, dc_table: int,
                    mv_table: int) -> list:
    """MS-MPEG4 v3 packets with every DC difference and motion vector coded
    in DC table ``dc_table`` and MV table ``mv_table`` (a vector table 0
    does not hold goes through its escape)."""
    walker = _MsmWalker()
    return [walker.picture(p, (w + 15) // 16, (h + 15) // 16, dc_table,
                           mv_table) for p in packets]


def _avi(path: str):
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.avi import AviFile
    return AviFile(path)


MSMPEG4_FOURCCS = {"msmpeg4v2": "MP42", "msmpeg4": "DIV3", "wmv1": "WMV1",
                   "wmv2": "WMV2"}


def msmpeg4_fixtures() -> None:
    """MS-MPEG4 v2 (``MP42``), v3 (``DIV3``), WMV7 (``WMV1``) and WMV8
    (``WMV2``) as cv2 writes and reads them: 30 frames (key frames at 0, 12
    and 24) in .avi, .mkv, .mov and .wmv (and .asf for DIV3 and WMV2), and
    a 53x37 input in .avi (cv2 writes 52x36); WMV8 in .wmv at 30000/1001
    (45 frames: FFmpeg's probe reads 41) and 24 fps, DIV3 at 15 fps.  From
    libavcodec's four encoders (``Lavc.encode_intra``) at fixed quantisers
    1, 4, 12 and 31 (every RL table and escape the encoders write; WMV8's
    three coded-block tables), v2 and v3 at 53x37 (the encoders that take
    an odd size), WMV7 at 64 kb/s (its inter-intra prediction), hard
    edges at quantiser 1 (DC escapes), muxed by ``msmpeg4_avi``; cv2's
    DIV3 and the v3 hard edges recoded in DC and MV table 0
    (``msmpeg4_retable``: libavcodec always picks table 1); WMV7 in an ASF of 256-byte packets with one payload
    each and no error correction data (``asf_mux``); and the Sintel pair's
    13 frames at 436x1024 in WMV8 at 300 kb/s (``asf_mux``: pictures split
    over many packets), which the card run reads, with three frames of it
    in each other codec (in .avi) for its host decode times."""
    def out(name):
        return os.path.join(OUT, name)
    clip = moving_clip(64, 96, 30, seed=50)
    for fcc in ("MP42", "DIV3", "WMV1", "WMV2"):
        exts = ("avi", "mkv", "mov", "wmv") + (
            ("asf",) if fcc in ("DIV3", "WMV2") else ())
        for ext in exts:
            _cv2_write(out(f"msm_{fcc.lower()}_96x64.{ext}"), clip, fcc)
        _cv2_write(out(f"msm_{fcc.lower()}_52x36.avi"),
                   moving_clip(37, 53, 14, seed=51), fcc)
    _cv2_write(out("msm_wmv2_2997_96x64.wmv"),
               moving_clip(64, 96, 45, seed=52), "WMV2", fps=30000 / 1001)
    _cv2_write(out("msm_wmv2_24fps_96x64.wmv"), clip[:14], "WMV2", fps=24)
    _cv2_write(out("msm_div3_15fps_96x64.wmv"), clip[:14], "DIV3", fps=15)
    lavc = Lavc()

    def lavc_avi(name, codec, frames, **opts):
        h, w = frames[0].shape[:2]
        ext, pk = lavc.encode_intra(frames, codec, "yuv420p", g=12, **opts)
        msmpeg4_avi(out(name), [p for p, _ in pk], w, h,
                    MSMPEG4_FOURCCS[codec], ext)

    small = moving_clip(36, 52, 14, seed=53, speed=3.0)
    for codec in MSMPEG4_FOURCCS:
        for q in (1, 4, 12, 31):
            lavc_avi(f"msm_lavc_{codec}_q{q}_52x36.avi", codec, small,
                     qmin=q, qmax=q)
    odd = moving_clip(37, 53, 14, seed=54, speed=3.0)
    for codec in ("msmpeg4v2", "msmpeg4"):
        lavc_avi(f"msm_lavc_{codec}_53x37.avi", codec, odd, qmin=3, qmax=3)
    lavc_avi("msm_lavc_wmv1_64k_96x64.avi", "wmv1", clip[:14], b=64000)
    # hard edges at quantiser 1: DC differences past the DC tables (their
    # escape) and all three coefficient escapes
    rng = np.random.default_rng(55)
    cells = (rng.integers(0, 2, (8, 12, 3)) * 255).astype(np.uint8)
    edges = cells.repeat(8, 0).repeat(8, 1)
    sharp = [np.roll(edges, 3 * i, axis=1) for i in range(4)]
    for codec in ("msmpeg4", "wmv1", "wmv2"):
        lavc_avi(f"msm_lavc_{codec}_edges_96x64.avi", codec, sharp, qmin=1,
                 qmax=1)
    # DC and MV table 0, which libavcodec's encoder never picks: cv2's DIV3
    # and the hard edges recoded (msmpeg4_retable)
    for src, dst in (("msm_div3_96x64.avi", "msm_retable_div3_96x64.avi"),
                     ("msm_lavc_msmpeg4_edges_96x64.avi",
                      "msm_retable_edges_96x64.avi")):
        box = _avi(out(src))
        with open(out(src), "rb") as f:
            pk = [box.sample(f, i) for i in range(len(box.sizes))]
        msmpeg4_avi(out(dst), msmpeg4_retable(pk, 96, 64, 0, 0), 96, 64,
                    "DIV3")
    ext, pk = lavc.encode_intra(clip[:14], "wmv1", "yuv420p", g=12, qmin=2,
                                qmax=2)
    asf_mux(out("msm_asf_single_wmv1_96x64.asf"), [p for p, _ in pk], 96, 64,
            "WMV1", ext, packet_size=256, multiple=False, ec=False)
    im1, im2 = sintel_pair()
    ext, pk = lavc.encode_intra([im1 if i % 2 == 0 else im2
                                 for i in range(13)], "wmv2", "yuv420p",
                                g=12, b=300000, qmin=8)
    asf_mux(out("msm_sintel_436x1024.wmv"), [p for p, _ in pk], 1024, 436,
            "WMV2", ext)
    # three frames of the pair in each other codec: the card run's host
    # decode times at the full width
    for codec in ("msmpeg4v2", "msmpeg4", "wmv1"):
        lavc_avi(f"msm_sintel_{codec}_436x1024.avi", codec, [im1, im2, im1],
                 b=300000, qmin=8)


def snow_avi(path: str, packets: list, w: int, h: int, fps=(25, 1)) -> None:
    """Snow packets → an AVI by the port's muxer, its key frames flagged
    in ``idx1``."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.avi import AviWriter
    from opticalflow_tpu_torch.runtime.snow import is_keyframe
    mux = AviWriter(path, (w, h), fps, fourcc="SNOW")
    for data in packets:
        mux.write(data, is_keyframe(data))
    mux.release()


def _rac_states() -> tuple:
    """(zero, one): the state transitions of ff_build_rac_states(c, 0.05 *
    2^32, 256 - 8)."""
    one64, factor, max_p = 1 << 32, int(0.05 * (1 << 32)), 256 - 8
    zero, one = [0] * 256, [0] * 256
    last, p = 0, one64 // 2
    for _ in range(128):
        p8 = (256 * p + one64 // 2) >> 32
        p8 = max(p8, last + 1)
        if last and last < 256 and p8 <= max_p:
            one[last] = p8
        p += ((one64 - p) * factor + one64 // 2) >> 32
        last = p8
    for i in range(256 - max_p, max_p + 1):
        if not one[i]:
            p = (i * one64 + 128) >> 8
            p += ((one64 - p) * factor + one64 // 2) >> 32
            one[i] = min(max((256 * p + one64 // 2) >> 32, i + 1), max_p)
    for i in range(1, 255):
        zero[i] = 256 - one[256 - i]
    return zero, one


class RacWriter:
    """FFmpeg's range encoder (rangecoder.h's put_rac and renorm_encoder,
    ff_rac_terminate) and snow.h's put_symbol, for crafted Snow headers;
    a state is a list and an index into it."""

    STATES = None

    def __init__(self):
        if RacWriter.STATES is None:
            RacWriter.STATES = _rac_states()
        self.low, self.range, self.byte, self.count = 0, 0xFF00, -1, 0
        self.out = bytearray()

    def _renorm(self) -> None:
        while self.range < 0x100:
            if self.byte < 0:
                self.byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out += bytes([self.byte]) + b"\xff" * self.count
                self.count, self.byte = 0, self.low >> 8
            elif self.low >= 0x10000:
                self.out += bytes([self.byte + 1]) + b"\0" * self.count
                self.count, self.byte = 0, (self.low >> 8) - 0x100
            else:
                self.count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def rac(self, st: list, i: int, bit: int) -> None:
        zero, one = self.STATES
        r1 = (self.range * st[i]) >> 8
        if not bit:
            self.range -= r1
            st[i] = zero[st[i]]
        else:
            self.low += self.range - r1
            self.range = r1
            st[i] = one[st[i]]
        self._renorm()

    def symbol(self, st: list, i: int, v: int, signed: bool = False) -> None:
        if not v:
            self.rac(st, i, 1)
            return
        a = abs(v)
        e = a.bit_length() - 1
        self.rac(st, i, 0)
        for k in range(e):
            self.rac(st, i + 1 + min(k, 9), 1)
        self.rac(st, i + 1 + min(e, 9), 0)
        for k in range(e - 1, -1, -1):
            self.rac(st, i + 22 + min(k, 9), (a >> k) & 1)
        if signed:
            self.rac(st, i + 11 + min(e, 10), int(v < 0))

    def terminate(self) -> bytes:
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        return bytes(self.out)


class SnowCraft:
    """Snow frames written syntax element by element, carrying header
    values libavcodec's encoder never writes: every coefficient zero, so a
    key frame is flat grey and an inter frame is its blocks' prediction
    (by default inter blocks with zero vectors; ``blocks`` gives intra
    blocks of their own colours, which make a textured picture, and inter
    blocks with vectors into it).  The contexts carry over from frame to
    frame as the decoder's do (reset at a key frame)."""

    def __init__(self, w: int, h: int, count: int = 3):
        self.w, self.h, self.count = w, h, count
        self.planes = 3
        self.header = [128] * 32

    def _bands(self, r: RacWriter) -> None:
        # each band: runs = 0 (get_symbol2's first bit, state[30][4]), and
        # no coefficient at all
        for p in range(self.planes):
            for level in range(self.count):
                for o in range(0 if level == 0 else 1, 4):
                    r.rac(self.band[p, level, o], 30 * 32 + 4, 0)

    def key(self, always_reset=0, ttype=0, tcount=0, colorspace=0,
            shifts=(1, 1), scalability=0, mv_scale: int = 4,
            pad: int = 64) -> bytes:
        r = RacWriter()
        self.header = hs = [128] * 32
        self.block = [128] * (128 + 32 * 128)
        self.band = {(p, lv, o): [128] * 32 * 32 for p in range(3)
                     for lv in range(8) for o in range(4)}
        r.rac([128] * 32, 0, 1)                    # key frame
        r.symbol(hs, 0, 0)                         # version
        r.rac(hs, 0, always_reset)
        r.symbol(hs, 0, ttype)
        r.symbol(hs, 0, tcount)
        r.symbol(hs, 0, self.count)
        r.symbol(hs, 0, colorspace)
        if colorspace == 0:
            r.symbol(hs, 0, shifts[0])
            r.symbol(hs, 0, shifts[1])
        self.planes = 1 if colorspace == 1 else 3
        r.rac(hs, 0, scalability)
        r.symbol(hs, 0, 0)                         # max_ref_frames - 1
        for p in range(min(self.planes, 2)):       # the quantiser logs
            for level in range(self.count):
                for o in range(0 if level == 0 else 1, 4):
                    if o != 2:
                        r.symbol(hs, 0, 0, True)
        # type, qlog, mv_scale, qbias, depth
        for delta in (0, 0, mv_scale, 0, 0):
            r.symbol(hs, 0, delta, True)
        self._bands(r)
        self.nodes: dict = {}
        return r.terminate() + b"\0" * pad

    def _blocks(self, r: RacWriter, blocks: list) -> None:
        """decode_q_branch's syntax at block_max_depth 0, in raster order:
        ("intra", (y, cb, cr)) codes the colours against the left block's,
        ("inter", (mx, my)) the vector against pred_mv's median, each in
        the contexts its left and top neighbours give."""
        def av_log2(v):
            return max(v.bit_length() - 1, 0)

        null = {"type": 0, "mx": 0, "my": 0, "color": (128, 128, 128)}
        bw = -(-self.w // 16)
        for k, (kind, val) in enumerate(blocks):
            x, y = k % bw, k // bw
            left = self.nodes[x - 1, y] if x else null
            top = self.nodes[x, y - 1] if y else null
            tl = self.nodes[x - 1, y - 1] if x and y else left
            tr = self.nodes[x + 1, y - 1] if y and x + 1 < bw else tl
            pmx, pmy = (sorted((left[c], top[c], top[c] + tr[c] - left[c]))[1]
                        for c in ("mx", "my"))
            intra = kind == "intra"
            r.rac(self.block, 1 + left["type"] + top["type"], int(intra))
            if intra:
                for j, at in enumerate((32, 64, 96)[:self.planes]):
                    r.symbol(self.block, at, val[j] - left["color"][j], True)
                self.nodes[x, y] = {"type": 1, "mx": pmx, "my": pmy,
                                    "color": tuple(val)}
            else:
                cx = av_log2(2 * abs(left["mx"] - top["mx"]))
                cy = av_log2(2 * abs(left["my"] - top["my"]))
                r.symbol(self.block, 128 + 32 * cx, val[0] - pmx, True)
                r.symbol(self.block, 128 + 32 * cy, val[1] - pmy, True)
                self.nodes[x, y] = {"type": 0, "mx": val[0], "my": val[1],
                                    "color": left["color"]}

    def inter(self, diag_mc=1, htaps=6, hcoeff=(-10, 2, 0),
              blocks=None, update_mc: bool = True, pad: int = 64) -> bytes:
        """An inter frame that sends an MC filter (update_mc, unless
        ``update_mc`` is false): diag_mc, htaps and hcoeff[1..htaps/2]
        (libavcodec's defaults: 1, 6, -10/2/0); its blocks as ``_blocks``
        codes them (inter, zero vectors by default)."""
        r = RacWriter()
        hs = self.header
        r.rac([128] * 32, 0, 0)
        r.rac(hs, 0, int(update_mc))
        if update_mc:
            for _ in range(min(self.planes, 2)):
                r.rac(hs, 0, diag_mc)
                r.symbol(hs, 0, htaps // 2 - 1)
                for i in range(htaps // 2, 0, -1):
                    r.symbol(hs, 0, abs(hcoeff[i - 1]))
        r.rac(hs, 0, 0)                            # no new decomposition
        for _ in range(5):
            r.symbol(hs, 0, 0, True)
        n = -(-self.w // 16) * -(-self.h // 16)
        self._blocks(r, blocks or [("inter", (0, 0))] * n)
        self._bands(r)
        return r.terminate() + b"\0" * pad


def snow_crafted() -> dict:
    """{name: the packets} of the crafted Snow streams at 64x48: the
    defaults (which both readers decode, grey), then one header value
    libavcodec's encoder never writes in each."""
    def craft(first=None, second=None):
        c = SnowCraft(64, 48)
        return [c.key(**(first or {})),
                c.inter(**second) if second is not None else c.key(
                    **(first or {}))]
    def textured(**mc):
        # intra blocks of random colours, then inter blocks whose vectors
        # (eighth-pel luma at mv_scale 1) reach every sub-pel position the
        # filter makes, some past the picture's edges
        rng = np.random.default_rng(26)
        c = SnowCraft(64, 48)
        n = 4 * 3
        colours = [("intra", tuple(int(v) for v in rng.integers(0, 256, 3)))
                   for _ in range(n)]
        moves = [("inter", tuple(int(v) for v in rng.integers(-40, 41, 2)))
                 for _ in range(n)]
        return [c.key(mv_scale=1), c.inter(blocks=colours, **mc),
                c.inter(blocks=moves, update_mc=False)]

    return {"default": craft(second={}),
            "always_reset": craft({"always_reset": 1}),
            "temporal_type": craft({"ttype": 1}),
            "temporal_count": craft({"tcount": 2}),
            "scalability": craft({"scalability": 1}),
            "colorspace2": craft({"colorspace": 2}),
            "shifts10": craft({"shifts": (1, 0)}),
            "shifts33": craft({"shifts": (3, 3)}),
            "htaps4": craft(second={"htaps": 4, "hcoeff": (-6, 2)}),
            "diag_mc0": craft(second={"diag_mc": 0}),
            "textured_htaps4": textured(htaps=4, hcoeff=(-6, 2)),
            "textured_htaps6": textured(hcoeff=(-12, 4, -1)),
            "textured_diag_mc0": textured(diag_mc=0),
            "textured_default": textured()}


def snow_fixtures() -> None:
    """Snow (fourcc ``SNOW``) as cv2 writes and reads it: 25 frames of the
    moving clip (key frames at 0, 12 and 24) in .avi, .mkv, .mov and .wmv,
    a 53x37 input in .avi, .wmv at 24 fps, and the Sintel pair's 13 frames
    at 436x1024 in .avi, which the card run reads.  From libavcodec's
    ``snow`` encoder (``Lavc.encode_intra``), muxed by ``snow_avi``: a
    53x37 picture (odd planes), the 5/3 wavelet, lossless, quarter-pel vectors, blocks split (``+mv4``),
    three references, iterative motion search, ``memc_only`` (key frames
    without coefficients, which FFmpeg refuses: cv2 reads no frame), key
    frames only, yuv410p, yuv444p and gray, a quantiser ladder through
    ``+qscale`` (frame qualities 1, 4, 12, 31), and qpel, mv4, two
    references and iterative search together.  And the crafted streams
    of ``snow_crafted`` (``SnowCraft``): each header value the encoder
    never writes, and the defaults."""
    def out(name):
        return os.path.join(OUT, name)
    clip = moving_clip(64, 96, 25, seed=60, speed=3.0)
    for ext in ("avi", "mkv", "mov", "wmv"):
        _cv2_write(out(f"snow_96x64.{ext}"), clip, "SNOW")
    _cv2_write(out("snow_53x37.avi"), moving_clip(37, 53, 14, seed=61),
               "SNOW")
    _cv2_write(out("snow_24fps_96x64.wmv"), clip[:14], "SNOW", fps=24)
    im1, im2 = sintel_pair()
    _cv2_write(out("snow_sintel_436x1024.avi"),
               [im1 if i % 2 == 0 else im2 for i in range(13)], "SNOW")
    lavc = Lavc()

    def lavc_avi(name, frames, pix="yuv420p", quality=None, **opts):
        h, w = frames[0].shape[:2]
        _, pk = lavc.encode_intra(frames, "snow", pix, quality=quality,
                                  **{"g": 12, **opts})
        snow_avi(out(name), [p for p, _ in pk], w, h)

    small = moving_clip(48, 64, 14, seed=62, speed=3.0)
    # odd planes: 53x37 luma, 27x19 chroma
    lavc_avi("snow_lavc_53x37.avi", moving_clip(37, 53, 14, seed=61))
    lavc_avi("snow_lavc_dwt53_64x48.avi", small, pred="dwt53")
    lavc_avi("snow_lavc_lossless_64x48.avi", small, pred="dwt53",
             flags="+qscale", global_quality=0)
    lavc_avi("snow_lavc_qpel_64x48.avi", small, flags="+qpel")
    lavc_avi("snow_lavc_mv4_64x48.avi", small, flags="+mv4")
    lavc_avi("snow_lavc_refs3_64x48.avi", small, refs=3)
    lavc_avi("snow_lavc_iter_64x48.avi", small, motion_est="iter")
    lavc_avi("snow_lavc_memc_only_64x48.avi", small[:4], memc_only=1)
    lavc_avi("snow_lavc_g1_64x48.avi", small[:4], g=1)
    for pix in ("yuv410p", "yuv444p", "gray"):
        lavc_avi(f"snow_lavc_{pix}_64x48.avi", small, pix=pix)
    for q in (1, 4, 12, 31):
        lavc_avi(f"snow_lavc_q{q}_64x48.avi", small, quality=q * 118,
                 flags="+qscale", global_quality=q * 118)
    # (at 53x37 libavcodec's encoder crashes with these options)
    lavc_avi("snow_lavc_combo_64x48.avi", moving_clip(48, 64, 14, seed=63,
                                                      speed=4.0),
             flags="+qpel+mv4", refs=2, motion_est="iter")
    for name, packets in snow_crafted().items():
        snow_avi(out(f"snow_craft_{name}_64x48.avi"), packets, 64, 48)

NUT_FOURCCS = ("mp4v", "XVID", "MJPG", "mpg2", "FLV1", "MP42", "DIV3", "WMV1",
               "WMV2", "SNOW", "VP80", "VP90", "FFV1", "HFYU", "FFVH", "ULY0",
               "M8Y0", "MPNG", "ASV1", "ASV2", "Y800", "I420")
# lossless and raw: 6 frames, to keep the group small
NUT_SHORT = ("FFV1", "HFYU", "FFVH", "ULY0", "M8Y0", "MPNG", "Y800", "I420")


def nut_crafted(src: str) -> dict:
    """cv2's own ``.nut`` bytes cut or damaged: {name: bytes}: cut before
    its index packet, its second syncpoint's checksum flipped, its main
    header's checksum flipped, its last frame (an I-VOP) cut in half, and
    the file cut in half inside the P-VOP before it."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.nut import (INDEX, MAIN, SYNCPOINT,
                                              NutFile, _Reader)
    with open(src, "rb") as f:
        data = f.read()
    nut = NutFile(src)

    def flipped(code: int, at: int) -> bytes:
        end = nut._packet(_Reader(data, at + 8), code)
        out = bytearray(data)
        out[end - 1] ^= 0x5A          # the packet's CRC-32
        return bytes(out)

    last, pvop = nut.frames_[-1], nut.frames_[-2]
    return {"noindex": data[:data.rfind(INDEX.to_bytes(8, "big"))],
            "badsyncpoint": flipped(SYNCPOINT, nut.syncpoints[1][0]),
            "badmain": flipped(MAIN, data.find(MAIN.to_bytes(8, "big"))),
            "truncated": data[:last.offset + last.size // 2],
            "truncated_pvop": data[:pvop.offset + pvop.size // 2]}


def nut_fixtures() -> None:
    """NUT as cv2 writes and reads it: every fourcc the port decodes at
    96x64 over the moving clip (25 frames, key frames every 12 where the
    codec has inter frames; the lossless and raw ones at 6 frames),
    ``H263`` at 128x96, fourcc 0 (cv2 writes raw I420), a 53x37 ``mp4v``
    (cv2 writes 52x36) and one at 30000/1001 fps; and ``nut_crafted``'s
    damage to the ``mp4v`` file (Dirac in NUT is in ``dirac_fixtures``)."""
    def out(name):
        return os.path.join(OUT, name)
    clip = moving_clip(64, 96, 25, seed=60, speed=3.0)
    for fourcc in NUT_FOURCCS:
        _cv2_write(out(f"nut_{fourcc}_96x64.nut"),
                   clip[:6] if fourcc in NUT_SHORT else clip, fourcc)
    _cv2_write(out("nut_H263_128x96.nut"),
               moving_clip(96, 128, 25, seed=60, speed=3.0), "H263")
    import cv2
    h, w = clip[0].shape[:2]
    wr = cv2.VideoWriter(out("nut_raw_96x64.nut"), 0, 25.0, (w, h))
    for f in clip[:6]:
        wr.write(f)
    wr.release()
    _cv2_write(out("nut_odd_53x37.nut"),
               moving_clip(37, 53, 14, seed=61, speed=5.0), "mp4v")
    _cv2_write(out("nut_ntsc_96x64.nut"), clip, "mp4v", fps=30000 / 1001)
    for name, data in nut_crafted(out("nut_mp4v_96x64.nut")).items():
        with open(out(f"nut_craft_{name}_96x64.nut"), "wb") as f:
            f.write(data)


def dirac_fixtures() -> None:
    """Dirac/VC-2 (fourcc ``drac``: libavcodec's ``vc2`` encoder, HQ
    profile, intra only) as cv2 writes and reads it: 25 frames of the
    moving clip in .drc, .avi, .mkv, .mov, .mp4, .ts, .nut and .wmv (cv2
    writes no .flv or .webm of it), a 53x37 input in .avi (cv2 writes
    52x36) and the Sintel pair's 13 frames at 436x1024 in .nut, which the
    card run reads.  From ``Lavc.encode`` (4 frames, muxed by
    ``lossless_avi`` under ``drac``): the (5,3), Haar and Haar-without-shift wavelets,
    depths 1, 2, 3 and 5, 64x64 slices, the flat and colour quantisation
    matrices, a low and a high bit rate, full range, field coding (which
    FFmpeg refuses: cv2 reads no frame), yuv422p, yuv444p (also at 53x37)
    and yuv420p10 (its samples the 8-bit ones shifted); with every bit of
    the deeper samples used, yuv420p10, yuv422p10, yuv444p10 (also at
    53x37) and yuv420p12."""
    def out(name):
        return os.path.join(OUT, name)
    clip = moving_clip(64, 96, 25, seed=70, speed=3.0)
    for ext in ("drc", "avi", "mkv", "mov", "mp4", "ts", "nut", "wmv"):
        _cv2_write(out(f"dirac_96x64.{ext}"), clip, "drac")
    _cv2_write(out("dirac_53x37.avi"), moving_clip(37, 53, 14, seed=71,
                                                   speed=5.0), "drac")
    im1, im2 = sintel_pair()
    _cv2_write(out("dirac_sintel_436x1024.nut"),
               [im1 if i % 2 == 0 else im2 for i in range(13)], "drac")
    lavc = Lavc()

    def lavc_avi(name, frames, pix="yuv420p", fine=False, **opts):
        h, w = frames[0].shape[:2]
        # a deeper format's planes are its 8-bit layout's, scaled up
        planes = [lavc_planes(f, pix.rstrip("0123456789")) for f in frames]
        if pix.endswith(("10", "12")):  # deeper samples, from the 8-bit ones
            shift = int(pix[-2:]) - 8
            rng = np.random.default_rng(74)
            # ``fine``: the bits below the 8-bit ones random too
            planes = [[(p.astype(np.uint16) << shift) + (
                rng.integers(0, 1 << shift, p.shape, np.uint16) if fine
                else 0) for p in pl] for pl in planes]
        pk = lavc.encode(planes, "vc2", pix=pix, **opts)
        lossless_avi(out(name), [p for p, _, _ in pk], w, h, "drac")

    small = moving_clip(48, 64, 4, seed=72, speed=3.0)
    for wavelet in ("5_3", "haar", "haar_noshift"):
        lavc_avi(f"dirac_lavc_{wavelet}_64x48.avi", small,
                 wavelet_type=wavelet)
    for depth in (1, 2, 3, 5):
        lavc_avi(f"dirac_lavc_depth{depth}_64x48.avi", small,
                 wavelet_depth=depth)
    lavc_avi("dirac_lavc_slices64_128x128.avi",
             moving_clip(128, 128, 4, seed=73, speed=3.0),
             slice_width=64, slice_height=64)
    for qm in ("flat", "color"):
        lavc_avi(f"dirac_lavc_qm_{qm}_64x48.avi", small, qm=qm)
    lavc_avi("dirac_lavc_b100k_64x48.avi", small, b=100000)
    lavc_avi("dirac_lavc_b50m_64x48.avi", small[:3], b=50000000)
    lavc_avi("dirac_lavc_fullrange_64x48.avi", small, color_range="pc")
    lavc_avi("dirac_lavc_interlaced_64x48.avi", small[:2], field_order="tt")
    for pix in ("yuv422p", "yuv444p", "yuv420p10"):
        lavc_avi(f"dirac_lavc_{pix}_64x48.avi", small, pix=pix)
    lavc_avi("dirac_lavc_yuv444p_53x37.avi", moving_clip(37, 53, 4, seed=71,
                                                         speed=5.0),
             pix="yuv444p")
    # deeper samples with every bit used: 4:2:0, 4:2:2 and 4:4:4 at 10
    # bits, 4:2:0 at 12, and an odd size (the encoder writes video range
    # alone above 8 bits)
    for pix in ("yuv420p10", "yuv422p10", "yuv444p10", "yuv420p12"):
        lavc_avi(f"dirac_lavc_{pix}_fine_64x48.avi", small, pix=pix,
                 fine=True)
    lavc_avi("dirac_lavc_yuv444p10_53x37.avi",
             moving_clip(37, 53, 4, seed=71, speed=5.0), pix="yuv444p10",
             fine=True)


def _nut_cut(src: str, dst: str, frac: float) -> None:
    """``src``'s bytes cut ``frac`` of the way into its last frame."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.nut import NutFile
    with open(src, "rb") as f:
        data = f.read()
    last = NutFile(src).frames_[-1]
    with open(dst, "wb") as f:
        f.write(data[:last.offset + int(last.size * frac)])


def mpeg4_concealment(path: str) -> dict:
    """The port's MPEG-4 decoder's account of the cut last frame of a
    ``.nut`` (``runtime/mpeg4.Decoder.concealment``)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.nut import NutFile
    from opticalflow_tpu_torch.runtime.mpeg4 import Decoder
    nut = NutFile(path)
    dec = Decoder(nut.dsi, tag=nut.tag)
    with open(path, "rb") as f:
        for i in range(len(nut.sizes)):
            dec.decode(nut.sample(f, i), cut=nut.is_cut(i))
    return dec.concealment


def cut_vop_fixtures() -> None:
    """MPEG-4 VOPs cut short, which FFmpeg's error resilience conceals:
    cv2's mp4v writer over 15 frames of the moving clip at 176x144 in
    ``.nut`` (I-VOPs at 0 and 12: a syncpoint before the cut, which sets
    cv2's count), its last P-VOP cut at 35% (the data ends its slice
    early: the rest missing, guess_mv searches from the macroblocks kept)
    and at 80% (a macroblock fails: its vector is what its decoding left,
    guess_mv searches); libavcodec's mpeg4 (I-VOPs every 4) over 6 frames
    of it and a picture of flat 16x16 blocks (its macroblocks coded
    intra), muxed by the port's NUT writer and cut at 85% (the damaged
    macroblocks taken as intra: guess_dc's spatial concealment); and an
    I-VOP (cv2's writer, 13 frames) cut at 85% with enough macroblocks
    undamaged that is_intra_more_likely weighs their SAD against the
    picture before: the clip going on (temporal) and a cut to the flat
    picture there (spatial).  Each file's ``mpeg4_concealment`` in the
    manifest is what the port did."""
    def out(name):
        return os.path.join(OUT, name)
    src = os.path.join(OUT, "cut_vop_source.nut")
    _cv2_write(src, moving_clip(144, 176, 15, seed=90, speed=2.5), "mp4v")
    _nut_cut(src, out("pvop_ended_176x144.nut"), 0.35)
    _nut_cut(src, out("pvop_search_176x144.nut"), 0.8)
    clip = moving_clip(144, 176, 6, seed=90, speed=2.5)
    rng = np.random.default_rng(5)
    flat = np.kron(rng.integers(0, 256, (9, 11, 3)),
                   np.ones((16, 16, 1))).astype(np.uint8)
    pk = Lavc().encode([bgr_i420(f) for f in clip + [flat]], "mpeg4",
                       pix="yuv420p", sc_threshold=1000000000, bf=0, g=4)
    vop = pk[0][0].find(b"\x00\x00\x01\xb6")
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.nut import NutWriter
    wr = NutWriter(src, (176, 144), (25, 1), pk[0][0][:vop])
    for i, (data, _, _) in enumerate(pk):
        wr.write(data[vop:] if i == 0 else data, i % 4 == 0)
    wr.release()
    _nut_cut(src, out("pvop_spatial_176x144.nut"), 0.85)
    clip = moving_clip(144, 176, 13, seed=90, speed=2.5)
    for name, frames in (("temporal", clip), ("spatial", clip[:12] + [flat])):
        _cv2_write(src, frames, "mp4v")
        _nut_cut(src, out(f"ivop_sad_{name}_176x144.nut"), 0.85)
    os.remove(src)


def j2k_segments(cs: bytes) -> tuple:
    """A JPEG 2000 codestream's main header: ([marker segment, ...] after
    SOC, each with its marker and length, up to the first SOT; the rest
    from that SOT on)."""
    assert cs[:2] == b"\xff\x4f", "not a codestream"
    pos, segs = 2, []
    while cs[pos:pos + 2] != b"\xff\x90":
        n = int.from_bytes(cs[pos + 2:pos + 4], "big")
        segs.append(cs[pos:pos + 2 + n])
        pos += 2 + n
    return segs, cs[pos:]


def j2k_with(cs: bytes, mct=None, poc: bool = False, coc: bool = False,
             qcc: bool = False) -> bytes:
    """A codestream with its main header rewritten: COD's multiple
    component transform byte set to ``mct``; a POC marker naming the
    progression COD names over every layer, level and component (the
    same packet order); a COC for component 0 and a QCC for component 1
    repeating COD's and QCD's parameters (the same decoding)."""
    segs, rest = j2k_segments(cs)
    out = []
    for seg in segs:
        if seg[:2] == b"\xff\x52":
            cod = bytearray(seg)
            if mct is not None:
                cod[8] = mct
            out.append(bytes(cod))
            siz = next(x for x in segs if x[:2] == b"\xff\x51")
            ncomp = int.from_bytes(siz[38:40], "big")
            if poc:
                body = bytes([0, 0]) + cod[6:8] + bytes([cod[9] + 1, ncomp,
                                                         cod[5]])
                out.append(b"\xff\x5f" + (2 + len(body)).to_bytes(2, "big")
                           + body)
            if coc:
                body = bytes([0, cod[4] & 1]) + bytes(cod[9:])
                out.append(b"\xff\x53" + (2 + len(body)).to_bytes(2, "big")
                           + body)
        elif seg[:2] == b"\xff\x5c" and qcc:
            out.append(seg)
            body = bytes([1]) + seg[4:]
            out.append(b"\xff\x5d" + (2 + len(body)).to_bytes(2, "big")
                       + body)
        else:
            out.append(seg)
    return b"\xff\x4f" + b"".join(out) + rest


def j2k_tile_parts(cs: bytes) -> bytes:
    """A codestream whose every tile (its packets led by SOP markers) is
    split into two tile-parts at a packet in its middle, the first parts
    of all tiles before the second ones, as Part 1 allows."""
    segs, rest = j2k_segments(cs)
    tiles = []
    while rest[:2] == b"\xff\x90":
        isot = int.from_bytes(rest[4:6], "big")
        psot = int.from_bytes(rest[6:10], "big")
        body = rest[14:psot]            # after SOT and SOD
        assert rest[12:14] == b"\xff\x93"
        sops = [i for i in range(len(body) - 3)
                if body[i:i + 4] == b"\xff\x91\x00\x04"]
        cut = sops[len(sops) // 2]
        tiles.append((isot, body[:cut], body[cut:]))
        rest = rest[psot:]

    def part(isot, k, data):
        return (b"\xff\x90\x00\x0a" + isot.to_bytes(2, "big")
                + (14 + len(data)).to_bytes(4, "big") + bytes([k, 2])
                + b"\xff\x93" + data)
    parts = [part(i, 0, a) for i, a, _ in tiles]
    parts += [part(i, 1, b) for i, _, b in tiles]
    return b"\xff\x4f" + b"".join(segs) + b"".join(parts) + rest


def jpeg2000_fixtures() -> None:
    """JPEG 2000 (fourcc ``MJ2C``: libavcodec's ``jpeg2000`` encoder, a
    JP2 file a frame) as cv2 writes and reads it: 12 frames of the moving
    clip at 96x64 and 6 at 53x37 in .avi, .mkv, .mov, .mp4, .nut and
    .wmv, and 5 frames of the Sintel pair at 436x1024 in .avi, which the
    card run reads.  From ``Lavc.encode_intra`` (4 frames at 96x64, muxed
    by ``lossless_avi`` under ``MJ2C``): the reversible 5/3, every
    progression order (with 32x32 tiles and two quality layers), tiles
    smaller than the picture (also at 53x37), SOP and EPH markers (each
    frame from a fresh encoder: the encoder's later frames with SOP are
    damaged), quality layers, bare codestreams (``format=j2k``; 4:4:4 then
    reads as RGB), and rgb24, yuv444p, yuv422p, yuv410p, yuv411p, yuv440p,
    gray, rgba and yuva420p/422p/444p (4:4:4 with alpha also as a bare
    codestream: rgba); above 8 bits, with grey's alpha and palettes,
    ``jpeg2000_deep``'s. Crafted from codestreams: the ICT and the RCT (COD's transform byte
    set over 4:4:4), a POC marker, COC and QCC markers, and tiles split
    into tile-parts."""
    def out(name):
        return os.path.join(OUT, name)
    clip = moving_clip(64, 96, 12, seed=80, speed=3.0)
    odd = moving_clip(37, 53, 6, seed=81, speed=5.0)
    for ext in ("avi", "mkv", "mov", "mp4", "nut", "wmv"):
        _cv2_write(out(f"j2k_96x64.{ext}"), clip, "MJ2C")
        _cv2_write(out(f"j2k_53x37.{ext}"), odd, "MJ2C")
    im1, im2 = sintel_pair()
    _cv2_write(out("j2k_sintel_436x1024.avi"), [im1, im2] * 2 + [im1],
               "MJ2C")
    lavc = Lavc()
    small = clip[:4]

    def lavc_avi(name, frames, pix="yuv420p", fresh=False, craft=None,
                 **opts):
        h, w = frames[0].shape[:2]
        if fresh:
            pk = [lavc.encode_intra([f], "jpeg2000", pix, **opts)[1][0][0]
                  for f in frames]
        else:
            pk = [p for p, _ in lavc.encode_intra(frames, "jpeg2000", pix,
                                                   **opts)[1]]
        if craft is not None:
            pk = [craft(p) for p in pk]
        lossless_avi(out(name), pk, w, h, "MJ2C")

    lavc_avi("j2k_lavc_dwt53_96x64.avi", small, pred="dwt53")
    for prog in ("rlcp", "rpcl", "pcrl", "cprl"):
        lavc_avi(f"j2k_lavc_{prog}_96x64.avi", small, prog=prog,
                 tile_width=32, tile_height=32, layer_rates="30,10")
    lavc_avi("j2k_lavc_tiles_96x64.avi", small, tile_width=32,
             tile_height=16)
    lavc_avi("j2k_lavc_tiles53_53x37.avi", odd[:4], pred="dwt53",
             tile_width=16, tile_height=16)
    lavc_avi("j2k_lavc_sop_eph_96x64.avi", small, fresh=True, sop=1, eph=1)
    lavc_avi("j2k_lavc_layers_96x64.avi", small, layer_rates="40,20,5")
    lavc_avi("j2k_lavc_codestream_96x64.avi", small, format="j2k")
    for pix in ("rgb24", "yuv444p", "yuv422p", "yuv410p", "yuv411p",
                "yuv440p", "gray", "rgba", "yuva420p", "yuva422p",
                "yuva444p"):
        lavc_avi(f"j2k_lavc_{pix}_96x64.avi", small, pix=pix)
    lavc_avi("j2k_lavc_yuva444p_j2k_96x64.avi", small, pix="yuva444p",
             format="j2k")
    lavc_avi("j2k_lavc_gray53_96x64.avi", small, pix="gray", pred="dwt53")
    lavc_avi("j2k_lavc_444j2k_53x37.avi", odd[:4], pix="yuv444p",
             format="j2k")
    lavc_avi("j2k_craft_ict_96x64.avi", small, pix="yuv444p", format="j2k",
             craft=lambda p: j2k_with(p, mct=1))
    lavc_avi("j2k_craft_rct_96x64.avi", small, pix="yuv444p", format="j2k",
             pred="dwt53", craft=lambda p: j2k_with(p, mct=1))
    lavc_avi("j2k_craft_poc_coc_qcc_96x64.avi", small, format="j2k",
             layer_rates="30,10", prog="rlcp",
             craft=lambda p: j2k_with(p, poc=True, coc=True, qcc=True))
    lavc_avi("j2k_craft_tile_parts_96x64.avi", small, format="j2k",
             fresh=True, sop=1, tile_width=48, tile_height=64,
             craft=j2k_tile_parts)
    jpeg2000_deep(lavc, small)


# the layouts of jpeg2000_deep: (libavcodec's pixel format, the wrapper);
# 4:4:4 as a bare codestream reads as rgb48 at 10 bits, as rgba with alpha
J2K_DEEP = (("yuv420p9", "jp2"), ("yuv420p10", "jp2"), ("yuv422p10", "jp2"),
            ("yuv444p12", "jp2"), ("yuv420p14", "jp2"), ("yuv420p16", "jp2"),
            ("yuv444p10", "j2k"), ("gray12", "jp2"), ("gray16", "jp2"),
            ("rgb48", "jp2"), ("yuva420p10", "jp2"), ("ya8", "jp2"),
            ("ya16", "jp2"), ("rgba64", "jp2"), ("pal8", "jp2"))


def jpeg2000_deep(lavc: "Lavc", frames: list) -> None:
    """JPEG 2000 in the layouts ``lavc_planes`` does not make (group
    jpeg2000): ``frames``' planes at each of ``J2K_DEEP``'s depths with
    every bit used (the 8-bit samples shifted up, the bits below them
    seeded noise; alpha from the red channel), grey with alpha, and 16
    colours of a seeded palette, through libavcodec's encoder
    (``Lavc.encode``), muxed by ``lossless_avi`` under ``MJ2C``."""
    rng = np.random.default_rng(83)
    h, w = frames[0].shape[:2]
    for pix, wrap in J2K_DEEP:
        base, bits = re.match(r"(yuva?4\d\dp|gray|rgba?|ya|pal)(\d+)",
                              pix).groups()
        bits = {"rgb": 16, "rgba": 16, "pal": 8}.get(base, int(bits))
        planes = []
        for f in frames:
            if base == "pal":       # 16 indices, 256 seeded colours
                planes.append([(f[..., 1] >> 4).astype(np.uint8),
                               rng.integers(0, 256, (1, 1024), np.uint8)])
                continue
            pl = ([f[..., 1]] if base == "gray" else
                  [np.stack([f[..., 1], f[..., 2]], -1).reshape(h, -1)]
                  if base == "ya" else
                  [np.ascontiguousarray(f[..., ::-1]).reshape(h, -1)]
                  if base == "rgb" else
                  [np.concatenate([f[..., ::-1], f[..., 2:]], -1).reshape(h, -1)]
                  if base == "rgba" else lavc_planes(f, base))
            planes.append([p if bits == 8 else (p.astype(np.uint16) << (
                bits - 8)) + rng.integers(0, 1 << (bits - 8), p.shape,
                                          np.uint16) for p in pl])
        fmt = pix + ("le" if bits > 8 else "")
        pk = lavc.encode(planes, "jpeg2000", pix=fmt, format=wrap)
        name = f"j2k_lavc_{pix}{'_j2k' if wrap == 'j2k' else ''}_{w}x{h}.avi"
        lossless_avi(os.path.join(OUT, name), [p for p, _, _ in pk], w, h,
                     "MJ2C")


def tag_fixtures() -> None:
    """The fourccs and sample entries cv2's writer uses for codecs the port
    reads under other tags: MPEG-4 Part 2 under ``3IV2`` (.avi, .mov,
    .nut, .wmv), ``XVID`` and ``DIVX`` (.mov), Motion JPEG under ``LJPG``
    (.avi, .nut, .wmv), MPEG-1/2 under ``mpg1`` and ``mpg2`` (.mov: the
    ``m1v `` and ``m2v1`` entries), raw ``NV12``, ``Y41B`` and ``Y8  ``
    (.avi, .mkv, .nut, .wmv) and libavcodec's ``yuv4`` (.avi, .mkv, .mov,
    .nut, .wmv); 6 frames of the moving clip at 64x48 each (the raw ones
    and yuv4 4)."""
    clip = moving_clip(48, 64, 6, seed=85, speed=3.0)
    plan = [("3IV2", ("avi", "mov", "nut", "wmv")), ("XVID", ("mov",)),
            ("DIVX", ("mov",)), ("LJPG", ("avi", "nut", "wmv")),
            ("mpg1", ("mov",)), ("mpg2", ("mov",)),
            ("NV12", ("avi", "mkv", "nut", "wmv")),
            ("Y41B", ("avi", "mkv", "nut", "wmv")),
            ("Y8  ", ("avi", "mkv", "nut", "wmv")),
            ("yuv4", ("avi", "mkv", "mov", "nut", "wmv"))]
    for fourcc, exts in plan:
        short = fourcc in ("NV12", "Y41B", "Y8  ", "yuv4")
        for ext in exts:
            _cv2_write(os.path.join(OUT, f"tag_{fourcc.strip()}_64x48.{ext}"),
                       clip[:4] if short else clip, fourcc)


def tiff_fixtures() -> None:
    """TIFF as cv2 writes and reads it (fourcc ``tiff``: libavcodec's
    encoder, PackBits, YCbCr 4:2:0, strips of 56 rows) in .avi, .mkv
    (``V_QUICKTIME``), .mov and .nut, 6 frames of the moving clip at
    96x64, and 3 at 53x37 in .avi (the odd size's last chroma row and
    column)."""
    clip = moving_clip(64, 96, 6, seed=310)
    for ext in ("avi", "mkv", "mov", "nut"):
        _cv2_write(os.path.join(OUT, f"tiff_96x64.{ext}"), clip, "tiff")
    _cv2_write(os.path.join(OUT, "tiff_53x37.avi"),
               moving_clip(37, 53, 3, seed=311), "tiff")


# the TIFF sequences (image2 patterns) tiff_seq_fixtures writes: name →
# (PIL mode, compression, extra TIFF tags, the Compression tag patched to)
TIFF_SEQ = {
    "tifseq_raw_rgb_53x37_%d.tif": ("RGB", "raw", {}, None),
    "tifseq_packbits_rgb_53x37_%d.tif": ("RGB", "packbits", {}, None),
    "tifseq_lzw_rgb_53x37_%d.tif": ("RGB", "tiff_lzw", {278: 8}, None),
    "tifseq_deflate_rgb_53x37_%d.tif": ("RGB", "tiff_adobe_deflate", {},
                                        None),
    "tifseq_deflate32946_rgb_53x37_%d.tif": ("RGB", "tiff_adobe_deflate",
                                             {}, 32946),
    "tifseq_pred_rgb_53x37_%d.tif": ("RGB", "tiff_lzw", {317: 2}, None),
    "tifseq_raw_gray_53x37_%d.tif": ("L", "raw", {}, None),
    "tifseq_raw_gray16_53x37_%d.tif": ("I;16", "raw", {}, None),
    "tifseq_pred_gray16_53x37_%d.tif": ("I;16", "tiff_adobe_deflate",
                                        {317: 2}, None),
    "tifseq_be_gray16_53x37_%d.tif": ("I;16B", "raw", {}, None),
}


def tiff_patch_compression(path: str, value: int) -> None:
    """The Compression entry (259) of a little-endian TIFF's first IFD set
    to ``value`` (Deflate's 8 and 32946 name the same coding)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    off = struct.unpack("<I", data[4:8])[0]
    for k in range(struct.unpack("<H", data[off:off + 2])[0]):
        e = off + 2 + 12 * k
        if struct.unpack("<H", data[e:e + 2])[0] == 259:
            struct.pack_into("<H", data, e + 8, value)
    with open(path, "wb") as f:
        f.write(data)


def tiff_seq_fixtures() -> None:
    """TIFF image sequences as PIL writes them (``%d.tif`` patterns, 3
    frames at 53x37 each): RGB uncompressed, PackBits, LZW (strips of 8
    rows), Deflate (Compression 8, and patched to 32946) and LZW with
    Predictor 2; 8-bit grey; 16-bit grey uncompressed, Deflate with
    Predictor 2, and big-endian (``I;16B``)."""
    from PIL import Image
    clip = moving_clip(37, 53, 3, seed=312)
    rng = np.random.default_rng(313)
    for pattern, (mode, comp, tags, patch) in TIFF_SEQ.items():
        for i, f in enumerate(clip):
            path = os.path.join(OUT, pattern % i)
            if mode == "RGB":
                im = Image.fromarray(np.ascontiguousarray(f[..., ::-1]))
            elif mode == "L":
                im = Image.fromarray(f[..., 1])
            else:
                g = (f[..., 1].astype(np.uint16) * 257
                     + rng.integers(0, 256, f.shape[:2])).astype(np.uint16)
                im = Image.frombytes(mode, (53, 37), g.astype(
                    ">u2" if mode == "I;16B" else "<u2").tobytes())
            im.save(path, compression=comp, tiffinfo=tags)
            if patch:
                tiff_patch_compression(path, patch)


# the frames each JPEG-LS fixture was written from (lossless: the frames
# read back equal them), by file; the manifest records their digests
JPEGLS_WRITTEN: dict = {}


def jpegls_lse(packet: bytes, params=(255, 3, 7, 21, 64)) -> bytes:
    """A JPEG-LS picture with an LSE marker of type 1 (MAXVAL, T1, T2,
    T3, RESET) before its scan: the defaults the coding used, restated
    (libavcodec's encoder writes LSE only for parameters it never picks)."""
    i = packet.find(b"\xff\xda")
    return (packet[:i] + b"\xff\xf8" + struct.pack(">HB5H", 13, 1, *params)
            + packet[i:])


def jpegls_fixtures() -> None:
    """JPEG-LS as cv2 writes and reads it (fourcc ``MJLS``: SOF55,
    line-interleaved RGB, NEAR 0) in .avi, .mkv, .mov, .nut and .wmv, 6
    frames of the moving clip at 96x64; from libavcodec's encoder through
    ctypes one grey component (ILV 0) at 53x37, and the colour clip with
    an LSE marker restating the default parameters, both in .avi; and the
    first Sintel frame at 436x1024 (cv2's writer, .avi), which the card
    run decodes."""
    clip = moving_clip(64, 96, 6, seed=314)
    for ext in ("avi", "mkv", "mov", "nut", "wmv"):
        name = f"jpegls_96x64.{ext}"
        _cv2_write(os.path.join(OUT, name), clip, "MJLS")
        JPEGLS_WRITTEN[name] = clip
    lavc = Lavc()
    odd = moving_clip(37, 53, 3, seed=315)
    _, pk = lavc.encode_intra(odd, "jpegls", "gray")
    lossless_avi(os.path.join(OUT, "jpegls_gray_53x37.avi"),
                 [p for p, _ in pk], 53, 37, "MJLS", bpc=8)
    JPEGLS_WRITTEN["jpegls_gray_53x37.avi"] = [
        np.repeat(f[..., 1:2], 3, axis=2) for f in odd]
    _, pk = lavc.encode_intra(clip[:3], "jpegls", "rgb24")
    lossless_avi(os.path.join(OUT, "jpegls_lse_96x64.avi"),
                 [jpegls_lse(p) for p, _ in pk], 96, 64, "MJLS")
    JPEGLS_WRITTEN["jpegls_lse_96x64.avi"] = clip[:3]
    sintel = sintel_pair()[:1]
    _cv2_write(os.path.join(OUT, "jpegls_sintel_436x1024.avi"), sintel, "MJLS")
    JPEGLS_WRITTEN["jpegls_sintel_436x1024.avi"] = sintel


def speedhq_fixtures() -> None:
    """SpeedHQ as cv2 writes and reads it (fourcc ``SHQ0``: libavcodec's
    encoder, 4:2:0) in .avi, .mkv, .mov, .nut and .wmv, 6 frames of the
    moving clip at 96x64; in .avi 3 frames at 96x37 (a partial last
    macroblock row) and of seeded noise at 176x144 (the escape codes); and
    the Sintel pair at 436x1024, which the card run decodes."""
    import cv2
    clip = moving_clip(64, 96, 6, seed=316)
    for ext in ("avi", "mkv", "mov", "nut", "wmv"):
        _cv2_write(os.path.join(OUT, f"speedhq_96x64.{ext}"), clip, "SHQ0")
    _cv2_write(os.path.join(OUT, "speedhq_96x37.avi"),
               moving_clip(37, 96, 3, seed=317), "SHQ0")
    rng = np.random.default_rng(318)
    noise = [cv2.GaussianBlur(rng.integers(0, 256, (144, 176, 3), np.uint8),
                              (0, 0), 0.6) for _ in range(3)]
    _cv2_write(os.path.join(OUT, "speedhq_noise_176x144.avi"), noise, "SHQ0")
    _cv2_write(os.path.join(OUT, "speedhq_sintel_436x1024.avi"),
               sintel_pair(), "SHQ0")


def flv_vp9_fixtures() -> None:
    """VP9 in enhanced FLV as cv2 writes and reads it (fourccs ``VP90`` and
    ``VP09``: FFmpeg's flv muxer falls back to the ``vp09`` FourCC of the
    extended tag header), 12 frames of the moving clip at 96x64 and 6 at
    53x37."""
    _cv2_write(os.path.join(OUT, "flv_vp9_96x64.flv"),
               moving_clip(64, 96, 12, seed=319), "VP90")
    _cv2_write(os.path.join(OUT, "flv_vp9_vp09_53x37.flv"),
               moving_clip(37, 53, 6, seed=320), "VP09")


def sintel_pair() -> list:
    import cv2
    jpeg = os.path.join(HERE, "goldens", "jpeg")
    return [cv2.imread(os.path.join(jpeg, f"sintel_im{k}.jpg"))
            for k in (1, 2)]


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    if sys.argv[1:2] == ["--new"]:
        # only the named fixture functions' files (stream_fixtures if none)
        for name in sys.argv[2:] or ["stream_fixtures"]:
            run_group(globals()[name])
        write_manifest(keep=True)
        return
    if sys.argv[1:] != ["--manifest"]:
        for fn in GROUPS:
            run_group(fn)
    write_manifest()


WRITTEN: dict = {}      # file (a PNG sequence's pattern) -> its group


def run_group(fn) -> None:
    """Run one fixture function and record it as the writer of every file
    it wrote: each manifest entry's ``group`` is the function's name
    without ``_fixtures``, which is how the card run's phases select their
    fixtures."""
    def stamps():
        return {n: os.stat(os.path.join(OUT, n)).st_mtime_ns
                for n in os.listdir(OUT)}
    before = stamps()
    fn()
    for name, t in stamps().items():
        if before.get(name) != t:
            if name.startswith("png16_"):
                name = name.rsplit("_", 1)[0] + "_%d.png"
            if name.startswith("tifseq_"):
                name = name.rsplit("_", 1)[0] + "_%d.tif"
            WRITTEN[name] = fn.__name__.removesuffix("_fixtures")


def mpeg4_fixtures() -> None:
    """MPEG-4 Part 2 by cv2's writer (mp4v, XVID, FMP4), raw I420, and the
    port's own encoder with the tools FFmpeg's writer leaves off."""
    moving = moving_clip(144, 176, 26)
    _cv2_write(os.path.join(OUT, "moving_176x144.mp4"), moving, "mp4v")
    _cv2_write(os.path.join(OUT, "moving_176x144_xvid.avi"), moving, "XVID")
    _cv2_write(os.path.join(OUT, "moving_176x144_fmp4.avi"), moving, "FMP4")
    _cv2_write(os.path.join(OUT, "odd_53x37.mp4"),
               moving_clip(37, 53, 26, seed=1, speed=5.0), "mp4v")
    _cv2_write(os.path.join(OUT, "still_64x48.mp4"),
               moving_clip(48, 64, 1, seed=3) * 14, "mp4v")
    raw = os.path.join(OUT, "raw_i420.avi")
    _cv2_write(raw, moving_clip(48, 64, 4, seed=4), "I420")
    _fill_raw_frames(raw, 64, 48)
    _port_write(os.path.join(OUT, "tools_h263.mp4"), zero_planes(64, 96, 14),
                packet_rows=2, mv4=True, rounding=1, dquant=1, qscale=2)
    iq = np.add.outer(np.arange(8), np.arange(8)) * 2 + 8
    pq = 16 + np.add.outer(np.arange(8), 2 * np.arange(8))
    _port_write(os.path.join(OUT, "tools_mpegq.avi"),
                _bgr_planes(moving_clip(64, 96, 14, seed=5, speed=4.5)),
                mpeg_quant=(iq, pq), packet_rows=1, mv4=True, qscale=4,
                rounding=1)


def mjpeg_fixtures() -> None:
    """Motion JPEG: cv2's writer into .avi and .mp4, PIL's JPEGs without
    their DHT in the port's AVI muxer."""
    _cv2_write(os.path.join(OUT, "mjpg.avi"), moving_clip(24, 32, 2), "MJPG")
    _cv2_write(os.path.join(OUT, "mjpg_176x144.mp4"),
               moving_clip(144, 176, 3, seed=6), "MJPG")
    mjpeg_avi(os.path.join(OUT, "mjpg_nodht_176x144.avi"),
              [strip_dht(j) for j in _pil_jpegs(
                  moving_clip(144, 176, 3, seed=7), quality=60)])


def vp8_fixtures() -> None:
    """VP8 in WebM, Matroska and AVI (patched sizes and versions, unknown
    element sizes, no Cues, the Sintel pair), the other codecs cv2 writes
    into Matroska, and MPEG-4 Part 2 patched to odd heights."""
    mp4 = os.path.join(OUT, "moving_176x144.mp4")
    patch_mpeg4_size(mp4, os.path.join(OUT, "mpeg4_176x143.mp4"), 176, 143)
    patch_mpeg4_size(mp4, os.path.join(OUT, "mpeg4_175x143.mp4"), 175, 143)
    moving = moving_clip(144, 176, 26)
    webm = os.path.join(OUT, "vp8_176x144.webm")
    for ext in ("webm", "mkv", "avi"):
        _cv2_write(os.path.join(OUT, f"vp8_176x144.{ext}"), moving, "VP80")
    _cv2_write(os.path.join(OUT, "vp8_still_64x48.webm"),
               moving_clip(48, 64, 1, seed=3) * 14, "VP80")
    _cv2_write(os.path.join(OUT, "vp8_odd_53x37.webm"),
               moving_clip(37, 53, 26, seed=1, speed=5.0), "VP80")
    patch_vp8_size(webm, os.path.join(OUT, "vp8_175x143.webm"), 175, 143)
    short = os.path.join(OUT, "vp8_version0.webm")
    _cv2_write(short, moving_clip(144, 176, 13, seed=8, speed=3.5), "VP80")
    for v in (1, 2, 3):
        patch_vp8_version(short, os.path.join(OUT, f"vp8_version{v}.webm"), v)
    unknown_sizes(short, os.path.join(OUT, "vp8_unknown_sizes.webm"))
    without_cues(short, os.path.join(OUT, "vp8_no_cues.webm"))
    os.remove(short)
    im1, im2 = sintel_pair()
    _cv2_write(os.path.join(OUT, "vp8_sintel_436x1024.webm"),
               [im1 if i % 2 == 0 else im2 for i in range(13)], "VP80")
    _cv2_write(os.path.join(OUT, "mkv_mp4v_176x144.mkv"), moving, "mp4v")
    _cv2_write(os.path.join(OUT, "mkv_mjpg_176x144.mkv"),
               moving_clip(144, 176, 4, seed=6), "MJPG")
    _cv2_write(os.path.join(OUT, "mkv_i420_64x48.mkv"),
               moving_clip(48, 64, 4, seed=4), "I420")


# cv2 reads frames of this MPEG-2 file, but swscale refuses each one
# ("Cannot convert interlaced to progressive frames or vice versa") and
# cv2 hands over a buffer swscale never wrote: its digests (one for all
# four frames, another in each process) are not a picture to match, so a
# regeneration keeps the recorded ones and the port's refusal stands
INTERLACED = "mpeg2_interlaced.mpg"
INTERLACED_OUTPUT = ("unconverted: swscale logs 'Cannot convert interlaced "
                     "to progressive frames or vice versa' for every frame "
                     "and cv2 returns a buffer it never wrote")


def _port_refuses(path: str):
    """What the port raises opening ``path`` (None where it opens it)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    try:
        EncodedVideo(path)
    except ValueError as e:
        return str(e).split(": ", 1)[1]
    return None


def write_manifest(keep: bool = False) -> None:
    """The manifest of every file; ``keep`` keeps the entries already there
    and adds the new files' alone."""
    import cv2
    manifest = {"opencv": cv2.__version__, "files": {}}
    old, groups, files = os.path.join(OUT, "manifest.json"), {}, {}
    if os.path.exists(old):
        with open(old) as f:
            files = json.load(f)["files"]
        groups = {n: e["group"] for n, e in files.items()}
        if keep:
            manifest["files"] = files
    names = [n for n in os.listdir(OUT)
             if not n.startswith(("png16_", "tifseq_"))]
    for name in sorted(names + list(PNG16) + list(TIFF_SEQ)):
        if name == "manifest.json" or name in manifest["files"]:
            continue
        path = os.path.join(OUT, name)
        frames = cv2_frames(path)
        manifest["files"][name] = {
            **cv2_info(path),
            "decoded": len(frames),
            "sha256": [frame_digest(f) for f in frames],
            "group": WRITTEN.get(name, groups.get(name)),
        }
        assert manifest["files"][name]["group"], f"{name}: no group wrote it"
        if name == INTERLACED:
            manifest["files"][name]["cv2_output"] = INTERLACED_OUTPUT
            if name in files:
                manifest["files"][name]["sha256"] = files[name]["sha256"]
        refused = _port_refuses(path) if name.startswith("ts_") else None
        if refused:
            manifest["files"][name]["port_refuses"] = refused
            continue
        if name.startswith("vp8_"):
            manifest["files"][name]["vp8_features"] = _vp8_features(path)
        if name.startswith(("mpeg1_", "mpeg2_")):
            feats, refused = _mpeg12_features(path)
            manifest["files"][name]["mpeg12_features"] = feats
            if refused:
                manifest["files"][name]["port_refuses"] = refused
            else:
                manifest["files"][name]["seeks"] = _cv2_seeks(path, frames)
        if name.startswith("vp9_"):
            feats, refused = _vp9_features(path)
            manifest["files"][name]["vp9_features"] = feats
            if refused:
                manifest["files"][name]["port_refuses"] = refused
        if name.startswith("h263_"):
            feats, refused = _h263_features(path)
            manifest["files"][name]["h263_features"] = feats
            if refused:
                manifest["files"][name]["port_refuses"] = refused
        if name.startswith("ffv1_"):
            feats, refused = _ffv1_features(path)
            manifest["files"][name]["ffv1_features"] = feats
            if refused:
                manifest["files"][name]["port_refuses"] = refused
        if name.startswith(("hfyu_", "ffvh_")):
            manifest["files"][name]["huffyuv_features"] = \
                _lossless_features(path)
        if name.startswith("ut_"):
            manifest["files"][name]["utvideo_features"] = \
                _lossless_features(path)
        for prefix, key in (("magy_", "magicyuv_features"),
                            ("asv_", "asv_features")):
            if name.startswith(prefix):
                manifest["files"][name][key] = _lossless_features(path)
        if name.startswith("flv_") and not name.startswith("flv_vp9"):
            manifest["files"][name]["flv_features"] = _flv_features(path)
        for prefix, key in (("tiff_", "tiff_features"),
                            ("jpegls_", "jpegls_features"),
                            ("speedhq_", "speedhq_features")):
            if name.startswith(prefix):
                manifest["files"][name][key] = _lossless_features(path)
        if name.startswith("tifseq_"):
            manifest["files"][name]["tiff_features"] = _tiff_seq_features(
                path, len(frames))
        if name in JPEGLS_WRITTEN:
            manifest["files"][name]["written_sha256"] = [
                frame_digest(f) for f in JPEGLS_WRITTEN[name]]
        if name.startswith("speedhq_"):
            manifest["files"][name]["speedhq_planes"] = [
                plane_digest(p) for p in speedhq_lavc_planes(path)]
        if name.startswith("msm_"):
            manifest["files"][name]["msmpeg4_features"] = \
                _lossless_features(path)
        if name.startswith("snow_"):
            try:
                manifest["files"][name]["snow_features"] = \
                    _lossless_features(path)
            except ValueError as e:     # Unsupported, or refused by FFmpeg
                manifest["files"][name]["port_refuses"] = \
                    str(e).split(": ", 1)[1]
        if name.startswith(("nut_", "dirac_")):
            sys.path.insert(0, os.path.dirname(HERE))
            from opticalflow_tpu_torch.io.nut import NutFile
            if name.endswith(".nut"):
                try:
                    nut = NutFile(path)
                    manifest["files"][name]["nut_features"] = nut.features
                    with open(path, "rb") as f:
                        for i in range(len(nut.sizes)):
                            nut.sample(f, i)
                    if nut.is_cut(len(nut.sizes) - 1):
                        # the port conceals a cut I-VOP, refuses a P-VOP
                        from opticalflow_tpu_torch.io.video import \
                            EncodedVideo
                        list(EncodedVideo(path))
                except ValueError as e:
                    manifest["files"][name]["port_refuses"] = \
                        str(e).split(": ", 1)[1]
            if name.startswith("dirac_"):
                try:
                    manifest["files"][name]["dirac_features"] = \
                        _lossless_features(path)
                except ValueError as e:     # Unsupported, or refused by FFmpeg
                    manifest["files"][name]["port_refuses"] = \
                        str(e).split(": ", 1)[1]
        if name.startswith(("pvop_", "ivop_")):
            sys.path.insert(0, os.path.dirname(HERE))
            from opticalflow_tpu_torch.io.nut import NutFile
            manifest["files"][name]["nut_features"] = NutFile(path).features
            manifest["files"][name]["mpeg4_concealment"] = \
                mpeg4_concealment(path)
        if name.startswith("h264_"):
            manifest["files"][name]["h264_features"] = _h264_features(path)
            manifest["files"][name]["h264_planes"] = [
                plane_digest(p) for p in h264_lavc_planes(path)]
        if name.startswith("j2k_"):
            try:
                manifest["files"][name]["jpeg2000_features"] = \
                    _lossless_features(path)
            except ValueError as e:     # Unsupported, or refused by FFmpeg
                manifest["files"][name]["port_refuses"] = \
                    str(e).split(": ", 1)[1]
        if (name.startswith(("h263_", "ffv1_", "mpeg4_", "magy_", "flv_",
                             "asv_", "msm_", "snow_", "nut_", "dirac_",
                             "pvop_", "ivop_", "j2k_", "tag_", "h264_",
                             "rot_", "ts_mpeg2_", "tiff_", "tifseq_",
                             "jpegls_", "speedhq_")
                            + LOSSLESS)
                or "resize" in name or name.endswith(".3gp")):
            manifest["files"][name]["seeks"] = _cv2_seeks(path, frames)
            # a seek that reads a frame the sequential read never shows
            # (a Sorenson disposable picture FFmpeg skips there): its digest
            odd = [t for t, hit in manifest["files"][name]["seeks"].items()
                   if hit == -1]
            if odd:
                manifest["files"][name]["seek_sha256"] = {
                    t: frame_digest(_cv2_seek_frame(path, int(t)))
                    for t in odd}
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import ffmpeg_threads
    from opticalflow_tpu_torch.runtime.vp9 import FEATURES
    reached = {f for e in manifest["files"].values()
               for f in e.get("vp9_features", [])}
    manifest["vp9_unreached"] = [f for f in FEATURES if f not in reached]
    from opticalflow_tpu_torch.runtime.mpeg12 import FEATURES as M12
    reached = {f for e in manifest["files"].values()
               for f in e.get("mpeg12_features", [])}
    manifest["mpeg12_unreached"] = [f for f in M12 if f not in reached]
    from opticalflow_tpu_torch.runtime.h263 import FEATURES as H263
    reached = {f for e in manifest["files"].values()
               for f in e.get("h263_features", [])}
    manifest["h263_unreached"] = [f for f in H263 if f not in reached]
    from opticalflow_tpu_torch.runtime.ffv1 import FEATURES as FFV1
    reached = {f for e in manifest["files"].values()
               for f in e.get("ffv1_features", [])}
    manifest["ffv1_unreached"] = [f for f in FFV1 if f not in reached]
    from opticalflow_tpu_torch.runtime.huffyuv import FEATURES as HYUV
    reached = {f for e in manifest["files"].values()
               for f in e.get("huffyuv_features", [])}
    manifest["huffyuv_unreached"] = [f for f in HYUV if f not in reached]
    from opticalflow_tpu_torch.runtime.utvideo import FEATURES as UT
    reached = {f for e in manifest["files"].values()
               for f in e.get("utvideo_features", [])}
    manifest["utvideo_unreached"] = [f for f in UT if f not in reached]
    from opticalflow_tpu_torch.runtime.asv import FEATURES as ASV
    from opticalflow_tpu_torch.runtime.h263 import SORENSON_FEATURES
    from opticalflow_tpu_torch.runtime.magicyuv import FEATURES as MAGY
    from opticalflow_tpu_torch.runtime.msmpeg4 import FEATURES as MSMP4
    from opticalflow_tpu_torch.runtime.snow import FEATURES as SNOW
    from opticalflow_tpu_torch.runtime.dirac import FEATURES as DIRAC
    from opticalflow_tpu_torch.io.nut import FEATURES as NUT
    from opticalflow_tpu_torch.runtime.jpeg2000 import FEATURES as J2K
    from opticalflow_tpu_torch.runtime.h264 import FEATURES as H264
    from opticalflow_tpu_torch.runtime.h264 import MODES as H264_MODES
    for key, names in (("magicyuv", MAGY), ("flv", SORENSON_FEATURES),
                       ("asv", ASV), ("msmpeg4", MSMP4), ("snow", SNOW),
                       ("dirac", DIRAC), ("nut", NUT), ("jpeg2000", J2K),
                       ("h264", H264 + H264_MODES)):
        reached = {f for e in manifest["files"].values()
                   for f in e.get(f"{key}_features", [])}
        manifest[f"{key}_unreached"] = [f for f in names if f not in reached]
    from opticalflow_tpu_torch.runtime.h264 import B_FEATURES
    reached = {f for n, e in manifest["files"].items()
               if e.get("group") == "h264_b"
               for f in e.get("h264_features", [])}
    manifest["h264_b_unreached"] = [f for f in B_FEATURES
                                    if f not in reached]
    # cv2's decoder threads: vp8_clamping.webm's digests depend on them
    manifest["ffmpeg_threads"] = ffmpeg_threads()
    build = cv2.getBuildInformation()
    manifest["ffmpeg"] = " ".join(
        line.split(":", 1)[1].strip() for line in build.splitlines()
        if line.strip().startswith(("avcodec:", "avformat:", "swscale:")))
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {len(manifest['files'])} files, {total} bytes, to {OUT}")


def _h264_features(path: str) -> list:
    """The port's H.264 decoder's features over the file (flushed)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    v = EncodedVideo(path)
    dec = v._decoder()
    with open(path, "rb") as f:
        for i in range(v.samples):
            dec.decode(v.box.sample(f, i))
    dec.flush()
    return dec.features


def h264_lavc_planes(path: str) -> list:
    """libavcodec's h264 decoder's planes of a file's packets (as FFmpeg's
    demuxer hands them over; the avcC or Annex B extradata first), from
    the reorder depth FFmpeg's probe leaves for cv2 (``Lavf.video_delay``)."""
    packets = [p for p, _, _ in Lavf().packets(path)]
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    return Lavc().decode(packets, "h264",
                         extradata=EncodedVideo(path).box.dsi,
                         video_delay=Lavf().video_delay(path))


def speedhq_lavc_planes(path: str) -> list:
    """libavcodec's speedhq decoder's planes of a file's packets, the
    fourcc and size handed to it as FFmpeg's demuxer hands them over."""
    import cv2
    info = cv2_info(path)
    return Lavc().decode([p for p, _, _ in Lavf().packets(path)], "speedhq",
                         tag="SHQ0", size=(info["width"], info["height"]))


def _tiff_seq_features(pattern: str, n: int) -> list:
    """The port's TIFF decoder's features over a sequence's files."""
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.runtime.tiff import Decoder
    dec = Decoder()
    for i in range(n):
        with open(pattern % i, "rb") as f:
            dec.decode(f.read())
    return dec.features


def plane_digest(planes) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(p).tobytes()
                                   for p in planes)).hexdigest()


def h264_write(path: str, sps: list, pps: list, pics: list,
               seed: int) -> None:
    """The syntax writer's stream (``tests/h264_syntax.py``) muxed by
    libavformat for ``path``'s extension: length-prefixed samples with
    the avcC in .mp4/.mov/.mkv/.flv, Annex B with the parameter sets as
    extradata in .avi, .ts, .nut and .wmv, the bare stream in .h264; key
    frames at the IDR pictures (and at an I picture with a recovery
    point)."""
    import h264_syntax as hs
    aus = hs.write_stream(seed, sps, pps, pics)
    keys = [p.idr or p.recovery_point is not None for p in pics]
    s = sps[0]
    w = 16 * s.mb_w - s.crop[0] - s.crop[1]
    h = 16 * s.mb_h - s.crop[2] - s.crop[3]
    ext = os.path.splitext(path)[1]
    # pictures with their own POCs (B pictures) are stamped as an encoder
    # stamps them: pts their display index, dts the decode index less the
    # reorder depth, which the stream's video_delay states
    shown, delay = hs.display_order(pics)
    stamps = [(d, i - delay) for i, d in enumerate(shown)]
    if ext == ".h264":
        with open(path, "wb") as f:
            f.write(b"".join(aus))
    elif ext in (".mp4", ".mov", ".mkv", ".flv"):
        Lavf().mux(path, [(hs.length_prefixed(a), k, *t)
                          for a, k, t in zip(aus, keys, stamps)],
                   hs.avcc(sps, pps), w, h, video_delay=delay)
    else:
        Lavf().mux(path, [(a, k, *t) for a, k, t in zip(aus, keys, stamps)],
                   b"".join(b"\0\0\0\1" + n
                            for n in hs.parameter_sets(sps, pps)), w, h,
                   video_delay=delay)


def h264_field_mp4(path: str) -> bytes:
    """An .mp4 of H.264 the port does not read (frame pictures of a stream
    with frame_mbs_only_flag 0, which cv2 reads): its bytes."""
    import h264_syntax as hs
    h264_write(path, [hs.Sps(frame_mbs_only=False)], [hs.Pps()],
               [hs.Pic(idr=True, mb_types=("I16",))], seed=3)
    with open(path, "rb") as f:
        return f.read()


def h264_specs() -> dict:
    """The group's streams: name → (SPS list, PPS list, pictures, file
    extension), each written once in CAVLC and once in CABAC (the PPS's
    entropy_coding_mode_flag set by ``h264_fixtures``)."""
    import h264_syntax as hs
    I, P, SL = hs.Pic, hs.Pps, hs.SliceSpec
    mix = ("P", "SKIP", "I4", "I8", "I16", "PCM")
    intra = ("I4", "I8", "I16", "PCM")

    def p(n, **kw):
        return [I(kind="P", mb_types=kw.pop("mb_types", mix), **kw)
                for _ in range(n)]
    rng = np.random.default_rng(280)
    lst4 = [int(v) for v in rng.integers(4, 64, 16)]
    lst4b = [int(v) for v in rng.integers(4, 64, 16)]
    lst8 = [int(v) for v in rng.integers(4, 64, 64)]
    S96 = dict(mb_w=6, mb_h=4)
    slices3 = [SL(0, 7, qp_delta=3, deblock=0, alpha=2, beta=-3,
                  cabac_init_idc=1),
               SL(7, 9, qp_delta=-4, deblock=2, alpha=-4, beta=5,
                  cabac_init_idc=2),
               SL(16, 8, deblock=1)]
    return {
        "pcm_96x64": ([hs.Sps(**S96)], [P()],
                      [I(idr=True, mb_types=("PCM",)),
                       I(mb_types=("PCM",))], ".mp4"),
        "intra_96x64": ([hs.Sps(**S96, max_num_ref_frames=1)],
                        [P(transform_8x8=True)],
                        [I(idr=True, mb_types=intra),
                         I(mb_types=intra, slices=slices3),
                         I(idr=True, mb_types=("I4",),
                           slices=[SL(0, 5), SL(5, 13), SL(18, 6)]),
                         I(mb_types=("I8",)), I(mb_types=("I16",))],
                        ".mkv"),
        "p_176x144": ([hs.Sps(mb_w=11, mb_h=9, max_num_ref_frames=1)],
                      [P(transform_8x8=True)],
                      [I(idr=True, mb_types=("I16", "I4"))]
                      + p(3) + p(2, mb_types=("P", "SKIP"), t8=True)
                      + p(2, mb_types=("P",), p_parts=(3, 4))
                      + p(1, mb_types=("P",), p_parts=(1, 2)), ".avi"),
        "multiref_96x64": ([hs.Sps(**S96, max_num_ref_frames=4)], [P()],
                           [I(idr=True, mb_types=("I16",))] + p(1)
                           + [I(kind="P", mb_types=mix, num_ref_idx=2),
                              I(kind="P", mb_types=mix, num_ref_idx=3,
                                list_mods=[(0, 1), (1, 0)]),
                              I(kind="P", mb_types=mix, num_ref_idx=4,
                                ref_idc=0),
                              I(kind="P", mb_types=mix, num_ref_idx=4,
                                list_mods=[(0, 3)]),
                              I(kind="P", mb_types=mix, num_ref_idx=4)],
                           ".mp4"),
        "longterm_96x64": ([hs.Sps(**S96, max_num_ref_frames=4)], [P()],
                           [I(idr=True, mb_types=("I16",)),
                            I(kind="P", mb_types=mix, mmco=[(4, 2), (6, 0)]),
                            I(kind="P", mb_types=mix, num_ref_idx=2),
                            I(kind="P", mb_types=mix, num_ref_idx=3,
                              mmco=[(3, 0, 1)]),
                            I(kind="P", mb_types=mix, num_ref_idx=3,
                              list_mods=[(2, 1), (2, 0)]),
                            I(kind="P", mb_types=mix, num_ref_idx=3,
                              mmco=[(2, 0), (1, 0)]),
                            I(kind="P", mb_types=mix, num_ref_idx=2,
                              mmco=[(5,)]),
                            I(kind="P", mb_types=mix, num_ref_idx=1),
                            I(idr=True, mb_types=("I4",),
                              long_term_reference=True),
                            I(kind="P", mb_types=mix, num_ref_idx=1)],
                           ".mkv"),
        "weighted_96x64": ([hs.Sps(**S96, max_num_ref_frames=2)],
                           [P(weighted_pred=True)],
                           [I(idr=True, mb_types=("I16", "I4"))]
                           + p(2, weights=dict(
                               luma_log2=5, chroma_log2=3,
                               luma={0: (40, -10)},
                               chroma={0: [(6, 3), (12, -20)]}))
                           + p(2, num_ref_idx=2, weights=dict(
                               luma_log2=0, chroma_log2=1,
                               luma={0: (2, -100), 1: (1, 20)},
                               chroma={1: [(1, 50), (3, -100)]})), ".mov"),
        "scaling_sps_96x64": ([hs.Sps(**S96, scaling=[
            lst4, None, "default", lst4b, None, None, lst8, None])],
            [P(transform_8x8=True, scaling=[
                None, lst4b, None, None, "default", None, None, lst8])],
            [I(idr=True, mb_types=intra)] + p(3, density=0.15), ".mp4"),
        "scaling_pps_96x64": ([hs.Sps(**S96)],
                              [P(transform_8x8=True, scaling=[
                                  lst4, None, lst4b, None, "default", None,
                                  None, lst8])],
                              [I(idr=True, mb_types=intra)]
                              + p(3, density=0.15), ".mkv"),
        "qp_96x64": ([hs.Sps(**S96)],
                     [P(chroma_qp_offset=-7, second_chroma_qp_offset=9,
                        init_qp=48),
                      P(id=1, init_qp=2, transform_8x8=True)],
                     [I(idr=True, mb_types=intra, qp_deltas=0.7)]
                     + p(2, qp_deltas=0.7)
                     + p(3, pps=1, big_levels=0.3, density=0.4),
                     ".avi"),
        "deblock_96x64": ([hs.Sps(**S96)], [P(transform_8x8=True)],
                          [I(idr=True, mb_types=intra, slices=slices3)]
                          + p(3, slices=slices3), ".ts"),
        "poc1_96x64": ([hs.Sps(**S96, poc_type=1, max_num_ref_frames=2,
                               offset_for_ref_frame=(2, 4),
                               offset_for_non_ref_pic=-1)], [P()],
                       [I(idr=True, mb_types=("I16",))]
                       + [I(kind="P", mb_types=mix, ref_idc=int(k % 3 != 2))
                          for k in range(5)], ".mkv"),
        "poc2_96x64": ([hs.Sps(**S96, poc_type=2, max_num_ref_frames=2)],
                       [P()],
                       [I(idr=True, mb_types=("I16",))]
                       + [I(kind="P", mb_types=mix, ref_idc=int(k % 3 != 2))
                          for k in range(5)], ".h264"),
        "vui_96x64": ([hs.Sps(**S96, vui=dict(
            full_range=True, matrix=1, chroma_loc=2, fps=(30000, 1001),
            reorder=1))], [P()],
            [I(idr=True, mb_types=("I16", "I4"))] + p(4), ".mp4"),
        "guess_96x64": ([hs.Sps(**S96)], [P()],
                        [I(idr=True, mb_types=("I16", "I4"), poc_step=4)]
                        + p(4, poc_step=4)
                        + [I(idr=True, mb_types=("I16",), poc_step=4)]
                        + p(2, poc_step=4), ".mkv"),
        "crop_54x38": ([hs.Sps(mb_w=4, mb_h=3, crop=(0, 10, 0, 10),
                               vui=dict(chroma_loc=1))], [P()],
                       [I(idr=True, mb_types=intra)] + p(3), ".mp4"),
        "leftcrop_86x56": ([hs.Sps(**S96, crop=(2, 8, 2, 6),
                                   vui=dict(chroma_loc=0))], [P()],
                           [I(idr=True, mb_types=intra)] + p(3), ".avi"),
        "recovery_96x64": ([hs.Sps(**S96)], [P()],
                           [I(mb_types=("I16",), recovery_point=0,
                              frame_num=3)] + p(3)
                           + [I(idr=True, mb_types=("I16",))] + p(2),
                           ".ts"),
        "cip_96x64": ([hs.Sps(**S96)],
                      [P(constrained_intra=True, transform_8x8=True)],
                      [I(idr=True, mb_types=intra)] + p(4), ".mkv"),
        "farmv_96x64": ([hs.Sps(**S96)], [P()],
                        [I(idr=True, mb_types=("I16",))]
                        + p(4, mb_types=("P",), far_mv=0.4), ".avi"),
    }


# the containers every stream of h264_clip is muxed into
H264_CONTAINERS = (".mp4", ".mov", ".mkv", ".avi", ".ts", ".h264", ".nut",
                   ".wmv", ".flv")


def h264_fixtures() -> None:
    """H.264 from the seeded syntax writer (``tests/h264_syntax.py``; no
    encoder of it is bundled), muxed by cv2's libavformat: each stream of
    ``h264_specs`` once in CAVLC and once in CABAC from the same seed (the
    same macroblocks, modes, vectors and levels), and a 12-frame clip at
    96x64 (two IDR pictures) in every container of ``H264_CONTAINERS``."""
    import h264_syntax as hs
    for k, (name, (sps, pps, pics, ext)) in enumerate(h264_specs().items()):
        for cabac in (False, True):
            pp = [hs.Pps(**{**x.__dict__, "cabac": cabac}) for x in pps]
            tag = "cabac" if cabac else "cavlc"
            h264_write(os.path.join(OUT, f"h264_{name}_{tag}{ext}"), sps, pp,
                       pics, seed=2800 + k)
    sps = [hs.Sps(mb_w=6, mb_h=4, max_num_ref_frames=2)]
    mix = ("P", "SKIP", "I4", "I16")
    pics = ([hs.Pic(idr=True, mb_types=("I16", "I4"))]
            + [hs.Pic(kind="P", mb_types=mix) for _ in range(5)]
            + [hs.Pic(idr=True, mb_types=("I16",))]
            + [hs.Pic(kind="P", mb_types=mix) for _ in range(5)])
    for cabac in (False, True):
        tag = "cabac" if cabac else "cavlc"
        for ext in H264_CONTAINERS:
            h264_write(os.path.join(OUT, f"h264_clip_{tag}{ext}"), sps,
                       [hs.Pps(cabac=cabac)], pics, seed=2900)


def h264_b_specs() -> dict:
    """The ``h264_b`` group's streams (as ``h264_specs``: each written once
    in CAVLC and once in CABAC): B pictures in pyramids (a reference B
    picture between each pair of P pictures, two non-reference ones
    around it), in spatial and temporal direct mode, with
    direct_8x8_inference_flag 1 and 0, each bi-prediction mode, list 1's
    modification and swap, long-term references, MMCO on a B reference,
    several slices, far vectors, VUI with and without the reorder depth,
    176x144 and the 54x38 crop."""
    import h264_syntax as hs
    I, P, SL = hs.Pic, hs.Pps, hs.SliceSpec
    bmix = ("B", "SKIP", "I4", "I16")
    pmix = ("P", "SKIP", "I16")

    def gops(n, first=0, step=2, spatial=True, p_kw=None, b_kw=None,
             bref_kw=None):
        """n pyramids after the picture of POC ``first``: P, then the
        reference B between, then the two non-reference Bs."""
        out = []
        for g in range(n):
            b = first + 4 * step * g
            out += [I(kind="P", mb_types=pmix, poc=b + 4 * step,
                      mv_range=2, **(p_kw or {})),
                    I(kind="B", mb_types=bmix, poc=b + 2 * step,
                      direct_spatial=spatial, num_ref_idx="all",
                      **{**(b_kw or {}), **(bref_kw or {})}),
                    I(kind="B", mb_types=bmix, poc=b + step, ref_idc=0,
                      direct_spatial=spatial, num_ref_idx="all",
                      **(b_kw or {})),
                    I(kind="B", mb_types=bmix, poc=b + 3 * step, ref_idc=0,
                      direct_spatial=spatial, num_ref_idx="all",
                      **(b_kw or {}))]
        return out
    idr = I(idr=True, mb_types=("I4", "I16"), poc=0)
    S96 = dict(mb_w=6, mb_h=4, max_num_ref_frames=4)
    P3 = dict(num_ref_idx_default1=2, transform_8x8=True)
    slices3 = [SL(0, 30, qp_delta=3, alpha=2, beta=-3, cabac_init_idc=1),
               SL(30, 40, qp_delta=-4, deblock=2, cabac_init_idc=2),
               SL(70, 29, deblock=0, alpha=-2, beta=3)]
    w = dict(luma_log2=5, chroma_log2=3, luma={0: (40, -10), 1: (20, 6)},
             chroma={0: [(6, 3), (12, -20)]}, luma1={0: (28, 9)},
             chroma1={0: [(9, -4), (5, 2)], 1: [(8, 1), (7, 7)]})
    return {
        "spatial_96x64": ([hs.Sps(**S96)], [P(**P3)],
                          [idr] + gops(3), ".mp4"),
        "temporal_96x64": ([hs.Sps(**S96)], [P(**P3)],
                           [idr] + gops(3, spatial=False), ".mkv"),
        "inference0_96x64": ([hs.Sps(**S96, direct_8x8_inference=False)],
                             [P(**P3)],
                             [idr] + gops(1) + gops(1, 8, spatial=False)
                             + gops(1, 16), ".avi"),
        "implicit_96x64": ([hs.Sps(mb_w=6, mb_h=4, max_num_ref_frames=5)],
                           [P(**P3, weighted_bipred_idc=2)],
                           [I(idr=True, mb_types=("I16",), poc=0,
                              long_term_reference=True)]
                           + gops(2, b_kw=dict(num_ref_idx1="all"))
                           + gops(1, 16, spatial=False,
                                  b_kw=dict(num_ref_idx1="all")), ".mov"),
        "explicit_96x64": ([hs.Sps(**S96)],
                           [P(**P3, weighted_bipred_idc=1)],
                           [idr] + gops(2, b_kw=dict(weights=w,
                                                     num_ref_idx1=2)),
                           ".ts"),
        "listmod_96x64": ([hs.Sps(**S96)], [P(**P3)],
                          [idr, I(kind="P", mb_types=pmix, poc=4),
                           # after every reference: list 1 equals list 0,
                           # its first two swapped
                           I(kind="B", mb_types=bmix, poc=8, ref_idc=0,
                             num_ref_idx1=2),
                           I(kind="P", mb_types=pmix, poc=16),
                           I(kind="B", mb_types=bmix, poc=12,
                             num_ref_idx1=3, list_mods1=[(0, 1), (1, 0)]),
                           I(kind="B", mb_types=bmix, poc=10, ref_idc=0,
                             num_ref_idx1="all", list_mods1=[(0, 2)],
                             direct_spatial=False, num_ref_idx="all"),
                           # list 0 the reference B alone: the co-located
                           # P picture's reference is not in it
                           I(kind="B", mb_types=bmix, poc=14, ref_idc=0,
                             direct_spatial=False, num_ref_idx=1,
                             list_mods=[(0, 0)])],
                          ".mp4"),
        "mmco_96x64": ([hs.Sps(**S96)], [P(**P3)],
                       [idr] + gops(1) + gops(1, 8, bref_kw=dict(
                           mmco=[(1, 1)])) + gops(1, 16, bref_kw=dict(
                               mmco=[(1, 2), (4, 1), (6, 0)])), ".nut"),
        "slices_176x144": ([hs.Sps(mb_w=11, mb_h=9, max_num_ref_frames=4,
                                   vui=dict(reorder=2))],
                           [P(**P3)],
                           [I(idr=True, mb_types=("I16",), poc=0)]
                           + gops(2, b_kw=dict(slices=slices3, far_mv=0.3),
                                  p_kw=dict(slices=slices3)), ".mkv"),
        "crop_54x38": ([hs.Sps(mb_w=4, mb_h=3, max_num_ref_frames=4,
                               crop=(0, 10, 0, 10), vui=dict(chroma_loc=1))],
                       [P(**P3)], [idr] + gops(2), ".wmv"),
    }


def h264_b_fixtures() -> None:
    """H.264 with B pictures from the seeded syntax writer: each stream of
    ``h264_b_specs`` in CAVLC and CABAC (seeds 2950 on), and a 13-frame
    pyramid clip at 96x64 in every container of ``H264_CONTAINERS``,
    stamped as an encoder stamps B-frames (``h264_write``)."""
    import h264_syntax as hs
    for k, (name, (sps, pps, pics, ext)) in enumerate(h264_b_specs().items()):
        for cabac in (False, True):
            pp = [hs.Pps(**{**x.__dict__, "cabac": cabac}) for x in pps]
            tag = "cabac" if cabac else "cavlc"
            h264_write(os.path.join(OUT, f"h264_b_{name}_{tag}{ext}"), sps,
                       pp, pics, seed=2950 + k)
    sps = [hs.Sps(mb_w=6, mb_h=4, max_num_ref_frames=4)]
    pics = [hs.Pic(idr=True, mb_types=("I16", "I4"), poc=0)]
    for g in range(3):
        b = 8 * g
        pics += [hs.Pic(kind="P", mb_types=("P", "SKIP"), poc=b + 8),
                 hs.Pic(kind="B", mb_types=("B", "SKIP"), poc=b + 4,
                        num_ref_idx="all"),
                 hs.Pic(kind="B", mb_types=("B", "SKIP"), poc=b + 2,
                        ref_idc=0, num_ref_idx="all"),
                 hs.Pic(kind="B", mb_types=("B", "SKIP"), poc=b + 6,
                        ref_idc=0, num_ref_idx="all")]
    for cabac in (False, True):
        tag = "cabac" if cabac else "cavlc"
        for ext in H264_CONTAINERS:
            h264_write(os.path.join(OUT, f"h264_b_clip_{tag}{ext}"), sps,
                       [hs.Pps(cabac=cabac)], pics, seed=2990)


def with_stream_type(src: str, dst: str, st: int) -> None:
    """Transport stream ``src`` with its PMT's first stream_type set to
    ``st`` (CRC fixed)."""
    data = bytearray(open(src, "rb").read())
    for k in range(0, len(data), 188):
        pid = (data[k + 1] & 0x1F) << 8 | data[k + 2]
        if pid == 0x1000:
            sec = k + 5
            n = (data[sec + 1] & 0x0F) << 8 | data[sec + 2]
            pil = (data[sec + 10] & 0x0F) << 8 | data[sec + 11]
            data[sec + 12 + pil] = st
            crc = 0xFFFFFFFF
            for b in data[sec:sec + 3 + n - 4]:
                crc ^= b << 24
                for _ in range(8):
                    crc = (crc << 1 ^ (0x04C11DB7 if crc & 0x80000000 else 0)
                           ) & 0xFFFFFFFF
            data[sec + 3 + n - 4:sec + 3 + n] = struct.pack(">I", crc)
            break
    with open(dst, "wb") as f:
        f.write(bytes(data))


def relabel_fixtures() -> None:
    """An MPEG-2 transport stream relabelled H.264 (stream_type 0x1B), which
    FFmpeg's probe reads as MPEG-2 after its h264 parser has cut up the
    first two PES packets (cv2's first 12 frames concealed)."""
    with_stream_type(os.path.join(OUT, "mpeg2_176x144.ts"),
                     os.path.join(OUT, "ts_mpeg2_type1b_176x144.ts"), 0x1B)


def rotation_matrix(degrees: float, mirror: bool = False) -> list:
    """A ``tkhd``-style display matrix turning by ``degrees`` (cv2's
    orientation angle: atan2(b, a)), its first column negated where
    ``mirror``."""
    t = math.radians(degrees)
    a, b, c, d = math.cos(t), math.sin(t), -math.sin(t), math.cos(t)
    if mirror:
        a, c = -a, -c
    fx = lambda v: int(round(v * 65536))  # noqa: E731
    return [fx(a), fx(b), 0, fx(c), fx(d), 0, 0, 0, 1 << 30]


def patch_tkhd(src: str, dst: str, matrix: list) -> None:
    """``src`` with its (first) ``tkhd``'s matrix replaced."""
    with open(src, "rb") as f:
        data = bytearray(f.read())
    i = data.find(b"tkhd")
    off = i + 4 + 4 + (32 if data[i + 4] else 20) + 16
    struct.pack_into(">9i", data, off, *matrix)
    with open(dst, "wb") as f:
        f.write(data)


# the angles and mirrors the rotation group patches in: cv2 turns its
# frames at 90, 180 and 270 (a mirror by its angle alone), not at 45
ROTATIONS = {"90": (90, False), "180": (180, False), "270": (270, False),
             "mirror": (0, True), "mirror90": (90, True), "45": (45, False)}


def rotation_fixtures() -> None:
    """Display matrices cv2 turns frames by: ``tkhd`` patched into committed
    MPEG-4 Part 2 (53x37) and H.264 .mp4 files (one with B pictures, whose
    ``elst`` shifts the track), an H.264 .mov and an H.263 .mov; and
    Matroska Projections (the mkv muxer's, from display matrix side
    data: a quarter turn each way, a flipped one)."""
    import h264_syntax as hs
    for src, tag in (("odd_53x37.mp4", "mpeg4"),
                     ("h264_clip_cavlc.mp4", "h264"),
                     ("h264_b_clip_cabac.mp4", "h264b"),
                     ("h264_clip_cabac.mov", "h264"),
                     ("h263_176x144.mov", "h263")):
        ext = os.path.splitext(src)[1]
        for name, (deg, mirror) in ROTATIONS.items():
            if tag == "h263" and name not in ("90", "270"):
                continue
            patch_tkhd(os.path.join(OUT, src),
                       os.path.join(OUT, f"rot_{tag}_{name}{ext}"),
                       rotation_matrix(deg, mirror))
    sps = [hs.Sps(mb_w=6, mb_h=4, max_num_ref_frames=1)]
    pps = [hs.Pps(cabac=True)]
    pics = [hs.Pic(idr=True, mb_types=("I16", "I4"))] + [
        hs.Pic(kind="P", mb_types=("P", "SKIP")) for _ in range(5)]
    aus = hs.write_stream(31, sps, pps, pics)
    flipped = rotation_matrix(90, True)
    for name, m in (("90", rotation_matrix(90)), ("270", rotation_matrix(270)),
                    ("mirror90", flipped)):
        Lavf().mux(os.path.join(OUT, f"rot_h264_{name}.mkv"),
                   [(hs.length_prefixed(a), i == 0) for i, a in enumerate(aus)],
                   hs.avcc(sps, pps), 96, 64, display_matrix=m)


# the fixture functions in the order they write (later ones read files
# that earlier ones wrote)
GROUPS = (mpeg4_fixtures, mjpeg_fixtures, vp8_fixtures, vp9_fixtures,
          mpeg12_fixtures, resize_fixtures, h263_fixtures, stream_fixtures,
          h263p_fixtures, pts_only_fixtures, png16_fixtures,
          lossless_fixtures, magicyuv_fixtures, sorenson_fixtures,
          asv_fixtures, msmpeg4_fixtures, snow_fixtures, nut_fixtures,
          dirac_fixtures, cut_vop_fixtures, jpeg2000_fixtures, tag_fixtures,
          h264_fixtures, h264_b_fixtures, rotation_fixtures,
          relabel_fixtures, tiff_fixtures, tiff_seq_fixtures,
          jpegls_fixtures, speedhq_fixtures, flv_vp9_fixtures)


if __name__ == "__main__":
    main()
