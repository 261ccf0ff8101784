"""Regenerate ``tests/goldens/video/``: the video files the port's MPEG-4
Part 2 decoder, demuxers and colour conversion are held to where OpenCV is
absent (the GPU machine), and ``manifest.json`` with, for each file, the
SHA-256 of every frame ``cv2.VideoCapture`` decodes from it (BGR bytes) and
its ``CAP_PROP_FPS``, ``_FRAME_WIDTH``, ``_FRAME_HEIGHT`` and
``_FRAME_COUNT``.

    python tests/make_video_fixtures.py

Needs OpenCV with FFmpeg (the manifest records the versions).  The frames
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

Each VP8 file's manifest entry lists the header features and coding modes
the port's decoder met in it (``vp8_features``, ``runtime/vp8.FEATURES``).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

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


def _cv2_write(path: str, frames: list, fourcc: str, fps: float = 25.0):
    import cv2
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
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


def _vp8_features(path: str) -> list:
    sys.path.insert(0, os.path.dirname(HERE))
    from opticalflow_tpu_torch.io.video import EncodedVideo
    v = EncodedVideo(path)
    dec = v._decoder()
    with open(path, "rb") as f:
        for i in range(len(v.box.sizes)):
            dec.decode(v.box.sample(f, i))
    return dec.features


def sintel_pair() -> list:
    import cv2
    jpeg = os.path.join(HERE, "goldens", "jpeg")
    return [cv2.imread(os.path.join(jpeg, f"sintel_im{k}.jpg"))
            for k in (1, 2)]


def main() -> None:
    import cv2
    os.makedirs(OUT, exist_ok=True)
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
    _cv2_write(os.path.join(OUT, "mjpg.avi"), moving_clip(24, 32, 2), "MJPG")
    _cv2_write(os.path.join(OUT, "mjpg_176x144.mp4"),
               moving_clip(144, 176, 3, seed=6), "MJPG")
    mjpeg_avi(os.path.join(OUT, "mjpg_nodht_176x144.avi"),
              [strip_dht(j) for j in _pil_jpegs(
                  moving_clip(144, 176, 3, seed=7), quality=60)])
    _port_write(os.path.join(OUT, "tools_h263.mp4"), zero_planes(64, 96, 14),
                packet_rows=2, mv4=True, rounding=1, dquant=1, qscale=2)
    iq = np.add.outer(np.arange(8), np.arange(8)) * 2 + 8
    pq = 16 + np.add.outer(np.arange(8), 2 * np.arange(8))
    _port_write(os.path.join(OUT, "tools_mpegq.avi"),
                _bgr_planes(moving_clip(64, 96, 14, seed=5, speed=4.5)),
                mpeg_quant=(iq, pq), packet_rows=1, mv4=True, qscale=4,
                rounding=1)

    mp4 = os.path.join(OUT, "moving_176x144.mp4")
    patch_mpeg4_size(mp4, os.path.join(OUT, "mpeg4_176x143.mp4"), 176, 143)
    patch_mpeg4_size(mp4, os.path.join(OUT, "mpeg4_175x143.mp4"), 175, 143)
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

    manifest = {"opencv": cv2.__version__, "files": {}}
    for name in sorted(os.listdir(OUT)):
        if name == "manifest.json":
            continue
        path = os.path.join(OUT, name)
        frames = cv2_frames(path)
        manifest["files"][name] = {
            **cv2_info(path),
            "decoded": len(frames),
            "sha256": [frame_digest(f) for f in frames],
        }
        if name.startswith("vp8_"):
            manifest["files"][name]["vp8_features"] = _vp8_features(path)
    build = cv2.getBuildInformation()
    manifest["ffmpeg"] = " ".join(
        line.split(":", 1)[1].strip() for line in build.splitlines()
        if line.strip().startswith(("avcodec:", "avformat:", "swscale:")))
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {len(manifest['files'])} files, {total} bytes, to {OUT}")


if __name__ == "__main__":
    main()
