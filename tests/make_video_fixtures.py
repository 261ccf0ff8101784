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
    matrices), so FFmpeg's decode of them is on record too.
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
