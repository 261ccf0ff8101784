"""Video frames in and out without OpenCV: ``.mp4``, ``.avi``, ``.y4m`` and
frame directories.

The JAX package reads and writes video through ``cv2.VideoCapture`` and
``cv2.VideoWriter`` (FFmpeg underneath); the port has its own demuxers,
muxers and codec and reads what those write:

  * **MP4** (``.mp4``, ``.m4v``, ``.mov``; ``io/mp4``) and **AVI**
    (``.avi``; ``io/avi``) holding MPEG-4 Part 2 Simple Profile video, what
    ``cv2.VideoWriter`` writes with fourcc ``mp4v``, ``XVID`` or ``FMP4``:
    decoded by ``runtime/mpeg4`` bit-exactly to FFmpeg and converted to BGR
    in swscale's arithmetic, so every frame equals ``cv2.VideoCapture``'s;
    raw I420 AVI too.  Written as MPEG-4 Part 2 (an I-VOP every 12 frames,
    as cv2's writer does; an odd side cropped to even, as it does), ``.mp4``
    or ``.avi`` (fourcc ``FMP4``).  H.264, HEVC, Motion JPEG and the like
    raise, naming ROADMAP Queue 1 item 8;
  * **YUV4MPEG2** (``.y4m``): 8-bit 4:2:0, colour tags ``C420jpeg``,
    ``C420mpeg2``, ``C420paldv``, ``C420`` or none; frames are converted
    with ``io/yuv`` (OpenCV's BT.601 integer arithmetic, nearest chroma);
    an odd side's last chroma row or column covers one pixel;
  * **a directory of PNG or JPEG frames** (``*.png``, ``*.jpg`` or
    ``*.jpeg``, one kind a directory), read in sorted name order with the
    port's own decoders (``io/images.decode_png``, ``runtime/jpeg``; no
    EXIF rotation), the counterpart of ``cv2.VideoCapture`` over an image
    sequence; written as PNG, ``000000.png``, ...

Frames are BGR uint8 (H, W, 3), as OpenCV hands them over.
:class:`AsyncVideoWriter` keeps the JAX class's encode thread, bounded
queue and error surfacing.
"""

from __future__ import annotations

import os
import queue
import threading
from bisect import bisect_right
from contextlib import closing
from fractions import Fraction
from glob import glob
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.io.avi import AviFile, AviWriter
from opticalflow_tpu_torch.io.images import (decode_bytes, encode_png, rgb8,
                                             unread_format)
from opticalflow_tpu_torch.io.mp4 import Mp4File, Mp4Writer
from opticalflow_tpu_torch.io.yuv import i420_planes, i420_to_rgb, pad_to_even
from opticalflow_tpu_torch.runtime.mpeg4 import (ITEM_8, Decoder, Encoder,
                                                  i420_to_bgr, to_i420)

__all__ = ["read_frames", "read_frame", "video_info", "AsyncVideoWriter",
           "EncodedVideo", "Mpeg4Writer", "Y4MFile", "Y4MWriter",
           "PngDirWriter", "FORMATS"]

FORMATS = ("an .mp4 or .avi file (MPEG-4 Part 2; raw I420 in .avi), a .y4m "
           "file (YUV4MPEG2, 8-bit 4:2:0) or a directory of PNG or JPEG "
           "frames")
_Y4M_MAGIC = b"YUV4MPEG2"
_420_TAGS = ("420jpeg", "420mpeg2", "420paldv", "420")
_MP4_EXTS = (".mp4", ".m4v", ".mov")
DEFAULT_FPS = 30.0


def _unsupported(path: str) -> ValueError:
    return ValueError(
        f"cannot read or write {path!r}: the port handles {FORMATS}; other "
        f"containers and codecs are {ITEM_8} (convert elsewhere, e.g. "
        "`ffmpeg -i in.mkv -c:v mpeg4 -q:v 3 out.mp4` or `ffmpeg -i in.mkv "
        "-pix_fmt yuv420p out.y4m`)")


def _kind(path: str, writing: bool = False) -> str:
    low = path.lower()
    if low.endswith(".y4m"):
        return "y4m"
    if low.endswith(_MP4_EXTS):
        if writing and not low.endswith(".mp4"):
            raise _unsupported(path)
        return "mp4"
    if low.endswith(".avi"):
        return "avi"
    if os.path.isdir(path) or (writing and not os.path.splitext(path)[1]):
        return "png"
    if not writing and not os.path.exists(path):
        raise FileNotFoundError(path)
    raise _unsupported(path)


# --------------------------------------------------------------- y4m

def _y4m_header(f) -> Tuple[Dict[str, str], int]:
    """(the header's parameters by tag letter, its length in bytes)."""
    line = f.readline(4096)
    if not line.startswith(_Y4M_MAGIC) or not line.endswith(b"\n"):
        raise ValueError("not a YUV4MPEG2 stream (bad header)")
    params = {}
    for tok in line[len(_Y4M_MAGIC):].split():
        params[chr(tok[0])] = tok[1:].decode("ascii")
    if "W" not in params or "H" not in params:
        raise ValueError("YUV4MPEG2 header without W or H")
    colour = params.get("C", "420")
    if colour not in _420_TAGS:
        raise ValueError(f"YUV4MPEG2 colour space C{colour} is not read: the "
                         "port reads 8-bit 4:2:0 (C420jpeg, C420mpeg2, "
                         "C420paldv, C420 or no C tag)")
    return params, len(line)


def _y4m_geometry(params) -> Tuple[int, int, int]:
    w, h = int(params["W"]), int(params["H"])
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return w, h, w * h + 2 * cw * ch


def _y4m_fps(params) -> float:
    if "F" not in params:
        return DEFAULT_FPS
    num, den = params["F"].split(":")
    return float(Fraction(int(num), int(den))) if int(den) else DEFAULT_FPS


def _y4m_to_bgr(buf: bytes, w: int, h: int) -> np.ndarray:
    """One 4:2:0 frame → BGR: the planes at even size (the last row and
    column repeated where a side is odd), OpenCV's I420 conversion,
    cropped."""
    cw, ch = (w + 1) // 2, (h + 1) // 2
    a = np.frombuffer(buf, np.uint8)
    y = a[:w * h].reshape(h, w)
    u = a[w * h:w * h + cw * ch].reshape(ch, cw)
    v = a[w * h + cw * ch:].reshape(ch, cw)
    if h % 2 or w % 2:
        y = np.pad(y, ((0, h % 2), (0, w % 2)), mode="edge")
    packed = np.concatenate([y.ravel(), u.ravel(), v.ravel()]).reshape(-1,
                                                                        2 * cw)
    return np.ascontiguousarray(i420_to_rgb(packed)[:h, :w, ::-1])


class Y4MFile:
    """A YUV4MPEG2 file's header and the byte offset of every frame, so a
    frame can be read by its index (``ConsecutiveFrames`` reads pairs in
    any order) or all of them in turn."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            params, pos = _y4m_header(f)
            self.fps = _y4m_fps(params)
            self.width, self.height, self._nbytes = _y4m_geometry(params)
            size = os.path.getsize(path)
            self.offsets = []
            while pos < size:
                f.seek(pos)
                tag = f.readline(4096)
                if not tag.startswith(b"FRAME"):
                    raise ValueError(f"{path}: bad YUV4MPEG2 frame header "
                                     f"{tag[:16]!r}")
                pos += len(tag)
                if pos + self._nbytes > size:
                    raise ValueError(f"{path}: truncated frame "
                                     f"{len(self.offsets)}")
                self.offsets.append(pos)
                pos += self._nbytes

    def __len__(self) -> int:
        return len(self.offsets)

    def _convert(self, buf: bytes) -> np.ndarray:
        return _y4m_to_bgr(buf, self.width, self.height)

    def frame(self, index: int) -> np.ndarray:
        """BGR uint8 frame ``index``."""
        with open(self.path, "rb") as f:
            f.seek(self.offsets[index])
            return self._convert(f.read(self._nbytes))

    def __iter__(self) -> Iterator[np.ndarray]:
        with open(self.path, "rb") as f:
            for off in self.offsets:
                f.seek(off)
                yield self._convert(f.read(self._nbytes))


# --------------------------------------------------------------- mp4 / avi

class EncodedVideo:
    """The video track of an ``.mp4`` or ``.avi`` file: its size, fps and
    frame count as ``cv2.VideoCapture`` reports them, and its frames.

    Iterating decodes every frame in turn (BGR); :meth:`frame` seeks: it
    decodes from the last keyframe at or before the index (``stss`` /
    ``idx1``), as FFmpeg's seek does; :meth:`read` keeps one decoder open
    and reads in order without seeking while the indices follow on."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.box = box = (Mp4File(path) if _kind(path) == "mp4" else
                          AviFile(path))
        self.fps, self.frames, self.keyframes = (box.fps, box.frames,
                                                 box.keyframes)
        if box.codec == "mpeg4":
            dec = self._decoder()
            if not dec.width:   # the VOL comes in band (AVI)
                with open(path, "rb") as f:
                    dec.probe(self.box.sample(f, 0))
            self.width, self.height = dec.width, dec.height
        else:
            self.width, self.height = box.width, box.height
        self._gen = None
        self._next = -1

    def __len__(self) -> int:
        return self.frames

    def _decoder(self) -> Decoder:
        return Decoder(self.box.dsi, what=self.path, tag=self.box.tag)

    def _raw(self, data: bytes):
        w, h = self.width, self.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        if len(data) < w * h + 2 * cw * ch:
            raise ValueError(f"{self.path}: a raw I420 frame of {len(data)} "
                             f"bytes, {w}x{h} needs {w * h + 2 * cw * ch}")
        a = np.frombuffer(data, np.uint8)
        return (a[:w * h].reshape(h, w),
                a[w * h:w * h + cw * ch].reshape(ch, cw),
                a[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw))

    def planes(self, start: int = 0) -> Iterator[Tuple[int, tuple]]:
        """(index, (Y, U, V)) of each picture from frame ``start`` on; a
        sample that yields no picture (a not-coded VOP) is passed over, as
        ``cv2.VideoCapture.read`` passes over it."""
        if not 0 <= start < self.frames:
            raise IndexError(f"frame {start} of {self.path}, which has "
                             f"{self.frames}")
        k = self.keyframes[max(bisect_right(self.keyframes, start) - 1, 0)]
        with open(self.path, "rb") as f:
            if self.box.codec == "i420":
                for i in range(start, self.frames):
                    yield i, self._raw(self.box.sample(f, i))
                return
            dec = self._decoder()
            for i in range(k, self.frames):
                p = dec.decode(self.box.sample(f, i))
                if p is not None and i >= start:
                    yield i, p

    def __iter__(self) -> Iterator[np.ndarray]:
        for _, p in self.planes():
            yield i420_to_bgr(*p)

    def frame(self, index: int) -> np.ndarray:
        """BGR frame ``index``, decoded from the keyframe before it."""
        with closing(self.planes(index)) as it:
            for _, p in it:
                return i420_to_bgr(*p)
        raise ValueError(f"{self.path}: frame {index} did not decode")

    def read(self, index: int) -> np.ndarray:
        """BGR frame ``index`` through one open decoder: the next frame in
        order costs one decode; any other index seeks."""
        if self._gen is None or index != self._next:
            self.close()
            self._gen = self.planes(index)
        try:
            i, p = next(self._gen)
        except StopIteration:
            self._gen = None
            raise ValueError(f"{self.path}: frame {index} did not decode")
        self._next = i + 1
        return i420_to_bgr(*p)

    def close(self) -> None:
        """Close the file and decoder :meth:`read` keeps open."""
        if self._gen is not None:
            self._gen.close()
            self._gen = None


# --------------------------------------------------------------- frame dir

_FRAME_EXTS = (".png", ".jpg", ".jpeg")


def _dir_frames(path: str):
    """The frame files of a directory in name order: its ``*.png``,
    ``*.jpg`` or ``*.jpeg`` files, of one kind."""
    found = {ext: sorted(glob(os.path.join(path, "*" + ext)))
             for ext in _FRAME_EXTS}
    kinds = [ext for ext, files in found.items() if files]
    if not kinds:
        raise FileNotFoundError(f"no *.png or *.jpg frames in {path}")
    if len(kinds) > 1:
        raise ValueError(f"{path} holds frames of more than one kind ("
                         + ", ".join("*" + k for k in kinds)
                         + "): a frame directory holds one")
    return found[kinds[0]]


def _read_frame_bgr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    img = decode_bytes(data, orient=False)
    if img is None:
        raise ValueError(f"{path}: {unread_format(data)}, which the frame "
                         "reader does not decode")
    return np.ascontiguousarray(rgb8(img)[..., ::-1])


# --------------------------------------------------------------- public

def read_frames(path: str, max_frames: Optional[int] = None,
                stride: int = 1) -> Iterator[np.ndarray]:
    """Yield BGR uint8 frames of ``path``: every ``stride``-th of its first
    ``max_frames`` (all when None)."""
    kind = _kind(path)
    if kind == "y4m":
        frames = iter(Y4MFile(path))
    elif kind in ("mp4", "avi"):
        frames = iter(EncodedVideo(path))
    else:
        frames = (_read_frame_bgr(p) for p in _dir_frames(path))
    for n, frame in enumerate(frames):
        if max_frames is not None and n >= max_frames:
            return
        if n % stride == 0:
            yield frame


def read_frame(path: str, index: int) -> np.ndarray:
    """BGR uint8 frame ``index`` of a video file or frame directory (an
    ``.mp4``/``.avi`` is decoded from the keyframe before it)."""
    kind = _kind(path)
    if kind == "y4m":
        return Y4MFile(path).frame(index)
    if kind in ("mp4", "avi"):
        return EncodedVideo(path).frame(index)
    return _read_frame_bgr(_dir_frames(path)[index])


def video_info(path: str) -> Dict[str, float]:
    """{"fps", "width", "height", "frames"} of a video file, as
    ``cv2.VideoCapture``'s ``CAP_PROP_*`` give them, or of a frame
    directory (which has no rate: 30 fps)."""
    kind = _kind(path)
    if kind in ("mp4", "avi"):
        v = EncodedVideo(path)
        return {"fps": v.fps, "width": v.width, "height": v.height,
                "frames": v.frames}
    if kind == "y4m":
        y4m = Y4MFile(path)
        return {"fps": y4m.fps, "width": y4m.width, "height": y4m.height,
                "frames": len(y4m)}
    files = _dir_frames(path)
    h, w = _read_frame_bgr(files[0]).shape[:2]
    return {"fps": DEFAULT_FPS, "width": w, "height": h,
            "frames": len(files)}


class Y4MWriter:
    """BGR frames → a ``C420jpeg`` YUV4MPEG2 file (OpenCV's conversion,
    ``runtime/mpeg4.to_i420``; an odd side is edge-padded for the chroma
    and cropped)."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int]):
        self.w, self.h = frame_size
        rate = Fraction(fps).limit_denominator(1001)
        self._f = open(path, "wb")
        self._f.write(f"YUV4MPEG2 W{self.w} H{self.h} F{rate.numerator}:"
                      f"{rate.denominator} Ip A1:1 C420jpeg\n".encode())

    def write(self, frame: np.ndarray) -> None:
        if frame.shape[:2] != (self.h, self.w):
            raise ValueError(f"frame {frame.shape[:2]} does not match the "
                             f"stream's {(self.h, self.w)}")
        yuv = to_i420(pad_to_even(frame))
        he, we = yuv.shape[0] * 2 // 3, yuv.shape[1]
        flat = yuv.reshape(-1)
        y = flat[:he * we].reshape(he, we)[:self.h, :self.w]
        self._f.write(b"FRAME\n")
        self._f.write(np.ascontiguousarray(y).tobytes())
        self._f.write(flat[he * we:].tobytes())

    def release(self) -> None:
        self._f.close()


def _rate(fps: float) -> Tuple[int, int]:
    """fps as (numerator, denominator), ``Fraction(fps).limit_denominator
    (1001)`` as ``Y4MWriter`` stores it, the numerator within MPEG-4's
    16-bit vop_time_increment_resolution."""
    if not fps > 0:
        raise ValueError(f"frame rate {fps} (must be > 0)")
    rate = Fraction(fps).limit_denominator(1001)
    if rate.numerator > 65535:
        rate = Fraction(fps).limit_denominator(max(1, int(65535 // fps)))
    if rate.numerator > 65535 or rate.numerator < 1:
        raise ValueError(f"frame rate {fps} has no MPEG-4 time base")
    return rate.numerator, rate.denominator


class Mpeg4Writer:
    """BGR frames → MPEG-4 Part 2 Simple Profile in ``.mp4`` or ``.avi``
    (``runtime/mpeg4``'s encoder: an I-VOP every 12 frames, P-VOPs between,
    quantiser 3, as ``cv2.VideoWriter`` with fourcc ``mp4v`` writes).
    An odd side is cropped to even (its last column or row dropped), as
    cv2's writer crops it.  Frames go to I420 in ``io/yuv.rgb_to_i420``'s
    arithmetic (in C, ``runtime/mpeg4.to_i420``).
    ``keep_recon`` keeps each frame's reconstruction (Y, U, V) in
    ``recon``, what every decoder that matches FFmpeg gives back."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int],
                 *, keep_recon: bool = False):
        self.in_w, self.in_h = frame_size
        self.w, self.h = self.in_w & ~1, self.in_h & ~1
        if self.w < 2 or self.h < 2:
            raise ValueError(f"frame size {frame_size} is too small to encode")
        rate = _rate(fps)
        avi = _kind(path, writing=True) == "avi"
        self.enc = Encoder(self.w, self.h, *rate, inband=avi)
        self.mux = (AviWriter(path, (self.w, self.h), rate) if avi else
                    Mp4Writer(path, (self.w, self.h), rate, self.enc.headers))
        self.recon = [] if keep_recon else None

    def write(self, frame: np.ndarray) -> None:
        if frame.shape[:2] != (self.in_h, self.in_w):
            raise ValueError(f"frame {frame.shape[:2]} does not match the "
                             f"stream's {(self.in_h, self.in_w)}")
        sample, key = self.enc.encode(
            *i420_planes(to_i420(frame[:self.h, :self.w])))
        self.mux.write(sample, key)
        if self.recon is not None:
            self.recon.append(self.enc.recon())

    def release(self) -> None:
        self.mux.release()


class PngDirWriter:
    """BGR frames → ``<dir>/000000.png``, ``000001.png``, ..."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int]):
        os.makedirs(path, exist_ok=True)
        self.path, self.n = path, 0

    def write(self, frame: np.ndarray) -> None:
        with open(os.path.join(self.path, f"{self.n:06d}.png"), "wb") as f:
            f.write(encode_png(np.ascontiguousarray(frame[..., ::-1])))
        self.n += 1

    def release(self) -> None:
        pass


class AsyncVideoWriter:
    """A video writer behind a background encode thread.

    ``path`` ending in ``.mp4`` or ``.avi`` writes MPEG-4 Part 2
    (:class:`Mpeg4Writer`), ``.y4m`` YUV4MPEG2, a directory (or a path
    without extension) PNG frames; anything else raises.  ``write``
    enqueues, blocking only when ``queue_size`` frames are already
    pending; ``release`` drains the queue, closes the file and re-raises
    any encoder error.
    """

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int],
                 *, queue_size: int = 32):
        kind = _kind(path, writing=True)
        writer = {"y4m": Y4MWriter, "png": PngDirWriter}.get(kind,
                                                             Mpeg4Writer)
        self._wr = writer(path, fps, frame_size)
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(
            maxsize=queue_size)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._encode_loop, daemon=True)
        self._thread.start()

    def _encode_loop(self) -> None:
        while True:
            frame = self._q.get()
            if frame is None:
                break
            try:
                self._wr.write(frame)
            except BaseException as e:  # surface on the caller's thread
                self._exc = e
                break
        self._wr.release()

    def isOpened(self) -> bool:  # noqa: N802 — cv2.VideoWriter's name
        return self._exc is None

    def _put(self, item: Optional[np.ndarray]) -> None:
        # bounded-wait put: if the encoder thread died (its exception is in
        # self._exc) nobody will drain the queue, and a plain blocking put
        # would deadlock the producer with the error never surfacing
        while True:
            if self._exc is not None:
                raise self._exc
            if not self._thread.is_alive():
                raise RuntimeError("encoder thread is not running "
                                   "(write after release?)")
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def write(self, frame: np.ndarray) -> None:
        self._put(frame)

    def release(self) -> None:
        if self._thread.is_alive():
            try:
                self._put(None)
            except Exception:
                pass  # encoder died; its error is re-raised below
            self._thread.join()
        if self._exc is not None:
            raise self._exc
