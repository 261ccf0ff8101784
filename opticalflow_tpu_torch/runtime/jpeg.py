"""ctypes binding of the port's JPEG decoder (``jpeg.cpp``).

``jpeg.cpp`` decodes baseline, extended-sequential and progressive Huffman
JPEG in two flavours, so the GPU machine, which has neither PIL nor
OpenCV, reads the same pixels as the JAX package: :func:`decode_jpeg` gives
what libjpeg-turbo 3.1 gives at its defaults (PIL, imageio,
``cv2.imread``), :func:`decode_jpeg_ffmpeg` what ``cv2.VideoCapture`` gives
for a Motion JPEG frame or an image-sequence frame (FFmpeg's mjpeg decoder
and swscale), each bit for bit.  It is built with ``g++`` at first use
into ``opticalflow_tpu_torch/_build/`` by ``runtime/_native.py``; a failed
build raises with the compiler's output.  The call releases the GIL (a
``ctypes.CDLL`` call does), so loader and server threads decode in
parallel.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["decode_jpeg", "decode_jpeg_ffmpeg", "declined_reason", "is_jpeg",
           "jpeg_size", "load"]

_SRC = Path(__file__).resolve().parent / "jpeg.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64
_MSG = 512
_DONE, _DECLINED = 0, 1


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the JPEG decoder")
        lib.ojpeg_info.restype = ctypes.c_int
        lib.ojpeg_info.argtypes = [ctypes.c_char_p, _I64,
                                   ctypes.POINTER(_I64), ctypes.c_char_p,
                                   _I64]
        lib.ojpeg_decode.restype = ctypes.c_int
        lib.ojpeg_decode.argtypes = [ctypes.c_char_p, _I64, _U8P, _I64, _I64,
                                     ctypes.c_char_p, _I64]
        lib.ojpeg_decode_ff.restype = ctypes.c_int
        lib.ojpeg_decode_ff.argtypes = lib.ojpeg_decode.argtypes
        _lib = lib
        return lib


def is_jpeg(data: bytes) -> bool:
    """SOI followed by a marker: the bytes claim to be a JPEG."""
    return data[:3] == b"\xff\xd8\xff"


# EXIF orientation 2-8 as cv2.imdecode(..., IMREAD_COLOR) applies it (its
# ApplyExifOrientation): flip, or transpose then flip
def _orient(img: np.ndarray, tag: int) -> np.ndarray:
    if tag >= 5:
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    axes = flip.get(tag, ())
    return np.ascontiguousarray(np.flip(img, axes) if axes else img)


def _decode(data: bytes, orient: bool) -> Tuple[Optional[np.ndarray], str]:
    """(RGB array, "") or (None, why the decoder declines the bytes)."""
    if not is_jpeg(data):
        return None, "not a JPEG"
    lib = load()
    data = bytes(data)
    msg = ctypes.create_string_buffer(_MSG)
    info = (_I64 * 5)()
    rc = lib.ojpeg_info(data, len(data), info, msg, _MSG)
    if rc == _DONE:
        h, w = info[0], info[1]
        img = np.empty((h, w, 3), np.uint8)
        rc = lib.ojpeg_decode(data, len(data), img.ctypes.data_as(_U8P), h,
                              w, msg, _MSG)
    why = msg.value.decode("utf-8", "replace")
    if rc == _DECLINED:
        return None, why
    if rc != _DONE:
        raise ValueError(f"corrupt JPEG: {why}")
    if orient and 2 <= info[4] <= 8:
        img = _orient(img, info[4])
    return img, ""


def decode_jpeg(data: bytes, *, orient: bool) -> Optional[np.ndarray]:
    """JPEG bytes → (H, W, 3) uint8 RGB, or None where the decoder declines
    them (not a JPEG, or a flavour it does not read: arithmetic coding,
    lossless, more than 8 bits, CMYK/YCCK, ...; :func:`declined_reason`
    says which).  ``orient`` applies the EXIF orientation as
    ``cv2.imdecode(..., IMREAD_COLOR)`` does; without it the pixels are
    PIL's ``convert("RGB")`` (and imageio's).  Corrupt or truncated data
    raises ``ValueError``."""
    return _decode(data, orient)[0]


def declined_reason(data: bytes) -> Optional[str]:
    """Why :func:`decode_jpeg` returns None for ``data`` (None if it does
    not): e.g. "arithmetic-coded JPEG (SOF9)"."""
    img, why = _decode(data, False)
    return None if img is not None else why


def jpeg_size(data: bytes, what: str = "JPEG") -> Tuple[int, int]:
    """(height, width) from a JPEG's frame header; raises ``ValueError``
    for bytes that are not a JPEG or whose headers are corrupt."""
    if not is_jpeg(data):
        raise ValueError(f"{what}: not a JPEG")
    data = bytes(data)
    msg = ctypes.create_string_buffer(_MSG)
    info = (_I64 * 5)()
    if load().ojpeg_info(data, len(data), info, msg, _MSG) != _DONE:
        raise ValueError(f"{what}: bad JPEG headers: "
                         + msg.value.decode("utf-8", "replace"))
    return int(info[0]), int(info[1])


def decode_jpeg_ffmpeg(data: bytes, what: str = "JPEG") -> np.ndarray:
    """JPEG bytes → (H, W, 3) uint8 **BGR**: the frame ``cv2.VideoCapture``
    reads from them (a Motion JPEG sample, or a file of an image sequence),
    bit for bit: FFmpeg's mjpeg decoder (its dequantisation and simple
    IDCT, no block smoothing, the standard Huffman tables where the data
    has no DHT, no EXIF rotation) and swscale's full-range conversion.

    A flavour it does not read (arithmetic coding, lossless, 12-bit, CMYK,
    RGB, other chroma layouts) raises :class:`~runtime.mpeg4.Unsupported`
    naming ROADMAP Queue 1 item 8; corrupt data raises ``ValueError``;
    ``what`` names the source.  Nothing falls back to :func:`decode_jpeg`,
    whose pixels differ."""
    if not is_jpeg(data):
        raise ValueError(f"{what}: not a JPEG")
    lib = load()
    data = bytes(data)
    msg = ctypes.create_string_buffer(_MSG)
    info = (_I64 * 5)()
    rc = lib.ojpeg_info(data, len(data), info, msg, _MSG)
    if rc == _DONE:
        img = np.empty((info[0], info[1], 3), np.uint8)
        rc = lib.ojpeg_decode_ff(data, len(data), img.ctypes.data_as(_U8P),
                                 info[0], info[1], msg, _MSG)
    why = msg.value.decode("utf-8", "replace")
    if rc == _DECLINED:
        raise Unsupported(f"{what}: {why}: not read as OpenCV's "
                          f"VideoCapture reads it ({ITEM_8})")
    if rc != _DONE:
        raise ValueError(f"{what}: corrupt JPEG: {why}")
    return img
