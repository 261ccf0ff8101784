"""ctypes binding of the port's JPEG decoder (``jpeg.cpp``).

``jpeg.cpp`` decodes baseline, extended-sequential and progressive Huffman
JPEG to the pixels that libjpeg-turbo 3.1 gives at its defaults (what PIL,
imageio and OpenCV decode with), bit for bit, so the GPU machine, which has
none of them, reads the same frames.  It is built with ``g++`` at first use
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

__all__ = ["decode_jpeg", "declined_reason", "is_jpeg", "load"]

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
