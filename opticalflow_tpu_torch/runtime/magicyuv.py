"""ctypes binding of the port's MagicYUV decoder (``magicyuv.cpp``).

:class:`Decoder` turns MagicYUV packets (fourccs ``M8Y0``, ``M8RG``,
``M8RA``, ``M8G0``, ``M8Y2``, ``M8Y4``, ``M8YA``, ``MAGY``: the sliced
lossless intra codec of capture and editing tools, which
``cv2.VideoWriter`` writes as 4:2:0 for any of them) into frames,
bit-exact to FFmpeg's ``magicyuv`` decoder, which ``cv2.VideoCapture``
runs: an RGB frame as packed BGR (swscale's GBRP/GBRAP → BGR24 copy, alpha
dropped), a grey one as its plane, a YCbCr one as its planes with the
matrix and range its header names (``matrix``, ``full_range``).  The
layout comes with each packet's header, so the frame size is the
packet's.  Every packet is a key frame.  The library is built with
``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Its calls release the GIL.  Damaged data raises ``ValueError``; the 10-,
12- and 14-bit layouts and interlaced frames (which the port leaves out)
raise ``Unsupported``, naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "frame_size", "load"]

_SRC = Path(__file__).resolve().parent / "magicyuv.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _UNSUPPORTED = 0, 2

# the decoder's feature bits (magicyuv.cpp), in order
FEATURES = ("left", "gradient", "median", "other_pred", "raw_slice",
            "slices", "gbrp", "gbrap", "yuv444", "yuv422", "yuv420",
            "yuva444", "gray", "bt709", "full_range", "odd_size")

Frame = Union[np.ndarray, Tuple[np.ndarray, ...]]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the MagicYUV decoder")
        sig = {
            "magy_dec_new": (_P, []),
            "magy_dec_free": (None, [_P]),
            "magy_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                               ctypes.POINTER(_I64),
                                               ctypes.c_char_p, _I64]),
            "magy_dec_output": (None, [_P, _P, _P, _P]),
            "magy_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def frame_size(packet: bytes) -> Optional[Tuple[int, int]]:
    """The (width, height) a MagicYUV packet's header names; None where the
    packet has no ``MAGY`` header."""
    if len(packet) < 24 or packet[:4] != b"MAGY":
        return None
    return struct.unpack("<II", packet[16:24])


class Decoder:
    """One stream's decoder; ``what`` names the source in errors.  After
    :meth:`decode`, ``kind`` says what it returned (``"bgr"``, ``"gray"``
    or ``"yuv"``: planes subsampled by ``shifts``, (horizontal, vertical),
    converted with ``matrix`` at ``full_range``; ``alpha`` where the
    format had an alpha plane)."""

    def __init__(self, what: str = "video"):
        self._lib = load()
        self._h = self._lib.magy_dec_new()
        self.what = what
        self.kind, self.shifts, self.alpha = "yuv", (1, 1), False
        self.matrix, self.full_range = "bt601", False

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.magy_dec_free(h)

    def decode(self, packet: bytes) -> Frame:
        """One packet → its frame: BGR (H, W, 3) uint8, (Y,) or (Y, U, V)."""
        packet = bytes(packet)
        info = (_I64 * 7)()
        msg = ctypes.create_string_buffer(_MSG)
        rc = self._lib.magy_dec_decode(self._h, packet, len(packet), info,
                                       msg, _MSG)
        if rc != _OK:
            text = msg.value.decode("utf-8", "replace")
            if rc == _UNSUPPORTED:
                raise Unsupported(f"{self.what}: MagicYUV with {text}: not "
                                  f"read by the port ({ITEM_8})")
            raise ValueError(f"{self.what}: corrupt MagicYUV stream: {text}")
        w, h, layout, hs, vs = (int(info[k]) for k in range(5))
        self.kind = ("bgr", "gray", "yuv", "yuv")[layout]
        self.alpha = layout == 3
        self.shifts = (hs, vs)
        self.matrix = "bt709" if info[5] else "bt601"
        self.full_range = bool(info[6])
        if self.kind == "bgr":
            out = np.empty((h, w, 3), np.uint8)
            self._lib.magy_dec_output(self._h, out.ctypes.data, None, None)
            return out
        y = np.empty((h, w), np.uint8)
        if self.kind == "gray":
            self._lib.magy_dec_output(self._h, y.ctypes.data, None, None)
            return (y,)
        u = np.empty((-(-h >> vs), -(-w >> hs)), np.uint8)
        v = np.empty_like(u)
        self._lib.magy_dec_output(self._h, y.ctypes.data, u.ctypes.data,
                                  v.ctypes.data)
        return y, u, v

    @property
    def features(self) -> List[str]:
        """The layouts and coding tools of the packets decoded so far, by
        name (``FEATURES``)."""
        bits = int(self._lib.magy_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
