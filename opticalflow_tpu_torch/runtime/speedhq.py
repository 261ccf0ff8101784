"""ctypes binding of the port's SpeedHQ decoder (``speedhq.cpp``).

:class:`Decoder` turns SpeedHQ packets (fourcc ``SHQ0``: the intra-only
DCT codec of NewTek's NDI, which ``cv2.VideoWriter`` writes through
libavcodec's ``speedhq`` encoder into ``.avi``, ``.mkv``, ``.mov``, ``.nut``
and ``.wmv``) into yuv420p planes, bit-exact to FFmpeg's ``speedhq``
decoder, which ``cv2.VideoCapture`` runs; ``runtime/mpeg4.i420_to_bgr``
converts them in swscale's arithmetic (BT.601, video range, chroma sited
at the centre as the decoder reports it).  The size comes from the
container.  Every packet is a key frame.  The library is built with
``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Damaged data raises ``ValueError``; ``SHQ1``-``SHQ9`` (4:2:2, 4:4:4, alpha),
interlaced pictures (two fields) and widths that are not a multiple of 16
raise ``Unsupported`` naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "load"]

_SRC = Path(__file__).resolve().parent / "speedhq.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _UNSUPPORTED = 0, 2

# the decoder's feature bits (speedhq.cpp), in order
FEATURES = ("escape", "partial_row")

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the SpeedHQ decoder")
        sig = {
            "shq_dec_new": (_P, [_I64, _I64]),
            "shq_dec_free": (None, [_P]),
            "shq_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                              ctypes.c_char_p, _I64]),
            "shq_dec_output": (None, [_P, _P, _P, _P]),
            "shq_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


class Decoder:
    """One stream's decoder for the fourcc ``tag`` at the container's
    ``width`` x ``height``; ``what`` names the source in errors."""

    def __init__(self, width: int, height: int, tag: str = "SHQ0",
                 what: str = "video"):
        if tag.upper() != "SHQ0":
            raise Unsupported(
                f"{what}: SpeedHQ {tag!r} (4:2:2, 4:4:4 or alpha; libavcodec's "
                f"encoder writes SHQ0 only), not read by the port ({ITEM_8})")
        if width <= 0 or height <= 0 or (width + 128) * (height + 128) >= (
                2**31 - 1) // 8:
            raise ValueError(f"{what}: a {width}x{height} SpeedHQ stream "
                             f"(FFmpeg's av_image_check_size refuses it)")
        self._lib = load()
        self._h = self._lib.shq_dec_new(width, height)
        self.width, self.height, self.what = width, height, what

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.shq_dec_free(h)

    def decode(self, packet: bytes) -> Planes:
        """One packet → its picture's (Y, U, V) planes."""
        packet = bytes(packet)
        msg = ctypes.create_string_buffer(_MSG)
        rc = self._lib.shq_dec_decode(self._h, packet, len(packet), msg, _MSG)
        if rc != _OK:
            text = msg.value.decode("utf-8", "replace")
            if rc == _UNSUPPORTED:
                raise Unsupported(f"{self.what}: SpeedHQ with {text}, not "
                                  f"read by the port ({ITEM_8})")
            raise ValueError(f"{self.what}: corrupt SpeedHQ stream: {text}")
        w, h = self.width, self.height
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.shq_dec_output(self._h, y.ctypes.data, u.ctypes.data,
                                 v.ctypes.data)
        return y, u, v

    @property
    def features(self) -> List[str]:
        """The coding tools of the packets decoded so far, by name."""
        bits = int(self._lib.shq_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
