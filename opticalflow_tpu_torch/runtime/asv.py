"""ctypes binding of the port's ASUS V1/V2 decoder (``asv.cpp``).

:class:`Decoder` turns ASV1 and ASV2 packets (fourccs ``ASV1``, ``ASV2``:
the intra-only DCT codec of ASUS capture cards, which ``cv2.VideoWriter``
writes into ``.avi``, ``.mkv`` and ``.mov``) into yuv420p planes,
bit-exact to FFmpeg's ``asv1``/``asv2`` decoders, which
``cv2.VideoCapture`` runs; ``runtime/mpeg4.i420_to_bgr`` converts them in
swscale's arithmetic.  Every packet is a key frame.  The library is built
with ``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Its calls release the GIL.  Damaged data raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load

__all__ = ["Decoder", "FEATURES", "load"]

_SRC = Path(__file__).resolve().parent / "asv.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK = 0

# the decoder's feature bits (asv.cpp), in order
FEATURES = ("asv1", "asv2", "partial_column", "partial_row", "escape",
            "default_qscale")

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the ASUS V1/V2 decoder")
        sig = {
            "asv_dec_new": (_P, [_I64, _I64, _I64, ctypes.c_char_p, _I64]),
            "asv_dec_free": (None, [_P]),
            "asv_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                              ctypes.c_char_p, _I64]),
            "asv_dec_output": (None, [_P, _P, _P, _P]),
            "asv_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


class Decoder:
    """One stream's decoder for the fourcc ``tag`` (``ASV1`` or ``ASV2``)
    at the container's ``width`` x ``height``, with its extradata (the
    first byte is the inverse quantiser, as FFmpeg's ``decode_init`` reads
    it); ``what`` names the source in errors."""

    def __init__(self, width: int, height: int, tag: str,
                 extradata: bytes = b"", what: str = "video"):
        self._lib = load()
        extradata = bytes(extradata)
        self.asv2 = tag.upper() == "ASV2"
        self._h = self._lib.asv_dec_new(int(self.asv2), width, height,
                                        extradata, len(extradata))
        self.width, self.height, self.what = width, height, what

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.asv_dec_free(h)

    def decode(self, packet: bytes) -> Planes:
        """One packet → its picture's (Y, U, V) planes."""
        packet = bytes(packet)
        msg = ctypes.create_string_buffer(_MSG)
        if self._lib.asv_dec_decode(self._h, packet, len(packet), msg,
                                    _MSG) != _OK:
            name = "ASUS V2" if self.asv2 else "ASUS V1"
            raise ValueError(f"{self.what}: corrupt {name} stream: "
                             f"{msg.value.decode('utf-8', 'replace')}")
        w, h = self.width, self.height
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.asv_dec_output(self._h, y.ctypes.data, u.ctypes.data,
                                 v.ctypes.data)
        return y, u, v

    @property
    def features(self) -> List[str]:
        """The coding tools of the stream and the packets decoded so far,
        by name (``FEATURES``)."""
        bits = int(self._lib.asv_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
