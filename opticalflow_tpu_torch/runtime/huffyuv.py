"""ctypes binding of the port's HuffYUV and FFVHuff decoder
(``huffyuv.cpp``).

:class:`Decoder` turns HuffYUV packets (fourcc ``HFYU``: what
``cv2.VideoWriter`` writes as RGB24 with the left predictor and
decorrelation, and what capture tools write as YUY2-style 4:2:2) and
FFVHuff packets (fourcc ``FFVH``: FFmpeg's extension, which cv2 writes as
4:2:0, with per-frame code tables and version 3's planar layouts) into
frames, bit-exact to FFmpeg's ``huffyuv``/``ffvhuff`` decoder, which
``cv2.VideoCapture`` runs: an RGB stream's frame as packed BGR (swscale's
BGR0/BGRA/GBRP → BGR24 copy, alpha dropped), a grey one as its plane, a
YCbCr one as its planes.  Every packet is a key frame.  The library is
built with ``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Its calls release the GIL.  Damaged data raises ``ValueError``; samples
above 8 bits and the layouts FFmpeg decodes no picture of raise
``Unsupported``, naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "load"]

_SRC = Path(__file__).resolve().parent / "huffyuv.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _UNSUPPORTED = 0, 2

# the decoder's feature bits (huffyuv.cpp), in order
FEATURES = ("left", "plane", "median", "decorrelate", "classic_tables",
            "extradata_tables", "context", "interlaced", "yuv422", "yuv420",
            "rgb24", "rgb32", "version_3", "gray", "gbrp", "gbrap", "yuv444",
            "yuv411", "yuv440", "yuv410", "alpha", "odd_width")

Frame = Union[np.ndarray, Tuple[np.ndarray, ...]]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the HuffYUV decoder")
        sig = {
            "hyuv_dec_new": (_P, [_I64, _I64]),
            "hyuv_dec_free": (None, [_P]),
            "hyuv_dec_init": (ctypes.c_int, [_P, _I64, ctypes.c_char_p, _I64,
                                             ctypes.POINTER(_I64),
                                             ctypes.c_char_p, _I64]),
            "hyuv_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                               ctypes.c_char_p, _I64]),
            "hyuv_dec_output": (None, [_P, _P, _P, _P]),
            "hyuv_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


class Decoder:
    """One stream's decoder at the container's ``width`` x ``height``,
    from its bits per sample (``bpc``: the BITMAPINFOHEADER's
    ``biBitCount``, QuickTime's depth) and extradata, as FFmpeg's
    ``decode_init`` reads them; ``what`` names the source in errors.
    ``kind`` is what :meth:`decode` returns: ``"bgr"``, ``"gray"`` or
    ``"yuv"`` (planes subsampled by ``shifts``, (horizontal, vertical);
    ``alpha``: from a format with an alpha plane, which swscale converts
    through another path)."""

    def __init__(self, width: int, height: int, bpc: int,
                 extradata: bytes = b"", what: str = "video"):
        self._lib = load()
        self._h = self._lib.hyuv_dec_new(width, height)
        self.width, self.height, self.what = width, height, what
        info = (_I64 * 4)()
        extradata = bytes(extradata)
        self._check(self._lib.hyuv_dec_init(self._h, bpc, extradata,
                                            len(extradata), info,
                                            *self._msg()))
        self.kind = ("bgr", "gray", "yuv")[info[0]]
        self.shifts = (int(info[1]), int(info[2]))
        self.alpha = bool(info[3])

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.hyuv_dec_free(h)

    def _msg(self):
        self._buf = ctypes.create_string_buffer(_MSG)
        return self._buf, _MSG

    def _check(self, rc: int) -> None:
        if rc == _OK:
            return
        text = self._buf.value.decode("utf-8", "replace")
        if rc == _UNSUPPORTED:
            raise Unsupported(f"{self.what}: HuffYUV with {text}: not read by "
                              f"the port ({ITEM_8})")
        raise ValueError(f"{self.what}: corrupt HuffYUV stream: {text}")

    def decode(self, packet: bytes) -> Frame:
        """One packet → its frame: BGR (H, W, 3) uint8, (Y,) or (Y, U, V)."""
        packet = bytes(packet)
        self._check(self._lib.hyuv_dec_decode(self._h, packet, len(packet),
                                              *self._msg()))
        w, h = self.width, self.height
        if self.kind == "bgr":
            out = np.empty((h, w, 3), np.uint8)
            self._lib.hyuv_dec_output(self._h, out.ctypes.data, None, None)
            return out
        y = np.empty((h, w), np.uint8)
        if self.kind == "gray":
            self._lib.hyuv_dec_output(self._h, y.ctypes.data, None, None)
            return (y,)
        hs, vs = self.shifts
        u = np.empty((-(-h >> vs), -(-w >> hs)), np.uint8)
        v = np.empty_like(u)
        self._lib.hyuv_dec_output(self._h, y.ctypes.data, u.ctypes.data,
                                  v.ctypes.data)
        return y, u, v

    @property
    def features(self) -> List[str]:
        """The coding tools of the stream and the frames decoded so far, by
        name (``FEATURES``)."""
        bits = int(self._lib.hyuv_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
