"""ctypes binding of the port's Ut Video decoder (``utvideo.cpp``).

:class:`Decoder` turns Ut Video packets (fourccs ``ULRG``, ``ULRA``,
``ULY0``, ``ULY2``, ``ULY4`` and the BT.709 ``ULH0``, ``ULH2``, ``ULH4``:
the lossless intra codec of capture and editing tools; ``cv2.VideoWriter``
writes 4:2:0 as ``ULY0`` for any of these fourccs) into frames, bit-exact
to FFmpeg's ``utvideo`` decoder, which ``cv2.VideoCapture`` runs: an RGB
stream's frame as packed BGR (swscale's GBRP/GBRAP → BGR24 copy, alpha
dropped), a YCbCr one as its planes, with the matrix its fourcc names
(``matrix``).  Every packet is a key frame.  The library is built with
``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Its calls release the GIL.  Damaged data raises ``ValueError``; the 10-bit
``UQ**`` family, the packed ``UM**`` family and interlaced streams (none
of which FFmpeg's encoder writes) raise ``Unsupported``, naming ROADMAP
Queue 1 item 8.
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

_SRC = Path(__file__).resolve().parent / "utvideo.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _UNSUPPORTED = 0, 2

# the decoder's feature bits (utvideo.cpp), in order
FEATURES = ("none", "left", "gradient", "median", "slices", "single_symbol",
            "rgb", "alpha", "yuv420", "yuv422", "yuv444", "bt709")

Frame = Union[np.ndarray, Tuple[np.ndarray, ...]]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the Ut Video decoder")
        sig = {
            "ut_dec_new": (_P, [_I64, _I64]),
            "ut_dec_free": (None, [_P]),
            "ut_dec_init": (ctypes.c_int, [_P, ctypes.c_char_p,
                                           ctypes.c_char_p, _I64,
                                           ctypes.POINTER(_I64),
                                           ctypes.c_char_p, _I64]),
            "ut_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                             ctypes.c_char_p, _I64]),
            "ut_dec_output": (None, [_P, _P, _P, _P]),
            "ut_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


class Decoder:
    """One stream's decoder at the container's ``width`` x ``height`` for
    the fourcc ``tag`` and the container's extradata (16 bytes: the
    encoder's version, the original format, the frame information size and
    the flags with the slice count), as FFmpeg's ``decode_init`` reads
    them; ``what`` names the source in errors.  ``kind`` is what
    :meth:`decode` returns: ``"bgr"`` or ``"yuv"`` (planes subsampled by
    ``shifts``, (horizontal, vertical), converted with ``matrix``)."""

    def __init__(self, width: int, height: int, tag: str,
                 extradata: bytes = b"", what: str = "video"):
        self._lib = load()
        self._h = self._lib.ut_dec_new(width, height)
        self.width, self.height, self.what = width, height, what
        info = (_I64 * 4)()
        extradata = bytes(extradata)
        self._check(self._lib.ut_dec_init(self._h, tag.encode("latin1"),
                                          extradata, len(extradata), info,
                                          *self._msg()))
        self.kind = "bgr" if info[0] else "yuv"
        self.shifts = (int(info[1]), int(info[2]))
        self.matrix = "bt709" if info[3] else "bt601"

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.ut_dec_free(h)

    def _msg(self):
        self._buf = ctypes.create_string_buffer(_MSG)
        return self._buf, _MSG

    def _check(self, rc: int) -> None:
        if rc == _OK:
            return
        text = self._buf.value.decode("utf-8", "replace")
        if rc == _UNSUPPORTED:
            raise Unsupported(f"{self.what}: Ut Video with {text}: not read "
                              f"by the port ({ITEM_8})")
        raise ValueError(f"{self.what}: corrupt Ut Video stream: {text}")

    def decode(self, packet: bytes) -> Frame:
        """One packet → its frame: BGR (H, W, 3) uint8 or (Y, U, V)."""
        packet = bytes(packet)
        self._check(self._lib.ut_dec_decode(self._h, packet, len(packet),
                                            *self._msg()))
        w, h = self.width, self.height
        if self.kind == "bgr":
            out = np.empty((h, w, 3), np.uint8)
            self._lib.ut_dec_output(self._h, out.ctypes.data, None, None)
            return out
        hs, vs = self.shifts
        y = np.empty((h, w), np.uint8)
        u = np.empty((h >> vs, w >> hs), np.uint8)
        v = np.empty_like(u)
        self._lib.ut_dec_output(self._h, y.ctypes.data, u.ctypes.data,
                                v.ctypes.data)
        return y, u, v

    @property
    def features(self) -> List[str]:
        """The coding tools of the stream and the frames decoded so far, by
        name (``FEATURES``)."""
        bits = int(self._lib.ut_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
