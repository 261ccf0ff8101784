"""ctypes binding of the port's H.263 decoder (``h263.cpp``).

:class:`Decoder` turns H.263 baseline packets (one picture each: what
``cv2.VideoWriter`` writes with fourcc ``H263`` into ``.avi``, ``.mkv`` and
``.mov`` or ``s263`` into ``.3gp``, old phones' video and early AVI
captures) into yuv420p planes, bit-exact to FFmpeg's ``h263`` decoder,
which ``cv2.VideoCapture`` runs; ``runtime/mpeg4.i420_to_bgr`` converts them
in swscale's arithmetic.  Annex F (advanced prediction: 8x8 vectors and
overlapped block motion compensation) is read.  The library is built with
``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Its calls release the GIL.  Damaged data raises ``ValueError``; H.263+
(PLUSPTYPE), syntax-based arithmetic coding (Annex E), PB-frames (Annex G)
and unrestricted vectors (Annex D) raise ``Unsupported``, naming ROADMAP
Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "SIZES", "picture_size", "is_intra",
           "load"]

_SRC = Path(__file__).resolve().parent / "h263.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(_I64)
_MSG = 400
_OK, _NO_FRAME, _UNSUPPORTED = 0, 1, 2

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]

# the decoder's feature bits (h263.cpp's Feature), in order
FEATURES = ("sub_qcif", "qcif", "cif", "4cif", "16cif", "p_pictures",
            "skipped_mb", "intra_mb_in_p", "dquant", "mv4",
            "advanced_prediction", "gob_headers", "escape",
            "escape_extended", "pei", "size_change", "mcbpc_stuffing",
            "dc_128")

# the source formats' sizes (PTYPE bits 6-8; 6 and 7 are PLUSPTYPE's)
SIZES = {1: (128, 96), 2: (176, 144), 3: (352, 288), 4: (704, 576),
         5: (1408, 1152)}


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the H.263 decoder")
        sig = {
            "h263_dec_new": (_P, []),
            "h263_dec_free": (None, [_P]),
            "h263_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                               _I64P, ctypes.c_char_p, _I64]),
            "h263_dec_output": (None, [_P, _P, _P, _P]),
            "h263_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def _ptype(packet: bytes) -> Optional[int]:
    """The 13 PTYPE bits of the picture a packet starts (its PSC found
    byte-aligned, as FFmpeg finds it), or None without a PSC."""
    for i in range(len(packet) - 4):
        if not packet[i] and not packet[i + 1] and packet[i + 2] >> 2 == 0x20:
            bits = int.from_bytes(packet[i + 2:i + 6].ljust(4, b"\0"), "big")
            return bits >> 5 & 0x1FFF      # after 6 PSC bits and the 8 of TR
    return None


def picture_size(packet: bytes) -> Optional[Tuple[int, int]]:
    """The (width, height) a packet's picture header names; None without a
    picture header.  A PLUSPTYPE header raises ``Unsupported``."""
    ptype = _ptype(packet)
    if ptype is None:
        return None
    fmt = ptype >> 5 & 7
    if fmt >= 6:
        raise Unsupported(f"H.263+ picture headers (PLUSPTYPE), not read by "
                          f"the port ({ITEM_8})")
    return SIZES.get(fmt)


def is_intra(packet: bytes) -> bool:
    """Whether a packet holds an I-picture (a seek can start there)."""
    ptype = _ptype(packet)
    return ptype is not None and ptype >> 5 & 7 < 6 and not ptype >> 4 & 1


class Decoder:
    """One stream's decoder; ``what`` names the source in errors."""

    def __init__(self, what: str = "video"):
        self._lib = load()
        self._h = self._lib.h263_dec_new()
        self.what = what
        self.width = self.height = 0

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.h263_dec_free(h)

    def decode(self, packet: bytes) -> Optional[Planes]:
        """One packet → its picture's (Y, U, V) planes, as FFmpeg hands
        them over (the H.263 decoder has no delay)."""
        wh = (_I64 * 2)()
        msg = ctypes.create_string_buffer(_MSG)
        packet = bytes(packet)
        rc = self._lib.h263_dec_decode(self._h, packet, len(packet), wh, msg,
                                       _MSG)
        text = msg.value.decode("utf-8", "replace")
        if rc == _UNSUPPORTED:
            raise Unsupported(f"{self.what}: {text}: the port decodes H.263 "
                              f"baseline with Annex F only ({ITEM_8})")
        if rc == _NO_FRAME:
            return None
        if rc != _OK:
            raise ValueError(f"{self.what}: corrupt H.263 stream: {text}")
        w, h = int(wh[0]), int(wh[1])
        self.width, self.height = w, h
        cw, ch = (w + 1) // 2, (h + 1) // 2
        y = np.empty((h, w), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        self._lib.h263_dec_output(self._h, y.ctypes.data, u.ctypes.data,
                                  v.ctypes.data)
        return y, u, v

    @property
    def features(self) -> List[str]:
        """The header features and coding tools of the pictures decoded so
        far, by name (``FEATURES``)."""
        bits = int(self._lib.h263_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
