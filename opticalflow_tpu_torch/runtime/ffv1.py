"""ctypes binding of the port's FFV1 decoder (``ffv1.cpp``).

:class:`Decoder` turns FFV1 packets (what ``cv2.VideoWriter`` writes with
fourcc ``FFV1`` into ``.mkv``, ``.avi``, ``.mp4`` and ``.mov``: lossless
intra-frame video of archives and capture pipelines) into frames,
bit-exact to FFmpeg's ``ffv1`` decoder, which ``cv2.VideoCapture`` runs:
an RGB stream's frame as packed BGR (swscale's BGR0/BGRA → BGR24 copy,
the alpha plane dropped), a YCbCr stream's as its planes (grey: Y alone).
FFV1 versions 0-3 with the range or Golomb-Rice coder are read; the
stream's parameters come from the extradata (versions 2 and 3) or from
each key frame (versions 0 and 1).  The library is built with ``g++`` at
first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's
output.  Its calls release the GIL.  Damaged data (a CRC or slice size
that does not match) raises ``ValueError``; other bit depths, 4:2:2 and
4:4:4 YCbCr and version 4 raise ``Unsupported``, naming ROADMAP Queue 1
item 8.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "is_keyframe", "load"]

_SRC = Path(__file__).resolve().parent / "ffv1.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _UNSUPPORTED = 0, 2

# the decoder's feature bits (ffv1.cpp), in order
FEATURES = ("key_frames", "golomb", "range_default", "range_custom",
            "initial_states", "golomb_runs", "non_key_frames", "slices",
            "version_0_1", "yuv420", "grey", "rgb", "alpha", "version_2",
            "version_3", "crc")

Frame = Union[np.ndarray, Tuple[np.ndarray, ...]]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the FFV1 decoder")
        sig = {
            "ffv1_dec_new": (_P, [_I64, _I64]),
            "ffv1_dec_free": (None, [_P]),
            "ffv1_dec_extradata": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                                  ctypes.c_char_p, _I64]),
            "ffv1_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                               ctypes.POINTER(_I64),
                                               ctypes.c_char_p, _I64]),
            "ffv1_dec_output": (None, [_P, _P, _P, _P]),
            "ffv1_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def is_keyframe(packet: bytes) -> bool:
    """Whether a packet holds a key frame: its first range-coded bit (state
    128, from a coder just started) is set."""
    return len(packet) >= 2 and (packet[0] << 8 | packet[1]) >= 0x7F80


class Decoder:
    """One stream's decoder at the container's ``width`` x ``height`` (FFV1
    does not code the size); ``extradata`` is the container's (the codec
    private data: versions 2 and 3 keep their parameters there); ``what``
    names the source in errors."""

    def __init__(self, width: int, height: int, extradata: bytes = b"",
                 what: str = "video"):
        self._lib = load()
        self._h = self._lib.ffv1_dec_new(width, height)
        self.width, self.height, self.what = width, height, what
        self.rgb = False
        if extradata:
            self._check(self._lib.ffv1_dec_extradata(
                self._h, bytes(extradata), len(extradata), *self._msg()))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.ffv1_dec_free(h)

    def _msg(self):
        self._buf = ctypes.create_string_buffer(_MSG)
        return self._buf, _MSG

    def _check(self, rc: int) -> None:
        if rc == _OK:
            return
        text = self._buf.value.decode("utf-8", "replace")
        if rc == _UNSUPPORTED:
            raise Unsupported(f"{self.what}: {text}: not read by the port "
                              f"({ITEM_8})")
        raise ValueError(f"{self.what}: corrupt FFV1 stream: {text}")

    def decode(self, packet: bytes) -> Frame:
        """One packet → its frame: BGR (H, W, 3) uint8 for an RGB stream,
        else (Y,) for grey or (Y, U, V) for 4:2:0."""
        info = (_I64 * 3)()
        packet = bytes(packet)
        self._check(self._lib.ffv1_dec_decode(self._h, packet, len(packet),
                                              info, *self._msg()))
        w, h = self.width, self.height
        self.rgb = info[0] == 1
        if self.rgb:
            out = np.empty((h, w, 3), np.uint8)
            self._lib.ffv1_dec_output(self._h, out.ctypes.data, None, None)
            return out
        y = np.empty((h, w), np.uint8)
        if not info[1]:
            self._lib.ffv1_dec_output(self._h, y.ctypes.data, None, None)
            return (y,)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.ffv1_dec_output(self._h, y.ctypes.data, u.ctypes.data,
                                  v.ctypes.data)
        return y, u, v

    @property
    def features(self) -> List[str]:
        """The coding tools of the frames decoded so far, by name
        (``FEATURES``)."""
        bits = int(self._lib.ffv1_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
