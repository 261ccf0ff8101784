"""ctypes binding of the port's VP8 decoder (``vp8.cpp``).

:class:`Decoder` turns VP8 frames (RFC 6386; what ``cv2.VideoWriter``
writes with fourcc ``VP80`` through libvpx, and browsers' ``MediaRecorder``
into WebM) into yuv420p planes, bit-exact to FFmpeg's native ``vp8``
decoder, which ``cv2.VideoCapture`` runs; ``runtime/mpeg4.i420_to_bgr``
converts them in swscale's arithmetic.  The library is built with ``g++``
at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Its calls release the GIL.  A frame FFmpeg refuses raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load

__all__ = ["Decoder", "FEATURES", "frame_size", "is_keyframe", "load"]

_SRC = Path(__file__).resolve().parent / "vp8.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(_I64)
_MSG = 400
_OK, _NO_FRAME = 0, 1

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]

# the decoder's feature bits (vp8.cpp's Feature), in order
FEATURES = ("segmentation", "segment_map", "lf_deltas", "partitions",
            "golden_refresh", "altref_refresh", "buffer_copy", "sign_bias",
            "no_prob_refresh", "simple_filter", "hidden_frames", "b_pred",
            "split_mv", "bilinear", "full_pel_chroma", "coef_prob_update",
            "mv_prob_update", "mode_prob_update", "no_skip_flag",
            "quant_deltas", "sharpness", "golden_ref", "altref_ref",
            "near_mv", "new_mv", "no_last_refresh", "no_loop_filter",
            "intra_in_inter")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the VP8 decoder")
        sig = {
            "vp8_dec_new": (_P, []),
            "vp8_dec_free": (None, [_P]),
            "vp8_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                              _I64P, ctypes.c_char_p, _I64]),
            "vp8_dec_output": (None, [_P, _P, _P, _P]),
            "vp8_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def is_keyframe(frame: bytes) -> bool:
    """Whether a VP8 frame is a key frame (its frame tag's first bit)."""
    return len(frame) >= 3 and not frame[0] & 1


def frame_size(frame: bytes) -> Optional[Tuple[int, int]]:
    """A key frame's (width, height) as FFmpeg decodes it (the 14-bit
    sizes, the upscaling bits ignored); None for an inter frame."""
    if not is_keyframe(frame) or len(frame) < 10 or \
            frame[3:6] != b"\x9d\x01\x2a":
        return None
    return ((frame[6] | frame[7] << 8) & 0x3FFF,
            (frame[8] | frame[9] << 8) & 0x3FFF)


class Decoder:
    """One stream's decoder; ``what`` names the source in errors."""

    def __init__(self, what: str = "video"):
        self._lib = load()
        self._h = self._lib.vp8_dec_new()
        self.what = what
        self.width = self.height = 0
        # the last key frame's clamping_type bit (FFmpeg's full-range flag)
        # and whether the last frame was a key frame
        self.clamping = self.keyframe = False

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.vp8_dec_free(h)

    def decode(self, frame: bytes) -> Optional[Planes]:
        """One frame → its (Y, U, V) planes at the header's size, or None
        for a frame that is not shown (``show_frame`` = 0)."""
        wh = (_I64 * 4)()
        msg = ctypes.create_string_buffer(_MSG)
        frame = bytes(frame)
        rc = self._lib.vp8_dec_decode(self._h, frame, len(frame), wh, msg,
                                      _MSG)
        if rc in (_OK, _NO_FRAME):
            self.clamping, self.keyframe = bool(wh[2]), bool(wh[3])
        if rc == _NO_FRAME:
            return None
        if rc != _OK:
            raise ValueError(f"{self.what}: corrupt VP8 frame: "
                             f"{msg.value.decode('utf-8', 'replace')}")
        w, h = int(wh[0]), int(wh[1])
        self.width, self.height = w, h
        cw, ch = (w + 1) // 2, (h + 1) // 2
        y = np.empty((h, w), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        self._lib.vp8_dec_output(self._h, y.ctypes.data, u.ctypes.data,
                                 v.ctypes.data)
        return y, u, v

    @property
    def features(self) -> List[str]:
        """The header features and coding modes of the frames decoded so
        far, by name (``FEATURES``)."""
        bits = int(self._lib.vp8_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
