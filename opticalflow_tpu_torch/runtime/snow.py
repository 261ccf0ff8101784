"""ctypes binding of the port's Snow decoder (``snow.cpp``).

:class:`Decoder` turns the packets of FFmpeg's own wavelet codec Snow
(fourcc ``SNOW``: what ``cv2.VideoWriter`` writes for it into ``.avi``,
``.mkv``, ``.mov`` and ``.wmv``) into planes, bit-exact to FFmpeg's
``snow`` decoder, which ``cv2.VideoCapture`` runs: the 9/7 and 5/3
wavelets, lossless coding, overlapped block motion compensation with half-
and quarter-pel vectors, blocks split one level, several reference
frames, in yuv420p, yuv410p, yuv444p or gray (:attr:`Decoder.shifts`
tells ``EncodedVideo`` how to convert them).  The picture size comes from
the container: the bitstream carries none.  The library is built with
``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Its calls release the GIL.  Damaged data raises ``ValueError``; what
libavcodec's encoder never writes (an ``update_mc`` filter other than its
default, a temporal decomposition, spatial scalability, ``always_reset``,
other colour spaces and chroma shifts) raises ``Unsupported``, naming
ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "is_keyframe", "load"]

_SRC = Path(__file__).resolve().parent / "snow.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _UNSUPPORTED = 0, 2

# the decoder's feature bits (snow.cpp's Feature), in order
FEATURES = ("key_frames", "inter_frames", "dwt97", "dwt53", "lossless",
            "yuv420p", "yuv410p", "yuv444p", "gray", "hpel_vectors",
            "qpel_vectors", "split_blocks", "intra_blocks", "several_refs",
            "ref_index", "mc_h264_qpel", "mc_block", "mc_bilinear",
            "edge_replicated", "qbias", "count_update", "qlog_delta",
            "always_reset", "temporal_decomposition", "spatial_scalability",
            "mc_filter", "no_diag_mc")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the Snow decoder")
        sig = {
            "snow_dec_new": (ctypes.c_int, [_I64, _I64, ctypes.POINTER(_P),
                                            ctypes.c_char_p, _I64]),
            "snow_dec_free": (None, [_P]),
            "snow_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                               ctypes.c_char_p, _I64]),
            "snow_dec_layout": (None, [_P, ctypes.POINTER(_I64),
                                       ctypes.POINTER(_I64)]),
            "snow_dec_output": (None, [_P, _P, _P, _P]),
            "snow_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def is_keyframe(packet: bytes) -> bool:
    """Whether a packet holds a key frame: the range coder's first bit at
    the middle state, 1 where the first two bytes read 0x7F80 or more."""
    return len(packet) >= 2 and (packet[0] << 8 | packet[1]) >= 0x7F80


class Decoder:
    """One stream's decoder at the size the container gives; ``what``
    names the source in errors.  After each decode, :attr:`shifts` is the
    chroma subsampling of the planes it returned."""

    def __init__(self, width: int, height: int, what: str = "video"):
        self._lib = load()
        self.what = what
        self.width, self.height = width, height
        self.shifts = (1, 1)
        h = _P()
        msg = ctypes.create_string_buffer(_MSG)
        rc = self._lib.snow_dec_new(width, height, ctypes.byref(h), msg, _MSG)
        self._h = h.value
        self._check(rc, msg)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.snow_dec_free(h)

    def _check(self, rc: int, msg) -> None:
        text = msg.value.decode("utf-8", "replace")
        if rc == _UNSUPPORTED:
            raise Unsupported(f"{self.what}: Snow with {text}: the port "
                              f"decodes what libavcodec's snow encoder "
                              f"writes ({ITEM_8})")
        if rc != _OK:
            raise ValueError(f"{self.what}: corrupt Snow stream: {text}")

    def decode(self, packet: bytes) -> Tuple[np.ndarray, ...]:
        """One packet → its picture's planes: (Y, U, V), or (Y,) in gray."""
        msg = ctypes.create_string_buffer(_MSG)
        packet = bytes(packet)
        rc = self._lib.snow_dec_decode(self._h, packet, len(packet), msg,
                                       _MSG)
        self._check(rc, msg)
        n, s = _I64(), _I64()
        self._lib.snow_dec_layout(self._h, ctypes.byref(n), ctypes.byref(s))
        shift = int(s.value)
        self.shifts = (shift, shift)
        w, h = self.width, self.height
        cw, ch = -(-w >> shift), -(-h >> shift)
        planes = [np.empty((h, w), np.uint8)]
        if n.value == 3:
            planes += [np.empty((ch, cw), np.uint8) for _ in range(2)]
        ptrs = [p.ctypes.data for p in planes] + [None] * (3 - len(planes))
        self._lib.snow_dec_output(self._h, *ptrs)
        return tuple(planes)

    @property
    def features(self) -> List[str]:
        """The coding tools of the frames decoded so far, by name."""
        bits = int(self._lib.snow_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
