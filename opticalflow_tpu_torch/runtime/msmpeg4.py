"""ctypes binding of the port's MS-MPEG4 and WMV7/8 decoder (``msmpeg4.cpp``).

:class:`Decoder` turns the packets of Microsoft's MPEG-4 variants into
yuv420p planes, bit-exact to FFmpeg's decoders, which ``cv2.VideoCapture``
runs: MS-MPEG4 v2 (``msmpeg4v2``: fourcc ``MP42``), v3 (``msmpeg4v3``: the
"DivX 3" ``DIV3``, ``MP43`` and their aliases), WMV7 (``wmv1``) and WMV8
(``wmv2``, whose four bytes of extradata carry its stream flags), as
``cv2.VideoWriter`` writes them into ``.avi``, ``.mkv``, ``.mov`` and
``.wmv``/``.asf`` and old dashcams and screen recorders left them.
``runtime/mpeg4.i420_to_bgr`` converts the planes in swscale's arithmetic.
The picture size comes from the container: the bitstream carries none.
The library is built with ``g++`` at first use into
``opticalflow_tpu_torch/_build/`` by ``runtime/_native.py``; a failed build
raises with the compiler's output.  Its calls release the GIL.  Damaged
data raises ``ValueError``; MS-MPEG4 v1, WMV8's J-pictures, mspel motion,
ABT blocks other than 8x8, its loop filter and its top-left vector
prediction raise ``Unsupported``, naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "VERSIONS", "NAMES", "is_keyframe", "load"]

_SRC = Path(__file__).resolve().parent / "msmpeg4.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _NO_FRAME, _UNSUPPORTED = 0, 1, 2

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]

# the port's codec names → FFmpeg's msmpeg4_version
VERSIONS = {"msmpeg4v2": 2, "msmpeg4v3": 3, "wmv1": 4, "wmv2": 5}
NAMES = {"msmpeg4v2": "MS-MPEG4 v2", "msmpeg4v3": "MS-MPEG4 v3",
         "wmv1": "WMV7", "wmv2": "WMV8"}

# the decoder's feature bits (msmpeg4.cpp's Feature), in order
FEATURES = ("p_pictures", "skipped_mb", "intra_mb_in_p", "ac_pred", "slices",
            "rl_luma_0", "rl_luma_1", "rl_luma_2", "rl_chroma_0",
            "rl_chroma_1", "rl_chroma_2", "rl_inter_0", "rl_inter_1",
            "rl_inter_2", "dc_table_0", "dc_table_1", "mv_table_0",
            "mv_table_1", "mv_escape", "mv_wrap", "escape_1", "escape_2",
            "escape_3", "dc_escape", "per_mb_rl", "skip_code", "flipflop",
            "ext_header", "inter_intra", "cbp_table_0", "cbp_table_1",
            "cbp_table_2", "skip_map", "overflow_ignored")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the MS-MPEG4/WMV decoder")
        sig = {
            "msmpeg4_dec_new": (ctypes.c_int, [_I64, _I64, _I64,
                                               ctypes.c_char_p, _I64,
                                               ctypes.POINTER(_P),
                                               ctypes.c_char_p, _I64]),
            "msmpeg4_dec_free": (None, [_P]),
            "msmpeg4_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                                  ctypes.c_char_p, _I64]),
            "msmpeg4_dec_output": (None, [_P, _P, _P, _P]),
            "msmpeg4_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def is_keyframe(packet: bytes, codec: str) -> bool:
    """Whether a packet holds an I-picture (a seek can start there): its
    first bits are the picture type (two bits, 0 for I; WMV8's one)."""
    if not packet:
        return False
    return packet[0] >> (7 if codec == "wmv2" else 6) == 0


class Decoder:
    """One stream's decoder: ``codec`` one of :data:`VERSIONS`, the size the
    container gives, WMV8's extradata; ``what`` names the source in
    errors."""

    def __init__(self, codec: str, width: int, height: int,
                 extradata: bytes = b"", what: str = "video"):
        self._lib = load()
        self.what, self.codec = what, codec
        self.width, self.height = width, height
        h = _P()
        msg = ctypes.create_string_buffer(_MSG)
        rc = self._lib.msmpeg4_dec_new(VERSIONS[codec], width, height,
                                       bytes(extradata), len(extradata),
                                       ctypes.byref(h), msg, _MSG)
        self._h = h.value
        self._check(rc, msg)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.msmpeg4_dec_free(h)

    def _check(self, rc: int, msg) -> None:
        text = msg.value.decode("utf-8", "replace")
        if rc == _UNSUPPORTED:
            raise Unsupported(f"{self.what}: {text}: the port decodes what "
                              f"libavcodec's {self.codec} encoder writes "
                              f"({ITEM_8})")
        if rc not in (_OK, _NO_FRAME):
            raise ValueError(f"{self.what}: corrupt {NAMES[self.codec]} "
                             f"stream: {text}")

    def decode(self, packet: bytes) -> Optional[Planes]:
        """One packet → its picture's (Y, U, V) planes, as FFmpeg hands
        them over (no delay); None for a WMV8 picture whose skip map skips
        every macroblock (FFmpeg's FRAME_SKIPPED)."""
        msg = ctypes.create_string_buffer(_MSG)
        packet = bytes(packet)
        rc = self._lib.msmpeg4_dec_decode(self._h, packet, len(packet), msg,
                                          _MSG)
        self._check(rc, msg)
        if rc == _NO_FRAME:
            return None
        w, h = self.width, self.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        y = np.empty((h, w), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        self._lib.msmpeg4_dec_output(self._h, y.ctypes.data, u.ctypes.data,
                                     v.ctypes.data)
        return y, u, v

    @property
    def features(self) -> List[str]:
        """The coding tools of the pictures decoded so far, by name."""
        bits = int(self._lib.msmpeg4_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
