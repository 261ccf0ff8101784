"""ctypes binding of the port's JPEG-LS decoder (``jpegls.cpp``).

:class:`Decoder` turns JPEG-LS pictures (fourcc ``MJLS``: what
``cv2.VideoWriter`` writes through libavcodec's ``jpegls`` encoder into
``.avi``, ``.mkv``, ``.mov``, ``.nut`` and ``.wmv``; SOF55, lossless,
line-interleaved colour or one grey component) into what FFmpeg's
``jpegls`` decoder hands ``cv2.VideoCapture``'s swscale, bit-exact:
rgb24 (returned as the BGR array swscale copies it to) or gray8.  Every
picture is a key frame.  The library is built with ``g++`` at first use
into ``opticalflow_tpu_torch/_build/`` by ``runtime/_native.py``; a failed
build raises with the compiler's output.  Damaged data raises
``ValueError``; near-lossless coding, palettes, sample interleaving,
restart intervals and more than 8 bits raise ``Unsupported`` naming ROADMAP
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

_SRC = Path(__file__).resolve().parent / "jpegls.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _UNSUPPORTED = 0, 2

# the decoder's feature bits (jpegls.cpp), in order
FEATURES = ("gray", "rgb", "ilv0", "ilv1", "run_mode", "escape", "lse",
            "reset")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the JPEG-LS decoder")
        sig = {
            "jls_dec_new": (_P, []),
            "jls_dec_free": (None, [_P]),
            "jls_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                              _I64, ctypes.c_char_p, _I64]),
            "jls_dec_layout": (None, [_P, _P]),
            "jls_dec_output": (None, [_P, _P]),
            "jls_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


class Decoder:
    """JPEG-LS pictures one after another; ``what`` names the source in
    errors."""

    def __init__(self, what: str = "video"):
        self._lib = load()
        self.what = what
        self._h = self._lib.jls_dec_new()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.jls_dec_free(h)

    def _run(self, packet: bytes, probe: bool) -> None:
        msg = ctypes.create_string_buffer(_MSG)
        rc = self._lib.jls_dec_decode(self._h, packet, len(packet),
                                      int(probe), msg, _MSG)
        if rc != _OK:
            text = msg.value.decode("utf-8", "replace")
            if rc == _UNSUPPORTED:
                raise Unsupported(f"{self.what}: JPEG-LS with {text}, not "
                                  f"read by the port ({ITEM_8})")
            raise ValueError(f"{self.what}: corrupt JPEG-LS picture: {text}")

    def size(self, packet: bytes) -> Tuple[int, int]:
        """(width, height) of a picture, from its SOF55 alone."""
        self._run(bytes(packet), True)
        out = (_I64 * 3)()
        self._lib.jls_dec_layout(self._h, out)
        return int(out[0]), int(out[1])

    def decode(self, packet: bytes) -> Union[Tuple[np.ndarray], np.ndarray]:
        """One picture → (Y,) of grey, or the BGR array of rgb24."""
        self._run(bytes(packet), False)
        out = (_I64 * 3)()
        self._lib.jls_dec_layout(self._h, out)
        w, h, comps = (int(v) for v in out)
        pic = np.empty((h, w, comps), np.uint8)
        self._lib.jls_dec_output(self._h, pic.ctypes.data)
        if comps == 1:
            return (pic[..., 0],)
        return np.ascontiguousarray(pic[..., ::-1])

    @property
    def features(self) -> List[str]:
        """The coding tools of the pictures decoded so far, by name."""
        bits = int(self._lib.jls_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
