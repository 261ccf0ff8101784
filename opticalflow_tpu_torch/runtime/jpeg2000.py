"""ctypes binding of the port's JPEG 2000 decoder (``jpeg2000.cpp``).

:class:`Decoder` turns JPEG 2000 packets (fourcc ``MJ2C``/``mjp2``: what
``cv2.VideoWriter`` writes through libavcodec's ``jpeg2000`` encoder into
``.avi``, ``.mkv``, ``.mov``, ``.mp4``, ``.nut`` and ``.wmv``; a JP2 file
or a bare codestream each) into planes, bit-exact to FFmpeg's
``jpeg2000`` decoder, which ``cv2.VideoCapture`` runs: any tiling, the
five progression orders and POC, tile-parts, SOP and EPH markers, quality
layers, precincts, every code-block style but High-Throughput, the
reversible 5/3 and irreversible 9/7 wavelets with the RCT or ICT, 1 to 16
bits a sample, alpha planes and JP2 palettes.  After each decode,
:attr:`Decoder.layout` names the pixel format FFmpeg picks (``gray``,
``gray16``, ``ya8``, ``ya16``, ``rgb24``, ``rgb48``, ``rgba``,
``rgba64``, ``pal8``, or a planar YUV layout, with or without alpha,
whose chroma subsampling :attr:`Decoder.shifts` and depth
:attr:`Decoder.bits` give; :attr:`Decoder.alpha` whether it has an alpha
plane).  The library is built with
``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py`` (with ``-ffp-contract=off``: FFmpeg's float
wavelet is reproduced operation for operation); a failed build raises with
the compiler's output.  Its calls release the GIL.  Damaged data, and what
FFmpeg's decoder refuses, raises ``ValueError``; what the port leaves out
(image offsets, ROI shifts, packed packet headers, HTJ2K, Digital
Cinema's XYZ) raises ``Unsupported``, naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import (ITEM_8, Unsupported,
                                                  rgb48_to_bgr)

__all__ = ["Decoder", "FEATURES", "LAYOUTS", "load", "probe"]

_SRC = Path(__file__).resolve().parent / "jpeg2000.cpp"
_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _NO_PICTURE, _UNSUPPORTED = 0, 1, 2

# the decoder's feature bits (jpeg2000.cpp's Feature), in order
FEATURES = ("jp2", "codestream", "colr_srgb", "colr_gray", "colr_sycc",
            "rgb24", "gray8", "yuv410p", "yuv411p", "yuv420p", "yuv422p",
            "yuv440p", "yuv444p", "dwt97", "dwt53", "ict", "rct", "lrcp",
            "rlcp", "rpcl", "pcrl", "cprl", "tiles", "tile_parts", "sop",
            "eph", "layers", "precincts", "poc", "coc", "qcc", "qsty_none",
            "qsty_derived", "qsty_expounded", "bypass", "reset", "termall",
            "vsc", "predterm", "segsym", "odd_size", "comment", "gray16",
            "rgb48", "yuv_deep", "pal8", "alpha")
# the pixel formats (jpeg2000.cpp's kFormats) → (layout, chroma shifts,
# bits)
LAYOUTS = (("gray", (0, 0), 8), ("rgb24", (0, 0), 8),
           ("yuv410p", (2, 2), 8), ("yuv411p", (2, 0), 8),
           ("yuv420p", (1, 1), 8), ("yuv422p", (1, 0), 8),
           ("yuv440p", (0, 1), 8), ("yuv444p", (0, 0), 8),
           ("gray16", (0, 0), 16), ("rgb48", (0, 0), 16),
           *((f"yuv{c}p{b}", s, b) for b in (9, 10, 12, 14, 16)
             for c, s in (("420", (1, 1)), ("422", (1, 0)),
                          ("444", (0, 0)))),
           ("pal8", (0, 0), 8), ("rgba", (0, 0), 8), ("rgba64", (0, 0), 16),
           ("ya8", (0, 0), 8), ("ya16", (0, 0), 16),
           *((f"yuva{c}p{'' if b == 8 else b}", s, b) for b in (8, 9, 10, 16)
             for c, s in (("420", (1, 1)), ("422", (1, 0)),
                          ("444", (0, 0)))))


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the JPEG 2000 decoder")
        sig = {
            "j2k_dec_new": (_P, []),
            "j2k_dec_free": (None, [_P]),
            "j2k_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                              ctypes.c_char_p, _I64]),
            "j2k_dec_layout": (None, [_P, ctypes.POINTER(_I64)]),
            "j2k_dec_output": (None, [_P, _P, _P, _P, _P]),
            "j2k_dec_palette": (None, [_P, _P]),
            "j2k_dec_features": (_I64, [_P]),
            "j2k_dec_times": (None, [_P, ctypes.POINTER(ctypes.c_double)]),
            "j2k_probe": (ctypes.c_int, [ctypes.c_char_p, _I64,
                                         ctypes.POINTER(_I64),
                                         ctypes.c_char_p, _I64]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def _fail(rc: int, text: str, what: str) -> None:
    if rc == _UNSUPPORTED:
        raise Unsupported(f"{what}: JPEG 2000 with {text}: the port decodes "
                          f"JPEG 2000 as libavcodec's jpeg2000 encoder "
                          f"writes it ({ITEM_8})")
    raise ValueError(f"{what}: corrupt JPEG 2000 picture: {text}")


def probe(data: bytes, what: str = "video") -> Optional[Tuple[int, int]]:
    """(width, height) of the picture SIZ names in a packet (a JP2 file or
    a codestream); None without a SIZ marker."""
    out = (_I64 * 4)()
    msg = ctypes.create_string_buffer(_MSG)
    data = bytes(data)
    rc = load().j2k_probe(data, len(data), out, msg, _MSG)
    if rc == _NO_PICTURE:
        return None
    if rc != _OK:
        _fail(rc, msg.value.decode("utf-8", "replace"), what)
    return int(out[0]), int(out[1])


class Decoder:
    """One stream's decoder (its pixel format carries over from picture to
    picture, as FFmpeg's context keeps it); ``what`` names the source in
    errors."""

    def __init__(self, what: str = "video"):
        self._lib = load()
        self.what = what
        self.layout = "yuv420p"
        self.shifts = (1, 1)
        self.bits = 8
        self.alpha = False
        self._h = self._lib.j2k_dec_new()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.j2k_dec_free(h)

    def decode(self, packet: bytes
               ) -> Union[Tuple[np.ndarray, ...], np.ndarray]:
        """One packet → its picture: (Y, U, V) planes of a YUV layout (an
        alpha plane dropped, as cv2's conversion drops it), (Y,) of grey
        (uint16 above 8 bits; alpha dropped), or, where FFmpeg picks a
        packed RGB layout or a palette, the BGR array cv2's conversion
        makes of it (a copy, the palette's colours; 16-bit RGB through
        swscale's YUV, ``mpeg4.rgb48_to_bgr``)."""
        msg = ctypes.create_string_buffer(_MSG)
        packet = bytes(packet)
        rc = self._lib.j2k_dec_decode(self._h, packet, len(packet), msg,
                                      _MSG)
        if rc != _OK:
            _fail(rc, msg.value.decode("utf-8", "replace"), self.what)
        out = (_I64 * 5)()
        self._lib.j2k_dec_layout(self._h, out)
        w, h, pix, n, stored = list(out)
        self.layout, self.shifts, self.bits = LAYOUTS[pix]
        kind = np.uint16 if stored == 16 else np.uint8
        self.alpha = self.layout.startswith("yuva")
        if not self.layout.startswith("yuv"):
            # one packed plane: rgb, rgba, ya or palette indices
            comps = {"rgb": 3, "rgba": 4, "ya": 2}.get(
                self.layout.rstrip("0123456789"), 1)
            packed = np.empty((h, w, comps), kind)
            self._lib.j2k_dec_output(self._h, packed.ctypes.data, None, None,
                                     None)
            if self.layout == "pal8":
                pal = (ctypes.c_uint32 * 256)()
                self._lib.j2k_dec_palette(self._h, pal)
                bgr = np.frombuffer(pal, np.uint32).view(np.uint8).reshape(
                    256, 4)[:, :3]
                return np.ascontiguousarray(bgr[packed[..., 0]])
            if comps <= 2:
                return (np.ascontiguousarray(packed[..., 0]),)
            if kind == np.uint16:
                return rgb48_to_bgr(packed)
            return np.ascontiguousarray(packed[..., 2::-1])
        xs, ys = self.shifts
        planes = [np.empty((h, w), kind)] + [
            np.empty((-(-h >> ys), -(-w >> xs)), kind) for _ in range(2)]
        if n == 4:
            planes.append(np.empty((h, w), kind))
        ptrs = [p.ctypes.data for p in planes] + [None] * (4 - n)
        self._lib.j2k_dec_output(self._h, *ptrs)
        return tuple(planes[:3])

    @property
    def features(self) -> List[str]:
        """The coding tools of the pictures decoded so far, by name."""
        bits = int(self._lib.j2k_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]

    @property
    def times(self) -> Tuple[float, float, float]:
        """Milliseconds spent so far: (tier 1 with the dequantisation, the
        inverse wavelet, the inverse MCT with the level shift and
        output)."""
        out = (ctypes.c_double * 3)()
        self._lib.j2k_dec_times(self._h, out)
        return tuple(out)
