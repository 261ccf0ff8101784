"""ctypes binding of the port's TIFF decoder (``tiff.cpp``).

:class:`Decoder` turns TIFF pictures into what FFmpeg's ``tiff`` decoder
hands ``cv2.VideoCapture``'s swscale: what ``cv2.VideoWriter`` writes for
fourcc ``tiff`` (libavcodec's encoder: PackBits, YCbCr at 2x2 subsampling,
several strips) into ``.avi``, ``.mkv``, ``.mov`` and ``.nut``, and the
``.tif``/``.tiff`` files of an image sequence (``frames/%06d.tif``:
uncompressed, PackBits, LZW or Deflate, with or without Predictor 2, in
either byte order; 8-bit grey, 16-bit grey, RGB), bit-exact to FFmpeg.
Deflate strips are inflated here with the standard library's ``zlib``
(FFmpeg's ``tiff_uncompress``: one inflate into ``width x lines`` bytes)
and handed to the library.  Every picture is a key frame.  The library is
built with ``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Damaged data raises ``ValueError``; what FFmpeg reads and the port does
not (tiles, JPEG-in-TIFF, palettes, planar configuration 2, CMYK, alpha,
float samples, other depths and subsamplings) raises ``Unsupported``
naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
import zlib
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "LAYOUTS", "is_tiff", "load", "probe"]

_SRC = Path(__file__).resolve().parent / "tiff.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _UNSUPPORTED = 0, 2
_DEFLATE = (8, 32946)

# the decoder's feature bits (tiff.cpp), in order
FEATURES = ("little_endian", "big_endian", "raw", "packbits", "lzw",
            "deflate", "predictor", "gray8", "gray16", "rgb24", "yuv420p",
            "strips")
# the pixel formats FFmpeg's decoder picks (tiff.cpp's Layout), in order
LAYOUTS = ("gray8", "gray16le", "gray16be", "rgb24", "yuv420p")


def is_tiff(data: bytes) -> bool:
    """The bytes start as a TIFF file does (either byte order)."""
    return data[:4] in (b"II*\0", b"MM\0*")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the TIFF decoder")
        sig = {
            "tiff_dec_new": (_P, []),
            "tiff_dec_free": (None, [_P]),
            "tiff_probe": (ctypes.c_int, [ctypes.c_char_p, _I64, _P,
                                          ctypes.c_char_p, _I64]),
            "tiff_strips": (ctypes.c_int, [ctypes.c_char_p, _I64, _P, _I64,
                                           ctypes.c_char_p, _I64]),
            "tiff_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                               ctypes.c_char_p, _P,
                                               ctypes.c_char_p, _I64]),
            "tiff_dec_layout": (None, [_P, _P]),
            "tiff_dec_output": (None, [_P, _P, _P, _P]),
            "tiff_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def _fail(rc: int, text: str, what: str) -> None:
    if rc == _UNSUPPORTED:
        raise Unsupported(f"{what}: TIFF with {text}, not read by the port "
                          f"({ITEM_8})")
    raise ValueError(f"{what}: corrupt TIFF picture: {text}")


def probe(data: bytes, what: str = "video") -> Tuple[int, int, str]:
    """(width, height, FFmpeg's pixel format) of a TIFF picture."""
    out = (_I64 * 5)()
    msg = ctypes.create_string_buffer(_MSG)
    data = bytes(data)
    rc = load().tiff_probe(data, len(data), out, msg, _MSG)
    if rc != _OK:
        _fail(rc, msg.value.decode("utf-8", "replace"), what)
    return int(out[0]), int(out[1]), LAYOUTS[out[2]]


class Decoder:
    """TIFF pictures one after another (a stream's, or an image
    sequence's); ``what`` names the source in errors."""

    def __init__(self, what: str = "video"):
        self._lib = load()
        self.what = what
        self.layout = "yuv420p"
        self._h = self._lib.tiff_dec_new()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.tiff_dec_free(h)

    def _inflated(self, packet: bytes, strips: int,
                  msg) -> Tuple[bytes, object]:
        """Each of the ``strips`` Deflate strips the decoder reads inflated
        as ``tiff_uncompress`` inflates it (at most the bytes the strip's
        rows take; a stream that ends short leaves the rest to the
        library's zeros), and their lengths."""
        table = (_I64 * (3 * strips))()
        rc = self._lib.tiff_strips(packet, len(packet), table, strips, msg,
                                   _MSG)
        if rc != _OK:
            _fail(rc, msg.value.decode("utf-8", "replace"), self.what)
        parts = []
        for k in range(strips):
            off, size, want = (int(v) for v in table[3 * k:3 * k + 3])
            if not 0 <= off <= len(packet) or not 0 <= size <= len(packet):
                raise ValueError(f"{self.what}: corrupt TIFF picture: strip "
                                 f"{k} out of the packet")
            try:
                parts.append(zlib.decompressobj().decompress(
                    packet[off:off + size], max(want, 1))[:want])
            except zlib.error as e:
                raise ValueError(f"{self.what}: corrupt TIFF picture: strip "
                                 f"{k} does not inflate ({e})") from None
        sizes = (_I64 * len(parts))(*(len(p) for p in parts))
        return b"".join(parts), sizes

    def decode(self, packet: bytes
               ) -> Union[Tuple[np.ndarray, ...], np.ndarray]:
        """One picture → (Y, U, V) planes of yuv420p, (Y,) of grey (uint16
        at 16 bits), or the BGR array swscale makes of rgb24 (a copy)."""
        packet = bytes(packet)
        msg = ctypes.create_string_buffer(_MSG)
        if not is_tiff(packet):
            raise ValueError(f"{self.what}: corrupt TIFF picture: no TIFF "
                             f"header")
        z, sizes = b"", None
        out = (_I64 * 5)()
        rc = self._lib.tiff_probe(packet, len(packet), out, msg, _MSG)
        if rc == _OK and int(out[3]) in _DEFLATE:
            z, sizes = self._inflated(packet, int(out[4]), msg)
        rc = self._lib.tiff_dec_decode(self._h, packet, len(packet), z,
                                       sizes, msg, _MSG)
        if rc != _OK:
            _fail(rc, msg.value.decode("utf-8", "replace"), self.what)
        out = (_I64 * 3)()
        self._lib.tiff_dec_layout(self._h, out)
        w, h, pix = (int(v) for v in out)
        self.layout = LAYOUTS[pix]
        if self.layout == "yuv420p":
            planes = [np.empty((h, w), np.uint8)] + [
                np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
                for _ in range(2)]
            self._lib.tiff_dec_output(self._h,
                                      *[p.ctypes.data for p in planes])
            return tuple(planes)
        if self.layout == "rgb24":
            rgb = np.empty((h, w, 3), np.uint8)
            self._lib.tiff_dec_output(self._h, rgb.ctypes.data, None, None)
            return np.ascontiguousarray(rgb[..., ::-1])
        if self.layout == "gray8":
            y = np.empty((h, w), np.uint8)
            self._lib.tiff_dec_output(self._h, y.ctypes.data, None, None)
            return (y,)
        y = np.empty((h, w), "<u2" if self.layout == "gray16le" else ">u2")
        self._lib.tiff_dec_output(self._h, y.ctypes.data, None, None)
        return (y.astype(np.uint16),)

    @property
    def features(self) -> List[str]:
        """The coding tools of the pictures decoded so far, by name."""
        bits = int(self._lib.tiff_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
