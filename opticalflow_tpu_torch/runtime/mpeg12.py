"""ctypes binding of the port's MPEG-1/2 video decoder (``mpeg12.cpp``).

:class:`Decoder` turns MPEG-1 and MPEG-2 video packets (one picture each,
as a container or ``io/mpegps``'s splitter hands them over; what
``cv2.VideoWriter`` writes with fourcc ``PIM1`` or ``MPG2``, DVDs and
broadcast captures hold) into yuv420p planes, bit-exact to FFmpeg's
``mpeg1video``/``mpeg2video`` decoder, which ``cv2.VideoCapture`` runs, and
in the order FFmpeg hands them over: display order, a reference picture one
packet late, the last one at :meth:`Decoder.flush`.
``runtime/mpeg4.i420_to_bgr`` converts them in swscale's arithmetic
(:data:`CHROMA_SITE` and :func:`matrix` say with what).  The library is
built with ``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Its calls release the GIL.  Damaged data raises ``ValueError``; interlaced
coding (field pictures, field or dual-prime prediction, field DCT), 4:2:2
and 4:4:4, D-pictures, scalable extensions and repeated fields raise
``Unsupported``, naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from fractions import Fraction
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import (CHROMA_SITES, ITEM_8,
                                                  Unsupported)

__all__ = ["Decoder", "FEATURES", "CHROMA_SITE", "SequenceInfo", "matrix",
           "picture_types", "picture_info", "output_order", "display_order",
           "sequence_info", "load"]

_SRC = Path(__file__).resolve().parent / "mpeg12.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(_I64)
_MSG = 400
_OK, _NO_FRAME, _UNSUPPORTED = 0, 1, 2
_PACKET, _FLUSH, _EXTRADATA = 0, 1, 2

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]

# the decoder's feature bits (mpeg12.cpp's Feature), in order
FEATURES = ("mpeg1", "mpeg2", "p_pictures", "b_pictures", "skipped_p",
            "skipped_b", "intra_matrix", "inter_matrix",
            "quant_matrix_extension", "alternate_scan", "intra_vlc_format",
            "q_scale_type", "intra_dc_precision_9", "intra_dc_precision_10",
            "intra_dc_precision_11", "concealment_motion_vectors",
            "colour_description", "open_gop", "broken_link", "low_delay",
            "full_pel", "escape", "escape_long", "mb_quant", "mb_escape",
            "mb_stuffing", "forward", "backward", "bidirectional", "no_mc",
            "frame_motion_type", "interlaced_sequence", "oddify_zero",
            "mismatch", "size_change")

# the chroma site FFmpeg reports to swscale: centred for MPEG-1, left (co-
# sited with the even luma columns) for MPEG-2
CHROMA_SITE = {False: CHROMA_SITES["center"], True: CHROMA_SITES["left"]}

# ISO/IEC 13818-2 frame_rate_code 1-8, then the codes FFmpeg reads beyond
# them (Xing's 15 fps, libmpeg3's 5, 10, 12 and 15)
FRAME_RATES = (None, Fraction(24000, 1001), Fraction(24), Fraction(25),
               Fraction(30000, 1001), Fraction(30), Fraction(50),
               Fraction(60000, 1001), Fraction(60), Fraction(15),
               Fraction(5), Fraction(10), Fraction(12), Fraction(15))


def matrix(coefficients: int) -> str:
    """swscale's matrix (``runtime/mpeg4.MATRICES``) for a sequence display
    extension's matrix_coefficients, as ``sws_getCoefficients`` picks it
    (BT.601 where there is none)."""
    return {1: "bt709", 4: "fcc", 7: "smpte240m", 9: "bt2020",
            10: "bt2020"}.get(coefficients, "bt601")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the MPEG-1/2 decoder")
        sig = {
            "m12_dec_new": (_P, []),
            "m12_dec_free": (None, [_P]),
            "m12_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                              ctypes.c_int, _I64P,
                                              ctypes.c_char_p, _I64]),
            "m12_dec_output": (None, [_P, _I64, _P, _P, _P]),
            "m12_dec_features": (_I64, [_P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


class SequenceInfo:
    """A sequence header's (and extension's) size, rate and kind."""

    def __init__(self, width: int, height: int, fps: Fraction, mpeg2: bool,
                 low_delay: bool):
        self.width, self.height, self.fps = width, height, fps
        self.mpeg2, self.low_delay = mpeg2, low_delay


def _start_codes(data: bytes, code: int):
    """Offsets of the bodies after each ``00 00 01 code`` in ``data``."""
    pat = bytes((0, 0, 1, code))
    i = data.find(pat)
    while i >= 0:
        yield i + 4
        i = data.find(pat, i + 4)


def sequence_info(data: bytes, what: str = "video") -> Optional[SequenceInfo]:
    """The first sequence header in ``data`` (with the sequence extension
    after it), or None where there is none."""
    body = next(_start_codes(data, 0xB3), None)
    if body is None:
        return None
    h = data[body:body + 8]
    if len(h) < 8:
        raise ValueError(f"{what}: truncated MPEG sequence header")
    width, height = h[0] << 4 | h[1] >> 4, (h[1] & 15) << 8 | h[2]
    code = h[3] & 15
    rate = FRAME_RATES[code] if 0 < code < len(FRAME_RATES) else FRAME_RATES[1]
    mpeg2 = low_delay = False
    ext = data.find(b"\x00\x00\x01\xb5", body)
    nxt = data.find(b"\x00\x00\x01", body)
    if ext >= 0 and ext == nxt and len(data) >= ext + 10 and \
            data[ext + 4] >> 4 == 1:
        e = data[ext + 4:ext + 10]
        mpeg2 = True
        width |= ((e[1] & 1) << 1 | e[2] >> 7) << 12
        height |= (e[2] >> 5 & 3) << 12
        low_delay = bool(e[5] >> 7)
        n, d = (e[5] >> 5 & 3) + 1, (e[5] & 31) + 1
        rate = rate * n / d
    if not width or not height:
        raise ValueError(f"{what}: MPEG sequence header of size "
                         f"{width}x{height}")
    return SequenceInfo(width, height, rate, mpeg2, low_delay)


def picture_types(data: bytes) -> List[int]:
    """picture_coding_type (1 I, 2 P, 3 B, 4 D) of each picture header in
    ``data``."""
    return [data[i + 1] >> 3 & 7 for i in _start_codes(data, 0x00)
            if i + 1 < len(data)]


class Decoder:
    """One stream's decoder; ``what`` names the source in errors.  After a
    call, ``width``, ``height``, ``mpeg2``, ``low_delay``, ``matrix``
    (swscale's, from the sequence display extension) are the stream's, and
    ``serials`` gives, for each picture handed over, the number of the
    packet it came in (0 for the decoder's first).  ``extradata`` is a
    container's codec headers (Matroska's CodecPrivate, MP4's
    DecoderSpecificInfo), read before the first packet."""

    def __init__(self, what: str = "video", extradata: bytes = b""):
        self._lib = load()
        self._h = self._lib.m12_dec_new()
        self.what = what
        self.width = self.height = 0
        self.mpeg2 = self.low_delay = False
        self.matrix = "bt601"
        self.serials: List[int] = []
        if extradata:
            self._call(bytes(extradata), _EXTRADATA)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.m12_dec_free(h)

    def _call(self, data: bytes, mode: int) -> List[Planes]:
        info = (_I64 * 8)()
        msg = ctypes.create_string_buffer(_MSG)
        rc = self._lib.m12_dec_decode(self._h, data, len(data), mode, info,
                                      msg, _MSG)
        text = msg.value.decode("utf-8", "replace")
        if rc == _UNSUPPORTED:
            raise Unsupported(f"{self.what}: {text}, not read by the port "
                              f"({ITEM_8})")
        if rc not in (_OK, _NO_FRAME):
            raise ValueError(f"{self.what}: corrupt MPEG-1/2 video: {text}")
        self.width, self.height = int(info[1]), int(info[2])
        self.mpeg2 = bool(info[3])
        self.matrix = matrix(int(info[4]))
        self.low_delay = bool(info[5])
        out = []
        w, h = self.width, self.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        for i in range(int(info[0]) if rc == _OK else 0):
            y = np.empty((h, w), np.uint8)
            u = np.empty((ch, cw), np.uint8)
            v = np.empty((ch, cw), np.uint8)
            self._lib.m12_dec_output(self._h, i, y.ctypes.data,
                                     u.ctypes.data, v.ctypes.data)
            out.append((y, u, v))
        self.serials = [int(info[6 + i]) for i in range(len(out))]
        return out

    def decode(self, packet: bytes) -> List[Planes]:
        """One packet → the planes of the pictures it hands over (none, or
        one: the picture itself, or the reference before it)."""
        return self._call(bytes(packet), _PACKET)

    def flush(self) -> List[Planes]:
        """The end of the stream → the last reference picture, if one is
        still held."""
        return self._call(b"", _FLUSH)

    @property
    def features(self) -> List[str]:
        """The header features and coding tools of the pictures decoded so
        far, by name (``FEATURES``)."""
        bits = int(self._lib.m12_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]


def picture_info(sample: bytes) -> Tuple[int, Optional[bool]]:
    """(picture_coding_type, closed_gop of a GOP header before it, or None
    where the sample has none) of a sample's first picture."""
    types = picture_types(sample)
    gop = next(_start_codes(sample, 0xB8), None)
    closed = None
    if gop is not None and gop + 3 < len(sample):
        closed = bool(sample[gop + 3] >> 6 & 1)
    return (types[0] if types else 0), closed


def output_order(types: List[int], closed: List[Optional[bool]],
                 low_delay: bool = False,
                 resets: Iterable[int] = ()) -> List[int]:
    """The pictures FFmpeg's decoder hands over, in order, for a stream (or
    what follows a seek: the decoder starts flushed) fed from its first
    picture on (types and GOP flags in decode order): a B-picture is handed
    over when decoded (as is any picture of a low_delay stream), an I- or
    P-picture when the next one comes, the last at the end; a B-picture
    without a forward reference in an open GOP, and a P-picture before any
    sync point (an I-picture or GOP header), are dropped.  At each picture
    of ``resets`` (a sequence header of another size before it) FFmpeg
    reinitialises: the reference pictures are dropped, the one held back
    for display among them."""
    out: List[int] = []
    refs, prev, gop_closed, synced = 0, None, False, False
    resets = set(resets)
    for i, (t, c) in enumerate(zip(types, closed)):
        if i in resets:
            refs, prev = 0, None
        if not t:       # slices without a picture header: skipped
            continue
        if c is not None:
            gop_closed, synced = c, True
        if t == 1:
            synced = True
        if t == 3 and refs < 2 and not gop_closed:
            continue
        if t == 2 and refs == 0 and not synced:
            continue
        if t == 3 or low_delay:
            out.append(i)
        elif prev is not None:
            out.append(prev)
        if t != 3:
            prev, refs = i, refs + 1
    if prev is not None and not low_delay:
        out.append(prev)
    return out


def display_order(types: List[int], closed: List[Optional[bool]],
                  low_delay: bool = False,
                  resets: Iterable[int] = ()) -> List[Optional[int]]:
    """The display index of each picture of a stream decoded from its start
    (``output_order``), None for a picture the decoder drops."""
    disp: List[Optional[int]] = [None] * len(types)
    for d, i in enumerate(output_order(types, closed, low_delay, resets)):
        disp[i] = d
    return disp
