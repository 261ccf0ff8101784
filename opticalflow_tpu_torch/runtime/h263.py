"""ctypes binding of the port's H.263 decoder (``h263.cpp``).

:class:`Decoder` turns H.263 packets (one picture each: what
``cv2.VideoWriter`` writes with fourcc ``H263`` into ``.avi``, ``.mkv`` and
``.mov`` or ``s263`` into ``.3gp``, libavcodec's ``h263p`` encoder's H.263+,
old phones' video and early AVI captures) into yuv420p planes, bit-exact to
FFmpeg's ``h263`` decoder, which ``cv2.VideoCapture`` runs;
``runtime/mpeg4.i420_to_bgr`` converts them in swscale's arithmetic.
Baseline H.263 with Annex F (advanced prediction: 8x8 vectors and
overlapped block motion compensation) is read, and H.263+ (PLUSPTYPE
headers: custom picture formats and clocks, the rounding type) with
Annexes D (unrestricted vectors), F, I (advanced intra coding), J
(deblocking filter), K (slice-structured mode), S (alternative inter VLC)
and T (modified quantisation).  The library is built with ``g++`` at first
use into ``opticalflow_tpu_torch/_build/`` by ``runtime/_native.py``; a
failed build raises with the compiler's output.  Its calls release the
GIL.  ``sorenson=True`` reads Sorenson H.263 (fourcc ``FLV1``: Flash
video's codec 2, what ``cv2.VideoWriter`` writes for ``FLV1`` into
``.flv``, ``.avi``, ``.mkv`` and ``.mov``), bit-exact to FFmpeg's ``flv``
decoder: its own picture header (:func:`sorenson_header`), version 1's
escape, disposable pictures.  Damaged data raises ``ValueError``;
syntax-based arithmetic coding (Annex E), PB-frames (Annexes G and M),
B-pictures (Annex O), Annexes N, P, Q and R, rectangular or unordered
slices and unrestricted vectors outside PLUSPTYPE raise ``Unsupported``,
naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "SIZES", "SORENSON_FEATURES",
           "picture_size", "is_intra", "sorenson_header", "load"]

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
            "dc_128",
            # H.263+ (PLUSPTYPE)
            "plusptype", "custom_format", "extended_par", "custom_clock",
            "rounding_type", "ufep_0", "umv", "umv_long", "umv_stuffing",
            "aic", "aic_vertical", "aic_horizontal", "loop_filter",
            "slices", "alt_inter_vlc", "alt_inter_retry", "modified_quant",
            "dquant_escape")
# the Sorenson header's and escape's bits, after FEATURES' (h263.cpp)
SORENSON_FEATURES = ("flv_version_0", "flv_version_1", "flv_custom_size",
                     "flv_disposable", "flv_dropped", "flv_escape_11")

# the source formats' sizes (PTYPE bits 6-8 or OPPTYPE bits 1-3; 6 is the
# custom format, 7 in PTYPE PLUSPTYPE)
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
            "h263_dec_new": (_P, [_I64]),
            "h263_dec_free": (None, [_P]),
            "h263_dec_after_seek": (None, [_P]),
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


class _Bits:
    """MSB-first bits of a picture header."""

    def __init__(self, data: bytes, pos: int):
        self.v = int.from_bytes(data, "big")
        self.n = 8 * len(data)
        self.pos = pos

    def get(self, n: int) -> int:
        self.pos += n
        if self.pos > self.n:
            raise ValueError("truncated H.263 picture header")
        return self.v >> (self.n - self.pos) & ((1 << n) - 1)


def _header(packet: bytes) -> Optional[dict]:
    """What the picture header of the picture a packet starts (its PSC
    found byte-aligned, as FFmpeg finds it) says of the picture's type and
    size: {"intra": bool, "size": (width, height) or None where a
    PLUSPTYPE header without UFEP keeps the last one}; None without a PSC.
    """
    for i in range(len(packet) - 4):
        if not packet[i] and not packet[i + 1] and packet[i + 2] >> 2 == 0x20:
            break
    else:
        return None
    b = _Bits(packet[i:i + 24], 22 + 8)     # after the PSC and TR
    b.get(5)                                # marker, id, three flags
    fmt = b.get(3)
    if fmt not in (6, 7):
        return {"intra": not b.get(1), "size": SIZES.get(fmt)}
    ufep = b.get(3)
    if ufep == 1:
        fmt = b.get(3)
        b.get(15)
    ptype = b.get(3)
    b.get(7)                                # RPR, RRU, RTYPE, ..., CPM
    size = None
    if ufep == 1:
        size = SIZES.get(fmt)
        if fmt == 6:                        # CPFMT
            b.get(4)
            w = (b.get(9) + 1) * 4
            b.get(1)
            size = (w, b.get(9) * 4)
    return {"intra": ptype in (0, 7), "size": size}


# Sorenson's size codes 2-6 (0 and 1: custom sizes of 8 or 16 bits)
SORENSON_SIZES = {2: (352, 288), 3: (176, 144), 4: (128, 96), 5: (320, 240),
                  6: (160, 120)}


def sorenson_header(packet: bytes) -> Optional[dict]:
    """What a Sorenson H.263 picture header (at the packet's start, as
    FFmpeg's ``ff_flv_decode_picture_header`` reads it) says: {"version":
    0 or 1, "intra": bool, "disposable": bool, "size": (width, height) or
    None for a size code FFmpeg refuses}; None where the packet does not
    start with the 17-bit start code and a version of 0 or 1.  H.263's
    22-bit picture start code is no guide here: a version-1 header never
    matches it."""
    if len(packet) < 9:
        return None
    try:
        b = _Bits(packet[:12], 0)
        if b.get(17) != 1:
            return None
        version = b.get(5)
        if version > 1:
            return None
        b.get(8)                                # TR
        code = b.get(3)
        size = ((b.get(8), b.get(8)) if code == 0 else
                (b.get(16), b.get(16)) if code == 1 else
                SORENSON_SIZES.get(code))
        kind = b.get(2)
    except ValueError:
        return None
    if size is not None and 0 in size:
        size = None
    return {"version": version, "intra": kind == 0, "disposable": kind > 1,
            "size": size}


def picture_size(packet: bytes, sorenson: bool = False
                 ) -> Optional[Tuple[int, int]]:
    """The (width, height) a packet's picture header names (a Sorenson
    header where ``sorenson``); None without a picture header or where a
    PLUSPTYPE header does not name one."""
    head = sorenson_header(packet) if sorenson else _header(packet)
    return None if head is None else head["size"]


def is_intra(packet: bytes, sorenson: bool = False) -> bool:
    """Whether a packet holds an I-picture (a seek can start there)."""
    head = sorenson_header(packet) if sorenson else _header(packet)
    return head is not None and head["intra"]


class Decoder:
    """One stream's decoder (Sorenson H.263 where ``sorenson``); ``what``
    names the source in errors.  ``after_seek``: the decoder starts as
    FFmpeg's does after OpenCV's seek, holding the pictures of the
    capture's first read, so it skips no disposable picture (a capture
    just opened skips one that comes before any last picture)."""

    def __init__(self, what: str = "video", sorenson: bool = False,
                 after_seek: bool = False):
        self._lib = load()
        self._h = self._lib.h263_dec_new(int(sorenson))
        if after_seek:
            self._lib.h263_dec_after_seek(self._h)
        self.what, self.sorenson = what, sorenson
        self.width = self.height = 0

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.h263_dec_free(h)

    def decode(self, packet: bytes) -> Optional[Planes]:
        """One packet → its picture's (Y, U, V) planes, as FFmpeg hands
        them over (the H.263 decoder has no delay); None for a Sorenson
        disposable picture FFmpeg skips."""
        wh = (_I64 * 2)()
        msg = ctypes.create_string_buffer(_MSG)
        packet = bytes(packet)
        rc = self._lib.h263_dec_decode(self._h, packet, len(packet), wh, msg,
                                       _MSG)
        text = msg.value.decode("utf-8", "replace")
        if rc == _UNSUPPORTED:
            raise Unsupported(f"{self.what}: {text}: the port decodes H.263 "
                              f"baseline with Annex F and H.263+ with "
                              f"Annexes D, F, I, J, K, S and T only "
                              f"({ITEM_8})")
        if rc == _NO_FRAME:
            return None
        if rc != _OK:
            name = "Sorenson H.263" if self.sorenson else "H.263"
            raise ValueError(f"{self.what}: corrupt {name} stream: {text}")
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

    @property
    def sorenson_features(self) -> List[str]:
        """The Sorenson header features and escapes of the pictures decoded
        so far, by name (``SORENSON_FEATURES``)."""
        bits = int(self._lib.h263_dec_features(self._h)) >> len(FEATURES)
        return [n for i, n in enumerate(SORENSON_FEATURES) if bits >> i & 1]
