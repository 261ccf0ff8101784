"""ctypes binding of the port's VP9 decoder (``vp9.cpp``).

:class:`Decoder` turns VP9 packets (profile 0: 8-bit 4:2:0; what
``cv2.VideoWriter`` writes with fourcc ``VP90`` through libvpx, browsers'
``MediaRecorder`` and YouTube put into WebM) into yuv420p planes, bit-exact
to FFmpeg's native ``vp9`` decoder, which ``cv2.VideoCapture`` runs;
``runtime/mpeg4.i420_to_bgr`` converts them in swscale's arithmetic.  A
packet may be a superframe (a hidden alt-ref frame and a shown one): each
of its frames is decoded, and the shown ones are handed over.  The library
is built with ``g++`` at first use into ``opticalflow_tpu_torch/_build/`` by
``runtime/_native.py``; a failed build raises with the compiler's output.
Its calls release the GIL.  A frame that changes size predicts from
references of the old size through FFmpeg's scaled motion compensation
(:func:`scaled_8tap`, libvpx's 8-tap filters stepped across the reference),
and hands over planes of its own size.  A frame FFmpeg refuses raises
``ValueError``; profiles 1-3 (4:4:4, 4:2:2, 4:4:0, 10/12-bit) raise
``Unsupported``, naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "MATRICES", "frame_size", "is_keyframe",
           "load", "scaled_8tap"]

_SRC = Path(__file__).resolve().parent / "vp9.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(_I64)
_MSG = 400
_OK, _NO_FRAME, _CORRUPT, _UNSUPPORTED = 0, 1, 2, 3
_MAX_PICTURES = 8

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]

# swscale's matrix (runtime/mpeg4.MATRICES) for each colour_space of the
# header, as FFmpeg reports it to cv2 (unknown, BT.601, BT.709, SMPTE 170M,
# SMPTE 240M, BT.2020, reserved; 7, RGB, is profile 1)
MATRICES = ("bt601", "bt601", "bt709", "bt601", "smpte240m", "bt2020",
            "bt601", "bt601")

# the decoder's feature bits (vp9.cpp's Feature), in order
FEATURES = ("tile_cols", "tile_rows", "hidden_frames", "superframes",
            "show_existing_frame", "intra_only", "error_resilient",
            "backward_adaptation", "segmentation", "segment_temporal",
            "segment_alt_q", "segment_alt_lf", "segment_ref", "segment_skip",
            "lossless", "compound", "switchable_filter", "smooth_filter",
            "sharp_filter", "bilinear_filter", "high_precision_mv",
            "tx_select", "tx_32x32", "sub8x8", "scaled_reference",
            "reset_context", "lf_deltas", "lf_sharpness", "q_deltas",
            "full_range", "color_space", "no_context_refresh",
            "size_change", "prev_frame_mvs", "intra_in_inter", "new_mv",
            "context_index")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the VP9 decoder")
        sig = {
            "vp9_dec_new": (_P, []),
            "vp9_dec_free": (None, [_P]),
            "vp9_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                              _I64P, ctypes.c_char_p, _I64]),
            "vp9_dec_output": (None, [_P, _I64, _P, _P, _P]),
            "vp9_dec_features": (_I64, [_P]),
            "vp9_scaled_8tap": (None, [_P] + [_I64] * 12 + [_P, _I64, _I64]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def scaled_8tap(ref: np.ndarray, x: int, y: int, fx: int, fy: int, dx: int,
                dy: int, bw: int, bh: int, filt: int,
                dst: Optional[np.ndarray] = None) -> np.ndarray:
    """The decoder's scaled prediction of a ``bh`` x ``bw`` block (FFmpeg's
    ``do_scaled_8tap_c``): from the uint8 plane ``ref`` (read with its
    coordinates clamped to it) at integer position (x, y) and phase (fx,
    fy) in sixteenths of a pixel, each output pixel ``dx`` (``dy``)
    sixteenths on; ``filt`` is libvpx's filter (0 regular, 1 smooth, 2
    sharp, 3 bilinear).  Given ``dst`` (a block of the same size), the
    prediction is averaged into it, as a compound block's second one is."""
    ref = np.ascontiguousarray(ref, np.uint8)
    out = (np.zeros((bh, bw), np.uint8) if dst is None else
           np.ascontiguousarray(dst, np.uint8).copy())
    load().vp9_scaled_8tap(ref.ctypes.data, ref.shape[1], ref.shape[1],
                           ref.shape[0], x, y, fx, fy, dx, dy, bw, bh, filt,
                           out.ctypes.data, bw, int(dst is not None))
    return out


class _Bits:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.pos >= 8 * len(self.data):
                raise ValueError("truncated VP9 frame header")
            v = v << 1 | (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
            self.pos += 1
        return v


def _first_frame(packet: bytes) -> bytes:
    """The first frame of a packet (a superframe's index split off)."""
    if not packet:
        return packet
    marker = packet[-1]
    if marker & 0xE0 == 0xC0:
        n, mag = (marker & 7) + 1, ((marker >> 3) & 3) + 1
        idx = 2 + mag * n
        if len(packet) >= idx and packet[-idx] == marker:
            size = int.from_bytes(packet[-idx + 1:-idx + 1 + mag], "little")
            return packet[:size]
    return packet


def _header(frame: bytes) -> Tuple[int, int, bool]:
    """(profile, frame_type, show_existing_frame) of a frame."""
    b = _Bits(frame)
    if b.read(2) != 2:
        raise ValueError("not a VP9 frame (bad frame marker)")
    profile = b.read(1) | b.read(1) << 1
    if profile == 3:
        b.read(1)
    existing = bool(b.read(1))
    return profile, (0 if existing else b.read(1)), existing


def is_keyframe(packet: bytes) -> bool:
    """Whether a packet starts with a VP9 key frame."""
    try:
        _, ftype, existing = _header(_first_frame(packet))
    except ValueError:
        return False
    return not existing and ftype == 0


def frame_size(packet: bytes) -> Optional[Tuple[int, int]]:
    """A key frame's (width, height) from its header; None for another
    frame.  Profiles 1-3 raise ``Unsupported``."""
    frame = _first_frame(packet)
    profile, ftype, existing = _header(frame)
    if profile:
        raise Unsupported(f"VP9 profile {profile} (4:4:4, 4:2:2, 4:4:0 or "
                          f"10/12-bit), not read by the port ({ITEM_8})")
    if existing or ftype != 0:
        return None
    b = _Bits(frame)
    b.read(8)                       # marker, profile, flags, type, show, er
    if b.read(24) != 0x498342:
        raise ValueError("bad VP9 sync code")
    if b.read(3) != 7:              # colour space, then range
        b.read(1)
    return b.read(16) + 1, b.read(16) + 1


class Decoder:
    """One stream's decoder; ``what`` names the source in errors.  After a
    packet, ``full_range`` and ``color_space`` are its header's."""

    def __init__(self, what: str = "video"):
        self._lib = load()
        self._h = self._lib.vp9_dec_new()
        self.what = what
        self.width = self.height = 0
        self.full_range = False
        self.color_space = 0

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.vp9_dec_free(h)

    def decode_all(self, packet: bytes) -> List[Planes]:
        """One packet → the (Y, U, V) planes of each picture it shows (none
        for a hidden frame, one for most packets)."""
        info = (_I64 * (3 + 2 * _MAX_PICTURES))()
        msg = ctypes.create_string_buffer(_MSG)
        packet = bytes(packet)
        rc = self._lib.vp9_dec_decode(self._h, packet, len(packet), info,
                                      msg, _MSG)
        text = msg.value.decode("utf-8", "replace")
        if rc == _UNSUPPORTED:
            raise Unsupported(f"{self.what}: {text} ({ITEM_8})")
        if rc not in (_OK, _NO_FRAME):
            raise ValueError(f"{self.what}: corrupt VP9 frame: {text}")
        self.color_space, self.full_range = int(info[1]), bool(info[2])
        out = []
        for i in range(int(info[0]) if rc == _OK else 0):
            w, h = int(info[3 + 2 * i]), int(info[4 + 2 * i])
            self.width, self.height = w, h
            cw, ch = (w + 1) // 2, (h + 1) // 2
            y = np.empty((h, w), np.uint8)
            u = np.empty((ch, cw), np.uint8)
            v = np.empty((ch, cw), np.uint8)
            self._lib.vp9_dec_output(self._h, i, y.ctypes.data,
                                     u.ctypes.data, v.ctypes.data)
            out.append((y, u, v))
        return out

    def decode(self, packet: bytes) -> Optional[Planes]:
        """One packet → its last shown picture's planes, or None."""
        out = self.decode_all(packet)
        return out[-1] if out else None

    @property
    def features(self) -> List[str]:
        """The header features and coding tools of the frames decoded so
        far, by name (``FEATURES``)."""
        bits = int(self._lib.vp9_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
