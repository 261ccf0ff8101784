"""ctypes binding of the port's Dirac/VC-2 decoder (``dirac.cpp``).

:class:`Decoder` turns Dirac packets (fourcc ``drac``: what
``cv2.VideoWriter`` writes for it through libavcodec's ``vc2`` encoder into
``.drc``, ``.avi``, ``.mkv``, ``.mov``, ``.mp4``, ``.ts`` and ``.nut``)
into planes, bit-exact to FFmpeg's ``dirac`` decoder, which
``cv2.VideoCapture`` runs: VC-2 HQ pictures (slices of interleaved
exp-Golomb coefficients) over the Deslauriers-Dubuc (9,7), LeGall (5,3) and
both Haar wavelets at depths 1-5, with the default or a custom quantisation
matrix, in 4:2:0, 4:2:2 or 4:4:4 at full or limited range, 8 bits a
sample (uint8 planes) or 10 or 12 (uint16 planes, as libavcodec's
yuv4xxp10/12 formats hold them).  After each decode,
:attr:`Decoder.shifts`, :attr:`Decoder.full_range`, :attr:`Decoder.matrix`
and :attr:`Decoder.bits` tell ``EncodedVideo`` how swscale converts the
planes.  The library is built with ``g++`` at first use into
``opticalflow_tpu_torch/_build/`` by ``runtime/_native.py``; a failed build
raises with the compiler's output.  Its calls release the GIL.  Damaged
data, and what FFmpeg's decoder refuses (field coding among it), raises
``ValueError``; what no encoder here writes (core-syntax and low-delay
pictures, the wavelets DD (13,7), Fidelity and Daubechies (9,7), depths
other than 8, 10 and 12 bits) raises ``Unsupported``, naming ROADMAP
Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Decoder", "FEATURES", "SeqInfo", "WAVELETS", "idwt",
           "is_keyframe", "load", "sequence_info", "split_units"]

_SRC = Path(__file__).resolve().parent / "dirac.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MSG = 400
_OK, _NO_PICTURE, _UNSUPPORTED = 0, 1, 2
PREFIX = b"BBCD"
UNIT_HEADER = 13

# the decoder's feature bits (dirac.cpp's Feature), in order
FEATURES = ("hq_pictures", "dd97", "legall53", "haar0", "haar1", "depth1",
            "depth2", "depth3", "depth4", "depth5", "custom_qm", "yuv420p",
            "yuv422p", "yuv444p", "limited_range", "full_range",
            "custom_size", "slices", "prefix_bytes", "size_scaler",
            "cut_coeffs", "reference_pictures", "10bit", "12bit")
_MATRICES = ("bt709", "bt601")
# the wavelet indices the decoder reads: Deslauriers-Dubuc (9,7), LeGall
# (5,3), Haar without and with shift
WAVELETS = {"dd97": 0, "legall53": 1, "haar0": 3, "haar1": 4}
_FRONT = 64             # dirac.cpp's kFront


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the Dirac decoder")
        sig = {
            "dirac_dec_new": (_P, []),
            "dirac_dec_free": (None, [_P]),
            "dirac_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                                ctypes.c_char_p, _I64]),
            "dirac_dec_layout": (None, [_P, ctypes.POINTER(_I64)]),
            "dirac_dec_output": (None, [_P, _P, _P, _P]),
            "dirac_dec_features": (_I64, [_P]),
            "dirac_seq_info": (ctypes.c_int, [ctypes.c_char_p, _I64,
                                              ctypes.POINTER(_I64),
                                              ctypes.c_char_p, _I64]),
            "dirac_idwt": (None, [_P, _I64, _I64, _I64, _I64, _I64]),
            "dirac_idwt32": (None, [_P, _I64, _I64, _I64, _I64, _I64]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def _fail(rc: int, text: str, what: str) -> None:
    if rc == _UNSUPPORTED:
        raise Unsupported(f"{what}: Dirac with {text}: the port decodes VC-2 "
                          f"HQ pictures as libavcodec's vc2 encoder writes "
                          f"them ({ITEM_8})")
    raise ValueError(f"{what}: corrupt Dirac stream: {text}")


class SeqInfo(NamedTuple):
    """A sequence header's picture size, frame rate, bits a sample and
    whether its pictures are coded as fields."""
    width: int
    height: int
    rate: Tuple[int, int]
    bit_depth: int
    fields: bool


def sequence_info(data: bytes, what: str = "video") -> Optional[SeqInfo]:
    """The first sequence header in ``data`` (None without one)."""
    lib = load()
    out = (_I64 * 6)()
    msg = ctypes.create_string_buffer(_MSG)
    data = bytes(data)
    rc = lib.dirac_seq_info(data, len(data), out, msg, _MSG)
    if rc == _NO_PICTURE:
        return None
    if rc != _OK:
        _fail(rc, msg.value.decode("utf-8", "replace"), what)
    w, h, num, den, depth, fields = list(out)
    return SeqInfo(w, h, (num, den), depth, bool(fields))


def idwt(coeffs: np.ndarray, wavelet: str, depth: int) -> np.ndarray:
    """The decoder's inverse wavelet over (H, W) int16 coefficients laid
    out as the decoder lays them (each level's low half of a line before
    its high half, its low lines on the even lines of its grid); H and W
    multiples of ``1 << depth``.  int32 coefficients (what the decoder
    keeps above 8 bits a sample) go through C's steps alone, in 32 bits."""
    h, w = coeffs.shape
    if h % (1 << depth) or w % (1 << depth):
        raise ValueError(f"a {w}x{h} plane is not padded to 1 << {depth}")
    stride = (w + 7) & ~7
    kind = np.int32 if coeffs.dtype == np.int32 else np.int16
    buf = np.zeros(_FRONT + stride * h, kind)
    buf[_FRONT:].reshape(h, stride)[:, :w] = coeffs
    run = load().dirac_idwt32 if kind == np.int32 else load().dirac_idwt
    run(buf.ctypes.data, w, h, stride, WAVELETS[wavelet], depth)
    return buf[_FRONT:].reshape(h, stride)[:, :w].copy()


def split_units(data: bytes) -> Tuple[List[int], List[int], List[int]]:
    """A Dirac stream (``.drc``, a transport stream's payload) cut into
    pictures by its parse units, each unit followed through its
    next-unit offset (a broken chain picks up at the next prefix): (each
    sample's start, each sample's picture unit offset, each picture's
    parse code).  A sample starts at the first unit after the picture
    before it that is not an end of sequence (FFmpeg's parser hands the
    decoder none between pictures), so it holds the sequence header and
    auxiliary data before its picture; units after the last picture make
    no sample."""
    starts, pictures, codes = [], [], []
    cur = i = data.find(PREFIX)
    while 0 <= i and i + UNIT_HEADER <= len(data):
        if data[i:i + 4] != PREFIX:
            i = data.find(PREFIX, i + 1)
            continue
        code = data[i + 4]
        step = int.from_bytes(data[i + 5:i + 9], "big")
        nxt = i + step if UNIT_HEADER <= step <= len(data) - i else None
        if code == 0x10 and cur == i and nxt is not None:
            cur = nxt                   # an end of sequence: passed over
        elif code & 0x08:
            starts.append(cur)
            pictures.append(i)
            codes.append(code)
            cur = nxt if nxt is not None else len(data)
        i = nxt if nxt is not None else data.find(PREFIX, i + 4)
    return starts, pictures, codes


def is_keyframe(packet: bytes) -> bool:
    """Whether a packet's picture is intra (its parse code refers to no
    other picture): every VC-2 picture is."""
    _, _, codes = split_units(packet)
    return bool(codes) and all(c & 3 == 0 for c in codes)


class Decoder:
    """One stream's decoder; ``what`` names the source in errors."""

    def __init__(self, what: str = "video"):
        self._lib = load()
        self.what = what
        self.shifts = (1, 1)
        self.full_range = False
        self.matrix = "bt709"
        self.bits = 8
        self._h = self._lib.dirac_dec_new()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.dirac_dec_free(h)

    def decode(self, packet: bytes) -> Optional[Tuple[np.ndarray, ...]]:
        """One packet → its picture's planes (Y, U, V); None where the
        packet hands over no picture (no picture unit in it)."""
        msg = ctypes.create_string_buffer(_MSG)
        packet = bytes(packet)
        rc = self._lib.dirac_dec_decode(self._h, packet, len(packet), msg,
                                        _MSG)
        if rc == _NO_PICTURE:
            return None
        if rc != _OK:
            _fail(rc, msg.value.decode("utf-8", "replace"), self.what)
        out = (_I64 * 7)()
        self._lib.dirac_dec_layout(self._h, out)
        w, h, xs, ys, full, matrix, bits = list(out)
        self.shifts = (xs, ys)
        self.full_range = bool(full)
        self.matrix = _MATRICES[matrix]
        self.bits = bits
        kind = np.uint8 if bits == 8 else np.uint16
        planes = [np.empty((h, w), kind),
                  np.empty((h >> ys, w >> xs), kind),
                  np.empty((h >> ys, w >> xs), kind)]
        self._lib.dirac_dec_output(self._h, *[p.ctypes.data for p in planes])
        return tuple(planes)

    @property
    def features(self) -> List[str]:
        """The coding tools of the pictures decoded so far, by name."""
        bits = int(self._lib.dirac_dec_features(self._h))
        return [name for i, name in enumerate(FEATURES) if bits >> i & 1]
