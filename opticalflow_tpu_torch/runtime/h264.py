"""ctypes binding of the port's H.264 decoder (``h264.cpp``).

:class:`Decoder` turns H.264 packets (an access unit each, Annex B or with
the NAL length prefix of the container's ``avcC`` record) into yuv420p
planes, bit-exact to FFmpeg's ``h264`` decoder, which ``cv2.VideoCapture``
runs, and hands them over as FFmpeg does: through its reorder buffer, none
before the first IDR picture or recovery point, the rest at
:meth:`Decoder.flush`, cropped as FFmpeg crops them.  Progressive 8-bit
4:2:0 I, P and B slices are read, in CAVLC and CABAC, with the 8x8
transform, scaling matrices, weighted and bi-prediction (explicit and
implicit), spatial and temporal direct prediction, long-term references,
B pictures as references and several slices a picture; the reorder depth
the decoder starts from is the one FFmpeg's probe leaves for cv2
(:func:`probe_delay`).  The library is built with ``g++`` at first use into
``opticalflow_tpu_torch/_build/`` by ``runtime/_native.py``; a failed build
raises with the compiler's output.  Its calls release the GIL.  Damaged
data raises ``ValueError``; SP and SI slices, field pictures and MBAFF,
other than 8-bit 4:2:0, lossless coding, slice groups, data partitioning,
redundant pictures, a gap in frame_num and whatever FFmpeg would conceal
raise ``Unsupported``, naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import ctypes
import threading
from fractions import Fraction
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
from opticalflow_tpu_torch.runtime.mpeg12 import matrix

__all__ = ["Decoder", "FEATURES", "B_FEATURES", "MODES", "StreamInfo", "probe",
           "probe_delay",
           "chroma_site", "is_keyframe", "nal_units", "load"]

_SRC = Path(__file__).resolve().parent / "h264.cpp"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(_I64)
_MSG = 400
_OK, _NO_FRAME, _UNSUPPORTED = 0, 1, 2

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]

# the decoder's feature bits (h264.cpp's Feature), in order
FEATURES = (
    "cavlc", "cabac", "annexb", "avcc", "i_pcm", "i4x4", "i8x8", "i16x16",
    "p_16x16", "p_16x8", "p_8x16", "p_8x8", "p_8x8ref0", "sub_8x8",
    "sub_8x4", "sub_4x8", "sub_4x4", "p_skip", "multi_ref", "list_mod",
    "long_term_list_mod", "long_term", "mmco1", "mmco2", "mmco3", "mmco4",
    "mmco5", "mmco6", "sliding_window", "weighted", "sps_scaling",
    "pps_scaling", "fallback_a", "fallback_b", "default_list",
    "chroma_qp_offset", "second_chroma_qp_offset", "qp_delta", "qp_wrap",
    "deblock_off", "deblock_slice_edges", "deblock_offsets", "multi_slice",
    "poc0", "poc1", "poc2", "vui", "reorder", "full_range",
    "colour_description", "chroma_loc", "cropping", "left_crop_dropped",
    "recovery_point", "mid_idr", "non_idr_i", "constrained_intra",
    "transform_8x8", "level_escape", "non_ref", "edge_mv",
    "reorder_guessed", "params_resent")

# what B slices reached (h264.cpp's FeatureB): each mb_type of Table 7-14,
# each sub_mb_type of Table 7-18, B_Skip, the two direct modes with
# direct_8x8_inference_flag 1 and 0, colZeroFlag's zero vectors, an intra
# co-located block and one that predicted from list 1 only, implicit
# weights (and their 32/32 fall-back), explicit weights on both lists,
# list 1's modification and its first two entries swapped, a B picture
# used as a reference, a long-term picture in list 1, an intra macroblock
# in a B slice, a temporal direct block whose co-located reference list 0
# no longer holds (FFmpeg's fill_colmap takes list 0's first entry)
B_FEATURES = (
    "b_direct_16x16", "b_l0_16x16", "b_l1_16x16", "b_bi_16x16",
    "b_l0_l0_16x8", "b_l0_l0_8x16", "b_l1_l1_16x8", "b_l1_l1_8x16",
    "b_l0_l1_16x8", "b_l0_l1_8x16", "b_l1_l0_16x8", "b_l1_l0_8x16",
    "b_l0_bi_16x8", "b_l0_bi_8x16", "b_l1_bi_16x8", "b_l1_bi_8x16",
    "b_bi_l0_16x8", "b_bi_l0_8x16", "b_bi_l1_16x8", "b_bi_l1_8x16",
    "b_bi_bi_16x8", "b_bi_bi_8x16", "b_8x8",
    "b_direct_8x8", "b_l0_8x8", "b_l1_8x8", "b_bi_8x8", "b_l0_8x4",
    "b_l0_4x8", "b_l1_8x4", "b_l1_4x8", "b_bi_8x4", "b_bi_4x8", "b_l0_4x4",
    "b_l1_4x4", "b_bi_4x4",
    "b_skip", "direct_spatial", "direct_temporal", "direct_8x8_inference",
    "direct_4x4", "col_zero", "col_intra", "col_l1", "implicit_weights",
    "implicit_fallback", "explicit_bipred", "list1_mod", "list1_swap",
    "b_reference", "long_term_l1", "b_intra", "col_unmapped")

# the intra modes reached (h264.cpp's second word): each 4x4, 8x8, 16x16
# and chroma mode, and each again where the block lacked its top or left
# neighbours (a picture or slice edge)
_BASE = ([f"i4x4_{m}" for m in range(9)] + [f"i8x8_{m}" for m in range(9)]
         + [f"i16x16_{m}" for m in range(4)]
         + [f"chroma_{m}" for m in range(4)])
MODES = tuple(_BASE + [f"{n}_edge" for n in _BASE])


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the H.264 decoder")
        sig = {
            "h264_dec_new": (_P, []),
            "h264_dec_free": (None, [_P]),
            "h264_dec_extradata": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                                  ctypes.c_char_p, _I64]),
            "h264_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64,
                                               ctypes.c_int, _I64P,
                                               ctypes.c_char_p, _I64]),
            "h264_dec_output": (None, [_P, _I64, _P, _P, _P]),
            "h264_dec_features": (ctypes.c_uint64, [_P]),
            "h264_dec_modes": (ctypes.c_uint64, [_P]),
            "h264_dec_features_b": (ctypes.c_uint64, [_P]),
            "h264_dec_delay": (ctypes.c_int, [_P, ctypes.c_int]),
            "h264_probe": (ctypes.c_int, [ctypes.c_char_p, _I64, _I64P,
                                          ctypes.c_char_p, _I64]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def _raise(rc: int, msg, what: str):
    text = msg.value.decode("utf-8", "replace")
    if rc == _UNSUPPORTED:
        raise Unsupported(f"{what}: H.264 with {text}, not read by the port "
                          f"({ITEM_8})")
    raise ValueError(f"{what}: corrupt H.264 video: {text}")


# the chroma site FFmpeg reports for a VUI's chroma_sample_loc_type (left
# where the VUI names none), as swscale's (x, y) position in 1/256 samples
_SITES = {-1: (0, 128), 0: (0, 128), 1: (128, 128), 2: (0, 0), 3: (128, 0),
          4: (0, 256), 5: (128, 256)}


def chroma_site(loc: int) -> Tuple[int, int]:
    """swscale's chroma position for chroma_sample_loc_type ``loc`` (-1:
    none sent)."""
    return _SITES.get(loc, _SITES[-1])


class StreamInfo:
    """An SPS's picture size (its crop applied: the size cv2 reports and
    scales every frame to), range, swscale matrix, chroma site (an (x, y)
    position, ``chroma_site``), frame rate from its VUI timing (None without
    one), reorder frames (None without a bitstream restriction) and
    profile."""

    def __init__(self, info):
        self.width, self.height = int(info[0]), int(info[1])
        self.full_range = bool(info[2])
        self.matrix = matrix(int(info[3]))
        self.chroma = chroma_site(int(info[4]))
        tick, scale = int(info[5]), int(info[6])
        self.fps = Fraction(scale, 2 * tick) if tick and scale else None
        self.reorder = None if info[7] < 0 else int(info[7])
        self.profile = int(info[8])
        # h264_ps.c's num_reorder_frames without a bitstream restriction:
        # the level's DPB size in pictures (of references), at most 15
        self.dpb_reorder = self.reorder
        if self.reorder is None and info[11]:
            mbs = _LEVEL_DPB_MBS.get(int(info[9]))
            self.dpb_reorder = 15 if mbs is None else min(mbs // int(info[10]),
                                                          15)


# h264_ps.c's level_max_dpb_mbs: MaxDpbMbs by level_idc
_LEVEL_DPB_MBS = {10: 396, 11: 900, 12: 2376, 13: 2376, 20: 2376, 21: 4752,
                  22: 8100, 30: 8100, 31: 18000, 32: 20480, 40: 32768,
                  41: 32768, 42: 34816, 50: 110400, 51: 184320, 52: 184320}


def probe(data: bytes, what: str = "video") -> Optional[StreamInfo]:
    """The first SPS in ``data`` (Annex B, or an ``avcC`` record), or None
    where there is none."""
    info = (_I64 * 12)()
    msg = ctypes.create_string_buffer(_MSG)
    data = bytes(data)
    rc = load().h264_probe(data, len(data), info, msg, _MSG)
    if rc == _NO_FRAME:
        return None
    if rc != _OK:
        _raise(rc, msg, what)
    return StreamInfo(info)


def probe_delay(packets: Iterable[bytes], extradata: bytes = b"",
                start: int = 0, what: str = "video") -> int:
    """The reorder depth ``cv2.VideoCapture``'s decoder starts from: the
    ``video_delay`` FFmpeg's probe (``avformat_find_stream_info``) leaves in
    the stream's parameters.  The probe decodes from the demuxer's estimate
    ``start`` until its decoder has handed over 7 pictures (18 from a depth
    of 3, 20 from 4; ``has_decode_delay_been_guessed``), or its depth is the
    SPS's reorder frames (``dpb_reorder``), or the packets run out, and
    keeps the depth its decoder reached."""
    dec = Decoder(what, extradata, start)
    info = probe(extradata) if extradata else None
    handed = 0
    for p in packets:
        d = dec.delay
        if info is None:
            info = probe(p)
        if d and info is not None and info.dpb_reorder == d:
            break
        if handed >= (7 if d < 3 else 18 if d < 4 else 20):
            break
        handed += len(dec.decode(p))
    return dec.delay


def nal_units(data: bytes, length_size: int = 0) -> List[bytes]:
    """The NAL units of a packet: Annex B (``length_size`` 0) or each
    behind its big-endian length."""
    out = []
    if not length_size:
        i = data.find(b"\0\0\1")
        while i >= 0:
            j = data.find(b"\0\0\1", i + 3)
            end = len(data) if j < 0 else j
            out.append(data[i + 3:end].rstrip(b"\0"))
            i = j
        return [n for n in out if n]
    p = 0
    while p + length_size <= len(data):
        n = int.from_bytes(data[p:p + length_size], "big")
        out.append(data[p + length_size:p + length_size + n])
        p += length_size + n
    return [n for n in out if n]


def _slice_type(unit: bytes) -> Optional[int]:
    """slice_type % 5 of a slice NAL unit (its second exp-Golomb value; the
    first bytes' emulation prevention ignored), None where it ends first."""
    bits = int.from_bytes(unit[1:9].ljust(8, b"\0"), "big")
    pos, vals = 0, []
    for _ in range(2):
        lz = 0
        while lz < 31 and not bits >> (63 - pos - lz) & 1:
            lz += 1
        pos += lz + 1
        if pos + lz > 64:
            return None
        vals.append((1 << lz) - 1 + ((bits >> (64 - pos - lz)) & ((1 << lz) - 1)
                                     if lz else 0))
        pos += lz
    return vals[1] % 5


def is_keyframe(data: bytes, length_size: int = 0) -> bool:
    """Whether a packet holds an IDR slice or an I slice: a picture
    FFmpeg's decoder, flushed, starts handing over from."""
    return any(n[0] & 31 == 5 or (n[0] & 31 == 1 and _slice_type(n) == 2)
               for n in nal_units(data, length_size))


class Decoder:
    """One stream's decoder; ``what`` names the source in errors,
    ``extradata`` is the container's ``avcC`` record or Annex B parameter
    sets, ``delay`` the reorder depth it starts from (cv2's decoder starts
    from the one FFmpeg's probe found: :func:`probe_delay`).  After a call, ``width`` and ``height`` are the planes' (FFmpeg's
    frame: a left crop that would unalign them is not applied),
    ``full_range``, ``matrix`` (swscale's) and ``chroma`` (its chroma site)
    the stream's, and ``serials`` gives,
    for each picture handed over, the packet it came in (0 for the
    decoder's first)."""

    def __init__(self, what: str = "video", extradata: bytes = b"",
                 delay: int = 0):
        self._lib = load()
        self._h = self._lib.h264_dec_new()
        self._lib.h264_dec_delay(self._h, int(delay))
        self.what = what
        self.width = self.height = 0
        self.full_range = False
        self.matrix = "bt601"
        self.chroma = chroma_site(-1)
        self.serials: List[int] = []
        if extradata:
            msg = ctypes.create_string_buffer(_MSG)
            data = bytes(extradata)
            rc = self._lib.h264_dec_extradata(self._h, data, len(data), msg,
                                              _MSG)
            if rc != _OK:
                _raise(rc, msg, what)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.h264_dec_free(h)

    def _call(self, data: bytes, end: bool) -> List[Planes]:
        info = (_I64 * 40)()
        msg = ctypes.create_string_buffer(_MSG)
        rc = self._lib.h264_dec_decode(self._h, data, len(data), int(end),
                                       info, msg, _MSG)
        if rc not in (_OK, _NO_FRAME):
            _raise(rc, msg, self.what)
        if rc == _NO_FRAME:
            self.serials = []
            return []
        self.width, self.height = int(info[1]), int(info[2])
        self.full_range = bool(info[3])
        self.matrix = matrix(int(info[4]))
        self.chroma = chroma_site(int(info[5]))
        w, h = self.width, self.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        out = []
        for i in range(int(info[0])):
            y = np.empty((h, w), np.uint8)
            u = np.empty((ch, cw), np.uint8)
            v = np.empty((ch, cw), np.uint8)
            self._lib.h264_dec_output(self._h, i, y.ctypes.data,
                                      u.ctypes.data, v.ctypes.data)
            out.append((y, u, v))
        self.serials = [int(info[6 + i]) for i in range(len(out))]
        return out

    def decode(self, packet: bytes) -> List[Planes]:
        """One packet → the planes of the pictures it hands over (none or
        one)."""
        return self._call(bytes(packet), False)

    def flush(self) -> List[Planes]:
        """The end of the stream → the pictures still held for reordering,
        in FFmpeg's order."""
        return self._call(b"", True)

    @property
    def features(self) -> List[str]:
        """The syntax and tools of the pictures decoded so far, by name
        (``FEATURES``, then ``MODES``)."""
        bits = int(self._lib.h264_dec_features(self._h))
        modes = int(self._lib.h264_dec_modes(self._h))
        b = int(self._lib.h264_dec_features_b(self._h))
        return ([n for i, n in enumerate(FEATURES) if bits >> i & 1]
                + [n for i, n in enumerate(B_FEATURES) if b >> i & 1]
                + [n for i, n in enumerate(MODES) if modes >> i & 1])

    @property
    def delay(self) -> int:
        """The reorder depth (FFmpeg's ``has_b_frames``) the decoder holds
        pictures back by now: the starting ``delay``, raised as POCs, a B
        slice or the VUI show more."""
        return int(self._lib.h264_dec_delay(self._h, -1))
