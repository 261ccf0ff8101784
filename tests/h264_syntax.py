"""A seeded H.264 syntax writer for the test fixtures.

It is not an encoder: it reconstructs nothing and optimises nothing.  It
chooses macroblock types, intra modes, partitions, motion vector
differences, references and coefficient levels at random from a seed,
within what the stream's parameters allow, and writes the syntax for them
in CAVLC or CABAC.  It tracks only what the syntax itself depends on: which
neighbours are available (so that every intra mode it writes has the
samples it predicts from), the neighbours' coefficient counts (CAVLC's nC)
and the context of every CABAC bin, which it derives as the standard does.
cv2's own decoder judges the result: a context chosen wrongly here or in
``runtime/h264.cpp`` shows as a mismatch with it.

Entry points: :class:`Sps`, :class:`Pps` and :class:`Pic` describe a
stream; :func:`write_stream` turns them into access units (Annex B);
:func:`avcc` and :func:`length_prefixed` give the ``avcC`` record and the
packets MP4 and Matroska hold.  The CAVLC and CABAC tables come from
``runtime/h264_tables.h``.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_HDR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "opticalflow_tpu_torch", "runtime", "h264_tables.h")


def _tables() -> Dict[str, np.ndarray]:
    text = open(_HDR).read()
    out = {}
    for m in re.finditer(r"const (\w+) (k\w+)((?:\[\d+\])+) = \{(.*?)\};",
                         text, re.S):
        shape = tuple(int(d) for d in re.findall(r"\[(\d+)\]", m.group(3)))
        vals = [int(v) for v in re.findall(r"-?\d+", m.group(4))]
        out[m.group(2)] = np.array(vals, np.int32).reshape(shape)
    return out


T = _tables()
BLK_X = [0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3]
BLK_Y = [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3]
INTRA_CBP = {int(v): i for i, v in enumerate(T["kGolombToIntraCbp"])}
INTER_CBP = {int(v): i for i, v in enumerate(T["kGolombToInterCbp"])}
# what each intra NxN mode predicts from: 1 top, 2 left, 4 top-left
NEED = [1, 2, 0, 1, 7, 7, 7, 1, 2]
NEED16 = [1, 2, 0, 7]          # V, H, DC, plane
NEED_CHROMA = [0, 2, 1, 7]     # DC, H, V, plane


# ------------------------------------------------------------------ bits

class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def u(self, n: int, v: int):
        if not n:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 255)
        self.acc &= (1 << self.n) - 1

    def ue(self, v: int):
        v += 1
        n = v.bit_length()
        self.u(n - 1, 0)
        self.u(n, v)

    def se(self, v: int):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, cmax: int, v: int):
        if cmax == 1:
            self.u(1, 1 - v)
        else:
            self.ue(v)

    @property
    def aligned(self) -> bool:
        return self.n == 0

    def align(self, bit: int = 0):
        while self.n:
            self.u(1, bit)

    def trailing(self):
        self.u(1, 1)
        self.align(0)

    def raw(self, data: bytes):
        assert self.aligned
        self.out += data

    def bytes(self) -> bytes:
        assert self.aligned
        return bytes(self.out)


def escape(rbsp: bytes) -> bytes:
    """Emulation prevention: a 3 after every two zeros that a byte of 3 or
    less follows."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal(ref_idc: int, kind: int, rbsp: bytes) -> bytes:
    return bytes([ref_idc << 5 | kind]) + escape(rbsp)


class Cabac:
    """CABAC's encoder (9.3.4) over a BitWriter."""

    def __init__(self, bw: BitWriter, slice_qp: int, table: int):
        self.bw = bw
        self.state = [0] * 1024
        self.mps = [0] * 1024
        init = T["kCabacInit"][table]
        q = min(max(slice_qp, 0), 51)
        for i in range(1024):
            m, n = int(init[i][0]), int(init[i][1])
            pre = min(max(((m * q) >> 4) + n, 1), 126)
            if pre <= 63:
                self.state[i], self.mps[i] = 63 - pre, 0
            else:
                self.state[i], self.mps[i] = pre - 64, 1
        self.start()

    def start(self):
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def _put(self, b: int):
        if self.first:
            self.first = False
        else:
            self.bw.u(1, b)
        while self.outstanding:
            self.bw.u(1, 1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def bin(self, ctx: int, b: int):
        s = self.state[ctx]
        lps = int(T["kRangeTabLPS"][s][(self.range >> 6) & 3])
        self.range -= lps
        if b != self.mps[ctx]:
            self.low += self.range
            self.range = lps
            if s == 0:
                self.mps[ctx] = 1 - self.mps[ctx]
            self.state[ctx] = int(T["kTransIdxLPS"][s])
        else:
            self.state[ctx] = min(s + 1, 62)
        self._renorm()

    def bypass(self, b: int):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, b: int):
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.bw.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self._renorm()

    def eg(self, v: int, k: int):
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        for i in range(k - 1, -1, -1):
            self.bypass((v >> i) & 1)


# ------------------------------------------------------------------ stream description

@dataclass
class Sps:
    id: int = 0
    profile: int = 100
    level: int = 30
    mb_w: int = 6
    mb_h: int = 4
    chroma_format: int = 1
    bit_depth: int = 8
    bypass: bool = False
    # scaling: None (none sent), or a list of 8 entries: None (not sent:
    # fall-back rule A), "default" (the default, by a first delta that
    # makes nextScale 0), or the list's values in scan order
    scaling: Optional[list] = None
    log2_max_frame_num: int = 4
    poc_type: int = 0
    log2_max_poc_lsb: int = 6
    offset_for_non_ref_pic: int = 0
    offset_for_ref_frame: Tuple[int, ...] = (2,)
    max_num_ref_frames: int = 1
    gaps: bool = False
    frame_mbs_only: bool = True
    direct_8x8_inference: bool = True
    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)   # left right top bottom
    vui: Optional[dict] = None


@dataclass
class Pps:
    id: int = 0
    sps_id: int = 0
    cabac: bool = False
    num_ref_idx_default: int = 1
    num_ref_idx_default1: int = 1
    weighted_pred: bool = False
    weighted_bipred_idc: int = 0
    init_qp: int = 26
    chroma_qp_offset: int = 0
    second_chroma_qp_offset: Optional[int] = None
    deblocking_control: bool = True
    constrained_intra: bool = False
    redundant_pic_cnt_present: bool = False
    transform_8x8: bool = False
    scaling: Optional[list] = None   # as Sps.scaling, 6 or 8 entries
    slice_groups: int = 1


@dataclass
class SliceSpec:
    first_mb: int
    count: int
    qp_delta: int = 0
    deblock: int = 0            # disable_deblocking_filter_idc
    alpha: int = 0              # slice_alpha_c0_offset_div2
    beta: int = 0
    cabac_init_idc: int = 0


@dataclass
class Pic:
    kind: str = "I"             # I, P or B
    idr: bool = False
    ref_idc: int = 1
    sps: int = 0
    pps: int = 0
    slices: Optional[List[SliceSpec]] = None   # None: one slice
    num_ref_idx: Optional[object] = None       # override ("all": all held)
    num_ref_idx1: Optional[object] = None      # list 1's (B)
    list_mods: Sequence[Tuple[int, int]] = ()  # (idc, value), raw syntax
    list_mods1: Sequence[Tuple[int, int]] = ()
    direct_spatial: bool = True                # B: direct_spatial_mv_pred_flag
    poc: Optional[int] = None                  # else counted (poc_step)
    mmco: Sequence[Tuple[int, ...]] = ()       # (op, args...)
    long_term_reference: bool = False          # IDR
    # pred_weight_table: luma_log2, chroma_log2, and list 0's (luma,
    # chroma) and list 1's (luma1, chroma1) weights by reference index
    weights: Optional[dict] = None
    recovery_point: Optional[int] = None       # SEI recovery_frame_cnt
    redundant_pic_cnt: int = 0
    frame_num: Optional[int] = None            # else counted
    poc_step: int = 2
    delta_poc: int = 0                          # POC type 1
    # what its macroblocks may be: any of I4 I8 I16 PCM P B SKIP; and how
    mb_types: Sequence[str] = ("I4", "I16", "PCM")
    p_parts: Sequence[int] = (0, 1, 2, 3, 4)
    b_types: Sequence[int] = tuple(range(23))   # B mb_type (Table 7-14)
    b_subs: Sequence[int] = tuple(range(13))    # B sub_mb_type (7-18)
    skips: float = 0.2          # the share of skipped macroblocks
    density: float = 0.25       # the share of nonzero coefficients
    big_levels: float = 0.02    # the share of escape-sized levels
    qp_deltas: float = 0.2      # the share of macroblocks with a delta
    mv_range: int = 24          # |mvd| in quarter samples
    far_mv: float = 0.0         # the share of vectors far outside
    pcm: Optional[np.ndarray] = None   # 16*mb_h x 16*mb_w Y then U, V: I_PCM samples
    global_mv: Optional[Tuple[int, int]] = None   # every MB P_L0_16x16
    cbps: Optional[Sequence[int]] = None   # the coded_block_patterns to pick
    t8: Optional[bool] = None   # inter transform_size_8x8_flag (None: at random)
    prefix: bytes = b""         # NAL units sent before the picture's


# ------------------------------------------------------------------ writer

class _Mb:
    __slots__ = ("slice", "kind", "t8", "cbp", "cbf_dc", "chroma", "ipred",
                 "nnz", "nnzc", "ref", "mvd", "intra", "direct8", "direct16")

    def __init__(self, slice_):
        self.slice = slice_
        self.kind = "SKIP"
        self.t8 = False
        self.cbp = 0
        self.cbf_dc = 0
        self.chroma = 0
        self.ipred = [-1] * 16
        self.nnz = [0] * 16
        self.nnzc = [[0] * 4, [0] * 4]
        self.ref = [[-1] * 4, [-1] * 4]     # per list
        self.mvd = [[[0, 0] for _ in range(16)] for _ in range(2)]
        self.intra = False
        self.direct8 = 0        # 8x8 blocks skipped or predicted directly
        self.direct16 = False   # B_Skip, B_Direct_16x16


def _scaling(bw: BitWriter, lists, sizes):
    for lst, size in zip(lists, sizes):
        if lst is None:
            bw.u(1, 0)
            continue
        bw.u(1, 1)
        if lst == "default":
            bw.se(-8)      # nextScale 0 at j 0
            continue
        last = 8
        for v in lst:
            v = int(v)
            bw.se(((v - last + 128) & 255) - 128)
            last = v
        assert len(lst) == size


def sps_nal(s: Sps) -> bytes:
    bw = BitWriter()
    bw.u(8, s.profile)
    bw.u(8, 0)
    bw.u(8, s.level)
    bw.ue(s.id)
    if s.profile in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139,
                     134, 135):
        bw.ue(s.chroma_format)
        if s.chroma_format == 3:
            bw.u(1, 0)
        bw.ue(s.bit_depth - 8)
        bw.ue(s.bit_depth - 8)
        bw.u(1, int(s.bypass))
        bw.u(1, int(s.scaling is not None))
        if s.scaling is not None:
            _scaling(bw, s.scaling, [16] * 6 + [64] * 2)
    bw.ue(s.log2_max_frame_num - 4)
    bw.ue(s.poc_type)
    if s.poc_type == 0:
        bw.ue(s.log2_max_poc_lsb - 4)
    elif s.poc_type == 1:
        bw.u(1, 0)
        bw.se(s.offset_for_non_ref_pic)
        bw.se(0)
        bw.ue(len(s.offset_for_ref_frame))
        for o in s.offset_for_ref_frame:
            bw.se(o)
    bw.ue(s.max_num_ref_frames)
    bw.u(1, int(s.gaps))
    bw.ue(s.mb_w - 1)
    bw.ue((s.mb_h if s.frame_mbs_only else s.mb_h // 2) - 1)
    bw.u(1, int(s.frame_mbs_only))
    if not s.frame_mbs_only:
        bw.u(1, 0)
    bw.u(1, int(s.direct_8x8_inference))
    cy = 2 if s.frame_mbs_only else 4
    if any(s.crop):
        bw.u(1, 1)
        bw.ue(s.crop[0] // 2)
        bw.ue(s.crop[1] // 2)
        bw.ue(s.crop[2] // cy)
        bw.ue(s.crop[3] // cy)
    else:
        bw.u(1, 0)
    v = s.vui
    bw.u(1, int(v is not None))
    if v is not None:
        bw.u(1, 0)   # aspect ratio
        bw.u(1, 0)   # overscan
        signal = "full_range" in v or "matrix" in v
        bw.u(1, int(signal))
        if signal:
            bw.u(3, 5)
            bw.u(1, int(v.get("full_range", False)))
            bw.u(1, int("matrix" in v))
            if "matrix" in v:
                bw.u(8, v["matrix"])
                bw.u(8, v["matrix"])
                bw.u(8, v["matrix"])
        bw.u(1, int("chroma_loc" in v))
        if "chroma_loc" in v:
            bw.ue(v["chroma_loc"])
            bw.ue(v["chroma_loc"])
        bw.u(1, int("fps" in v))
        if "fps" in v:
            num, den = v["fps"]
            bw.u(32, den)
            bw.u(32, 2 * num)
            bw.u(1, 1)
        bw.u(1, 0)
        bw.u(1, 0)
        bw.u(1, 0)
        bw.u(1, int("reorder" in v))
        if "reorder" in v:
            bw.u(1, 1)
            bw.ue(2)
            bw.ue(1)
            bw.ue(16)
            bw.ue(16)
            bw.ue(v["reorder"])
            bw.ue(max(v["reorder"], s.max_num_ref_frames))
    bw.trailing()
    return nal(3, 7, bw.bytes())


def pps_nal(p: Pps, s: Sps) -> bytes:
    bw = BitWriter()
    bw.ue(p.id)
    bw.ue(p.sps_id)
    bw.u(1, int(p.cabac))
    bw.u(1, 0)
    bw.ue(p.slice_groups - 1)
    if p.slice_groups > 1:   # type 6: columns alternate between groups
        bw.ue(6)
        n = s.mb_w * s.mb_h
        bw.ue(n - 1)
        bits = (p.slice_groups - 1).bit_length()
        for i in range(n):
            bw.u(bits, (i % s.mb_w) % p.slice_groups)
    bw.ue(p.num_ref_idx_default - 1)
    bw.ue(p.num_ref_idx_default1 - 1)
    bw.u(1, int(p.weighted_pred))
    bw.u(2, p.weighted_bipred_idc)
    bw.se(p.init_qp - 26)
    bw.se(0)
    bw.se(p.chroma_qp_offset)
    bw.u(1, int(p.deblocking_control))
    bw.u(1, int(p.constrained_intra))
    bw.u(1, int(p.redundant_pic_cnt_present))
    if (p.transform_8x8 or p.scaling is not None
            or p.second_chroma_qp_offset is not None):
        bw.u(1, int(p.transform_8x8))
        bw.u(1, int(p.scaling is not None))
        if p.scaling is not None:
            n = 8 if p.transform_8x8 else 6
            _scaling(bw, p.scaling[:n], ([16] * 6 + [64] * 2)[:n])
        bw.se(p.chroma_qp_offset if p.second_chroma_qp_offset is None
              else p.second_chroma_qp_offset)
    bw.trailing()
    return nal(3, 8, bw.bytes())


def sei_recovery(cnt: int) -> bytes:
    """An SEI NAL unit holding a recovery point of ``cnt`` frames."""
    body = BitWriter()
    body.ue(cnt)
    body.u(1, 1)   # exact_match_flag
    body.u(1, 0)   # broken_link_flag
    body.u(2, 0)   # changing_slice_group_idc
    if not body.aligned:
        body.u(1, 1)
        body.align(0)
    payload = body.bytes()
    bw = BitWriter()
    bw.u(8, 6)
    bw.u(8, len(payload))
    bw.raw(payload)
    bw.trailing()
    return nal(0, 6, bw.bytes())


class Writer:
    """Writes a stream's pictures; ``rng`` chooses what each picture's
    description leaves open."""

    def __init__(self, seed: int, sps: Sequence[Sps], pps: Sequence[Pps]):
        self.rng = np.random.default_rng(seed)
        self.sps = {s.id: s for s in sps}
        self.pps = {p.id: p for p in pps}
        self.frame_num = 0
        self.poc = 0
        self.refs: List[dict] = []   # {"fn": frame_num, "long": idx or None}
        self.max_long = -1
        # the largest weight of any scaling list the stream may use
        vals = [16]
        for x in list(sps) + list(pps):
            for lst in x.scaling or ():
                vals += [42] if lst in (None, "default") else [int(v) for v in lst]
        self.wmax = max(vals)

    # ---------------------------------------------------------- references

    def _mark(self, pic: Pic, sps: Sps):
        if pic.idr:
            self.refs = []
            if pic.long_term_reference:
                self.max_long = 0
                self.refs.append({"fn": 0, "long": 0})
            else:
                self.max_long = -1
                self.refs.append({"fn": 0, "long": None})
            return
        max_fn = 1 << sps.log2_max_frame_num
        cur = self.cur_fn

        def num(r):
            return r["fn"] - max_fn if r["fn"] > cur else r["fn"]
        long_marked = False
        if pic.mmco:
            for op in pic.mmco:
                if op[0] in (1, 3):
                    target = cur - (op[1] + 1)
                    r = next(r for r in self.refs
                             if r["long"] is None and num(r) == target)
                    if op[0] == 1:
                        self.refs.remove(r)
                    else:
                        self.refs = [x for x in self.refs
                                     if x["long"] != op[2]]
                        r["long"] = op[2]
                elif op[0] == 2:
                    self.refs = [x for x in self.refs if x["long"] != op[1]]
                elif op[0] == 4:
                    self.max_long = op[1] - 1
                    self.refs = [x for x in self.refs if x["long"] is None
                                 or x["long"] <= self.max_long]
                elif op[0] == 5:
                    self.refs = []
                    self.max_long = -1
                    self.mmco5 = True
                elif op[0] == 6:
                    self.refs = [x for x in self.refs if x["long"] != op[1]]
                    long_marked = True
                    self.refs.append({"fn": cur, "long": op[1]})
        else:
            shorts = [r for r in self.refs if r["long"] is None]
            if shorts and len(self.refs) >= max(sps.max_num_ref_frames, 1):
                self.refs.remove(min(shorts, key=num))
        if not long_marked:
            self.refs.append({"fn": 0 if getattr(self, "mmco5", False)
                              else cur, "long": None})

    # ---------------------------------------------------------- stream

    def picture(self, pic: Pic) -> bytes:
        sps = self.sps[self.pps[pic.pps].sps_id]
        pps = self.pps[pic.pps]
        max_fn = 1 << sps.log2_max_frame_num
        self.mmco5 = False
        if pic.idr:
            self.frame_num = 0
            self.poc = 0
        fn = pic.frame_num if pic.frame_num is not None else self.frame_num
        self.cur_fn = fn
        if pic.poc is not None:
            self.poc = pic.poc
        out = bytearray(pic.prefix)
        if pic.recovery_point is not None:
            out += b"\0\0\0\1" + sei_recovery(pic.recovery_point)
        n_mb = sps.mb_w * sps.mb_h
        slices = pic.slices or [SliceSpec(0, n_mb)]
        self.mbs = [None] * n_mb
        self.sps_cur, self.pps_cur, self.pic = sps, pps, pic
        for k, sl in enumerate(slices):
            out += b"\0\0\0\1" + self._slice(pic, sps, pps, sl, k, fn)
        if pic.ref_idc:
            self._mark(pic, sps)
            self.frame_num = (fn + 1) % max_fn
            if self.mmco5:
                self.frame_num = 1
        self.poc += pic.poc_step
        return bytes(out)

    def _slice(self, pic, sps, pps, sl, k, fn) -> bytes:
        bw = BitWriter()
        kind = {"P": 0, "B": 1, "I": 2}[pic.kind]
        bw.ue(sl.first_mb)
        bw.ue(kind + 5 if k == 0 else kind)
        bw.ue(pps.id)
        bw.u(sps.log2_max_frame_num, fn)
        if not sps.frame_mbs_only:
            bw.u(1, 0)   # field_pic_flag
        if pic.idr:
            bw.ue(0)
        if sps.poc_type == 0:
            bw.u(sps.log2_max_poc_lsb, self.poc % (1 << sps.log2_max_poc_lsb))
        elif sps.poc_type == 1:
            bw.se(pic.delta_poc)
        if pps.redundant_pic_cnt_present:
            bw.ue(pic.redundant_pic_cnt)
        if pic.kind == "B":
            bw.u(1, int(pic.direct_spatial))
        nref = nref1 = 0
        if pic.kind in "PB":
            held = len(self.refs)   # "all": every reference held
            nref = (held if pic.num_ref_idx == "all" else
                    pic.num_ref_idx or pps.num_ref_idx_default)
            nref1 = 0
            if pic.kind == "B":
                nref1 = (held if pic.num_ref_idx1 == "all" else
                         pic.num_ref_idx1 or pps.num_ref_idx_default1)
            if nref != pps.num_ref_idx_default or (
                    pic.kind == "B" and nref1 != pps.num_ref_idx_default1):
                bw.u(1, 1)
                bw.ue(nref - 1)
                if pic.kind == "B":
                    bw.ue(nref1 - 1)
            else:
                bw.u(1, 0)
            for mods in ((pic.list_mods, pic.list_mods1) if pic.kind == "B"
                         else (pic.list_mods,)):
                bw.u(1, int(bool(mods)))
                for idc, v in mods:
                    bw.ue(idc)
                    bw.ue(v)
                if mods:
                    bw.ue(3)
            if (pps.weighted_pred and pic.kind == "P") or (
                    pps.weighted_bipred_idc == 1 and pic.kind == "B"):
                w = pic.weights or {}
                bw.ue(w.get("luma_log2", 5))
                bw.ue(w.get("chroma_log2", 5))
                for k, n in enumerate((nref, nref1)):
                    for i in range(n):
                        lw = w.get("luma1" if k else "luma", {}).get(i)
                        bw.u(1, int(lw is not None))
                        if lw is not None:
                            bw.se(lw[0])
                            bw.se(lw[1])
                        cw = w.get("chroma1" if k else "chroma", {}).get(i)
                        bw.u(1, int(cw is not None))
                        if cw is not None:
                            for wt, off in cw:
                                bw.se(wt)
                                bw.se(off)
        self.nref = nref
        self.nrefs = (nref, nref1)
        if pic.ref_idc:
            if pic.idr:
                bw.u(1, 0)
                bw.u(1, int(pic.long_term_reference))
            else:
                bw.u(1, int(bool(pic.mmco)))
                for op in pic.mmco:
                    bw.ue(op[0])
                    for a in op[1:]:
                        bw.ue(a)
                if pic.mmco:
                    bw.ue(0)
        if pps.cabac and pic.kind != "I":
            bw.ue(sl.cabac_init_idc)
        bw.se(sl.qp_delta)
        if pps.deblocking_control:
            bw.ue(sl.deblock)
            if sl.deblock != 1:
                bw.se(sl.alpha)
                bw.se(sl.beta)
        self.qp = pps.init_qp + sl.qp_delta
        self.slice_idx = k
        self.last_qpd = 0
        if pps.cabac:
            while not bw.aligned:
                bw.u(1, 1)
            self.cab = Cabac(bw, self.qp, 0 if pic.kind == "I"
                             else sl.cabac_init_idc + 1)
        self.bw = bw
        run = 0
        end = sl.first_mb + sl.count
        for addr in range(sl.first_mb, end):
            self.addr = addr
            self.mx, self.my = addr % sps.mb_w, addr // sps.mb_w
            mb = _Mb(k)
            self.mbs[addr] = mb
            self.cur = mb
            skip = pic.kind in "PB" and "SKIP" in pic.mb_types and \
                self.rng.random() < pic.skips and pic.global_mv is None
            if pps.cabac:
                if pic.kind in "PB":
                    self._skip_flag(skip)
                if skip:
                    self._skip_mb()
                else:
                    self._mb()
                self.cab.terminate(1 if addr == end - 1 else 0)
            else:
                if skip:
                    run += 1
                    self._skip_mb()
                    continue
                if pic.kind in "PB":
                    bw.ue(run)
                    run = 0
                self._mb()
        if pps.cabac:
            bw.align(0)
        else:
            if run:
                bw.ue(run)
            bw.trailing()
        return nal(pic.ref_idc, 5 if pic.idr else 1, bw.bytes())

    # ---------------------------------------------------------- neighbours

    def avail(self, addr) -> bool:
        return addr is not None and addr >= 0 and \
            self.mbs[addr] is not None and \
            self.mbs[addr].slice == self.slice_idx

    def addr_a(self):
        return self.addr - 1 if self.mx > 0 else None

    def addr_b(self):
        return self.addr - self.sps_cur.mb_w if self.my > 0 else None

    def addr_c(self):
        return (self.addr - self.sps_cur.mb_w + 1
                if self.my > 0 and self.mx < self.sps_cur.mb_w - 1 else None)

    def addr_d(self):
        return (self.addr - self.sps_cur.mb_w - 1
                if self.my > 0 and self.mx > 0 else None)

    def intra_avail(self, addr) -> bool:
        return self.avail(addr) and not (self.pps_cur.constrained_intra
                                         and not self.mbs[addr].intra)

    def locate(self, x, y):
        """(macroblock, raster 4x4 block) holding luma (x, y) relative to
        the current one; None where unavailable."""
        if y < 0:
            a = self.addr_d() if x < 0 else self.addr_b() if x < 16 \
                else self.addr_c()
        elif x < 0:
            a = self.addr_a()
        elif x < 16:
            return self.cur, (y >> 2) * 4 + (x >> 2)
        else:
            return None
        if not self.avail(a):
            return None
        return self.mbs[a], (((y + 16) & 15) >> 2) * 4 + (((x + 16) & 15) >> 2)

    # ---------------------------------------------------------- syntax pieces

    def _skip_flag(self, skip):
        ctx = 24 if self.pic.kind == "B" else 11
        for a in (self.addr_a(), self.addr_b()):
            if self.avail(a) and self.mbs[a].kind != "SKIP":
                ctx += 1
        self.cab.bin(ctx, int(skip))

    def _skip_mb(self):
        self.cur.kind = "SKIP"
        self.cur.ref[0] = [0] * 4
        self.cur.direct8 = 15
        self.cur.direct16 = self.pic.kind == "B"
        self.last_qpd = 0

    def _pred_mode(self, x, y):
        la, lb = self.locate(x - 1, y), self.locate(x, y - 1)
        if la is None or lb is None:
            return 2
        ma, mb = la[0].ipred[la[1]], lb[0].ipred[lb[1]]
        if ma < 0 or mb < 0:
            if self.pps_cur.constrained_intra:
                return 2
            ma, mb = (2 if ma < 0 else ma), (2 if mb < 0 else mb)
        return min(ma, mb)

    def _write_mode(self, mode, pred):
        if self.pps_cur.cabac:
            if mode == pred:
                self.cab.bin(68, 1)
                return
            self.cab.bin(68, 0)
            rem = mode if mode < pred else mode - 1
            for i in range(3):
                self.cab.bin(69, rem >> i & 1)
        else:
            if mode == pred:
                self.bw.u(1, 1)
            else:
                self.bw.u(1, 0)
                self.bw.u(3, mode if mode < pred else mode - 1)

    def _pick(self, need, have, choices):
        legal = [m for m in choices if need[m] & have == need[m]]
        return int(self.rng.choice(legal))

    def _mb_type_intra(self, kind, i16=0):
        """CAVLC/CABAC mb_type of an intra macroblock: kind I4/I8 (I_NxN),
        I16 (``i16`` the 1-24 type), PCM."""
        p = self.pic
        t = 0 if kind in ("I4", "I8") else 25 if kind == "PCM" else i16
        if not self.pps_cur.cabac:
            self.bw.ue(t + {"P": 5, "B": 23, "I": 0}[p.kind])
            return
        cab = self.cab
        if p.kind == "I":
            ctx = 0
            for a in (self.addr_a(), self.addr_b()):
                if self.avail(a) and self.mbs[a].kind in ("I16", "PCM"):
                    ctx += 1
            st, intra_slice = 3, 1
            cab.bin(st + ctx, int(t != 0))
            if not t:
                return
            st += 2
        else:
            if p.kind == "P":
                cab.bin(14, 1)
                st = 17
            else:   # B: mb_type's prefix 1101
                self._b_type_prefix(0b1101)
                st = 32
            intra_slice = 0
            cab.bin(st, int(t != 0))
            if not t:
                return
        cab.terminate(int(t == 25))
        if t == 25:
            return
        v = t - 1
        pred, chroma, luma = v % 4, (v // 4) % 3, v // 12
        cab.bin(st + 1, luma)
        cab.bin(st + 2, int(chroma != 0))
        if chroma:
            cab.bin(st + 2 + intra_slice, int(chroma == 2))
        cab.bin(st + 3 + intra_slice, pred >> 1)
        cab.bin(st + 3 + 2 * intra_slice, pred & 1)

    def _chroma_mode(self, mode):
        self.cur.chroma = mode
        if not self.pps_cur.cabac:
            self.bw.ue(mode)
            return
        ctx = 0
        for a in (self.addr_a(), self.addr_b()):
            if self.avail(a):
                m = self.mbs[a]
                if m.intra and m.kind != "PCM" and m.chroma:
                    ctx += 1
        self.cab.bin(64 + ctx, int(mode > 0))
        if mode > 0:
            self.cab.bin(67, int(mode > 1))
            if mode > 1:
                self.cab.bin(67, int(mode > 2))

    def _cbp(self, cbp, intra):
        if not self.pps_cur.cabac:
            self.bw.ue((INTRA_CBP if intra else INTER_CBP)[cbp])
            return

        def nb(a):
            if not self.avail(a):
                return 0x0F
            m = self.mbs[a]
            return 0x2F if m.kind == "PCM" else m.cbp
        ca, cb = nb(self.addr_a()), nb(self.addr_b())
        c = self.cab
        b = [cbp >> i & 1 for i in range(4)]
        c.bin(73 + (not ca & 2) + 2 * (not cb & 4), b[0])
        c.bin(73 + (not b[0]) + 2 * (not cb & 8), b[1])
        c.bin(73 + (not ca & 8) + 2 * (not b[0]), b[2])
        c.bin(73 + (not b[2]) + 2 * (not b[1]), b[3])

        def ch(a):
            if not self.avail(a):
                return 0
            m = self.mbs[a]
            return 2 if m.kind == "PCM" else m.cbp >> 4
        cha, chb = ch(self.addr_a()), ch(self.addr_b())
        chroma = cbp >> 4
        c.bin(77 + (cha > 0) + 2 * (chb > 0), int(chroma > 0))
        if chroma:
            c.bin(77 + 4 + (cha == 2) + 2 * (chb == 2), int(chroma == 2))

    def _qp_delta(self, dq):
        if not self.pps_cur.cabac:
            self.bw.se(dq)
        else:
            v = 2 * dq - 1 if dq > 0 else -2 * dq
            self.cab.bin(60 + (self.last_qpd != 0), int(v > 0))
            if v:
                ctx = 62
                for _ in range(v - 1):
                    self.cab.bin(ctx, 1)
                    ctx = 63
                self.cab.bin(ctx, 0)
        self.last_qpd = dq
        q = self.qp + dq
        self.qp = q % 52 if q < 0 or q > 51 else q

    def _t8_flag(self, t8):
        if self.pps_cur.cabac:
            ctx = 399
            for a in (self.addr_a(), self.addr_b()):
                if self.avail(a) and self.mbs[a].t8:
                    ctx += 1
            self.cab.bin(ctx, int(t8))
        else:
            self.bw.u(1, int(t8))

    # ---------------------------------------------------------- levels

    def _levels(self, n, kind, qp, density=None, must=False):
        """Random levels for a block of ``n``, kept within what a conforming
        stream allows: the dequantised coefficients of a block (estimated
        from the largest weight of any scaling list in use) sum to at most
        4000, so that no intermediate of the inverse transform leaves 16
        bits (FFmpeg's SIMD transforms wrap there)."""
        rng = self.rng
        density = self.pic.density if density is None else density
        norm, div = {"4x4": (29, 16), "8x8": (58, 64), "dc": (18, 64),
                     "cdc": (18, 32)}[kind]
        unit = norm * self.wmax * (1 << (qp // 6)) / div
        cap = max(1, int(4000 // unit))
        out = [0] * n
        for i in range(n):
            if rng.random() < density * (1.0 - 0.5 * i / n):
                if rng.random() < self.pic.big_levels:
                    v = int(rng.integers(1, max(2, cap + 1)))
                else:
                    v = int(rng.integers(1, max(2, min(cap, 4) + 1)))
                out[i] = v if rng.random() < 0.5 else -v
        if must and not any(out):
            out[int(rng.integers(0, n))] = 1
        while sum(map(abs, out)) * unit > 4000:
            nz = [i for i, v in enumerate(out) if v]
            if len(nz) == 1:
                out[nz[0]] = 1 if out[nz[0]] > 0 else -1
                break
            out[nz[int(rng.integers(0, len(nz)))]] = 0
        return out

    # ---------------------------------------------------------- residual

    def _nc(self, x4, y4):
        la, lb = self.locate(4 * x4 - 1, 4 * y4), self.locate(4 * x4, 4 * y4 - 1)

        def n(l):
            return 16 if l[0].kind == "PCM" else l[0].nnz[l[1]]
        if la and lb:
            return (n(la) + n(lb) + 1) >> 1
        return n(la) if la else n(lb) if lb else 0

    def _nc_chroma(self, c, x2, y2):
        m = self.cur

        def side(dx, dy):
            nx, ny = x2 + dx, y2 + dy
            if nx >= 0 and ny >= 0:
                return True, m.nnzc[c][ny * 2 + nx]
            a = self.addr_a() if dx else self.addr_b()
            if not self.avail(a):
                return False, 0
            o = self.mbs[a]
            if o.kind == "PCM":
                return True, 16
            return True, o.nnzc[c][((ny + 2) & 1) * 2 + ((nx + 2) & 1)]
        ha, na = side(-1, 0)
        hb, nb = side(0, -1)
        if ha and hb:
            return (na + nb + 1) >> 1
        return na if ha else nb if hb else 0

    def _cavlc(self, coeffs, nc):
        bw = self.bw
        n = len(coeffs)
        nz = [i for i, v in enumerate(coeffs) if v]
        tc = len(nz)
        levels = [coeffs[i] for i in reversed(nz)]
        t1 = 0
        for v in levels:
            if abs(v) == 1 and t1 < 3:
                t1 += 1
            else:
                break
        if nc < 0:
            ln = int(T["kChromaDcCoeffTokenLen"][tc * 4 + t1])
            code = int(T["kChromaDcCoeffTokenBits"][tc * 4 + t1])
        else:
            tab = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
            ln = int(T["kCoeffTokenLen"][tab][tc * 4 + t1])
            code = int(T["kCoeffTokenBits"][tab][tc * 4 + t1])
        assert ln
        bw.u(ln, code)
        if not tc:
            return 0
        for v in levels[:t1]:
            bw.u(1, int(v < 0))
        suffix = 1 if tc > 10 and t1 < 3 else 0
        for i, v in enumerate(levels[t1:], start=t1):
            code = 2 * v - 2 if v > 0 else -2 * v - 1
            if i == t1 and t1 < 3:
                code -= 2
            if suffix == 0 and code < 14:
                bw.u(code + 1, 1)
            elif suffix == 0 and code < 30:
                bw.u(15, 1)
                bw.u(4, code - 14)
            elif suffix and code < (15 << suffix):
                bw.u((code >> suffix) + 1, 1)
                bw.u(suffix, code & ((1 << suffix) - 1))
            else:
                base = (15 << suffix) + (15 if suffix == 0 else 0)
                rest = code - base
                prefix = 15
                while True:
                    size = prefix - 3
                    add = 0 if prefix == 15 else (1 << (prefix - 3)) - 4096
                    if 0 <= rest - add < (1 << size):
                        break
                    prefix += 1
                bw.u(prefix + 1, 1)
                bw.u(size, rest - add)
            if suffix == 0:
                suffix = 1
            if abs(v) > (3 << (suffix - 1)) and suffix < 6:
                suffix += 1
        if tc < n:
            zeros = nz[-1] + 1 - tc
            if nc < 0:
                bw.u(int(T["kChromaDcTotalZerosLen"][tc - 1][zeros]),
                     int(T["kChromaDcTotalZerosBits"][tc - 1][zeros]))
            else:
                bw.u(int(T["kTotalZerosLen"][tc - 1][zeros]),
                     int(T["kTotalZerosBits"][tc - 1][zeros]))
        else:
            zeros = 0
        # run_before, from the highest frequency down
        left = zeros
        pos = list(reversed(nz))
        for i in range(tc - 1):
            if left <= 0:
                break
            run = pos[i] - pos[i + 1] - 1
            t = min(left, 7) - 1
            bw.u(int(T["kRunLen"][t][run]), int(T["kRunBits"][t][run]))
            left -= run
        return tc

    def _cabac_block(self, coeffs, cat, cbf_ctx):
        c = self.cab
        n = len(coeffs)
        nz = [i for i, v in enumerate(coeffs) if v]
        if cbf_ctx is not None:
            c.bin(cbf_ctx, int(bool(nz)))
        if not nz:
            return 0
        sig_off = [0, 15, 29, 44, 47]
        abs_off = [0, 10, 20, 30, 39]
        if cat == 5:
            sig, last, absb = 402, 417, 426
        else:
            sig, last = 105 + sig_off[cat], 166 + sig_off[cat]
            absb = 227 + abs_off[cat]
        lastnz = nz[-1]
        for i in range(n - 1):
            if cat == 5:
                sc = sig + int(T["kSigCoeffFlagOffset8x8"][i])
                lc = last + int(T["kLastCoeffFlagOffset8x8"][i])
            else:
                k = min(i, 2) if cat == 3 else i
                sc, lc = sig + k, last + k
            s = int(coeffs[i] != 0)
            c.bin(sc, s)
            if s:
                c.bin(lc, int(i == lastnz))
                if i == lastnz:
                    break
        gt1 = eq1 = 0
        for i in reversed(nz):
            a = abs(coeffs[i]) - 1
            c.bin(absb + (0 if gt1 else min(4, 1 + eq1)), int(a > 0))
            if a > 0:
                c2 = absb + 5 + min(4 - (cat == 3), gt1)
                for j in range(1, 14):
                    b = int(a > j)
                    c.bin(c2, b)
                    if not b:
                        break
                if a >= 14:
                    c.eg(a - 14, 0)
                gt1 += 1
            else:
                eq1 += 1
            c.bypass(int(coeffs[i] < 0))
        return len(nz)

    def _cbf_luma(self, x4, y4, dx, dy, intra):
        l = self.locate(4 * x4 + dx, 4 * y4 + dy)
        if l is None:
            return int(intra)
        m, b = l
        if m.kind == "PCM":
            return 1
        if m.kind == "SKIP":
            return 0
        return int(m.nnz[b] != 0)

    def _cbf_chroma(self, c, x2, y2, dx, dy, intra):
        nx, ny = x2 + dx, y2 + dy
        if nx >= 0 and ny >= 0:
            return int(self.cur.nnzc[c][ny * 2 + nx] != 0)
        a = self.addr_a() if dx else self.addr_b()
        if not self.avail(a):
            return int(intra)
        m = self.mbs[a]
        if m.kind == "PCM":
            return 1
        if m.kind == "SKIP":
            return 0
        return int(m.nnzc[c][((ny + 2) & 1) * 2 + ((nx + 2) & 1)] != 0)

    def _cbf_dc(self, bit, intra):
        ctx = 0
        for k, a in enumerate((self.addr_a(), self.addr_b())):
            if not self.avail(a):
                c = int(intra)
            elif self.mbs[a].kind == "PCM":
                c = 1
            else:
                c = self.mbs[a].cbf_dc >> bit & 1
            ctx += c << k
        return ctx

    def _residual(self, kind, cbp, t8):
        m = self.cur
        intra = m.intra
        cabac = self.pps_cur.cabac
        qp = self.qp
        cl, cc = cbp & 15, cbp >> 4
        if kind == "I16":
            dc = self._levels(16, "dc", qp)
            n = (self._cabac_block(dc, 0, 85 + self._cbf_dc(0, True)) if cabac
                 else self._cavlc(dc, self._nc(0, 0)))
            if n:
                m.cbf_dc |= 1
        for b8 in range(4):
            if not cl >> b8 & 1:
                continue
            if t8:
                # one draw of 64 levels either way (CAVLC codes them as
                # four interleaved blocks), so that the twins match
                lv = self._levels(64, "8x8", qp, must=True)
                if cabac:
                    n = self._cabac_block(lv, 5, None)
                    x4, y4 = (b8 & 1) * 2, (b8 >> 1) * 2
                    for j in range(2):
                        for i in range(2):
                            m.nnz[(y4 + j) * 4 + x4 + i] = n
                    continue
                for i4 in range(4):
                    b = b8 * 4 + i4
                    x4, y4 = BLK_X[b], BLK_Y[b]
                    m.nnz[y4 * 4 + x4] = self._cavlc(lv[i4::4],
                                                     self._nc(x4, y4))
                continue
            for i4 in range(4):
                b = b8 * 4 + i4
                x4, y4 = BLK_X[b], BLK_Y[b]
                if kind == "I16":
                    lv = self._levels(15, "4x4", qp)
                    n = (self._cabac_block(
                        lv, 1, 85 + 4 + self._cbf_luma(x4, y4, -1, 0, True)
                        + 2 * self._cbf_luma(x4, y4, 0, -1, True)) if cabac
                        else self._cavlc(lv, self._nc(x4, y4)))
                else:
                    lv = self._levels(16, "4x4", qp)
                    n = (self._cabac_block(
                        lv, 2, 85 + 8 + self._cbf_luma(x4, y4, -1, 0, intra)
                        + 2 * self._cbf_luma(x4, y4, 0, -1, intra)) if cabac
                        else self._cavlc(lv, self._nc(x4, y4)))
                m.nnz[y4 * 4 + x4] = n
        qpc = [int(T["kChromaQp"][min(max(qp + o, 0), 51)])
               for o in self._cqp_offsets()]
        if cc:
            for c in range(2):
                lv = self._levels(4, "cdc", qpc[c], density=0.5)
                n = (self._cabac_block(lv, 3, 85 + 12 + self._cbf_dc(1 + c, intra))
                     if cabac else self._cavlc(lv, -1))
                if n:
                    m.cbf_dc |= 2 << c
        if cc == 2:
            for c in range(2):
                for b in range(4):
                    x2, y2 = b & 1, b >> 1
                    lv = self._levels(15, "4x4", qpc[c])
                    n = (self._cabac_block(
                        lv, 4, 85 + 16 + self._cbf_chroma(c, x2, y2, -1, 0, intra)
                        + 2 * self._cbf_chroma(c, x2, y2, 0, -1, intra))
                        if cabac else self._cavlc(lv, self._nc_chroma(c, x2, y2)))
                    m.nnzc[c][b] = n

    def _cqp_offsets(self):
        p = self.pps_cur
        return (p.chroma_qp_offset, p.chroma_qp_offset
                if p.second_chroma_qp_offset is None
                else p.second_chroma_qp_offset)

    # ---------------------------------------------------------- macroblocks

    def _mb(self):
        pic, rng, m = self.pic, self.rng, self.cur
        if pic.global_mv is not None:
            return self._inter(0, mvds=[pic.global_mv])
        if pic.pcm is not None:
            return self._pcm()
        kinds = [k for k in pic.mb_types if k != "SKIP"]
        if pic.kind == "I":
            kinds = [k for k in kinds if k not in "PB"]
        if "I8" in kinds and not self.pps_cur.transform_8x8:
            kinds.remove("I8")
        kind = str(rng.choice(kinds))
        if kind == "P":
            return self._inter(int(rng.choice(list(pic.p_parts))))
        if kind == "B":
            return self._b_inter(int(rng.choice(list(pic.b_types))))
        if kind == "PCM":
            return self._pcm()
        m.intra = True
        A, B, C, D = self.addr_a(), self.addr_b(), self.addr_c(), self.addr_d()
        ia, ib, ic, id_ = (self.intra_avail(a) for a in (A, B, C, D))
        if kind in ("I4", "I8"):
            t8 = kind == "I8"
            self._mb_type_intra(kind)
            if self.pps_cur.transform_8x8:
                self._t8_flag(t8)
            m.kind, m.t8 = kind, t8
            if t8:
                for b8 in range(4):
                    bx, by = b8 & 1, b8 >> 1
                    have = (1 if by or ib else 0) | (2 if bx or ia else 0) | (
                        4 if (bx and by) or (ia if (not bx and by) else
                                             ib if (bx and not by) else id_)
                        else 0)
                    mode = self._pick(NEED, have, range(9))
                    self._write_mode(mode, self._pred_mode(8 * bx, 8 * by))
                    for j in range(2):
                        for i in range(2):
                            m.ipred[(2 * by + j) * 4 + 2 * bx + i] = mode
            else:
                for b in range(16):
                    bx, by = BLK_X[b], BLK_Y[b]
                    tl = (bx and by) or (ia if (not bx and by) else
                                         ib if (bx and not by) else id_)
                    have = (1 if by or ib else 0) | (2 if bx or ia else 0) | (
                        4 if tl else 0)
                    mode = self._pick(NEED, have, range(9))
                    self._write_mode(mode, self._pred_mode(4 * bx, 4 * by))
                    m.ipred[by * 4 + bx] = mode
            have = (1 if ib else 0) | (2 if ia else 0) | (4 if id_ else 0)
            self._chroma_mode(self._pick(NEED_CHROMA, have, range(4)))
            cbp = self._rand_cbp()
            self._cbp(cbp, True)
            m.cbp = cbp
            if cbp:
                self._qp_delta(self._dq())
                self._residual(kind, cbp, t8)
            else:
                self.last_qpd = 0
            return
        # I_16x16
        have = (1 if ib else 0) | (2 if ia else 0) | (4 if id_ else 0)
        pred = self._pick(NEED16, have, range(4))
        chroma = int(rng.integers(0, 3))
        luma = int(rng.integers(0, 2))
        self._mb_type_intra("I16", 1 + pred + 4 * chroma + 12 * luma)
        m.kind = "I16"
        m.ipred = [2] * 16
        m.cbp = (15 if luma else 0) | chroma << 4
        self._chroma_mode(self._pick(NEED_CHROMA, have, range(4)))
        self._qp_delta(self._dq())
        self._residual("I16", m.cbp, False)

    def _rand_cbp(self):
        if self.pic.cbps is not None:
            return int(self.rng.choice(list(self.pic.cbps)))
        cbp = int(self.rng.integers(0, 48))
        return (cbp & 15) | ((cbp >> 4) % 3) << 4

    def _dq(self):
        if self.rng.random() >= self.pic.qp_deltas:
            return 0
        return int(self.rng.integers(-26, 26))

    def _pcm(self):
        m = self.cur
        m.kind, m.intra = "PCM", True
        m.ipred = [2] * 16
        m.cbp = 0x2F
        m.cbf_dc = 7
        m.nnz = [16] * 16
        m.nnzc = [[16] * 4, [16] * 4]
        self._mb_type_intra("PCM")
        bw = self.bw
        bw.align(0)     # pcm_alignment_zero_bit (after CABAC's flush too)
        pic = self.pic
        if pic.pcm is not None:
            y0, x0 = self.my * 16, self.mx * 16
            Y, U, V = pic.pcm
            data = (Y[y0:y0 + 16, x0:x0 + 16].tobytes()
                    + U[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8].tobytes()
                    + V[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8].tobytes())
        else:
            data = self.rng.integers(0, 256, 384, dtype=np.uint8).tobytes()
        sps = self.sps_cur
        if sps.bit_depth > 8 or sps.chroma_format != 1:
            cs = {0: 0, 1: 128, 2: 256, 3: 512}[sps.chroma_format]
            n = 256 + cs
            vals = self.rng.integers(0, 1 << sps.bit_depth, n)
            for v in vals:
                bw.u(sps.bit_depth, int(v))
        else:
            bw.raw(data)
        self.last_qpd = 0
        if self.pps_cur.cabac:
            self.cab.start()

    def _ref(self, lst, x, y, ref):
        """ref_idx_lX: te(v) in CAVLC; in CABAC refIdxZeroFlag counts a
        skipped or direct neighbour as reference 0."""
        n = self.nrefs[lst]
        if n <= 1:
            return
        if not self.pps_cur.cabac:
            self.bw.te(n - 1, ref)
            return
        ctx = 0
        for k, (dx, dy) in enumerate(((-1, 0), (0, -1))):
            l = self.locate(x + dx, y + dy)
            if l is None:
                continue
            o, b = l
            b8 = (b >> 3) * 2 + ((b & 3) >> 1)
            if not o.intra and not o.direct8 >> b8 & 1 and o.ref[lst][b8] > 0:
                ctx += 1 << k
        for _ in range(ref):
            self.cab.bin(54 + ctx, 1)
            ctx = (ctx >> 2) + 4
        self.cab.bin(54 + ctx, 0)

    def _mvd(self, lst, x, y, w, h, mvd):
        m = self.cur
        for comp in range(2):
            v = mvd[comp]
            if not self.pps_cur.cabac:
                self.bw.se(v)
                continue
            amvd = 0
            for dx, dy in ((-1, 0), (0, -1)):
                l = self.locate(x + dx, y + dy)
                if l is not None:
                    amvd += l[0].mvd[lst][l[1]][comp]
            base = 47 if comp else 40
            inc = 0 if amvd < 3 else 1 if amvd <= 32 else 2
            a = abs(v)
            self.cab.bin(base + inc, int(a > 0))
            if a:
                p = min(a, 9)
                ctx = base + 3
                for j in range(1, 9):
                    b = int(p > j)
                    self.cab.bin(ctx, b)
                    if j < 4:
                        ctx += 1
                    if not b:
                        break
                if a >= 9:
                    self.cab.eg(a - 9, 3)
                self.cab.bypass(int(v < 0))
        for j in range(y // 4, (y + h) // 4):
            for i in range(x // 4, (x + w) // 4):
                m.mvd[lst][j * 4 + i] = [min(abs(mvd[0]), 70),
                                         min(abs(mvd[1]), 70)]

    def _rand_mvd(self):
        rng, r = self.rng, self.pic.mv_range
        if rng.random() < self.pic.far_mv:
            return [int(rng.integers(-2000, 2000)), int(rng.integers(-600, 600))]
        return [int(rng.integers(-r, r + 1)), int(rng.integers(-r, r + 1))]

    def _inter(self, part, mvds=None):
        m, rng = self.cur, self.rng
        m.kind, m.intra = "P", False
        cabac = self.pps_cur.cabac
        if cabac and part == 4:
            part = 3     # CABAC has no binarisation of P_8x8ref0
        # mb_type
        if not cabac:
            self.bw.ue(part)
        else:
            c = self.cab
            c.bin(14, 0)
            if part in (0, 3):
                c.bin(15, 0)
                c.bin(16, int(part == 3))
            else:
                c.bin(15, 1)
                c.bin(17, int(part == 1))
        nref = self.nref

        def rref():
            return int(rng.integers(0, nref))
        subs = [0] * 4
        if part == 0:
            refs = [rref()]
            m.ref[0] = refs * 4
            self._ref(0, 0, 0, refs[0])
            parts = [(0, 0, 16, 16)]
        elif part == 1:
            refs = [rref(), rref()]
            m.ref[0] = [refs[0], refs[0], refs[1], refs[1]]
            self._ref(0, 0, 0, refs[0])
            self._ref(0, 0, 8, refs[1])
            parts = [(0, 0, 16, 8), (0, 8, 16, 8)]
        elif part == 2:
            refs = [rref(), rref()]
            m.ref[0] = [refs[0], refs[1], refs[0], refs[1]]
            self._ref(0, 0, 0, refs[0])
            self._ref(0, 8, 0, refs[1])
            parts = [(0, 0, 8, 16), (8, 0, 8, 16)]
        else:
            subs = [int(rng.integers(0, 4)) for _ in range(4)]
            for s in subs:
                if not cabac:
                    self.bw.ue(s)
                else:
                    c = self.cab
                    c.bin(21, int(s == 0))
                    if s:
                        c.bin(22, int(s > 1))
                        if s > 1:
                            c.bin(23, int(s == 2))
            # drawn either way, so that a CABAC twin (which codes
            # P_8x8ref0 as P_8x8) draws as its CAVLC stream does
            drawn = [rref() for _ in range(4)]
            m.ref[0] = [0] * 4 if part == 4 else drawn
            if part == 3:
                for i in range(4):
                    self._ref(0, (i & 1) * 8, (i >> 1) * 8, m.ref[0][i])
            parts = []
            for i in range(4):
                x0, y0 = (i & 1) * 8, (i >> 1) * 8
                s = subs[i]
                if s == 0:
                    parts.append((x0, y0, 8, 8))
                elif s == 1:
                    parts += [(x0, y0, 8, 4), (x0, y0 + 4, 8, 4)]
                elif s == 2:
                    parts += [(x0, y0, 4, 8), (x0 + 4, y0, 4, 8)]
                else:
                    parts += [(x0, y0, 4, 4), (x0 + 4, y0, 4, 4),
                              (x0, y0 + 4, 4, 4), (x0 + 4, y0 + 4, 4, 4)]
        for k, (x, y, w, h) in enumerate(parts):
            if mvds is not None:
                mvd = list(mvds[0]) if self.addr == 0 else [0, 0]
            else:
                mvd = self._rand_mvd()
            self._mvd(0, x, y, w, h, mvd)
        if self.pic.global_mv is not None:
            cbp = 0
        else:
            cbp = self._rand_cbp()
        self._cbp(cbp, False)
        m.cbp = cbp
        small = part >= 3 and any(subs)
        t8 = False
        if (cbp & 15) and self.pps_cur.transform_8x8 and not small:
            t8 = bool(rng.random() < 0.5) if self.pic.t8 is None else \
                self.pic.t8
            self._t8_flag(t8)
        m.t8 = t8
        if cbp:
            self._qp_delta(self._dq())
            self._residual("P", cbp, t8)
        else:
            self.last_qpd = 0


    # ---------------------------------------------------------- B macroblocks

    # each B mb_type's partition shape (0 16x16, 1 16x8, 2 8x16, 3 8x8) and
    # its partitions' lists (1 L0, 2 L1, 3 both), Table 7-14
    B_SHAPE = (0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2,
               1, 2, 3)
    B_PRED = ((0, 0), (1, 0), (2, 0), (3, 0), (1, 1), (1, 1), (2, 2), (2, 2),
              (1, 2), (1, 2), (2, 1), (2, 1), (1, 3), (1, 3), (2, 3), (2, 3),
              (3, 1), (3, 1), (3, 2), (3, 2), (3, 3), (3, 3), (0, 0))
    # each B sub_mb_type's shape (-1 direct, 0 8x8, 1 8x4, 2 4x8, 3 4x4)
    # and lists, Table 7-18
    B_SUB = ((-1, 0), (0, 1), (0, 2), (0, 3), (1, 1), (2, 1), (1, 2), (2, 2),
             (1, 3), (2, 3), (3, 1), (3, 2), (3, 3))

    def _b_type_prefix(self, bits):
        """CABAC's B mb_type bins up to the four bits ``bits`` (past the
        first two)."""
        ctx = sum(1 for a in (self.addr_a(), self.addr_b())
                  if self.avail(a) and not self.mbs[a].direct16)
        c = self.cab
        c.bin(27 + ctx, 1)
        c.bin(30, 1)
        c.bin(31, bits >> 3 & 1)
        for k in (2, 1, 0):
            c.bin(32, bits >> k & 1)

    def _b_type(self, t):
        if not self.pps_cur.cabac:
            self.bw.ue(t)
            return
        c = self.cab
        if t == 0:
            ctx = sum(1 for a in (self.addr_a(), self.addr_b())
                      if self.avail(a) and not self.mbs[a].direct16)
            c.bin(27 + ctx, 0)
        elif t <= 2:
            ctx = sum(1 for a in (self.addr_a(), self.addr_b())
                      if self.avail(a) and not self.mbs[a].direct16)
            c.bin(27 + ctx, 1)
            c.bin(30, 0)
            c.bin(32, t - 1)
        elif t <= 10:
            self._b_type_prefix(t - 3)
        elif t == 11:
            self._b_type_prefix(14)
        elif t == 22:
            self._b_type_prefix(15)
        else:
            self._b_type_prefix((t + 4) >> 1)
            c.bin(32, (t + 4) & 1)

    def _b_sub(self, t):
        if not self.pps_cur.cabac:
            self.bw.ue(t)
            return
        c = self.cab
        c.bin(36, int(t > 0))
        if not t:
            return
        c.bin(37, int(t > 2))
        if t <= 2:
            c.bin(39, t - 1)
            return
        if t >= 11:
            c.bin(38, 1)
            c.bin(39, 1)
            c.bin(39, t - 11)
            return
        c.bin(38, int(t >= 7))
        if t >= 7:
            c.bin(39, 0)
        v = t - (7 if t >= 7 else 3)
        c.bin(39, v >> 1)
        c.bin(39, v & 1)

    def _b_inter(self, t):
        """A B macroblock of mb_type ``t`` (0-22): its references and
        vector differences at random, each list in turn as the syntax
        orders them; what direct prediction derives is left to the decoder
        (no context depends on it)."""
        m, rng = self.cur, self.rng
        m.kind, m.intra = "B", False
        self._b_type(t)
        t8_ok = True
        inference = self.sps_cur.direct_8x8_inference

        def rref(lst):
            return int(rng.integers(0, self.nrefs[lst]))
        parts = [[], []]      # per list: (x, y, w, h)
        if t == 0:
            m.direct8, m.direct16 = 15, True
            t8_ok = inference
        elif t < 22:
            shape, pred = self.B_SHAPE[t], self.B_PRED[t]
            boxes = ([(0, 0, 16, 16)] if shape == 0 else
                     [(0, 0, 16, 8), (0, 8, 16, 8)] if shape == 1 else
                     [(0, 0, 8, 16), (8, 0, 8, 16)])
            for lst in range(2):
                for p, (x, y, w, h) in enumerate(boxes):
                    if not pred[p] >> lst & 1:
                        continue
                    r = rref(lst)
                    for b8 in range(4):
                        bx, by = (b8 & 1) * 8, (b8 >> 1) * 8
                        if x <= bx < x + w and y <= by < y + h:
                            m.ref[lst][b8] = r
                    self._ref(lst, x, y, r)
                    parts[lst].append((x, y, w, h))
        else:
            subs = [int(rng.choice(list(self.pic.b_subs))) for _ in range(4)]
            for i, st in enumerate(subs):
                self._b_sub(st)
                if st == 0:
                    m.direct8 |= 1 << i
                    t8_ok &= inference
                else:
                    t8_ok &= self.B_SUB[st][0] == 0
            for lst in range(2):
                for i, st in enumerate(subs):
                    if st and self.B_SUB[st][1] >> lst & 1:
                        r = rref(lst)
                        m.ref[lst][i] = r
                        self._ref(lst, (i & 1) * 8, (i >> 1) * 8, r)
            for lst in range(2):
                for i, st in enumerate(subs):
                    if not st or not self.B_SUB[st][1] >> lst & 1:
                        continue
                    x0, y0 = (i & 1) * 8, (i >> 1) * 8
                    sh = self.B_SUB[st][0]
                    parts[lst] += (
                        [(x0, y0, 8, 8)] if sh == 0 else
                        [(x0, y0, 8, 4), (x0, y0 + 4, 8, 4)] if sh == 1 else
                        [(x0, y0, 4, 8), (x0 + 4, y0, 4, 8)] if sh == 2 else
                        [(x0, y0, 4, 4), (x0 + 4, y0, 4, 4),
                         (x0, y0 + 4, 4, 4), (x0 + 4, y0 + 4, 4, 4)])
        if t < 22:
            for lst in range(2):
                for x, y, w, h in parts[lst]:
                    self._mvd(lst, x, y, w, h, self._rand_mvd())
        else:
            # the syntax orders them list by list, sub-macroblock by
            # sub-macroblock: parts[] is built in that order
            for lst in range(2):
                for x, y, w, h in parts[lst]:
                    self._mvd(lst, x, y, w, h, self._rand_mvd())
        cbp = self._rand_cbp()
        self._cbp(cbp, False)
        m.cbp = cbp
        t8 = False
        if (cbp & 15) and self.pps_cur.transform_8x8 and t8_ok:
            t8 = bool(rng.random() < 0.5) if self.pic.t8 is None else \
                self.pic.t8
            self._t8_flag(t8)
        m.t8 = t8
        if cbp:
            self._qp_delta(self._dq())
            self._residual("P", cbp, t8)
        else:
            self.last_qpd = 0

def write_stream(seed: int, sps: Sequence[Sps], pps: Sequence[Pps],
                 pics: Sequence[Pic], headers_each_idr: bool = True
                 ) -> List[bytes]:
    """The stream's access units (Annex B, four-byte start codes), the
    parameter sets in front of the first and, where ``headers_each_idr``,
    of every IDR picture."""
    w = Writer(seed, sps, pps)
    hdr = b"".join(b"\0\0\0\1" + n for n in parameter_sets(sps, pps))
    out = []
    for i, p in enumerate(pics):
        au = w.picture(p)
        if i == 0 or (p.idr and headers_each_idr):
            au = hdr + au
        out.append(au)
    return out


def display_order(pics: Sequence[Pic]) -> Tuple[List[int], int]:
    """Each picture's display index (by POC within each run from an IDR
    picture; decode order where no picture names its POC) and the reorder
    depth (the most places a picture moves back past those decoded before
    it)."""
    if all(p.poc is None for p in pics):
        return list(range(len(pics))), 0
    shown, seg, depth = [0] * len(pics), [], 0
    for i, p in enumerate(list(pics) + [Pic(idr=True)]):
        if p.idr and seg:
            base = seg[0]
            for r, j in enumerate(sorted(seg, key=lambda j: pics[j].poc)):
                shown[j] = base + r
            seg = []
        if i < len(pics):
            seg.append(i)
    for i, d in enumerate(shown):
        depth = max(depth, sum(1 for e in shown[:i] if e > d))
    return shown, depth


def parameter_sets(sps: Sequence[Sps], pps: Sequence[Pps]) -> List[bytes]:
    """The SPS and PPS NAL units."""
    by_id = {s.id: s for s in sps}
    return [sps_nal(s) for s in sps] + [pps_nal(p, by_id[p.sps_id])
                                        for p in pps]


def avcc(sps: Sequence[Sps], pps: Sequence[Pps], length_size: int = 4
         ) -> bytes:
    """An ``avcC`` record (ISO/IEC 14496-15) holding the parameter sets."""
    units = parameter_sets(sps, pps)
    s_units, p_units = units[:len(sps)], units[len(sps):]
    first = s_units[0]
    out = bytearray([1, first[1], first[2], first[3],
                     0xFC | (length_size - 1), 0xE0 | len(s_units)])
    for u in s_units:
        out += len(u).to_bytes(2, "big") + u
    out.append(len(p_units))
    for u in p_units:
        out += len(u).to_bytes(2, "big") + u
    return bytes(out)


def annexb_units(au: bytes) -> List[bytes]:
    """The NAL units of an Annex B access unit."""
    out = []
    i = au.find(b"\0\0\1")
    while i >= 0:
        j = au.find(b"\0\0\1", i + 3)
        end = len(au) if j < 0 else j
        unit = au[i + 3:end]
        if j >= 0 and unit.endswith(b"\0"):
            unit = unit[:-1]
        out.append(unit)
        i = j
    return out


def length_prefixed(au: bytes, length_size: int = 4,
                    keep_params: bool = False) -> bytes:
    """An Annex B access unit as MP4 and Matroska hold it: each NAL unit
    behind its length, the parameter sets dropped (they are in the
    ``avcC``) unless ``keep_params``."""
    out = bytearray()
    for u in annexb_units(au):
        if not keep_params and u[0] & 31 in (7, 8):
            continue
        out += len(u).to_bytes(length_size, "big") + u
    return bytes(out)


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return (8 + len(body)).to_bytes(4, "big") + kind + body


def _full(kind: bytes, *parts: bytes) -> bytes:
    return _box(kind, b"\0\0\0\0", *parts)


def write_mp4(path: str, samples: Sequence[bytes], keys: Sequence[bool],
              record: bytes, width: int, height: int, fps: int = 25,
              shown: Optional[Sequence[int]] = None) -> None:
    """A minimal ISO base media file of one ``avc1`` track: length-prefixed
    ``samples`` (one a frame at ``fps``), ``record`` its avcC, ``keys`` its
    sync samples; where no libavformat is at hand (the card machine).
    ``shown``: each sample's display index (B pictures), written as the
    mov muxer writes an encoder's B-frames: a ``ctts`` of each sample's
    display index less its decode index plus the reorder depth, and an
    ``elst`` that starts the track at the first picture shown."""
    n = len(samples)
    delay = max([i - d for i, d in enumerate(shown)] + [0]) if shown else 0
    u32 = lambda v: int(v).to_bytes(4, "big")  # noqa: E731
    u16 = lambda v: int(v).to_bytes(2, "big")  # noqa: E731
    matrix = b"".join(u32(v) for v in (0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                       0x40000000))
    ftyp = _box(b"ftyp", b"isom", u32(0x200), b"isomiso2avc1mp41")
    offsets, pos = [], len(ftyp) + 8       # past the mdat's header
    for s in samples:
        offsets.append(pos)
        pos += len(s)
    mdat = _box(b"mdat", *samples)
    entry = (b"\0" * 6 + u16(1) + b"\0" * 16 + u16(width) + u16(height)
             + u32(0x480000) + u32(0x480000) + u32(0) + u16(1)
             + bytes(32) + u16(0x18) + (-1).to_bytes(2, "big", signed=True)
             + _box(b"avcC", record))
    stbl = _box(
        b"stbl",
        _full(b"stsd", u32(1), _box(b"avc1", entry)),
        _full(b"stts", u32(1), u32(n), u32(1)),
        _full(b"stss", u32(sum(keys)),
              *(u32(i + 1) for i, k in enumerate(keys) if k)),
        *([_full(b"ctts", u32(n), *(u32(1) + u32(d - i + delay)
                                    for i, d in enumerate(shown)))]
          if shown else []),
        _full(b"stsc", u32(1), u32(1), u32(1), u32(1)),
        _full(b"stsz", u32(0), u32(n), *(u32(len(s)) for s in samples)),
        _full(b"stco", u32(n), *(u32(o) for o in offsets)))
    minf = _box(b"minf", _full(b"vmhd", bytes(8)),
                _box(b"dinf", _full(b"dref", u32(1),
                                    _box(b"url ", b"\0\0\0\1"))), stbl)
    mdia = _box(b"mdia",
                _full(b"mdhd", u32(0), u32(0), u32(fps), u32(n),
                      u16(0x55C4), u16(0)),
                _full(b"hdlr", u32(0), b"vide", bytes(12), b"video\0"),
                minf)
    tkhd = _box(b"tkhd", b"\0\0\0\3", u32(0), u32(0), u32(1), u32(0),
                u32(n * 1000 // fps), bytes(8), u16(0), u16(0), u16(0),
                u16(0), matrix, u32(width << 16), u32(height << 16))
    mvhd = _full(b"mvhd", u32(0), u32(0), u32(1000), u32(n * 1000 // fps),
                 u32(0x10000), u16(0x100), bytes(10), matrix, bytes(24),
                 u32(2))
    edts = [_box(b"edts", _full(b"elst", u32(1), u32(n * 1000 // fps),
                                u32(delay), u32(0x10000)))] if shown else []
    moov = _box(b"moov", mvhd, _box(b"trak", tkhd, *edts, mdia))
    with open(path, "wb") as f:
        f.write(ftyp + mdat + moov)
