"""MPEG video carried in PES packets: what the port's program stream
(``io/mpegps``), transport stream (``io/mpegts``) and elementary stream
(``io/elementary``) readers share, in Python (no FFmpeg).

A demuxer fills :attr:`PesVideo.pes` with the video stream's packets
(their payloads' file ranges, PTS and DTS); :class:`PesVideo` splits the
stream into one sample a picture as FFmpeg's parsers split it for
``cv2.VideoCapture``:

  * MPEG-1/2 (``mpegvideo`` parser, ``mpeg1_find_frame_end``): a picture
    ends at the first start code that is not a slice after its slices, so
    sequence and GOP headers go with the picture that follows them;
  * MPEG-4 Part 2 (``mpeg4video`` parser, ``ff_mpeg4_find_frame_end``): a
    frame runs from its VOP start code to the next start code, the headers
    before a VOP going with it;
  * H.263 (``h263`` parser): a picture starts at each byte-aligned picture
    start code;
  * Dirac/VC-2 (``dirac`` parser): parse units followed through their
    next-unit offsets, a picture's sequence header and auxiliary data going
    with it (``runtime/dirac.split_units``).

A PES packet's timestamps belong to the first picture whose start code
lies in it (``ff_fetch_timestamp``).  The duration estimate is FFmpeg's
``estimate_timings_from_pts``: the largest PES timestamp plus one frame at
the stream's ``r_frame_rate``, less the start time.
"""

from __future__ import annotations

import math
from array import array
from bisect import bisect_right
from fractions import Fraction
from typing import BinaryIO, List, Optional, Sequence, Tuple

from opticalflow_tpu_torch.runtime.dirac import split_units
from opticalflow_tpu_torch.runtime.h263 import is_intra as h263_is_intra
from opticalflow_tpu_torch.runtime.mpeg12 import picture_types

__all__ = ["TIME_BASE", "timestamp", "Pes", "PesVideo", "duration_frames",
           "mpeg4_vol_rate", "mpeg4_vop_type", "split_starts"]

TIME_BASE = 90000           # PTS and DTS tick 90 kHz
_PICTURE, _SEQUENCE_END, _VOP = 0x00, 0xB7, 0xB6


def put_timestamp(prefix: int, t: int) -> bytes:
    """``put_timestamp``: a 33-bit PTS or DTS in its 5 bytes, ``prefix``
    in the top 4 bits (2: PTS alone, 3: PTS then DTS, 1: the DTS)."""
    return bytes((prefix << 4 | (t >> 29 & 0xE) | 1, t >> 22 & 0xFF,
                  (t >> 14 & 0xFE) | 1, t >> 7 & 0xFF, (t << 1 & 0xFE) | 1))


def timestamp(b: bytes, at: int) -> int:
    """A 33-bit PTS or DTS from its five bytes (with marker bits)."""
    return ((b[at] >> 1 & 7) << 30 | b[at + 1] << 22 | (b[at + 2] >> 1) << 15
            | b[at + 3] << 7 | b[at + 4] >> 1)


class Pes:
    """A video PES packet: the file ranges of its payload (``offsets``,
    ``lengths``), its size, its offset in the elementary stream, its PTS
    and DTS (the PTS where it has no DTS, as FFmpeg indexes it) and
    ``pos``, the file offset FFmpeg gives its packet (where it began)."""
    __slots__ = ("offsets", "lengths", "size", "es", "pts", "dts", "pos")

    def __init__(self, pos: int, es: int, pts: Optional[int],
                 dts: Optional[int]):
        self.offsets, self.lengths = array("q"), array("q")
        self.size, self.es, self.pts, self.dts, self.pos = 0, es, pts, dts, pos

    def add(self, offset: int, n: int) -> None:
        if n > 0:
            if self.lengths and self.offsets[-1] + self.lengths[-1] == offset:
                self.lengths[-1] += n
            else:
                self.offsets.append(offset)
                self.lengths.append(n)
            self.size += n

    def read(self, f: BinaryIO, skip: int = 0, n: Optional[int] = None
             ) -> bytes:
        """``n`` bytes of the payload (all when None) from ``skip`` on."""
        want = self.size - skip if n is None else min(n, self.size - skip)
        out = bytearray()
        for off, ln in zip(self.offsets, self.lengths):
            if len(out) >= want:
                break
            if skip >= ln:
                skip -= ln
                continue
            f.seek(off + skip)
            chunk = f.read(min(ln - skip, want - len(out)))
            if len(chunk) != min(ln - skip, want - len(out)):
                raise ValueError("a PES packet's payload is truncated")
            out += chunk
            skip = 0
        return bytes(out)


def _codes(data: bytes):
    """(offset, code) of every start code 00 00 01 xx in ``data``."""
    i = data.find(b"\x00\x00\x01")
    while 0 <= i and i + 3 < len(data):
        yield i, data[i + 3]
        i = data.find(b"\x00\x00\x01", i + 3)


def split_starts(chunks, codec: str) -> Tuple[List[int], List[int], int]:
    """Split a stream given as (stream offset, bytes) chunks in order into
    pictures as FFmpeg's parser for ``codec`` (``mpeg12``, ``mpeg4``,
    ``h263``, ``dirac``, ``h264``) splits it: (each sample's start offset, each
    sample's picture or VOP start code offset, the stream's length)."""
    if codec in ("dirac", "h264"):
        chunks = list(chunks)
        base = chunks[0][0] if chunks else 0
        data = b"".join(c for _, c in chunks)
        starts, pictures = (split_h264(data) if codec == "h264"
                            else split_units(data)[:2])
        return ([base + o for o in starts], [base + o for o in pictures],
                base + len(data))
    starts: List[int] = []
    pictures: List[int] = []
    cur, tail, total, base = None, b"", 0, 0
    in_slices = have = False
    for off, chunk in chunks:
        if cur is None:     # the first sample starts with the stream
            cur = off
        data = tail + chunk
        base = off - len(tail)
        total = off + len(chunk)
        if codec == "h263":
            # a byte-aligned 22-bit picture start code: 00 00 80-83
            i = data.find(b"\x00\x00")
            while 0 <= i and i + 2 < len(data):
                if data[i + 2] >> 2 == 0x20:
                    o = base + i
                    if have:
                        starts.append(cur)
                    cur, have = o, True
                    pictures.append(o)
                i = data.find(b"\x00\x00", i + 1)
            tail = data[-2:]
            continue
        for i, code in _codes(data):
            o = base + i
            if codec == "mpeg4":
                if have and o > pictures[-1]:
                    starts.append(cur)
                    cur, have = o, False
                if code == _VOP and not have:
                    have = True
                    pictures.append(o)
                continue
            if 0x01 <= code <= 0xAF:
                in_slices = True
            elif in_slices:
                end = o + 4 if code == _SEQUENCE_END else o
                if have:
                    starts.append(cur)
                cur, in_slices, have = end, False, False
            if code == _PICTURE and not have:
                have = True
                pictures.append(o)
        tail = data[-3:]
    if have and (in_slices or codec != "mpeg12"):
        starts.append(cur)
    # a picture start code of a sample that never closed has no sample
    return starts, pictures[:len(starts)], total


def _ue_pair(data: bytes, i: int) -> Optional[Tuple[int, int]]:
    """The first two exp-Golomb values after the NAL header byte at ``i``
    (a slice's first_mb_in_slice and slice_type; emulation prevention
    ignored as FFmpeg's parser ignores it), None where the data ends
    first."""
    b = _Bits(data, i + 1)
    out = []
    for _ in range(2):
        lz = 0
        while lz < 32 and not b.get(1):
            lz += 1
            if b.pos > 8 * len(data):
                return None
        out.append((1 << lz) - 1 + b.get(lz))
    return (out[0], out[1]) if b.pos <= 8 * len(data) else None


def split_h264(data: bytes) -> Tuple[List[int], List[int]]:
    """FFmpeg's h264 parser (``h264_find_frame_end``) over an Annex B
    stream: an access unit ends before an SEI, SPS, PPS or AUD that follows
    a slice of it, or before a slice whose first_mb_in_slice is not past the
    last slice's; its boundary takes a leading zero of a 4-byte start code.
    (each access unit's start, its first slice's start code)."""
    starts, slices, cur, found = _scan_h264(data)
    if found:
        starts.append(cur)
    return starts, slices[:len(starts)]


def h264_parser_units(data: bytes) -> List[Tuple[int, int]]:
    """(start, end) of each access unit FFmpeg's h264 parser hands over from
    ``data`` before what it still holds back (an access unit whose end it
    has not seen), whatever the data: FFmpeg's transport stream demuxer
    runs it over the first PES packets of a stream labelled H.264 (0x1B)
    before its probe finds the payload is MPEG-2 video."""
    starts, _, cur, _ = _scan_h264(data)
    return list(zip(starts, starts[1:] + [cur]))


def _scan_h264(data: bytes):
    """split_h264's walk: the access units closed, their first slices, where
    the one it holds starts, and whether that one has a slice."""
    starts: List[int] = []
    slices: List[int] = []
    found, last_mb, cur = False, -1, 0
    i = data.find(b"\x00\x00\x01")
    while 0 <= i and i + 3 < len(data):
        t = data[i + 3] & 31
        at = i - 1 if i and data[i - 1] == 0 else i
        if t in (6, 7, 8, 9):
            if found:
                starts.append(cur)
                cur, found = at, False
        elif t in (1, 2, 5):
            head = _ue_pair(data, i + 3)
            if head is not None:
                if found and head[0] <= last_mb:
                    starts.append(cur)
                    cur = at
                    slices.append(i)
                elif not found:
                    found = True
                    slices.append(i)
                last_mb = head[0]
        i = data.find(b"\x00\x00\x01", i + 3)
    return starts, slices, cur, found


def h264_slice_type(head: bytes) -> int:
    """1 where the slice whose start code begins ``head`` is an IDR or I
    slice, else 2."""
    if len(head) < 4:
        return 2
    if head[3] & 31 == 5:
        return 1
    pair = _ue_pair(head, 3)
    return 1 if pair is not None and pair[1] % 5 == 2 else 2


def mpeg4_vop_type(sample: bytes) -> Optional[int]:
    """The vop_coding_type (0 I, 1 P, 2 B, 3 S) of a sample's VOP, or None."""
    i = sample.find(b"\x00\x00\x01\xb6")
    return sample[i + 4] >> 6 if 0 <= i and i + 4 < len(sample) else None


class _Bits:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos * 8

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            bit = (self.data[byte] >> (7 - (self.pos & 7)) & 1
                   if byte < len(self.data) else 0)
            v = v << 1 | bit
            self.pos += 1
        return v


def mpeg4_vol_rate(data: bytes) -> Optional[Fraction]:
    """FFmpeg's ``framerate`` from a VOL header in ``data``:
    vop_time_increment_resolution over fixed_vop_time_increment (over 1
    without a fixed rate); None without a VOL."""
    for i, code in _codes(data):
        if 0x20 <= code <= 0x2F:
            b = _Bits(data, i + 4)
            b.get(1)                        # random_accessible_vol
            b.get(8)                        # video_object_type_indication
            verid = 1
            if b.get(1):                    # is_object_layer_identifier
                verid = b.get(4)
                b.get(3)
            if b.get(4) == 15:              # extended PAR
                b.get(16)
            if b.get(1):                    # vol_control_parameters
                b.get(3)
                if b.get(1):                # vbv_parameters
                    b.get(79)
            shape = b.get(2)
            if shape == 3 and verid != 1:
                b.get(4)
            b.get(1)
            res = b.get(16)
            if not res:
                return None
            b.get(1)
            bits = max((res - 1).bit_length(), 1)
            inc = b.get(bits) if b.get(1) else 1
            return Fraction(res, inc or 1)
    return None


def duration_frames(start: Optional[int], stamps: Sequence[int],
                    r_frame_rate: Fraction, fps: float) -> int:
    """``CAP_PROP_FRAME_COUNT`` of a stream whose duration FFmpeg estimates
    from PTS (``estimate_timings_from_pts``): the largest PES PTS plus one
    frame at ``r_frame_rate`` (rounded down to 90 kHz ticks), less the
    start time, in whole microseconds, times ``fps`` (OpenCV's rate),
    rounded."""
    if start is None or not stamps:
        return 0
    tick = r_frame_rate.denominator * TIME_BASE // r_frame_rate.numerator
    duration = max(stamps) + tick - start
    if duration <= 0:
        return 0
    us = (duration * 1000000 + TIME_BASE // 2) // TIME_BASE
    return int(math.floor(us / 1e6 * fps + 0.5))


class PesVideo:
    """A video stream in PES packets (:attr:`pes`, filled by a demuxer):
    one sample a picture, with its PTS and DTS (where its PES packet gave
    them) and the PES packet each sample's timestamps came from."""

    codec = "mpeg12"
    dsi = b""           # the codec headers come in band
    tag = "mp4v"

    def __init__(self, path: str):
        self.path = path
        self.pes: List[Pes] = []

    # ----------------------------------------------------------- pictures

    # PES packets an H.264-labelled MPEG-2 stream's first samples come from
    # (the H.264 parser's split; set by the transport stream demuxer)
    h264_head = 0

    def _split(self, f: BinaryIO) -> None:
        """One sample a picture (see the module's notes): sample i is the
        stream's bytes [starts[i], ends[i]).  With ``h264_head``, the first
        PES packets come as FFmpeg's h264 parser split them (slices without a
        picture header among them, which FFmpeg's MPEG-2 decoder passes
        over) and what it held back is lost; its timestamps stamp the
        samples that start in their PES packets."""
        head = self.pes[:self.h264_head]
        self.starts, self.pictures, total = split_starts(
            ((p.es, p.read(f)) for p in self.pes[len(head):]), self.codec)
        self.ends = self.starts[1:] + [total]
        stamp_at = list(self.pictures)
        if head:
            base = head[0].es
            data = b"".join(p.read(f) for p in head)
            units = h264_parser_units(data)
            codes = [base + i for i, c in _codes(data) if c == _PICTURE]
            pics = [next((o for o in codes if base + a <= o < base + b),
                         base + a) for a, b in units]
            self.starts = [base + a for a, _ in units] + self.starts
            self.ends = [base + b for _, b in units] + self.ends
            self.pictures = pics + self.pictures
            stamp_at = self.starts[:len(units)] + stamp_at
        self.sizes = [e - s for s, e in zip(self.starts, self.ends)]
        self._es_starts = es_starts = [p.es for p in self.pes]
        used = set()
        self.types: List[int] = []
        self.pts: List[Optional[int]] = []
        self.dts: List[Optional[int]] = []
        self.owner: List[Optional[int]] = []    # the PES each stamp came from
        for o, at in zip(self.pictures, stamp_at):
            head = self._es(f, o, 12 if self.codec == "h263" else 6)
            if self.codec == "mpeg12":
                t = picture_types(head)
                self.types.append(t[0] if t else 0)
            elif self.codec == "mpeg4":
                self.types.append(1 if mpeg4_vop_type(head) == 0 else 2)
            elif self.codec == "h264":
                head = self._es(f, o, 16)
                self.types.append(h264_slice_type(head))
            elif self.codec == "dirac":     # no reference: intra
                self.types.append(1 if len(head) > 4 and head[4] & 3 == 0
                                  else 2)
            else:
                self.types.append(1 if h263_is_intra(head) else 2)
            j = bisect_right(es_starts, at) - 1
            pes = self.pes[j]
            if pes.pts is not None and j not in used:
                used.add(j)
                self.pts.append(pes.pts)
                self.dts.append(pes.dts)
                self.owner.append(j)
            else:
                self.pts.append(None)
                self.dts.append(None)
                self.owner.append(None)

    def _es(self, f: BinaryIO, o: int, n: int) -> bytes:
        """``n`` bytes of the stream from offset ``o``."""
        out = b""
        j = bisect_right(self._es_starts, o) - 1
        while len(out) < n and j < len(self.pes):
            p = self.pes[j]
            out += p.read(f, max(o + len(out) - p.es, 0), n - len(out))
            j += 1
        return out

    # ------------------------------------------------------------- public

    @property
    def start_time(self) -> Optional[int]:
        """FFmpeg's start time of the stream: the first picture's PTS."""
        return next((p for p in self.pts if p is not None), None)

    def sample(self, f: BinaryIO, i: int) -> bytes:
        """Picture ``i``'s bytes (from the PES packets it spans)."""
        s, e = self.starts[i], self.ends[i]
        data = self._es(f, s, e - s)
        if len(data) != e - s:
            raise ValueError(f"{self.path}: picture {i} is truncated")
        return data
