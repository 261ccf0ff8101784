"""MPEG program streams (``.mpg``, ``.mpeg``, ``.vob``): the demuxer of the
port's video path, in Python (no FFmpeg).

:class:`MpegPsFile` reads MPEG-1 and MPEG-2 pack headers, the system
header and PES packets with their PTS and DTS, as FFmpeg's ``mpegps``
demuxer does for ``cv2.VideoCapture``.  It takes the first video stream
(ids 0xE0-0xEF) and passes over padding, private and audio streams.  The
stream's bytes are split into one sample for each picture, as FFmpeg's
``mpegvideo`` parser splits them: a picture ends at the first start code
that is not a slice after its slices, so sequence and GOP headers go with
the picture that follows them.  A PES packet's PTS belongs to the first
picture that starts in it.

fps comes from the sequence header (with MPEG-2's frame rate extension).
The frame count is ``cv2.VideoCapture``'s: FFmpeg estimates the duration
of a program stream from its PTS (the last packet's time, plus one frame,
less the first picture's time), and OpenCV multiplies it by the rate.  The
keyframes are the I-pictures.

A truncated or damaged file raises ``ValueError``; a program stream
without MPEG-1/2 video (H.264 or MPEG-4 in a PS) raises ``Unsupported``.
"""

from __future__ import annotations

import math
import mmap
import os
from bisect import bisect_right
from typing import BinaryIO, List, Optional, Tuple

from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
from opticalflow_tpu_torch.runtime.mpeg12 import picture_types, sequence_info

__all__ = ["MpegPsFile", "EXTENSIONS", "TIME_BASE"]

EXTENSIONS = (".mpg", ".mpeg", ".vob")
TIME_BASE = 90000           # PTS and DTS tick 90 kHz
_PACK, _SYSTEM, _END = 0xBA, 0xBB, 0xB9
_PICTURE, _SEQUENCE_END = 0x00, 0xB7


def _timestamp(b: bytes, at: int) -> int:
    """A 33-bit PTS or DTS from its five bytes (with marker bits)."""
    return ((b[at] >> 1 & 7) << 30 | b[at + 1] << 22 | (b[at + 2] >> 1) << 15
            | b[at + 3] << 7 | b[at + 4] >> 1)


class _Pes:
    """A video PES packet: its payload's file offset and size, its offset
    in the elementary stream, its PTS and DTS (the PTS where it has no
    DTS, as FFmpeg indexes it)."""
    __slots__ = ("start", "size", "es", "pts", "dts")

    def __init__(self, start: int, size: int, es: int, pts: Optional[int],
                 dts: Optional[int]):
        self.start, self.size, self.es = start, size, es
        self.pts, self.dts = pts, dts


class MpegPsFile:
    """The first video stream of an MPEG program stream: one sample a
    picture, with its type, PTS (where a PES packet gave it one) and the
    file ranges it is read from."""

    codec = "mpeg12"
    dsi = b""           # the codec headers come in band

    def __init__(self, path: str):
        self.path = path
        self.pes: List[_Pes] = []       # the video stream's packets
        self.stream: Optional[int] = None
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 4:
                raise ValueError(f"{path}: not an MPEG program stream")
            with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
                self._packets(mm, size)
                if not self.pes:
                    raise ValueError(f"{path}: no MPEG video stream in the "
                                     "program stream")
                self._split(mm)
        if not self.starts:
            raise ValueError(f"{path}: no MPEG-1/2 picture in its video "
                             "stream (truncated file?)")
        with open(path, "rb") as f:
            head = self.sample(f, 0)
        seq = sequence_info(head, path)
        if seq is None:
            raise Unsupported(f"{path}: its video stream (id 0x{self.stream:02x}"
                              ") starts without an MPEG-1/2 sequence header: "
                              "H.264 or MPEG-4 in a program stream is not "
                              f"read by the port ({ITEM_8})")
        self.width, self.height, self.mpeg2 = seq.width, seq.height, seq.mpeg2
        self.rate = seq.fps
        self.keyframes = [i for i, t in enumerate(self.types) if t == 1] or [0]

    # ------------------------------------------------------------ packets

    def _packets(self, mm, size: int) -> None:
        """Walk the packs: every PES packet of the first video stream."""
        pos, es = 0, 0
        while pos < size:
            if pos + 4 > size:
                raise ValueError(f"{self.path}: truncated at byte {pos}")
            if mm[pos:pos + 3] != b"\x00\x00\x01":
                nxt = mm.find(b"\x00\x00\x01", pos)
                if nxt < 0 and not mm[pos:].strip(b"\x00"):
                    return                      # zero padding at the end
                raise ValueError(f"{self.path}: no start code at byte {pos} "
                                 "(damaged program stream)")
            code = mm[pos + 3]
            if code == _PACK:
                if pos + 5 > size:
                    raise ValueError(f"{self.path}: truncated pack header")
                if mm[pos + 4] >> 6 == 1:       # MPEG-2: 14 bytes + stuffing
                    if pos + 14 > size:
                        raise ValueError(f"{self.path}: truncated pack header")
                    pos += 14 + (mm[pos + 13] & 7)
                elif mm[pos + 4] >> 4 == 2:     # MPEG-1: 12 bytes
                    pos += 12
                else:
                    raise ValueError(f"{self.path}: damaged pack header at "
                                     f"byte {pos}")
                continue
            if code == _END:
                pos += 4
                continue
            if code < _END:
                raise ValueError(f"{self.path}: elementary stream data "
                                 f"outside a PES packet at byte {pos} (an "
                                 "elementary .m1v/.m2v stream is not read "
                                 f"by the port, {ITEM_8})")
            if pos + 6 > size:
                raise ValueError(f"{self.path}: truncated packet header")
            n = mm[pos + 4] << 8 | mm[pos + 5]
            end = pos + 6 + n
            if end > size:
                raise ValueError(f"{self.path}: truncated packet at byte "
                                 f"{pos} ({n} bytes, {size - pos - 6} left)")
            if 0xE0 <= code <= 0xEF and self.stream in (None, code):
                self.stream = code
                start, pts, dts = self._pes_header(mm, pos + 6, end)
                if end > start:
                    self.pes.append(_Pes(start, end - start, es, pts, dts))
                    es += end - start
            pos = end

    def _pes_header(self, mm, p: int, end: int
                    ) -> Tuple[int, Optional[int], Optional[int]]:
        """(payload start, PTS, DTS) of the PES packet whose header starts
        at ``p``: MPEG-2's flags and header length, or MPEG-1's stuffing,
        STD buffer and timestamp codes."""
        pts = dts = None
        head = mm[p:min(end, p + 48)]
        if head and head[0] >> 6 == 2:
            if len(head) < 3 or 3 + head[2] > end - p:
                raise ValueError(f"{self.path}: damaged PES header at byte "
                                 f"{p - 6}")
            flags, hl = head[1], head[2]
            if flags & 0x80:
                if hl < 5:
                    raise ValueError(f"{self.path}: damaged PES header")
                pts = dts = _timestamp(head, 3)
                if flags & 0x40:
                    if hl < 10:
                        raise ValueError(f"{self.path}: damaged PES header")
                    dts = _timestamp(head, 8)
            return p + 3 + hl, pts, dts
        k = 0
        while k < len(head) and head[k] == 0xFF and k < 16:
            k += 1
        if k < len(head) and head[k] >> 6 == 1:
            k += 2
        if k >= len(head):
            raise ValueError(f"{self.path}: damaged PES header at byte "
                             f"{p - 6}")
        c = head[k]
        if c >> 4 == 2 and k + 5 <= len(head):
            pts = dts = _timestamp(head, k)
            k += 5
        elif c >> 4 == 3 and k + 10 <= len(head):
            pts, dts = _timestamp(head, k), _timestamp(head, k + 5)
            k += 10
        elif c == 0x0F:
            k += 1
        else:
            raise ValueError(f"{self.path}: damaged PES header at byte "
                             f"{p - 6}")
        return p + k, pts, dts

    # ----------------------------------------------------------- pictures

    def _split(self, mm) -> None:
        """One sample a picture (``mpeg1_find_frame_end``): sample i is the
        stream's bytes [starts[i], starts[i + 1])."""
        self.starts: List[int] = []
        self.pts: List[Optional[int]] = []
        pictures: List[int] = []
        cur, in_slices, tail = 0, False, b""
        have_picture = False
        es_total = 0
        for pes in self.pes:
            data = tail + mm[pes.start:pes.start + pes.size]
            base = pes.es - len(tail)
            i = data.find(b"\x00\x00\x01")
            while 0 <= i and i + 3 < len(data):
                o, code = base + i, data[i + 3]
                if 0x01 <= code <= 0xAF:
                    in_slices = True
                elif in_slices:
                    end = o + 4 if code == _SEQUENCE_END else o
                    if have_picture:
                        self.starts.append(cur)
                    cur, in_slices, have_picture = end, False, False
                if code == _PICTURE and not have_picture:
                    have_picture = True
                    pictures.append(o)
                i = data.find(b"\x00\x00\x01", i + 3)
            tail = data[-3:]
            es_total = pes.es + pes.size
        if have_picture and in_slices:
            self.starts.append(cur)
        self.ends = self.starts[1:] + [es_total]
        self.sizes = [e - s for s, e in zip(self.starts, self.ends)]
        # the picture start code of each sample, its type and PES timestamp
        self._es_starts = es_starts = [p.es for p in self.pes]
        used = set()
        self.types: List[int] = []
        self.pictures: List[int] = []   # each sample's picture start code
        pics = iter(pictures)
        for s in self.starts:
            o = next(pics)
            while o < s:
                o = next(pics)
            self.pictures.append(o)
            t = picture_types(self._es(mm, es_starts, o, 6))
            self.types.append(t[0] if t else 0)
            j = bisect_right(es_starts, o) - 1
            pes = self.pes[j]
            if pes.pts is not None and j not in used:
                used.add(j)
                self.pts.append(pes.pts)
            else:
                self.pts.append(None)

    def _es(self, mm, es_starts: List[int], o: int, n: int) -> bytes:
        """``n`` bytes of the stream from offset ``o``."""
        out = b""
        j = bisect_right(es_starts, o) - 1
        while len(out) < n and j < len(self.pes):
            p = self.pes[j]
            a = p.start + max(o + len(out) - p.es, 0)
            out += mm[a:p.start + p.size][:n - len(out)]
            j += 1
        return out

    # ------------------------------------------------------------- public

    @property
    def fps(self) -> float:
        return float(self.rate)

    @property
    def start_time(self) -> Optional[int]:
        """FFmpeg's start time of the stream: the first picture's PTS."""
        return next((p for p in self.pts if p is not None), None)

    @property
    def frames(self) -> int:
        """``CAP_PROP_FRAME_COUNT``: FFmpeg's duration estimate from the PES
        packets' PTS (the last packet's, plus one frame at the stream's
        rate, rounded down to 90 kHz ticks, less the start time), in whole
        microseconds, times the rate, rounded."""
        start = self.start_time
        stamps = [p.pts for p in self.pes if p.pts is not None]
        if start is None or not stamps:
            return 0
        tick = self.rate.denominator * TIME_BASE // self.rate.numerator
        duration = max(stamps) + tick - start
        if duration <= 0:
            return 0
        us = (duration * 1000000 + TIME_BASE // 2) // TIME_BASE
        return int(math.floor(us / 1e6 * float(self.rate) + 0.5))

    def sample(self, f: BinaryIO, i: int) -> bytes:
        """Picture ``i``'s bytes (from the PES packets it spans)."""
        s, e = self.starts[i], self.ends[i]
        j = bisect_right(self._es_starts, s) - 1
        out = bytearray()
        while len(out) < e - s and j < len(self.pes):
            p = self.pes[j]
            a = max(s + len(out) - p.es, 0)
            f.seek(p.start + a)
            chunk = f.read(min(p.size - a, e - s - len(out)))
            if len(chunk) != min(p.size - a, e - s - len(out)):
                raise ValueError(f"{self.path}: picture {i} is truncated")
            out += chunk
            j += 1
        return bytes(out)
