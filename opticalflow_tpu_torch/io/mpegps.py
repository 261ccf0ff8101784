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
keyframes are the I-pictures (I-VOPs).

MPEG-4 Part 2 in a program stream (what ``cv2.VideoWriter`` writes with
fourcc ``mp4v`` into ``.mpg``) is split as FFmpeg's ``mpeg4video`` parser
splits it, its rate read from the VOL.  The shared pieces (PES packets,
the picture split, the duration estimate) are ``io/mpegpes``'s.

A truncated or damaged file raises ``ValueError``; a program stream
holding other video (H.264) raises ``Unsupported``; an elementary stream
(no packs) raises ``ValueError`` pointing to ``io/elementary``.
"""

from __future__ import annotations

import mmap
import os
from fractions import Fraction
from typing import Optional, Tuple

from opticalflow_tpu_torch.io.mpegpes import (TIME_BASE, Pes, PesVideo,
                                              duration_frames,
                                              mpeg4_vol_rate, timestamp)
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
from opticalflow_tpu_torch.runtime.mpeg12 import sequence_info

__all__ = ["MpegPsFile", "EXTENSIONS", "TIME_BASE", "video_codec"]

EXTENSIONS = (".mpg", ".mpeg", ".vob")
_PACK, _SYSTEM, _END = 0xBA, 0xBB, 0xB9


def video_codec(head: bytes, what: str) -> str:
    """The codec of an elementary video stream from its first bytes, as
    FFmpeg's probes tell MPEG-1/2 from MPEG-4 Part 2: ``mpeg12`` (a
    sequence or GOP header first), ``mpeg4`` (visual object sequence, VOL
    or VOP start codes); H.264 and anything else raise ``Unsupported``."""
    i = head.find(b"\x00\x00\x01")
    while 0 <= i < len(head) - 3:
        code = head[i + 3]
        if code in (0xB3, 0xB8):
            return "mpeg12"
        if code in (0xB0, 0xB5, 0xB6) or 0x20 <= code <= 0x2F:
            return "mpeg4"
        if code & 0x1F in (7, 8, 9) and code < 0x80:
            raise Unsupported(f"{what}: H.264 video in an MPEG stream, not "
                              f"read by the port ({ITEM_8})")
        i = head.find(b"\x00\x00\x01", i + 3)
    raise Unsupported(f"{what}: its video stream starts without an MPEG-1/2 "
                      "sequence header or MPEG-4 Part 2 headers: not read "
                      f"by the port ({ITEM_8})")


class MpegPsFile(PesVideo):
    """The first video stream of an MPEG program stream: one sample a
    picture, with its type, PTS (where a PES packet gave it one) and the
    file ranges it is read from."""

    def __init__(self, path: str):
        super().__init__(path)
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
                self.codec = video_codec(self.pes[0].read(mm, 0, 4096),
                                         path)
                self._split(mm)
            if not self.starts:
                raise ValueError(f"{path}: no picture in its video stream "
                                 "(truncated file?)")
            head = self.sample(f, 0)
        if self.codec == "mpeg12":
            seq = sequence_info(head, path)
            if seq is None:
                raise ValueError(f"{path}: MPEG-1/2 video without a "
                                 "sequence header")
            self.width, self.height, self.mpeg2 = (seq.width, seq.height,
                                                   seq.mpeg2)
            self.rate = seq.fps
        else:
            self.mpeg2 = False
            self.width = self.height = 0       # the decoder reads the VOL
            rate = mpeg4_vol_rate(head)
            if rate is None:
                raise ValueError(f"{path}: MPEG-4 video without a VOL")
            self.rate = rate
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
                                 f"outside a PES packet at byte {pos}: an "
                                 "elementary stream (.m1v, .m2v, .mpv) is "
                                 "read by io/elementary, under its own "
                                 "extension")
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
                    pes = Pes(pos, es, pts, dts)
                    pes.add(start, end - start)
                    self.pes.append(pes)
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
                pts = dts = timestamp(head, 3)
                if flags & 0x40:
                    if hl < 10:
                        raise ValueError(f"{self.path}: damaged PES header")
                    dts = timestamp(head, 8)
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
            pts = dts = timestamp(head, k)
            k += 5
        elif c >> 4 == 3 and k + 10 <= len(head):
            pts, dts = timestamp(head, k), timestamp(head, k + 5)
            k += 10
        elif c == 0x0F:
            k += 1
        else:
            raise ValueError(f"{self.path}: damaged PES header at byte "
                             f"{p - 6}")
        return p + k, pts, dts

    # ------------------------------------------------------------- public

    @property
    def fps(self) -> float:
        return float(self.rate)

    @property
    def r_frame_rate(self) -> Fraction:
        return Fraction(self.rate)

    @property
    def frames(self) -> int:
        """``CAP_PROP_FRAME_COUNT``: FFmpeg's duration estimate from the PES
        packets' PTS, times the rate (``mpegpes.duration_frames``)."""
        return duration_frames(self.start_time,
                               [p.pts for p in self.pes if p.pts is not None],
                               self.r_frame_rate, self.fps)
