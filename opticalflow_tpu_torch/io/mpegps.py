"""MPEG program streams (``.mpg``, ``.mpeg``, ``.vob``): the demuxer of the
port's video path, and the muxer of its MPEG-4 Part 2 output
(:class:`PsWriter`), in Python (no FFmpeg).

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
import struct
from fractions import Fraction
from typing import BinaryIO, List, Optional, Tuple

from opticalflow_tpu_torch.io.mpegpes import (TIME_BASE, Pes, PesVideo,
                                              duration_frames,
                                              mpeg4_vol_rate, put_timestamp,
                                              timestamp)
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
from opticalflow_tpu_torch.runtime.mpeg12 import sequence_info

__all__ = ["MpegPsFile", "PsWriter", "EXTENSIONS", "TIME_BASE",
           "video_codec"]

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


# ----------------------------------------------------------------- writer

class _Unit:
    """A picture in the muxer's queue (mpegenc.c's ``PacketDesc``)."""
    __slots__ = ("pts", "size", "unwritten")

    def __init__(self, pts: int, size: int):
        self.pts, self.size, self.unwritten = pts, size, size


_PACK_SIZE = 2048
_BUFFER = 230 * 1024           # the video buffer the muxer assumes
_PRELOAD = 45000               # 0.5 s, in 90 kHz ticks
_MAX_DELAY = 63000             # 0.7 s
_STREAM = 0xE0
# the mux rate the muxer derives where the stream states no bit rate, in
# units of 50 bytes a second
_RATE = (lambda b: (b + b // 20 + 10000 + 399) // 400)((1 << 21) * 8 * 50)


class PsWriter:
    """MPEG-4 Part 2 samples (VOL headers in band) → an MPEG program stream
    laid out as FFmpeg's ``mpeg`` muxer (``mpegenc.c``) lays out
    ``cv2.VideoWriter``'s stream: MPEG-1 packs (``.mpg``, ``.mpeg``) or,
    as the ``svcd`` muxer cv2 picks for ``.vob``, MPEG-2 packs whose first
    holds only the system header and padding.  The pictures' bytes go out
    in 2048-byte packs as the muxer's queue fills (``output_packet``): a
    pack header with its SCR (the system header in the first, and every
    40th in MPEG-2), one PES packet of stream 0xE0 that carries the PTS of
    the first picture starting in it (0.5 s on, as the muxer's preload),
    a padding packet where the PES packet runs short; the SCR advances a
    pack at the mux rate and is bumped past the decode time of the oldest
    buffered picture when the next picture would be due more than 0.7 s
    after it.  Like the muxer, it writes no end code."""

    def __init__(self, path: str, rate: Tuple[int, int], mpeg2: bool = False):
        self.num, self.den = rate
        self.mpeg2 = mpeg2
        self.n = 0
        self.fifo = bytearray()
        self.queue: List[_Unit] = []      # premux onward, by position
        self.premux = 0                   # the first not wholly written
        self.predecode = 0                # the first still in the buffer
        self.buffer_index = 0
        self.last_scr = 0
        self.packs = 0                    # packs written
        self.stream_packs = 0             # packs holding the stream's data
        self.header_freq = 1 if mpeg2 else max(
            1, 2 * (_RATE * 400) // _PACK_SIZE // 8)
        self.system_freq = self.header_freq * (40 if mpeg2 else 5)
        self._f: Optional[BinaryIO] = open(path, "wb")

    # --- headers
    def _pack_header(self, scr: int) -> bytes:
        if self.mpeg2:
            bits = (0b01 << 46 | (scr >> 30 & 7) << 43 | 1 << 42
                    | (scr >> 15 & 0x7FFF) << 27 | 1 << 26
                    | (scr & 0x7FFF) << 11 | 1 << 10 | 1)
            return (b"\0\0\1\xba" + bits.to_bytes(6, "big")
                    + (_RATE << 2 | 3).to_bytes(3, "big") + b"\xf8")
        bits = (0b0010 << 36 | (scr >> 30 & 7) << 33 | 1 << 32
                | (scr >> 15 & 0x7FFF) << 17 | 1 << 16
                | (scr & 0x7FFF) << 1 | 1)
        return (b"\0\0\1\xba" + bits.to_bytes(5, "big")
                + (1 << 23 | _RATE << 1 | 1).to_bytes(3, "big"))

    @staticmethod
    def _system_header() -> bytes:
        body = ((1 << 23 | _RATE << 1 | 1).to_bytes(3, "big")
                + bytes((0, 0x21, 0xFF, _STREAM,
                         0xE0 | (_BUFFER // 1024) >> 8, (_BUFFER // 1024)
                         & 0xFF)))
        return b"\0\0\1\xbb" + struct.pack(">H", len(body)) + body

    def _padding(self, n: int) -> bytes:
        head = b"\0\0\1\xbe" + struct.pack(">H", n - 6)
        if self.mpeg2:
            return head + b"\xff" * (n - 6)
        return head + b"\x0f" + b"\xff" * (n - 7)

    # --- mpegenc.c's flush_packet and output_packet
    def _flush_packet(self, pts: Optional[int], scr: int,
                      trailer: int) -> int:
        out = bytearray()
        if self.packs % self.header_freq == 0 or self.last_scr != scr:
            out += self._pack_header(scr)
            self.last_scr = scr
            if self.packs % self.system_freq == 0:
                out += self._system_header()
        packet_size = _PACK_SIZE - len(out)
        pad = 0
        general = False
        if self.mpeg2 and self.packs == 0:
            general = True                # svcd: the first pack is empty
            pad = packet_size
        packet_size -= pad
        payload = stuffing = 0
        if packet_size > 0:
            packet_size -= 6
            if self.mpeg2:
                header_len = 3 + (3 if self.stream_packs == 0 else 0) + 1
            else:
                header_len = 0
            if pts is not None:
                header_len += 5
            elif not self.mpeg2:
                header_len += 1
            payload = packet_size - header_len
            stuffing = payload - len(self.fifo)
            if payload <= trailer and pts is not None:
                pts = None
                cut = 5 if self.mpeg2 else 4
                header_len -= cut
                payload += cut
                stuffing += cut
                if payload > trailer:
                    stuffing += payload - trailer
            if 0 < pad <= 7:
                packet_size += pad
                payload += pad
                stuffing = pad if stuffing < 0 else stuffing + pad
                pad = 0
            stuffing = max(stuffing, 0)
            if stuffing > 16:
                pad += stuffing
                packet_size -= stuffing
                payload -= stuffing
                stuffing = 0
            out += b"\0\0\1" + bytes((_STREAM,)) + struct.pack(
                ">H", packet_size)
            if self.mpeg2:
                flags = (0x80 if pts is not None else 0) | (
                    1 if self.stream_packs == 0 else 0)
                out += bytes((0x80, flags, header_len - 3 + stuffing))
                if pts is not None:
                    out += put_timestamp(2, pts)
                if flags & 1:
                    out += b"\x10" + struct.pack(">H", 0x6000
                                                   | _BUFFER // 1024)
                out += b"\xff" * (1 + stuffing)
            else:
                out += b"\xff" * stuffing
                out += put_timestamp(2, pts) if pts is not None else b"\x0f"
            n = payload - stuffing
            out += self.fifo[:n]
            del self.fifo[:n]
        if pad > 0:
            out += self._padding(pad)
        self._f.write(out)
        self.packs += 1
        if not general:
            self.stream_packs += 1
        return payload - stuffing if packet_size > 0 else 0

    def _remove_decoded(self, scr: int) -> None:
        while self.predecode < len(self.queue) and \
                scr > self.queue[self.predecode].pts:
            unit = self.queue[self.predecode]
            if self.buffer_index < unit.size or self.predecode == self.premux:
                break
            self.buffer_index -= unit.size
            self.predecode += 1

    def _output_packet(self, flush: bool) -> bool:
        scr = self.last_scr
        ignore_constraints = ignore_delay = False
        while True:
            if _PACK_SIZE > len(self.fifo) and not flush:
                return False
            ready = bool(self.fifo)
            if ready and _BUFFER - self.buffer_index < _PACK_SIZE \
                    and not ignore_constraints:
                ready = False
            nxt = (self.queue[self.premux] if self.premux < len(self.queue)
                   else None)
            if ready and nxt and nxt.pts - scr > _MAX_DELAY \
                    and not ignore_delay:
                ready = False
            if ready:
                break
            if self.predecode < len(self.queue):
                best = self.queue[self.predecode].pts
                if scr >= best + 1 and not ignore_constraints:
                    ignore_constraints = True
                scr = max(best + 1, scr)
                self._remove_decoded(scr)
            elif nxt is not None and flush:
                ignore_delay = ignore_constraints = True
            else:
                return False
        first = self.queue[self.premux]
        if first.unwritten == first.size:
            trailer, stamp = 0, first
        else:
            trailer = first.unwritten
            stamp = (self.queue[self.premux + 1]
                     if self.premux + 1 < len(self.queue) else None)
        size = self._flush_packet(stamp.pts if stamp else None, scr, trailer)
        self.buffer_index += size
        self.last_scr += _PACK_SIZE * 90000 // (_RATE * 50)
        while self.premux < len(self.queue) and \
                self.queue[self.premux].unwritten <= size:
            size -= self.queue[self.premux].unwritten
            self.premux += 1
        if size:
            self.queue[self.premux].unwritten -= size
        self._remove_decoded(self.last_scr)
        # drop what neither list needs
        done = min(self.premux, self.predecode)
        if done > 64:
            del self.queue[:done]
            self.premux -= done
            self.predecode -= done
        return True

    def write(self, sample: bytes, key: bool) -> None:
        pts = _PRELOAD + (self.n * 90000 * self.den * 2 + self.num) // (
            2 * self.num)
        self.queue.append(_Unit(pts, len(sample)))
        self.fifo += sample
        self.n += 1
        while self._output_packet(False):
            pass

    def release(self) -> None:
        f = self._f
        if f is None:
            return
        try:
            while self._output_packet(True):
                pass
        finally:
            self._f = None
            f.close()
