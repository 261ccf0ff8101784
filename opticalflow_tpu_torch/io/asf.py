"""Advanced Systems Format (``.asf``, ``.wmv``): the demuxer of the port's
MS-MPEG4/WMV and Snow path, and the muxer of its MPEG-4 Part 2 output
(:class:`AsfWriter`), in Python (no FFmpeg).

:class:`AsfFile` reads what FFmpeg's asf demuxer (``asfdec_f.c``) reads of
a file for ``cv2.VideoCapture``:

  * the Header Object: the File Properties Object (the fixed data packet
    size, the play duration and preroll, the broadcast flag) and the first
    video stream's Stream Properties Object (its stream number and
    BITMAPINFOHEADER: the size, the fourcc, the extradata after its 40
    bytes); other objects are passed over;
  * the Data Object's packets, each of the fixed size: the error
    correction data, the length type flags (packet length, sequence,
    padding), send time and duration, then one payload or several
    (a count and the length type of their sizes): each payload's stream
    number (its top bit flags a key frame), media object number, offset
    into the object and replicated data (the object's size and its
    presentation time in ms), then its bytes; a media object (a
    compressed picture) is the payloads of one object number joined in
    offset order, across as many packets as it spans.  Compressed payloads
    (replicated data of length 1) raise ``Unsupported``;
  * the Simple Index Object, if there is one: an entry a time interval,
    each the packet where the last key frame before that time starts,
    which FFmpeg's seek lands on (:attr:`AsfFile.index`).

What cv2 reports follows FFmpeg: a frame's time is its presentation time
less the preroll; ASF stores no frame rate, so fps is the rate FFmpeg's
stream probe fits to the first 41 frames' millisecond times
(``mkv._rfps``: an exact common period, else the standard rate that fits
best, 30000/1001 for NTSC's 29.97) and takes as the average rate where the
mean period lies within a millisecond of it; a file where that is not so,
or too short to fit a rate to, raises ``Unsupported``, naming ROADMAP
Queue 1 item 8.  The count is OpenCV's play duration (less the preroll)
times fps, rounded.  A ``CAP_PROP_POS_FRAMES`` seek decodes from the last
key frame at or before the frame (``EncodedVideo.seek_target``), where
OpenCV's numbers of the frames' times are their indices
(:attr:`AsfFile.numbered`).
"""

from __future__ import annotations

import os
import struct
import uuid
from fractions import Fraction
from typing import BinaryIO, List, Optional, Tuple

from opticalflow_tpu_torch.io.avi import codec_of
from opticalflow_tpu_torch.io.mkv import _rfps
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["AsfFile", "AsfWriter", "EXTENSIONS", "guid"]

EXTENSIONS = (".asf", ".wmv")


def guid(text: str) -> bytes:
    """A GUID as ASF stores it (its first three fields little-endian)."""
    return uuid.UUID(text).bytes_le


HEADER = guid("75B22630-668E-11CF-A6D9-00AA0062CE6C")
DATA = guid("75B22636-668E-11CF-A6D9-00AA0062CE6C")
SIMPLE_INDEX = guid("33000890-E5B1-11CF-89F4-00A0C90349CB")
FILE_PROPERTIES = guid("8CABDCA1-A947-11CF-8EE4-00C00C205365")
STREAM_PROPERTIES = guid("B7DC0791-A9B7-11CF-8EE6-00C00C205365")
VIDEO_MEDIA = guid("BC19EFC0-5B4D-11CF-A8FD-00805F5C442B")
NO_CONCEALMENT = guid("20FB5700-5B55-11CF-A8FD-00805F5C442B")
HEADER_EXTENSION = guid("5FBF03B5-A92E-11CF-8EE3-00C00C205365")
RESERVED_1 = guid("ABD3D211-A9BA-11CF-8EE6-00C00C205365")


def _sized(kind: int, data: bytes, pos: int, default: int = 0
           ) -> Tuple[int, int]:
    """A field of a 2-bit length type (0 absent, 1 byte, 2 word, 3
    dword): (its value, the position after it)."""
    n = (0, 1, 2, 4)[kind & 3]
    if not n:
        return default, pos
    if pos + n > len(data):
        raise ValueError("truncated ASF data packet")
    return int.from_bytes(data[pos:pos + n], "little"), pos + n


class AsfFile:
    """The first video stream of an ASF file."""

    def __init__(self, path: str):
        self.path = path
        self.sizes: List[int] = []
        self.pieces: List[List[Tuple[int, int]]] = []  # (offset, length)
        self.stamps: List[int] = []                     # ms, less preroll
        self.keys: List[bool] = []
        self.index: List[Tuple[int, int]] = []   # (time ms, packet number)
        self.stream = None
        self.packet_size = self.play_duration = self.preroll = 0
        self.broadcast = False
        self.file_size = 0
        self.tag, self.dsi, self.bpc = "", b"", 0
        self.width = self.height = 0
        self.data_offset = self.packets = 0
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(30)
            if len(head) < 30 or head[:16] != HEADER:
                raise ValueError(f"{path}: not an ASF file")
            hsize = struct.unpack("<Q", head[16:24])[0]
            if hsize > size:
                raise ValueError(f"{path}: the ASF header runs past the file "
                                 "(truncated file?)")
            self._header(f.read(hsize - 30))
            pos = hsize
            while pos + 24 <= size:
                f.seek(pos)
                top = f.read(24)
                n = struct.unpack("<Q", top[16:24])[0]
                if n < 24:
                    raise ValueError(f"{path}: an ASF object of {n} bytes")
                if top[:16] == DATA:
                    self._data(f, pos, min(pos + n, size))
                elif top[:16] == SIMPLE_INDEX and pos + n <= size:
                    self._index(f.read(n - 24))
                pos += n
        if self.stream is None:
            raise ValueError(f"{path}: no video stream")
        if not self.sizes:
            raise ValueError(f"{path}: no video frames (truncated file?)")
        self.codec = codec_of(self.tag, path)
        self.keyframes = [i for i, k in enumerate(self.keys) if k] or [0]
        self.start_time = self.stamps[0]
        self.fps = self._fps()
        # FFmpeg takes the play duration as the stream's where the file is
        # no broadcast and about the size it says (within 5%)
        if self.broadcast or abs(size - self.file_size) >= min(
                size, self.file_size) / 20:
            raise Unsupported(f"{path}: an ASF file whose play duration "
                              f"FFmpeg does not take (a broadcast or a size "
                              f"other than its header's), so OpenCV's count "
                              f"is another guess; not read by the port "
                              f"({ITEM_8})")
        usec = (self.play_duration // 10000 - self.preroll) * 1000
        self.frames = int(usec / 1000000 * self.fps + 0.5)
        self.numbered = all(self.number(i) == i
                            for i in range(len(self.stamps)))

    # ---- the header

    def _header(self, body: bytes) -> None:
        pos = 0
        while pos + 24 <= len(body):
            g = body[pos:pos + 16]
            n = struct.unpack("<Q", body[pos + 16:pos + 24])[0]
            if n < 24 or pos + n > len(body):
                raise ValueError(f"{self.path}: a damaged ASF header object")
            obj = body[pos + 24:pos + n]
            if g == FILE_PROPERTIES:
                if len(obj) < 80:
                    raise ValueError(f"{self.path}: truncated ASF file "
                                     "properties")
                self.file_size = struct.unpack("<Q", obj[16:24])[0]
                (self.play_duration, _send, self.preroll, flags, minp,
                 maxp) = struct.unpack("<QQQIII", obj[40:76])
                self.broadcast = bool(flags & 1)
                if minp != maxp or minp <= 0:
                    raise ValueError(f"{self.path}: ASF data packets of "
                                     f"{minp}-{maxp} bytes (FFmpeg needs one "
                                     "fixed size)")
                self.packet_size = minp
            elif (g == STREAM_PROPERTIES and self.stream is None
                  and obj[:16] == VIDEO_MEDIA):
                self._video(obj)
            pos += n

    def _video(self, obj: bytes) -> None:
        tsd_len = struct.unpack("<I", obj[40:44])[0]
        self.stream = struct.unpack("<H", obj[48:50])[0] & 0x7F
        tsd = obj[54:54 + tsd_len]
        # encoded width and height, a reserved byte, the format data's
        # size, then the BITMAPINFOHEADER and extradata
        if len(tsd) < 11 + 40:
            raise ValueError(f"{self.path}: truncated ASF video format")
        fmt_len = struct.unpack("<H", tsd[9:11])[0]
        bmp = tsd[11:11 + fmt_len]
        bi_size, self.width, h = struct.unpack("<Iii", bmp[:12])
        self.height = abs(h)
        self.bpc = struct.unpack("<H", bmp[14:16])[0]     # biBitCount
        self.tag = bmp[16:20].decode("latin1")
        self.dsi = bmp[40:max(bi_size, 40)] if bi_size > 40 else bmp[40:]

    # ---- the data packets

    def _data(self, f: BinaryIO, start: int, end: int) -> None:
        if not self.packet_size:
            raise ValueError(f"{self.path}: ASF data before file properties")
        f.seek(start + 16 + 8 + 16)
        self.packets = struct.unpack("<Q", f.read(8))[0]
        self.data_offset = start + 50
        pending = {}   # media object number → frame index being joined
        pos, k = self.data_offset, 0
        while pos + self.packet_size <= end:
            f.seek(pos)
            self._packet(f.read(self.packet_size), pos, k, pending)
            pos += self.packet_size
            k += 1
        for i in pending.values():
            if sum(n for _, n in self.pieces[i]) != self.sizes[i]:
                raise ValueError(f"{self.path}: frame {i} is truncated")

    def _packet(self, p: bytes, at: int, k: int, pending: dict) -> None:
        what = f"{self.path}: ASF data packet {k}"
        pos = 0
        if p[0] & 0x80:                                  # error correction
            if p[0] & 0x8F != 0x82 or p[1] or p[2]:
                raise ValueError(f"{what}: bad error correction data")
            pos = 3
        flags, props = p[pos], p[pos + 1]
        pos += 2
        length, pos = _sized(flags >> 5, p, pos, self.packet_size)
        _, pos = _sized(flags >> 1, p, pos)              # sequence
        pad, pos = _sized(flags >> 3, p, pos)
        pos += 6                                         # send time, duration
        if length < self.packet_size:
            pad += self.packet_size - length
        multiple = flags & 1
        count, seg_type = 1, 0x80
        if multiple:
            count, seg_type = p[pos] & 0x3F, p[pos]
            pos += 1
        stop = self.packet_size - pad
        for _ in range(count):
            if pos >= stop:
                raise ValueError(f"{what}: payloads run past the packet")
            number, key = p[pos] & 0x7F, bool(p[pos] & 0x80)
            obj, pos = _sized(props >> 4, p, pos + 1)
            offset, pos = _sized(props >> 2, p, pos)
            replic, pos = _sized(props, p, pos)
            if replic == 1:
                raise Unsupported(f"{what}: compressed ASF payloads, not "
                                  f"read by the port ({ITEM_8})")
            if replic < 8:
                raise ValueError(f"{what}: replicated data of {replic} "
                                 "bytes")
            obj_size, stamp = struct.unpack("<II", p[pos:pos + 8])
            pos += replic
            if multiple:
                n, pos = _sized(seg_type >> 6, p, pos)
            else:
                n = stop - pos
            if n < 0 or pos + n > stop:
                raise ValueError(f"{what}: a payload runs past the packet")
            if number == self.stream:
                self._fragment(obj, offset, obj_size, stamp, key, at + pos,
                               n, pending, what)
            pos += n

    def _fragment(self, obj: int, offset: int, obj_size: int, stamp: int,
                  key: bool, at: int, n: int, pending: dict,
                  what: str) -> None:
        if offset == 0:
            i = pending.pop(obj, None)
            if i is not None and sum(m for _, m in self.pieces[i]) \
                    != self.sizes[i]:
                raise ValueError(f"{what}: frame {i} is cut short")
            pending[obj] = len(self.sizes)
            self.sizes.append(obj_size)
            self.pieces.append([])
            self.stamps.append(stamp - self.preroll)
            self.keys.append(key)
        i = pending.get(obj)
        if i is None or sum(m for _, m in self.pieces[i]) != offset:
            raise ValueError(f"{what}: a fragment of media object {obj} out "
                             "of order")
        if offset + n > self.sizes[i]:
            raise ValueError(f"{what}: media object {obj} overruns its size")
        self.pieces[i].append((at, n))
        if offset + n == self.sizes[i]:
            del pending[obj]

    def _index(self, body: bytes) -> None:
        if len(body) < 32:
            return
        interval, _, count = struct.unpack("<QII", body[16:32])
        for i in range(min(count, (len(body) - 32) // 6)):
            packet = struct.unpack("<I", body[32 + 6 * i:36 + 6 * i])[0]
            self.index.append((max(interval * i // 10000 - self.preroll, 0),
                               packet))

    # ---- what cv2 reports

    def _fps(self) -> float:
        rate = _rfps(self.stamps, 0.001)
        times = self.stamps[:41]
        durs = [b - a for a, b in zip(times, times[1:]) if b > a]
        if rate is None or not durs or abs(
                1000 * rate[1] / rate[0] - sum(durs) / len(durs)) > 1.0:
            raise Unsupported(
                f"{self.path}: ASF frame times that FFmpeg's probe fits no "
                f"frame rate to as its average (OpenCV's fps is then "
                f"another guess), not read by the port ({ITEM_8})")
        return rate[0] / rate[1]

    def number(self, i: int) -> int:
        """OpenCV's frame number of frame ``i`` (``dts_to_frame_number``)."""
        return int(self.fps * ((self.stamps[i] - self.start_time) * 0.001)
                   + 0.5)

    def sample(self, f: BinaryIO, i: int) -> bytes:
        parts = []
        for at, n in self.pieces[i]:
            f.seek(at)
            parts.append(f.read(n))
        data = b"".join(parts)
        if len(data) != self.sizes[i]:
            raise ValueError(f"{self.path}: frame {i} is truncated")
        return data


# ----------------------------------------------------------------- writer

def _object(g: bytes, body: bytes) -> bytes:
    return g + struct.pack("<Q", 24 + len(body)) + body


# asfenc.c's sizes: the data packet, the preroll (ms), the payload parsing
# information without its padding field, a payload's header in a packet
# of one payload and of several, and the index's interval (100 ns)
PACKET_SIZE = 3200
PREROLL = 3100
_PPI = 11
_SINGLE, _MULTIPLE = 15, 17
_PER_PACKET = 63
_INTERVAL = 10_000_000
# 1970-01-01 as a FILETIME, the creation date the muxer writes without one
_EPOCH = 116444736000000000


class AsfWriter:
    """MPEG-4 Part 2 samples → a ``.wmv``/``.asf`` file laid out as
    FFmpeg's asf muxer (``asfenc.c``) lays out ``cv2.VideoWriter``'s
    ``mp4v`` stream: the Header Object (File Properties: 3200-byte data
    packets, the play duration, preroll 3100 ms, seekable; an empty Header
    Extension; Stream Properties: stream 1, video, a BITMAPINFOHEADER with
    fourcc ``mp4v`` and the VOS/VOL headers as its extradata), the Data
    Object and a Simple Index Object.  Each picture goes into the packets
    as ``put_frame`` puts it: payloads after one another while a packet
    has room (several a packet, each with its replicated size and
    presentation time, ms after the preroll), a picture that does not fit
    split over the next, a packet that opens on a picture as large as a
    packet holding that one payload alone; each packet's send time and
    duration span its pictures' times.  The index has an entry a second
    (``update_index``): the packet where the last key frame at or before
    that time starts."""

    def __init__(self, path: str, size: Tuple[int, int],
                 rate: Tuple[int, int], dsi: bytes):
        self.w, self.h = size
        self.rate = Fraction(*rate)
        self.dsi = dsi
        self.n = 0
        self.duration = 0                 # 100 ns
        self.packets: List[bytes] = []
        self._payloads: List[bytes] = []
        self._left = PACKET_SIZE
        self._multi = True
        self._start = self._end = -1
        # update_index's state
        self.index: List[Tuple[int, int]] = []
        self._next = (0, 0)
        self._next_sec = 0
        self._end_sec = 0
        self._max = 0
        self.sizes: List[int] = []
        self._f: Optional[BinaryIO] = open(path, "wb")

    def _ms(self, i: int) -> int:
        """Frame i's time in ms, ``av_rescale_q`` rounding half up."""
        return int(i / self.rate * 1000 + Fraction(1, 2))

    def _flush(self) -> None:
        pad = self._left - _PPI - self._multi
        flags = 0x01 if self._multi else 0
        field = b""
        if pad > 0:
            if pad < 256:
                flags |= 0x08
                field = bytes((pad - 1,))
            else:
                flags |= 0x10
                field = struct.pack("<H", pad - 2)
        head = (b"\x82\0\0" + bytes((flags, 0x5D)) + field
                + struct.pack("<IH", self._start, self._end - self._start))
        if self._multi:
            head += bytes((0x80 | len(self._payloads),))
        body = b"".join(self._payloads)
        self.packets.append(head + body
                            + bytes(PACKET_SIZE - len(head) - len(body)))
        self._payloads = []
        self._left = PACKET_SIZE
        self._start = self._end = -1

    def write(self, sample: bytes, key: bool) -> None:
        ms = self._ms(self.n)
        self.duration = max(self.duration,
                            10000 * (ms + self._ms(1)))
        first = len(self.packets)
        off, size = 0, len(sample)
        while off < size:
            n = size - off
            if self._start == -1:
                self._multi = n < PACKET_SIZE - (_PPI + 1 + 2 * _MULTIPLE)
                room = (PACKET_SIZE - (_PPI + 1 + 2 * _MULTIPLE) - 1
                        if self._multi else PACKET_SIZE - _PPI - _SINGLE)
                self._start = ms
            else:
                room = self._left - _MULTIPLE - _PPI - 1
            if room > 0:
                if n > room:
                    n = room
                elif n == room - 1:
                    n = room - 2
                head = (bytes((0x81 if key else 0x01, (self.n + 1) & 0xFF))
                        + struct.pack("<IBII", off, 8, size, ms + PREROLL))
                if self._multi:
                    head += struct.pack("<H", n)
                self._payloads.append(head + sample[off:off + n])
                self._left -= n + (_MULTIPLE if self._multi else _SINGLE)
                self._end = ms
            else:
                n = 0
            off += n
            if (not self._multi or self._left <= _MULTIPLE + _PPI + 1
                    or len(self._payloads) == _PER_PACKET):
                self._flush()
        self.sizes.append(size)
        sec = -(-(PREROLL * 10000 + ms * 10000) // _INTERVAL)
        if key:
            self._update_index(sec, first, len(self.packets) - first)
        self._end_sec = sec
        self.n += 1

    def _update_index(self, sec: int, number: int, count: int) -> None:
        if sec > self._next_sec:
            if not self._next_sec:
                self._next = (number, count)
            self.index += [self._next] * (sec - self._next_sec)
        self._max = max(self._max, count)
        self._next = (number, count)
        self._next_sec = sec

    def _header(self, file_size: int) -> bytes:
        bmp = struct.pack("<IiiHH4sIiiII", 40 + len(self.dsi), self.w,
                          self.h, 1, 24, b"mp4v", self.w * self.h * 3, 0, 0,
                          0, 0) + self.dsi
        tsd = struct.pack("<IIBH", self.w, self.h, 2, len(bmp)) + bmp
        stream = (VIDEO_MEDIA + NO_CONCEALMENT
                  + struct.pack("<QIIHI", 0, len(tsd), 0, 1, 0) + tsd)
        play = self.duration + PREROLL * 10000
        seconds = max(self.duration / 1e7, 1e-3)
        rate = int(sum(self.sizes) * 8 / seconds)
        props = bytes(16) + struct.pack(
            "<QQQQQQIIII", file_size, _EPOCH, len(self.packets), play,
            self.duration, PREROLL, 2, PACKET_SIZE, PACKET_SIZE, rate)
        objs = [_object(FILE_PROPERTIES, props),
                _object(HEADER_EXTENSION, RESERVED_1 + struct.pack("<HI", 6,
                                                                   0)),
                _object(STREAM_PROPERTIES, stream)]
        return _object(HEADER, struct.pack("<IBB", len(objs), 1, 2)
                       + b"".join(objs))

    def release(self) -> None:
        f, self._f = self._f, None
        if f is None:
            return
        try:
            if self._payloads:
                self._flush()
            data = _object(DATA, bytes(16) + struct.pack(
                "<QH", len(self.packets), 0x101) + b"".join(self.packets))
            index = b""
            if self._next_sec:
                self._update_index(self._end_sec + 1, 0, 0)
                index = _object(SIMPLE_INDEX, bytes(16) + struct.pack(
                    "<QII", _INTERVAL, self._max, len(self.index)) + b"".join(
                        struct.pack("<IH", *e) for e in self.index))
            size = len(self._header(0)) + len(data) + len(index)
            f.write(self._header(size) + data + index)
        finally:
            f.close()
