"""NUT (``.nut``), FFmpeg's own container: the demuxer of the port's video
path, and the muxer of its MPEG-4 Part 2 output (:class:`NutWriter`), in
Python (no FFmpeg).

:class:`NutFile` reads what FFmpeg's nut demuxer (``nutdec.c``, ``nut.c``)
reads of a file for ``cv2.VideoCapture``:

  * the file ID string, then packets, each a 64-bit startcode, its
    ``forward_ptr`` (a v-coded size; one over 4096 bytes is followed by a
    CRC-32 of the startcode and size, the header checksum) and a body that
    ends in a CRC-32 of itself (``av_crc`` at ``AV_CRC_32_IEEE`` from 0: a
    body read whole, checksum included, sums to 0);
  * the main header (versions 3 and 4): the stream count, ``max_distance``,
    the time bases, the 256-entry frame-code table built from its runs
    (``tmp_flag``, ``tmp_fields``, ``tmp_pts``, ``tmp_mul``,
    ``tmp_stream``, ``tmp_size``, ``tmp_res``, ``count``,
    ``tmp_head_idx``; code ``'N'`` invalid), the elision headers and, in
    version 4, the flags; a header whose checksum fails is passed over for
    the next main header, as FFmpeg's search does;
  * the stream header: its class (video only), a fourcc of 2 or 4 bytes
    (NUT's own tags, then AVI's through ``io/avi.codec_of``), the time base
    id, ``msb_pts_shift``, ``max_pts_distance``, ``decode_delay``, the
    codec-specific data (the extradata FFV1, HuffYUV, Ut Video, MagicYUV,
    WMV7/8 and MPEG-4 read), the width, height and sample aspect; info
    packets give the stream's ``r_frame_rate``;
  * syncpoints (the global key pts, ``back_ptr``) and frames: a frame code,
    then the coded flags, stream id, pts (an lsb relative to the stream's
    last pts), size msb, header index, reserved fields and a frame checksum
    as its flags say; the data after the elided header of its index.  A
    syncpoint or header that fails its checksum, or a frame header FFmpeg
    refuses, is resynced over as FFmpeg resyncs: at the next startcode
    after the last syncpoint; a frame cut short by the end of the file is
    handed over short, as FFmpeg hands it to its decoder
    (:meth:`NutFile.is_cut` marks it: the MPEG-4 Part 2 decoder conceals
    what is missing as FFmpeg's error resilience does);
  * the index at the end (``index_ptr`` in the last 12 bytes): ``max_pts``,
    the syncpoint positions and the key-frame runs of each stream, which
    FFmpeg turns into its seek index one syncpoint behind (the key frame
    after syncpoint j is indexed at syncpoint j - 1, so the last is never
    indexed; ``nutdec.c``'s ``find_and_decode_index``).

What cv2 reports follows FFmpeg and OpenCV: fps is the ``avg_frame_rate``
``avformat_find_stream_info`` derives from the packets' durations, each one
frame at the info packet's ``r_frame_rate`` rounded down to the stream's
time base, snapped to a standard rate within 1%; the count is OpenCV's
duration × fps rounded, the duration the index's ``max_pts`` (the largest
pts in the file: the last frame's start, one frame short of its end, so a
file of 25 frames counts 24 where the pts run 0-24, and 25 where an MPEG-2
stream's B-pictures delay every pts one frame), or, without an index, the
time of the last syncpoint (``find_duration``).  A ``CAP_PROP_POS_FRAMES``
seek lands where ``read_seek`` does (:meth:`NutFile.landing`): at the
syncpoint of the index's last entry at or before the time (else its
first), or, with no entry (a file of one syncpoint, or none of its
frames key frames), through FFmpeg's syncpoint search; reading goes on
with every frame until a key frame passed over, so a stream with no key
frame (what cv2's writer makes of Dirac) reads nothing after any seek, as
cv2's capture reads nothing.  What cv2's writer never writes (more than one stream, a stream other than video, broadcast mode,
side or meta data on a frame) raises ``Unsupported`` too.
"""

from __future__ import annotations

import struct
from bisect import bisect_right
from math import gcd
from typing import BinaryIO, List, Optional, Tuple

from opticalflow_tpu_torch.io.avi import codec_of
from opticalflow_tpu_torch.io.mkv import _N_STD, av_reduce, std_rate
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["NutFile", "NutWriter", "EXTENSIONS", "FEATURES", "ID_STRING",
           "crc", "STARTCODES"]

EXTENSIONS = (".nut",)
ID_STRING = b"nut/multimedia container\x00"


def _startcode(low: int, letter: str) -> int:
    return low + ((ord("N") << 8 | ord(letter)) << 48)


MAIN = _startcode(0x7A561F5F04AD, "M")
STREAM = _startcode(0x11405BF2F9DB, "S")
SYNCPOINT = _startcode(0xE4ADEECA4569, "K")
INDEX = _startcode(0xDD672F23E64E, "X")
INFO = _startcode(0xAB68B596BA78, "I")
STARTCODES = frozenset((MAIN, STREAM, SYNCPOINT, INDEX, INFO))

# the frame code flags (nut.h)
FLAG_KEY, FLAG_EOR, FLAG_CODED_PTS, FLAG_STREAM_ID = 1, 2, 8, 16
FLAG_SIZE_MSB, FLAG_CHECKSUM, FLAG_RESERVED, FLAG_SM_DATA = 32, 64, 128, 256
FLAG_HEADER_IDX, FLAG_MATCH_TIME, FLAG_CODED, FLAG_INVALID = (1024, 2048,
                                                              4096, 8192)
NUT_BROADCAST, NUT_PIPE = 1, 2
_MAX_DISTANCE = 65536

# what a file reaches of the demuxer (NutFile.features), in order
FEATURES = ("main_header_v3", "main_header_v4", "elision_headers",
            "extradata", "info_rate", "syncpoints", "coded_flags",
            "coded_pts", "size_msb", "frame_checksum", "elided_header",
            "reserved_fields", "key_frames", "no_key_frames", "pts_reordered",
            "index", "index_without_entries", "no_index", "repeated_headers",
            "resync", "truncated_frame")

# what cv2's writer puts in a NUT stream header for each codec the port
# reads, by the name io/avi.codec_of knows it under
_AVI_NAME = {b"FMP4": "FMP4", b"XVID": "XVID", b"mp4v": "FMP4",
             b"MJPG": "MJPG", b"mpg2": "MPG2", b"mpg1": "MPG1",
             b"flv1": "FLV1", b"FLV1": "FLV1", b"MP42": "MP42",
             b"MP43": "MP43", b"DIV3": "DIV3", b"wmv1": "WMV1",
             b"wmv2": "WMV2", b"WMV1": "WMV1", b"WMV2": "WMV2",
             b"snow": "SNOW", b"SNOW": "SNOW", b"VP80": "VP80",
             b"VP90": "VP90", b"ffv1": "FFV1", b"FFV1": "FFV1",
             b"HFYU": "HFYU", b"FFVH": "FFVH", b"ULRA": "ULRA",
             b"ULRG": "ULRG", b"ULY0": "ULY0", b"ULY2": "ULY2",
             b"ULY4": "ULY4", b"MAGY": "MAGY", b"MPNG": "MPNG",
             b"asv1": "ASV1", b"asv2": "ASV2", b"ASV1": "ASV1",
             b"ASV2": "ASV2", b"drac": "drac", b"H263": "H263",
             b"h263": "H263", b"s263": "H263", b"I420": "I420"}


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7 if c & 0x80000000 else c << 1) \
                & 0xFFFFFFFF
        table.append(c)
    return table


_CRC = _crc_table()


def crc(data: bytes, value: int = 0) -> int:
    """``av_crc(av_crc_get_table(AV_CRC_32_IEEE), value, data)``: the
    CRC-32 of polynomial 0x04C11DB7, most significant bit first, without
    reflection or final inversion."""
    for b in data:
        value = _CRC[(value >> 24) ^ b] ^ (value << 8 & 0xFFFFFFFF)
    return value


class _Reader:
    """``data`` read from ``pos`` as FFmpeg's AVIOContext reads it: past the
    end every byte is 0 and :attr:`eof` is set."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos, self.eof = data, pos, False

    def u8(self) -> int:
        if self.pos >= len(self.data):
            self.eof = True
            self.pos += 1
            return 0
        self.pos += 1
        return self.data[self.pos - 1]

    def v(self) -> int:
        """``ffio_read_varlen``: 7 bits a byte, the top bit set on all but
        the last."""
        val = 0
        while True:
            t = self.u8()
            val = (val << 7) + (t & 127)
            if not t & 128:
                return val & 0xFFFFFFFFFFFFFFFF

    def s(self) -> int:
        """``get_s``: a v-coded signed value (0, 1, -1, 2, -2, ...)."""
        v = self.v() + 1
        return -(v >> 1) if v & 1 else v >> 1

    def bytes(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        if len(out) < n:
            self.eof = True
        return out

    def be(self, n: int) -> int:
        return int.from_bytes(self.bytes(n).ljust(n, b"\0"), "big")


class _Refused(Exception):
    """A packet FFmpeg's demuxer refuses (it resyncs)."""


class _Frame:
    __slots__ = ("offset", "size", "head", "pts", "key", "cut")

    def __init__(self, offset: int, size: int, head: bytes, pts: int,
                 key: bool, cut: bool = False):
        self.offset, self.size, self.head = offset, size, head
        self.pts, self.key, self.cut = pts, key, cut


class NutFile:
    """The video stream of a NUT file (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.data = data = f.read()
        if not data.startswith(ID_STRING):
            raise ValueError(f"{path}: not a NUT file (no ID string)")
        self.flags = 0
        self.time_bases: List[Tuple[int, int]] = []
        self.codes: List[Tuple[int, ...]] = []
        self.elided: List[bytes] = [b""]
        self.rate: Optional[Tuple[int, int]] = None   # r_frame_rate
        self.syncpoints: List[Tuple[int, int, int]] = []  # (pos, ts µs, back)
        self.frames_: List[_Frame] = []
        self.reached = set()
        r = _Reader(data, len(ID_STRING))
        self._main(r)
        self._stream(r)
        self._body(r)
        self.index: List[Tuple[int, int]] = []   # (timestamp, pos)
        self.max_pts: Optional[int] = None
        self._index()
        if not self.frames_:
            raise ValueError(f"{path}: no video frames (truncated file?)")
        fr = self.frames_
        self.sizes = [len(x.head) + x.size for x in fr]
        self.pts = [x.pts for x in fr]
        self.keys = [x.key for x in fr]
        self.keyframes = [i for i, k in enumerate(self.keys) if k] or [0]
        self.start_time = min(self.pts)
        self.reached.add("key_frames" if any(self.keys) else "no_key_frames")
        if any(b < a for a, b in zip(self.pts, self.pts[1:])):
            self.reached.add("pts_reordered")
        if self.dsi:
            self.reached.add("extradata")
        if self.rate:
            self.reached.add("info_rate")
        self.reached.add("index" if self.index else "no_index"
                         if self.max_pts is None else "index_without_entries")
        self.codec = self._codec()
        self.bpc = 0        # NUT stores no bits_per_coded_sample

    # ---- packets

    def _packet(self, r: _Reader, code: int) -> int:
        """``get_packetheader``: read the forward pointer (and the header
        checksum over 4096 bytes) after a startcode; the end of the body.
        Raises ``_Refused`` where the header checksum fails."""
        state = crc(code.to_bytes(8, "big"))
        start = r.pos
        size = r.v()
        if size > 4096:
            r.be(4)
            if crc(self.data[start:r.pos], state):
                raise _Refused("header checksum")
        return r.pos + size

    def _body_ok(self, start: int, end: int) -> bool:
        """Whether the body [start, end) sums to 0 with its checksum."""
        return end <= len(self.data) and crc(self.data[start:end]) == 0

    def _find(self, pos: int, want: Optional[int] = None
              ) -> Optional[Tuple[int, int]]:
        """``find_any_startcode`` (``find_startcode`` with ``want``): the
        first startcode at or after ``pos``: (its position, the code)."""
        data = self.data
        i = data.find(b"N", pos)
        while 0 <= i and i + 8 <= len(data):
            code = int.from_bytes(data[i:i + 8], "big")
            if code in STARTCODES and (want is None or code == want):
                return i, code
            i = data.find(b"N", i + 1)
        return None

    def _main(self, r: _Reader) -> None:
        pos = 0
        while True:
            got = self._find(pos, MAIN)
            if got is None:
                raise ValueError(f"{self.path}: no valid NUT main header "
                                 "(FFmpeg's demuxer does not open it either)")
            r.pos = got[0] + 8
            pos = got[0] + 1
            try:
                if self._main_header(r):
                    return
            except _Refused:
                pass

    def _main_header(self, r: _Reader) -> bool:
        end = self._packet(r, MAIN)
        start = r.pos
        version = r.v()
        if not 3 <= version <= 4:
            raise ValueError(f"{self.path}: NUT version {version} (FFmpeg "
                             "reads 3 and 4)")
        if version > 3:
            r.v()                                   # minor version
        self.version = version
        streams = r.v()
        if streams != 1:
            raise Unsupported(f"{self.path}: a NUT file of {streams} "
                              f"streams; the port reads the one video "
                              f"stream OpenCV's writer writes ({ITEM_8})")
        self.max_distance = min(r.v(), _MAX_DISTANCE)
        count = r.v()
        if not 0 < count < end - start:
            return False
        self.time_bases = []
        for _ in range(count):
            num, den = r.v(), r.v()
            if not (0 < num < 1 << 31 and 0 < den < 1 << 31):
                return False
            if gcd(num, den) != 1:
                return False
            self.time_bases.append((num, den))
        codes: List[Tuple[int, ...]] = []
        pts, mul, stream, head = 0, 1, 0, 0
        while len(codes) < 256:
            flags, fields = r.v(), r.v()
            if fields > 0:
                pts = r.s()
            if fields > 1:
                mul = r.v()
            if fields > 2:
                stream = r.v()
            size = r.v() if fields > 3 else 0
            res = r.v() if fields > 4 else 0
            n = r.v() if fields > 5 else mul - size
            if fields > 6:
                r.s()                               # match time delta
            if fields > 7:
                head = r.v()
            for _ in range(8, fields):
                if r.eof:
                    return False
                r.v()
            i = len(codes)
            if n <= 0 or n > 256 - (i <= ord("N")) - i or stream >= 1:
                return False
            j = 0
            while j < n:
                if len(codes) == ord("N"):
                    codes.append((FLAG_INVALID, 0, 0, 1, 0, 0, 0))
                    continue
                codes.append((flags, pts, stream, mul, size + j, res, head))
                j += 1
        self.codes = codes
        self.elided = [b""]
        if end > r.pos + 4:
            n = r.v()
            if n >= 128:
                return False
            left = 1024
            for _ in range(n):
                ln = r.v()
                if not 0 < ln < 256 or ln > left:
                    return False
                left -= ln
                self.elided.append(r.bytes(ln))
        self.flags = 0
        if version > 3 and end > r.pos + 4:
            self.flags = r.v()
        if r.pos > end or not self._body_ok(start, end):
            return False
        r.pos = end
        self.reached.add(f"main_header_v{version}")
        if len(self.elided) > 1:
            self.reached.add("elision_headers")
        if self.flags & NUT_BROADCAST:
            raise Unsupported(f"{self.path}: a NUT file in broadcast mode, "
                              f"which OpenCV's writer does not write; not read "
                              f"by the port ({ITEM_8})")
        return True

    def _stream(self, r: _Reader) -> None:
        pos = 0
        while True:
            got = self._find(pos, STREAM)
            if got is None:
                raise ValueError(f"{self.path}: no valid NUT stream header")
            r.pos, pos = got[0] + 8, got[0] + 1
            try:
                end = self._packet(r, STREAM)
            except _Refused:
                continue
            start = r.pos
            r.v()                                   # stream id (0)
            cls = r.v()
            n = r.v()
            self.fourcc = r.bytes(n) if n in (2, 4) else None
            tb_id, self.msb_shift = r.v(), r.v()
            self.max_pts_distance = r.v()
            r.v()                                   # decode delay
            r.v()                                   # stream flags
            self.dsi = r.bytes(r.v())
            if cls == 0:
                self.width, self.height = r.v(), r.v()
                self.sar = (r.v(), r.v())
                r.v()                               # colourspace type
            if (r.pos > end or not self._body_ok(start, end)
                    or tb_id >= len(self.time_bases) or self.msb_shift >= 16):
                continue
            if cls != 0:
                raise Unsupported(f"{self.path}: a NUT stream of class {cls} "
                                  f"(not video), which the port does not "
                                  f"read ({ITEM_8})")
            if self.fourcc is None:
                raise ValueError(f"{self.path}: a NUT fourcc of {n} bytes")
            self.time_base = self.time_bases[tb_id]
            r.pos = end
            return

    # ---- the body: syncpoints, frames and the packets between them

    def _info(self, r: _Reader) -> None:
        """``decode_info_header``: the stream's ``r_frame_rate``."""
        end = self._packet(r, INFO)
        start = r.pos
        stream_plus1 = r.v()
        r.s()                                       # chapter id
        r.v(), r.v()                                # chapter start, length
        for _ in range(r.v()):
            if r.eof or r.pos > end:
                break
            name = r.bytes(r.v())
            value = r.s()
            text = b""
            if value == -1:
                text = r.bytes(r.v())
            elif value == -2:
                r.bytes(r.v())
                text = r.bytes(r.v())
            elif value == -3 or value < -4:
                r.s()
            elif value == -4:
                r.v()
            if stream_plus1 == 1 and name == b"r_frame_rate":
                num, _, den = text.partition(b"/")
                try:
                    rate = (int(num), int(den))
                except ValueError:
                    rate = (0, 0)
                ok = 0 <= rate[0] < 1000 * rate[1] and rate[1] >= 0
                self.rate = rate if ok else None
        if r.pos > end or not self._body_ok(start, end):
            raise _Refused("info checksum")
        r.pos = end

    def _syncpoint(self, r: _Reader) -> None:
        self.last_sp = r.pos - 8
        end = self._packet(r, SYNCPOINT)
        start = r.pos
        tt = r.v()
        back = self.last_sp - 16 * r.v()
        if back < 0 or r.pos > end or not self._body_ok(start, end):
            raise _Refused("syncpoint")
        r.pos = end
        num, den = self.time_bases[tt % len(self.time_bases)]
        val = tt // len(self.time_bases)
        # ff_nut_reset_ts: the stream's last pts, rounded down
        snum, sden = self.time_base
        self.last_pts = (val * num * sden) // (den * snum)
        self.syncpoints.append((self.last_sp, int(val * (num / den) * 1e6),
                                back))

    def _frame(self, r: _Reader, code: int) -> _Frame:
        """``decode_frame_header`` and ``decode_frame``; raises
        ``_Refused`` where FFmpeg refuses the frame header."""
        if (not self.flags & NUT_PIPE
                and r.pos > self.last_sp + self.max_distance):
            raise _Refused("past max_distance")
        flags, delta, stream, mul, size, res, head = self.codes[code]
        if flags & FLAG_INVALID:
            raise _Refused("invalid frame code")
        if flags & FLAG_CODED:
            flags ^= r.v()
            self.reached.add("coded_flags")
        if flags & FLAG_STREAM_ID and r.v() >= 1:
            raise _Refused("stream id")
        if flags & FLAG_CODED_PTS:
            self.reached.add("coded_pts")
            coded = r.v()
            if coded < 1 << self.msb_shift:
                mask = (1 << self.msb_shift) - 1
                base = self.last_pts - mask // 2
                pts = ((coded - base) & mask) + base
            else:
                pts = coded - (1 << self.msb_shift)
        else:
            pts = self.last_pts + delta
        if flags & FLAG_SIZE_MSB:
            self.reached.add("size_msb")
            size += mul * r.v()
        if flags & FLAG_MATCH_TIME:
            r.s()
        if flags & FLAG_HEADER_IDX:
            head = r.v()
        if flags & FLAG_RESERVED:
            res = r.v()
        if res:
            self.reached.add("reserved_fields")
        for _ in range(res):
            if r.eof:
                raise _Refused("reserved fields")
            r.v()
        if head >= len(self.elided):
            raise _Refused("header index")
        if size > 4096:
            head = 0
        size -= len(self.elided[head])
        if flags & FLAG_CHECKSUM:
            r.be(4)                          # FFmpeg does not check it
            self.reached.add("frame_checksum")
        elif ((not self.flags & NUT_PIPE and size > 2 * self.max_distance)
              or abs(self.last_pts - pts) > self.max_pts_distance):
            raise _Refused("frame without a checksum")
        self.last_pts = pts
        if flags & FLAG_SM_DATA:
            raise Unsupported(f"{self.path}: a NUT frame with side or meta "
                              f"data, which OpenCV's writer does not write; not "
                              f"read by the port ({ITEM_8})")
        if size < 0:
            raise _Refused("frame size")
        if head:
            self.reached.add("elided_header")
        offset = r.pos
        r.pos += size
        cut = r.pos > len(self.data)
        if cut:                 # avio_read falls short: the packet shrinks
            self.reached.add("truncated_frame")
            size = len(self.data) - offset
        return _Frame(offset, size, self.elided[head], pts,
                      bool(flags & FLAG_KEY), cut)

    def _body(self, r: _Reader) -> None:
        """``nut_read_header``'s info packets, then ``nut_read_packet`` to
        the end of the file."""
        while True:
            got = self._find(r.pos)
            if got is None:
                raise ValueError(f"{self.path}: NUT file ends before its "
                                 "video frames")
            r.pos = got[0] + 8
            if got[1] == SYNCPOINT:
                break
            if got[1] == INFO:
                try:
                    self._info(r)
                except _Refused:
                    pass
        self.data_offset = got[0]
        self.last_sp = self.last_pts = self.last_resync = 0
        pending: Optional[int] = SYNCPOINT
        while True:
            pos = r.pos
            tmp, pending = pending, None
            if tmp is None:
                if r.pos >= len(self.data):
                    return
                code = r.u8()
                tmp = 0
                if code == ord("N"):
                    tmp = int.from_bytes(self.data[pos:pos + 8], "big")
                    r.pos = pos + 8
            try:
                if tmp in (MAIN, STREAM):
                    self.reached.add("repeated_headers")
                if tmp in (MAIN, STREAM, INDEX):
                    try:
                        r.pos = self._packet(r, tmp)
                    except _Refused:
                        r.pos -= 1           # avio_skip(bc, -1)
                    continue
                if tmp == INFO:
                    self._info(r)
                    continue
                if tmp == SYNCPOINT:
                    self._syncpoint(r)
                    self.reached.add("syncpoints")
                    code = r.u8()
                elif tmp != 0:
                    raise _Refused("not a startcode")
                fr = self._frame(r, code)
            except _Refused:
                self.reached.add("resync")
                got = self._find(max(self.last_sp, self.last_resync) + 1)
                if got is None:
                    return
                r.pos = self.last_resync = got[0] + 8
                pending = got[1]
                continue
            self.frames_.append(fr)
            if fr.cut:
                return

    # ---- the index

    def _index(self) -> None:
        """``find_and_decode_index``: FFmpeg's seek index and duration."""
        data = self.data
        if len(data) < 12:
            return
        at = len(data) - struct.unpack(">Q", data[-12:-4])[0]
        if not 0 <= at <= len(data) - 8 or int.from_bytes(
                data[at:at + 8], "big") != INDEX:
            return
        r = _Reader(data, at + 8)
        try:
            end = self._packet(r, INDEX)
        except _Refused:
            return
        start = r.pos
        n_tb = len(self.time_bases)
        max_pts = r.v()
        count = r.v()
        if not 0 < count < (1 << 31) // 8:
            return
        sps, acc = [], 0
        for _ in range(count):
            d = r.v()
            if d <= 0:
                return
            acc += d
            sps.append(acc)
        entries = []
        has = [0] * (count + 1)
        last_pts, j = -1, 0
        while j < count:
            x = r.v()
            typ, x, n = x & 1, x >> 1, j
            if typ:
                flag, x = x & 1, x >> 1
                if n + x >= count + 1:
                    return
                for _ in range(x):
                    has[n] = flag
                    n += 1
                has[n] = 1 - flag
                n += 1
            else:
                if x <= 1:
                    return
                while x != 1:
                    if n >= count + 1:
                        return
                    has[n] = x & 1
                    x >>= 1
                    n += 1
            if has[0]:
                return
            while j < n and j < count:
                if has[j]:
                    a = r.v()
                    b = 0
                    if not a:
                        a, b = r.v(), r.v()
                    entries.append((last_pts + a, 16 * sps[j - 1]))
                    last_pts += a + b
                j += 1
        if r.pos > end or not self._body_ok(start, end):
            return
        num, den = self.time_bases[max_pts % n_tb]
        v = max_pts // n_tb
        # av_rescale_q to µs, rounded to nearest
        self.max_pts = (v * num * 1000000 + den // 2) // den
        self.index = sorted(set(entries))

    # ---- what cv2 reports

    def _codec(self) -> str:
        tag = self.fourcc
        self.tag = _AVI_NAME.get(tag, tag.decode("latin1"))
        return codec_of(self.tag, self.path)

    @property
    def fps(self) -> float:
        """``CAP_PROP_FPS`` (see the module's notes)."""
        if self.rate is None or not self.rate[0]:
            raise Unsupported(f"{self.path}: a NUT stream without an "
                              f"r_frame_rate info field, whose frame rate "
                              f"FFmpeg guesses from the packets; not read by "
                              f"the port ({ITEM_8})")
        tnum, tden = self.time_base
        rnum, rden = self.rate
        dur = (rden * tden) // (rnum * tnum)
        if dur <= 0:
            raise Unsupported(f"{self.path}: frames shorter than the NUT "
                              f"time base ({ITEM_8})")
        num, den = av_reduce(tden, dur * tnum, 60000)
        best, best_fps = 0.01, 0
        for j in range(_N_STD):
            err = abs((num / den) / (std_rate(j) / (12 * 1001)) - 1)
            if err < best:
                best, best_fps = err, std_rate(j)
        if best_fps:
            num, den = av_reduce(best_fps, 12 * 1001, (1 << 31) - 1)
        return num / den

    @property
    def duration_us(self) -> int:
        """FFmpeg's duration in µs: the index's max_pts, else the time of
        the last syncpoint."""
        if self.max_pts is not None:
            return self.max_pts
        return self.syncpoints[-1][1] if self.syncpoints else 0

    @property
    def frames(self) -> int:
        """``CAP_PROP_FRAME_COUNT``: the duration times fps, rounded."""
        return int(self.duration_us / 1e6 * self.fps + 0.5)

    def number(self, i: int) -> int:
        """OpenCV's frame number of frame ``i`` (``dts_to_frame_number`` of
        its pts)."""
        num, den = self.time_base
        return int(self.fps * ((self.pts[i] - self.start_time) * (num / den))
                   + 0.5)

    def ticks(self, frame: int) -> int:
        """The time OpenCV's seek asks FFmpeg for at frame ``frame``."""
        num, den = self.time_base
        return self.start_time + int(frame / self.fps / (num / den) + 0.5)

    def landing(self, ts: int) -> Optional[int]:
        """The frame reading starts from after ``read_seek`` to ``ts`` with
        ``AVSEEK_FLAG_BACKWARD``: the first key frame after the syncpoint
        FFmpeg lands on (None where no key frame follows: no frame is
        read).  With an index, the syncpoint of its last entry at or
        before ``ts`` (else its first); without one, FFmpeg's syncpoint
        search: the last syncpoint at or before the time (else the first),
        then the syncpoint its ``back_ptr`` names."""
        if self.index:
            stamps = [t for t, _ in self.index]
            j = max(bisect_right(stamps, ts) - 1, 0)
            got = self._find(self.index[j][1], SYNCPOINT)
            if got is None:
                return None
            pos = got[0]
        else:
            if not self.syncpoints:
                return None
            num, den = self.time_base
            us = int(ts * (num / den) * 1e6)
            j = max(bisect_right([t for _, t, _ in self.syncpoints], us) - 1,
                    0)
            got = self._find(max(self.syncpoints[j][2] - 15, 0), SYNCPOINT)
            if got is None:
                return None
            pos = got[0]
        for i, fr in enumerate(self.frames_):
            if fr.offset > pos and fr.key:
                return i
        return None

    @property
    def features(self) -> List[str]:
        """What the file reaches of the demuxer, by name (``FEATURES``)."""
        return [name for name in FEATURES if name in self.reached]

    def sample(self, f: BinaryIO, i: int) -> bytes:
        """Frame ``i``'s bytes; a frame cut short by the end of the file
        as far as it goes (:meth:`is_cut`), as FFmpeg hands it over."""
        fr = self.frames_[i]
        return fr.head + self.data[fr.offset:fr.offset + fr.size]

    def is_cut(self, i: int) -> bool:
        """Whether the end of the file fell inside frame ``i``."""
        return self.frames_[i].cut


# ----------------------------------------------------------------- writer

def _v(val: int) -> bytes:
    """``put_v``: 7 bits a byte, most significant first, the top bit set
    on all but the last."""
    out = [val & 127]
    val >>= 7
    while val:
        out.append(128 | (val & 127))
        val >>= 7
    return bytes(reversed(out))


def _s(val: int) -> bytes:
    """``put_s``: 0, 1, -1, 2, -2, ... as 0, 1, 2, 3, 4, ..."""
    return _v(2 * abs(val) - (val > 0))


def _vstr(text: bytes) -> bytes:
    return _v(len(text)) + text


def _packet(startcode: int, body: bytes) -> bytes:
    """``put_packet``: the startcode, the forward pointer (with its own
    CRC past 4096 bytes), the body and its CRC-32."""
    head = struct.pack(">Q", startcode) + _v(len(body) + 4)
    if len(body) + 4 > 4096:
        head += struct.pack(">I", crc(head))
    return head + body + struct.pack(">I", crc(body))


# nutenc.c's MAX_DISTANCE, and the elision headers build_elision_headers
# lists (the muxer never elides a video frame's bytes with them)
_WRITE_DISTANCE = 1024 * 32 - 1
_ELISION = (b"\x00\x00\x01", b"\x00\x00\x01\xb6", b"\xff\xfa", b"\xff\xfb",
            b"\xff\xfc", b"\xff\xfd")


def _choose_timebase(num: int, den: int, precision: int = 48000
                     ) -> Tuple[int, int]:
    """``ff_choose_timebase(s, st, 48000)`` on the stream's time base
    num/den (the frame period): drop small factors of the numerator, then
    double the denominator, until it counts ``precision`` ticks a
    second."""
    j = 2
    while j < 14:
        while den // num < precision and num % j == 0:
            num //= j
        j += 1 + (j > 2)
    while den // num < precision and den < 1 << 24:
        den <<= 1
    return num, den


class NutWriter:
    """MPEG-4 Part 2 samples → a ``.nut`` file laid out as FFmpeg's nut
    muxer (``nutenc.c``) lays out one video stream for ``cv2.VideoWriter``:
    the file ID string; the main header (version 3, ``max_distance``
    32767, the time base ``ff_choose_timebase`` picks from the frame
    period, the frame-code table ``build_frame_code`` makes for a video
    stream whose frames last a whole number of ticks, the six elision
    headers); the stream header (fourcc ``mp4v``, ``msb_pts_shift`` 14,
    the VOS/VOL headers as the codec-specific data); the stream's info
    packet with its ``r_frame_rate``; a syncpoint before each key frame
    that follows another frame and wherever the next frame would end
    ``max_distance`` past the last one, its back pointer to the syncpoint
    the stream's last key frame before it follows; each frame under code 1
    with its flags, pts and size coded (a checksum past twice
    ``max_distance``); and at :meth:`release` the index packet
    (``write_index``: ``max_pts``, the syncpoints, the key frames' runs
    one syncpoint behind) and its pointer."""

    def __init__(self, path: str, size: Tuple[int, int],
                 rate: Tuple[int, int], dsi: bytes):
        self.w, self.h = size
        num, den = rate                       # frames a second, num/den
        self.tb = _choose_timebase(den, num)
        self.step = den * self.tb[1] // (num * self.tb[0])
        if self.step * num * self.tb[0] != den * self.tb[1]:
            raise ValueError(f"frame rate {num}/{den} has no whole tick "
                             "count in its NUT time base")
        self.rate = rate
        self.n = 0
        self.max_pts = 0
        self.syncpoints: List[int] = []       # their positions
        self.key_index: List[Tuple[int, int]] = []  # (pts, syncpoint pos)
        self.key_pts: dict = {}               # syncpoint number -> pts
        self.last_key = False
        self.last_pts = 0
        self._f: Optional[BinaryIO] = open(path, "wb")
        self._f.write(ID_STRING + self._headers(dsi))
        self.pos = self._f.tell()

    def _codes(self) -> List[Tuple[int, int, int, int, int]]:
        """``build_frame_code`` for one video stream: (flags, pts_delta,
        size_mul, size_lsb, stream id) of the 256 codes."""
        codes = [(FLAG_INVALID, 0, 0, 0, 0), (FLAG_CODED, 1, 1, 0, 0),
                 (FLAG_SIZE_MSB | FLAG_CODED_PTS, 0, 1, 0, 0),
                 (FLAG_KEY | FLAG_SIZE_MSB | FLAG_CODED_PTS, 0, 1, 0, 0),
                 (FLAG_KEY | FLAG_SIZE_MSB, self.step, 1, 0, 0)]
        codes += [(FLAG_SIZE_MSB, self.step, 249, k, 0) for k in range(249)]
        codes.insert(ord("N"), (FLAG_INVALID, 0, 0, 0, 0))
        return codes + [(FLAG_INVALID, 0, 0, 0, 0)]

    def _main_body(self) -> bytes:
        out = bytearray(_v(3) + _v(1) + _v(_WRITE_DISTANCE) + _v(1)
                        + _v(self.tb[0]) + _v(self.tb[1]))
        codes = self._codes()
        pts, mul, stream, lsb = 0, 1, 0, 0
        i = 0
        while i < 256:
            flags_i, pts_i, mul_i, lsb_i, stream_i = codes[i]
            fields = 0
            if pts != pts_i:
                fields = 1
            if mul_i != mul:
                fields = 2
            if stream_i != stream:
                fields = 3
            if lsb_i != 0:
                fields = 4
            pts, flags, stream, mul, lsb = pts_i, flags_i, stream_i, mul_i, \
                lsb_i
            j = 0
            while i < 256:
                if i == ord("N"):
                    i += 1
                    continue
                if codes[i] != (flags, pts, mul, lsb + j, stream):
                    break
                i += 1
                j += 1
            if j != mul - lsb:
                fields = 6
            out += _v(flags) + _v(fields)
            for k, val in enumerate((_s(pts), _v(mul), _v(stream), _v(lsb),
                                     _v(0), _v(j))):
                if fields > k:
                    out += val
        out += _v(len(_ELISION))
        for head in _ELISION:
            out += _vstr(head)
        return bytes(out)

    def _headers(self, dsi: bytes) -> bytes:
        stream = (_v(0) + _v(0) + _vstr(b"mp4v") + _v(0) + _v(14)
                  + _v(max(self.tb) // self.tb[0]) + _v(0) + b"\0"
                  + _vstr(dsi) + _v(self.w) + _v(self.h) + _v(0) + _v(0)
                  + _v(0))
        rate = f"{self.rate[0]}/{self.rate[1]}".encode()
        info = (_v(1) + _v(0) + _v(0) + _v(0) + _v(1)
                + _vstr(b"r_frame_rate") + _s(-1) + _vstr(rate))
        return (_packet(MAIN, self._main_body()) + _packet(STREAM, stream)
                + _packet(INFO, info))

    def write(self, sample: bytes, key: bool) -> None:
        pts = self.n * self.step
        if (key and not self.last_key) or not self.syncpoints or (
                len(sample) + 30 + self.pos
                >= self.syncpoints[-1] + _WRITE_DISTANCE):
            earlier = [at for t, at in self.key_index if t <= pts]
            back = (self.pos - earlier[-1]) >> 4 if earlier else 0
            self.syncpoints.append(self.pos)
            self._put(_packet(SYNCPOINT, _v(pts) + _v(back)))
            self.last_pts = pts                 # ff_nut_reset_ts
        flags = FLAG_SIZE_MSB | FLAG_CODED_PTS | (FLAG_KEY if key else 0)
        if len(sample) > 2 * _WRITE_DISTANCE or \
                abs(pts - self.last_pts) > max(self.tb) // self.tb[0]:
            flags |= FLAG_CHECKSUM
        # the pts's 14 low bits, or the pts plus 2^14 where ff_lsb2full
        # would read those bits as another pts
        mask = (1 << 14) - 1
        delta = self.last_pts - mask // 2
        coded = pts & mask
        if ((coded - delta) & mask) + delta != pts:
            coded = pts + (1 << 14)
        head = bytes((1,)) + _v(flags) + _v(coded) + _v(len(sample))
        if flags & FLAG_CHECKSUM:
            head += struct.pack(">I", crc(head))
        self._put(head + sample)
        if key:
            self.key_index.append((pts, self.syncpoints[-1]))
            self.key_pts.setdefault(len(self.syncpoints), pts)
        self.last_key = key
        self.last_pts = self.max_pts = pts
        self.n += 1

    def _put(self, data: bytes) -> None:
        self._f.write(data)
        self.pos += len(data)

    def _index(self) -> bytes:
        """``write_index``'s body."""
        count = len(self.syncpoints)
        out = bytearray(_v(self.max_pts) + _v(count))
        last = 0
        for at in self.syncpoints:
            out += _v((at >> 4) - (last >> 4))
            last = at
        keys = [self.key_pts.get(j) for j in range(count)]
        last_pts, j = -1, 0
        while j < count:
            flag = (keys[j] is not None) ^ (j + 1 == count)
            n = 0
            while j < count and (keys[j] is not None) == flag:
                n += 1
                j += 1
            out += _v(1 + 2 * flag + 4 * n)
            for k in range(j - n, min(j + 1, count)):
                if keys[k] is None:
                    continue
                out += _v(keys[k] - last_pts)
                last_pts = keys[k]
            j += 1
        size = len(out) + 8 + 4
        out += struct.pack(">Q", 8 + size + (size.bit_length() - 1) // 7
                           + 1 + 4 * (size > 4096))
        return bytes(out)

    def release(self) -> None:
        f, self._f = self._f, None
        if f is None:
            return
        try:
            if self.syncpoints:
                f.write(_packet(INDEX, self._index()))
        finally:
            f.close()
