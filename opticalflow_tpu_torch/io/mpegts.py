"""MPEG transport streams (``.ts``, ``.m2ts``, ``.mts``, ``.m2t``): the
demuxer of the port's video path, and the muxer of its MPEG-4 Part 2
output (:class:`TsWriter`), in Python (no FFmpeg).

:class:`MpegTsFile` reads a transport stream as FFmpeg's ``mpegts``
demuxer reads it for ``cv2.VideoCapture``:

  * the packet size as its probe finds it (``get_packet_size``): 188, 192
    (M2TS, a 4-byte ``TP_extra_header`` before each packet) or 204 (16
    bytes of FEC after each), from the first sync byte;
  * adaptation fields and stuffing, the PAT, the first program's PMT and
    the first elementary stream whose ``stream_type`` is video: 0x01 and
    0x02 (MPEG-1/2 video; FFmpeg reads MPEG-1 under either) decoded by
    ``runtime/mpeg12``, 0x10 (MPEG-4 Part 2) by ``runtime/mpeg4``, 0xD1
    (Dirac/VC-2, what FFmpeg's muxer writes with a ``drac`` registration
    descriptor) by ``runtime/dirac``, its PES payloads split at parse
    units and its rate the sequence header's, 0x1B (H.264) by
    ``runtime/h264``, split into access units as FFmpeg's h264 parser
    splits them, its rate the VUI's timing (else fitted to the DTS); an
    MPEG-2 payload under 0x1B as FFmpeg's probe reads it
    (``MpegTsFile._probe_payload``: the first two PES packets through the
    h264 parser, then MPEG-2, its decoder concealing what they cut).  Other
    video (HEVC 0x24, ...) raises ``Unsupported`` naming its
    type; a stream with no video (H.263 or FFV1 muxed as private data,
    0x06, which cv2 does not open either) raises too;
  * PES packets reassembled over ``payload_unit_start_indicator``, bounded
    or unbounded (``PES_packet_length`` 0), with PTS and DTS; a
    continuity-counter gap only marks FFmpeg's packet corrupt, its bytes
    are kept (``gaps`` counts them);
  * pictures split and stamped as ``io/mpegpes`` does for program
    streams.

fps, the frame count and seeks are ``cv2.VideoCapture``'s: OpenCV reports
the stream's ``avg_frame_rate`` where FFmpeg set one, else its
``r_frame_rate``.  An MPEG-2 stream's time base is unreliable to FFmpeg
(``tb_unreliable``), which then analyses the stream and sets both to the
sequence's rate; MPEG-1 and MPEG-4 are not, so FFmpeg sets neither from
the packets and ``r_frame_rate`` is the codec's rate, doubled for MPEG-1
(its ``AV_CODEC_PROP_FIELDS``): MPEG-1 at 25 Hz reads at 50 fps.  The
count is FFmpeg's PTS duration estimate (``mpegpes.duration_frames``) times
that rate.  A ``CAP_PROP_POS_FRAMES`` seek goes through
``ff_seek_frame_binary``: :meth:`MpegTsFile.seek` reproduces its search
(``ff_gen_search`` over ``mpegts_get_dts``, the index it builds, the DTS
``compute_pkt_fields`` leaves a picture whose PES header carries a PTS
alone) for ``io/video``'s seek.
"""

from __future__ import annotations

import mmap
import os
import struct
from bisect import bisect_left, bisect_right
from fractions import Fraction
from typing import BinaryIO, Dict, Optional, Tuple

from opticalflow_tpu_torch.io.mpegpes import (TIME_BASE, Pes, PesVideo,
                                              duration_frames,
                                              mpeg4_vol_rate, put_timestamp,
                                              timestamp)
from opticalflow_tpu_torch.io.mkv import _N_STD, _rfps, std_rate
from opticalflow_tpu_torch.io.nut import crc
from opticalflow_tpu_torch.runtime.dirac import \
    sequence_info as dirac_sequence
from opticalflow_tpu_torch.runtime.h264 import probe as h264_probe
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
from opticalflow_tpu_torch.runtime.mpeg12 import sequence_info

__all__ = ["MpegTsFile", "TsWriter", "EXTENSIONS", "TIME_BASE",
           "packet_size"]

EXTENSIONS = (".ts", ".m2ts", ".mts", ".m2t")
_SYNC, _PACKET = 0x47, 188
_PROBE, _MARGIN = 8192, 8            # PROBE_PACKET_MAX_BUF, _MARGIN
_VIDEO = {0x01: "mpeg12", 0x02: "mpeg12", 0x10: "mpeg4", 0xD1: "dirac",
          0x1B: "h264"}
_OTHER_VIDEO = {0x20: "H.264 (MVC)", 0x24: "HEVC",
                0x33: "VVC", 0x21: "JPEG 2000", 0x42: "CAVS",
                0xD1: "Dirac", 0xD2: "AVS2", 0xD4: "AVS3", 0xEA: "VC-1"}
_NOT_SEEN = -1


def _analyze(buf: bytes, size: int) -> int:
    """FFmpeg's ``analyze``: how well sync bytes line up at ``size``."""
    stat = [0] * size
    best = total = 0
    i = buf.find(b"\x47")
    while 0 <= i < len(buf) - 3:
        x = i % size
        stat[x] += 1
        total += 1
        best = max(best, stat[x])
        i = buf.find(b"\x47", i + 1)
    return best - max(total - 10 * best, 0) // 10


def packet_size(head: bytes) -> Optional[int]:
    """The raw packet size FFmpeg's ``get_packet_size`` finds in a file's
    first bytes: 188, 192 or 204; None where none scores."""
    buf = head[:_PROBE]
    score, dvhs, fec = (_analyze(buf, n) for n in (188, 192, 204))
    margin = sorted((score, fec, dvhs))[1]
    if len(buf) < _PROBE:
        margin += _MARGIN
    if score > margin:
        return 188
    if dvhs > margin:
        return 192
    if fec > margin:
        return 204
    return None


class MpegTsFile(PesVideo):
    """The first video stream of an MPEG transport stream: one sample a
    picture, with its type, PTS and DTS (where a PES packet gave them) and
    the file ranges it is read from."""

    def __init__(self, path: str):
        super().__init__(path)
        self.size = os.path.getsize(path)
        self.pid: Optional[int] = None
        self.stream_type = 0
        self.gaps = 0
        self._refused = ""
        with open(path, "rb") as f:
            head = f.read(_PROBE)
            first = head.find(b"\x47")
            self.raw = packet_size(head[first:]) if first >= 0 else None
            if self.raw is None:
                raise ValueError(f"{path}: not an MPEG transport stream (no "
                                 "run of sync bytes)")
            self.pos47 = first % self.raw
            with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
                self._packets(mm, first)
                if not self.pes:
                    raise ValueError(f"{path}: no PES packet of the video "
                                     f"stream (PID 0x{self.pid:x})")
                self.codec = _VIDEO[self.stream_type]
                if self.codec == "h264":
                    self._probe_payload(mm)
                self._split(mm)
            if not self.starts:
                raise ValueError(f"{path}: no picture in its video stream "
                                 "(truncated file?)")
            sample = self.sample(f, 0)
        if self.codec == "mpeg12":
            seq = sequence_info(sample, path)
            if seq is None:
                raise ValueError(f"{path}: MPEG-1/2 video without a "
                                 "sequence header")
            self.width, self.height, self.mpeg2 = (seq.width, seq.height,
                                                   seq.mpeg2)
            self.rate = seq.fps
        elif self.codec == "dirac":
            info = dirac_sequence(sample, path)
            if info is None:
                raise ValueError(f"{path}: Dirac video without a sequence "
                                 "header")
            self.width, self.height, self.mpeg2 = info.width, info.height, False
            self.rate = Fraction(*info.rate)
        elif self.codec == "h264":
            info = h264_probe(sample, path)
            if info is None:
                raise ValueError(f"{path}: H.264 video without an SPS before "
                                 "its first picture")
            self.width, self.height, self.mpeg2 = info.width, info.height, False
            # the VUI's timing where it has one, else none (fitted)
            self.rate = info.fps or Fraction(0)
            self.reorder = info.reorder or 0
        else:
            self.mpeg2 = False
            self.width = self.height = 0       # the decoder reads the VOL
            rate = mpeg4_vol_rate(sample)
            if rate is None:
                raise ValueError(f"{path}: MPEG-4 video without a VOL")
            self.rate = rate
        self.keyframes = [i for i, t in enumerate(self.types) if t == 1] or [0]
        # compute_pkt_fields' delay: the decoder's has_b_frames (MPEG-1/2:
        # the sequence is not low delay; MPEG-4: the parser saw a B-VOP)
        self.delay = (not seq.low_delay if self.codec == "mpeg12"
                      else self.reorder > 0 if self.codec == "h264"
                      else 3 in self.types)
        # the parsed packets mpegts_get_dts reads, in file order: (pos of
        # the PES packet the picture starts in, PTS, DTS, B-picture)
        starts = self._es_starts
        self._parsed = [
            (self.pes[j if j is not None else
                      bisect_right(starts, self.pictures[i]) - 1].pos,
             self.pts[i], self.dts[i], self.types[i] == 3)
            for i, j in enumerate(self.owner)]
        self._seek_pos = [p for p, _, _, _ in self._parsed]

    def _probe_payload(self, mm) -> None:
        """FFmpeg's probe of a stream labelled H.264 (0x1B) whose payload is
        MPEG-2 video (a sequence header and its extension first, which
        h264_probe refuses and mpegvideo's accepts): FFmpeg runs its h264
        parser over the first two PES packets, then switches the stream to
        MPEG-2 and its parser (``PesVideo.h264_head``); the pictures the
        first packets held come to its MPEG-2 decoder cut up, which conceals
        them.  Shown where each of the first two PES packets carries a DTS
        other than its PTS; where one does not (a low-delay stream, PTS
        alone, a packet without timestamps) FFmpeg switches nothing and cv2
        reads no frame, and the port, decoding H.264, raises.  MPEG-1 and
        MPEG-4 payloads under 0x1B are refused."""
        if len(self.pes) < 2 or any(p.dts is None or p.dts == p.pts
                                    for p in self.pes[:2]):
            return
        data = self.pes[0].read(mm, 0, 64).lstrip(b"\0")
        if not data.startswith(b"\x00\x00\x01\xb3") and not data.startswith(
                b"\x01\xb3"):
            return
        i = data.find(b"\x00\x00\x01\xb5")
        if i < 0 or i + 4 >= len(data) or data[i + 4] >> 4 != 1:
            raise Unsupported(
                f"{self.path}: MPEG-1 video under stream_type 0x1b (H.264), "
                f"which FFmpeg's probe reads as MPEG video; not read by the "
                f"port ({ITEM_8})")
        self.codec = "mpeg12"
        self.h264_head = 2

    # ------------------------------------------------------------ packets

    def _packets(self, mm, first: int) -> None:
        """Walk the packets: PAT, the PMT, the video PID's PES packets."""
        raw, size = self.raw, self.size
        sections: Dict[int, bytearray] = {}
        pmt_pid: Optional[int] = None
        last_cc: Dict[int, int] = {}
        pes: Optional[Pes] = None
        head = bytearray()              # a PES header not yet complete
        es = 0
        pos = first
        while pos + _PACKET <= size:
            if mm[pos] != _SYNC:
                nxt = mm.find(b"\x47", pos + 1)
                if nxt < 0:
                    break
                pos = nxt                       # resync
                continue
            p1, p2, p3 = mm[pos + 1], mm[pos + 2], mm[pos + 3]
            pid = (p1 & 0x1F) << 8 | p2
            start = bool(p1 & 0x40)
            afc = p3 >> 4 & 3
            at = pos
            pos += raw
            if afc == 0:
                continue
            body = at + 4
            disc = False
            if afc & 2:
                n = mm[body]
                disc = n > 0 and bool(mm[body + 1] & 0x80)
                body += n + 1
            cc = p3 & 0xF
            if pid != 0x1FFF:
                prev = last_cc.get(pid, _NOT_SEEN)
                want = (prev + 1) & 0xF if afc & 1 else prev
                if not (disc or prev == _NOT_SEEN or want == cc):
                    if pid == self.pid:
                        self.gaps += 1       # FFmpeg: AV_PKT_FLAG_CORRUPT
                last_cc[pid] = cc
            end = at + _PACKET
            if not afc & 1 or body >= end:
                continue
            if pid == 0 or pid == pmt_pid:
                if self.pid is None:
                    found = self._section(pid, sections, mm[body:end], start)
                    if found is not None and pid == 0:
                        pmt_pid = found
                continue
            if pid != self.pid:
                continue
            if start:
                if pes is not None and pes.size:
                    self.pes.append(pes)
                    es += pes.size
                pes, head = None, bytearray()
                pes_pos = at
            elif pes is None and not head:
                continue                        # skip until a PES header
            if pes is None:
                head += mm[body:end]
                got = self._pes_header(head, pes_pos, es)
                if got is None:
                    continue
                if got is False:
                    head = bytearray()
                    continue
                pes, skip = got
                pes.add(end - (len(head) - skip), len(head) - skip)
                head = bytearray()
            else:
                pes.add(body, end - body)
        if pes is not None and pes.size:
            self.pes.append(pes)
        if self.pid is None:
            raise Unsupported(f"{self.path}: no video stream FFmpeg reads "
                              f"in its PMT{self._refused or ''} (OpenCV opens "
                              f"none either; {ITEM_8})")

    def _pes_header(self, head: bytearray, pos: int, es: int):
        """A PES packet from its header bytes gathered so far: (the Pes,
        the header's length), None while more are needed, False for bytes
        that are no PES header (FFmpeg skips to the next)."""
        if len(head) < 9:
            return None
        if head[:3] != b"\x00\x00\x01":
            return False
        hl = head[8]
        if len(head) < 9 + hl:
            return None
        pts = dts = None
        flags = head[7] >> 6
        if flags & 2 and hl >= 5:
            pts = dts = timestamp(head, 9)
            if flags & 1 and hl >= 10:
                dts = timestamp(head, 14)
        return Pes(pos, es, pts, dts), 9 + hl

    def _section(self, pid: int, sections: Dict[int, bytearray],
                 data: bytes, start: bool) -> Optional[int]:
        """Gather a PSI section; a whole PAT gives the first program's PMT
        PID, a whole PMT picks the video stream (None otherwise)."""
        if start:
            if not data:
                return None
            data = data[1 + data[0]:]           # pointer_field
            sections[pid] = bytearray(data)
        elif pid in sections:
            sections[pid] += data
        else:
            return None
        sec = sections[pid]
        if len(sec) < 3:
            return None
        n = (sec[1] & 0x0F) << 8 | sec[2]
        if len(sec) < 3 + n:
            return None
        del sections[pid]
        body = bytes(sec[8:3 + n - 4])          # past the header, no CRC
        if pid == 0 and sec[0] == 0x00:
            for k in range(0, len(body) - 3, 4):
                program = body[k] << 8 | body[k + 1]
                if program:
                    return (body[k + 2] & 0x1F) << 8 | body[k + 3]
            return None
        if sec[0] != 0x02 or len(body) < 4:
            return None
        k = 4 + ((body[2] & 0x0F) << 8 | body[3])
        refused = []
        while k + 5 <= len(body):
            st = body[k]
            es_pid = (body[k + 1] & 0x1F) << 8 | body[k + 2]
            k += 5 + ((body[k + 3] & 0x0F) << 8 | body[k + 4])
            if st in _VIDEO:
                self.pid, self.stream_type = es_pid, st
                return None
            if st in _OTHER_VIDEO:
                raise Unsupported(
                    f"{self.path}: {_OTHER_VIDEO[st]} video (stream_type "
                    f"0x{st:02x}) in a transport stream: the port reads "
                    f"MPEG-1, MPEG-2 and MPEG-4 Part 2 there ({ITEM_8})")
            refused.append(f"0x{st:02x}")
        self._refused = (f" (stream types {', '.join(refused)}: 0x06 is "
                         "private data, as FFmpeg muxes H.263 or FFV1)"
                         if refused else "")
        return None

    # ------------------------------------------------------------- public

    @property
    def r_frame_rate(self) -> Fraction:
        """FFmpeg's ``r_frame_rate``: the codec's rate where its time base
        is reliable (``tb_unreliable``: a frame of 1/5 s to 1/101 s, MPEG-1
        counted in fields), doubled for MPEG-1; else the rate it fits to
        the timestamps, the stream's own."""
        if self.codec == "mpeg12" and not self.mpeg2:
            fields = 2 * self.rate
            if 5 <= fields < 101:
                return fields
        if self._fitted is not None:
            return self._fitted[0]
        return Fraction(self.rate)

    @property
    def _fitted(self) -> Optional[Tuple[Fraction, Fraction]]:
        """(r_frame_rate, avg_frame_rate) FFmpeg fits to the PES packets'
        PTS where an MPEG-4 VOL gives a rate it does not trust (a VOL
        without a fixed VOP rate gives its time resolution a second, as
        FFmpeg's and the port's encoders write at 30000/1001); None where
        it trusts the VOL's."""
        if self.codec not in ("mpeg4", "h264") or 5 <= self.rate < 101:
            return None
        # ff_rfps_add_frame and the average read decode times (B pictures'
        # presentation times go back and forth)
        times = [p.dts for p in self.pes if p.dts is not None]
        fit = _rfps(times, 1 / TIME_BASE)
        if fit is None or times[-1] <= times[0]:
            return None
        avg = Fraction(len(times) - 1) * TIME_BASE / (times[-1] - times[0])
        best, err = avg, 0.01
        for j in range(_N_STD):
            std = Fraction(std_rate(j), 12 * 1001)
            e = abs(float(avg / std) - 1)
            if e < err:
                best, err = std, e
        return Fraction(*fit), best

    @property
    def fps(self) -> float:
        """``CAP_PROP_FPS``: ``avg_frame_rate`` where FFmpeg analysed the
        stream (an unreliable time base), else ``r_frame_rate``."""
        if self._fitted is not None:
            return float(self._fitted[1])
        return float(self.r_frame_rate)

    @property
    def frames(self) -> int:
        """``CAP_PROP_FRAME_COUNT``: FFmpeg's duration estimate from the PES
        packets' PTS at ``r_frame_rate``, times the rate."""
        return duration_frames(self.start_time,
                               [p.pts for p in self.pes if p.pts is not None],
                               self.r_frame_rate, self.fps)

    # -------------------------------------------------------------- seeks

    def _read_ts(self, pos: int, limit: Optional[int],
                 index: Dict[int, Tuple[int, int]]) -> Optional[Tuple[int, int]]:
        """``mpegts_get_dts``: from ``pos`` rounded up to a packet, the first
        parsed packet with a DTS (its (pos, DTS)), added to ``index``; None
        at the end, or where the packet boundary is at ``limit`` or past.

        The DTS is the one ``compute_pkt_fields`` leaves after the flush
        each call starts with: with a decoding delay, an I- or P-picture
        whose PES header carries a PTS alone (DTS = PTS) has its DTS taken
        away and replaced by the PTS of the last I- or P-picture read
        since the flush (none for the first: that picture is passed over);
        a B-picture's DTS is its PTS."""
        raw = self.raw
        aligned = (pos + raw - 1 - self.pos47) // raw * raw + self.pos47
        if limit is not None and aligned >= limit:
            return None
        last_ip = None
        for p, pts, dts, b in self._parsed[bisect_left(self._seek_pos,
                                                       aligned):]:
            delayed = self.delay and not b
            if delayed and dts is not None and dts == pts:
                dts = None
            if delayed or (pts is not None and dts is not None and pts > dts):
                if dts is None:
                    dts = last_ip
                last_ip = pts
            else:
                dts = pts if pts is not None else dts
            if dts is not None:
                index[dts] = p    # av_add_index_entry: one entry a timestamp
                return p, dts
        return None

    def _last_ts(self, index) -> Optional[Tuple[int, int]]:
        """``ff_find_last_ts``: (pos, DTS) of the last parsed packet."""
        step, pos_max = 1024, self.size - 1
        while True:
            limit = pos_max
            pos_max = max(0, pos_max - step)
            got = self._read_ts(pos_max, limit, index)
            step += step
            if got is not None or not 2 * limit > step:
                break
        if got is None:
            return None
        while True:
            nxt = self._read_ts(got[0] + 1, None, index)
            if nxt is None:
                break
            got = nxt
            if got[0] >= self.size:
                break
        return got

    def seek(self, target: int, index: Dict[int, int]) -> Optional[int]:
        """``av_seek_frame(..., AVSEEK_FLAG_BACKWARD)`` to the 90 kHz time
        ``target`` (``ff_seek_frame_binary``): the stream offset reading
        starts at afterwards (that of the PES packet the search lands on),
        or None where FFmpeg's search fails (reading goes on from where the
        search left the file: at its end).  ``index`` is the
        demuxer's index {DTS: pos}, which each search adds to and the next
        starts from, as FFmpeg's does within one capture."""
        pos_min = pos_max = 0
        ts_min = ts_max = None
        pos_limit = -1
        if index:
            stamps = sorted(index)
            j = max(bisect_right(stamps, target) - 1, 0)
            if stamps[j] <= target or index[stamps[j]] == 0:
                pos_min, ts_min = index[stamps[j]], stamps[j]
            j = bisect_left(stamps, target)
            if j < len(stamps):
                ts_max = stamps[j]
                pos_max = pos_limit = index[ts_max]
        # ff_gen_search
        if ts_min is None:
            got = self._read_ts(0, None, index)
            if got is None:
                return None
            pos_min, ts_min = got
        if ts_min >= target:
            return self._sample_at(pos_min)
        if ts_max is None:
            got = self._last_ts(index)
            if got is None:
                return None
            pos_max, ts_max = got
            pos_limit = pos_max
        if ts_max <= target:
            return self._sample_at(pos_max)
        no_change = 0
        while pos_min < pos_limit:
            if no_change == 0:
                gap = pos_max - pos_limit
                num = (target - ts_min) * (pos_max - pos_min)
                den = ts_max - ts_min
                pos = (num + den // 2) // den + pos_min - gap   # av_rescale
            elif no_change == 1:
                pos = (pos_min + pos_limit) >> 1
            else:
                pos = pos_min
            if pos <= pos_min:
                pos = pos_min + 1
            elif pos > pos_limit:
                pos = pos_limit
            start_pos = pos
            got = self._read_ts(pos, None, index)
            if got is None:
                return None                 # "read_timestamp() failed"
            pos, ts = got
            no_change = no_change + 1 if pos == pos_max else 0
            if target <= ts:
                pos_limit, pos_max, ts_max = start_pos - 1, pos, ts
            if target >= ts:
                pos_min, ts_min = pos, ts
        return self._sample_at(pos_min)

    def _sample_at(self, pos: int) -> int:
        """The stream offset reading from the file position ``pos`` starts
        at: the first PES packet beginning there or later (the demuxer
        skips to the next PES header)."""
        j = bisect_left([p.pos for p in self.pes], pos)
        return self.pes[j].es if j < len(self.pes) else self.ends[-1]


# ----------------------------------------------------------------- writer

_PCR_HZ = 27_000_000
_DELAY = 63000                 # max_delay, 0.7 s in 90 kHz ticks
_PAT_PERIOD = _PCR_HZ // 10    # 0.1 s


def _section(table_id: int, ext: int, body: bytes) -> bytes:
    """``mpegts_write_section1``: a PSI section (version 0, current) and
    its CRC-32 (``av_crc`` from all ones)."""
    sec = bytes((table_id,)) + struct.pack(">HH", 0xB000 | len(body) + 9,
                                           ext) + b"\xc1\0\0" + body
    return sec + struct.pack(">I", crc(sec, 0xFFFFFFFF))


class TsWriter:
    """MPEG-4 Part 2 samples (VOL headers in band) → an MPEG transport
    stream laid out as FFmpeg's ``mpegts`` muxer (``mpegtsenc.c``, VBR)
    lays out ``cv2.VideoWriter``'s stream: the PAT and PMT (program 1,
    ``stream_type`` 0x10) before the first picture, again where 0.1 s of
    PCR has passed and before a key frame that follows another picture;
    one unbounded PES packet (stream 0xE0, its PTS 1.4 s on) a picture,
    split over 188-byte packets, the last padded by adaptation-field
    stuffing; a PCR (0.7 s behind the picture's time) on each key frame
    and wherever the largest whole number of frame periods under 0.1 s
    has passed, and the random access flag on key frames.  ``m2ts`` writes
    192-byte packets (the 4-byte arrival time FFmpeg derives from the byte
    position) with the PMT on PID 0x100, the video on PID 0x1011 and the
    ``HDMV`` registration, padded with null packets to a multiple of 32 as
    the muxer pads them; the stream type stays 0x10 (FFmpeg's muxer marks
    MPEG-4 private data in M2TS and its demuxer then probes the payload).
    FFmpeg's SDT (its own provider and service names) is left out."""

    def __init__(self, path: str, rate: Tuple[int, int], m2ts: bool = False):
        self.num, self.den = rate
        self.m2ts = m2ts
        self.pmt_pid, self.pid = (0x100, 0x1011) if m2ts else (0x1000,
                                                               0x100)
        self.cc: Dict[int, int] = {}
        self.n = 0
        frame = -(-self.den * _PCR_HZ // self.num)
        self.pcr_period = (frame * (_PCR_HZ // 10 // frame)
                           if frame <= _PCR_HZ // 10 else 1)
        self.first_pcr = _DELAY * 300
        self.last_pcr = self.first_pcr - self.pcr_period
        self.last_pat: Optional[int] = None
        self.prev_key = False
        self.pos = 0
        self._f: Optional[BinaryIO] = open(path, "wb")

    def _packet(self, pkt: bytes) -> None:
        if self.m2ts:
            # get_pcr at VBR's mux rate of 1 bit a second, modulo 2^30 - 1
            at = (self.pos + 11) * 8 * _PCR_HZ + self.first_pcr
            pkt = struct.pack(">I", at % 0x3FFFFFFF) + pkt
        self._f.write(pkt)
        self.pos += len(pkt)

    def _counter(self, pid: int) -> int:
        self.cc[pid] = (self.cc.get(pid, 15) + 1) & 15
        return self.cc[pid]

    def _write_section(self, pid: int, sec: bytes) -> None:
        first = True
        while sec:
            head = bytes((0x47, (0x40 if first else 0) | pid >> 8, pid & 0xFF,
                          0x10 | self._counter(pid))) + (b"\0" if first
                                                          else b"")
            n = 188 - len(head)
            self._packet((head + sec[:n]).ljust(188, b"\xff"))
            sec = sec[n:]
            first = False

    def _psi(self) -> None:
        self._write_section(0, _section(0, 1, struct.pack(
            ">HH", 1, 0xE000 | self.pmt_pid)))
        info = b"\x05\x04HDMV\x88\x04\x0f\xff\xfc\xfc" if self.m2ts else b""
        self._write_section(self.pmt_pid, _section(2, 1, struct.pack(
            ">HH", 0xE000 | self.pid, 0xF000 | len(info)) + info + bytes(
                (0x10,)) + struct.pack(">HH", 0xE000 | self.pid, 0xF000)))

    def write(self, sample: bytes, key: bool) -> None:
        dts = 2 * _DELAY + (self.n * 90000 * self.den * 2 + self.num) // (
            2 * self.num)
        pcr = (dts - _DELAY) * 300
        force_pat = key and not self.prev_key
        payload = sample
        start = True
        while payload:
            if self.last_pat is None or pcr - self.last_pat >= _PAT_PERIOD \
                    or force_pat:
                self.last_pat = pcr if self.last_pat is None else max(
                    pcr, self.last_pat)
                self._psi()
            force_pat = False
            write_pcr = False
            if start and pcr - self.last_pcr >= self.pcr_period:
                self.last_pcr = max(pcr - self.pcr_period,
                                    self.last_pcr + self.pcr_period)
                write_pcr = True
            af_flags = 0
            if key and start:
                write_pcr = True
                af_flags |= 0x40
            af = b""
            if write_pcr:
                high, low = divmod(pcr, 300)
                af = bytes((high >> 25 & 0xFF, high >> 17 & 0xFF,
                            high >> 9 & 0xFF, high >> 1 & 0xFF,
                            (high << 7 & 0x80) | low >> 8 | 0x7E,
                            low & 0xFF))
                af_flags |= 0x10
            head = b""
            if start:
                head = (b"\0\0\1\xe0\0\0\x80\x80\x05"
                        + put_timestamp(2, dts))
            room = 184 - head.__len__() - (2 + len(af) if af_flags else 0)
            n = min(room, len(payload))
            stuffing = room - n
            if af_flags or stuffing:
                field = bytes((af_flags,)) + af if af_flags else (
                    b"\0" if stuffing >= 2 else b"")
                if af_flags:
                    field += b"\xff" * stuffing
                elif stuffing >= 2:
                    field += b"\xff" * (stuffing - 2)
                adapt = bytes((len(field),)) + field
                afc = 0x30
            else:
                adapt, afc = b"", 0x10
            pid = self.pid
            pkt = bytes((0x47, (0x40 if start else 0) | pid >> 8, pid & 0xFF,
                         afc | self._counter(pid))) + adapt + head + \
                payload[:n]
            assert len(pkt) == 188, len(pkt)
            self._packet(pkt)
            payload = payload[n:]
            start = False
        self.prev_key = key
        self.n += 1

    def release(self) -> None:
        f = self._f
        if f is None:
            return
        try:
            if self.m2ts:
                for _ in range(self.pos // 192 % 32, 32):
                    self._packet(b"\x47\x1f\xff\x10" + b"\xff" * 184)
        finally:
            self._f = None
            f.close()
