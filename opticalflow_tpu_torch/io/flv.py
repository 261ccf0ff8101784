"""Flash Video (``.flv``): the demuxer of the port's Sorenson H.263 path,
in Python (no FFmpeg).

:class:`FlvFile` reads what FFmpeg's flv demuxer reads of a file for
``cv2.VideoCapture``: the FLV header and its data offset, then the tags
one after another (each closed by its previous-tag size): the
``onMetaData`` script tag (AMF0: its ``framerate``, ``duration``,
``width`` and ``height``), and every video tag (type 9) with its frame
type (1: key frame, 2: inter, 3: disposable inter; 5, a video info or
command frame, is passed over as FFmpeg passes it over) and its
millisecond timestamp; audio and other tags are skipped.  Video of codec
id 2 (Sorenson H.263, what FFmpeg's flv muxer writes for
``cv2.VideoWriter``'s fourcc ``FLV1``) is read, and codec id 7 (H.264:
AVCPacketType 0, the sequence header, is its avcC; type 1 holds
length-prefixed NAL units; the composition time is passed over, as I and
P pictures have none), and, in enhanced FLV's extended tag header, VP9
(FourCC ``vp09``: what FFmpeg's flv muxer writes for ``cv2.VideoWriter``'s
fourccs ``VP90`` and ``VP09``; its SequenceStart packet is the ``vpcC``
record); other codecs (Screen video, VP6, the other enhanced-FLV FourCCs:
AV1, HEVC, H.264) raise ``Unsupported``, naming ROADMAP Queue 1 item 8.

What cv2 reports follows FFmpeg: fps is the metadata's ``framerate`` as
``av_d2q(framerate, 1000)`` makes it the stream's ``avg_frame_rate``; the
frame count is OpenCV's ``duration × fps`` rounded, the duration the
metadata's in whole microseconds.  A file whose metadata lacks either
raises ``Unsupported`` (item 8): FFmpeg then guesses both from the
packets it probes, which the port does not reproduce.  Key frames
are the video tags of frame type 1, which FFmpeg's demuxer indexes as it
reads them, so a ``CAP_PROP_POS_FRAMES`` seek lands on the last key frame
at or before the time OpenCV asks for (``EncodedVideo.seek_target``).
"""

from __future__ import annotations

import math
import os
import struct
from typing import BinaryIO, List

from opticalflow_tpu_torch.io.mkv import av_reduce
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["FlvFile", "EXTENSIONS", "av_d2q"]

EXTENSIONS = (".flv",)
SORENSON = 2            # the video tag's codec id of Sorenson H.263
AVC = 7                 # and of H.264
_CODECS = {1: "JPEG video", 3: "Screen video", 4: "On2 VP6",
           5: "On2 VP6 with alpha", 6: "Screen video version 2",
           7: "H.264", 12: "HEVC", 13: "AV1", 14: "VP9"}
_KEY, _INFO = 1, 5      # frame types: key frame, video info/command frame
# enhanced FLV's packet types (the extended header's low 4 bits)
(_SEQUENCE_START, _CODED_FRAMES, _SEQUENCE_END, _CODED_FRAMES_X, _METADATA,
 _MPEG2TS_SEQUENCE_START, _MULTITRACK) = range(7)
_FOURCCS = {b"vp09": "VP9", b"av01": "AV1", b"hvc1": "HEVC",
            b"avc1": "H.264"}


def av_d2q(d: float, limit: int):
    """FFmpeg's ``av_d2q``: ``d`` as the closest ratio with terms at most
    ``limit``, (numerator, denominator)."""
    if math.isnan(d):
        return 0, 0
    exponent = max(math.frexp(d)[1] - 1, 0)
    den = 1 << (61 - exponent)
    num, den2 = av_reduce(int(math.floor(d * den + 0.5)), den, limit)
    if (not num or not den2) and d and 0 < limit < (1 << 31) - 1:
        num, den2 = av_reduce(int(math.floor(d * den + 0.5)), den,
                              (1 << 31) - 1)
    return num, den2


def _amf_value(b: bytes, pos: int, depth: int = 0):
    """(one AMF0 value at ``pos``, the position after it)."""
    if depth > 16:
        raise ValueError("AMF0 values nested too deep")
    kind = b[pos]
    pos += 1
    if kind == 0:                                   # number
        return struct.unpack(">d", b[pos:pos + 8])[0], pos + 8
    if kind == 1:                                   # boolean
        return bool(b[pos]), pos + 1
    if kind == 2:                                   # string
        n = struct.unpack(">H", b[pos:pos + 2])[0]
        return b[pos + 2:pos + 2 + n].decode("utf-8", "replace"), pos + 2 + n
    if kind in (3, 8):                              # object, ECMA array
        if kind == 8:
            pos += 4
        out = {}
        while pos + 3 <= len(b):
            n = struct.unpack(">H", b[pos:pos + 2])[0]
            if n == 0 and b[pos + 2] == 9:          # object end
                return out, pos + 3
            key = b[pos + 2:pos + 2 + n].decode("utf-8", "replace")
            out[key], pos = _amf_value(b, pos + 2 + n, depth + 1)
        return out, pos
    if kind == 10:                                  # strict array
        n = struct.unpack(">I", b[pos:pos + 4])[0]
        pos += 4
        items = []
        for _ in range(min(n, len(b))):
            v, pos = _amf_value(b, pos, depth + 1)
            items.append(v)
        return items, pos
    if kind == 11:                                  # date
        return struct.unpack(">d", b[pos:pos + 8])[0], pos + 10
    if kind in (5, 6):                              # null, undefined
        return None, pos
    raise ValueError(f"AMF0 type {kind}")


class FlvFile:
    """The video of an FLV file."""

    def __init__(self, path: str):
        self.path = path
        self.codec, self.tag = "flv1", "FLV1"
        self.dsi = b""          # H.264's avcC (its sequence header tag)
        self.offsets: List[int] = []
        self.sizes: List[int] = []
        self.stamps: List[int] = []        # ms
        self.frame_types: List[int] = []
        self.meta: dict = {}
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(9)
            if head[:3] != b"FLV"[:len(head)] or not head:
                raise ValueError(f"{path}: not an FLV file")
            if len(head) < 9:
                raise ValueError(f"{path}: a truncated FLV header")
            # the data offset, then PreviousTagSize0
            pos = struct.unpack(">I", head[5:9])[0] + 4
            while pos + 11 <= size:
                f.seek(pos)
                t = f.read(11)
                kind = t[0] & 0x1F
                n = int.from_bytes(t[1:4], "big")
                stamp = int.from_bytes(t[4:7], "big") | t[7] << 24
                if pos + 11 + n > size:
                    raise ValueError(f"{path}: a tag at byte {pos} is "
                                     "truncated")
                if kind == 18 and not self.meta:
                    self._script(f.read(n))
                elif kind == 9 and n:
                    flags = f.read(1)[0]
                    self._video(f, flags, pos + 12, n - 1, stamp)
                pos += 11 + n + 4
        if not self.sizes:
            raise ValueError(f"{path}: no video frames (truncated file?)")
        if self.codec == "h264" and not self.dsi:
            raise ValueError(f"{path}: H.264 in FLV without its sequence "
                             "header (avcC)")
        self.keyframes = [i for i, t in enumerate(self.frame_types)
                          if t == _KEY] or [0]
        self.start_time = self.stamps[0]
        self.fps = self._fps()
        self.frames = self._count()
        # whether OpenCV's frame numbers (dts_to_frame_number) are the
        # frames' indices, which a seek counts in
        self.numbered = all(self.number(i) == i
                            for i in range(len(self.stamps)))
        self.width = int(self.meta.get("width") or 0)
        self.height = int(self.meta.get("height") or 0)

    def _script(self, body: bytes) -> None:
        try:
            name, pos = _amf_value(body, 0)
            if name == "onMetaData":
                value, _ = _amf_value(body, pos)
                if isinstance(value, dict):
                    self.meta = value
        except (ValueError, IndexError, struct.error):
            pass                      # FFmpeg reads past a damaged script tag

    def _enhanced(self, f: BinaryIO, flags: int, offset: int, n: int,
                  stamp: int) -> None:
        """An extended video tag header (enhanced FLV, as flvdec reads it):
        the frame type in bits 4-6, the packet type in the low 4 bits, then
        the FourCC.  VP9 (``vp09``) is read: SequenceStart holds its
        ``vpcC`` record, CodedFrames and CodedFramesX a frame each (no
        composition time: only AVC and HEVC carry one), SequenceEnd and
        Metadata (``colorInfo``) no frame; a video info or command frame
        is passed over, as FFmpeg passes it over."""
        frame_type, kind = flags >> 4 & 7, flags & 0x0F
        if kind == _MULTITRACK or n < 4:
            what = ("a multitrack packet" if kind == _MULTITRACK else
                    "an extended tag header without its FourCC")
            raise Unsupported(f"{self.path}: enhanced FLV video ({what}), "
                              f"not read by the port ({ITEM_8})")
        if frame_type == _INFO and kind != _METADATA:
            return
        fourcc = f.read(4)
        if fourcc != b"vp09" or (self.sizes and self.codec != "vp9"):
            name = fourcc.decode("latin-1")
            raise Unsupported(
                f"{self.path}: enhanced FLV video of FourCC {name!r} "
                f"({_FOURCCS.get(fourcc, 'an unknown codec')}): the port "
                f"reads VP9 ('vp09') only of the enhanced FLV codecs "
                f"({ITEM_8})")
        self.codec, self.tag = "vp9", "VP90"
        offset, n = offset + 4, n - 4
        if kind == _SEQUENCE_START:
            if not self.dsi:
                self.dsi = f.read(n)
            return
        if kind not in (_CODED_FRAMES, _CODED_FRAMES_X) or not n:
            return
        self.offsets.append(offset)
        self.sizes.append(n)
        self.stamps.append(stamp)
        self.frame_types.append(frame_type)

    def _video(self, f: BinaryIO, flags: int, offset: int, n: int,
               stamp: int) -> None:
        if flags & 0x80:
            self._enhanced(f, flags, offset, n, stamp)
            return
        codec, frame_type = flags & 0x0F, flags >> 4
        if codec not in (SORENSON, AVC) or self.codec == "vp9" or (
                self.sizes and codec != (
                    AVC if self.codec == "h264" else SORENSON)):
            name = _CODECS.get(codec, f"codec id {codec}")
            raise Unsupported(f"{self.path}: {name} video in FLV: the port "
                              f"reads Sorenson H.263 (codec id 2) and H.264 "
                              f"(codec id 7) only ({ITEM_8})")
        if frame_type == _INFO:
            return
        if codec == AVC:
            # AVCPacketType and the composition time, then the avcC
            # (sequence header) or length-prefixed NAL units
            self.codec, self.tag = "h264", "avc1"
            if n < 4:
                raise ValueError(f"{self.path}: a truncated AVC video tag")
            kind = f.read(4)[0]
            offset, n = offset + 4, n - 4
            if kind == 0:
                if not self.dsi:
                    self.dsi = f.read(n)
                return
            if kind != 1 or not n:
                return
        self.offsets.append(offset)
        self.sizes.append(n)
        self.stamps.append(stamp)
        self.frame_types.append(frame_type)

    def _meta(self, key: str) -> float:
        value = self.meta.get(key)
        if not (isinstance(value, float) and 0 < value < 1 << 31):
            raise Unsupported(f"{self.path}: an FLV without an onMetaData "
                              f"{key} (FFmpeg guesses the frame rate and "
                              f"count from its probe), not read by the "
                              f"port ({ITEM_8})")
        return value

    def _fps(self) -> float:
        num, den = av_d2q(self._meta("framerate"), 1000)
        return num / den

    def _count(self) -> int:
        """OpenCV's count: floor(duration in s × fps + 0.5)."""
        usec = int(self._meta("duration") * 1000000)  # flvdec's int64 cast
        return int(math.floor(usec / 1000000 * self.fps + 0.5))

    def number(self, i: int) -> int:
        """OpenCV's frame number of sample ``i`` (``dts_to_frame_number``)."""
        return int(self.fps * ((self.stamps[i] - self.start_time) * 0.001)
                   + 0.5)

    def sample(self, f: BinaryIO, i: int) -> bytes:
        f.seek(self.offsets[i])
        data = f.read(self.sizes[i])
        if len(data) != self.sizes[i]:
            raise ValueError(f"{self.path}: frame {i} is truncated")
        return data
