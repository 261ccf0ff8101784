"""Matroska and WebM video: the demuxer and muxer of the port's video path,
in Python (no FFmpeg).

:class:`MkvFile` reads the first video track (TrackType 1) of a ``.mkv``
or ``.webm`` file as FFmpeg's matroska demuxer reads it for
``cv2.VideoCapture``: the EBML header, the Segment, Info
(``TimecodeScale``, ``Duration``), Tracks (``CodecID``, ``CodecPrivate``,
``DefaultDuration``, ``PixelWidth``/``PixelHeight``, ``Colour``'s range
and chroma siting, ``ContentEncoding``)
and every Cluster's ``SimpleBlock`` and ``BlockGroup``.  Element sizes may
be unknown (all ones), as ``MediaRecorder`` and live WebM writers leave the
Segment's and the Clusters'; such an element ends where an element of a
level above it begins.  Each block's keyframe flag (a ``BlockGroup``
without ``ReferenceBlock`` is one) gives the seek points, so Cues are not
needed.  The codecs, by ``CodecID``:

  * ``V_VP8``: ``runtime/vp8``;
  * ``V_VP9``: ``runtime/vp9`` (profile 0);
  * ``V_MPEG4/ISO/SP``, ``/ASP``, ``/AP``: ``runtime/mpeg4``, the VOL in
    ``CodecPrivate`` (what ``cv2.VideoWriter`` writes with ``mp4v``);
  * ``V_MPEG1``, ``V_MPEG2``: ``runtime/mpeg12``, the sequence header in
    ``CodecPrivate``;
  * ``V_MJPEG``: ``runtime/jpeg``'s FFmpeg flavour;
  * ``V_FFV1``: ``runtime/ffv1``, ``CodecPrivate`` as its extradata;
  * ``V_MPEG4/MS/V3``: ``runtime/msmpeg4`` (MS-MPEG4 v3, what
    ``cv2.VideoWriter`` writes for ``DIV3`` into ``.mkv``);
  * ``V_SNOW``: ``runtime/snow`` (what ``cv2.VideoWriter`` writes for
    ``SNOW`` into ``.mkv``);
  * ``V_DIRAC``: ``runtime/dirac`` (Dirac/VC-2, what ``cv2.VideoWriter``
    writes for ``drac`` into ``.mkv``);
  * ``V_UNCOMPRESSED`` with the FourCC ``I420``: raw planes; ``Y800``,
    ``GREY``, ``Y8  ``, ``YV12``, ``NV12``, ``Y41B`` and ``RGBA``:
    ``io/avi``'s ``RAW_LAYOUTS``;
  * ``V_MS/VFW/FOURCC``: the BITMAPINFOHEADER in ``CodecPrivate``, read by
    ``io/avi``'s fourcc rules (H.263 under ``H263``, Sorenson H.263 under
    ``FLV1``, HuffYUV, FFVHuff, Ut Video, MagicYUV, ASUS V1/V2, PNG,
    MS-MPEG4 v2 and WMV7/8 under ``HFYU``, ``FFVH``, ``UL**``, ``M8Y0``,
    ``ASV1``/``ASV2``, ``MPNG``, ``MP42``, ``WMV1`` and ``WMV2``, as ``cv2.VideoWriter`` writes them into ``.mkv``;
    JPEG 2000 under ``MJ2C``/``mjp2``, Motion JPEG under ``LJPG``,
    MPEG-4 Part 2 under ``3IV2``, ``yuv4``), its ``biBitCount`` as
    ``bpc``;
  * ``V_QUICKTIME``: a QuickTime sample description in ``CodecPrivate``,
    its fourcc looked up as matroskadec's ``get_qt_codec`` looks it up
    (``tiff``, what ``cv2.VideoWriter`` writes for it into ``.mkv``:
    ``runtime/tiff``).

Other codecs (H.264, HEVC, AV1, ...), zlib-compressed
or encrypted tracks and laced video blocks raise ``Unsupported`` naming
ROADMAP Queue 1 item 8; header stripping is applied.

fps and the frame count are ``cv2.VideoCapture``'s: fps is FFmpeg's
``r_frame_rate``, ``DefaultDuration`` reduced to a ratio of terms up to
30000 (``av_reduce``), or without it the standard rate its ``rfps`` search
fits to the first blocks' timestamps; the count is the segment's
``Duration`` times fps, rounded (OpenCV's estimate: Matroska stores no
count).  Without a ``Duration`` cv2 reports a negative count; the port
counts the blocks.

:class:`MkvWriter` writes MPEG-4 Part 2 samples as FFmpeg's matroska muxer
lays out what ``cv2.VideoWriter`` writes with ``mp4v`` into ``.mkv``:
``V_MPEG4/ISO/ASP`` with the VOL as ``CodecPrivate``, ``DefaultDuration``,
``Duration``, a Cluster from each keyframe and Cues.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple

from opticalflow_tpu_torch.io.avi import RAW_LAYOUTS, codec_of

# the QuickTime sample entries read under V_QUICKTIME → their codecs
QT_CODECS = {b"tiff": "tiff"}
from opticalflow_tpu_torch.io.orientation import (matrix_angle,
                                                  projection_matrix)
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["MkvFile", "MkvWriter", "av_reduce", "std_rate"]

# element IDs, marker bits kept
EBML, DOCTYPE = 0x1A45DFA3, 0x4282
SEGMENT, SEEKHEAD, INFO, TRACKS, CLUSTER, CUES = (
    0x18538067, 0x114D9B74, 0x1549A966, 0x1654AE6B, 0x1F43B675, 0x1C53BB6B)
TAGS, CHAPTERS, ATTACHMENTS = 0x1254C367, 0x1043A770, 0x1941A469
TIMECODE_SCALE, DURATION, MUXING_APP, WRITING_APP = (0x2AD7B1, 0x4489,
                                                     0x4D80, 0x5741)
TRACK_ENTRY, TRACK_NUMBER, TRACK_UID, TRACK_TYPE = 0xAE, 0xD7, 0x73C5, 0x83
CODEC_ID, CODEC_PRIVATE, DEFAULT_DURATION, FLAG_LACING = (0x86, 0x63A2,
                                                          0x23E383, 0x9C)
VIDEO, PIXEL_WIDTH, PIXEL_HEIGHT, COLOUR_SPACE = 0xE0, 0xB0, 0xBA, 0x2EB524
PROJECTION, PROJECTION_TYPE = 0x7670, 0x7671
POSE_YAW, POSE_PITCH, POSE_ROLL = 0x7673, 0x7674, 0x7675
COLOUR, RANGE, CHROMA_SITING_HORZ, CHROMA_SITING_VERT = (0x55B0, 0x55B9,
                                                         0x55B7, 0x55B8)
CONTENT_ENCODINGS, CONTENT_ENCODING = 0x6D80, 0x6240
CONTENT_COMPRESSION, COMP_ALGO, COMP_SETTINGS, CONTENT_ENCRYPTION = (
    0x5034, 0x4254, 0x4255, 0x5035)
TIMECODE, SIMPLE_BLOCK, BLOCK_GROUP, BLOCK, REFERENCE_BLOCK = (
    0xE7, 0xA3, 0xA0, 0xA1, 0xFB)
CUE_POINT, CUE_TIME, CUE_TRACK_POSITIONS, CUE_TRACK, CUE_CLUSTER_POSITION = (
    0xBB, 0xB3, 0xB7, 0xF7, 0xF1)
LANGUAGE = 0x22B59C

# the Segment's children: where an unknown-size Cluster ends
_TOP = {SEEKHEAD, INFO, TRACKS, CLUSTER, CUES, TAGS, CHAPTERS, ATTACHMENTS}
_MPEG4_IDS = ("V_MPEG4/ISO/SP", "V_MPEG4/ISO/ASP", "V_MPEG4/ISO/AP")
_NAMES = {"V_AV1": "AV1", "V_MPEGH/ISO/HEVC": "HEVC", "V_THEORA": "Theora", "V_PRORES": "ProRes",
          "V_REAL/RV40": "RealVideo"}


def _vint(f: BinaryIO, keep_marker: bool) -> Tuple[Optional[int], int]:
    """A variable-length integer at the file's position: (its value, or None
    for the reserved all-ones 'unknown' size; its length in bytes)."""
    head = f.read(1)
    if not head:
        raise EOFError
    first = head[0]
    n = 1
    while n <= 8 and not first & (0x80 >> (n - 1)):
        n += 1
    if n > 8:
        raise ValueError("an EBML integer longer than 8 bytes")
    rest = f.read(n - 1)
    if len(rest) != n - 1:
        raise EOFError
    value = first if keep_marker else first & ((0x80 >> (n - 1)) - 1)
    for b in rest:
        value = value << 8 | b
    if not keep_marker and value == (1 << (7 * n)) - 1:
        return None, n
    return value, n


def _header(f: BinaryIO) -> Tuple[int, Optional[int], int]:
    """(element ID, size or None when unknown, header length)."""
    eid, n = _vint(f, True)
    size, m = _vint(f, False)
    return eid, size, n + m


def _uint(data: bytes) -> int:
    return int.from_bytes(data, "big") if data else 0


def _float(data: bytes) -> float:
    if len(data) == 4:
        return struct.unpack(">f", data)[0]
    if len(data) == 8:
        return struct.unpack(">d", data)[0]
    return 0.0


def av_reduce(num: int, den: int, limit: int) -> Tuple[int, int]:
    """FFmpeg's ``av_reduce``: num/den as the closest ratio whose terms are
    at most ``limit`` (continued fractions)."""
    from math import gcd
    g = gcd(num, den)
    if g:
        num, den = num // g, den // g
    a0, a1 = (0, 1), (1, 0)
    if num <= limit and den <= limit:
        return num, den
    while den:
        x = num // den
        nxt = num - den * x
        a2 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
        if a2[0] > limit or a2[1] > limit:
            if a1[0]:
                x = (limit - a0[0]) // a1[0]
            if a1[1]:
                x = min(x, (limit - a0[1]) // a1[1])
            if den * (2 * x * a1[1] + a0[1]) > num * a1[1]:
                a1 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
            break
        a0, a1 = a1, a2
        num, den = den, nxt
    return a1


def std_rate(j: int) -> int:
    """FFmpeg's ``get_std_framerate``: standard rate ``j`` in units of
    1/(12 * 1001) frames a second."""
    if j < 30 * 12:
        return (j + 1) * 1001
    j -= 30 * 12
    if j < 30:
        return (j + 31) * 1001 * 12
    j -= 30
    if j < 3:
        return (80, 120, 240)[j] * 1001 * 12
    j -= 3
    return (24, 30, 60, 12, 15, 48)[j] * 1000 * 12


_N_STD = 30 * 12 + 30 + 3 + 6


def _rfps(times: List[int], tb: float) -> Optional[Tuple[int, int]]:
    """FFmpeg's frame-rate guess from timestamps (``ff_rfps_add_frame`` and
    ``ff_rfps_calculate`` over what ``avformat_find_stream_info`` reads: up
    to 41 blocks at a millisecond time base): an exact common period when
    the durations after the fourth share one above 2 ticks, else the
    standard rate whose frame grid the timestamps fit best."""
    times = times[:41]
    durs = [b - a for a, b in zip(times, times[1:])]
    durs = [d for d in durs if d > 0]
    if len(durs) < 2:
        return None
    from math import gcd
    g = 0
    for d in durs[3:]:
        g = gcd(g, d)
    if len(durs) > 15 and g > max(1, int(1 / (500 * tb))):
        return av_reduce(int(round(1 / tb)), g, (1 << 31) - 1)
    err = [[[0.0] * _N_STD for _ in range(2)] for _ in range(2)]
    for t in times[1:len(durs) + 1]:
        dts = t * tb
        for j in range(_N_STD):
            sdts = dts * std_rate(j) / (1001 * 12)
            for k in range(2):
                ticks = int(round(sdts + k * 0.5))   # llrint
                e = sdts - ticks + k * 0.5
                err[k][0][j] += e
                err[k][1][j] += e * e
    n = len(durs)
    mean_period = sum(durs) * tb / n
    best, num = 0.01, 0
    for j in range(_N_STD):
        rate = std_rate(j)
        if sum(durs) * tb < (1001 * 12.0) / rate:
            continue
        if mean_period < (1001 * 12.0 * 0.8) / rate:
            continue
        for k in range(2):
            a = err[k][0][j] / n
            e = err[k][1][j] / n - a * a
            if e < best and best > 1e-9:
                best, num = e, rate
    return av_reduce(num, 12 * 1001, (1 << 31) - 1) if num else None


class MkvFile:
    """The first video track of a Matroska or WebM file."""

    def __init__(self, path: str):
        self.path = path
        self.offsets: List[int] = []
        self.sizes: List[int] = []
        self.times: List[int] = []          # block timestamps, TimecodeScale
        self.keyframes: List[int] = []
        self.dsi = b""
        self.tag = ""
        self.bpc = 0
        self.codec = ""
        self.width = self.height = 0
        self.full_range = False
        self.chroma_site: Optional[Tuple[int, int]] = None
        self.rotation = 0       # cv2's orientation (io/orientation)
        self.timescale = 1_000_000
        self.duration: Optional[float] = None
        self.default_duration = 0
        self._track: Optional[int] = None
        self._strip = b""
        self._file_size = os.path.getsize(path)
        try:
            with open(path, "rb") as f:
                self._read(f)
        except EOFError:
            raise ValueError(f"{path}: truncated Matroska file") from None
        except (struct.error, IndexError) as e:
            raise ValueError(f"{path}: malformed Matroska ({e!r})") from e
        if self._track is None:
            raise ValueError(f"{path}: no video track")
        if not self.sizes:
            raise ValueError(f"{path}: no video frames (truncated file?)")
        # FFmpeg indexes key-flagged blocks (with or without Cues); a track
        # with none (cv2's writer flags no Dirac packet a key frame) has no
        # index, and its seeks go through FFmpeg's generic search
        self.indexed = bool(self.keyframes)
        self.keyframes = self.keyframes or [0]

    # ------------------------------------------------------------ parsing
    def _read(self, f: BinaryIO) -> None:
        eid, size, n = _header(f)
        if eid != EBML or size is None:
            raise ValueError(f"{self.path}: not a Matroska or WebM file")
        body = f.read(size)
        doctype = self._children_bytes(body).get(DOCTYPE, b"matroska")
        if doctype not in (b"matroska", b"webm"):
            raise ValueError(f"{self.path}: EBML document type {doctype!r}, "
                             "not Matroska or WebM")
        pos = n + size
        while pos < self._file_size:
            f.seek(pos)
            eid, size, n = _header(f)
            if eid == SEGMENT:
                end = self._file_size if size is None else min(
                    pos + n + size, self._file_size)
                self._segment(f, pos + n, end)
                return
            if size is None:
                break
            pos += n + size
        raise ValueError(f"{self.path}: no Matroska Segment")

    @staticmethod
    def _children_bytes(body: bytes) -> Dict[int, bytes]:
        """The first instance of each child of a small master element."""
        import io
        out: Dict[int, bytes] = {}
        f = io.BytesIO(body)
        while f.tell() < len(body):
            try:
                eid, size, _ = _header(f)
            except EOFError:
                break
            if size is None:
                break
            data = f.read(size)
            out.setdefault(eid, data)
        return out

    def _segment(self, f: BinaryIO, pos: int, end: int) -> None:
        while pos < end:
            f.seek(pos)
            try:
                eid, size, n = _header(f)
            except EOFError:
                return
            body = pos + n
            if eid == CLUSTER:
                pos = self._cluster(f, body, end if size is None else
                                    min(body + size, end))
                continue
            if size is None:
                raise ValueError(f"{self.path}: an element {eid:#x} of "
                                 "unknown size outside a Cluster")
            if eid == INFO:
                self._info(f.read(size))
            elif eid == TRACKS:
                self._tracks(f.read(size))
            pos = body + size

    def _info(self, data: bytes) -> None:
        kids = self._children_bytes(data)
        if TIMECODE_SCALE in kids:
            self.timescale = _uint(kids[TIMECODE_SCALE]) or 1_000_000
        if DURATION in kids:
            self.duration = _float(kids[DURATION])

    def _tracks(self, data: bytes) -> None:
        import io
        f = io.BytesIO(data)
        while f.tell() < len(data) and self._track is None:
            eid, size, _ = _header(f)
            body = f.read(size)
            if eid == TRACK_ENTRY:
                self._entry(body)

    def _entry(self, data: bytes) -> None:
        kids = self._children_bytes(data)
        if _uint(kids.get(TRACK_TYPE, b"")) != 1:
            return
        self._track = _uint(kids.get(TRACK_NUMBER, b"\1"))
        codec = kids.get(CODEC_ID, b"").decode("latin1").rstrip("\0")
        self.dsi = kids.get(CODEC_PRIVATE, b"")
        self.default_duration = _uint(kids.get(DEFAULT_DURATION, b""))
        video = self._children_bytes(kids.get(VIDEO, b""))
        self.width = _uint(video.get(PIXEL_WIDTH, b""))
        self.height = _uint(video.get(PIXEL_HEIGHT, b""))
        self._colour(self._children_bytes(video.get(COLOUR, b"")))
        # a rectangular Projection's pose: the display matrix FFmpeg gives
        # the track (io/orientation)
        proj = self._children_bytes(video.get(PROJECTION, b""))
        if proj and _uint(proj.get(PROJECTION_TYPE, b"")) == 0:
            self.rotation = matrix_angle(projection_matrix(
                *(_float(proj[k]) if k in proj else 0.0
                  for k in (POSE_YAW, POSE_PITCH, POSE_ROLL))))
        if CONTENT_ENCODINGS in kids:
            self._encodings(kids[CONTENT_ENCODINGS])
        if codec == "V_VP8":
            self.codec, self.tag = "vp8", "VP80"
        elif codec == "V_VP9":
            self.codec, self.tag = "vp9", "VP90"
        elif codec in _MPEG4_IDS:
            self.codec, self.tag = "mpeg4", "mp4v"
        elif codec in ("V_MPEG1", "V_MPEG2"):
            self.codec, self.tag = "mpeg12", codec
        elif codec == "V_MJPEG":
            self.codec, self.tag = "mjpeg", "MJPG"
        elif codec == "V_FFV1":
            self.codec, self.tag = "ffv1", "FFV1"
        elif codec == "V_MPEG4/MS/V3":
            self.codec, self.tag = "msmpeg4v3", "DIV3"
        elif codec == "V_SNOW":
            self.codec, self.tag = "snow", "SNOW"
        elif codec == "V_DIRAC":
            self.codec, self.tag = "dirac", "drac"
        elif codec == "V_MPEG4/ISO/AVC":
            # CodecPrivate is the avcC record (its NAL length size)
            if not self.dsi:
                raise ValueError(f"{self.path}: V_MPEG4/ISO/AVC without its "
                                 "avcC CodecPrivate")
            self.codec, self.tag = "h264", "avc1"
        elif codec == "V_UNCOMPRESSED":
            self.tag = video.get(COLOUR_SPACE, b"").decode("latin1")
            if self.tag in ("I420", "IYUV"):
                self.codec = "i420"
            elif self.tag in RAW_LAYOUTS:
                self.codec = "raw"
            else:
                raise Unsupported(f"{self.path}: uncompressed video with "
                                  f"FourCC {self.tag!r}: the port reads raw "
                                  f"I420, YV12, NV12, Y41B, Y800, GREY, "
                                  f"'Y8  ' and RGBA only ({ITEM_8})")
        elif codec == "V_QUICKTIME":
            # CodecPrivate is a QuickTime sample description (its size,
            # then the entry's fourcc; matroskadec's get_qt_codec shifts
            # one that starts at the fourcc); the mov tags cv2's writer
            # falls back to here: tiff
            entry = self.dsi
            if entry[:4] in QT_CODECS:
                entry = len(entry).to_bytes(4, "big") + entry
            self.tag = entry[4:8].decode("latin1")
            if len(entry) < 21 or entry[4:8] not in QT_CODECS:
                raise Unsupported(f"{self.path}: V_QUICKTIME video of fourcc "
                                  f"{self.tag!r}: the port reads tiff only "
                                  f"under V_QUICKTIME ({ITEM_8})")
            self.codec = QT_CODECS[entry[4:8]]
        elif codec == "V_MS/VFW/FOURCC":
            if len(self.dsi) < 40:
                raise ValueError(f"{self.path}: V_MS/VFW/FOURCC without a "
                                 "BITMAPINFOHEADER")
            w, h, _, self.bpc, comp = struct.unpack("<iiHH4s",
                                                    self.dsi[4:20])
            self.tag = comp.decode("latin1")
            self.codec = codec_of(self.tag, self.path)
            self.width, self.height = self.width or w, self.height or abs(h)
            self.dsi = self.dsi[40:]
        else:
            name = _NAMES.get(codec, f"the {codec!r} codec")
            raise Unsupported(f"{self.path}: {name} video (CodecID "
                              f"{codec!r}): the port reads VP8, VP9, MPEG-4 "
                              f"Part 2, MS-MPEG4 v3, Snow, Dirac, MPEG-1, "
                              f"MPEG-2, "
                              f"FFV1, "
                              f"Motion JPEG, "
                              f"raw video "
                              f"and the AVI fourccs of V_MS/VFW/FOURCC "
                              f"(H.263, ...) in Matroska only ({ITEM_8})")

    def _colour(self, colour: Dict[int, bytes]) -> None:
        """The Colour element as FFmpeg hands it to the decoder: Range 2 is
        full range; ChromaSitingHorz/Vert 1 (co-sited) or 2 (half), both
        given, a chroma site (1/256 of a luma sample: 0 or 128 a side)."""
        self.full_range = _uint(colour.get(RANGE, b"")) == 2
        h = _uint(colour.get(CHROMA_SITING_HORZ, b""))
        v = _uint(colour.get(CHROMA_SITING_VERT, b""))
        if h in (1, 2) and v in (1, 2):
            self.chroma_site = ((h - 1) << 7, (v - 1) << 7)

    def _encodings(self, data: bytes) -> None:
        enc = self._children_bytes(self._children_bytes(data).get(
            CONTENT_ENCODING, b""))
        if CONTENT_ENCRYPTION in enc:
            raise Unsupported(f"{self.path}: an encrypted track, not read by "
                              f"the port ({ITEM_8})")
        comp = self._children_bytes(enc.get(CONTENT_COMPRESSION, b""))
        if CONTENT_COMPRESSION in enc:
            algo = _uint(comp.get(COMP_ALGO, b""))
            if algo != 3:
                name = {0: "zlib", 1: "bzlib", 2: "lzo"}.get(algo, str(algo))
                raise Unsupported(f"{self.path}: {name}-compressed track, "
                                  f"not read by the port ({ITEM_8})")
            self._strip = comp.get(COMP_SETTINGS, b"")

    def _cluster(self, f: BinaryIO, pos: int, end: int) -> int:
        """Index one Cluster's blocks; returns where the next element of
        the Segment begins."""
        base = 0
        while pos < end:
            f.seek(pos)
            try:
                eid, size, n = _header(f)
            except EOFError:
                return end
            if eid in _TOP or eid == SEGMENT:
                return pos              # an unknown-size Cluster ends here
            if size is None:
                raise ValueError(f"{self.path}: a Cluster child {eid:#x} of "
                                 "unknown size")
            body = pos + n
            if body + size > self._file_size:
                if eid in (SIMPLE_BLOCK, BLOCK_GROUP):
                    raise ValueError(f"{self.path}: frame {len(self.sizes)} "
                                     "is truncated")
                return end
            if eid == TIMECODE:
                base = _uint(f.read(size))
            elif eid == SIMPLE_BLOCK:
                self._block(f, body, size, base, None)
            elif eid == BLOCK_GROUP:
                self._group(f, body, size, base)
            pos = body + size
        return end

    def _group(self, f: BinaryIO, pos: int, size: int, base: int) -> None:
        end = pos + size
        block, key = None, True
        while pos < end:
            f.seek(pos)
            eid, n_size, n = _header(f)
            if n_size is None:
                raise ValueError(f"{self.path}: a BlockGroup child of "
                                 "unknown size")
            if eid == BLOCK:
                block = (pos + n, n_size)
            elif eid == REFERENCE_BLOCK:
                key = False
            pos += n + n_size
        if block is not None:
            self._block(f, block[0], block[1], base, key)

    def _block(self, f: BinaryIO, pos: int, size: int, base: int,
               key: Optional[bool]) -> None:
        f.seek(pos)
        track, n = _vint(f, False)
        if track != self._track:
            return
        rel, flags = struct.unpack(">hB", f.read(3))
        if flags & 0x06:
            raise Unsupported(f"{self.path}: a laced video block (frame "
                              f"{len(self.sizes)}), not read by the port "
                              f"({ITEM_8})")
        if key is None:
            key = bool(flags & 0x80)
        if key:
            self.keyframes.append(len(self.sizes))
        self.offsets.append(pos + n + 3)
        self.sizes.append(size - n - 3)
        self.times.append(base + rel)

    # ------------------------------------------------------------ public
    @property
    def rate(self) -> Optional[Tuple[int, int]]:
        """FFmpeg's ``r_frame_rate`` (numerator, denominator)."""
        if self.default_duration:
            num, den = av_reduce(10 ** 9, self.default_duration, 30000)
            if 5 * den < num < 1000 * den:
                return num, den
        return _rfps(self.times, self.timescale / 1e9)

    @property
    def fps(self) -> float:
        rate = self.rate
        return rate[0] / rate[1] if rate else 0.0

    @property
    def frames(self) -> int:
        """``CAP_PROP_FRAME_COUNT``: Duration times fps, rounded; the
        number of blocks without a Duration."""
        if not self.duration or not self.fps:
            return len(self.sizes)
        us = int(self.duration * self.timescale * 1000 / 1_000_000)
        return int(us / 1_000_000 * self.fps + 0.5)

    def number(self, i: int) -> int:
        """OpenCV's frame number of block ``i`` (``dts_to_frame_number``)."""
        tb = self.timescale / 1e9
        return int(self.fps * ((self.times[i] - self.times[0]) * tb) + 0.5)

    def ticks(self, frame: int) -> int:
        """The time OpenCV's seek asks FFmpeg for at frame ``frame``."""
        return self.times[0] + int(frame / self.fps / (self.timescale / 1e9)
                                   + 0.5)

    def landing(self, ts: int) -> Optional[int]:
        """The block reading resumes at after FFmpeg's seek to ``ts`` in a
        track without an index (``seek_frame_generic``): it reads from the
        first Cluster to the first block after ``ts`` (FFmpeg's parser
        flags every Dirac picture a key frame) and stops past it."""
        later = [i for i, t in enumerate(self.times) if t > ts]
        return later[0] + 1 if later and later[0] + 1 < len(self.sizes) \
            else None

    def sample(self, f: BinaryIO, i: int) -> bytes:
        f.seek(self.offsets[i])
        data = f.read(self.sizes[i])
        if len(data) != self.sizes[i]:
            raise ValueError(f"{self.path}: frame {i} is truncated")
        return self._strip + data


# --------------------------------------------------------------- writing

def _id_bytes(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def _size_bytes(n: int, width: int = 0) -> bytes:
    width = width or next(k for k in range(1, 9) if n < (1 << (7 * k)) - 1)
    return ((1 << (7 * width)) | n).to_bytes(width, "big")


def _el(eid: int, body: bytes) -> bytes:
    return _id_bytes(eid) + _size_bytes(len(body)) + body


def _uint_el(eid: int, v: int) -> bytes:
    return _el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


class MkvWriter:
    """MPEG-4 Part 2 samples (VOL headers out of band) → a Matroska file,
    as FFmpeg's muxer writes ``mp4v`` for ``cv2.VideoWriter``: one track,
    a Cluster from each keyframe (or every 32 s of block timestamps), a
    millisecond TimecodeScale, Cues, and the Duration written at the
    end."""

    def __init__(self, path: str, size: Tuple[int, int],
                 rate: Tuple[int, int], headers: bytes):
        self.path = path
        self.num, self.den = rate
        self.n = 0
        self.cluster: List[Tuple[int, bytes, bool]] = []
        self.cues: List[Tuple[int, int]] = []
        self._f: Optional[BinaryIO] = open(path, "wb")
        w, h = size
        ebml = _el(EBML, _uint_el(0x4286, 1) + _uint_el(0x42F7, 1)
                   + _uint_el(0x42F2, 4) + _uint_el(0x42F3, 8)
                   + _el(DOCTYPE, b"matroska") + _uint_el(0x4287, 4)
                   + _uint_el(0x4285, 2))
        app = b"opticalflow_tpu_torch"
        info_body = (_uint_el(TIMECODE_SCALE, 1_000_000)
                     + _el(MUXING_APP, app) + _el(WRITING_APP, app))
        info = _el(INFO, info_body + _el(DURATION, struct.pack(">d", 0.0)))
        track = _el(TRACK_ENTRY, _uint_el(TRACK_NUMBER, 1)
                    + _uint_el(TRACK_UID, 1) + _uint_el(FLAG_LACING, 0)
                    + _el(LANGUAGE, b"und")
                    + _el(CODEC_ID, b"V_MPEG4/ISO/ASP")
                    + _uint_el(TRACK_TYPE, 1)
                    + _uint_el(DEFAULT_DURATION,
                               int(round(1e9 * self.den / self.num)))
                    + _el(VIDEO, _uint_el(PIXEL_WIDTH, w)
                          + _uint_el(PIXEL_HEIGHT, h))
                    + _el(CODEC_PRIVATE, headers))
        self._f.write(ebml)
        # the Segment's size is written at the end, in 8 bytes
        self._f.write(_id_bytes(SEGMENT) + b"\x01" + b"\0" * 7)
        self._seg = self._f.tell()
        self._duration_at = self._seg + len(info) - 8   # Info's last child
        self._f.write(info + _el(TRACKS, track))

    def _ms(self, i: int) -> int:
        """Frame i's timestamp in milliseconds, rounded as FFmpeg rescales."""
        return (2000 * i * self.den + self.num) // (2 * self.num)

    def write(self, sample: bytes, key: bool) -> None:
        t = self._ms(self.n)
        self.n += 1
        if self.cluster and (key or t - self.cluster[0][0] > 32767):
            self._flush()
        self.cluster.append((t, sample, key))

    def _flush(self) -> None:
        base = self.cluster[0][0]
        body = _uint_el(TIMECODE, base)
        for t, sample, key in self.cluster:
            body += _el(SIMPLE_BLOCK, b"\x81" + struct.pack(
                ">hB", t - base, 0x80 if key else 0) + sample)
        if self.cluster[0][2]:
            self.cues.append((base, self._f.tell() - self._seg))
        self._f.write(_el(CLUSTER, body))
        self.cluster = []

    def release(self) -> None:
        f = self._f
        if f is None:
            return
        try:
            if self.cluster:
                self._flush()
            f.write(_el(CUES, b"".join(
                _el(CUE_POINT, _uint_el(CUE_TIME, t) + _el(
                    CUE_TRACK_POSITIONS, _uint_el(CUE_TRACK, 1)
                    + _uint_el(CUE_CLUSTER_POSITION, pos)))
                for t, pos in self.cues)))
            end = f.tell()
            f.seek(self._seg - 8)
            f.write(_size_bytes(end - self._seg, 8))
            f.seek(self._duration_at)
            f.write(struct.pack(">d", self.n * 1000.0 * self.den / self.num))
        finally:
            self._f = None
            f.close()
