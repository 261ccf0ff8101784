"""ISO BMFF (``.mp4``, ``.mov``, and ``.3gp``/``.3g2`` of the ``3gp*`` and
``3g2*`` brands) video: the demuxer and muxer of the port's MPEG-4 Part 2
and Motion JPEG paths, in Python (no FFmpeg).

:class:`Mp4File` reads the first video track: ``ftyp``, ``moov`` before or
after ``mdat``, ``trak/mdia/minf/stbl`` (``stsd`` with its ``mp4v`` entry
and the ``esds``: objectTypeIndication 0x20, MPEG-4 Visual, with its
DecoderSpecificInfo; 0x6C, Motion JPEG, what ``cv2.VideoWriter`` writes
for fourcc ``MJPG`` in ``.mp4``; 0x6A, MPEG-1, and 0x60-0x65, MPEG-2,
what it writes for ``PIM1`` and ``MPG2``; ``stts``, ``stss``, ``stsc``,
``stsz``, ``stco``/``co64``), the ``mdhd`` timescale and the ``elst`` as
FFmpeg applies it to these files (empty and zero-offset edits change no
frame).  Its fps and frame count are what ``cv2.VideoCapture`` reports:
``timescale · samples / Σ durations`` (FFmpeg's ``avg_frame_rate``) and the
sample count.  The ``vp09`` entry (VP9, what ``cv2.VideoWriter`` writes for
fourcc ``VP90`` into ``.mp4``) is read with its ``vpcC``; the ``s263``
(with its ``d263``), ``h263`` and ``H263`` entries, H.263, what it writes for
fourccs ``s263`` and ``H263`` into ``.3gp`` and ``.mov``; the ``FFV1``
entry with its ``glbl`` box (the extradata), what it writes for fourcc
``FFV1`` into ``.mp4`` and ``.mov``; in QuickTime the ``jpeg`` entry
(Motion JPEG, what it writes for ``MJPG`` into ``.mov``), ``png `` (PNG,
also ``mp4v`` with objectTypeIndication 0x6D in ``.mp4``), ``RGBA`` (raw),
and the AVI fourccs FFmpeg's mov demuxer takes from riff.c: ``HFYU``,
``FFVH``, ``UL**``, ``M8**``, ``ASV1`` and ``ASV2`` with their ``glbl``
extradata and the entry's depth as ``bpc`` (HuffYUV, FFVHuff, Ut Video,
MagicYUV, ASUS V1/V2), ``FLV1`` (Sorenson H.263, keyframes from
``stss``), ``MP42``, ``WMV1`` and ``WMV2`` (MS-MPEG4 v2, WMV7/8; WMV8's
extradata in ``glbl``), ``SNOW`` (Snow, keyframes from ``stss``),
isom.c's ``3IVD`` (MS-MPEG4 v3, the entry cv2's mov muxer falls back to
for ``DIV3``) and ``drac`` (Dirac/VC-2, every picture intra, what it
writes for ``drac`` into ``.mp4`` and ``.mov``); ``mjp2`` and riff.c's
``MJ2C`` (JPEG 2000, every picture intra; in ``.mp4`` the ``mp4v`` entry
with objectTypeIndication 0x6E), ``yuv4`` (libavcodec's packed 4:2:0),
isom.c's ``3IV2``, ``XVID`` and ``DIVX`` (MPEG-4 Part 2, the VOL in
``glbl``), ``m1v `` and ``m2v1`` (MPEG-1/2, what it falls back to for
``mpg1``, ``PIM1``, ``MPEG``, ``mpg2`` and ``PIM2``).  Other codecs' sample entries
(``avc1``, ``hev1``, ...) raise ``Unsupported``, naming ROADMAP Queue 1
item 8.

:class:`Mp4Writer` writes what FFmpeg's mov muxer writes for ``mp4v``:
``ftyp``, ``mdat``, and at :meth:`~Mp4Writer.release` a ``moov`` with
``mvhd``, ``tkhd``, ``mdhd``, ``hdlr vide``, ``vmhd``, ``dinf``,
``stsd mp4v + esds``, ``stts``, ``stss``, ``stsc``, ``stsz`` and
``stco`` (``co64`` past 4 GiB).  The brand follows the extension as the
muxer's does (:data:`BRANDS`: ``isom`` for ``.mp4``, ``M4V `` for ``.m4v``,
``3gp4``, ``3g2a``; ``qt  `` for ``.mov``), and in QuickTime mode the
boxes take QuickTime's forms: ``wide`` before ``mdat``, the ``mdhd``
language 0x7FFF, the ``hdlr`` boxes' component types (``mhlr vide`` in
``mdia``, ``dhlr url `` in ``minf``) with counted names, and the sample
entry's vendor ``FFMP`` and temporal and spatial qualities.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple

from opticalflow_tpu_torch.io.avi import (ASV_TAGS, DIRAC_TAGS, FLV1_TAGS,
                                          JPEG2000_TAGS, JPEGLS_TAGS,
                                          HUFFYUV_TAGS, MAGICYUV_TAGS,
                                          MSMPEG4_TAGS, SNOW_TAGS,
                                          SPEEDHQ_TAGS, UTVIDEO_TAGS)
from opticalflow_tpu_torch.io.orientation import matrix_angle
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

__all__ = ["Mp4File", "Mp4Writer", "VIDEO_CODECS", "BRANDS"]

# sample entries of other video codecs, by what they are
VIDEO_CODECS = {
    "avc1": "H.264", "avc3": "H.264", "H264": "H.264", "h264": "H.264",
    "hev1": "HEVC", "hvc1": "HEVC", "av01": "AV1", "vp08": "VP8",
    "vp09": "VP9", "mjpa": "Motion JPEG", "mjpb": "Motion JPEG",
    "jpeg": "Motion JPEG", "mp4v": "MPEG-4 Part 2",
}
# the mov demuxer's sample entries of FFmpeg's h263 decoder
H263_ENTRIES = ("s263", "h263", "H263")
# isom.c's H.264 sample entries: the parameter sets in the avcC (avc1) or
# in band (avc3), the NAL unit lengths' size in the avcC either way
H264_ENTRIES = ("avc1", "avc3")
# esds objectTypeIndication → the codec it names
# objectTypeIndication: MPEG-4 Visual, Motion JPEG, PNG, MPEG-1 Visual and
# the MPEG-2 Visual profiles (simple, main, SNR, spatial, high, 4:2:2)
_OTI_CODECS = {0x20: "mpeg4", 0x6C: "mjpeg", 0x6D: "png", 0x6A: "mpeg12",
               0x6E: "jpeg2000",
               **{oti: "mpeg12" for oti in range(0x60, 0x66)}}
# QuickTime sample entries of intra-only codecs: the entry → the codec
# (the AVI fourccs the mov demuxer looks up in riff.c's table too)
_INTRA_ENTRIES = {"jpeg": "mjpeg", "png ": "png", "RGBA": "raw",
                  "mjp2": "jpeg2000", "yuv4": "yuv4", "tiff": "tiff",
                  **{t: "huffyuv" for t in HUFFYUV_TAGS},
                  **{t: "utvideo" for t in UTVIDEO_TAGS},
                  **{t: "magicyuv" for t in MAGICYUV_TAGS},
                  **{t: "asv" for t in ASV_TAGS}}
# riff.c's tags the mov demuxer takes for inter codecs (Sorenson H.263,
# MS-MPEG4 v2/v3, WMV7/8, Snow, Dirac), and isom.c's 3IVD, MS-MPEG4 v3's entry
# where cv2's mov muxer falls back to it
_RIFF_ENTRIES = {**{t: "flv1" for t in FLV1_TAGS}, **MSMPEG4_TAGS,
                 **{t: "snow" for t in SNOW_TAGS}, "3IVD": "msmpeg4v3",
                 **{t: "dirac" for t in DIRAC_TAGS},
                 **{t: "jpeg2000" for t in JPEG2000_TAGS},
                 **{t: "jpegls" for t in JPEGLS_TAGS},
                 **{t: "speedhq" for t in SPEEDHQ_TAGS}}
# isom.c's entries of MPEG-4 Part 2 (besides mp4v: what cv2's mov muxer
# writes for 3IV2, XVID and DIVX, the VOL in a glbl box) and of MPEG-1/2
# (what it falls back to for mpg1, PIM1, MPEG, mpg2 and PIM2)
_ISOM_ENTRIES = {"3IV2": "mpeg4", "XVID": "mpeg4", "DIVX": "mpeg4",
                 "m1v ": "mpeg12", "m2v1": "mpeg12"}


def _boxes(f: BinaryIO, start: int, end: int, what: str):
    """(type, body offset, box end) of each box in [start, end)."""
    off = start
    while off + 8 <= end:
        f.seek(off)
        head = f.read(16)
        if len(head) < 8:
            raise ValueError(f"{what}: truncated box at byte {off}")
        size, typ = struct.unpack(">I4s", head[:8])
        hdr = 8
        if size == 1:
            if len(head) < 16:
                raise ValueError(f"{what}: truncated box at byte {off}")
            size = struct.unpack(">Q", head[8:16])[0]
            hdr = 16
        elif size == 0:
            size = end - off
        if size < hdr or off + size > end:
            raise ValueError(f"{what}: box {typ!r} at byte {off} runs past "
                             f"its parent (truncated file?)")
        yield typ.decode("latin1"), off + hdr, off + size
        off += size


def _full(body: bytes) -> Tuple[int, bytes]:
    """(version, rest) of a full box's body."""
    if len(body) < 4:
        raise ValueError("truncated full box")
    return body[0], body[4:]


def _descriptor(data: bytes, pos: int) -> Tuple[int, int, int]:
    """(tag, payload start, payload end) of an MPEG-4 descriptor."""
    tag = data[pos]
    pos += 1
    n = 0
    for _ in range(4):
        c = data[pos]
        pos += 1
        n = (n << 7) | (c & 0x7F)
        if not c & 0x80:
            break
    if pos + n > len(data):
        raise ValueError("truncated esds descriptor")
    return tag, pos, pos + n


def _esds(body: bytes, what: str) -> Tuple[str, bytes]:
    """(codec, DecoderSpecificInfo) of an ``esds`` box: ``mpeg4`` with its
    VOS/VO/VOL headers, or ``mjpeg``."""
    _, es = _full(body)
    tag, p, end = _descriptor(es, 0)
    if tag != 3:
        raise ValueError(f"{what}: esds without an ES_Descriptor")
    flags = es[p + 2]
    p += 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + es[p]
    if flags & 0x20:
        p += 2
    tag, p, dend = _descriptor(es, p)
    if tag != 4:
        raise ValueError(f"{what}: esds without a DecoderConfigDescriptor")
    oti = es[p]
    codec = _OTI_CODECS.get(oti)
    if codec is None:
        raise Unsupported(f"{what}: mp4v track of objectTypeIndication "
                          f"0x{oti:02x}: the port decodes MPEG-4 Part 2 "
                          f"(0x20), MPEG-2 (0x60-0x65), MPEG-1 (0x6a), "
                          f"Motion JPEG (0x6c), PNG (0x6d) and JPEG 2000 "
                          f"(0x6e) only "
                          f"({ITEM_8})")
    p += 13
    if p < dend:
        tag, p, e = _descriptor(es, p)
        if tag == 5:
            return codec, es[p:e]
    return codec, b""


class Mp4File:
    """The first video track of an ``.mp4``/``.mov``/``.3gp`` file: its
    codec (``mpeg4``, ``mjpeg``, ``mpeg12``, ``vp9`` or ``h263``), size
    (the sample entry's), samples' offsets
    and sizes, keyframes (sync samples), DecoderSpecificInfo and timing."""

    def __init__(self, path: str):
        self.path = path
        self._size = size = os.path.getsize(path)
        with open(path, "rb") as f:
            moov = None
            for typ, body, end in _boxes(f, 0, size, path):
                if typ == "moov":
                    moov = (body, end)
            if moov is None:
                raise ValueError(f"{path}: no moov box (not an MP4 file, or "
                                 "a truncated one)")
            try:
                self._movie_matrix(f, *moov)
                self._read_trak(f, self._video_trak(f, *moov))
            except (struct.error, KeyError, IndexError) as e:
                raise ValueError(f"{path}: malformed MP4 track ({e!r})") \
                    from e
        for off, n in zip(self.offsets, self.sizes):
            if off + n > size:
                raise ValueError(f"{path}: sample at byte {off} runs past the "
                                 "end of the file (truncated)")

    # ---- parsing

    def _children(self, f, body, end) -> Dict[str, Tuple[int, int]]:
        out: Dict[str, Tuple[int, int]] = {}
        for typ, b, e in _boxes(f, body, end, self.path):
            out.setdefault(typ, (b, e))
        return out

    def _read(self, f, span) -> bytes:
        f.seek(span[0])
        return f.read(span[1] - span[0])

    def _video_trak(self, f, body, end):
        for typ, b, e in _boxes(f, body, end, self.path):
            if typ != "trak":
                continue
            mdia = self._children(f, b, e).get("mdia")
            if not mdia:
                continue
            hdlr = self._children(f, *mdia).get("hdlr")
            if hdlr and self._read(f, hdlr)[8:12] == b"vide":
                return b, e
        raise ValueError(f"{self.path}: no video track")

    def _movie_matrix(self, f, body, end) -> None:
        """mvhd's matrix (identity without one)."""
        self._mvhd = [0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 1 << 30]
        mvhd = self._children(f, body, end).get("mvhd")
        if mvhd:
            ver, b = _full(self._read(f, mvhd))
            off = (28 if ver else 16) + 4 + 2 + 10   # past times, rate, volume
            self._mvhd = list(struct.unpack(">9i", b[off:off + 36]))

    def _orientation(self, tkhd: bytes) -> None:
        """mov_read_tkhd: the track's matrix times the movie's, the display
        matrix where it is not the identity; cv2's angle of it
        (``io/orientation``)."""
        ver, b = _full(tkhd)
        off = (32 if ver else 20) + 16        # past times, id, duration, ...
        m = struct.unpack(">9i", b[off:off + 36])
        sh = (16, 16, 30)
        res = [sum((m[3 * i + e] * self._mvhd[3 * e + j]) >> sh[e]
                   for e in range(3)) for i in range(3) for j in range(3)]
        ident = [0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 1 << 30]
        self.rotation = matrix_angle(None if res == ident else res)

    def _read_trak(self, f, trak) -> None:
        kids = self._children(f, *trak)
        self.rotation = 0       # cv2's orientation (io/orientation)
        if "tkhd" in kids:
            self._orientation(self._read(f, kids["tkhd"]))
        mdia = self._children(f, *kids["mdia"])
        ver, mdhd = _full(self._read(f, mdia["mdhd"]))
        self.timescale = struct.unpack(">I", mdhd[16:20] if ver else
                                       mdhd[8:12])[0]
        if not self.timescale:
            raise ValueError(f"{self.path}: mdhd timescale 0")
        elst = (self._children(f, *kids["edts"]).get("elst")
                if "edts" in kids else None)
        stbl = self._children(f, *self._children(f, *mdia["minf"])["stbl"])
        for need in ("stsd", "stts", "stsc", "stsz"):
            if need not in stbl:
                raise ValueError(f"{self.path}: no {need} box")
        self._read_stsd(self._read(f, stbl["stsd"]))
        self.sizes = self._stsz(self._read(f, stbl["stsz"]))
        n = len(self.sizes)
        if "stco" in stbl:
            _, b = _full(self._read(f, stbl["stco"]))
            cnt = struct.unpack(">I", b[:4])[0]
            chunks = list(struct.unpack(f">{cnt}I", b[4:4 + 4 * cnt]))
        elif "co64" in stbl:
            _, b = _full(self._read(f, stbl["co64"]))
            cnt = struct.unpack(">I", b[:4])[0]
            chunks = list(struct.unpack(f">{cnt}Q", b[4:4 + 8 * cnt]))
        else:
            raise ValueError(f"{self.path}: no stco or co64 box")
        self.offsets = self._sample_offsets(self._read(f, stbl["stsc"]),
                                            chunks, n)
        self.durations = self._stts(self._read(f, stbl["stts"]), n)
        if "stss" in stbl:
            _, b = _full(self._read(f, stbl["stss"]))
            cnt = struct.unpack(">I", b[:4])[0]
            self.keyframes = sorted(
                i - 1 for i in struct.unpack(f">{cnt}I", b[4:4 + 4 * cnt]))
        else:
            self.keyframes = list(range(n))
        # each sample's composition offset (``ctts``, version 0 or 1: signed)
        self.ctts = [0] * n
        if "ctts" in stbl:
            _, b = _full(self._read(f, stbl["ctts"]))
            cnt = struct.unpack(">I", b[:4])[0]
            k = 0
            for j in range(cnt):
                run, off = struct.unpack(">Ii", b[4 + 8 * j:12 + 8 * j])
                for _ in range(run):
                    if k < n:
                        self.ctts[k] = off
                    k += 1
        if elst:
            self._check_edits(self._read(f, elst), self._first_shown())

    def _first_shown(self) -> int:
        """The composition time of the first picture shown (0 without a
        ``ctts``): where the mov muxer's edit list starts a track whose
        pictures are reordered or delayed (MPEG-1/2, H.264 with B
        pictures)."""
        dts, best = 0, None
        for d, off in zip(self.durations, self.ctts):
            best = dts + off if best is None else min(best, dts + off)
            dts += d
        return best or 0

    @property
    def video_delay(self) -> int:
        """mov.c's mov_estimate_video_delay for H.264: the most places a
        sample's composition time moves back past those decoded before it
        (within a window of 17), 0 without a ``ctts``."""
        if self.codec != "h264" or not any(self.ctts):
            return 0
        buf, delay, dts = [], 0, 0
        for d, off in zip(self.durations, self.ctts):
            buf = (buf + [dts + off])[-17:]
            j = len(buf) - 1
            swaps = 0
            while j > 0 and buf[j] < buf[j - 1]:
                buf[j], buf[j - 1] = buf[j - 1], buf[j]
                swaps += 1
                j -= 1
            delay = max(delay, swaps)
            dts += d
        return delay

    def _check_edits(self, body: bytes, shown: int = 0) -> None:
        ver, b = _full(body)
        cnt = struct.unpack(">I", b[:4])[0]
        step = 20 if ver else 12
        fmt = ">QqI" if ver else ">IiI"
        media = [struct.unpack(fmt, b[4 + i * step:4 + (i + 1) * step])[1]
                 for i in range(cnt)]
        # an edit that starts at the first picture shown changes no frame
        if len([m for m in media if m != -1]) > 1 or any(
                m > 0 and not (self.codec in ("mpeg12", "h264") and m == shown)
                for m in media):
            raise Unsupported(f"{self.path}: an edit list that starts the "
                              "track past its first sample or splices it; "
                              f"not read by the port ({ITEM_8})")

    def _read_stsd(self, body: bytes) -> None:
        _, b = _full(body)
        if struct.unpack(">I", b[:4])[0] < 1:
            raise ValueError(f"{self.path}: empty stsd")
        size, fourcc = struct.unpack(">I4s", b[4:12])
        fourcc = fourcc.decode("latin1")
        entry = b[12:4 + size]
        self.tag = fourcc
        if (fourcc not in ("mp4v", "vp09", "FFV1") + H263_ENTRIES + H264_ENTRIES
                and fourcc not in _INTRA_ENTRIES
                and fourcc not in _ISOM_ENTRIES
                and fourcc.upper() not in _RIFF_ENTRIES):
            name = VIDEO_CODECS.get(fourcc, f"the {fourcc!r} codec")
            raise Unsupported(f"{self.path}: {name} video (sample entry "
                              f"{fourcc!r}): the port decodes the mp4v "
                              f"entry (MPEG-4 Part 2, MPEG-1/2, Motion JPEG, "
                              f"PNG), vp09 (VP9), FFV1, s263/h263 (H.263), "
                              f"FLV1 (Sorenson H.263), jpeg, png, RGBA, HFYU, "
                              f"FFVH, UL**, M8** (MagicYUV), ASV1/ASV2, MP42, "
                              f"avc1/avc3 (H.264), "
                              f"DIV3/3IVD, WMV1/WMV2, SNOW, drac (Dirac), "
                              f"mjp2/MJ2C (JPEG 2000), yuv4, tiff, MJLS (JPEG-LS), "
                              f"SHQ0 (SpeedHQ), 3IV2/XVID/DIVX "
                              f"(MPEG-4 Part 2) and m1v /m2v1 (MPEG-1/2) only "
                              f"({ITEM_8})")
        self.width, self.height = struct.unpack(">HH", entry[24:28])
        self.bpc = struct.unpack(">H", entry[74:76])[0]
        self.codec = ("vp9" if fourcc == "vp09" else
                      "h264" if fourcc in H264_ENTRIES else
                      "ffv1" if fourcc == "FFV1" else
                      "h263" if fourcc in H263_ENTRIES else
                      _ISOM_ENTRIES.get(fourcc) or
                      _RIFF_ENTRIES.get(fourcc.upper()) or
                      _INTRA_ENTRIES.get(fourcc, "mpeg4"))
        self.dsi = b""
        pos = 78   # VisualSampleEntry fields
        while pos + 8 <= len(entry):
            n, t = struct.unpack(">I4s", entry[pos:pos + 8])
            if n < 8:
                break
            if t == b"esds" and (fourcc == "mp4v" or self.codec == "h264"):
                # mov_read_esds: the objectTypeIndication names the codec,
                # whatever the entry's fourcc
                self.codec, self.dsi = _esds(entry[pos + 8:pos + n],
                                             self.path)
            elif t == b"glbl" and fourcc != "mp4v":   # the extradata
                self.dsi = entry[pos + 8:pos + n]
            elif t == b"vpcC":
                self._vpcc(entry[pos + 8:pos + n])
            elif t == b"avcC" and fourcc in H264_ENTRIES and \
                    self.codec == "h264":
                self.dsi = entry[pos + 8:pos + n]
            pos += n
        if self.codec == "h264" and not self.dsi:
            # FFmpeg's h264 decoder cannot split the samples' NAL units
            # without the avcC's length size: cv2 reads no frame
            raise ValueError(f"{self.path}: an {fourcc!r} sample entry "
                             "without its avcC box")

    def _vpcc(self, body: bytes) -> None:
        """VP9's codec configuration (version 1): its profile, bit depth
        and range flag."""
        if len(body) < 8:
            raise ValueError(f"{self.path}: truncated vpcC box")
        profile, depth = body[4], body[6] >> 4
        if profile or depth not in (0, 8):
            raise Unsupported(f"{self.path}: VP9 profile {profile}, "
                              f"{depth}-bit (vpcC), not read by the port "
                              f"({ITEM_8})")
        self.full_range = bool(body[6] & 1)

    def _stsz(self, body: bytes) -> List[int]:
        _, b = _full(body)
        fixed, cnt = struct.unpack(">II", b[:8])
        if cnt > self._size or fixed * cnt > self._size:
            raise ValueError(f"{self.path}: stsz counts {cnt} samples"
                             + (f" of {fixed} bytes" if fixed else "")
                             + f" in a file of {self._size} bytes")
        if fixed:
            return [fixed] * cnt
        if len(b) < 8 + 4 * cnt:
            raise ValueError(f"{self.path}: truncated stsz")
        return list(struct.unpack(f">{cnt}I", b[8:8 + 4 * cnt]))

    def _sample_offsets(self, body: bytes, chunks: List[int], n: int):
        _, b = _full(body)
        cnt = struct.unpack(">I", b[:4])[0]
        runs = [struct.unpack(">III", b[4 + 12 * i:16 + 12 * i])
                for i in range(cnt)]
        offsets: List[int] = []
        k = 0
        for r, (first, per, _) in enumerate(runs):
            last = runs[r + 1][0] - 1 if r + 1 < len(runs) else len(chunks)
            for c in range(first - 1, last):
                if c >= len(chunks):
                    raise ValueError(f"{self.path}: stsc names chunk {c + 1} "
                                     f"of {len(chunks)}")
                off = chunks[c]
                for _ in range(per):
                    if k >= n:
                        break
                    offsets.append(off)
                    off += self.sizes[k]
                    k += 1
        if k != n:
            raise ValueError(f"{self.path}: stsc/stco cover {k} of {n} "
                             "samples")
        return offsets

    def _stts(self, body: bytes, n: int) -> List[int]:
        _, b = _full(body)
        cnt = struct.unpack(">I", b[:4])[0]
        out: List[int] = []
        for i in range(cnt):
            if len(out) >= n:
                break
            c, d = struct.unpack(">II", b[4 + 8 * i:12 + 8 * i])
            out += [d] * min(c, n - len(out))   # a count past n is not kept
        return (out + [out[-1] if out else 0] * n)[:n]

    # ---- what the readers use

    @property
    def frames(self) -> int:
        return len(self.sizes)

    @property
    def fps(self) -> float:
        """FFmpeg's avg_frame_rate: timescale · samples / Σ durations."""
        total = sum(self.durations)
        return self.timescale * len(self.sizes) / total if total else 0.0

    def sample(self, f: BinaryIO, i: int) -> bytes:
        f.seek(self.offsets[i])
        data = f.read(self.sizes[i])
        if len(data) != self.sizes[i]:
            raise ValueError(f"{self.path}: sample {i} is truncated")
        return data


# ----------------------------------------------------------------- writer

def _box(typ: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), typ) + body


def _fullbox(typ: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags), *parts)


def _desc(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
# the ftyp the mov muxer writes for each extension: (major brand, minor
# version, compatible brands); .mov is QuickTime mode
BRANDS = {".mp4": (b"isom", 0x200, b"isomiso2mp41"),
          ".m4v": (b"M4V ", 0x200, b"M4V isomiso2"),
          ".3gp": (b"3gp4", 0x200, b"3gp4isomiso2"),
          ".3g2": (b"3g2a", 0x10000, b"3g2aisomiso2"),
          ".mov": (b"qt  ", 0x200, b"qt  ")}


class Mp4Writer:
    """MPEG-4 Part 2 samples → an ``.mp4``, ``.m4v``, ``.3gp``, ``.3g2``
    or ``.mov`` file (the brand by the extension, :data:`BRANDS`).
    ``rate`` is the frame rate as (numerator, denominator); ``dsi`` the
    VOS/VO/VOL headers."""

    def __init__(self, path: str, size: Tuple[int, int], rate: Tuple[int, int],
                 dsi: bytes):
        self.path = path
        self.w, self.h = size
        self.num, self.den = rate
        self.dsi = dsi
        self.sizes: List[int] = []
        self.keys: List[int] = []
        ext = os.path.splitext(path)[1].lower()
        if ext not in BRANDS:
            raise ValueError(f"cannot write {path!r} as ISO BMFF: the "
                             f"extension names none of {sorted(BRANDS)}")
        major, minor, compatible = BRANDS[ext]
        self.qt = major == b"qt  "
        self._f: Optional[BinaryIO] = open(path, "wb")
        ftyp = _box(b"ftyp", major, struct.pack(">I", minor), compatible)
        self._f.write(ftyp)
        self._mdat = len(ftyp)
        # "free" ("wide" in QuickTime) then a 32-bit mdat header; a 64-bit
        # mdat takes both
        self._f.write(_box(b"wide" if self.qt else b"free")
                      + struct.pack(">I4s", 0, b"mdat"))
        self._data = self._mdat + 16

    def write(self, sample: bytes, key: bool) -> None:
        if key:
            self.keys.append(len(self.sizes) + 1)
        self.sizes.append(len(sample))
        self._f.write(sample)

    def release(self) -> None:
        f, self._f = self._f, None
        if f is None:
            return
        try:
            end = f.tell()
            n = end - self._mdat - 8
            f.seek(self._mdat)
            if n < 1 << 32:
                f.write(_box(b"wide" if self.qt else b"free")
                        + struct.pack(">I4s", n, b"mdat"))
            else:
                f.write(struct.pack(">I4sQ", 1, b"mdat", end - self._mdat))
            f.seek(end)
            f.write(self._moov())
        finally:
            f.close()

    def _moov(self) -> bytes:
        n = len(self.sizes)
        ts, dur = self.num, self.den * n
        ms = dur * 1000 // ts
        mvhd = _fullbox(b"mvhd", 0, 0, struct.pack(
            ">IIIIIH10x", 0, 0, 1000, ms, 0x10000, 0x100), _MATRIX,
            b"\0" * 24, struct.pack(">I", 2))
        tkhd = _fullbox(b"tkhd", 0, 3, struct.pack(
            ">IIIII8xhhH2x", 0, 0, 1, 0, ms, 0, 0, 0), _MATRIX,
            struct.pack(">II", self.w << 16, self.h << 16))
        mdhd = _fullbox(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, ts, dur, 0x7FFF if self.qt else 0x55C4, 0))
        if self.qt:
            hdlr = _fullbox(b"hdlr", 0, 0, b"mhlrvide", b"\0" * 12,
                            b"\x0cVideoHandler")
            dhlr = _fullbox(b"hdlr", 0, 0, b"dhlrurl ", b"\0" * 12,
                            b"\x0bDataHandler")
        else:
            hdlr = _fullbox(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                            b"VideoHandler\0")
            dhlr = b""
        vmhd = _fullbox(b"vmhd", 0, 1, b"\0" * 8)
        dinf = _box(b"dinf", _fullbox(b"dref", 0, 0, struct.pack(">I", 1),
                                      _fullbox(b"url ", 0, 1)))
        bitrate = sum(self.sizes) * 8 * self.num // max(self.den * n, 1)
        dcd = (bytes([0x20, 0x11]) + struct.pack(">I", max(self.sizes or [0])
                                                 )[1:]
               + struct.pack(">II", bitrate, bitrate) + _desc(5, self.dsi))
        esd = _desc(3, struct.pack(">HB", 1, 0) + _desc(4, dcd)
                    + _desc(6, b"\x02"))
        esds = _fullbox(b"esds", 0, 0, esd)
        entry = _box(b"mp4v", b"\0" * 6, struct.pack(">H", 1),
                     struct.pack(">4x4sII", b"FFMP", 0x200, 0x200) if self.qt
                     else b"\0" * 16,
                     struct.pack(">HHIIIH", self.w, self.h, 0x480000,
                                 0x480000, 0, 1), b"\0" * 32,
                     struct.pack(">Hh", 0x18, -1), esds)
        stsd = _fullbox(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _fullbox(b"stts", 0, 0, struct.pack(">III", 1, n, self.den))
        stss = _fullbox(b"stss", 0, 0, struct.pack(f">I{len(self.keys)}I",
                                                   len(self.keys), *self.keys))
        stsc = _fullbox(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
        stsz = _fullbox(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n,
                                                   *self.sizes))
        if self._data < 1 << 32:
            stco = _fullbox(b"stco", 0, 0, struct.pack(">II", 1, self._data))
        else:
            stco = _fullbox(b"co64", 0, 0, struct.pack(">IQ", 1, self._data))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        minf = _box(b"minf", vmhd, dhlr, dinf, stbl)
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))
