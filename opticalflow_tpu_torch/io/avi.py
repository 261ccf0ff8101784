"""RIFF AVI video: the demuxer and muxer of the port's video path, in
Python (no FFmpeg).

:class:`AviFile` reads the first video stream: ``avih``, ``strh``/``strf``
(``fccHandler``, ``biCompression`` and the extradata after the
BITMAPINFOHEADER), the ``##dc``/``##db`` chunks of every ``movi`` list
(``RIFF AVIX`` continuations included) and ``idx1`` with its keyframe
flags.  It knows these payloads, by ``biCompression`` as FFmpeg picks the
codec:

  * MPEG-4 Part 2 (``FMP4``, ``XVID``, ``DIVX``, ``DX50``, ``mp4v``,
    ``MP4V``, ``3IV2``): decoded by ``runtime/mpeg4``;
  * Motion JPEG (``MJPG``, ``mjpg``, ``LJPG``): one JPEG a chunk, every
    frame a keyframe, decoded by ``runtime/jpeg``'s FFmpeg flavour;
  * raw I420 (``I420``, ``IYUV``): Y, U and V planes;
  * VP8 (``VP80``): decoded by ``runtime/vp8``, a key frame a keyframe;
  * MPEG-1 and MPEG-2 (``PIM1``, ``mpg1``, ``mpg2``, ``MPEG``, ...: the
    tags FFmpeg's ``riff.c`` maps to ``mpeg1video``/``mpeg2video``, in any
    case): decoded by ``runtime/mpeg12``;
  * H.263 (``H263``, ``U263``, ``X263``, ...: the tags ``riff.c`` maps to
    ``h263``, in any case): decoded by ``runtime/h263``, keyframes from
    ``idx1``;
  * FFV1 (``FFV1``): decoded by ``runtime/ffv1``, its extradata after the
    BITMAPINFOHEADER, keyframes from ``idx1``;
  * HuffYUV and FFVHuff (``HFYU``, ``FFVH``, in any case): decoded by
    ``runtime/huffyuv`` from the extradata and ``biBitCount``; Ut Video
    (``ULRG``, ``ULRA``, ``ULY0``, ``ULY2``, ``ULY4``, ``ULH0``, ``ULH2``,
    ``ULH4``; ``UQ**`` and ``UM**`` raise there): ``runtime/utvideo``;
    PNG (``MPNG``, ``PNG1``, ``png ``): one PNG file a chunk, decoded by
    ``io/images.decode_png``;
  * MagicYUV (``M8Y0``, ``M8RG``, ``MAGY``, ...: riff.c's tags, in any
    case): decoded by ``runtime/magicyuv``, its layout in each packet;
    Sorenson H.263 (``FLV1``): ``runtime/h263``'s Sorenson reading,
    keyframes from ``idx1``; ASUS V1/V2 (``ASV1``, ``ASV2``):
    ``runtime/asv``, its quantiser in the extradata;
  * MS-MPEG4 v2 (``MP42``, ``DIV2``), v3 (``DIV3``, ``MP43``, ``MPG3``,
    ``DIV4``-``DIV6``, ``DVX3``, ``AP41``, ``COL0``, ``COL1``), WMV7
    (``WMV1``) and WMV8 (``WMV2``, ``GXVE``; its 4 bytes of extradata
    after the BITMAPINFOHEADER), in any case (``MSMPEG4_TAGS``): decoded
    by ``runtime/msmpeg4`` at the header's size, keyframes from ``idx1``;
    v1's ``MPG4`` and ``MP41`` raise;
  * Snow (``SNOW``, in any case): decoded by ``runtime/snow`` at the
    header's size, keyframes from ``idx1``;
  * Dirac/VC-2 (``drac``, in any case: what ``cv2.VideoWriter`` writes for
    it): decoded by ``runtime/dirac``, every picture intra, so every frame
    a keyframe;
  * JPEG 2000 (``MJ2C``, ``mjp2``, ``LJ2C``, ``LJ2K``, ``IPJ2``,
    ``AVj2``, in any case): decoded by ``runtime/jpeg2000``, every frame a
    keyframe; libavcodec's packed 4:2:0 ``yuv4`` (codec ``yuv4``); TIFF
    (``tiff``, in any case: riff.c's ``TIFF``): ``runtime/tiff``; JPEG-LS
    (``MJLS``): ``runtime/jpegls``; SpeedHQ (``SHQ0``-``SHQ9``, in any
    case): ``runtime/speedhq``; every frame of these a keyframe;
  * raw ``Y800``/``GREY``/``Y8  `` (grey), ``YV12`` (I420 with its chroma
    planes swapped), ``NV12`` (interleaved chroma), ``Y41B`` (yuv411p),
    ``RGBA`` and 32-bit ``BI_RGB`` (tag 0, bottom-up), read as FFmpeg's
    rawvideo decoder reads them (codec ``raw``, the layout in ``tag``).

Anything else (``H264``, Matrox's intra-only ``M701``-``M705``,
``slif``, ...) raises ``Unsupported``, naming ROADMAP
Queue 1 item 8.  fps is ``rate / scale`` of the stream header, the frame
count the number of the stream's chunks, as ``cv2.VideoCapture`` reports
them.

:class:`AviWriter` writes MPEG-4 Part 2 samples under ``FMP4`` (FFmpeg's
own fourcc, which selects no other decoder's workarounds), with ``idx1``;
under ``fourcc="MJPG"`` it muxes JPEG files as Motion JPEG (the tests and
``chip_smoke.py`` build MJPEG sources with it; the port encodes no JPEG).
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, List, Optional, Tuple

from opticalflow_tpu_torch.runtime.ffv1 import is_keyframe as ffv1_is_keyframe
from opticalflow_tpu_torch.runtime.h263 import is_intra as is_h263_intra
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
from opticalflow_tpu_torch.runtime.msmpeg4 import VERSIONS as _MSMPEG4
from opticalflow_tpu_torch.runtime.msmpeg4 import \
    is_keyframe as msmpeg4_is_keyframe
from opticalflow_tpu_torch.runtime.snow import is_keyframe as snow_is_keyframe
from opticalflow_tpu_torch.runtime.vp8 import is_keyframe

__all__ = ["AviFile", "AviWriter", "ASV_TAGS", "FLV1_TAGS", "H263_TAGS",
           "H264_TAGS",
           "HUFFYUV_TAGS", "MAGICYUV_TAGS", "MJPEG_TAGS", "MPEG4_TAGS",
           "MSMPEG4_TAGS", "SNOW_TAGS", "JPEG2000_TAGS", "YUV4_TAGS",
           "MPEG12_TAGS", "PNG_TAGS", "RAW_LAYOUTS", "RAW_TAGS",
           "UTVIDEO_TAGS", "VP8_TAGS", "VP9_TAGS", "codec_of"]

MPEG4_TAGS = {"FMP4", "XVID", "xvid", "DIVX", "divx", "DX50", "mp4v", "MP4V",
              "3IV2", "3iv2"}
MJPEG_TAGS = {"MJPG", "mjpg", "JPEG", "jpeg", "LJPG"}
RAW_TAGS = {"I420", "IYUV"}
# the other rawvideo layouts cv2's writer names (riff.c's tags, raw.c's
# pixel formats): grey, I420 with V before U, NV12 (interleaved chroma),
# yuv411p and RGBA; and BI_RGB (tag 0; 32 bits, BGR0, bottom-up where
# biHeight is positive; 24 bits refused)
RAW_LAYOUTS = {"Y800": "gray", "GREY": "gray", "Y8  ": "gray",
               "YV12": "yv12", "NV12": "nv12", "Y41B": "yuv411p",
               "RGBA": "rgba", "\0\0\0\0": "dib"}
# riff.c's tags of jpeg2000 and of yuv4 (libavcodec's packed 4:2:0),
# matched without regard to case
JPEG2000_TAGS = {"MJ2C", "MJP2", "LJ2C", "LJ2K", "IPJ2", "AVJ2"}
# riff.c's tags of tiff (cv2's writer falls back to "tiff" itself), of
# jpegls and of speedhq (SHQ0-SHQ9: the layout in the tag's digit)
TIFF_TAGS = {"TIFF"}
JPEGLS_TAGS = {"MJLS"}
SPEEDHQ_TAGS = {f"SHQ{k}" for k in range(10)}
YUV4_TAGS = {"YUV4"}
# riff.c's tags of huffyuv/ffvhuff, utvideo and png, matched without
# regard to case (Ut Video's decoder takes its own tags in upper case)
HUFFYUV_TAGS = {"HFYU", "FFVH"}
UTVIDEO_TAGS = {"ULRA", "ULRG", "ULY0", "ULY2", "ULY4", "ULH0", "ULH2",
                "ULH4", "UQY0", "UQY2", "UQY4", "UQRA", "UQRG", "UMY2",
                "UMH2", "UMY4", "UMH4", "UMRA", "UMRG"}
PNG_TAGS = {"MPNG", "PNG1", "PNG "}
# riff.c's tags of magicyuv (its layout is in each packet: the M0**/M2**
# tags name 10- and 12-bit layouts, which the decoder refuses), flv and
# asv1/asv2, matched without regard to case
MAGICYUV_TAGS = {"MAGY", "M8RG", "M8RA", "M8G0", "M8Y0", "M8Y2", "M8Y4",
                 "M8YA", "M0RA", "M0RG", "M0G0", "M0Y0", "M0Y2", "M0Y4",
                 "M2RA", "M2RG"}
FLV1_TAGS = {"FLV1"}
ASV_TAGS = {"ASV1", "ASV2"}
VP8_TAGS = {"VP80"}
VP9_TAGS = {"VP90"}
FFV1_TAGS = {"FFV1"}
# FFmpeg's BITMAPINFOHEADER tags of mpeg1video and mpeg2video (riff.c),
# which it matches without regard to case
MPEG12_TAGS = {"MPG1", "MPG2", "MPEG", "PIM1", "PIM2", "VCR2",
               "\x01\x00\x00\x10", "\x02\x00\x00\x10", "DVR ", "MMES",
               "LMP2", "EM2V", "MPGV", "BW10", "XMPG"}
# riff.c's tags of h263, matched without regard to case (ZyGo's pictures
# carry data FFmpeg reads past, which the port does not)
H263_TAGS = {"H263", "X263", "T263", "L263", "VX1K", "M263", "LSVM", "U263",
             "VSM4"}
# riff.c's tags of msmpeg4v2, msmpeg4v3, wmv1 and wmv2, matched without
# regard to case (each checked with cv2 on a rewritten fixture); v1's
# MPG4 and MP41 are refused
MSMPEG4_TAGS = {"MP42": "msmpeg4v2", "DIV2": "msmpeg4v2",
                **{t: "msmpeg4v3" for t in ("DIV3", "MP43", "MPG3", "DIV4",
                                            "DIV5", "DIV6", "DVX3", "AP41",
                                            "COL0", "COL1")},
                "WMV1": "wmv1", "WMV2": "wmv2", "GXVE": "wmv2"}
# riff.c's tag of snow, matched without regard to case
SNOW_TAGS = {"SNOW"}
# riff.c's tag of dirac, matched without regard to case
DIRAC_TAGS = {"DRAC"}
# riff.c's tags of h264, matched without regard to case: Annex B packets,
# the parameter sets in the extradata or in band
H264_TAGS = {"H264", "X264", "AVC1", "DAVC", "SMV2", "VSSH", "Q264", "V264",
             "GAVC", "UMSV", "TSHD", "INMC"}
_NAMES = {"ZyGo": "ZyGo H.263", "I263": "Intel H.263",
          "HEVC": "HEVC", "hev1": "HEVC",
          "MPG4": "MS-MPEG4 v1", "MP41": "MS-MPEG4 v1", "WMV3": "WMV9"}
_KEYFRAME = 0x10   # AVIIF_KEYFRAME
_RIFF_MAX = (1 << 32) - 1


class AviFile:
    """The first video stream of an AVI file."""

    def __init__(self, path: str):
        self.path = path
        self.offsets: List[int] = []
        self.sizes: List[int] = []
        self.dsi = b""
        self.scale = self.rate = 0
        self.bpc = 0    # biBitCount, FFmpeg's bits_per_coded_sample
        self.bottom_up = False
        self.tag = ""
        self._stream: Optional[int] = None
        size = os.path.getsize(path)
        idx1: Optional[List[Tuple[bytes, int, int, int]]] = None
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
                raise ValueError(f"{path}: not an AVI file")
            pos = 0
            while pos + 12 <= size:
                f.seek(pos)
                riff, n, form = struct.unpack("<4sI4s", f.read(12))
                if riff != b"RIFF" or form not in (b"AVI ", b"AVIX"):
                    break
                end = min(pos + 8 + n, size)
                try:
                    idx = self._riff(f, pos + 12, end)
                except (struct.error, IndexError) as e:
                    raise ValueError(f"{path}: malformed AVI ({e!r})") from e
                if idx1 is None:
                    idx1 = idx
                pos = pos + 8 + n + (n & 1)
        if self._stream is None:
            raise ValueError(f"{path}: no video stream")
        if not self.sizes:
            raise ValueError(f"{path}: no video frames (truncated file?)")
        self.keyframes = self._keys(idx1 or [])

    def _riff(self, f, start: int, end: int):
        """Read one RIFF chunk's lists; returns its idx1 entries."""
        idx1 = []
        pos = start
        while pos + 8 <= end:
            f.seek(pos)
            fcc, n = struct.unpack("<4sI", f.read(8))
            if fcc == b"LIST":
                kind = f.read(4)
                if kind == b"hdrl":
                    self._hdrl(f, pos + 12, min(pos + 8 + n, end))
                elif kind == b"movi":
                    self._movi(f, pos + 12, min(pos + 8 + n, end))
            elif fcc == b"idx1":
                data = f.read(min(n, end - pos - 8))
                idx1 = [struct.unpack("<4sIII", data[i:i + 16])
                        for i in range(0, len(data) - 15, 16)]
            pos += 8 + n + (n & 1)
        return idx1

    def _hdrl(self, f, start: int, end: int) -> None:
        pos, stream = start, -1
        while pos + 8 <= end:
            f.seek(pos)
            fcc, n = struct.unpack("<4sI", f.read(8))
            if fcc == b"LIST" and f.read(4) == b"strl":
                stream += 1
                if self._stream is None:
                    self._strl(f, pos + 12, min(pos + 8 + n, end), stream)
            pos += 8 + n + (n & 1)

    def _strl(self, f, start: int, end: int, stream: int) -> None:
        pos, video = start, False
        while pos + 8 <= end:
            f.seek(pos)
            fcc, n = struct.unpack("<4sI", f.read(8))
            body = f.read(min(n, end - pos - 8))
            if fcc == b"strh" and body[:4] == b"vids":
                video = True
                self.scale, self.rate = struct.unpack("<II", body[20:28])
            elif fcc == b"strf" and video:
                if len(body) < 40:
                    raise ValueError(f"{self.path}: truncated strf")
                self.width, h, _, self.bpc, comp = struct.unpack(
                    "<iiHH4s", body[4:20])
                self.height = abs(h)
                self.tag = comp.decode("latin1")
                # avidec flags BI_RGB bottom-up ("BottomUp" extradata)
                self.bottom_up = self.tag == "\0\0\0\0" and h > 0
                self.dsi = body[40:]
            pos += 8 + n + (n & 1)
        if video:
            self._stream = stream
            self.codec = codec_of(self.tag, self.path)

    def _movi(self, f, start: int, end: int) -> None:
        want = (b"%02d" % self._stream) if self._stream is not None else None
        pos = start
        while pos + 8 <= end:
            f.seek(pos)
            fcc, n = struct.unpack("<4sI", f.read(8))
            if fcc == b"LIST":   # rec lists hold the chunks
                self._movi(f, pos + 12, min(pos + 8 + n, end))
            elif fcc[:2] == want and fcc[2:] in (b"dc", b"db"):
                if pos + 8 + n > end:
                    raise ValueError(f"{self.path}: frame {len(self.sizes)} "
                                     "is truncated")
                self.offsets.append(pos + 8)
                self.sizes.append(n)
            pos += 8 + n + (n & 1)

    def _keys(self, idx1) -> List[int]:
        """Indices of the keyframes: idx1's flags for the frames it covers;
        frames past it (AVIX parts) count as keyframes when they are
        MPEG-4 I-VOPs, H.263, Sorenson or MS-MPEG4/WMV I-pictures, FFV1,
        Snow or VP8 key frames; all raw, intra-only and Motion JPEG frames
        are."""
        if self.codec not in ("mpeg4", "vp8", "h263", "flv1", "ffv1",
                              "snow") + tuple(_MSMPEG4):
            return list(range(len(self.sizes)))
        want = b"%02d" % self._stream
        flags = [fl for fcc, fl, _, _ in idx1
                 if fcc[:2] == want and fcc[2:] in (b"dc", b"db")]
        keys = [i for i, fl in enumerate(flags[:len(self.sizes)])
                if fl & _KEYFRAME]
        if len(flags) < len(self.sizes):
            with open(self.path, "rb") as f:
                for i in range(len(flags), len(self.sizes)):
                    f.seek(self.offsets[i])
                    head = f.read(min(self.sizes[i], 4096))
                    if (_is_ivop(head) if self.codec == "mpeg4" else
                            is_h263_intra(head) if self.codec == "h263" else
                            is_h263_intra(head, sorenson=True)
                            if self.codec == "flv1" else
                            ffv1_is_keyframe(head) if self.codec == "ffv1"
                            else snow_is_keyframe(head)
                            if self.codec == "snow"
                            else msmpeg4_is_keyframe(head, self.codec)
                            if self.codec in _MSMPEG4
                            else is_keyframe(head)):
                        keys.append(i)
        return keys or [0]

    @property
    def frames(self) -> int:
        return len(self.sizes)

    @property
    def fps(self) -> float:
        return self.rate / self.scale if self.scale else 0.0

    def sample(self, f: BinaryIO, i: int) -> bytes:
        f.seek(self.offsets[i])
        data = f.read(self.sizes[i])
        if len(data) != self.sizes[i]:
            raise ValueError(f"{self.path}: frame {i} is truncated")
        return data


def codec_of(tag: str, what: str) -> str:
    """The codec FFmpeg picks for a BITMAPINFOHEADER's ``biCompression``:
    ``mpeg4``, ``mjpeg``, ``i420``, ``raw`` (the layout by
    ``RAW_LAYOUTS``), ``vp8``, ``vp9``, ``mpeg12``, ``h263``, ``flv1``,
    ``ffv1``, ``huffyuv``, ``utvideo``, ``magicyuv``, ``asv``, ``png``,
    ``snow``, ``dirac``, ``jpeg2000``, ``yuv4``, ``tiff``, ``jpegls``,
    ``speedhq``, ``h264`` or one of
    ``MSMPEG4_TAGS``' codecs; anything else raises
    ``Unsupported`` naming ROADMAP Queue 1 item 8."""
    if tag in MPEG4_TAGS:
        return "mpeg4"
    if tag in MJPEG_TAGS:
        return "mjpeg"
    if tag in RAW_TAGS:
        return "i420"
    if tag in VP8_TAGS:
        return "vp8"
    if tag in VP9_TAGS:
        return "vp9"
    if tag.upper() in MPEG12_TAGS:
        return "mpeg12"
    if tag.upper() in H263_TAGS:
        return "h263"
    if tag in FFV1_TAGS:
        return "ffv1"
    if tag in RAW_LAYOUTS:
        return "raw"
    if tag.upper() in HUFFYUV_TAGS:
        return "huffyuv"
    if tag.upper() in UTVIDEO_TAGS:
        return "utvideo"
    if tag.upper() in PNG_TAGS:
        return "png"
    if tag.upper() in MAGICYUV_TAGS:
        return "magicyuv"
    if tag.upper() in FLV1_TAGS:
        return "flv1"
    if tag.upper() in ASV_TAGS:
        return "asv"
    if tag.upper() in H264_TAGS:
        return "h264"
    if tag.upper() in MSMPEG4_TAGS:
        return MSMPEG4_TAGS[tag.upper()]
    if tag.upper() in SNOW_TAGS:
        return "snow"
    if tag.upper() in DIRAC_TAGS:
        return "dirac"
    if tag.upper() in JPEG2000_TAGS:
        return "jpeg2000"
    if tag.upper() in YUV4_TAGS:
        return "yuv4"
    if tag.upper() in TIFF_TAGS:
        return "tiff"
    if tag.upper() in JPEGLS_TAGS:
        return "jpegls"
    if tag.upper() in SPEEDHQ_TAGS:
        return "speedhq"
    name = _NAMES.get(tag.upper(), _NAMES.get(tag, f"the {tag!r} codec"))
    raise Unsupported(f"{what}: {name} video (fourcc {tag!r}): the port "
                      f"reads MPEG-4 Part 2, MPEG-1, MPEG-2, H.263, Sorenson "
                      f"H.263, MS-MPEG4 v2/v3, WMV7/8, Snow, Dirac, JPEG "
                      f"2000, TIFF, JPEG-LS, SpeedHQ, FFV1, HuffYUV, FFVHuff, Ut Video, MagicYUV, "
                      f"ASUS V1/V2, PNG, Motion JPEG, yuv4, raw I420, YV12, "
                      f"NV12, Y41B, Y800 and RGBA, VP8 and VP9 only "
                      f"({ITEM_8})")


def _is_ivop(head: bytes) -> bool:
    i = head.find(b"\x00\x00\x01\xb6")
    return i >= 0 and i + 4 < len(head) and head[i + 4] >> 6 == 0


class AviWriter:
    """MPEG-4 Part 2 samples (with in-band VOL headers) → an AVI file
    under fourcc ``FMP4``, with an ``idx1`` index; or other samples under
    ``fourcc`` (``MJPG``: one JPEG file a frame), with ``extradata`` after
    the BITMAPINFOHEADER and ``bpc`` as its ``biBitCount``."""

    def __init__(self, path: str, size: Tuple[int, int],
                 rate: Tuple[int, int], fourcc: str = "FMP4",
                 extradata: bytes = b"", bpc: int = 24):
        self.path = path
        self.w, self.h = size
        self.num, self.den = rate
        self.fourcc = fourcc.encode("latin1")
        self.extradata, self.bpc = bytes(extradata), bpc
        self.index: List[Tuple[int, int, bool]] = []
        self._f: Optional[BinaryIO] = open(path, "wb")
        self._f.write(self._header(0, 0))
        self._movi = self._f.tell() - 4   # the 'movi' fourcc

    def _header(self, frames: int, maxsize: int) -> bytes:
        usec = int(round(1e6 * self.den / self.num))
        avih = struct.pack("<10I16x", usec, 0, 0, 0x10, frames, 0, 1,
                           maxsize, self.w, self.h)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", self.fourcc, 0,
                           0, 0, 0, self.den, self.num, 0, frames, maxsize,
                           0xFFFFFFFF, 0, 0, 0, self.w, self.h)
        strf = struct.pack("<IiiHH4sIiiII", 40 + len(self.extradata),
                           self.w, self.h, 1, self.bpc, self.fourcc,
                           self.w * self.h * 3, 0, 0, 0, 0) + self.extradata
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
        return b"RIFF\0\0\0\0AVI " + hdrl + b"LIST\0\0\0\0movi"

    def write(self, sample: bytes, key: bool) -> None:
        f = self._f
        pos = f.tell()
        if pos + 8 + len(sample) + 16 * (len(self.index) + 1) > _RIFF_MAX:
            raise ValueError(f"{self.path}: AVI output past 4 GiB is not "
                             "written (use .mp4)")
        self.index.append((pos - self._movi, len(sample), key))
        f.write(_chunk(b"00dc", sample))

    def release(self) -> None:
        f, self._f = self._f, None
        if f is None:
            return
        try:
            end = f.tell()
            f.seek(self._movi - 4)
            f.write(struct.pack("<I", end - self._movi))
            f.seek(end)
            f.write(_chunk(b"idx1", b"".join(
                struct.pack("<4sIII", b"00dc", _KEYFRAME if k else 0, off, n)
                for off, n, k in self.index)))
            total = f.tell()
            f.seek(0)
            maxsize = max([n for _, n, _ in self.index] or [0])
            head = self._header(len(self.index), maxsize)
            f.write(head[:-12])   # the headers, now with counts and sizes
            f.seek(4)
            f.write(struct.pack("<I", total - 8))
        finally:
            f.close()


def _chunk(fcc: bytes, data: bytes) -> bytes:
    return struct.pack("<4sI", fcc, len(data)) + data + b"\0" * (len(data) & 1)


def _list(kind: bytes, data: bytes) -> bytes:
    return struct.pack("<4sI", b"LIST", len(data) + 4) + kind + data
