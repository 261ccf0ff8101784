"""Video frames in and out without OpenCV: ``.mp4``, ``.mov``, ``.3gp``,
``.avi``, ``.mkv``, ``.webm``, ``.flv``, ``.wmv``, ``.asf``, ``.nut``,
``.mpg``, ``.ts``, ``.m2v``, ``.h263``, ``.drc``, ``.y4m``, image sequences
and frame directories.

The JAX package reads and writes video through ``cv2.VideoCapture`` and
``cv2.VideoWriter`` (FFmpeg underneath); the port has its own demuxers,
muxers and codecs and reads what those read, frame for frame, each turned
as cv2 turns it by an MP4/QuickTime ``tkhd`` matrix or a Matroska
``Projection`` (``io/orientation``: at 90, 180 and 270 degrees, the width
and height swapped at 90 and 270):

  * **MP4** (``.mp4``, ``.m4v``, ``.mov``; ``io/mp4``), **AVI**
    (``.avi``; ``io/avi``) and **Matroska/WebM** (``.mkv``, ``.webm``;
    ``io/mkv``) holding MPEG-4 Part 2 Simple Profile video, what
    ``cv2.VideoWriter`` writes with fourcc ``mp4v``, ``XVID`` or ``FMP4``:
    decoded by ``runtime/mpeg4`` bit-exactly to FFmpeg and converted to BGR
    in swscale's arithmetic, so every frame equals ``cv2.VideoCapture``'s;
    VP8 (``VP80`` in AVI, ``V_VP8`` in Matroska and WebM), decoded by
    ``runtime/vp8`` bit-exactly to FFmpeg; VP9 profile 0 (``VP90`` in AVI,
    ``V_VP9`` in Matroska and WebM, ``vp09`` in MP4), decoded by
    ``runtime/vp9`` bit-exactly to FFmpeg, converted with the range and
    matrix its frame header names; Motion JPEG (fourcc ``MJPG`` in
    AVI, ``V_MJPEG`` in Matroska, ``mp4v`` with objectTypeIndication 0x6C
    in MP4), decoded by ``runtime/jpeg``'s FFmpeg flavour; raw I420 in AVI
    and Matroska too.  Written as MPEG-4 Part 2 (an I-VOP every 12 frames,
    as cv2's writer does; an odd side cropped to even, as it does),
    ``.mp4``, ``.avi`` (fourcc ``FMP4``) or ``.mkv``.  HEVC, AV1, VP9
    profiles 1-3 and the like raise, naming ROADMAP Queue 1 item 8;
  * **H.264** (``runtime/h264``): progressive 8-bit 4:2:0 I, P and B
    slices, CAVLC and CABAC, in MP4/QuickTime (``avc1``/``avc3`` with the
    avcC; ``ctts`` and the ``elst`` that starts the track at its first
    picture shown), Matroska (``V_MPEG4/ISO/AVC``), AVI, NUT and ASF
    (riff.c's tags), FLV (codec id 7), MPEG-TS (0x1B) and raw
    ``.h264``/``.264``/``.avc``; the size is the SPS's crop, key frames the
    IDR and I pictures, frames counted in the order FFmpeg's decoder hands
    them over, its reorder depth starting where FFmpeg's probe left it
    (``EncodedVideo.h264_delay``); field coding and other layouts raise
    naming item 8;
  * **H.263** baseline with Annex F (``H263``, ``U263``, ... in AVI,
    ``s263``/``h263`` in ``.3gp``, ``.3g2`` and ``.mov``, ``H263`` under
    ``V_MS/VFW/FOURCC`` in Matroska: what ``cv2.VideoWriter`` writes for
    fourccs ``H263`` and ``s263``) and **H.263+** (PLUSPTYPE: custom sizes
    and clocks, Annexes D, F, I, J, K, S and T, as libavcodec's ``h263p``
    writes them), decoded by ``runtime/h263`` bit-exactly to FFmpeg;
    Annexes E, G, M, N, O, P, Q and R raise, naming item 8;
  * **Sorenson H.263** (``FLV1``: Flash video's codec, what
    ``cv2.VideoWriter`` writes for fourcc ``FLV1``) in **FLV** (``.flv``;
    ``io/flv``, read, not written), AVI, Matroska (``V_MS/VFW/FOURCC``)
    and QuickTime, decoded by ``runtime/h263``'s Sorenson reading
    bit-exactly to FFmpeg (versions 0 and 1, disposable pictures, which
    FFmpeg skips before its first reference picture in a capture just
    opened and not after a seek); other FLV codecs raise, and so does a
    seek in an FLV whose timestamps OpenCV numbers otherwise than its
    frames, naming item 8;
  * **MS-MPEG4 v2** (``MP42``, ``DIV2``), **v3** ("DivX 3": ``DIV3``,
    ``MP43`` and their aliases, ``3IVD`` in QuickTime), **WMV7** (``WMV1``)
    and **WMV8** (``WMV2``) in AVI, Matroska (``V_MS/VFW/FOURCC``),
    QuickTime and **ASF** (``.wmv``, ``.asf``; ``io/asf``, read, not
    written): what ``cv2.VideoWriter`` writes for these fourccs, decoded by
    ``runtime/msmpeg4`` bit-exactly to FFmpeg at the container's size;
    ASF's fps is the rate FFmpeg's probe fits to its millisecond times
    (29.97 as 30000/1001).  MS-MPEG4 v1, WMV8's J-pictures, mspel, ABT
    blocks other than 8x8 and loop filter, and ASF files whose fps or count
    FFmpeg guesses otherwise, raise naming item 8;
  * **Snow** (``SNOW`` in AVI and ASF, ``V_SNOW`` in Matroska, the
    ``SNOW`` entry in QuickTime: what ``cv2.VideoWriter`` writes for
    fourcc ``SNOW``), decoded by ``runtime/snow`` bit-exactly to FFmpeg at
    the container's size: the 9/7 and 5/3 wavelets, lossless coding,
    overlapped block motion compensation at half and quarter pel, blocks
    split one level, several references, in yuv420p, yuv410p, yuv444p or
    gray (converted as swscale converts each).  What libavcodec's encoder
    never writes (an MC filter other than its default, a temporal
    decomposition, spatial scalability, ``always_reset``, other colour
    spaces) raises naming item 8;
  * **Dirac/VC-2** (``drac`` in AVI, ASF and QuickTime/MP4, ``V_DIRAC`` in
    Matroska, stream type 0xD1 in transport streams, raw ``.drc``, and
    NUT: what ``cv2.VideoWriter`` writes for fourcc ``drac`` through
    libavcodec's ``vc2`` encoder), decoded by ``runtime/dirac`` bit-exactly
    to FFmpeg: HQ pictures over the (9,7), (5,3) and both Haar wavelets at
    depths 1-5, 8-bit 4:2:0, 4:2:2 and 4:4:4, converted at the range and
    matrix its sequence header names (BT.709 as the vc2 encoder writes
    it).  Core-syntax and low-delay pictures, the other wavelets and
    samples above 8 bits raise naming item 8; field coding, which FFmpeg
    refuses, raises ``ValueError``;
  * **JPEG 2000** (``MJ2C``/``mjp2`` in AVI, Matroska, NUT and ASF, the
    ``mjp2`` entry in QuickTime, ``mp4v`` with objectTypeIndication 0x6E
    in MP4: what ``cv2.VideoWriter`` writes for fourcc ``MJ2C`` through
    libavcodec's ``jpeg2000`` encoder), decoded by ``runtime/jpeg2000``
    bit-exactly to FFmpeg: JP2 files or codestreams, tiles, tile-parts,
    the five progression orders, layers, SOP/EPH, the 9/7 and 5/3
    wavelets, every layout libavcodec's encoder writes (RGB, grey and YUV
    at 8 to 16 bits, with alpha, palettes; converted as swscale converts
    each), every frame a key frame.  Image offsets, ROI shifts, packed
    headers and HTJ2K raise naming item 8; **yuv4** (libavcodec's packed
    4:2:0, ``yuv4`` in AVI, Matroska, NUT, ASF and QuickTime) and raw
    ``NV12`` (through swscale's
    scaler, as its interleaved chroma goes), ``Y41B`` (yuv411p) and
    ``Y8  `` (grey) in AVI, Matroska, NUT and ASF;
  * **NUT** (``.nut``; ``io/nut``, read, not written), FFmpeg's own
    container, with every codec above that ``cv2.VideoWriter`` writes into
    it, at cv2's fps, its count (one short of the frames where the last
    frame's start ends the duration) and its seeks over NUT's index (none
    lands on a Dirac frame: cv2's writer flags none a key frame);
  * a picture of another size than its stream's first (a VP9 frame that
    changed size, a VP8 key frame, an H.263 picture header) is scaled back
    to the first size through swscale's bicubic scaler, as
    ``cv2.VideoCapture`` hands every frame to swscale at that size;
  * **MPEG-1 and MPEG-2** (``PIM1``, ``mpg1``, ``mpg2``, ... in AVI,
    ``V_MPEG1``/``V_MPEG2`` in Matroska, ``mp4v`` with objectTypeIndication
    0x6A or 0x60-0x65 in MP4, and **MPEG program streams**: ``.mpg``,
    ``.mpeg``, ``.vob``; ``io/mpegps``), decoded by ``runtime/mpeg12``
    bit-exactly to FFmpeg, pictures in display order; a seek reads the frame
    ``cv2.VideoCapture``'s seek reads, its quirks included
    (:meth:`EncodedVideo.seek_target`).  Interlaced coding, 4:2:2/4:4:4
    and scalable streams raise, naming item 8; program streams are read,
    not written.  MPEG-4 Part 2 in a program stream is read too;
  * **MPEG transport streams** (``.ts``, ``.m2ts``, ``.mts``, ``.m2t``;
    ``io/mpegts``): MPEG-1, MPEG-2 and MPEG-4 Part 2, with cv2's count,
    fps (MPEG-1 at twice its rate) and FFmpeg's seek search; and
    **elementary streams** (``.m1v``, ``.m2v``, ``.mpv``, ``.h263``,
    ``.263``; ``io/elementary``) at the raw demuxers' 25 fps and cv2's
    count; neither is written;
  * **FFV1** (``FFV1`` in AVI, ``V_FFV1`` in Matroska, the ``FFV1`` entry
    in MP4 and QuickTime: what ``cv2.VideoWriter`` writes for fourcc
    ``FFV1``), decoded by ``runtime/ffv1`` bit-exactly to FFmpeg, RGB handed
    over packed as swscale copies it;
  * **lossless intra video** in AVI, Matroska (``V_MS/VFW/FOURCC``) and
    QuickTime, what ``cv2.VideoWriter`` writes for these fourccs:
    **HuffYUV** and **FFVHuff** (``HFYU``, ``FFVH``; ``runtime/huffyuv``:
    4:2:2, 4:2:0, RGB24/RGB32 and version 3's 8-bit planar layouts, every
    predictor, the classic and the extradata's tables), **Ut Video**
    (``ULRG``, ``ULRA``, ``ULY0``/``ULY2``/``ULY4`` and the BT.709
    ``ULH*``; ``runtime/utvideo``), **PNG** (``MPNG``, ``png ``, ``mp4v``
    with objectTypeIndication 0x6D in MP4: one PNG a packet, converted as
    an image sequence's PNG is), each bit-exact to FFmpeg and converted
    as swscale converts the decoder's pixel format (``runtime/mpeg4``'s
    ``yuv_to_bgr``: 4:2:2, 4:4:4, 4:1:1, 4:4:0, 4:1:0, BT.709); **Motion
    JPEG** in QuickTime (the ``jpeg`` entry); **raw** ``Y800``/``GREY``
    (rows 4-byte aligned where the packet allows, as FFmpeg's rawvideo
    decoder reads them), ``YV12`` and ``RGBA`` in AVI and Matroska,
    ``RGBA`` in QuickTime and 32-bit ``BI_RGB`` (bottom-up) in AVI;
    **MagicYUV** (``M8Y0``, ``M8RG``, ``MAGY``, ...; ``runtime/magicyuv``:
    its 8-bit GBRP, GBRAP, 4:4:4, 4:2:2, 4:2:0, YUVA 4:4:4 and grey
    layouts, every predictor, slices, the header's matrix and range) and
    **ASUS V1/V2** (``ASV1``, ``ASV2``; ``runtime/asv``: intra DCT,
    yuv420p).  Dirac, MagicYUV above 8 bits or interlaced, Ut Video's 10-bit and packed families, FFVHuff above 8
    bits, APNG-style packets and 24-bit BI_RGB raise, naming item 8;
  * **image sequences** (:class:`ImageSequence`): a printf pattern such as
    ``frames/%06d.jpg``, or one image file, read by FFmpeg's image2 rules
    as ``cv2.VideoCapture`` opens them: JPEG through the FFmpeg flavour,
    PNG through ``io/images.decode_png`` and swscale's conversion (16-bit
    colour through its YUV, ``runtime/mpeg4.rgb48_to_bgr``);
  * **YUV4MPEG2** (``.y4m``): 8-bit 4:2:0, colour tags ``C420jpeg``,
    ``C420mpeg2``, ``C420paldv``, ``C420`` or none, read as FFmpeg's
    yuv4mpeg demuxer reads it (25 fps without an ``F`` tag,
    ``XCOLORRANGE=FULL`` honoured) and converted as swscale converts it;
  * **a directory of PNG or JPEG frames** (``*.png``, ``*.jpg`` or
    ``*.jpeg``, one kind a directory), read in sorted name order as the
    JAX package loads images (``io/images.decode_png``, ``runtime/jpeg``'s
    libjpeg flavour; no EXIF rotation); ``cv2.VideoCapture`` opens no
    directory; written as PNG, ``000000.png``, ...

Frames are BGR uint8 (H, W, 3), as OpenCV hands them over.
:class:`AsyncVideoWriter` keeps the JAX class's encode thread, bounded
queue and error surfacing.
"""

from __future__ import annotations

import os
import queue
import threading
from bisect import bisect_left, bisect_right
from contextlib import closing
from fractions import Fraction
from glob import glob
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.io.asf import EXTENSIONS as _ASF_EXTS
from opticalflow_tpu_torch.io.asf import AsfFile, AsfWriter
from opticalflow_tpu_torch.io.avi import RAW_LAYOUTS, AviFile, AviWriter
from opticalflow_tpu_torch.io.flv import EXTENSIONS as _FLV_EXTS
from opticalflow_tpu_torch.io.flv import FlvFile
from opticalflow_tpu_torch.io.images import (decode_bytes, decode_png,
                                             encode_png, rgb8, unread_format)
from opticalflow_tpu_torch.io.mkv import MkvFile, MkvWriter
from opticalflow_tpu_torch.io.mp4 import Mp4File, Mp4Writer
from opticalflow_tpu_torch.io.elementary import (DIRAC_EXTENSIONS,
                                                 H263_EXTENSIONS,
                                                 H264_EXTENSIONS,
                                                 MPEG_EXTENSIONS,
                                                 ElementaryFile)
from opticalflow_tpu_torch.io.mpegps import EXTENSIONS as _MPG_EXTS
from opticalflow_tpu_torch.io.mpegps import MpegPsFile, PsWriter
from opticalflow_tpu_torch.io.mpegts import EXTENSIONS as _TS_EXTS
from opticalflow_tpu_torch.io.mpegts import MpegTsFile, TsWriter
from opticalflow_tpu_torch.io.nut import EXTENSIONS as _NUT_EXTS
from opticalflow_tpu_torch.io.nut import NutFile, NutWriter
from opticalflow_tpu_torch.io.yuv import i420_planes, pad_to_even
from opticalflow_tpu_torch.runtime.asv import Decoder as AsvDecoder
from opticalflow_tpu_torch.runtime.dirac import Decoder as DiracDecoder
from opticalflow_tpu_torch.runtime.dirac import \
    sequence_info as dirac_sequence
from opticalflow_tpu_torch.runtime.ffv1 import Decoder as Ffv1Decoder
from opticalflow_tpu_torch.runtime.h263 import Decoder as H263Decoder
from opticalflow_tpu_torch.runtime.h263 import picture_size as h263_size
from opticalflow_tpu_torch.io.orientation import display_size, rotate
from opticalflow_tpu_torch.runtime.h264 import Decoder as H264Decoder
from opticalflow_tpu_torch.runtime.h264 import is_keyframe as h264_is_idr
from opticalflow_tpu_torch.runtime.h264 import probe as h264_probe
from opticalflow_tpu_torch.runtime.h264 import probe_delay as h264_probe_delay
from opticalflow_tpu_torch.runtime.huffyuv import Decoder as HuffyuvDecoder
from opticalflow_tpu_torch.runtime.jpeg2000 import Decoder as J2kDecoder
from opticalflow_tpu_torch.runtime.jpeg2000 import probe as j2k_size
from opticalflow_tpu_torch.runtime.jpegls import Decoder as JplsDecoder
from opticalflow_tpu_torch.runtime.speedhq import Decoder as ShqDecoder
from opticalflow_tpu_torch.runtime.tiff import Decoder as TiffDecoder
from opticalflow_tpu_torch.runtime.tiff import is_tiff
from opticalflow_tpu_torch.runtime.tiff import probe as tiff_probe
from opticalflow_tpu_torch.runtime.jpeg import (decode_jpeg_ffmpeg, is_jpeg,
                                                jpeg_size)
from opticalflow_tpu_torch.runtime.magicyuv import Decoder as MagicyuvDecoder
from opticalflow_tpu_torch.runtime.magicyuv import frame_size as magy_size
from opticalflow_tpu_torch.runtime.mpeg4 import (CHROMA_SITES, ITEM_8,
                                                  Decoder, Encoder,
                                                  Unsupported, i420_to_bgr,
                                                  rgb48_to_bgr, to_i420,
                                                  yuv16_to_bgr, yuv_to_bgr)
from opticalflow_tpu_torch.runtime.msmpeg4 import VERSIONS as MSMPEG4
from opticalflow_tpu_torch.runtime.msmpeg4 import Decoder as Msmpeg4Decoder
from opticalflow_tpu_torch.runtime.snow import Decoder as SnowDecoder
from opticalflow_tpu_torch.runtime.mpeg12 import CHROMA_SITE as MPEG12_SITE
from opticalflow_tpu_torch.runtime.mpeg12 import Decoder as Mpeg12Decoder
from opticalflow_tpu_torch.runtime.mpeg12 import (display_order, output_order,
                                                  picture_info, sequence_info)
from opticalflow_tpu_torch.runtime.utvideo import Decoder as UtvideoDecoder
from opticalflow_tpu_torch.runtime.vp8 import Decoder as Vp8Decoder
from opticalflow_tpu_torch.runtime.vp8 import frame_size as vp8_frame_size
from opticalflow_tpu_torch.runtime.vp9 import MATRICES as VP9_MATRICES
from opticalflow_tpu_torch.runtime.vp9 import Decoder as Vp9Decoder
from opticalflow_tpu_torch.runtime.vp9 import frame_size as vp9_frame_size
from opticalflow_tpu_torch.runtime.vp9 import is_keyframe as vp9_is_keyframe

__all__ = ["read_frames", "read_frame", "video_info", "AsyncVideoWriter",
           "EncodedVideo", "ImageSequence", "Mpeg4Writer", "Y4MFile",
           "Y4MWriter", "PngDirWriter", "FORMATS", "frame_filename",
           "is_sequence", "ffmpeg_threads"]

FORMATS = ("an .mp4, .mov, .3gp, .3g2, .avi, .mkv, .webm or .nut file "
           "(MPEG-4 Part 2, MPEG-1, MPEG-2, H.263, Sorenson H.263, MS-MPEG4 "
           "v2/v3, WMV7/8, Snow, Dirac/VC-2, JPEG 2000, H.264, VP8, VP9, "
           "FFV1, "
           "HuffYUV, FFVHuff, Ut Video, MagicYUV, ASUS V1/V2, PNG, Motion "
           "JPEG or yuv4; raw I420, YV12, NV12, Y41B, Y800 and RGBA in .avi, "
           ".mkv and .nut), an "
           ".flv file (Sorenson H.263, H.264), a .wmv or .asf file (MS-MPEG4 "
           "v2/v3, WMV7/8, Snow, Dirac, JPEG 2000 and the AVI fourccs above), "
           "an "
           "MPEG program stream (.mpg, .mpeg, .vob) "
           "or transport stream (.ts, .m2ts, .mts, .m2t: MPEG-1, MPEG-2, "
           "MPEG-4 Part 2, Dirac or H.264), an elementary stream (.m1v, .m2v, "
           ".mpv, .h263, .263, .drc, .h264, .264, .avc), a .y4m "
           "file (YUV4MPEG2, 8-bit 4:2:0), an image sequence named by a "
           "pattern (frames/%06d.jpg; JPEG or PNG) or one image file, or a "
           "directory of PNG or JPEG frames")
WRITES = (".mp4, .mov, .m4v, .3gp, .3g2, .avi, .mkv, .nut, .wmv, .asf, .mpg, "
          ".mpeg, .vob, .ts, .mts, .m2t or .m2ts (MPEG-4 Part 2, the "
          "containers OpenCV's mp4v writer opens), .y4m, or a directory of "
          "PNG frames")
_Y4M_MAGIC = b"YUV4MPEG2"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_420_TAGS = ("420jpeg", "420mpeg2", "420paldv", "420")
# yuv4mpegdec's chroma location of each tag (none without a C tag)
_Y4M_SITES = {"420jpeg": CHROMA_SITES["center"],
              "420": CHROMA_SITES["center"],
              "420mpeg2": CHROMA_SITES["left"],
              "420paldv": CHROMA_SITES["topleft"]}
_MP4_EXTS = (".mp4", ".m4v", ".mov", ".3gp", ".3g2")
_MKV_EXTS = (".mkv", ".webm")
_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".tif", ".tiff")
_ES_EXTS = (MPEG_EXTENSIONS + H263_EXTENSIONS + DIRAC_EXTENSIONS
            + H264_EXTENSIONS)
_ENCODED = ("mp4", "avi", "mkv", "mpg", "ts", "es", "flv", "asf", "nut")
DEFAULT_FPS = 30.0     # a frame directory's, as the JAX package's
Y4M_FPS = 25.0         # FFmpeg's yuv4mpeg demuxer without an F tag


def ffmpeg_threads() -> int:
    """The decoder threads ``cv2.VideoCapture`` gives FFmpeg:
    ``OPENCV_FFMPEG_THREADS`` where set, else one a CPU this process may
    run on (``cv2.getNumberOfCPUs``).  A VP8 stream's colour range depends
    on it: each of FFmpeg's frame threads keeps the range of the last key
    frame it decoded itself, and frames go to the threads in turn."""
    env = os.environ.get("OPENCV_FFMPEG_THREADS", "")
    if env.isdigit() and int(env) > 0:
        return int(env)
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:
        return max(1, os.cpu_count() or 1)


def _unsupported(path: str) -> ValueError:
    return ValueError(
        f"cannot read or write {path!r}: the port handles {FORMATS}; other "
        f"containers and codecs are {ITEM_8} "
        "(convert elsewhere, e.g. "
        "`ffmpeg -i in.rm -c:v mpeg4 -q:v 3 out.mkv` or `ffmpeg -i in.rm "
        "-pix_fmt yuv420p out.y4m`)")


def is_sequence(path: str) -> bool:
    """Whether ``cv2.VideoCapture`` would open ``path`` through FFmpeg's
    image2 (:class:`ImageSequence`): an image file name that is a printf
    pattern or names one file (image2 claims image extensions only)."""
    return path.lower().endswith(_IMAGE_EXTS) and (
        frame_filename(path, 0) is not None or os.path.isfile(path))


def _refuse_writing(path: str, why: str) -> ValueError:
    return ValueError(f"cannot write {path!r}: {why}, and OpenCV's mp4v "
                      f"writer does not open on it either; the port writes "
                      f"{WRITES}")


def _kind(path: str, writing: bool = False) -> str:
    low = path.lower()
    if not writing and is_sequence(path):
        return "sequence"
    if low.endswith(".y4m"):
        return "y4m"
    if low.endswith(_MP4_EXTS):
        return "mp4"
    if low.endswith(".avi"):
        return "avi"
    for exts, kind in ((_MPG_EXTS, "mpg"), (_TS_EXTS, "ts")):
        if low.endswith(exts):
            return kind
    if low.endswith(_ES_EXTS):
        if writing:
            raise _refuse_writing(path, "an elementary stream holds MPEG-1/2,"
                                        " H.263, Dirac or H.264, which the "
                                        "port does not encode")
        return "es"
    if low.endswith(_FLV_EXTS):
        if writing:
            raise _refuse_writing(path, "FLV holds Sorenson H.263, which the "
                                        "port does not encode")
        return "flv"
    if low.endswith(_ASF_EXTS):
        return "asf"
    if low.endswith(_NUT_EXTS):
        return "nut"
    if low.endswith(_MKV_EXTS):
        if writing and low.endswith(".webm"):
            raise _refuse_writing(path, "WebM holds VP8, VP9 or AV1, which "
                                        "the port does not encode")
        return "mkv"
    if os.path.isdir(path) or (writing and not os.path.splitext(path)[1]):
        return "png"
    if writing:
        raise _refuse_writing(path, "the port writes no such container")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    raise _unsupported(path)


# --------------------------------------------------------------- y4m

def _y4m_header(f) -> Tuple[Dict[str, str], int]:
    """(the header's parameters by tag letter, the ``X`` tags' values
    under ``"X"`` as a list; its length in bytes)."""
    line = f.readline(4096)
    if not line.startswith(_Y4M_MAGIC) or not line.endswith(b"\n"):
        raise ValueError("not a YUV4MPEG2 stream (bad header)")
    params = {"X": []}
    for tok in line[len(_Y4M_MAGIC):].split():
        val = tok[1:].decode("ascii")
        if tok[:1] == b"X":
            params["X"].append(val)
        else:
            params[chr(tok[0])] = val
    if "W" not in params or "H" not in params:
        raise ValueError("YUV4MPEG2 header without W or H")
    colour = params.get("C", "420")
    if colour not in _420_TAGS:
        raise ValueError(f"YUV4MPEG2 colour space C{colour} is not read: the "
                         "port reads 8-bit 4:2:0 (C420jpeg, C420mpeg2, "
                         "C420paldv, C420 or no C tag)")
    return params, len(line)


def _y4m_geometry(params) -> Tuple[int, int, int]:
    w, h = int(params["W"]), int(params["H"])
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return w, h, w * h + 2 * cw * ch


def _y4m_fps(params) -> float:
    """FFmpeg's yuv4mpeg demuxer: the ``F`` tag, else 25 fps."""
    if "F" not in params:
        return Y4M_FPS
    num, den = params["F"].split(":")
    return float(Fraction(int(num), int(den))) if int(den) else Y4M_FPS


class Y4MFile:
    """A YUV4MPEG2 file's header and the byte offset of every frame, so a
    frame can be read by its index (``ConsecutiveFrames`` reads pairs in
    any order) or all of them in turn.

    Frames convert as ``cv2.VideoCapture`` converts them through FFmpeg's
    yuv4mpeg demuxer and swscale (``runtime/mpeg4.i420_to_bgr``): every
    4:2:0 tag is yuv420p, at video range unless an ``XCOLORRANGE=FULL``
    tag says full range; an odd height goes through swscale's scaler,
    which interpolates the chroma from the tag's site (``C420mpeg2``
    left, ``C420paldv`` top left, ``C420jpeg`` and ``C420`` centred)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            params, pos = _y4m_header(f)
            self.fps = _y4m_fps(params)
            self.width, self.height, self._nbytes = _y4m_geometry(params)
            self.full_range = "COLORRANGE=FULL" in params["X"]
            self.chroma = _Y4M_SITES.get(params.get("C"))
            size = os.path.getsize(path)
            self.offsets = []
            while pos < size:
                f.seek(pos)
                tag = f.readline(4096)
                if not tag.startswith(b"FRAME"):
                    raise ValueError(f"{path}: bad YUV4MPEG2 frame header "
                                     f"{tag[:16]!r}")
                pos += len(tag)
                if pos + self._nbytes > size:
                    raise ValueError(f"{path}: truncated frame "
                                     f"{len(self.offsets)}")
                self.offsets.append(pos)
                pos += self._nbytes

    def __len__(self) -> int:
        return len(self.offsets)

    def _convert(self, buf: bytes) -> np.ndarray:
        w, h = self.width, self.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        a = np.frombuffer(buf, np.uint8)
        return i420_to_bgr(a[:w * h].reshape(h, w),
                           a[w * h:w * h + cw * ch].reshape(ch, cw),
                           a[w * h + cw * ch:].reshape(ch, cw),
                           self.full_range, self.chroma)

    def frame(self, index: int) -> np.ndarray:
        """BGR uint8 frame ``index``."""
        with open(self.path, "rb") as f:
            f.seek(self.offsets[index])
            return self._convert(f.read(self._nbytes))

    def __iter__(self) -> Iterator[np.ndarray]:
        with open(self.path, "rb") as f:
            for off in self.offsets:
                f.seek(off)
                yield self._convert(f.read(self._nbytes))


# --------------------------------------------------------------- mp4 / avi

class EncodedVideo:
    """The video track of an ``.mp4``, ``.avi``, ``.mkv``, ``.webm``,
    ``.flv``, ``.wmv``, ``.asf`` or ``.nut`` file, an MPEG program or
    transport stream or an elementary stream: its
    size, fps and frame count as
    ``cv2.VideoCapture`` reports them, and its frames (in display order:
    an MPEG-1/2 stream's pictures come out reordered, as FFmpeg hands them
    over).

    Iterating decodes every frame in turn (BGR); :meth:`frame` seeks: it
    decodes from the last keyframe at or before the index (``stss`` /
    ``idx1`` / Matroska's block flags; every Motion JPEG frame is one), as
    a ``CAP_PROP_POS_FRAMES`` seek does;
    :meth:`read` keeps one decoder open and reads in order without seeking
    while the indices follow on."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        kind = _kind(path)
        self.box = box = {"mp4": Mp4File, "mkv": MkvFile, "mpg": MpegPsFile,
                          "ts": MpegTsFile, "es": ElementaryFile,
                          "avi": AviFile, "flv": FlvFile,
                          "asf": AsfFile, "nut": NutFile}[kind](path)
        self.fps, self.frames, self.keyframes = (box.fps, box.frames,
                                                 box.keyframes)
        # the samples decoding walks: all of them, as cv2.VideoCapture.read
        # does, where Matroska's estimated count falls short of them
        self.samples = len(box.sizes)
        if box.codec == "mpeg4":
            dec = self._decoder()
            if not dec.width:   # the VOL comes in band (AVI)
                with open(path, "rb") as f:
                    dec.probe(self.box.sample(f, 0))
            self.width, self.height = dec.width, dec.height
        elif box.codec in ("vp8", "vp9"):
            with open(path, "rb") as f:
                if box.codec == "vp9":
                    # cv2's AVI writer flags every VP9 frame a keyframe: a
                    # seek starts from a key frame of the bitstream
                    self.keyframes = [
                        i for i in self.keyframes
                        if vp9_is_keyframe(box.sample(f, i))] or [0]
                first = box.sample(f, self.keyframes[0])
            size = (vp8_frame_size if box.codec == "vp8" else
                    vp9_frame_size)(first)
            if size is None:
                raise ValueError(f"{path}: the first {box.codec.upper()} "
                                 "keyframe has no key frame header")
            self.width, self.height = size
        elif box.codec == "mpeg12":
            self._mpeg12_layout()
        elif box.codec == "h264":
            self._h264_layout()
        elif box.codec in ("h263", "flv1"):
            sorenson = box.codec == "flv1"
            with open(path, "rb") as f:
                size = h263_size(box.sample(f, self.keyframes[0]), sorenson)
            if size is None:
                raise ValueError(f"{path}: the first "
                                 f"{'Sorenson ' if sorenson else ''}H.263 "
                                 "keyframe has no picture header")
            self.width, self.height = size
        elif box.codec == "dirac":
            with open(path, "rb") as f:
                info = dirac_sequence(box.sample(f, 0), path)
            if info is None:
                raise ValueError(f"{path}: the first Dirac packet has no "
                                 "sequence header")
            self.width, self.height = info.width, info.height
        elif box.codec == "jpeg2000":
            with open(path, "rb") as f:
                size = j2k_size(box.sample(f, 0), path)
            if size is None:
                raise ValueError(f"{path}: the first JPEG 2000 packet has no "
                                 "SIZ marker")
            self.width, self.height = size
        elif box.codec == "tiff":
            with open(path, "rb") as f:
                self.width, self.height, _ = tiff_probe(box.sample(f, 0),
                                                        f"{path} frame 0")
        elif box.codec == "jpegls":
            with open(path, "rb") as f:
                self.width, self.height = JplsDecoder(
                    what=f"{path} frame 0").size(box.sample(f, 0))
        elif box.codec == "magicyuv":
            with open(path, "rb") as f:
                size = magy_size(box.sample(f, 0))
            if size is None:
                raise ValueError(f"{path}: the first MagicYUV packet has no "
                                 "frame header")
            self.width, self.height = size
        elif box.codec == "mjpeg":
            with open(path, "rb") as f:
                self.height, self.width = jpeg_size(box.sample(f, 0),
                                                    f"{path} frame 0")
            # FFmpeg decodes a picture under 3/4 of the container's height
            # as one field of an interlaced pair
            if self.height < box.height * 3 // 4:
                raise Unsupported(
                    f"{path}: interlaced Motion JPEG ({self.height}-line "
                    f"fields of a {box.height}-line frame), not read by the "
                    f"port ({ITEM_8})")
        else:
            self.width, self.height = box.width, box.height
        # what FFmpeg's decoder hands swscale with the planes: the chroma
        # site its scaler interpolates from at an odd height (MPEG-4 Part
        # 2's own, left; else Matroska's Colour element's), the range and
        # the matrix (VP8's and VP9's from their frame headers, as planes()
        # decodes them; else Matroska's Range and BT.601)
        self.chroma = (CHROMA_SITES["left"] if box.codec == "mpeg4" else
                       MPEG12_SITE[self.mpeg2] if box.codec == "mpeg12" else
                       getattr(box, "chroma_site", None))
        if box.codec == "speedhq":     # speedhqdec's chroma location
            self.chroma = CHROMA_SITES["center"]
        self.full_range = box.codec != "vp8" and getattr(box, "full_range",
                                                         False)
        self.matrix = "bt601"
        if box.codec == "h264":   # FFmpeg's frames carry the SPS's VUI
            self.chroma, self.full_range, self.matrix = (
                self.h264.chroma, self.h264.full_range, self.h264.matrix)
        self.shifts, self.alpha = (1, 1), False     # 4:2:0, no alpha plane
        self.bits = 8
        # swscale's scaler even where its unscaled yuv2rgb would take the
        # layout (NV12's interleaved chroma)
        layout = RAW_LAYOUTS.get(box.tag) if box.codec == "raw" else None
        self.scaler = layout == "nv12"
        if layout == "yuv411p":
            self.shifts = (2, 0)
        self.threads = ffmpeg_threads()
        self.rotation = getattr(box, "rotation", 0)
        self._gen = None
        self._next = 0      # a capture just opened reads frame 0 unsought
        self._index: dict = {}      # FFmpeg's seek index in a capture

    def __len__(self) -> int:
        return self.frames

    def _mpeg12_layout(self) -> None:
        """An MPEG-1/2 stream's size, and the display index of each sample
        (pictures come out of FFmpeg's decoder in display order, B-pictures
        before the reference decoded ahead of them): what frame indices,
        keyframes and seeks are counted in."""
        box = self.box
        types, closed, sizes = [], [], []
        with open(self.path, "rb") as f:
            for i in range(self.samples):
                sample = box.sample(f, i)
                t, c = picture_info(sample)
                types.append(t)
                closed.append(c)
                s = sequence_info(sample, self.path)
                sizes.append(s and (s.width, s.height))
            first = box.sample(f, 0)
        seq = sequence_info(box.dsi, self.path) or sequence_info(first,
                                                                 self.path)
        if seq is None:
            raise ValueError(f"{self.path}: MPEG-1/2 video without a "
                             "sequence header")
        self.width, self.height, self.mpeg2 = seq.width, seq.height, seq.mpeg2
        self.types, self.closed, self.low_delay = types, closed, seq.low_delay
        # the samples whose sequence header changes the size: FFmpeg drops
        # its references there (output_order)
        self.resets, size = [], (seq.width, seq.height)
        for i, s in enumerate(sizes):
            if s and s != size:
                self.resets.append(i)
                size = s
        self.display = display_order(types, closed, seq.low_delay,
                                     self.resets)
        self.shown = sum(d is not None for d in self.display)
        # a seek decodes from the last I-picture at or before the frame
        self.keyframes = [i for i, t in enumerate(types)
                          if t == 1 and self.display[i] is not None] or [0]
        self._key_display = [self.display[i] for i in self.keyframes]

    def _h264_layout(self) -> None:
        """An H.264 stream's size (its first SPS, the crop applied), and the
        samples a decoder can start from: the container's key frames that
        hold an IDR or I slice (FFmpeg's decoder, flushed, hands over no
        picture before one)."""
        box = self.box
        with open(self.path, "rb") as f:
            # the avcC's SPS, else (Annex B) the first key frame's
            info = h264_probe(box.dsi or box.sample(f, self.keyframes[0]),
                              self.path)
            if info is None:
                raise ValueError(f"{self.path}: H.264 video without an SPS")
            keys = [i for i in self.keyframes
                    if h264_is_idr(box.sample(f, i), self._length_size)]
            self.keyframes = keys or self.keyframes
        self.h264 = info
        self.width, self.height = info.width, info.height

    @property
    def h264_delay(self) -> int:
        """The reorder depth cv2's H.264 decoder starts from: FFmpeg's probe
        over the first packets (``h264.probe_delay``), from the demuxer's
        estimate (MP4's ``ctts``)."""
        if getattr(self, "_h264_delay", None) is None:
            with open(self.path, "rb") as f:
                self._h264_delay = h264_probe_delay(
                    (self.box.sample(f, i) for i in range(self.samples)),
                    self.box.dsi, getattr(self.box, "video_delay", 0),
                    self.path)
        return self._h264_delay

    @property
    def h264_types(self) -> list:
        """1 where a sample holds an IDR or I slice, else 2 (read once, at
        the first seek that needs them: every sample is read)."""
        if getattr(self, "_h264_types", None) is None:
            with open(self.path, "rb") as f:
                self._h264_types = [
                    1 if h264_is_idr(self.box.sample(f, i),
                                     self._length_size) else 2
                    for i in range(self.samples)]
        return self._h264_types

    @property
    def _length_size(self) -> int:
        """The NAL length prefix of an avcC's samples, 0 for Annex B."""
        dsi = self.box.dsi
        return (dsi[4] & 3) + 1 if len(dsi) > 4 and dsi[0] == 1 else 0

    def seek_target(self, index: int, capture: Optional[dict] = None
                    ) -> Optional[int]:
        """The frame ``cv2.VideoCapture`` returns after a
        ``CAP_PROP_POS_FRAMES`` seek to ``index`` (:meth:`_seek`)."""
        return self._seek(index, capture)[0]

    def _seek(self, index: int, capture: Optional[dict] = None
              ) -> Tuple[Optional[int], Optional[int]]:
        """The frame ``cv2.VideoCapture`` returns after a
        ``CAP_PROP_POS_FRAMES`` seek to ``index`` on a capture just opened:
        OpenCV clamps the index to its frame count; in AVI, where FFmpeg
        stamps an MPEG-1/2 I- or P-picture with the packet that hands it
        over (one late, without B-pictures to reorder around), every seek
        from frame 2 on lands one frame early; in a program or transport
        stream the seek follows FFmpeg's search (:meth:`_opencv_seek`); in an
        elementary stream ``ElementaryFile.seek_target``'s rule; in an FLV
        exactly where OpenCV numbers its frames by their indices
        (``FlvFile.numbered``; after the seek FFmpeg's Sorenson decoder
        skips no disposable picture, ``h263.Decoder(after_seek=True)``);
        in ASF likewise (``AsfFile.numbered``); in NUT, and in Matroska
        without a key-flagged block, where FFmpeg's seek lands
        (:meth:`_opencv_seek`).  Other codecs and containers seek exactly.
        ``capture`` is the index FFmpeg's transport stream demuxer keeps
        through one capture's seeks (:meth:`read` passes its own; None: a
        capture just opened).

        (that frame, the sample FFmpeg's decoder starts from after the seek
        where it matters: a Dirac decoder keeps its coefficient planes from
        picture to picture, and what libavcodec's SIMD steps leave before
        them shows in later pictures, so OpenCV's frame is decoded from the
        frame FFmpeg lands on, not only from a key frame; None elsewhere:
        the last key frame at or before the frame)."""
        box = self.box
        if isinstance(box, ElementaryFile):
            return box.seek_target(index), None
        if isinstance(box, (FlvFile, AsfFile)) and not box.numbered:
            raise Unsupported(
                f"{self.path}: a seek to frame {index} in an FLV or ASF whose "
                f"timestamps OpenCV numbers otherwise than the frames' "
                f"indices; not reproduced by the port ({ITEM_8})")
        if isinstance(box, (MpegPsFile, MpegTsFile, NutFile)) or (
                isinstance(box, MkvFile) and not box.indexed):
            return self._opencv_seek(min(index, self.frames),
                                     {} if capture is None else capture)
        if box.codec == "dirac":
            # OpenCV asks for 16 frames before the target and reads on; the
            # seek lands on the last key frame at or before that time
            ask = max(index - 16, 0) if index >= 2 else 0
            return index, self.keyframes[
                max(bisect_right(self.keyframes, ask) - 1, 0)]
        if box.codec != "mpeg12":
            return index, None
        index = min(index, self.frames)
        if (isinstance(box, AviFile) and index >= 2
                and 3 not in self.types):
            index -= 1
        return index, None

    def _landing(self, ts: int, index: dict) -> Optional[int]:
        """The stream offset FFmpeg reads from after seeking to the 90 kHz
        time ``ts``: in a transport stream ``MpegTsFile.seek``'s search (None
        where it fails); in a program stream the last PES packet whose DTS
        (else PTS) is at or before ``ts``."""
        box = self.box
        if isinstance(box, MpegTsFile):
            return box.seek(ts, index)
        stamps = sorted((p.dts, p.es) for p in box.pes if p.dts is not None)
        j = bisect_right([d for d, _ in stamps], ts) - 1
        return stamps[j][1] if j >= 0 else 0

    def _opencv_seek(self, target: int, index: dict
                     ) -> Tuple[Optional[int], Optional[int]]:
        """OpenCV's seek (``CvCapture_FFMPEG::seek``) in a program or
        transport stream, a NUT file or Matroska without an index: it asks
        FFmpeg for the time ``delta`` frames before the target (16, then
        more while it lands past it); FFmpeg lands (a PES stream's
        :meth:`_landing`, else the container's ``landing``: NUT's index or
        syncpoint search, Matroska's generic seek) and its decoder, flushed,
        drops what it cannot decode until an I-picture or GOP header;
        OpenCV numbers the first picture that comes out by its time (at its
        fps: an MPEG-1 transport stream's 50 makes two numbers a picture)
        and reads on, one picture at a time, to the target: (that picture,
        None where the read after the seek finds none, as after any seek
        in a Dirac NUT, which flags no key frame; the sample reading
        restarts at, for a Dirac stream).  MPEG-4 pictures decoded after
        landing on a P-VOP and before the next I-VOP, which FFmpeg decodes
        over a grey picture, are not reproduced: a seek that reads one
        raises ``Unsupported``."""
        box = self.box
        pes = isinstance(box, (MpegPsFile, MpegTsFile))
        if not pes and self.frames < 2:
            raise Unsupported(f"{self.path}: a seek in a file of "
                              f"{self.frames} frames by OpenCV's count, which "
                              f"OpenCV makes without FFmpeg's seek; not "
                              f"reproduced by the port ({ITEM_8})")
        start = (box.start_time or 0) if pes else 0
        mpeg12 = box.codec == "mpeg12"
        samples = ({d: i for i, d in enumerate(self.display) if d is not None}
                   if mpeg12 else None)

        def number(d: int) -> int:
            """OpenCV's dts_to_frame_number of display frame ``d``."""
            i = samples[d] if mpeg12 else d
            if not pes:
                return box.number(i)
            if not isinstance(box, MpegTsFile) or box.pts[i] is None:
                return d
            return int(box.fps * ((box.pts[i] - start) * (1.0 / 90000))
                       + 0.5)

        first = number(0)
        delta = 16
        while True:
            temp = max(target - delta, 0)
            if pes:
                ts = start + int(temp / box.fps / (1.0 / 90000) + 0.5)
                land = self._landing(ts, index)
                s0 = None if land is None else bisect_left(box.pictures, land)
            else:
                land = None
                s0 = box.landing(box.ticks(temp))
            if s0 is None:
                return None, None
            if mpeg12:
                closed = [c if land is None or box.starts[i] >= land
                          else None
                          for i, c in enumerate(self.closed[s0:], s0)]
                out = [self.display[s0 + i] for i in output_order(
                    self.types[s0:], closed, self.low_delay,
                    [r - s0 for r in self.resets if r > s0])]
            elif box.codec == "h264":
                # FFmpeg's decoder, flushed, hands over nothing before an I
                # picture recovers it
                first_i = next((i for i in range(s0, self.samples)
                                if self.h264_types[i] == 1), self.samples)
                out = list(range(first_i, self.samples))
            else:
                out = list(range(s0, self.samples))
            # MPEG-4 from a P-VOP: FFmpeg decodes over a grey picture until
            # the next I-VOP, frames the port does not reproduce
            grey = (0 if mpeg12 or not pes or box.codec == "h264" else
                    next((i for i in range(s0, self.samples)
                          if box.types[i] == 1), self.samples) - s0)
            restart = s0 if box.codec == "dirac" else None

            def pick(n: int) -> Tuple[Optional[int], Optional[int]]:
                if n < grey:
                    raise Unsupported(
                        f"{self.path}: a seek to frame {target} reads a "
                        f"picture FFmpeg decodes from a P-VOP over a grey "
                        f"one (after landing on picture {s0}); not "
                        f"reproduced by the port ({ITEM_8})")
                return (out[n] if n < len(out) else None), restart

            if target < 2 or not out:
                return pick(target)
            got = number(out[0]) - first
            if got < 0 or got > target - 1:
                if temp == 0:
                    return pick(1)
                delta = delta * 2 if delta < 16 else delta * 3 // 2
                continue
            return pick(target - got)

    def _cut(self, i: int) -> bool:
        """Whether the container cut sample ``i`` short (NUT's last frame
        where the end of the file fell inside it)."""
        is_cut = getattr(self.box, "is_cut", None)
        return bool(is_cut and is_cut(i))

    def _decoder(self, seeking: bool = False):
        if self.box.codec == "mpeg12":
            return Mpeg12Decoder(what=self.path, extradata=self.box.dsi)
        if self.box.codec == "h264":
            return H264Decoder(what=self.path, extradata=self.box.dsi,
                               delay=self.h264_delay)
        if self.box.codec == "vp8":
            return Vp8Decoder(what=self.path)
        if self.box.codec == "vp9":
            return Vp9Decoder(what=self.path)
        if self.box.codec in ("h263", "flv1"):
            return H263Decoder(what=self.path,
                               sorenson=self.box.codec == "flv1",
                               after_seek=seeking)
        if self.box.codec == "magicyuv":
            return MagicyuvDecoder(what=self.path)
        if self.box.codec in MSMPEG4:   # the size comes from the container
            return Msmpeg4Decoder(self.box.codec, self.width, self.height,
                                  self.box.dsi, what=self.path)
        if self.box.codec == "snow":    # the size comes from the container
            return SnowDecoder(self.width, self.height, what=self.path)
        if self.box.codec == "dirac":
            return DiracDecoder(what=self.path)
        if self.box.codec == "jpeg2000":
            return J2kDecoder(what=self.path)
        if self.box.codec == "tiff":
            return TiffDecoder(what=self.path)
        if self.box.codec == "jpegls":
            return JplsDecoder(what=self.path)
        if self.box.codec == "speedhq":  # the size comes from the container
            return ShqDecoder(self.width, self.height, self.box.tag,
                              what=self.path)
        if self.box.codec == "asv":
            return AsvDecoder(self.width, self.height, self.box.tag,
                              self.box.dsi, what=self.path)
        if self.box.codec == "ffv1":
            return Ffv1Decoder(self.width, self.height, self.box.dsi,
                               what=self.path)
        if self.box.codec == "huffyuv":
            return HuffyuvDecoder(self.width, self.height, self.box.bpc,
                                  self.box.dsi, what=self.path)
        if self.box.codec == "utvideo":
            return UtvideoDecoder(self.width, self.height, self.box.tag,
                                  self.box.dsi, what=self.path)
        return Decoder(self.box.dsi, what=self.path, tag=self.box.tag)

    def _raw(self, data: bytes):
        """One raw frame as FFmpeg's rawvideo decoder lays it out: I420
        (and YV12, V before U; NV12, its chroma interleaved; Y41B, yuv411p)
        as its three planes; grey (``Y800``, ``GREY``, ``Y8  ``) as its
        plane, its rows 4-byte aligned where the packet holds that many
        (cv2 writes I420-sized packets under ``Y800``); RGBA, and AVI's
        32-bit ``BI_RGB`` (BGR0, bottom-up where the height is positive),
        as packed BGR; a ``yuv4`` packet (yuv4dec.c: U, V and the four Y
        of each 2x2 block, chroma stored ``^ 0x80``) as yuv420p planes."""
        w, h = self.width, self.height
        a = np.frombuffer(data, np.uint8)
        if self.box.codec == "yuv4":
            cw, ch = (w + 1) // 2, (h + 1) // 2
            if len(a) < 6 * cw * ch:
                raise ValueError(f"{self.path}: a yuv4 packet of {len(a)} "
                                 f"bytes, {w}x{h} needs {6 * cw * ch}")
            blocks = a[:6 * cw * ch].reshape(ch, cw, 6)
            y = np.empty((2 * ch, 2 * cw), np.uint8)
            y[0::2, 0::2], y[0::2, 1::2] = blocks[..., 2], blocks[..., 3]
            y[1::2, 0::2], y[1::2, 1::2] = blocks[..., 4], blocks[..., 5]
            return (np.ascontiguousarray(y[:h, :w]), blocks[..., 0] ^ 0x80,
                    blocks[..., 1] ^ 0x80)
        layout = ("i420" if self.box.codec == "i420"
                  else RAW_LAYOUTS[self.box.tag])
        if layout == "dib":
            # BI_RGB at 32 bits (BGR0); OpenCV 5.0 aborts on the 24-bit kind
            if self.box.bpc != 32:
                raise Unsupported(f"{self.path}: {self.box.bpc}-bit BI_RGB "
                                  f"video, not read by the port ({ITEM_8})")
            need = 4 * w * h
        elif layout == "gray":
            line = -(-w // 4) * 4 if -(-w // 4) * 4 * h <= len(a) else w
            need = w * h
        elif layout == "rgba":
            need = 4 * w * h
        elif layout == "yuv411p":
            cw, ch = (w + 3) // 4, h
            need = w * h + 2 * cw * ch
        else:
            cw, ch = (w + 1) // 2, (h + 1) // 2
            need = w * h + 2 * cw * ch
        if len(a) < need:
            raise ValueError(f"{self.path}: a raw {self.box.tag} frame of "
                             f"{len(a)} bytes, {w}x{h} needs {need}")
        if layout == "nv12":
            y = a[:w * h].reshape(h, w)
            uv = a[w * h:w * h + 2 * cw * ch].reshape(ch, cw, 2)
            return y, uv[..., 0], uv[..., 1]
        if layout in ("i420", "yv12", "yuv411p"):
            y = a[:w * h].reshape(h, w)
            c1 = a[w * h:w * h + cw * ch].reshape(ch, cw)
            c2 = a[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw)
            return (y, c2, c1) if layout == "yv12" else (y, c1, c2)
        if layout == "gray":
            return (np.lib.stride_tricks.as_strided(a, (h, w), (line, 1)),)
        if layout == "rgba":
            return np.ascontiguousarray(a[:need].reshape(h, w, 4)[..., 2::-1])
        rows = a[:need].reshape(h, w, 4)[..., :3]
        return np.ascontiguousarray(
            rows[::-1] if getattr(self.box, "bottom_up", False) else rows)

    def planes(self, start: int = 0, seeking: bool = False,
               restart: Optional[int] = None
               ) -> Iterator[Tuple[int, tuple]]:
        """(index, (Y, U, V)) of each picture of an MPEG-4 Part 2, H.263,
        VP8, VP9 or raw stream from frame ``start`` on; a sample that
        yields no picture (a not-coded VOP, a VP8 frame not shown) is
        passed over, as ``cv2.VideoCapture.read`` passes over it.
        ``seeking``: the decoder starts as FFmpeg's after OpenCV's seek
        (a Sorenson stream's disposable pictures are then all shown)."""
        if not 0 <= start < self.samples:
            raise IndexError(f"frame {start} of {self.path}, which has "
                             f"{self.samples}")
        if self.box.codec == "mpeg12":
            yield from self._mpeg12_planes(start)
            return
        if self.box.codec == "h264":
            yield from self._h264_planes(start, restart)
            return
        j = max(bisect_right(self.keyframes, start) - 1, 0)
        if j and self._cut(self.keyframes[j]):
            # FFmpeg conceals a cut I-VOP from the picture before it, which
            # OpenCV's seek (landing at least one frame early) has decoded
            j -= 1
        k = restart if restart is not None else self.keyframes[j]
        with open(self.path, "rb") as f:
            if self.box.codec in ("i420", "raw", "yuv4"):
                for i in range(start, self.samples):
                    yield i, self._raw(self.box.sample(f, i))
                return
            dec = self._decoder(seeking)
            ranges = [False] * self.threads
            for i in range(k, self.samples):
                sample = self.box.sample(f, i)
                if self.box.codec == "vp9":
                    # a packet shows any number of pictures (a superframe);
                    # FFmpeg hands swscale each frame's own range and matrix
                    for p in dec.decode_all(sample):
                        self.full_range = dec.full_range
                        self.matrix = VP9_MATRICES[dec.color_space]
                        if i >= start:
                            yield i, p
                    continue
                if self._cut(i):
                    if self.box.codec != "mpeg4":
                        raise Unsupported(
                            f"{self.path}: frame {i} is cut short by the end "
                            f"of the file; FFmpeg decodes what is there with "
                            f"its error concealment, which the port "
                            f"reproduces for MPEG-4 Part 2 only ({ITEM_8})")
                    p = dec.decode(sample, cut=True)
                else:
                    p = dec.decode(sample)
                # how the frame converts, where its decoder says: the chroma
                # subsampling, an alpha plane, the matrix and the range
                # (MagicYUV's packet header names all four)
                for name in ("shifts", "alpha", "matrix", "full_range",
                             "bits"):
                    setattr(self, name, getattr(dec, name, getattr(self, name)))
                if self.box.codec == "vp8":
                    # FFmpeg's frame threads each keep the clamping_type
                    # (full-range) bit of the last key frame they decoded
                    slot = (i - k) % self.threads
                    if dec.keyframe:
                        ranges[slot] = dec.clamping
                    self.full_range = ranges[slot]
                if p is not None and i >= start:
                    yield i, p
            if self.box.codec == "mpeg4":
                p = dec.flush()
                if p is not None and self.samples - 1 >= start:
                    yield self.samples - 1, p

    def _h264_planes(self, start: int, restart: Optional[int] = None
                     ) -> Iterator[Tuple[int, tuple]]:
        """(display index, planes) of an H.264 stream's pictures from frame
        ``start`` on, decoded from the key frame before it (or ``restart``),
        as FFmpeg's decoder hands them over: through its reorder buffer (P
        pictures may come out in another order than their packets, as their
        POCs say) and the flush at the end.  A key frame shows as many
        pictures before it as packets (an IDR picture or recovery point
        hands over all the decoder holds first), so its n-th picture handed
        over is frame k + n, as cv2 counts frames."""
        if not 0 <= start < self.samples:
            raise IndexError(f"frame {start} of {self.path}, which has "
                             f"{self.samples}")
        j = max(bisect_right(self.keyframes, start) - 1, 0)
        k = restart if restart is not None else self.keyframes[j]
        dec = self._decoder()
        n = k
        with open(self.path, "rb") as f:
            for i in range(k, self.samples + 1):
                for p in (dec.decode(self.box.sample(f, i))
                          if i < self.samples else dec.flush()):
                    if n >= start:
                        yield n, p
                    n += 1

    def _mpeg12_planes(self, start: int) -> Iterator[Tuple[int, tuple]]:
        """(display index, planes) of an MPEG-1/2 stream from display index
        ``start`` on, decoded from the I-picture before it."""
        if not 0 <= start < self.shown:
            raise IndexError(f"frame {start} of {self.path}, which shows "
                             f"{self.shown}")
        j = max(bisect_right(self._key_display, start) - 1, 0)
        k = self.keyframes[j]
        # the pictures a decoder started at sample k hands over, as
        # output_order plans them (open-GOP B-pictures before the first
        # reference dropped): the decoder must hand over exactly these
        plan = iter(output_order(self.types[k:], self.closed[k:],
                                 self.low_delay,
                                 [r - k for r in self.resets if r > k]))
        dec = self._decoder()
        with open(self.path, "rb") as f:
            for i in range(k, self.samples + 1):
                out = (dec.decode(self.box.sample(f, i)) if i < self.samples
                       else dec.flush())
                self.matrix = dec.matrix
                for p, serial in zip(out, dec.serials):
                    want = next(plan, None)
                    d = None if want is None else self.display[k + want]
                    if serial != want or d is None:
                        raise ValueError(
                            f"{self.path}: the decoder handed over picture "
                            f"{k + serial} of decode order where FFmpeg's "
                            f"output order has "
                            f"{'none' if want is None else k + want}")
                    if d >= start:
                        yield d, p
        left = next(plan, None)
        if left is not None:
            raise ValueError(f"{self.path}: the decoder never handed over "
                             f"picture {k + left} of decode order")

    def _decoded(self, start: int = 0, seeking: bool = False,
                 restart: Optional[int] = None
                 ) -> Iterator[Tuple[int, np.ndarray]]:
        """(index, BGR frame) of each picture from frame ``start`` on, turned
        as cv2 turns it by the container's display matrix
        (``io/orientation``: an MP4/QuickTime ``tkhd``, a Matroska
        ``Projection``)."""
        for i, frame in self._unturned(start, seeking, restart):
            yield i, rotate(frame, self.rotation)

    @property
    def display_size(self) -> Tuple[int, int]:
        """(``CAP_PROP_FRAME_WIDTH``, ``CAP_PROP_FRAME_HEIGHT``): the
        stream's size, swapped where cv2 turns its frames a quarter."""
        return display_size(self.width, self.height, self.rotation)

    def _unturned(self, start: int = 0, seeking: bool = False,
                  restart: Optional[int] = None
                  ) -> Iterator[Tuple[int, np.ndarray]]:
        """(index, BGR frame) of each picture from frame ``start`` on.  A
        picture of another size than the stream's (a VP9 frame that changed
        size, a VP8 key frame, an H.263 picture header) is scaled to it, as
        cv2 hands every frame to swscale at its stream's size."""
        if self.box.codec not in ("mjpeg", "png"):
            size = (self.width, self.height)
            for i, p in self.planes(start, seeking, restart):
                if isinstance(p, np.ndarray):
                    # RGB comes packed (BGR0/GBRP → BGR24 is a copy in
                    # swscale)
                    yield i, p
                elif len(p) == 1:
                    yield i, _grey_bgr(p[0])
                elif p[0].dtype == np.uint16:   # 9-16 bits (Dirac, JPEG 2000)
                    yield i, yuv16_to_bgr(*p, self.bits, self.shifts,
                                          self.full_range, self.matrix,
                                          self.chroma)
                elif self.shifts != (1, 1) or self.alpha or self.scaler:
                    yield i, yuv_to_bgr(*p, self.shifts, self.full_range,
                                        self.matrix, self.chroma, self.alpha,
                                        self.scaler)
                else:
                    yield i, i420_to_bgr(*p, self.full_range, self.chroma,
                                         self.matrix, size)
            return
        if not 0 <= start < self.samples:
            raise IndexError(f"frame {start} of {self.path}, which has "
                             f"{self.samples}")
        with open(self.path, "rb") as f:
            for i in range(start, self.samples):
                what = f"{self.path} frame {i}"
                data = self.box.sample(f, i)
                yield i, (decode_jpeg_ffmpeg(data, what)
                          if self.box.codec == "mjpeg" else
                          self._png(data, what))

    def _png(self, data: bytes, what: str) -> np.ndarray:
        """One PNG packet (``MPNG``, ``png ``) → BGR, as FFmpeg's png
        decoder and swscale hand it to cv2 (``_image_bgr``)."""
        if not data.startswith(_PNG_MAGIC):
            if b"fcTL" in data or b"fdAT" in data:
                raise Unsupported(f"{what}: an APNG-style packet (frame "
                                  f"control and data without a PNG "
                                  f"signature), not read by the port "
                                  f"({ITEM_8})")
            raise ValueError(f"{what}: not a PNG picture")
        frame = _image_bgr(data, what)
        if frame.shape[:2] != (self.height, self.width):
            raise Unsupported(f"{what}: a {frame.shape[1]}x{frame.shape[0]} "
                              f"picture in a {self.width}x{self.height} "
                              f"stream, not read by the port ({ITEM_8})")
        return frame

    def __iter__(self) -> Iterator[np.ndarray]:
        for _, frame in self._decoded():
            yield frame

    def frame(self, index: int) -> np.ndarray:
        """BGR frame ``index``, decoded from the keyframe before it: the
        frame a ``CAP_PROP_POS_FRAMES`` seek to ``index`` reads
        (:meth:`seek_target`)."""
        target, restart = self._seek(index)
        if target is None:
            raise ValueError(f"{self.path}: a seek to frame {index} reads no "
                             "frame (OpenCV's VideoCapture reads none either)")
        with closing(self._decoded(target, True, restart)) as it:
            for _, frame in it:
                return frame
        raise ValueError(f"{self.path}: frame {index} did not decode")

    def read(self, index: int) -> np.ndarray:
        """BGR frame ``index`` through one open decoder: the next frame in
        order costs one decode, as does frame 0 of a capture just opened
        (cv2 reads it without a seek, where an MPEG-1/2 seek to 0 may land
        elsewhere); any other index seeks (as :meth:`frame`)."""
        if self._gen is None and index == self._next == 0:
            self._gen = self._decoded(0)
        elif self._gen is None or index != self._next:
            if self._gen is not None:
                self._gen.close()
                self._gen = None
            target, restart = self._seek(index, self._index)
            if target is None:
                raise ValueError(f"{self.path}: a seek to frame {index} reads "
                                 "no frame (OpenCV's VideoCapture reads none either)")
            self._gen = self._decoded(target, True, restart)
        try:
            _, frame = next(self._gen)
        except StopIteration:
            self._gen = None
            raise ValueError(f"{self.path}: frame {index} did not decode")
        # cv2 counts on from the index it was asked for, whatever packet
        # the frame came from (a quirky MPEG-1/2 seek, a packet that showed
        # no picture: a Sorenson disposable picture FFmpeg skipped)
        self._next = index + 1
        return frame

    def close(self) -> None:
        """Close the file and decoder :meth:`read` keeps open; the next
        :meth:`read` starts as on a capture just opened."""
        if self._gen is not None:
            self._gen.close()
            self._gen = None
        self._next = 0
        self._index = {}


# --------------------------------------------------------------- image2

IMAGE2_FPS = 25.0      # image2's default frame rate
_FIRST_INDICES = 5     # image2's start_number_range: the first index is 0-4


def frame_filename(pattern: str, number: int) -> Optional[str]:
    """FFmpeg's ``av_get_frame_filename``: ``pattern`` with its one ``%d``
    (``%Nd`` and ``%0Nd`` pad with zeros to N digits) replaced by
    ``number`` and ``%%`` by ``%``; None where ``pattern`` is not one (no
    ``%d``, two, or another conversion)."""
    out, i, found = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        i += 1
        if c != "%":
            out.append(c)
            continue
        width = ""
        while i < len(pattern) and pattern[i].isdigit():
            width += pattern[i]
            i += 1
        conv = pattern[i] if i < len(pattern) else ""
        i += 1
        if conv == "%" and not width:
            out.append("%")
        elif conv == "d" and not found:
            found = True
            out.append(str(number).zfill(int(width or 0)))
        else:
            return None
    return "".join(out) if found else None


def _image2_range(pattern: str) -> Tuple[int, int]:
    """(first, last) index of image2's ``find_image_range``: the first in
    0-4 that names a file, the last found by doubling steps from it (so a
    gap can lie inside the range: reading stops there, as FFmpeg's does)."""
    exists = lambda i: os.path.isfile(frame_filename(pattern, i))  # noqa: E731
    first = next((i for i in range(_FIRST_INDICES) if exists(i)), None)
    if first is None:
        raise FileNotFoundError(
            f"no file or sequence with path {pattern!r} and index in the "
            f"range 0-{_FIRST_INDICES - 1} (OpenCV's VideoCapture does not "
            "open it either)")
    last = first
    while True:
        step = 0
        while exists(last + (2 * step or 1)):
            step = 2 * step or 1
        if not step:
            return first, last
        last += step


def _grey_bgr(g: np.ndarray) -> np.ndarray:
    """A grey plane as swscale's BGR24: replicated, a 16-bit sample rounded
    to 8 bits."""
    if g.dtype == np.uint16:
        g = np.minimum((g.astype(np.uint32) + 128) >> 8, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=2)


def _image_bgr(data: bytes, what: str) -> np.ndarray:
    """One image file's bytes → the BGR frame ``cv2.VideoCapture`` reads
    from it: JPEG through FFmpeg's decoder (``runtime/jpeg``'s FFmpeg
    flavour), PNG through ``io/images.decode_png`` and swscale's
    conversion to BGR24 (alpha dropped, grey replicated, a 16-bit grey
    sample rounded to 8 bits, 16-bit colour through swscale's YUV:
    ``runtime/mpeg4.rgb48_to_bgr``), TIFF through ``runtime/tiff`` and
    the same conversions (its YCbCr as yuv420p at video range)."""
    if is_jpeg(data):
        return decode_jpeg_ffmpeg(data, what)
    if is_tiff(data):
        p = TiffDecoder(what).decode(data)
        if isinstance(p, np.ndarray):
            return p
        return _grey_bgr(p[0]) if len(p) == 1 else i420_to_bgr(*p)
    img = decode_png(data)
    if img is None:
        raise Unsupported(f"{what}: {unread_format(data)}, which the port "
                          f"does not read in an image sequence ({ITEM_8})")
    if img.dtype == np.uint16:
        if img.ndim == 3 and img.shape[2] >= 3:
            return rgb48_to_bgr(img)
        img = np.minimum((img.astype(np.uint32) + 128) >> 8, 255).astype(
            np.uint8)
    return np.ascontiguousarray(rgb8(img)[..., ::-1])


class ImageSequence:
    """Image files read as ``cv2.VideoCapture`` reads them through
    FFmpeg's image2 demuxer: ``path`` is a printf pattern
    (``frames/%06d.jpg``; see :func:`frame_filename`) whose first index
    lies in 0-4, or one image file (a one-frame video).  25 fps; the frame
    count is image2's (``CAP_PROP_FRAME_COUNT``), and reading stops at the
    first missing file, as ``cv2.VideoCapture.read`` does.  A frame is read
    by its index, without seeking."""

    def __init__(self, path: str):
        self.path = path
        self.fps = IMAGE2_FPS
        if frame_filename(path, 0) is None:
            if not os.path.isfile(path):
                raise FileNotFoundError(path)
            self.files = [path]
        else:
            first, last = _image2_range(path)
            self.files = [frame_filename(path, i)
                          for i in range(first, last + 1)]
        self.readable = next((i for i, f in enumerate(self.files)
                              if not os.path.isfile(f)), len(self.files))
        self.height, self.width = self.frame(0).shape[:2]

    def __len__(self) -> int:
        return len(self.files)

    def frame(self, index: int) -> np.ndarray:
        """BGR frame ``index``."""
        if not 0 <= index < len(self.files):
            raise IndexError(f"frame {index} of {self.path}, which has "
                             f"{len(self.files)}")
        if index >= self.readable:
            raise ValueError(f"{self.path}: frame {index} is past the "
                             f"missing {self.files[self.readable]!r}, where "
                             "reading stops")
        with open(self.files[index], "rb") as f:
            return _image_bgr(f.read(), self.files[index])

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self.readable):
            yield self.frame(i)


# --------------------------------------------------------------- frame dir

_FRAME_EXTS = (".png", ".jpg", ".jpeg")


def _dir_frames(path: str):
    """The frame files of a directory in name order: its ``*.png``,
    ``*.jpg`` or ``*.jpeg`` files, of one kind."""
    found = {ext: sorted(glob(os.path.join(path, "*" + ext)))
             for ext in _FRAME_EXTS}
    kinds = [ext for ext, files in found.items() if files]
    if not kinds:
        raise FileNotFoundError(f"no *.png or *.jpg frames in {path}")
    if len(kinds) > 1:
        raise ValueError(f"{path} holds frames of more than one kind ("
                         + ", ".join("*" + k for k in kinds)
                         + "): a frame directory holds one")
    return found[kinds[0]]


def _read_frame_bgr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    img = decode_bytes(data, orient=False)
    if img is None:
        raise ValueError(f"{path}: {unread_format(data)}, which the frame "
                         "reader does not decode")
    return np.ascontiguousarray(rgb8(img)[..., ::-1])


# --------------------------------------------------------------- public

def read_frames(path: str, max_frames: Optional[int] = None,
                stride: int = 1) -> Iterator[np.ndarray]:
    """Yield BGR uint8 frames of ``path``: every ``stride``-th of its first
    ``max_frames`` (all when None)."""
    kind = _kind(path)
    if kind == "y4m":
        frames = iter(Y4MFile(path))
    elif kind in _ENCODED:
        frames = iter(EncodedVideo(path))
    elif kind == "sequence":
        frames = iter(ImageSequence(path))
    else:
        frames = (_read_frame_bgr(p) for p in _dir_frames(path))
    for n, frame in enumerate(frames):
        if max_frames is not None and n >= max_frames:
            return
        if n % stride == 0:
            yield frame


def read_frame(path: str, index: int) -> np.ndarray:
    """BGR uint8 frame ``index`` of a video file, image sequence or frame
    directory (an ``.mp4``/``.avi`` is decoded from the keyframe before
    it)."""
    kind = _kind(path)
    if kind == "y4m":
        return Y4MFile(path).frame(index)
    if kind in _ENCODED:
        return EncodedVideo(path).frame(index)
    if kind == "sequence":
        return ImageSequence(path).frame(index)
    return _read_frame_bgr(_dir_frames(path)[index])


def video_info(path: str) -> Dict[str, float]:
    """{"fps", "width", "height", "frames"} of a video file or image
    sequence, as ``cv2.VideoCapture``'s ``CAP_PROP_*`` give them (one image
    file: one frame, where cv2's count is undefined), or of a frame
    directory (which has no rate: 30 fps)."""
    kind = _kind(path)
    if kind in _ENCODED:
        v = EncodedVideo(path)
        w, h = v.display_size
        return {"fps": v.fps, "width": w, "height": h, "frames": v.frames}
    if kind == "sequence":
        seq = ImageSequence(path)
        return {"fps": seq.fps, "width": seq.width, "height": seq.height,
                "frames": len(seq)}
    if kind == "y4m":
        y4m = Y4MFile(path)
        return {"fps": y4m.fps, "width": y4m.width, "height": y4m.height,
                "frames": len(y4m)}
    files = _dir_frames(path)
    h, w = _read_frame_bgr(files[0]).shape[:2]
    return {"fps": DEFAULT_FPS, "width": w, "height": h,
            "frames": len(files)}


class Y4MWriter:
    """BGR frames → a ``C420jpeg`` YUV4MPEG2 file (OpenCV's conversion,
    ``runtime/mpeg4.to_i420``; an odd side is edge-padded for the chroma
    and cropped)."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int]):
        self.w, self.h = frame_size
        rate = Fraction(fps).limit_denominator(1001)
        self._f = open(path, "wb")
        self._f.write(f"YUV4MPEG2 W{self.w} H{self.h} F{rate.numerator}:"
                      f"{rate.denominator} Ip A1:1 C420jpeg\n".encode())

    def write(self, frame: np.ndarray) -> None:
        if frame.shape[:2] != (self.h, self.w):
            raise ValueError(f"frame {frame.shape[:2]} does not match the "
                             f"stream's {(self.h, self.w)}")
        yuv = to_i420(pad_to_even(frame))
        he, we = yuv.shape[0] * 2 // 3, yuv.shape[1]
        flat = yuv.reshape(-1)
        y = flat[:he * we].reshape(he, we)[:self.h, :self.w]
        self._f.write(b"FRAME\n")
        self._f.write(np.ascontiguousarray(y).tobytes())
        self._f.write(flat[he * we:].tobytes())

    def release(self) -> None:
        self._f.close()


def _rate(fps: float) -> Tuple[int, int]:
    """fps as (numerator, denominator), ``Fraction(fps).limit_denominator
    (1001)`` as ``Y4MWriter`` stores it, the numerator within MPEG-4's
    16-bit vop_time_increment_resolution."""
    if not fps > 0:
        raise ValueError(f"frame rate {fps} (must be > 0)")
    rate = Fraction(fps).limit_denominator(1001)
    if rate.numerator > 65535:
        rate = Fraction(fps).limit_denominator(max(1, int(65535 // fps)))
    if rate.numerator > 65535 or rate.numerator < 1:
        raise ValueError(f"frame rate {fps} has no MPEG-4 time base")
    return rate.numerator, rate.denominator


def _muxer(path: str, kind: str, size: Tuple[int, int],
           rate: Tuple[int, int], headers: bytes):
    """The container writer for ``path``, laid out as the FFmpeg muxer
    cv2's writer picks for its extension lays out its ``mp4v`` stream."""
    low = path.lower()
    if kind == "avi":
        return AviWriter(path, size, rate)
    if kind == "mkv":
        return MkvWriter(path, size, rate, headers)
    if kind == "mp4":
        return Mp4Writer(path, size, rate, headers)
    if kind == "nut":
        return NutWriter(path, size, rate, headers)
    if kind == "asf":
        return AsfWriter(path, size, rate, headers)
    if kind == "mpg":                   # cv2 takes the svcd muxer for .vob
        return PsWriter(path, rate, mpeg2=low.endswith(".vob"))
    return TsWriter(path, rate, m2ts=low.endswith(".m2ts"))


# the containers whose muxer takes no global header: the VOS/VOL headers
# go in band, before each I-VOP
_INBAND = ("avi", "mpg", "ts")


def _opencv_rate(fps: float) -> Tuple[int, int]:
    """fps as ``cv2.VideoWriter`` turns it into its codec's time base (a
    power of ten under the rate, 29.97 as 2997/100): the rate a program
    stream's MPEG-4 takes, since FFmpeg reports its VOL's time resolution
    as the frame rate there."""
    if not fps > 0:
        raise ValueError(f"frame rate {fps} (must be > 0)")
    num, den = int(fps + 0.5), 1
    while abs(num / den - fps) > 0.001:
        den *= 10
        num = int(fps * den + 0.5)
    if num > 65535:
        return _rate(fps)
    return num, den


class Mpeg4Writer:
    """BGR frames → MPEG-4 Part 2 Simple Profile in any container of
    :data:`WRITES` (ISO BMFF flavours, AVI, Matroska, NUT, ASF, program and
    transport streams; ``_muxer``)
    (``runtime/mpeg4``'s encoder: an I-VOP every 12 frames, P-VOPs between,
    quantiser 3, as ``cv2.VideoWriter`` with fourcc ``mp4v`` writes; the
    VOL headers in band where the container has no global header, as in
    cv2's AVI, program and transport streams).
    An odd side is cropped to even (its last column or row dropped), as
    cv2's writer crops it.  Frames go to I420 in ``io/yuv.rgb_to_i420``'s
    arithmetic (in C, ``runtime/mpeg4.to_i420``).
    ``keep_recon`` keeps each frame's reconstruction (Y, U, V) in
    ``recon``, what every decoder that matches FFmpeg gives back."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int],
                 *, keep_recon: bool = False):
        self.in_w, self.in_h = frame_size
        self.w, self.h = self.in_w & ~1, self.in_h & ~1
        if self.w < 2 or self.h < 2:
            raise ValueError(f"frame size {frame_size} is too small to encode")
        kind = _kind(path, writing=True)
        rate = _opencv_rate(fps) if kind == "mpg" else _rate(fps)
        self.enc = Encoder(self.w, self.h, *rate, inband=kind in _INBAND)
        self.mux = _muxer(path, kind, (self.w, self.h), rate,
                          self.enc.headers)
        self.recon = [] if keep_recon else None

    def write(self, frame: np.ndarray) -> None:
        if frame.shape[:2] != (self.in_h, self.in_w):
            raise ValueError(f"frame {frame.shape[:2]} does not match the "
                             f"stream's {(self.in_h, self.in_w)}")
        sample, key = self.enc.encode(
            *i420_planes(to_i420(frame[:self.h, :self.w])))
        self.mux.write(sample, key)
        if self.recon is not None:
            self.recon.append(self.enc.recon())

    def release(self) -> None:
        self.mux.release()


class PngDirWriter:
    """BGR frames → ``<dir>/000000.png``, ``000001.png``, ..."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int]):
        os.makedirs(path, exist_ok=True)
        self.path, self.n = path, 0

    def write(self, frame: np.ndarray) -> None:
        with open(os.path.join(self.path, f"{self.n:06d}.png"), "wb") as f:
            f.write(encode_png(np.ascontiguousarray(frame[..., ::-1])))
        self.n += 1

    def release(self) -> None:
        pass


class AsyncVideoWriter:
    """A video writer behind a background encode thread.

    ``path`` ending in any extension cv2's ``mp4v`` writer opens (``.mp4``,
    ``.mov``, ``.m4v``, ``.3gp``, ``.3g2``, ``.avi``, ``.mkv``, ``.nut``,
    ``.wmv``, ``.asf``, ``.mpg``, ``.mpeg``, ``.vob``, ``.ts``, ``.mts``,
    ``.m2t``, ``.m2ts``) writes MPEG-4 Part 2 (:class:`Mpeg4Writer`) into
    the container its FFmpeg muxer writes; ``.y4m`` YUV4MPEG2; a directory
    (or a path without extension) PNG frames.  Anything else (``.webm``,
    ``.flv``, ``.mxf``, ``.ogv``, elementary streams) raises
    ``ValueError``: cv2's writer does not open on those, and where it does
    not, the JAX CLI runs on and writes nothing.
    ``write`` enqueues, blocking only when ``queue_size`` frames are
    already pending; ``release`` drains the queue, closes the file and
    re-raises any encoder error.
    """

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int],
                 *, queue_size: int = 32):
        kind = _kind(path, writing=True)
        writer = {"y4m": Y4MWriter, "png": PngDirWriter}.get(kind,
                                                             Mpeg4Writer)
        self._wr = writer(path, fps, frame_size)
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(
            maxsize=queue_size)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._encode_loop, daemon=True)
        self._thread.start()

    def _encode_loop(self) -> None:
        while True:
            frame = self._q.get()
            if frame is None:
                break
            try:
                self._wr.write(frame)
            except BaseException as e:  # surface on the caller's thread
                self._exc = e
                break
        self._wr.release()

    def isOpened(self) -> bool:  # noqa: N802 — cv2.VideoWriter's name
        return self._exc is None

    def _put(self, item: Optional[np.ndarray]) -> None:
        # bounded-wait put: if the encoder thread died (its exception is in
        # self._exc) nobody will drain the queue, and a plain blocking put
        # would deadlock the producer with the error never surfacing
        while True:
            if self._exc is not None:
                raise self._exc
            if not self._thread.is_alive():
                raise RuntimeError("encoder thread is not running "
                                   "(write after release?)")
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def write(self, frame: np.ndarray) -> None:
        self._put(frame)

    def release(self) -> None:
        if self._thread.is_alive():
            try:
                self._put(None)
            except Exception:
                pass  # encoder died; its error is re-raised below
            self._thread.join()
        if self._exc is not None:
            raise self._exc
