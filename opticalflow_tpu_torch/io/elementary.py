"""Elementary video streams: raw MPEG-1/2 video (``.m1v``, ``.m2v``,
``.mpv``), raw H.263 (``.h263``, ``.263``), raw Dirac/VC-2 (``.drc``,
what ``cv2.VideoWriter`` writes for fourcc ``drac`` there) and raw H.264
(``.h264``, ``.264``, ``.avc``, ``.h26l``, Annex B), read as FFmpeg's
``mpegvideo``, ``h263``, ``dirac`` and ``h264`` raw demuxers read them for
``cv2.VideoCapture``, in Python (no FFmpeg).

The file is one stream without timestamps, split into pictures by
FFmpeg's parsers (``io/mpegpes``).  What cv2 reports of it follows from
the raw demuxers' settings:

  * fps is 25 whatever the stream says: the raw demuxers set the stream's
    ``avg_frame_rate`` from their ``framerate`` option, 25 by default, and
    OpenCV reports ``avg_frame_rate`` (H.263 at 29.97 Hz reads at 25, so
    does Dirac at any rate its sequence header names, and H.264 at any rate
    its VUI names);
  * the frame count is OpenCV's ``duration × fps``, rounded down after
    adding 0.5.  FFmpeg knows no duration for MPEG-2 or H.263 here
    (``AV_NOPTS_VALUE``, INT64_MIN ticks of 1/1200000 s), which OpenCV
    turns into -192153584101141 at 25 fps (H.264 too).  Where a bit rate
    is known it
    estimates one from it (``estimate_timings_from_bit_rate``: the file's
    bits over the rate): MPEG-1's is 400 × bit_rate_value, 104857600 b/s
    for the VBR marker cv2's writer leaves, so a small file counts 0;
    MPEG-2's only where its picture header's vbv_delay is not 0xFFFF
    (constant bit rate; cv2's writer's is VBR);
  * a ``CAP_PROP_POS_FRAMES`` seek is clamped to that count: at a count
    under 2 OpenCV asks FFmpeg for no seek, so a capture just opened reads
    frame 0 (frame 1 after a seek to 1 or more at a count of 1): every
    seek in a ``.drc`` reads its frame 0.
    FFmpeg's generic index seek, which a count of 2 or more starts (from a
    start time it does not know), is not reproduced: such a seek raises
    ``Unsupported``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

from opticalflow_tpu_torch.io.mpegpes import Pes, PesVideo
from opticalflow_tpu_torch.io.mpegps import video_codec
from opticalflow_tpu_torch.runtime.dirac import \
    sequence_info as dirac_sequence
from opticalflow_tpu_torch.runtime.h263 import picture_size
from opticalflow_tpu_torch.runtime.h264 import probe as h264_probe
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
from opticalflow_tpu_torch.runtime.mpeg12 import sequence_info

__all__ = ["ElementaryFile", "MPEG_EXTENSIONS", "H263_EXTENSIONS",
           "H264_EXTENSIONS",
           "DIRAC_EXTENSIONS", "RAW_FPS", "nopts_count"]

MPEG_EXTENSIONS = (".m1v", ".m2v", ".mpv")
H264_EXTENSIONS = (".h264", ".264", ".avc", ".h26l")
H263_EXTENSIONS = (".h263", ".263")
DIRAC_EXTENSIONS = (".drc",)
RAW_FPS = 25                    # the raw demuxers' framerate option
RAW_TIME_BASE = 1200000         # their time base: 1/1200000 s
_INT64_MIN = -(1 << 63)         # AV_NOPTS_VALUE


def nopts_count(fps: float) -> int:
    """OpenCV's frame count where FFmpeg knows no duration: the stream's
    duration (``AV_NOPTS_VALUE`` ticks) in seconds, times fps, plus 0.5,
    rounded down, in doubles as OpenCV computes it."""
    sec = float(_INT64_MIN) * (1.0 / RAW_TIME_BASE)
    return int(math.floor(sec * fps + 0.5))


def _bit_rate(sample: bytes, mpeg2: bool) -> int:
    """The bit rate FFmpeg exports for a raw MPEG-1/2 stream from its first
    sample: 400 × bit_rate_value for MPEG-1 (the VBR marker 0x3FFFF too);
    for MPEG-2, with the sequence extension's high bits, only where the
    picture's vbv_delay is not 0xFFFF (the ``mpegvideo`` parser's rule), so
    a VBR stream has none."""
    i = sample.find(b"\x00\x00\x01\xb3")
    if i < 0 or i + 11 > len(sample):
        return 0
    b = sample[i + 8:i + 11]
    value = b[0] << 10 | b[1] << 2 | b[2] >> 6
    if not mpeg2:
        return 400 * value
    j = sample.find(b"\x00\x00\x01\xb5", i)
    if j < 0 or j + 8 > len(sample) or sample[j + 4] >> 4 != 1:
        return 0
    value |= ((sample[j + 6] & 0x1F) << 7 | sample[j + 7] >> 1) << 18
    k = sample.find(b"\x00\x00\x01\x00", j)
    if k < 0 or k + 8 > len(sample):
        return 0
    vbv_delay = (int.from_bytes(sample[k + 4:k + 8], "big") >> 3) & 0xFFFF
    return 400 * value if vbv_delay != 0xFFFF else 0


class ElementaryFile(PesVideo):
    """An elementary MPEG-1/2, H.263, Dirac or H.264 stream: one sample a
    picture (an access unit)."""

    def __init__(self, path: str):
        super().__init__(path)
        self.size = os.path.getsize(path)
        if not self.size:
            raise ValueError(f"{path}: empty file")
        pes = Pes(0, 0, None, None)
        pes.add(0, self.size)
        self.pes = [pes]
        with open(path, "rb") as f:
            head = f.read(4096)
            if head.startswith(b"\x00\x00\x01\xba"):
                raise ValueError(f"{path}: a program stream (pack headers) "
                                 "under an elementary stream's extension: "
                                 "rename it .mpg")
            if path.lower().endswith(H263_EXTENSIONS):
                self.codec = "h263"
            elif path.lower().endswith(DIRAC_EXTENSIONS):
                self.codec = "dirac"
            elif path.lower().endswith(H264_EXTENSIONS):
                self.codec = "h264"
            else:
                self.codec = video_codec(head, path)
                if self.codec != "mpeg12":
                    raise Unsupported(f"{path}: an MPEG-4 Part 2 elementary "
                                      f"stream under an MPEG-1/2 extension, "
                                      f"not read by the port ({ITEM_8})")
            self._split(f)
            if not self.starts:
                raise ValueError(f"{path}: no picture in the stream")
            first = self.sample(f, 0)
        self.bit_rate = 0
        self.mpeg2 = False
        if self.codec == "h264":
            info = h264_probe(first, path)
            if info is None:
                raise ValueError(f"{path}: H.264 video without an SPS before "
                                 "its first picture")
            self.width, self.height = info.width, info.height
        elif self.codec == "dirac":
            info = dirac_sequence(first, path)
            if info is None:
                raise ValueError(f"{path}: no Dirac sequence header")
            self.width, self.height = info.width, info.height
        elif self.codec == "h263":
            size = picture_size(first)
            if size is None:
                raise ValueError(f"{path}: no H.263 picture header")
            self.width, self.height = size
        else:
            seq = sequence_info(first, path)
            if seq is None:
                raise ValueError(f"{path}: MPEG-1/2 video without a "
                                 "sequence header")
            self.width, self.height, self.mpeg2 = (seq.width, seq.height,
                                                   seq.mpeg2)
            self.bit_rate = _bit_rate(first, self.mpeg2)
        self.keyframes = [i for i, t in enumerate(self.types) if t == 1] or [0]

    @property
    def fps(self) -> float:
        return float(RAW_FPS)

    @property
    def frames(self) -> int:
        """``CAP_PROP_FRAME_COUNT`` (see the module's notes)."""
        if not self.bit_rate:
            return nopts_count(self.fps)
        # st->duration = av_rescale(8 · size, 1200000, bit_rate), then
        # ic->duration in µs (av_rescale_q, rounded to nearest)
        ticks = (8 * self.size * RAW_TIME_BASE + self.bit_rate // 2) \
            // self.bit_rate
        us = (ticks * 1000000 + RAW_TIME_BASE // 2) // RAW_TIME_BASE
        return int(math.floor(us / 1e6 * self.fps + 0.5))

    def seek_target(self, index: int) -> Optional[int]:
        """The frame a ``CAP_PROP_POS_FRAMES`` seek to ``index`` reads on a
        capture just opened (see the module's notes)."""
        count = self.frames
        if count < 2:
            return 1 if count == 1 and index >= 1 else 0
        raise Unsupported(f"{self.path}: a seek in an elementary stream of "
                          f"{count} frames by OpenCV's count goes through "
                          f"FFmpeg's generic index seek, which the port does "
                          f"not reproduce ({ITEM_8}); read it in order")
