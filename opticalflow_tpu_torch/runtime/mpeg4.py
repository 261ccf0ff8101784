"""ctypes binding of the port's MPEG-4 Part 2 codec (``mpeg4.cpp``).

:class:`Decoder` turns MPEG-4 Part 2 Simple Profile samples (what
``cv2.VideoWriter`` writes with fourcc ``mp4v``, ``XVID`` or ``FMP4``) into
I420 planes, bit-exact to FFmpeg's decoder; :func:`i420_to_bgr` converts
them in swscale's arithmetic, so the frames equal ``cv2.VideoCapture``'s.
:class:`Encoder` writes the same profile: an I-VOP every 12 frames,
P-VOPs with 1MV half-pel motion between them, a fixed quantiser;
:func:`to_i420` converts BGR or RGB frames to I420 for it (and for the
port's other I420 writers) in ``io/yuv.rgb_to_i420``'s arithmetic.  The
library is built with ``g++`` at first use into
``opticalflow_tpu_torch/_build/`` by ``runtime/_native.py``; a failed build
raises with the compiler's output.  Its calls release the GIL.

Streams outside the Simple Profile raise :class:`Unsupported` (a
``ValueError``) naming the feature and ROADMAP Queue 1 item 8; damaged ones
raise ``ValueError``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load

__all__ = ["Decoder", "Encoder", "Unsupported", "i420_to_bgr",
           "rgb48_to_bgr", "to_i420", "yuv_to_bgr",
           "ITEM_8", "load"]

ITEM_8 = "ROADMAP Queue 1 item 8"
_SRC = Path(__file__).resolve().parent / "mpeg4.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(_I64)
_MSG = 400
_OK, _NO_FRAME, _UNSUPPORTED = 0, 1, 2

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]
_XVID_TAGS = {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"}


class Unsupported(ValueError):
    """A stream (or container entry) the port does not decode."""


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the MPEG-4 Part 2 codec")
        sig = {
            "om4_dec_new": (_P, [ctypes.c_int]),
            "om4_dec_free": (None, [_P]),
            "om4_dec_headers": (ctypes.c_int, [_P, ctypes.c_char_p, _I64, _I64P,
                                               ctypes.c_char_p, _I64]),
            "om4_dec_decode": (ctypes.c_int, [_P, ctypes.c_char_p, _I64, _I64P,
                                              ctypes.c_char_p, _I64,
                                              ctypes.c_int]),
            "om4_dec_output": (None, [_P, _P, _P, _P]),
            "om4_dec_concealment": (None, [_P, _I64P]),
            "om4_dec_flush": (ctypes.c_int, [_P, _I64P]),
            "om4_yuv420_scale_to_bgr": (ctypes.c_int, [_P, _P, _P]
                                        + [ctypes.c_int] * 10 + [_P]),
            "om4_yuv420_to_bgr": (None, [_P, _P, _P] + [ctypes.c_int] * 8
                                  + [_P]),
            "om4_yuv_to_bgr": (None, [_P, _P, _P] + [ctypes.c_int] * 11
                               + [_P]),
            "om4_rgb48_to_bgr": (None, [_P, ctypes.c_int, _I64, _P]),
            "om4_yuv16_to_bgr": (None, [_P, _P, _P] + [ctypes.c_int] * 11
                                 + [_P]),
            "om4_to_i420": (None, [_P, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _P, _P, _P]),
            "om4_enc_new": (_P, [_I64P, ctypes.c_char_p, ctypes.c_char_p, _I64]),
            "om4_enc_free": (None, [_P]),
            "om4_enc_headers": (_I64, [_P, _P, _I64]),
            "om4_enc_frame": (_I64, [_P, _P, _P, _P, _I64P, ctypes.c_char_p,
                                     _I64]),
            "om4_enc_take": (None, [_P, _P]),
            "om4_enc_recon": (None, [_P, _P, _P, _P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def _raise(rc: int, msg, what: str):
    text = msg.value.decode("utf-8", "replace")
    if rc == _UNSUPPORTED:
        if text.startswith("error concealment"):
            raise Unsupported(f"{what}: {text}, not reproduced by the port "
                              f"({ITEM_8})")
        raise Unsupported(f"{what}: {text}: the port decodes MPEG-4 Part 2 "
                          f"Simple Profile only ({ITEM_8})")
    raise ValueError(f"{what}: corrupt MPEG-4 Part 2 stream: {text}")


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class Decoder:
    """One stream's decoder.  ``headers`` is the DecoderSpecificInfo (an
    MP4 ``esds``'s VOS/VO/VOL headers) or empty, when the VOL comes in band
    (AVI); ``tag`` the container's fourcc (FFmpeg takes a stream under
    ``XVID`` without user data for Xvid's, which the port refuses).  ``what``
    names the source in errors."""

    def __init__(self, headers: bytes = b"", what: str = "video",
                 tag: str = "mp4v"):
        self._lib = load()
        self._h = self._lib.om4_dec_new(int(tag in _XVID_TAGS))
        self.what = what
        self.width = self.height = 0
        if headers:
            self.probe(headers)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.om4_dec_free(h)

    def probe(self, data: bytes) -> None:
        """Read the headers in ``data`` (a sample with in-band VOL headers),
        setting ``width`` and ``height``, without decoding its VOP."""
        wh = (_I64 * 2)()
        msg = ctypes.create_string_buffer(_MSG)
        data = bytes(data)
        rc = self._lib.om4_dec_headers(self._h, data, len(data), wh, msg,
                                       _MSG)
        if rc != _OK:
            _raise(rc, msg, self.what)
        self.width, self.height = int(wh[0]), int(wh[1])

    def decode(self, sample: bytes, cut: bool = False) -> Optional[Planes]:
        """One sample → its picture's (Y, U, V) planes at the display size,
        or None for a sample that yields no picture (a not-coded VOP, or
        headers alone), as FFmpeg hands them over.  ``cut``: the container
        cut the sample short (the end of the file fell inside it); its VOP
        is decoded up to the first macroblock that fails (or where the data
        ends its slice) and the rest concealed as FFmpeg's error resilience
        conceals it (:attr:`concealment`: a damaged region taken from the
        last picture with guessed vectors, or from its DCs, deblocked)."""
        wh = (_I64 * 2)()
        msg = ctypes.create_string_buffer(_MSG)
        sample = bytes(sample)
        rc = self._lib.om4_dec_decode(self._h, sample, len(sample), wh, msg,
                                      _MSG, int(cut))
        if rc == _NO_FRAME:
            return None
        if rc != _OK:
            _raise(rc, msg, self.what)
        return self._output(wh)

    def flush(self) -> Optional[Planes]:
        """The end of the stream: the last picture again where the last VOP
        was not coded (FFmpeg's flush after an N-VOP, also one read from a
        cut VOP's padding), else None."""
        wh = (_I64 * 2)()
        if self._lib.om4_dec_flush(self._h, wh) != _OK:
            return None
        return self._output(wh)

    def _output(self, wh) -> Planes:
        w, h = int(wh[0]), int(wh[1])
        self.width, self.height = w, h
        cw, ch = (w + 1) // 2, (h + 1) // 2
        y = np.empty((h, w), np.uint8)
        u = np.empty((ch, cw), np.uint8)
        v = np.empty((ch, cw), np.uint8)
        self._lib.om4_dec_output(self._h, _ptr(y), _ptr(u), _ptr(v))
        return y, u, v

    @property
    def concealment(self) -> Optional[dict]:
        """The last VOP FFmpeg's error resilience concealed (None before
        one): its ``type`` ("I" or "P"), the macroblock whose data failed or
        the first one missing after its slice ended (``slice_ended``),
        the macroblocks that kept their vectors (``kept``), whether
        guess_mv searched for the damaged ones' vectors (``searched``: more
        than half the longer side's count kept theirs) and whether they
        were taken as intra (``spatial``: is_intra_more_likely)."""
        out = (_I64 * 6)()
        self._lib.om4_dec_concealment(self._h, out)
        kind, mb, ended, kept, searched, spatial = (int(v) for v in out)
        if not kind:
            return None
        return {"type": "IP"[kind - 1], "macroblock": mb,
                "slice_ended": bool(ended), "kept": kept,
                "searched": bool(searched), "spatial": bool(spatial)}


# FFmpeg's chroma locations as swscale sites (x, y) in 1/256 of a luma
# sample from the first luma sample's: what the scaler interpolates from
CHROMA_SITES = {"center": (128, 128), "left": (0, 128), "topleft": (0, 0)}
# swscale's YUV -> RGB matrices (ffmpeg_dsp.h's kMatrices, in order)
MATRICES = ("bt601", "bt709", "smpte240m", "bt2020", "fcc")


def i420_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                full_range: bool = False,
                chroma: Optional[Tuple[int, int]] = None,
                matrix: str = "bt601",
                size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """(H, W) Y and (⌈H/2⌉, ⌈W/2⌉) U, V uint8 planes → (H, W, 3) BGR as
    swscale converts them for ``cv2.VideoCapture`` (BT.601, video range, or
    full range where ``full_range``): its x86 yuv2rgb with nearest chroma at
    an even height, its bicubic scaler at an odd one (full-width chroma
    where the width is odd too), which interpolates the chroma from the
    site the decoder reports (``chroma``: an (x, y) site, one of
    ``CHROMA_SITES``' values; None for none), with the matrix swscale is
    handed (``MATRICES``: BT.601 unless a VP9 stream names another).
    ``size`` (width, height) other than the planes' scales them there,
    luma and chroma through swscale's bicubic filters, as cv2 converts a
    picture of another size than its stream's first.  Every decoder of the
    port that hands over 4:2:0 planes (MPEG-4 Part 2, VP8, VP9, H.263, raw
    I420, ``.y4m``) converts here."""
    h, w = y.shape
    ys, us, vs = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    if us.shape != ((h + 1) // 2, (w + 1) // 2) or vs.shape != us.shape:
        raise ValueError(f"chroma planes {us.shape}, {vs.shape} do not match "
                         f"a {h}x{w} luma plane")
    hpos, vpos = chroma or (-1, -1)
    dw, dh = size or (w, h)
    out = np.empty((dh, dw, 3), np.uint8)
    if (dw, dh) == (w, h):
        load().om4_yuv420_to_bgr(_ptr(ys), _ptr(us), _ptr(vs), w, h, w,
                                 us.shape[1], int(full_range), hpos, vpos,
                                 MATRICES.index(matrix), _ptr(out))
    elif load().om4_yuv420_scale_to_bgr(
            _ptr(ys), _ptr(us), _ptr(vs), w, h, w, us.shape[1],
            int(full_range), hpos, vpos, MATRICES.index(matrix), dw, dh,
            _ptr(out)):
        raise Unsupported(f"a {w}x{h} picture scaled to {dw}x{dh} through "
                          "swscale's two-tap luma path, not read by the port "
                          f"({ITEM_8})")
    return out


def yuv16_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray, bits: int,
                 shifts: Tuple[int, int], full_range: bool = False,
                 matrix: str = "bt601",
                 chroma: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """(H, W) Y and subsampled U, V planes of 9- to 16-bit samples
    (uint16, as FFmpeg's yuv4xxp9-16 hold them) → (H, W, 3) BGR as
    swscale converts them for ``cv2.VideoCapture``: always its bicubic
    scaler (no unscaled path takes them), each row read at 15 bits by
    hScale16To15, then what :func:`yuv_to_bgr` does for 8-bit planes."""
    if not 9 <= bits <= 16:
        raise ValueError(f"{bits}-bit samples (9 to 16)")
    h, w = y.shape
    hs, vs = shifts
    ys, us, vs_ = (np.ascontiguousarray(p, np.uint16) for p in (y, u, v))
    want = (-(-h >> vs), -(-w >> hs))
    if us.shape != want or vs_.shape != want:
        raise ValueError(f"chroma planes {us.shape}, {vs_.shape} do not match "
                         f"a {h}x{w} luma plane subsampled by {shifts}")
    hpos, vpos = chroma or (-1, -1)
    out = np.empty((h, w, 3), np.uint8)
    load().om4_yuv16_to_bgr(_ptr(ys), _ptr(us), _ptr(vs_), w, h, w, want[1],
                            hs, vs, bits, int(full_range), hpos, vpos,
                            MATRICES.index(matrix), _ptr(out))
    return out


def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               shifts: Tuple[int, int], full_range: bool = False,
               matrix: str = "bt601",
               chroma: Optional[Tuple[int, int]] = None,
               alpha: bool = False, scaler: bool = False) -> np.ndarray:
    """(H, W) Y and (⌈H >> vshift⌉, ⌈W >> hshift⌉) U, V uint8 planes, the
    chroma subsampled by ``shifts`` (hshift, vshift: 4:4:4 (0, 0), 4:2:2
    (1, 0), 4:2:0 (1, 1), 4:1:1 (2, 0), 4:4:0 (0, 1), 4:1:0 (2, 2)), →
    (H, W, 3) BGR as swscale converts them for ``cv2.VideoCapture``: 4:2:0
    and 4:2:2 at an even height through its x86 yuv2rgb, the rest through
    its bicubic scaler (``ffmpeg_dsp.h``'s ``yuv_to_bgr``), with the matrix
    and range the decoder reports and ``chroma``'s site as in
    :func:`i420_to_bgr`.  ``alpha``: the planes come from a format with
    an alpha plane (dropped), which swscale's unscaled yuv2rgb takes only at
    4:2:0 (yuva422p goes through its scaler); ``scaler``: through the
    scaler whatever the layout (what swscale does with NV12's interleaved
    chroma)."""
    h, w = y.shape
    hs, vs = shifts
    ys, us, vs_ = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    want = (-(-h >> vs), -(-w >> hs))
    if us.shape != want or vs_.shape != want:
        raise ValueError(f"chroma planes {us.shape}, {vs_.shape} do not match "
                         f"a {h}x{w} luma plane subsampled by {shifts}")
    hpos, vpos = chroma or (-1, -1)
    out = np.empty((h, w, 3), np.uint8)
    load().om4_yuv_to_bgr(_ptr(ys), _ptr(us), _ptr(vs_), w, h, w, want[1],
                          hs, vs, int(full_range), hpos, vpos,
                          MATRICES.index(matrix),
                          int(scaler or (alpha and shifts != (1, 1))),
                          _ptr(out))
    return out


def rgb48_to_bgr(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3 or 4) uint16 RGB or RGBA → (H, W, 3) uint8 BGR as swscale
    converts FFmpeg's 16-bit colour PNG pictures (rgb48be, rgba64be) for
    ``cv2.VideoCapture``: through its video-range BT.601 YUV at 15 bits,
    full chroma, alpha dropped (``ffmpeg_dsp.h``'s ``rgb48_to_bgr``)."""
    if rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(f"16-bit RGB or RGBA expected, got {rgb.shape}")
    src = np.ascontiguousarray(rgb, np.uint16)
    out = np.empty(rgb.shape[:2] + (3,), np.uint8)
    load().om4_rgb48_to_bgr(_ptr(src), rgb.shape[2],
                            rgb.shape[0] * rgb.shape[1], _ptr(out))
    return out


def to_i420(frame: np.ndarray, channels: str = "bgr") -> np.ndarray:
    """(H, W, 3) uint8 BGR (or RGB, ``channels="rgb"``), H and W even →
    (H·3/2, W) uint8 I420 in OpenCV's packed layout, bit-exact to
    ``io/yuv.rgb_to_i420`` (OpenCV's ``COLOR_RGB2YUV_I420``), in C with the
    GIL released: the conversion of every I420 writer and upload of the
    port; the numpy version is its reference in the tests."""
    h, w = frame.shape[:2]
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3 \
            or h % 2 or w % 2:
        raise ValueError(f"to_i420 takes uint8 (H, W, 3) with even sides, "
                         f"got {frame.dtype} {frame.shape}")
    if channels not in ("bgr", "rgb"):
        raise ValueError(f"channels {channels!r} (bgr or rgb)")
    src = np.ascontiguousarray(frame)
    out = np.empty((h * 3 // 2, w), np.uint8)
    flat = out.reshape(-1)
    n, c = h * w, h * w // 4
    load().om4_to_i420(_ptr(src), w, h, int(channels == "rgb"), _ptr(out),
                       _ptr(flat[n:]), _ptr(flat[n + c:]))
    return out


class Encoder:
    """MPEG-4 Part 2 Simple Profile encoder for (``width``, ``height``)
    frames (even sides) at ``fps_num / fps_den`` frames a second
    (``fps_num`` ≤ 65535).

    ``qscale`` is the fixed quantiser (3 is what ``cv2.VideoWriter`` uses);
    an I-VOP comes every 12 frames; ``inband`` repeats the VOS/VO/VOL headers
    before every I-VOP (for AVI, which has no DecoderSpecificInfo).  The
    rest are coding tools the decoder reads, off by default as in FFmpeg's
    writer, switched on by the tests to hold the decoder to FFmpeg on them:
    ``packet_rows`` (a video packet every n macroblock rows), ``rounding=1``
    (alternate vop_rounding_type), ``mv4``, ``mpeg_quant`` ((intra, inter)
    raster-order 8x8 matrices), ``dquant`` (a per-macroblock quantiser
    pattern), ``ac_pred``."""

    def __init__(self, width: int, height: int, fps_num: int, fps_den: int,
                 *, qscale: int = 3, inband: bool = False,
                 packet_rows: int = 0, rounding: int = 0, mv4: bool = False,
                 ac_pred: bool = True,
                 mpeg_quant: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 dquant: int = 0):
        self._lib = load()
        self.width, self.height = width, height
        prm = (_I64 * 12)(width, height, qscale, fps_num, fps_den,
                          int(inband), packet_rows, rounding, int(mv4),
                          int(ac_pred), int(mpeg_quant is not None), dquant)
        mats = b"\0" * 128
        if mpeg_quant is not None:
            mats = b"".join(np.asarray(m, np.uint8).reshape(64).tobytes()
                            for m in mpeg_quant)
        msg = ctypes.create_string_buffer(_MSG)
        self._h = self._lib.om4_enc_new(prm, mats, msg, _MSG)
        if not self._h:
            raise ValueError(f"MPEG-4 encoder: {msg.value.decode()}")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.om4_enc_free(h)

    @property
    def headers(self) -> bytes:
        """The VOS/VO/VOL headers: an MP4 DecoderSpecificInfo."""
        n = self._lib.om4_enc_headers(self._h, None, 0)
        buf = ctypes.create_string_buffer(n)
        self._lib.om4_enc_headers(self._h, buf, n)
        return buf.raw

    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray
               ) -> Tuple[bytes, bool]:
        """One frame's I420 planes → (its VOP, whether it is an I-VOP)."""
        w, h = self.width, self.height
        ys, us, vs = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
        if ys.shape != (h, w) or us.shape != (h // 2, w // 2) or \
                vs.shape != us.shape:
            raise ValueError(f"planes {ys.shape}, {us.shape}, {vs.shape} do "
                             f"not match the encoder's {h}x{w}")
        key = _I64()
        msg = ctypes.create_string_buffer(_MSG)
        n = self._lib.om4_enc_frame(self._h, _ptr(ys), _ptr(us), _ptr(vs),
                                    ctypes.byref(key), msg, _MSG)
        if n < 0:
            raise ValueError(f"MPEG-4 encoder: {msg.value.decode()}")
        out = ctypes.create_string_buffer(n)
        self._lib.om4_enc_take(self._h, out)
        return out.raw, bool(key.value)

    def recon(self) -> Planes:
        """The last frame as the decoder reconstructs it (Y, U, V)."""
        w, h = self.width, self.height
        y = np.empty((h, w), np.uint8)
        u = np.empty((h // 2, w // 2), np.uint8)
        v = np.empty((h // 2, w // 2), np.uint8)
        self._lib.om4_enc_recon(self._h, _ptr(y), _ptr(u), _ptr(v))
        return y, u, v
