"""Image loading + geometry helpers for the /64-constrained PWC pipeline.

The port's own copy of ``opticalflow_tpu.io.images`` (numpy only; the port
imports nothing of the JAX package).  The architecture has six stride-2
levels, so inputs must be multiples of 64.  Two strategies, as in the
reference:

  * :func:`resize_to_multiple_of_64` — distorting bilinear resize (canonical
    CLI, ``script_pwc.py:47-54``; flow vectors rescaled back after), in
    numpy, bit-exact to the reference's ``cv2.resize``;
  * :func:`pad_to_multiple_of_64` / :func:`unpad` — replicate pad bottom/right
    (``inference_kitti.py:53-71``).

:func:`decode_png` decodes 8- and 16-bit non-interlaced grey/RGB/RGBA PNG
itself (stdlib ``zlib`` + numpy), so the single-pair path and the KITTI
flow files (16-bit RGB, ``io/kitti.py``) need neither imageio, PIL nor
OpenCV; :func:`load_image` hands other formats to imageio or PIL, imported
lazily.
"""

from __future__ import annotations

import struct
import zlib
from math import ceil
from typing import Tuple

import numpy as np

__all__ = ["load_image", "decode_png", "encode_png", "preprocess_pair",
           "resize_bilinear_u8", "resize_bilinear_f32", "resize_nearest",
           "resize_to_multiple_of_64",
           "pad_to_multiple_of_64", "unpad", "PREPROC_PRESETS",
           "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

PREPROC_PRESETS = ("bgr_unit", "rgb_imagenet", "rgb_unit")

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel, for the types decode_png handles
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (PNG spec §9) → (h, stride) uint8."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG image data too short: {len(raw)} bytes for "
                         f"{h} rows of {stride}")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += stride + 1
        if ftype == 1:      # Sub: running sum per channel, mod 256
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            row += prev
        elif ftype in (3, 4):
            # Average / Paeth depend on the reconstructed left byte: a
            # sequential loop over the row
            r = bytearray(row.tobytes())
            p = prev.tobytes()
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                b = p[i]
                if ftype == 3:
                    r[i] = (r[i] + ((a + b) >> 1)) & 255
                else:
                    c = p[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                    r[i] = (r[i] + pred) & 255
            row = np.frombuffer(bytes(r), np.uint8)
        elif ftype != 0:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = row
        prev = out[y]
    return out


def decode_png(data: bytes):
    """Decode an 8- or 16-bit, non-interlaced grey/RGB/RGBA PNG → uint8 or
    uint16 array of shape (H, W) or (H, W, C).  Returns None for any other
    PNG flavour (or non-PNG bytes), so the caller can hand the file to a
    full decoder."""
    if not data.startswith(_PNG_SIG):
        return None
    pos = len(_PNG_SIG)
    header = None
    idat = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk " + ctype.decode("latin1"))
        pos += 12 + length          # length, type, body, CRC
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth not in (8, 16) or interlace != 0 or color not in _PNG_CHANNELS:
        return None
    ch = _PNG_CHANNELS[color]
    nb = depth // 8                 # bytes per sample
    # the filters work on bytes, a pixel's worth apart: 2·C for 16 bits
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch * nb, ch * nb)
    if nb == 2:                     # big-endian samples
        px = px.view(">u2").astype(np.uint16)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, ch)


def encode_png(img: np.ndarray) -> bytes:
    """Encode a uint8 or uint16 (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA
    array as a non-interlaced PNG (filter 0 on every row, one zlib stream):
    what :func:`decode_png` reads back bit for bit."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"encode_png takes uint8 or uint16, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    colour = {1: 0, 3: 2, 4: 6}.get(ch)
    if colour is None or img.ndim not in (2, 3):
        raise ValueError(f"encode_png takes (H, W), (H, W, 3) or (H, W, 4), "
                         f"got {img.shape}")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    samples = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">")))
    rows = np.zeros((h, 1 + w * ch * img.dtype.itemsize), np.uint8)
    rows[:, 1:] = samples.view(np.uint8).reshape(h, -1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def load_image(path: str) -> np.ndarray:
    """Read an image file → (H, W, 3) uint8 RGB (alpha dropped, grey
    replicated, like ``script_pwc.py:43-44``; a 16-bit PNG keeps the high
    byte of each sample)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img is not None and img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img is None:
        try:
            import imageio.v2 as imageio
            img = np.asarray(imageio.imread(path))
        except ImportError:
            try:
                from PIL import Image
            except ImportError:
                raise ImportError(
                    f"{path!r} is not a PNG that decode_png reads, and "
                    "neither imageio nor PIL is installed to decode it") \
                    from None
            img = np.asarray(Image.open(path).convert("RGB"))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def preprocess_pair(im1: np.ndarray, im2: np.ndarray,
                    preset: str = "bgr_unit") -> np.ndarray:
    """uint8 RGB pair → (1, H, W, 6) float32 network input.

    ``bgr_unit`` reproduces the canonical CLI preprocessing exactly
    (``script_pwc.py:56-58``: RGB→BGR flip then /255, nothing else);
    ``rgb_unit`` is RGB /255; ``rgb_imagenet`` is RGB /255 normalised by the
    ImageNet mean and std.
    """
    def one(im):
        im = im.astype(np.float32)
        if preset == "bgr_unit":
            return im[..., ::-1] / 255.0
        if preset == "rgb_unit":
            return im / 255.0
        if preset == "rgb_imagenet":
            return (im / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        raise ValueError(f"unknown preprocessing preset {preset!r}; "
                         f"choose from {PREPROC_PRESETS}")

    x = np.concatenate([one(im1), one(im2)], axis=-1)
    return x[None].astype(np.float32)


_COEF_BITS = 11                 # cv2's INTER_RESIZE_COEF_BITS
_COEF_ONE = np.float32(1 << _COEF_BITS)


def _linear_taps(n_src: int, n_dst: int, float_path: bool = False):
    """Source index and float32 fraction of each destination pixel, with
    cv2's half-pixel rule computed in cv2's types.  Its uint8 path rounds
    the position (taken in double) to float32, then takes floor and
    fraction in float32; its float path (``float_path``) takes floor and
    fraction in double and rounds the fraction to float32."""
    scale = 1.0 / (float(n_dst) / n_src)
    pos = (np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5
    if not float_path:
        pos = pos.astype(np.float32)
    first = np.floor(pos)
    return first.astype(np.int64), (pos - first).astype(np.float32)


def _fixed_weights(frac: np.ndarray):
    """The two 11-bit weights of each tap, rounded half to even as cv2's
    ``saturate_cast<short>`` rounds them."""
    w0 = np.rint((np.float32(1) - frac) * _COEF_ONE).astype(np.int32)
    w1 = np.rint(frac * _COEF_ONE).astype(np.int32)
    return w0, w1


def resize_bilinear_u8(img: np.ndarray, height: int,
                       width: int) -> np.ndarray:
    """uint8 (H, W, C) → (height, width, C), enlarging or shrinking either
    side, bit-exact to ``cv2.resize(img, (width, height))`` (INTER_LINEAR),
    in numpy integer arithmetic.

    cv2's fixed-point scheme: 11-bit weights; a horizontal pass into int32
    (``src[x0]·a0 + src[x1]·a1``), where a tap left of the first column
    takes column 0 whole and one at or right of the last column takes that
    column whole; then a vertical pass over the two rows, clamped into the
    image with the weights left as they are,
    ``(((b0·(r0>>4))>>16) + ((b1·(r1>>4))>>16) + 2) >> 2``.  The same
    formula holds when a side shrinks.  At exactly half size on both sides
    cv2 averages 2×2 blocks instead, ``(a + b + c + d + 2) >> 2``, which is
    what this formula gives there: every tap falls halfway between two
    pixels, with weights (1024, 1024)."""
    h, w, c = img.shape
    src = img.reshape(h, w * c).astype(np.int32)
    if width == w:
        # every tap lands on its own column with weights (2048, 0), so the
        # horizontal pass is src·2048, and >>4 of that is src·128 (Sintel's
        # 1024 columns stay as they are)
        rows = src << 7
    else:
        sx, fx = _linear_taps(w, width)
        edge = (sx < 0) | (sx >= w - 1)
        fx = np.where(edge, np.float32(0), fx)
        sx = np.clip(sx, 0, w - 1)
        a0, a1 = _fixed_weights(fx)
        # flat (row, x·C + channel) indices, so each pass is one np.take
        ch = np.arange(c)
        i0 = (sx[:, None] * c + ch).ravel()
        i1 = (np.minimum(sx + 1, w - 1)[:, None] * c + ch).ravel()
        rows = np.take(src, i0, axis=1)
        rows *= np.repeat(a0, c)
        t = np.take(src, i1, axis=1)
        t *= np.repeat(a1, c)
        rows += t
        rows >>= 4

    sy, fy = _linear_taps(h, height)
    b0, b1 = _fixed_weights(fy)
    out = np.take(rows, np.clip(sy, 0, h - 1), axis=0)
    out *= b0[:, None]
    out >>= 16
    t = np.take(rows, np.clip(sy + 1, 0, h - 1), axis=0)
    t *= b1[:, None]
    t >>= 16
    out += t
    out += 2
    out >>= 2
    return out.astype(np.uint8).reshape(height, width, c)


def resize_bilinear_f32(img: np.ndarray, height: int,
                        width: int) -> np.ndarray:
    """float32 (H, W[, C]) → (height, width[, C]), bilinear with the
    half-pixel rule, as ``cv2.resize``'s float INTER_LINEAR computes it:
    float32 weights ``1 - f, f``; along a row a tap left of the first
    column or at or right of the last takes that column whole; down the
    columns the two rows are clamped into the image with the weights left
    as they are."""
    h, w = img.shape[:2]
    x = img.astype(np.float32, copy=False).reshape(h, w, -1)
    if width != w:
        sx, fx = _linear_taps(w, width, float_path=True)
        edge = (sx < 0) | (sx >= w - 1)
        fx = np.where(edge, np.float32(0), fx)[None, :, None]
        sx = np.clip(sx, 0, w - 1)
        x = (x[:, sx] * (np.float32(1) - fx)
             + x[:, np.minimum(sx + 1, w - 1)] * fx)
    if height != h:
        sy, fy = _linear_taps(h, height, float_path=True)
        fy = fy[:, None, None]
        x = (x[np.clip(sy, 0, h - 1)] * (np.float32(1) - fy)
             + x[np.clip(sy + 1, 0, h - 1)] * fy)
    return x.reshape((height, width) + img.shape[2:])


def _nearest_index(n_src: int, n_dst: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index: floor(i · (1 / (dst / src))) in
    double, clamped to the last pixel (not the half-pixel rule)."""
    scale = 1.0 / (float(n_dst) / n_src)
    idx = np.floor(np.arange(n_dst, dtype=np.float64) * scale)
    return np.minimum(idx.astype(np.int64), n_src - 1)


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, ...) → (height, width, ...) as ``cv2.resize``'s
    INTER_NEAREST picks its pixels."""
    h, w = img.shape[:2]
    return img[_nearest_index(h, height)][:, _nearest_index(w, width)]


def resize_to_multiple_of_64(img: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Bilinear resize up to ceil(/64)*64 (``script_pwc.py:47-54``), the
    reference's ``cv2.resize`` reproduced bit for bit by
    :func:`resize_bilinear_u8` (the target never shrinks a side).

    Returns (resized, H_orig, W_orig)."""
    h, w = img.shape[:2]
    h64 = int(ceil(h / 64.0) * 64)
    w64 = int(ceil(w / 64.0) * 64)
    if (h64, w64) == (h, w):
        return img, h, w
    return resize_bilinear_u8(img, h64, w64), h, w


def pad_to_multiple_of_64(img: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Replicate-pad bottom/right to /64 (``inference_kitti.py:53-63``).

    img: (..., H, W, C).  Returns (padded, pad_h, pad_w)."""
    h, w = img.shape[-3], img.shape[-2]
    pad_h = (64 - h % 64) % 64
    pad_w = (64 - w % 64) % 64
    if pad_h or pad_w:
        pads = [(0, 0)] * (img.ndim - 3) + [(0, pad_h), (0, pad_w), (0, 0)]
        img = np.pad(img, pads, mode="edge")
    return img, pad_h, pad_w


def unpad(x: np.ndarray, pad_h: int, pad_w: int) -> np.ndarray:
    """Strip bottom/right padding from (..., H, W, C)."""
    if pad_h:
        x = x[..., :-pad_h, :, :]
    if pad_w:
        x = x[..., :, :-pad_w, :]
    return x
