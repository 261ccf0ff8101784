"""Image loading + geometry helpers for the /64-constrained PWC pipeline.

The port's own copy of ``opticalflow_tpu.io.images`` (numpy only; the port
imports nothing of the JAX package).  The architecture has six stride-2
levels, so inputs must be multiples of 64.  Two strategies, as in the
reference:

  * :func:`resize_to_multiple_of_64` — distorting bilinear resize (canonical
    CLI, ``script_pwc.py:47-54``; flow vectors rescaled back after);
  * :func:`pad_to_multiple_of_64` / :func:`unpad` — replicate pad bottom/right
    (``inference_kitti.py:53-71``).

:func:`load_image` decodes 8-bit non-interlaced grey/RGB/RGBA PNG itself
(stdlib ``zlib`` + numpy), so the single-pair path needs neither imageio,
PIL nor cv2; other formats go through imageio or PIL, imported lazily.
"""

from __future__ import annotations

import struct
import zlib
from math import ceil
from typing import Tuple

import numpy as np

__all__ = ["load_image", "decode_png", "resize_to_multiple_of_64",
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
    """Decode an 8-bit, non-interlaced grey/RGB/RGBA PNG → uint8 array of
    shape (H, W) or (H, W, C).  Returns None for any other PNG flavour (or
    non-PNG bytes), so the caller can hand the file to a full decoder."""
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
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        return None
    ch = _PNG_CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, ch)


def load_image(path: str) -> np.ndarray:
    """Read an image file → (H, W, 3) uint8 RGB (alpha dropped, grey
    replicated, like ``script_pwc.py:43-44``)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img is None:
        try:
            import imageio.v2 as imageio
            img = np.asarray(imageio.imread(path))
        except ImportError:
            from PIL import Image
            img = np.asarray(Image.open(path).convert("RGB"))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def resize_to_multiple_of_64(img: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """cv2-bilinear resize up to ceil(/64)*64 (``script_pwc.py:47-54``).

    /64-sized frames return early without importing cv2.
    Returns (resized, H_orig, W_orig)."""
    h, w = img.shape[:2]
    h64 = int(ceil(h / 64.0) * 64)
    w64 = int(ceil(w / 64.0) * 64)
    if (h64, w64) == (h, w):
        return img, h, w
    import cv2
    return cv2.resize(img, (w64, h64)), h, w


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
