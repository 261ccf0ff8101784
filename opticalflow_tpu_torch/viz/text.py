"""Anti-aliased text without OpenCV: ``cv2.putText(FONT_HERSHEY_SIMPLEX,
LINE_AA)`` reproduced bit for bit from a committed glyph atlas.

The overlays label frames with a title chip and a ``p=0.87`` confidence
(``viz/overlay.py``, ``viz/vanishing.py``); the GPU machine has no OpenCV.
``glyphs.npz`` holds, for each (font scale, thickness) the overlays use,
every printable ASCII glyph's coverage mask as OpenCV renders it alone,
white on black, at an integer origin, and each glyph's advance in pixels.
OpenCV places glyph ``i`` of a string at the origin plus the advances of
the glyphs before it, and blends each glyph into the image in turn:
``rint(bg + (colour - bg) * a / 255)`` per channel, ``a`` its coverage.
:func:`put_text` does the same.

The atlas is made by ``tests/test_torch_text.build_atlas`` with OpenCV;
that test rebuilds it and asserts it equals this file, and holds
:func:`put_text` to ``cv2.putText`` on textured backgrounds.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["put_text", "font_key", "ATLAS_PATH", "FONTS"]

ATLAS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "glyphs.npz")
# (font scale, thickness) pairs in the atlas: titles, and the p= label
FONTS = ((0.7, 2), (0.6, 2))
FIRST, LAST = 32, 126          # printable ASCII, space to tilde

_atlas: Dict[Tuple[float, int], Tuple[np.ndarray, np.ndarray, np.ndarray]] \
    = {}


def font_key(scale: float, thickness: int) -> str:
    return f"{scale:g}_{thickness}"


def _font(scale: float, thickness: int):
    """(masks (95, gh, gw) uint8, origin (oy, ox) in a mask, advances)."""
    key = (float(scale), int(thickness))
    if key not in _atlas:
        if key not in FONTS:
            raise ValueError(f"no glyphs for font scale {scale} thickness "
                             f"{thickness}; the atlas holds {FONTS}")
        k = font_key(*key)
        with np.load(ATLAS_PATH) as z:
            _atlas[key] = (z[f"masks_{k}"], z[f"origin_{k}"],
                           z[f"advance_{k}"])
    return _atlas[key]


def _codes(text: str) -> np.ndarray:
    codes = np.array([ord(c) for c in text], np.int64)
    if codes.size and (codes.min() < FIRST or codes.max() > LAST):
        raise ValueError(f"put_text draws printable ASCII only, got {text!r}")
    return codes - FIRST


def put_text(img: np.ndarray, text: str, org: Tuple[int, int],
             scale: float, color: Sequence[int],
             thickness: int = 2) -> np.ndarray:
    """Draw ``text`` with its baseline's left end at ``org`` = (x, y) into
    the (H, W, C) uint8 ``img`` in place, as ``cv2.putText(img, text, org,
    cv2.FONT_HERSHEY_SIMPLEX, scale, color, thickness, cv2.LINE_AA)``;
    returns ``img``."""
    masks, origin, advance = _font(scale, thickness)
    h, w = img.shape[:2]
    gh, gw = masks.shape[1:]
    col = np.asarray(color, np.float64)[:img.shape[2]]
    x = int(org[0])
    for c in _codes(text):
        y0, x0 = int(org[1]) - int(origin[0]), x - int(origin[1])
        x += int(advance[c])
        ys, xs = max(y0, 0), max(x0, 0)
        ye, xe = min(y0 + gh, h), min(x0 + gw, w)
        if ys >= ye or xs >= xe:
            continue
        a = masks[c, ys - y0:ye - y0, xs - x0:xe - x0].astype(np.float64)
        bg = img[ys:ye, xs:xe].astype(np.float64)
        img[ys:ye, xs:xe] = np.rint(bg + (col - bg) * a[..., None] / 255.0)
    return img
