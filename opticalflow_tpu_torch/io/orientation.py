"""The orientation ``cv2.VideoCapture`` gives a video's frames.

OpenCV 5's FFmpeg backend turns every frame by the stream's display matrix
(``CAP_PROP_ORIENTATION_AUTO``, on by default): the angle is
``-av_display_rotation_get(matrix)`` rounded to whole degrees and taken
into 0-359 (``CAP_PROP_ORIENTATION_META``); at 90 it turns the BGR frame
(after swscale's conversion) clockwise, at 180 half round, at 270
counter-clockwise, and at any other angle not at all.  Only 90 and 270
swap ``CAP_PROP_FRAME_WIDTH`` and ``CAP_PROP_FRAME_HEIGHT``.  A mirroring
matrix turns by its angle alone (the flip is not applied).

FFmpeg gives a display matrix to MP4/QuickTime tracks (``tkhd``'s matrix
times ``mvhd``'s) and Matroska tracks (a rectangular ``Projection``'s pose
roll and yaw); AVI, MPEG program and transport streams, NUT, ASF, FLV and
elementary streams carry none.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

__all__ = ["matrix_angle", "projection_matrix", "rotate", "display_size"]


def matrix_angle(m: Optional[Sequence[int]]) -> int:
    """OpenCV's ``CAP_PROP_ORIENTATION_META`` of a display matrix (nine
    integers, 16.16 fixed point but the third column; None: none)."""
    if m is None:
        return 0
    s0 = math.hypot(m[0] / 65536.0, m[3] / 65536.0)
    s1 = math.hypot(m[1] / 65536.0, m[4] / 65536.0)
    if s0 == 0.0 or s1 == 0.0:
        return 0
    theta = -math.degrees(math.atan2(m[1] / 65536.0 / s1, m[0] / 65536.0 / s0))
    angle = -int(round(theta))      # cvRound: to nearest, ties to even
    return angle + 360 if angle < 0 else angle


def projection_matrix(yaw: float, pitch: float, roll: float
                      ) -> Optional[list]:
    """matroskadec.c's mkv_create_display_matrix: a 2-D rectangular
    projection's pose as a display matrix (None where it gives none)."""
    if pitch == 0.0 and yaw == 0.0 and roll == 0.0:
        return None
    if pitch != 0.0 or yaw not in (0.0, 180.0, -180.0) or math.isnan(roll):
        return None
    hflip = yaw != 0.0
    # av_display_rotation_set, then av_display_matrix_flip
    rad = -(roll * (2 * hflip - 1)) * math.pi / 180.0
    c, s = math.cos(rad), math.sin(rad)
    m = [int(c * 65536), int(-s * 65536), 0, int(s * 65536), int(c * 65536),
         0, 0, 0, 1 << 30]
    if hflip:
        m = [v * (-1 if i % 3 == 0 else 1) for i, v in enumerate(m)]
    return m


def rotate(frame: np.ndarray, angle: int) -> np.ndarray:
    """A BGR frame as OpenCV turns it (``cv2.rotate``) at ``angle``."""
    if angle == 90:
        return np.ascontiguousarray(np.rot90(frame, -1))
    if angle == 180:
        return np.ascontiguousarray(frame[::-1, ::-1])
    if angle == 270:
        return np.ascontiguousarray(np.rot90(frame, 1))
    return frame


def display_size(width: int, height: int, angle: int):
    """(``CAP_PROP_FRAME_WIDTH``, ``CAP_PROP_FRAME_HEIGHT``) at ``angle``."""
    return (height, width) if angle in (90, 270) else (width, height)
