"""ctypes binding of the port's host C++ drawing and colouring code.

``flowviz.cpp`` is compiled with ``g++ -O3`` at first use into
``opticalflow_tpu_torch/_build/`` by ``runtime/_native.py``.  A failed
build raises with the compiler's output: the overlays have no second
implementation to fall back to on a machine without OpenCV.  The numpy
functions of ``viz/colorwheel.py`` and ``io/images.resize_bilinear_f32``
stay as the plain versions the tests hold these against.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load

__all__ = ["load", "flow_to_color_native", "flow_max_rad",
           "resize_flow_native", "draw_segments_native",
           "draw_thick_segments_native", "draw_circle_native",
           "warp_perspective_native"]

_SRC = Path(__file__).resolve().parent / "flowviz.cpp"
# no -march=native and no contraction into FMAs: the colour wheel's double
# arithmetic then rounds as numpy's does
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_U8 = ctypes.c_uint8


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the video overlays")
        lib.ofv_flow_max_rad.restype = ctypes.c_double
        lib.ofv_flow_max_rad.argtypes = [_F32P, _I64]
        lib.ofv_flow_to_color.restype = None
        lib.ofv_flow_to_color.argtypes = [_F32P, _I64, _I64, ctypes.c_double,
                                          _U8P]
        lib.ofv_resize_flow_bilinear.restype = None
        lib.ofv_resize_flow_bilinear.argtypes = [_F32P, _I64, _I64, _I64,
                                                 _I64, _F32P]
        lib.ofv_draw_segments.restype = None
        lib.ofv_draw_segments.argtypes = [_U8P, _I64, _I64, _I32P, _I64,
                                          _U8, _U8, _U8]
        lib.ofv_draw_thick_segments.restype = None
        lib.ofv_draw_thick_segments.argtypes = [_U8P, _I64, _I64, _I32P, _I64,
                                                _U8, _U8, _U8, ctypes.c_int]
        lib.ofv_draw_circle.restype = None
        lib.ofv_draw_circle.argtypes = [_U8P, _I64, _I64, _I64, _I64, _I64,
                                        _U8, _U8, _U8, ctypes.c_int]
        lib.ofv_warp_perspective_linear.restype = None
        lib.ofv_warp_perspective_linear.argtypes = [
            _U8P, _I64, _I64, _I64, ctypes.POINTER(ctypes.c_double), _I64,
            _U8P]
        _lib = lib
        return lib


def _image(img: np.ndarray) -> np.ndarray:
    if (img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3
            or not img.flags.c_contiguous):
        raise ValueError("draw into a C-contiguous (H, W, 3) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    return img


def flow_max_rad(flow: np.ndarray) -> float:
    flow = np.ascontiguousarray(flow, np.float32)
    return load().ofv_flow_max_rad(flow.ctypes.data_as(_F32P),
                                   flow.shape[0] * flow.shape[1])


def flow_to_color_native(flow: np.ndarray,
                         max_rad: float = 0.0) -> np.ndarray:
    """(H, W, 2) f32 → (H, W, 3) u8 RGB Middlebury colours in one pass
    (``viz.colorwheel.flow_to_color`` is its plain version); ``max_rad``
    ≤ 0 normalises by this frame's own largest vector."""
    lib = load()
    flow = np.ascontiguousarray(flow, np.float32)
    h, w = flow.shape[:2]
    out = np.empty((h, w, 3), np.uint8)
    lib.ofv_flow_to_color(flow.ctypes.data_as(_F32P), h, w, float(max_rad),
                          out.ctypes.data_as(_U8P))
    return out


def resize_flow_native(flow: np.ndarray, height: int,
                       width: int) -> np.ndarray:
    """Half-pixel bilinear flow resize + vector rescale, as
    ``viz.overlay.resize_flow_np`` computes it."""
    lib = load()
    flow = np.ascontiguousarray(flow, np.float32)
    h, w = flow.shape[:2]
    out = np.empty((height, width, 2), np.float32)
    lib.ofv_resize_flow_bilinear(flow.ctypes.data_as(_F32P), h, w, height,
                                 width, out.ctypes.data_as(_F32P))
    return out


def _segments(segs: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(segs).reshape(-1, 4), np.int32)


def draw_segments_native(img: np.ndarray, segs: np.ndarray,
                         bgr: Sequence[int]) -> None:
    """Draw (N, 2, 2) or (N, 4) ``[x1 y1 x2 y2]`` segments into a
    contiguous (H, W, 3) u8 image in place: thickness 1, 8-connected,
    the pixels of ``cv2.line`` (rect clipping included)."""
    _image(img)
    segs = _segments(segs)
    h, w = img.shape[:2]
    load().ofv_draw_segments(img.ctypes.data_as(_U8P), h, w,
                             segs.ctypes.data_as(_I32P), segs.shape[0],
                             int(bgr[0]), int(bgr[1]), int(bgr[2]))


def draw_thick_segments_native(img: np.ndarray, segs: np.ndarray,
                               bgr: Sequence[int], thickness: int) -> None:
    """The same at ``thickness`` ≥ 2, with round caps: the pixels of
    ``cv2.line(img, p1, p2, bgr, thickness)`` per segment."""
    if thickness < 2:
        raise ValueError(f"thickness must be >= 2, got {thickness}")
    _image(img)
    segs = _segments(segs)
    h, w = img.shape[:2]
    load().ofv_draw_thick_segments(img.ctypes.data_as(_U8P), h, w,
                                   segs.ctypes.data_as(_I32P), segs.shape[0],
                                   int(bgr[0]), int(bgr[1]), int(bgr[2]),
                                   int(thickness))


def draw_circle_native(img: np.ndarray, center, radius: int,
                       bgr: Sequence[int], thickness: int = 1) -> None:
    """``cv2.circle(img, center, radius, bgr, thickness)`` (LINE_8) in
    place; a negative ``thickness`` fills."""
    _image(img)
    h, w = img.shape[:2]
    load().ofv_draw_circle(img.ctypes.data_as(_U8P), h, w, int(center[0]),
                           int(center[1]), int(radius), int(bgr[0]),
                           int(bgr[1]), int(bgr[2]), int(thickness))


def warp_perspective_native(frame: np.ndarray, minv: np.ndarray,
                            simd_cols: int) -> np.ndarray:
    """``cv2.warpPerspective`` (INTER_LINEAR, zero border) of a uint8
    (H, W[, C]) frame, given the inverse matrix ``minv`` (3×3 double)
    and the width of OpenCV's vector loop (see ``viz/topview.py``)."""
    lib = load()
    src = np.ascontiguousarray(frame, np.uint8)
    h, w = src.shape[:2]
    c = 1 if src.ndim == 2 else src.shape[2]
    m = np.ascontiguousarray(minv, np.float64).reshape(9)
    out = np.empty_like(src)
    lib.ofv_warp_perspective_linear(
        src.ctypes.data_as(_U8P), h, w, c,
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), int(simd_cols),
        out.ctypes.data_as(_U8P))
    return out
