"""ctypes binding of the port's DIS optical flow (``dis.cpp``).

``dis.cpp`` computes ``cv2.DISOpticalFlow_create(
cv2.DISOPTICAL_FLOW_PRESET_MEDIUM).calc(g1, g2, None)`` as OpenCV 5.0 does,
rebuilt against it stage by stage, for the ``dis`` baseline of
``extract_video --mode compare`` on a machine without OpenCV.  It runs on
the host: the patches' spatial propagation is sequential in scan order.
The library is built with ``g++`` at first use into
``opticalflow_tpu_torch/_build/`` by ``runtime/_native.py``; a failed build
raises with the compiler's output, and nothing falls back to OpenCV.  A
call releases the GIL (a ``ctypes.CDLL`` call does).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from opticalflow_tpu_torch.runtime._native import build_and_load

__all__ = ["dis_flow", "variational_refinement", "resize_area", "load",
           "MEDIUM"]

_SRC = Path(__file__).resolve().parent / "dis.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
          "-ffp-contract=off")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)
_MSG = 512

# cv2.DISOPTICAL_FLOW_PRESET_MEDIUM as OpenCV 5.0 reports it (its
# getters; the coarsest scale follows from the image size, patch means are
# normalised); epsilon is the variational refinement's, which DIS sets
MEDIUM = dict(finest_scale=1, patch_size=8, patch_stride=3,
              grad_descent_iter=25, var_iter=5, spatial_prop=True,
              alpha=20.0, delta=5.0, gamma=10.0, epsilon=0.01)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, _FLAGS, "the DIS optical flow")
        lib.odis_flow.restype = ctypes.c_int
        lib.odis_flow.argtypes = [_U8P, _U8P, ctypes.c_int, ctypes.c_int,
                                  _I32P, _F32P, _F32P, ctypes.c_char_p,
                                  ctypes.c_int64]
        lib.odis_variational_refinement.restype = ctypes.c_int
        lib.odis_variational_refinement.argtypes = [
            _U8P, _U8P, ctypes.c_int, ctypes.c_int, _I32P, _F32P,
            ctypes.c_int, _F32P, _F32P]
        lib.odis_resize_area.restype = ctypes.c_int
        lib.odis_resize_area.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                         _U8P, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _grey(g: np.ndarray, what: str) -> np.ndarray:
    g = np.asarray(g)
    if g.ndim != 2 or g.dtype != np.uint8:
        raise ValueError(f"{what} must be a grey (H, W) uint8 image, got "
                         f"{g.dtype} {g.shape}")
    return np.ascontiguousarray(g)


def _params(**overrides):
    p = {**MEDIUM, **overrides}
    ints = np.array([p["finest_scale"], p["patch_size"], p["patch_stride"],
                     p["grad_descent_iter"], p["var_iter"],
                     int(p["spatial_prop"])], np.int32)
    floats = np.array([p["alpha"], p["delta"], p["gamma"], p["epsilon"]],
                      np.float32)
    return ints, floats


def dis_flow(g1: np.ndarray, g2: np.ndarray, *, var_iter: int = 5,
             spatial_prop: bool = True) -> np.ndarray:
    """Dense flow from grey uint8 ``g1`` to ``g2``: (H, W, 2) float32.
    ``var_iter=0`` (no variational refinement) and ``spatial_prop=False``
    are OpenCV's setters of the same stages, for holding the others
    against it alone."""
    g1, g2 = _grey(g1, "g1"), _grey(g2, "g2")
    if g1.shape != g2.shape:
        raise ValueError(f"dis_flow needs two images of one size, got "
                         f"{g1.shape} and {g2.shape}")
    ints, floats = _params(var_iter=var_iter, spatial_prop=spatial_prop)
    lib = load()
    h, w = g1.shape
    out = np.empty((h, w, 2), np.float32)
    msg = ctypes.create_string_buffer(_MSG)
    rc = lib.odis_flow(_ptr(g1, _U8P), _ptr(g2, _U8P), h, w,
                       _ptr(ints, _I32P), _ptr(floats, _F32P),
                       _ptr(out, _F32P), msg, _MSG)
    if rc:
        raise ValueError(f"DIS flow of a {h}x{w} pair: "
                         f"{msg.value.decode(errors='replace')}")
    return out


def variational_refinement(g1: np.ndarray, g2: np.ndarray, u: np.ndarray,
                           v: np.ndarray, *, iterations: int,
                           sor_iterations: int, epsilon: float):
    """``cv2.VariationalRefinement`` with these settings and DIS's α, δ, γ
    (its defaults) and ω = 1.6, its ``calcUV``: the refined (u, v) as new
    float32 arrays (DIS's last stage)."""
    g1, g2 = _grey(g1, "g1"), _grey(g2, "g2")
    if g1.shape != g2.shape or np.shape(u) != g1.shape or \
            np.shape(v) != g1.shape:
        raise ValueError("variational_refinement needs images and flows of "
                         "one size")
    ints, floats = _params(var_iter=iterations, epsilon=epsilon)
    u = np.array(u, np.float32, order="C")
    v = np.array(v, np.float32, order="C")
    h, w = g1.shape
    load().odis_variational_refinement(
        _ptr(g1, _U8P), _ptr(g2, _U8P), h, w, _ptr(ints, _I32P),
        _ptr(floats, _F32P), sor_iterations, _ptr(u, _F32P), _ptr(v, _F32P))
    return u, v


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)``
    of a grey uint8 image, shrinking (DIS's pyramid)."""
    img = _grey(img, "img")
    if height > img.shape[0] or width > img.shape[1]:
        raise ValueError("resize_area only shrinks")
    out = np.empty((height, width), np.uint8)
    load().odis_resize_area(_ptr(img, _U8P), img.shape[0], img.shape[1],
                            _ptr(out, _U8P), height, width)
    return out
