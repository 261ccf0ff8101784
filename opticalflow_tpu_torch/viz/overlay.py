"""Arrow / quiver overlays for video output, without OpenCV.

The port's counterpart of ``opticalflow_tpu.viz.overlay``, drawing the
same pixels on a machine that has no OpenCV:

  * :func:`arrow_overlay` — arrows on a regular grid with magnitude gating
    and an optional title chip (``pwc_extract_flow_video.py:94-142``); the
    arrows through ``runtime/flowviz`` (cv2's rasteriser in C++), the chip
    through :func:`fill_rect` and ``viz/text.put_text`` (a glyph atlas);
  * :func:`side_by_side` — horizontal concat for comparison videos;
  * :func:`opencv_flow` — the classical baselines of the comparison mode
    (``pwc_extract_flow_video.py:49-92``), OpenCV's Farneback, DIS-medium
    and "dense LK" (Farneback under other parameters), computed without
    OpenCV: the grey conversion by ``io/yuv.bgr_to_gray``, Farneback as
    torch ops on the caller's device (``viz/farneback.py``), DIS in host
    C++ (``runtime/dis.cpp``), each rebuilt against OpenCV 5.0;
  * :func:`quiver_figure` — the matplotlib quiver figure of the single-pair
    extractor, where matplotlib is installed (imported when called).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from opticalflow_tpu_torch.io.images import resize_bilinear_f32
from opticalflow_tpu_torch.io.yuv import bgr_to_gray
from opticalflow_tpu_torch.runtime import dis, flowviz
from opticalflow_tpu_torch.viz.farneback import (FARNEBACK_PARAMS,
                                                 farneback_flow)
from opticalflow_tpu_torch.viz.text import put_text

__all__ = ["arrow_overlay", "draw_arrows_batch", "draw_title", "fill_rect",
           "opencv_flow", "side_by_side", "quiver_figure", "resize_flow_np",
           "ARROW_COLORS"]

# BGR triples, keyed like the reference's color_map
ARROW_COLORS = {
    "red": (0, 0, 255),
    "lime": (0, 255, 0),
    "blue": (255, 0, 0),
    "white": (255, 255, 255),
    "yellow": (0, 255, 255),
}


def resize_flow_np(flow: np.ndarray, height: int, width: int) -> np.ndarray:
    """Host bilinear flow resize with the vector rescale ``u·width/w``,
    ``v·height/h``: each channel alone through
    ``io.images.resize_bilinear_f32``, bit-exact to the JAX package's
    per-channel ``cv2.resize``."""
    hf, wf = flow.shape[:2]
    if (hf, wf) == (height, width):
        return flow
    flow = np.asarray(flow, np.float32)
    u = resize_bilinear_f32(flow[..., 0], height, width)
    v = resize_bilinear_f32(flow[..., 1], height, width)
    return np.dstack([u * np.float32(width / float(wf)),
                      v * np.float32(height / float(hf))])


def fill_rect(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int],
              bgr) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, bgr, -1)``: the corners inclusive,
    clipped to the image; in place."""
    h, w = img.shape[:2]
    x1, x2 = sorted((int(pt1[0]), int(pt2[0])))
    y1, y2 = sorted((int(pt1[1]), int(pt2[1])))
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, w - 1), min(y2, h - 1)
    if x1 <= x2 and y1 <= y2:
        img[y1:y2 + 1, x1:x2 + 1] = bgr
    return img


def draw_title(img: np.ndarray, title: str) -> np.ndarray:
    """The reference's title chip: a black box at (10, 10) sized 12 px a
    character, white text at (14, 35), font scale 0.7; in place."""
    fill_rect(img, (10, 10), (10 + len(title) * 12, 40), (0, 0, 0))
    return put_text(img, title, (14, 35), 0.7, (255, 255, 255), 2)


def draw_arrows_batch(img: np.ndarray, p0: np.ndarray, p1: np.ndarray,
                      bgr: Tuple[int, int, int], *, thickness: int = 1,
                      tip_length: float = 0.3) -> None:
    """Draw N arrows, pixel-identical to N ``cv2.arrowedLine`` calls (each
    is three lines: the shaft and two tips at ±45° of tip_length·|p0-p1|,
    ``np.rint`` matching cvRound).  ``p0``/``p1`` are (N, 2) integer-valued
    endpoint arrays.  In place on ``img``."""
    if len(p0) == 0:
        return
    d = p0.astype(np.float64) - p1.astype(np.float64)  # pt1 - pt2
    tip = np.hypot(d[:, 0], d[:, 1]) * tip_length
    ang = np.arctan2(d[:, 1], d[:, 0])
    pl = np.stack([np.rint(p1[:, 0] + tip * np.cos(ang + np.pi / 4)),
                   np.rint(p1[:, 1] + tip * np.sin(ang + np.pi / 4))], axis=1)
    pr = np.stack([np.rint(p1[:, 0] + tip * np.cos(ang - np.pi / 4)),
                   np.rint(p1[:, 1] + tip * np.sin(ang - np.pi / 4))], axis=1)
    segs = np.concatenate([np.stack([p0, p1], axis=1),
                           np.stack([pl, p1], axis=1),
                           np.stack([pr, p1], axis=1)]).astype(np.int32)
    target = img if img.flags.c_contiguous else np.ascontiguousarray(img)
    if thickness == 1:
        flowviz.draw_segments_native(target, segs, bgr)
    else:
        flowviz.draw_thick_segments_native(target, segs, bgr, thickness)
    if target is not img:
        img[...] = target


def _grid_vectors(flow: np.ndarray, h: int, w: int, step: int,
                  grid_step: Optional[int]):
    """(x, y, dx, dy) float64 arrays at every ``step`` full-res pixels.

    ``grid_step`` set means ``flow`` is already grid-sampled on the card at
    that full-res spacing (vectors in full-res pixel units): the streaming
    runner's decimated readback.  ``flow[i, j]`` is then the vector at pixel
    ``(j*grid_step, i*grid_step)`` and ``step`` is ignored; rows/cols whose
    anchor falls outside the (unpadded) frame are dropped.
    """
    if grid_step is None:
        flow = resize_flow_np(flow, h, w)
        ys, xs = np.mgrid[0:h:step, 0:w:step]
        u = flow[ys, xs, 0]
        v = flow[ys, xs, 1]
    else:
        gh = min(flow.shape[0], -(-h // grid_step))
        gw = min(flow.shape[1], -(-w // grid_step))
        u = flow[:gh, :gw, 0]
        v = flow[:gh, :gw, 1]
        ys, xs = np.mgrid[0:gh * grid_step:grid_step,
                          0:gw * grid_step:grid_step]
    return (xs.ravel().astype(np.float64), ys.ravel().astype(np.float64),
            u.ravel().astype(np.float64), v.ravel().astype(np.float64))


def arrow_overlay(frame_bgr: np.ndarray, flow: np.ndarray, *, step: int = 16,
                  scale: float = 1.0, min_mag: float = 0.5,
                  title: Optional[str] = None,
                  color: str | Tuple[int, int, int] = "red",
                  grid_step: Optional[int] = None) -> np.ndarray:
    """Draw flow arrows on a BGR frame every ``step`` pixels.

    ``scale`` shortens arrows as it grows (drawn length = |flow|/scale),
    vectors below ``min_mag`` are skipped, as the reference's defaults
    (``pwc_extract_flow_video.py:94-142``).  ``grid_step``: see
    :func:`_grid_vectors` (flow decimated on the card).
    """
    h, w = frame_bgr.shape[:2]
    out = frame_bgr.copy()
    bgr = ARROW_COLORS.get(color, color if isinstance(color, tuple)
                           else (0, 0, 255))
    inv = 1.0 / max(scale, 1e-6)
    x, y, dx, dy = _grid_vectors(flow, h, w, step, grid_step)
    keep = dx * dx + dy * dy >= min_mag * min_mag
    x, y, dx, dy = x[keep], y[keep], dx[keep], dy[keep]
    p0 = np.stack([x, y], axis=1)
    p1 = np.stack([np.rint(x + dx * inv), np.rint(y + dy * inv)], axis=1)
    draw_arrows_batch(out, p0, p1, bgr)
    if title:
        draw_title(out, title)
    return out


def opencv_flow(frame1_bgr: np.ndarray, frame2_bgr: np.ndarray,
                method: str = "farneback", *,
                device: Union[str, torch.device, None] = None) -> np.ndarray:
    """Classical flow baselines for side-by-side comparison: the (H, W, 2)
    float32 flow of OpenCV's ``farneback``, ``dis`` (DIS-medium) or
    ``lucaskanade_dense`` from ``frame1_bgr`` to ``frame2_bgr``, as the
    JAX package computes them with OpenCV.  Farneback runs on ``device``
    (the card unless the CPU is asked for; a failure there raises), DIS
    on the host."""
    if method != "dis" and method not in FARNEBACK_PARAMS:
        raise ValueError(f"unknown OpenCV flow method {method!r}")
    g1, g2 = bgr_to_gray(frame1_bgr), bgr_to_gray(frame2_bgr)
    if method == "dis":
        return dis.dis_flow(g1, g2)
    pyr_scale, levels, winsize, iterations, poly_n, poly_sigma = (
        FARNEBACK_PARAMS[method])
    return farneback_flow(g1, g2, pyr_scale=pyr_scale, levels=levels,
                          winsize=winsize, iterations=iterations,
                          poly_n=poly_n, poly_sigma=poly_sigma, device=device)


def side_by_side(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Horizontal concat (heights must match)."""
    return np.concatenate([left, right], axis=1)


def quiver_figure(image_rgb: np.ndarray, flow: np.ndarray, out_path: str, *,
                  step: int = 16, scale: float = 1.0,
                  title: str = "PWC-Net flow") -> None:
    """Matplotlib quiver overlay saved to file (the single-pair extractor's
    ``save_quiver_overlay``, ``pwc_extract_flow.py:193-233``).  Raises
    ImportError, saying so, where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        raise ImportError("quiver_figure needs matplotlib, which is not "
                          "installed") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    h, w = image_rgb.shape[:2]
    ys, xs = np.mgrid[0:h:step, 0:w:step]
    u = flow[ys, xs, 0]
    v = flow[ys, xs, 1]
    fig, ax = plt.subplots(figsize=(w / 100.0, h / 100.0), dpi=100)
    ax.imshow(image_rgb)
    ax.quiver(xs, ys, u, v, color="red", angles="xy", scale_units="xy",
              scale=scale)
    ax.set_title(title)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
