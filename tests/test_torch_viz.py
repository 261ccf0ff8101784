"""The port's visualisation (``viz/``, ``runtime/flowviz``) against OpenCV
and the JAX package on the same inputs.

Tolerances: the rasterisers (lines of thickness 1-3, circles, filled
rectangles), the colour wheel, the overlays and the perspective warp are
bit-exact; the native colour wheel is held to the numpy one as the JAX
package's test holds its own (off by one level on <2% of the values); the
perspective matrix to 1e-9; the five visual goldens to
``tests/test_goldens._check``'s 1% of pixels.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import os
import re

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from opticalflow_tpu.runtime import flowviz as jflowviz  # noqa: E402
from opticalflow_tpu.viz import colorwheel as jcw  # noqa: E402
from opticalflow_tpu.viz import overlay as jov  # noqa: E402
from opticalflow_tpu.viz import topview as jtv  # noqa: E402
from opticalflow_tpu.viz import vanishing as jvp  # noqa: E402
from opticalflow_tpu_torch.io.images import decode_png, fma32  # noqa: E402
from opticalflow_tpu_torch.runtime import flowviz  # noqa: E402
from opticalflow_tpu_torch.viz import colorwheel as cw  # noqa: E402
from opticalflow_tpu_torch.viz import overlay as ov  # noqa: E402
from opticalflow_tpu_torch.viz import topview as tv  # noqa: E402
from opticalflow_tpu_torch.viz import vanishing as vp  # noqa: E402
from test_goldens import (GOLDEN_DIR, _synthetic_flow,  # noqa: E402
                          _synthetic_frame)


def _rand_flow(h, w, seed=0, mag=6.0):
    rng = np.random.RandomState(seed)
    return ((rng.rand(h, w, 2) - 0.5) * 2 * mag).astype(np.float32)


def _rand_frame(h, w, seed=1):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


# ---------------------------------------------------------------- colours

def test_colorwheel_bit_exact_to_jax():
    np.testing.assert_array_equal(cw.make_colorwheel(),
                                  jcw.make_colorwheel())
    for seed in range(3):
        f = _rand_flow(33, 47, seed, mag=8.0)
        np.testing.assert_array_equal(cw.flow_to_color(f),
                                      jcw.flow_to_color(f))
        np.testing.assert_array_equal(cw.flow_to_color(f, clip_flow=3.0),
                                      jcw.flow_to_color(f, clip_flow=3.0))
        np.testing.assert_array_equal(cw.flow_to_color_hsv(f),
                                      jcw.flow_to_color_hsv(f))


def test_native_flow_to_color_matches_numpy():
    f = (np.random.RandomState(0).randn(33, 47, 2) * 5).astype(np.float32)
    a = flowviz.flow_to_color_native(f)
    diff = np.abs(a.astype(int) - cw.flow_to_color(f).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02
    assert flowviz.flow_max_rad(f) == pytest.approx(
        float(np.sqrt((f ** 2).sum(-1)).max()), rel=1e-6)


def test_flow_resizes_match_jax():
    """``resize_flow_np`` (numpy, cv2's float rules) bit-exact to the JAX
    one (cv2); the native resize within the JAX test's 1e-4."""
    for (h, w), (oh, ow) in (((24, 32), (48, 96)), ((32, 48), (96, 130)),
                             ((30, 40), (17, 23))):
        f = _rand_flow(h, w, h)
        np.testing.assert_array_equal(ov.resize_flow_np(f, oh, ow),
                                      jov.resize_flow_np(f, oh, ow))
        np.testing.assert_allclose(flowviz.resize_flow_native(f, oh, ow),
                                   jov.resize_flow_np(f, oh, ow), atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------- rasters

def _segments(rng, n, h, w, clipped):
    if clipped:
        return rng.randint([-w, -h, -w, -h], [2 * w, 2 * h, 2 * w, 2 * h],
                           size=(n, 4)).astype(np.int32)
    return rng.randint(0, [w, h, w, h], size=(n, 4)).astype(np.int32)


@pytest.mark.parametrize("thickness", [1, 2, 3])
@pytest.mark.parametrize("clipped", [False, True])
def test_segments_bit_exact_to_cv2_line(thickness, clipped):
    rng = np.random.RandomState(10 * thickness + clipped)
    h, w = 61, 83
    for trial in range(150):
        segs = _segments(rng, 4, h, w, clipped)
        if trial % 5 == 0:              # short and degenerate segments
            segs[:, 2:] = segs[:, :2] + rng.randint(-2, 3, size=(4, 2))
        want = np.zeros((h, w, 3), np.uint8)
        for s in segs:
            cv2.line(want, (int(s[0]), int(s[1])), (int(s[2]), int(s[3])),
                     (10, 200, 30), thickness)
        got = np.zeros_like(want)
        if thickness == 1:
            flowviz.draw_segments_native(got, segs, (10, 200, 30))
        else:
            flowviz.draw_thick_segments_native(got, segs, (10, 200, 30),
                                               thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_thick_segments_bit_exact_to_polylines():
    """``cv2.polylines`` over two-point polylines, what the JAX overlays
    call at thickness 2, draws the same pixels."""
    rng = np.random.RandomState(3)
    h, w = 40, 56
    for trial in range(100):
        segs = _segments(rng, 5, h, w, clipped=trial % 2 == 1)
        want = np.zeros((h, w, 3), np.uint8)
        cv2.polylines(want, segs.reshape(-1, 2, 2), False, (255, 9, 1), 2)
        got = np.zeros_like(want)
        flowviz.draw_thick_segments_native(got, segs, (255, 9, 1), 2)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3])
def test_circles_bit_exact_to_cv2(thickness):
    rng = np.random.RandomState(20 + thickness)
    h, w = 50, 70
    for trial in range(200):
        c = (int(rng.randint(-15, w + 15)), int(rng.randint(-15, h + 15)))
        r = int(rng.randint(0, 30))
        want = _rand_frame(h, w, trial)
        got = want.copy()
        cv2.circle(want, c, r, (0, 255, 255), thickness)
        flowviz.draw_circle_native(got, c, r, (0, 255, 255), thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{c} r={r}")


def test_sine_table_is_opencvs():
    """The C++ copy of OpenCV's sine table (which its circles' polygons
    read) against the one cv2.ellipse2Poly reveals: at a radius of 2^30
    every float entry comes back exactly."""
    pts = cv2.ellipse2Poly((0, 0), (1 << 30, 1 << 30), 0, 0, 360, 1)
    table = np.zeros(451)
    for i, (x, y) in enumerate(pts[:361]):
        table[450 - i], table[i] = x / 2 ** 30, y / 2 ** 30
    with open(os.path.join(os.path.dirname(flowviz.__file__),
                           "flowviz.cpp")) as f:
        src = f.read()
    body = src[src.index("kSinTable[451]"):]
    body = body[body.index("{") + 1:body.index("}")]
    ours = np.array([np.float32(v) for v in re.findall(r"-?\d+\.\d+", body)],
                    np.float64)
    np.testing.assert_array_equal(ours, table)


def test_fill_rect_bit_exact_to_cv2():
    rng = np.random.RandomState(5)
    for trial in range(200):
        p1 = tuple(int(v) for v in rng.randint(-20, 80, 2))
        p2 = tuple(int(v) for v in rng.randint(-20, 80, 2))
        want = _rand_frame(40, 60, trial)
        got = want.copy()
        cv2.rectangle(want, p1, p2, (1, 2, 3), -1)
        ov.fill_rect(got, p1, p2, (1, 2, 3))
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2}")


# ---------------------------------------------------------------- overlays

def test_draw_arrows_batch_matches_arrowed_line():
    rng = np.random.RandomState(7)
    p0 = rng.randint(-10, 130, size=(40, 2))
    p1 = p0 + rng.randint(-25, 25, size=(40, 2))
    for thickness in (1, 2):
        want = _rand_frame(128, 128)
        got = want.copy()
        for a, b in zip(p0, p1):
            cv2.arrowedLine(want, tuple(int(v) for v in a),
                            tuple(int(v) for v in b), (0, 255, 0),
                            thickness=thickness, tipLength=0.3)
        ov.draw_arrows_batch(got, p0, p1, (0, 255, 0), thickness=thickness)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("title", [None, "PWC-Net (TPU)"])
@pytest.mark.parametrize("scale,min_mag", [(1.0, 0.5), (2.0, 1.5)])
def test_arrow_overlay_bit_exact_to_jax(title, scale, min_mag):
    frame = _rand_frame(96, 130)
    qflow = _rand_flow(32, 48, seed=3)   # a padded 128x192 quarter field
    got = ov.arrow_overlay(frame, qflow, step=16, scale=scale,
                           min_mag=min_mag, title=title)
    want = jov.arrow_overlay(frame, qflow, step=16, scale=scale,
                             min_mag=min_mag, title=title)
    np.testing.assert_array_equal(got, want)


def test_arrow_overlay_grid_path_bit_exact_to_jax():
    """Flow decimated to the arrow grid (as the runner reads it back):
    the same pixels as the JAX overlay on the same grid, and as the port's
    own full path."""
    from opticalflow_tpu.video import decimate_flow as jdecimate
    h, w, step = 96, 130, 16
    qflow = _rand_flow(32, 48, seed=9)
    frame = _rand_frame(h, w, seed=2)
    grid = np.asarray(jdecimate(qflow[None], step, h, w))[0]
    got = ov.arrow_overlay(frame, grid, step=step, grid_step=step)
    np.testing.assert_array_equal(
        got, jov.arrow_overlay(frame, grid, step=step, grid_step=step))
    np.testing.assert_array_equal(got, ov.arrow_overlay(frame, qflow,
                                                        step=step))


def test_vanishing_point_and_marker_bit_exact_to_jax():
    flow = _synthetic_flow()
    est = vp.estimate_vanishing_point(flow, step=8)
    assert est == jvp.estimate_vanishing_point(flow, step=8)
    frame = _synthetic_frame()
    np.testing.assert_array_equal(vp.draw_vanishing_point(frame, est),
                                  jvp.draw_vanishing_point(frame, est))
    # the marker clipped at the frame's corner
    corner = (1.0, 2.0, 0.5)
    np.testing.assert_array_equal(vp.draw_vanishing_point(frame, corner),
                                  jvp.draw_vanishing_point(frame, corner))


@pytest.mark.parametrize("shrink,title", [(0.75, "VP"), (1.0, None),
                                          (0.6, "PWC-Net VP (TPU)")])
def test_vanish_frame_bit_exact_to_jax(shrink, title):
    h, w, step = 96, 130, 8
    yy, xx = np.mgrid[0:32, 0:48].astype(np.float32)
    qflow = np.dstack([(xx - 24) / 3, (yy - 16) / 3])
    frame = _rand_frame(h, w, seed=4)
    got = vp.vanish_frame(frame, qflow, step=step, shrink_ratio=shrink,
                          title=title)
    want = jvp.vanish_frame(frame, qflow, step=step, shrink_ratio=shrink,
                            title=title)
    np.testing.assert_array_equal(got, want)


def test_direction_arrows_bit_exact_to_jax():
    h, w = 120, 160
    flow = _rand_flow(h, w, seed=11, mag=4.0)
    frame = _rand_frame(h, w, seed=12)
    dom = tv.dominant_direction(flow)
    np.testing.assert_array_equal(dom, jtv.dominant_direction(flow))
    np.testing.assert_array_equal(
        tv.draw_direction_arrows(frame, flow, step=20, scale=5.0,
                                 dominant=dom),
        jtv.draw_direction_arrows(frame, flow, step=20, scale=5.0,
                                  dominant=dom))


# ---------------------------------------------------------------- top view

@pytest.mark.parametrize("h,w", [(96, 128), (70, 90), (201, 333),
                                 (720, 1280)])
def test_perspective_matrix_and_warp(h, w):
    """The matrix within 1e-9 of OpenCV's; the warp bit-exact to
    ``cv2.warpPerspective`` given the same matrix."""
    want_m = jtv.perspective_matrix(w, h)
    got_m = tv.perspective_matrix(w, h)
    assert np.abs(got_m - want_m).max() <= 1e-9
    frame = _rand_frame(h, w, seed=h)
    want = cv2.warpPerspective(frame, want_m, (w, h))
    np.testing.assert_array_equal(tv.warp_topview(frame, want_m), want)


def test_warp_bit_exact_on_random_homographies():
    rng = np.random.RandomState(0)
    for trial in range(60):
        m = np.eye(3) + rng.randn(3, 3) * np.array(
            [[0.1, 0.1, 5], [0.1, 0.1, 5], [1e-3, 1e-3, 0]])
        h, w = int(rng.randint(5, 60)), int(rng.randint(5, 90))
        frame = _rand_frame(h, w, trial)
        want = cv2.warpPerspective(frame, m, (w, h))
        np.testing.assert_array_equal(tv.warp_topview(frame, m), want)


def test_fma32_is_a_fused_multiply_add():
    """Against float32 products and sums taken exactly in rationals: the
    one rounding of a*b + c."""
    from fractions import Fraction
    rng = np.random.RandomState(1)
    a, b, c = (rng.randn(300).astype(np.float32) * s
               for s in (1.0, 1e3, 1e-2))
    got = fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert g == best, (x, y, z)


# ---------------------------------------------------------------- goldens

def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return np.ascontiguousarray(decode_png(f.read())[..., ::-1])  # BGR


def _check(name, img, max_frac_diff=0.01):
    """``tests/test_goldens._check`` with the port's PNG decoder."""
    gold = _golden(name)
    assert gold.shape == img.shape, f"{name}: {img.shape} vs {gold.shape}"
    frac = float(np.any(gold != img, axis=-1).mean())
    assert frac <= max_frac_diff, f"{name}: {frac:.2%} of pixels differ"
    return frac


def test_golden_colorwheel():
    _check("colorwheel.png", cw.flow_to_color(_synthetic_flow())[..., ::-1])


def test_golden_arrow_overlay():
    _check("arrows.png", ov.arrow_overlay(_synthetic_frame(),
                                          _synthetic_flow(), step=16,
                                          scale=0.5, title="golden"))


def test_golden_topview_arrows():
    flow = _synthetic_flow()
    flow[..., 0] += 4.0
    _check("topview_arrows.png", tv.draw_direction_arrows(
        _synthetic_frame(), flow, step=20, scale=2.0,
        dominant=tv.dominant_direction(flow)))


def test_golden_vanishing_marker():
    est = vp.estimate_vanishing_point(_synthetic_flow(), step=8)
    _check("vanish_marker.png", vp.draw_vanishing_point(_synthetic_frame(),
                                                        est))


def test_golden_vanish_frame_shrink():
    out = vp.vanish_frame(_synthetic_frame(), _synthetic_flow(), step=8,
                          shrink_ratio=0.75, title="VP")
    assert out[:5].max() == 0 and out[-5:].max() == 0
    _check("vanish_shrink.png", out)


# ---------------------------------------------------------------- the rest

def test_side_by_side_quiver_and_what_is_not_ported(tmp_path):
    """``side_by_side`` is JAX's; ``opencv_flow`` (the comparison
    baselines, once not ported) gives the JAX package's OpenCV flow within
    1e-3 px mean EPE for each method (measured ≤ 2e-7, see
    ``test_torch_classic_flow.py``), and an unknown method is JAX's
    ``ValueError``."""
    a, b = _rand_frame(10, 12, 1), _rand_frame(10, 7, 2)
    np.testing.assert_array_equal(ov.side_by_side(a, b),
                                  jov.side_by_side(a, b))
    f1 = cv2.GaussianBlur(_rand_frame(40, 48, 3), (0, 0), 2.0)
    f2 = np.ascontiguousarray(np.roll(f1, (1, 2), axis=(0, 1)))
    for method in ("farneback", "dis", "lucaskanade_dense"):
        got = ov.opencv_flow(f1, f2, method, device="cpu")
        want = jov.opencv_flow(f1, f2, method)
        assert got.shape == want.shape == (40, 48, 2)
        assert np.hypot(*(got - want).transpose(2, 0, 1)).mean() <= 1e-3
    with pytest.raises(ValueError) as jax_err:
        jov.opencv_flow(f1, f2, "horn_schunck")
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        ov.opencv_flow(f1, f2, "horn_schunck")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="matplotlib"):
            ov.quiver_figure(a[..., ::-1], _rand_flow(10, 12),
                             str(tmp_path / "q.png"))
    else:
        path = str(tmp_path / "q.png")
        ov.quiver_figure(_rand_frame(64, 64)[..., ::-1], _rand_flow(64, 64),
                         path)
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_native_library_builds_into_build_dir():
    lib = flowviz.load()
    assert lib is flowviz.load()
    assert os.path.basename(os.path.dirname(lib._name)) == "_build"
    assert jflowviz.available()      # the JAX loader, for the tests above


def test_a_failed_native_build_raises(monkeypatch, tmp_path):
    """No quiet numpy fallback: a g++ failure reaches the caller."""
    from opticalflow_tpu_torch.runtime import _native
    monkeypatch.setattr(flowviz, "_lib", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(flowviz, "_FLAGS",
                        flowviz._FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="failed"):
        flowviz.draw_segments_native(np.zeros((4, 4, 3), np.uint8),
                                     np.zeros((1, 4), np.int32), (1, 2, 3))
