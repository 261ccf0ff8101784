"""The comparison mode's classical baselines, written without OpenCV, held
against OpenCV 5.0 (``cv2`` 5.0.0): ``io/yuv.bgr_to_gray``,
``viz/farneback.py`` (torch ops, here on the CPU) and ``runtime/dis.cpp``
(host C++), on seeded textured pairs at 16x16, 40x48, 96x128 and 121x163
under a sub-pixel shift, a small rotation with zoom, and a flat frame.

Tolerances, with what was measured on the CPU against cv2 5.0.0:

  * ``bgr_to_gray``: bit for bit;
  * Farneback, both parameter sets: mean EPE ≤ 1e-3 px against
    ``cv2.calcOpticalFlowFarneback`` (measured: mean ≤ 2.2e-7, 99th
    percentile ≤ 8.5e-7, max ≤ 3.5e-6; float32 rounding in another order);
    p99 ≤ 1e-2 asserted besides;
  * DIS-medium: mean EPE ≤ 0.05 px against cv2's (measured: mean ≤ 1.7e-6,
    99th percentile ≤ 3.5e-5, max ≤ 6.6e-5); p99 ≤ 0.5 asserted besides;
  * the stages: the Gaussian kernels bit for bit, a pyramid level and the
    flow resize to 1e-4, one level's expansion, update and solve (one
    iteration) to 1e-5 px, INTER_AREA bit for bit, the variational
    refinement to 1e-5 px, DIS without it (with and without the spatial
    propagation) to 1e-4 px mean.

cv2's DIS gives the same flow under 1, 3 and 8 threads on these pairs (its
propagation runs in a fixed eight stripes), so no thread count is pinned:
:func:`test_cv2_dis_does_not_depend_on_its_thread_count` checks it.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from opticalflow_tpu_torch.io.yuv import bgr_to_gray  # noqa: E402
from opticalflow_tpu_torch.runtime import dis  # noqa: E402
from opticalflow_tpu_torch.viz import farneback as fb  # noqa: E402

SIZES = [(16, 16), (40, 48), (96, 128), (121, 163)]
KINDS = ["shift", "rotzoom", "flat"]


def _texture(h, w, warp=None, seed=0):
    """A sum of 24 seeded sinusoids sampled at (x, y), or at ``warp(x,
    y)``: a textured grey uint8 image whose motion is known exactly."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    if warp is not None:
        xs, ys = warp(xs, ys)
    img = np.zeros((h, w))
    for _ in range(24):
        fx, fy = rng.uniform(-0.35, 0.35, 2)
        ph, a = rng.uniform(0, 2 * np.pi), rng.uniform(10, 30)
        img += a * np.sin(fx * xs + fy * ys + ph)
    img = 128 + img * (100 / np.abs(img).max())
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def grey_pair(kind, h, w, seed=0):
    """(g1, g2): ``shift`` moves the texture by (1.37, -0.61) px,
    ``rotzoom`` turns it 2° about the centre and zooms 3%, ``flat`` is one
    grey level."""
    if kind == "flat":
        g = np.full((h, w), 117, np.uint8)
        return g, g.copy()
    if kind == "shift":
        def warp(x, y):
            return x - 1.37, y + 0.61
    else:
        cx, cy, a, s = w / 2, h / 2, np.deg2rad(2.0), 1.03

        def warp(x, y):
            return (cx + ((x - cx) * np.cos(a) + (y - cy) * np.sin(a)) / s,
                    cy + (-(x - cx) * np.sin(a) + (y - cy) * np.cos(a)) / s)
    return _texture(h, w, seed=seed), _texture(h, w, warp, seed=seed)


def _epe(a, b):
    e = np.hypot(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])
    return e.mean(), np.percentile(e, 99), e.max()


def _farneback(method, g1, g2, **kw):
    ps, lv, ws, it, pn, sg = fb.FARNEBACK_PARAMS[method]
    p = dict(pyr_scale=ps, levels=lv, winsize=ws, iterations=it, poly_n=pn,
             poly_sigma=sg)
    p.update(kw)
    ours = fb.farneback_flow(g1, g2, device="cpu", **p)
    ref = cv2.calcOpticalFlowFarneback(
        g1, g2, None, p["pyr_scale"], p["levels"], p["winsize"],
        p["iterations"], p["poly_n"], p["poly_sigma"], 0)
    return ours, ref


def _cv2_dis(g1, g2, **setters):
    d = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
    for name, value in setters.items():
        getattr(d, "set" + name)(value)
    return d.calc(g1, g2, None)


# ------------------------------------------------------------------ grey

def test_bgr_to_gray_bit_exact():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (300, 301, 3), dtype=np.uint8)
    img[0, :8] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
                  [0, 0, 255], [1, 2, 3], [254, 1, 128], [128, 128, 128]]
    np.testing.assert_array_equal(bgr_to_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    with pytest.raises(ValueError, match="uint8"):
        bgr_to_gray(img.astype(np.float32))


# ------------------------------------------------------------- Farneback

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("method", ["farneback", "lucaskanade_dense"])
def test_farneback_matches_cv2(method, h, w, kind):
    g1, g2 = grey_pair(kind, h, w)
    ours, ref = _farneback(method, g1, g2)
    assert ours.shape == (h, w, 2) and ours.dtype == np.float32
    mean, p99, mx = _epe(ours, ref)
    assert mean <= 1e-3 and p99 <= 1e-2, (mean, p99, mx)


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (3, 0.5), (9, 1.5),
                                         (19, 3.5), (39, 7.5), (7, -1.0)])
def test_gaussian_kernel_is_opencvs(ksize, sigma):
    np.testing.assert_array_equal(
        fb.gaussian_kernel(ksize, sigma),
        cv2.getGaussianKernel(ksize, sigma, cv2.CV_32F).ravel())


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25, 0.125])
def test_pyramid_level_matches_cv2(scale):
    """Stage 1: OpenCV's blur of the full image, then its resize."""
    img = grey_pair("rotzoom", 121, 163)[0].astype(np.float32)
    sigma = (1 / scale - 1) * 0.5
    k = max(int(round(sigma * 5)) | 1, 3)
    want = cv2.resize(cv2.GaussianBlur(img, (k, k), sigma, sigmaY=sigma),
                      (int(round(163 * scale)), int(round(121 * scale))),
                      interpolation=cv2.INTER_LINEAR)
    got = fb.pyramid_level(torch.from_numpy(img), scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_flow_resize_matches_cv2():
    """Stage 5's resize of the 2-channel flow between levels."""
    flow = np.random.default_rng(2).standard_normal((30, 41, 2)).astype(
        np.float32)
    for h, w in [(60, 82), (61, 81), (121, 163)]:
        want = cv2.resize(flow, (w, h), interpolation=cv2.INTER_LINEAR)
        got = fb._resize_linear(torch.from_numpy(flow), h, w).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["farneback", "lucaskanade_dense"])
def test_one_level_one_iteration_matches_cv2(method):
    """Stages 2-4 alone: one level (levels=0) and one iteration, so the flow
    is the solve of the expansions' system at zero flow."""
    g1, g2 = grey_pair("rotzoom", 96, 128, seed=3)
    ours, ref = _farneback(method, g1, g2, levels=0, iterations=1)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("h,w", [(16, 16), (40, 48), (62, 64), (64, 64),
                                 (64, 130)])
def test_farneback_level_count_is_opencvs(h, w):
    """A level is built while both sides at its scale are at least 32 px:
    at 16x16, 40x48 and 62x64 only the image itself, so levels=3 gives
    cv2's levels=0 flow; at 64x64 one level more."""
    g1, g2 = grey_pair("shift", h, w, seed=1)
    ours, ref = _farneback("farneback", g1, g2)
    assert _epe(ours, ref)[0] <= 1e-6
    single = _farneback("farneback", g1, g2, levels=0)[1]
    assert np.array_equal(ref, single) == (min(h, w) < 64)


def test_farneback_refuses_bad_input():
    g = np.zeros((20, 20), np.uint8)
    with pytest.raises(ValueError, match="one size"):
        fb.farneback_flow(g, np.zeros((20, 21), np.uint8), pyr_scale=0.5,
                          levels=1, winsize=5, iterations=1, poly_n=5,
                          poly_sigma=1.1, device="cpu")
    with pytest.raises(ValueError, match="pyr_scale"):
        fb.farneback_flow(g, g, pyr_scale=1.0, levels=1, winsize=5,
                          iterations=1, poly_n=5, poly_sigma=1.1,
                          device="cpu")


# ------------------------------------------------------------------- DIS

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w", SIZES)
def test_dis_matches_cv2(h, w, kind):
    g1, g2 = grey_pair(kind, h, w)
    ours = dis.dis_flow(g1, g2)
    assert ours.shape == (h, w, 2) and ours.dtype == np.float32
    mean, p99, mx = _epe(ours, _cv2_dis(g1, g2))
    assert mean <= 0.05 and p99 <= 0.5, (mean, p99, mx)


@pytest.mark.parametrize("prop", [False, True])
def test_dis_search_and_densification_match_cv2(prop):
    """Stages 1-5 and 7 alone: cv2 and the port with no variational
    refinement, with and without the spatial propagation."""
    g1, g2 = grey_pair("rotzoom", 121, 163, seed=2)
    ref = _cv2_dis(g1, g2, VariationalRefinementIterations=0,
                   UseSpatialPropagation=prop)
    ours = dis.dis_flow(g1, g2, var_iter=0, spatial_prop=prop)
    assert _epe(ours, ref)[0] <= 1e-4


@pytest.mark.parametrize("h,w", [(10, 12), (11, 13), (40, 48)])
def test_variational_refinement_matches_cv2(h, w):
    """Stage 6 alone, against ``cv2.VariationalRefinement`` from a random
    flow, even and odd sides (the red-black split's edges)."""
    g1, g2 = grey_pair("rotzoom", h, w)
    rng = np.random.default_rng(0)
    u = (rng.standard_normal((h, w)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((h, w)) * 0.3).astype(np.float32)
    for it, sor in [(1, 1), (2, 3), (5, 5)]:
        vr = cv2.VariationalRefinement_create()
        vr.setFixedPointIterations(it)
        vr.setSorIterations(sor)
        vr.setEpsilon(0.01)
        wu, wv = vr.calcUV(g1, g2, u.copy(), v.copy())
        ou, ov = dis.variational_refinement(g1, g2, u, v, iterations=it,
                                            sor_iterations=sor, epsilon=0.01)
        np.testing.assert_allclose(ou, wu, atol=1e-5, rtol=0)
        np.testing.assert_allclose(ov, wv, atol=1e-5, rtol=0)


@pytest.mark.parametrize("h,w,dh,dw", [(96, 128, 48, 64), (121, 163, 60, 81),
                                       (45, 80, 22, 40), (363, 500, 181, 250)])
def test_resize_area_bit_exact(h, w, dh, dw):
    img = np.random.default_rng(h).integers(0, 256, (h, w), dtype=np.uint8)
    np.testing.assert_array_equal(
        dis.resize_area(img, dh, dw),
        cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA))


def test_cv2_dis_does_not_depend_on_its_thread_count():
    g1, g2 = grey_pair("rotzoom", 121, 163)
    before = cv2.getNumThreads()
    try:
        flows = []
        for n in (1, 3, 8):
            cv2.setNumThreads(n)
            flows.append(_cv2_dis(g1, g2))
    finally:
        cv2.setNumThreads(before)
    assert all(np.array_equal(flows[0], f) for f in flows[1:])


def test_dis_refuses_bad_input():
    g = np.zeros((20, 20), np.uint8)
    with pytest.raises(ValueError, match="grey"):
        dis.dis_flow(np.zeros((20, 20, 3), np.uint8), g)
    with pytest.raises(ValueError, match="one size"):
        dis.dis_flow(g, np.zeros((20, 21), np.uint8))
    with pytest.raises(ValueError, match="patch size"):
        dis.dis_flow(np.zeros((4, 4), np.uint8), np.zeros((4, 4), np.uint8))
    # a thin frame whose coarse scales fall under the patch (cv2 5.0
    # crashes on this pair: it reads outside the level)
    thin = grey_pair("shift", 12, 200)
    with pytest.raises(ValueError, match="smaller than the 8-px patch"):
        dis.dis_flow(*thin)


def test_dis_library_builds_into_build_dir():
    lib = dis.load()
    assert lib is dis.load()
    assert os.path.basename(os.path.dirname(lib._name)) == "_build"


def test_a_failed_dis_build_raises(monkeypatch, tmp_path):
    """No fallback to OpenCV: a g++ failure reaches the caller."""
    from opticalflow_tpu_torch.runtime import _native
    monkeypatch.setattr(dis, "_lib", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(dis, "_FLAGS", dis._FLAGS + ("-fno-such-flag",))
    g = np.zeros((20, 20), np.uint8)
    with pytest.raises(RuntimeError, match="building dis.cpp failed"):
        dis.dis_flow(g, g)
