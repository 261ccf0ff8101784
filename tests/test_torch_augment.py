"""The port's numpy augmentation (``opticalflow_tpu_torch/data/augment.py``)
against the JAX package's, which calls OpenCV here, on the same seeded
inputs and the same ``np.random.Generator`` seeds.

Tolerances (OpenCV computes in float32, the port samples at float64
coordinates with float32 weights):
  * images on [0, 1]: 1e-5; images on 0..255 through the blur: 2e-3;
  * flow: 1e-4 px, on smooth flows of up to ±20 px.  The gap between the
    two is OpenCV's coordinate rounding (≈6e-6 px) times the flow's change
    from one pixel to the next, so a flow that is noise from pixel to pixel
    (±100 px between neighbours) would show ≈1e-3 px;
  * nearest-sampled arrays: equal;
  * a ``valid`` mask warped bilinearly and thresholded at 0.5: equal on
    ≥ 99.9% of pixels (a value at the threshold can fall either side).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from opticalflow_tpu.data import augment as jaug
from opticalflow_tpu_torch.data import augment as aug

IMG_TOL = 1e-5
IMG255_TOL = 2e-3
FLOW_TOL = 1e-4
MASK_AGREE = 0.999


def _smooth(rng, h, w, c, scale):
    """A smooth random field (H, W, C): bilinear upsampling of a coarse
    grid of uniform values in [-scale, scale]."""
    coarse = torch.from_numpy(
        (rng.uniform(-1, 1, (1, c, h // 8 + 2, w // 8 + 2)) * scale
         ).astype(np.float32))
    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0).numpy()


def _sample(seed, h=60, w=84):
    rng = np.random.default_rng(seed + 100)
    im1 = rng.random((h, w, 3)).astype(np.float32)
    im2 = rng.random((h, w, 3)).astype(np.float32)
    flow = _smooth(rng, h, w, 2, 20.0)
    valid = rng.random((h, w)) > 0.3
    return im1, im2, flow, valid


def _assert_mask_agrees(ours, ref):
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == bool
    assert (ours == ref).mean() >= MASK_AGREE, (ours != ref).sum()


def test_affine_matrix_is_the_jax_function():
    for args in (((41.0, 29.5), 1.7, 1.02, 0.97),
                 ((42, 30), -16.0, 1.0, 1.0, (3.0, -2.0))):
        m, a = aug.affine_matrix(*args)
        jm, ja = jaug.affine_matrix(*args)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(a, ja)
        assert m.dtype == jm.dtype == np.float32


@pytest.mark.parametrize("border", ["reflect_101", "reflect"])
@pytest.mark.parametrize("seed", range(4))
def test_warp_matches_warp_affine(seed, border):
    """Rotations up to ±17° with anisotropic zoom and a shift, on 3- and
    1-channel images (images: bilinear and nearest; flow channels)."""
    cv_border = {"reflect_101": cv2.BORDER_REFLECT_101,
                 "reflect": cv2.BORDER_REFLECT}[border]
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(20, 70)), int(rng.integers(20, 90))
    im = rng.random((h, w, 3)).astype(np.float32)
    fl = _smooth(rng, h, w, 1, 20.0)[..., 0]
    m, _ = aug.affine_matrix((w * 0.5, h * 0.5), rng.uniform(-17, 17),
                             rng.uniform(0.9, 1.1), rng.uniform(0.9, 1.1),
                             (rng.uniform(-4, 4), rng.uniform(-4, 4)))
    for arr, tol in ((im, IMG_TOL), (im[..., 1], IMG_TOL), (fl, FLOW_TOL)):
        arr = np.ascontiguousarray(arr)
        ours = aug._warp(arr, m, (h, w), border=border)
        ref = cv2.warpAffine(arr, m, (w, h), flags=cv2.INTER_LINEAR,
                             borderMode=cv_border)
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)
        near = aug._warp(arr, m, (h, w), nearest=True, border=border)
        np.testing.assert_array_equal(
            near, cv2.warpAffine(arr, m, (w, h), flags=cv2.INTER_NEAREST,
                                 borderMode=cv_border))
    # the JAX package's own _warp (OpenCV) on the same call
    np.testing.assert_allclose(aug._warp(im, m, (h, w), border=border),
                               jaug._warp(im, m, (h, w), border=cv_border),
                               rtol=0, atol=IMG_TOL)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("shape", [(31, 47, 3), (9, 4), (2, 3, 3)],
                         ids=["rgb", "narrow-grey", "tiny"])
def test_gaussian_blur_matches_opencv(shape, k):
    """The binomial kernels OpenCV uses for sigma 0, reflect-101 border;
    frames narrower than the kernel included."""
    x = (np.random.default_rng(k).random(shape) * 255).astype(np.float32)
    ours = aug.gaussian_blur(x, k)
    ref = cv2.GaussianBlur(x, (k, k), 0)
    assert ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=0, atol=IMG255_TOL)


@pytest.mark.parametrize("seed", range(6))
def test_reduced_affine_matches_jax(seed):
    """The same generator draws the same transform (or the same 40% skip);
    the generators stay in step after it."""
    im1, im2, flow, valid = _sample(seed)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    out = aug.reduced_affine(im1, im2, flow, valid, rng)
    ref = jaug.reduced_affine(im1, im2, flow, valid, jrng)
    for o, r, tol in zip(out[:3], ref[:3], (IMG_TOL, IMG_TOL, FLOW_TOL)):
        assert o.shape == r.shape and o.dtype == r.dtype
        np.testing.assert_allclose(o, r, rtol=0, atol=tol)
    assert out[3].dtype == np.asarray(ref[3]).dtype
    if out[3].dtype == bool:
        _assert_mask_agrees(out[3], ref[3])
    assert rng.random() == jrng.random()


def test_reduced_affine_skips_and_warps_across_seeds():
    """Seeds 0-5 above cover both branches (a skip returns the inputs)."""
    skipped = [np.random.default_rng(s).random() < 0.4 for s in range(6)]
    assert any(skipped) and not all(skipped)


@pytest.mark.parametrize("seed", range(3))
def test_random_crop_and_hflip_match_jax(seed):
    im1, im2, flow, valid = _sample(seed)
    out = aug.random_crop((im1, im2, flow, valid), (40, 64),
                          np.random.default_rng(seed))
    ref = jaug.random_crop((im1, im2, flow, valid), (40, 64),
                           np.random.default_rng(seed))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    # a crop no smaller than the frame keeps it whole and draws nothing
    rng = np.random.default_rng(seed)
    whole = aug.random_crop((im1,), (80, 100), rng)[0]
    np.testing.assert_array_equal(whole, im1)
    assert rng.random() == np.random.default_rng(seed).random()
    for o, r in zip(aug.hflip(*out), jaug.hflip(*[a.copy() for a in ref])):
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("seed", range(12))
def test_rich_augment_matches_jax(seed):
    """Crop, flip, rotation (BORDER_REFLECT), translation, brightness and
    blur (k = 3 or 5) on 0..255 images, across seeds that fire every
    branch (checked below)."""
    im1, im2, flow, valid = _sample(seed, 72, 100)
    im1, im2 = im1 * 255.0, im2 * 255.0
    out = aug.RichAugment((48, 80))(im1, im2, flow, valid,
                                    np.random.default_rng(seed))
    ref = jaug.RichAugment((48, 80))(im1, im2, flow, valid,
                                     np.random.default_rng(seed))
    for o, r, tol in zip(out[:3], ref[:3],
                         (IMG255_TOL, IMG255_TOL, FLOW_TOL)):
        assert o.shape == r.shape and o.dtype == r.dtype
        np.testing.assert_allclose(o, r, rtol=0, atol=tol)
    _assert_mask_agrees(np.asarray(out[3]), np.asarray(ref[3]))


def test_rich_augment_seeds_fire_every_branch():
    """Seeds 0-11 above reach each of the five 50% branches, both blur
    sizes, and both sides of each branch (the draw order of RichAugment)."""
    fired = {k: set() for k in ("flip", "rot", "shift", "gain", "blur")}
    ks = set()
    for seed in range(12):
        rng = np.random.default_rng(seed)
        rng.integers(0, 72 - 48 + 1), rng.integers(0, 100 - 80 + 1)
        for name in fired:
            hit = rng.random() < 0.5
            fired[name].add(hit)
            if not hit:
                continue
            if name == "rot":
                rng.uniform(-17.0, 17.0)
            elif name == "shift":
                rng.integers(-10, 11), rng.integers(-10, 11)
            elif name == "gain":
                rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2)
            elif name == "blur":
                ks.add(int(rng.choice((3, 5))))
    assert all(v == {True, False} for v in fired.values()), fired
    assert ks == {3, 5}


def test_rich_augment_without_augment_only_crops():
    im1, im2, flow, valid = _sample(0)
    out = aug.RichAugment((40, 64), augment=False)(
        im1, im2, flow, valid, np.random.default_rng(3))
    ref = jaug.RichAugment((40, 64), augment=False)(
        im1, im2, flow, valid, np.random.default_rng(3))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
