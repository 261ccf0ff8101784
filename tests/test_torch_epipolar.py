"""The port's epipolar geometry (``opticalflow_tpu_torch/geometry``) against
the JAX package's on the CPU: ``tests/test_epipolar.py``'s seven cases, each
run through both with the same inputs and, for RANSAC, the same hypotheses
(JAX's own draws, ``jax.random.split`` then ``jax.random.choice`` without
replacement, handed to the port as ``sample_idx``); then one
``proxy_epipolar`` train step with the Sampson term against the JAX step.

Tolerances: F within 1e-4 of the JAX F's largest entry, both normalised
by F[2, 2] (float32 SVDs from two LAPACK builds), where the system is well
conditioned (200 exact points, RANSAC's refit over 240 inliers); where it
is less so (a noisy small-baseline flow's refit) both are held to the
float64 solve within 5e-4.  A minimal
8-point system is not: its smallest nonzero singular value is 2e-4 to 4e-3
of its largest, and either package's float32 F lies up to 7.1e-3 (JAX) and
5.0e-3 (port) of its largest entry from the float64 solve of the same
points, so there each is held to the float64 solve within 1e-2.  Masks
equal on ≥ 99.5% of pixels; Sampson penalties 1e-5 relative.  The step:
loss and metrics 1e-5 relative, and every gradient within 1e-3 relative
+ 1e-4 of the parameter's largest from JAX's (``tests/test_torch_trainer.py``'s
tolerances).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opticalflow_tpu.geometry import epipolar as J
from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet
from opticalflow_tpu.train import trainer as JT
from opticalflow_tpu_torch.geometry import epipolar as T
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.models.torch_import import state_dict_from_jax
from opticalflow_tpu_torch.train import trainer as TT
from test_epipolar import _synthetic_two_view

F_TOL = 1e-4
MASK_AGREE = 0.995


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _chw(flow_hw2):
    """(H, W, 2) → the port's (2, H, W)."""
    return _t(np.ascontiguousarray(np.transpose(flow_hw2, (2, 0, 1))))


def jax_draws(key, n, iters, min_samples=8):
    """The hypotheses' rows JAX's RANSAC draws from ``key``."""
    keys = jax.random.split(key, iters)
    return torch.from_numpy(np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, (min_samples,), replace=False))(
            keys)).astype(np.int64))


def assert_f_close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape == (3, 3)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=F_TOL * np.abs(ref).max())


def test_eight_point_recovers_f():
    x1, x2, _ = _synthetic_two_view()
    f = T.eight_point_fundamental(_t(x1), _t(x2))
    assert_f_close(f, J.eight_point_fundamental(jnp.asarray(x1),
                                                jnp.asarray(x2)))
    d = T.sampson_distance(f, _t(x1), _t(x2)).numpy()
    np.testing.assert_allclose(
        d, np.asarray(J.sampson_distance(jnp.asarray(f.numpy()),
                                         jnp.asarray(x1), jnp.asarray(x2))),
        rtol=1e-4, atol=1e-9)
    assert np.median(d) < 0.05
    assert d.max() < 0.5


def test_eight_point_minimal_sample_fits_its_own_points():
    """N=8: the null vector is the 9th row of the full SVD's Vh.  Each
    package's float32 F against the float64 solve (module docstring)."""
    for seed in range(5):
        x1, x2, _ = _synthetic_two_view(n=8, seed=seed)
        f = T.eight_point_fundamental(_t(x1), _t(x2))
        f64 = T.eight_point_fundamental(_t(x1).double(),
                                        _t(x2).double()).numpy()
        jf = np.asarray(J.eight_point_fundamental(jnp.asarray(x1),
                                                  jnp.asarray(x2)))
        for got in (f.numpy(), jf):
            np.testing.assert_allclose(got, f64, rtol=0,
                                       atol=1e-2 * np.abs(f64).max())
        assert T.sampson_distance(f, _t(x1), _t(x2)).max() < 1e-3, seed


def test_eight_point_batches_like_one_call_each():
    """One batched SVD over hypotheses gives each one's own solve."""
    sets = [_synthetic_two_view(n=8, seed=s)[:2] for s in range(4)]
    x1 = torch.stack([_t(a) for a, _ in sets])
    x2 = torch.stack([_t(b) for _, b in sets])
    batched = T.eight_point_fundamental(x1, x2)
    for i in range(4):
        torch.testing.assert_close(
            batched[i], T.eight_point_fundamental(x1[i], x2[i]),
            rtol=0, atol=F_TOL * float(batched[i].abs().max()))


def _outlier_views():
    x1, x2, _ = _synthetic_two_view(n=300, noise=0.05)
    rng = np.random.RandomState(3)
    x2c = x2.copy()
    bad = rng.choice(300, 60, replace=False)          # 20% outliers
    x2c[bad, :2] += rng.randn(60, 2) * 30.0
    return x1, x2, x2c, bad


def test_ransac_rejects_outliers():
    x1, x2, x2c, bad = _outlier_views()
    key = jax.random.PRNGKey(0)
    f, inliers, count = T.ransac_fundamental(
        _t(x1), _t(x2c), iters=128, thresh=0.5,
        sample_idx=jax_draws(key, 300, 128))
    jf, jinl, jcount = J.ransac_fundamental(
        jnp.asarray(x1), jnp.asarray(x2c), key, iters=128, thresh=0.5)
    assert int(count) == int(jcount)
    np.testing.assert_array_equal(inliers.numpy(), np.asarray(jinl))
    assert_f_close(f, jf)
    inliers = inliers.numpy()
    assert int(count) > 150
    assert inliers[bad].mean() < 0.25
    d = T.sampson_distance(f, _t(x1), _t(x2c)).numpy()
    good = np.setdiff1d(np.arange(300), bad)
    assert np.median(d[good]) < 0.5


def test_ransac_draws_distinct_rows_from_its_generator():
    """Without ``sample_idx`` the port draws its own hypotheses: distinct
    rows each, the same for the same seed, and RANSAC still rejects the
    outliers."""
    x1, _, x2c, bad = _outlier_views()
    idx = T._draw(300, 128, 8, torch.Generator().manual_seed(5), "cpu")
    assert idx.shape == (128, 8)
    assert all(len(set(r.tolist())) == 8 for r in idx)
    assert int(idx.min()) >= 0 and int(idx.max()) < 300
    runs = [T.ransac_fundamental(_t(x1), _t(x2c),
                                 torch.Generator().manual_seed(5),
                                 iters=128) for _ in range(2)]
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    assert runs[0][1].numpy()[bad].mean() < 0.25


def _mask_both(flow, key, **kw):
    h, w, _ = flow.shape
    n = len(range(0, h, kw["stride"])) * len(range(0, w, kw["stride"]))
    ours = T.epipolar_mask_and_f(_chw(flow), sample_idx=jax_draws(
        key, n, kw["iters"]), **kw)
    ref = J.epipolar_mask_and_f(jnp.asarray(flow), key, **kw)
    return ours, ref


def test_epipolar_mask_consistent_flow_keeps_pixels():
    h, w = 48, 64
    flow = np.tile(np.array([2.0, 1.0], np.float32), (h, w, 1))
    flow += np.random.RandomState(0).randn(h, w, 2).astype(np.float32) * 0.01
    (mask, f), (jmask, jf) = _mask_both(
        flow, jax.random.PRNGKey(1), tau=1.0, stride=4, keep_ratio=0.5,
        min_keep=0.05, iters=64)
    assert mask.shape == (h, w) and mask.dtype == torch.bool
    assert (mask.numpy() == np.asarray(jmask)).mean() >= MASK_AGREE
    assert mask.float().mean() >= 0.2


def test_epipolar_mask_relaxes_to_min_keep_coverage():
    h, w = 48, 64
    flow = np.random.RandomState(3).randn(h, w, 2).astype(np.float32) * 6.0
    (mask, f), (jmask, jf) = _mask_both(
        flow, jax.random.PRNGKey(0), tau=1e-9, stride=4, keep_ratio=0.2,
        min_keep=0.05, iters=64)
    assert (mask.numpy() == np.asarray(jmask)).mean() >= MASK_AGREE
    assert mask.float().mean() >= 0.05 * 0.9, mask.float().mean()


def two_view_flow(h, w, seed, noise=0.3, outliers=0.1):
    """A dense flow of a camera that translates and turns over a surface
    of varying depth (exact epipolar geometry), with ``noise`` px of noise
    and ``outliers`` of the pixels moved at random: a predicted flow's
    residuals sit well above float32 rounding."""
    rng = np.random.RandomState(seed)
    k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
    ang, t = 0.03, np.array([0.4, 0.1, 0.2])
    r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = 5.0 + 2.0 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
    pts = (np.linalg.inv(k) @ np.stack([xx, yy, np.ones_like(xx)]).reshape(
        3, -1)) * depth.reshape(1, -1)
    p2 = k @ (r @ pts + t[:, None])
    x2 = (p2[:2] / p2[2:]).reshape(2, h, w)
    flow = np.stack([x2[0] - xx, x2[1] - yy], axis=-1)
    flow += rng.randn(h, w, 2) * noise
    bad = rng.rand(h, w) < outliers
    flow[bad] += rng.randn(int(bad.sum()), 2) * 8.0
    return flow.astype(np.float32)


def test_epipolar_mask_on_two_view_motion_matches_jax():
    """The tau ∧ quantile mask of a moving camera's noisy flow with
    outliers: neither empty nor full, and F."""
    flow = two_view_flow(48, 64, seed=0)
    key = jax.random.PRNGKey(2)
    (mask, f), (jmask, jf) = _mask_both(
        flow, key, tau=1.0, stride=4, keep_ratio=0.2, min_keep=0.05,
        iters=128)
    assert (mask.numpy() == np.asarray(jmask)).mean() >= MASK_AGREE
    assert 0.0 < mask.float().mean() < 1.0
    # the refit over ~170 noisy inliers of a small baseline is less well
    # conditioned than the 200 exact points above: JAX's float32 F lies
    # 1.1e-4 of its largest entry from the float64 refit of the same
    # inliers, the port's 1.3e-4 on the other side; each is held to 5e-4
    x1, x2 = T.flow_to_pairs(_chw(flow), 4)
    _, inl, _ = T.ransac_fundamental(
        x1, x2, iters=128, sample_idx=jax_draws(key, x1.shape[0], 128))
    f64 = T.eight_point_fundamental(x1.double(), x2.double(),
                                    inl.double()).numpy()
    for got in (f.numpy(), np.asarray(jf)):
        np.testing.assert_allclose(got, f64, rtol=0,
                                   atol=5e-4 * np.abs(f64).max())


def test_ransac_failure_keeps_every_pixel():
    """Fewer than min_samples inliers (a threshold nothing passes): the
    mask is all-True in both."""
    h, w = 24, 32
    flow = np.random.RandomState(4).randn(h, w, 2).astype(np.float32) * 9.0
    (mask, _), (jmask, _) = _mask_both(
        flow, jax.random.PRNGKey(3), tau=1.0, stride=4, keep_ratio=0.2,
        min_keep=0.05, iters=16, thresh=1e-12)
    assert bool(mask.all()) and bool(np.asarray(jmask).all())


@pytest.mark.parametrize("robust", ["huber", "l1", "plain"])
def test_sampson_penalty_zero_for_exact_geometry(robust):
    """Small for consistent flow, larger for corrupted flow, and the JAX
    value for each robust loss, with and without a valid mask."""
    x1, x2, f_true = _synthetic_two_view(n=64 * 48)
    h, w = 48, 64
    u = (x2[:, 0] - x1[:, 0]).reshape(h, w)
    v = (x2[:, 1] - x1[:, 1]).reshape(h, w)
    flow = np.stack([u, v], axis=-1).astype(np.float32)[None]
    fm = np.tile(f_true[None], (1, 1, 1)).astype(np.float32)
    corrupted = flow + np.random.RandomState(1).randn(*flow.shape).astype(
        np.float32) * 20.0
    valid = (np.random.RandomState(2).rand(1, h, w) > 0.3).astype(np.float32)
    vals = {}
    for name, fl in (("base", flow), ("worse", corrupted)):
        for vm in (None, valid):
            ours = float(T.sampson_penalty(
                _chw(fl[0])[None], _t(fm), None if vm is None else _t(vm),
                robust=robust))
            ref = float(J.sampson_penalty(
                jnp.asarray(fl), jnp.asarray(fm),
                None if vm is None else jnp.asarray(vm), robust=robust))
            assert ours == pytest.approx(ref, rel=1e-5), (name, robust)
        vals[name] = ours
    assert vals["worse"] > vals["base"]


def test_flow_to_pairs_shapes():
    flow = np.random.RandomState(0).randn(32, 48, 2).astype(np.float32)
    x1, x2 = T.flow_to_pairs(_chw(flow), stride=8)
    jx1, jx2 = J.flow_to_pairs(jnp.asarray(flow), stride=8)
    assert x1.shape == (4 * 6, 3) and x2.shape == (4 * 6, 3)
    np.testing.assert_array_equal(x1.numpy(), np.asarray(jx1))
    np.testing.assert_array_equal(x2.numpy(), np.asarray(jx2))
    z1, z2 = T.flow_to_pairs(torch.zeros(2, 32, 48), stride=8)
    torch.testing.assert_close(z1, z2, rtol=0, atol=0)


# ------------------------------------------------------ proxy_epipolar step


def _batch(b=2, h=64, w=64, seed=0):
    rng = np.random.RandomState(seed)
    _, _, f_true = _synthetic_two_view()
    fs = np.stack([f_true * (1.0 + 0.1 * i) for i in range(b)])
    return {"images": rng.rand(b, h, w, 6).astype(np.float32),
            "photo_mask": (rng.rand(b, h, w) > 0.4).astype(np.float32),
            "fundamental": (fs / fs[:, 2:, 2:]).astype(np.float32)}


def test_proxy_epipolar_step_matches_jax():
    """One proxy_epipolar step with epi_soft_weight 0.1: loss, photo,
    smooth and sampson metrics and every gradient against the JAX step's,
    from the same carried-across weights (×0.5, as the trainer tests).
    The model's flow here is near zero, so warped points on the last row
    round onto the image's edge: the border warp's gradient there is
    held to JAX's too."""
    jmodel = JaxPWCDCNet(variant="new", precision="highest",
                         use_pallas_corr=False)
    params = jax.jit(lambda r, x: jmodel.init(r, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)))["params"]
    params = jax.tree.map(lambda p: np.asarray(p) * 0.5, params)
    cfg = TT.TrainConfig(loss="proxy_epipolar", optimizer="adam",
                         epi_soft_weight=0.1)
    jcfg = JT.TrainConfig(**dataclasses.asdict(cfg))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT._compute_loss(jmodel, p, jb, jcfg), has_aux=True))(
            params)
    jm = {k: float(v) for k, v in jm.items()}
    assert set(jm) == {"loss", "photo", "smooth", "sampson"}

    model = PWCDCNet(variant="new", precision="highest")
    model.load_state_dict(state_dict_from_jax(params))
    loss, m = TT._compute_loss(
        model, TT.batch_to_device(batch, torch.device("cpu")), cfg)
    loss.backward()
    for k, v in jm.items():
        assert float(m[k]) == pytest.approx(v, rel=1e-5), k
    assert float(m["loss"]) == pytest.approx(
        float(m["photo"]) + 0.1 * float(m["smooth"])
        + 0.1 * float(m["sampson"]), rel=1e-6)
    gj = state_dict_from_jax(jax.tree.map(np.asarray, jg))
    names = {n for n, _ in model.named_parameters()}
    assert set(gj) == names
    for name, p in model.named_parameters():
        g_ref = gj[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(g_ref).max(),
                                   err_msg=name)
