"""The port's training losses (NCHW) against the JAX package's (NHWC) on
the same seeded inputs, at 1e-5 (float32 sums in another order)."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opticalflow_tpu.train import losses as JL
from opticalflow_tpu_torch.train import losses as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    """NHWC numpy → NCHW torch; (B, H, W) masks as they are."""
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(out, ref):
    out = out.permute(0, 2, 3, 1) if out.dim() == 4 else out
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


B, H, W = 2, 24, 32
FLOW = _rand((B, H, W, 2), 0, 3.0)
GT = _rand((B, H, W, 2), 1, 3.0)
IM1 = np.random.RandomState(2).rand(B, H, W, 3).astype(np.float32)
IM2 = np.random.RandomState(3).rand(B, H, W, 3).astype(np.float32)
VALID = (np.random.RandomState(4).rand(B, H, W) > 0.3).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_charbonnier_and_epe(masked):
    v = VALID if masked else None
    jv = None if v is None else jnp.asarray(v)
    tv = None if v is None else _t(v)
    _close(TL.charbonnier_epe(_t(FLOW), _t(GT), tv),
           JL.charbonnier_epe(jnp.asarray(FLOW), jnp.asarray(GT), jv))
    _close(TL.epe_loss(_t(FLOW), _t(GT), tv),
           JL.epe_loss(jnp.asarray(FLOW), jnp.asarray(GT), jv))


def test_smoothness_terms():
    _close(TL.smoothness_first_order(_t(FLOW)),
           JL.smoothness_first_order(jnp.asarray(FLOW)))
    _close(TL.edge_aware_smoothness(_t(FLOW), _t(IM1)),
           JL.edge_aware_smoothness(jnp.asarray(FLOW), jnp.asarray(IM1)))


@pytest.mark.parametrize("masked", [False, True])
def test_photometric_l1(masked):
    m = VALID if masked else None
    _close(TL.photometric_l1(_t(IM1), _t(IM2), None if m is None else _t(m)),
           JL.photometric_l1(jnp.asarray(IM1), jnp.asarray(IM2),
                             None if m is None else jnp.asarray(m)))


def test_ssim_and_proxy_photometric():
    _close(TL.ssim(_t(IM1), _t(IM2)),
           JL.ssim(jnp.asarray(IM1), jnp.asarray(IM2)))
    _close(TL._avg_pool3(_t(IM1)), JL._avg_pool3(jnp.asarray(IM1)))
    _close(TL.proxy_photometric_loss(_t(IM1), _t(IM2)),
           JL.proxy_photometric_loss(jnp.asarray(IM1), jnp.asarray(IM2)))


@pytest.mark.parametrize("hw", [(H, W), (H // 4, W // 4), (7, 9)])
def test_flow_to_image_res(hw):
    f = FLOW[:, :hw[0], :hw[1]]
    _close(TL._flow_to_image_res(_t(f), H, W),
           JL._flow_to_image_res(jnp.asarray(f), H, W))


@pytest.mark.parametrize("quarter", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_proxy_label_loss(quarter, masked):
    f = FLOW[:, ::4, ::4] if quarter else FLOW
    m = VALID if masked else None
    out = TL.proxy_label_loss(_t(f), _t(IM1), _t(IM2), alpha_photo=0.7,
                              alpha_smooth=0.2,
                              photo_mask=None if m is None else _t(m))
    ref = JL.proxy_label_loss(jnp.asarray(f), jnp.asarray(IM1),
                              jnp.asarray(IM2), alpha_photo=0.7,
                              alpha_smooth=0.2,
                              photo_mask=None if m is None
                              else jnp.asarray(m))
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("lam_photo,lam_smooth", [(0.0, 0.0), (0.5, 0.0),
                                                  (0.0, 0.3), (0.5, 0.3)])
def test_multiscale_supervised_loss(lam_photo, lam_smooth):
    hb, wb = 64, 96
    gt = _rand((B, hb, wb, 2), 5, 4.0)
    valid = (np.random.RandomState(6).rand(B, hb, wb) > 0.2).astype(
        np.float32)
    images = np.random.RandomState(7).rand(B, hb, wb, 6).astype(np.float32)
    # flow2..flow6 of a 64x96 input, at quarter..1/64 resolution, and one
    # level that is not a power-of-two reduction
    preds = [_rand((B, hb // s, wb // s, 2), 10 + i)
             for i, s in enumerate((4, 8, 16, 32))] + [_rand((B, 3, 5, 2),
                                                             20)]
    kw = dict(weights=(0.32, 0.08, 0.02, 0.01, 0.005),
              lambda_photo=lam_photo, lambda_smooth=lam_smooth)
    out = TL.multiscale_supervised_loss([_t(p) for p in preds], _t(gt),
                                        _t(valid), images=_t(images), **kw)
    ref = JL.multiscale_supervised_loss([jnp.asarray(p) for p in preds],
                                        jnp.asarray(gt), jnp.asarray(valid),
                                        images=jnp.asarray(images), **kw)
    _close(out, ref)


def test_losses_differentiate_like_jax():
    """The gradient of the multiscale loss with respect to the predictions,
    through the port's autograd and through jax.grad."""
    import jax
    gt = _rand((1, 32, 32, 2), 30, 2.0)
    valid = (np.random.RandomState(31).rand(1, 32, 32) > 0.2).astype(
        np.float32)
    preds = [_rand((1, 32 // s, 32 // s, 2), 32 + s) for s in (4, 8)]
    tp = [_t(p).requires_grad_() for p in preds]
    TL.multiscale_supervised_loss(tp, _t(gt), _t(valid)).backward()
    ref = jax.grad(lambda ps: JL.multiscale_supervised_loss(
        ps, jnp.asarray(gt), jnp.asarray(valid)))([jnp.asarray(p)
                                                   for p in preds])
    for t, r in zip(tp, ref):
        _close(t.grad, r)
