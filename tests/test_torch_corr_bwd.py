"""The port's correlation backward on the CPU: the plain version
(``correlation_bwd_plain``) against the JAX package's gather-form backward
(``pallas_corr._corr_bwd_lax``) and against ``jax.grad`` of
``correlation_lax``; ``CorrelationFn`` against autograd through the plain
forward; the routing in ``correlation()``; and the backward kernel's
wrapper checks, which hold before any build.  The kernel itself is held
against the plain version on the card in ``tests/test_torch_cuda.py``."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opticalflow_tpu.ops.correlation import correlation_lax
from opticalflow_tpu.ops.pallas_corr import _corr_bwd_lax
from opticalflow_tpu_torch.ops import corr_cuda
from opticalflow_tpu_torch.ops.correlation import (CorrelationFn,
                                                   correlation,
                                                   correlation_bwd_plain,
                                                   correlation_plain)
from test_torch_corr import _FakeCuda

# (B, H, W, C): H=8 and W=12 not multiples of the kernel's 8x32 tile, C=3
# and 7 ragged against its 4-channel stages; W=1 and H=1
SHAPES = [(1, 8, 12, 3), (2, 5, 14, 7), (1, 1, 9, 4), (1, 9, 1, 4)]
TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _inputs(shape, seed=0):
    b, h, w, _ = shape
    return (_rand(shape, seed), _rand(shape, seed + 1),
            _rand((b, h, w, 81), seed + 2))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_jax_gather_form(shape):
    f1, f2, g = _inputs(shape)
    d1, d2 = correlation_bwd_plain(_nchw(f1), _nchw(f2), _nchw(g))
    r1, r2 = _corr_bwd_lax(4, jnp.asarray(f1), jnp.asarray(f2),
                           jnp.asarray(g))
    assert d1.dtype == d2.dtype == torch.float32
    # float32 sums of 81 products in the same order
    np.testing.assert_allclose(_nhwc(d1), np.asarray(r1), **TOL)
    np.testing.assert_allclose(_nhwc(d2), np.asarray(r2), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_jax_grad_of_correlation_lax(shape):
    f1, f2, g = _inputs(shape, seed=3)
    _, vjp = jax.vjp(lambda a, b: correlation_lax(
        a, b, pad_size=4, max_displacement=4), jnp.asarray(f1),
        jnp.asarray(f2))
    r1, r2 = vjp(jnp.asarray(g))
    d1, d2 = correlation_bwd_plain(_nchw(f1), _nchw(f2), _nchw(g))
    # the same function, differentiated by JAX's transpose rules
    np.testing.assert_allclose(_nhwc(d1), np.asarray(r1), **TOL)
    np.testing.assert_allclose(_nhwc(d2), np.asarray(r2), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_correlation_fn_matches_autograd_through_plain(shape):
    f1, f2, g = (_nchw(a) for a in _inputs(shape, seed=6))
    a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    out = CorrelationFn.apply(a1, a2, 4)
    got = torch.autograd.grad(out, (a1, a2), g)
    p1, p2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    ref_out = correlation_plain(p1, p2, pad_size=4, max_displacement=4)
    ref = torch.autograd.grad(ref_out, (p1, p2), g)
    torch.testing.assert_close(out, ref_out.detach(), atol=0, rtol=0)
    for d, r in zip(got, ref):
        # float32 sums of 81 products in another order
        torch.testing.assert_close(d, r, **TOL)


def test_correlation_fn_keeps_bfloat16():
    """bfloat16 inputs: volume and gradients in bfloat16, float32 sums."""
    f1, f2, g = (_nchw(a).bfloat16() for a in _inputs((1, 6, 10, 5), 9))
    a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    out = correlation(a1, a2, pad_size=4, max_displacement=4)
    assert out.dtype == torch.bfloat16
    d1, d2 = torch.autograd.grad(out, (a1, a2), g)
    r1, r2 = correlation_bwd_plain(f1, f2, g)
    assert d1.dtype == d2.dtype == torch.bfloat16
    assert torch.equal(d1, r1) and torch.equal(d2, r2)


def test_correlation_routes_through_the_function_only_under_grad():
    f1, f2 = (_nchw(_rand((1, 6, 10, 5), s)) for s in (10, 11))
    out = correlation(f1.requires_grad_(), f2, pad_size=4,
                      max_displacement=4)
    assert type(out.grad_fn).__name__ == "CorrelationFnBackward"
    with torch.no_grad():
        assert correlation(f1, f2).grad_fn is None
    # other configurations differentiate the plain version directly
    out = correlation(f1, f2, pad_size=4, kernel_size=3,
                      max_displacement=4)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ != "CorrelationFnBackward"


@pytest.mark.parametrize("bad", ["cpu", "g_shape", "g_dtype", "dtype",
                                 "noncontiguous_g", "md", "grad"])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(bad, monkeypatch):
    """Checks run before any build or launch, so they hold on the CPU."""
    def no_build(*a, **k):
        raise AssertionError("a refused input reached the library")
    monkeypatch.setattr(corr_cuda._bwd_kernel, "load", no_build)
    f = torch.zeros(1, 3, 8, 8)
    g = torch.zeros(1, 81, 8, 8)
    kw = {}
    expected = (ValueError, TypeError)
    if bad == "g_shape":
        g = g[:, :80]
    elif bad == "g_dtype":
        g = g.bfloat16()
    elif bad == "dtype":
        f, g = f.double(), g.double()
    elif bad == "md":
        kw = {"max_displacement": 6}
    elif bad == "grad":
        f, expected = f.clone().requires_grad_(), RuntimeError
    if bad == "cpu":
        args = (f, f, g)
    else:
        args = (_FakeCuda(f), _FakeCuda(f),
                _FakeCuda(g, contiguous=bad != "noncontiguous_g"))
    before = corr_cuda.correlation_bwd_cuda.launches
    with pytest.raises(expected):
        corr_cuda.correlation_bwd_cuda(*args, **kw)
    assert corr_cuda.correlation_bwd_cuda.launches == before


def test_forward_wrapper_points_at_correlation_under_grad():
    f = _FakeCuda(torch.zeros(1, 3, 8, 8).requires_grad_())
    with pytest.raises(RuntimeError, match="forward-only.*correlation\\(\\)"):
        corr_cuda.correlation_cuda(f, f)
