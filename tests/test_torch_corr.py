"""The port's correlation (plain PyTorch version, dispatcher, CUDA wrapper)
against the JAX package's ``correlation_lax`` and its Pallas kernel, the
latter in interpret mode as ``tests/test_pallas_corr.py`` runs it.  The
kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opticalflow_tpu.ops.correlation import correlation_lax
from opticalflow_tpu.ops.pallas_corr import _corr_fwd_impl
from opticalflow_tpu_torch.ops import corr_cuda
from opticalflow_tpu_torch.ops.correlation import (correlation,
                                                   correlation_plain)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(a):
    """NHWC numpy → NCHW torch (the port's layout)."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


# H=14 is not a multiple of 8 (the L5 shape of a 448x1024 frame); H=7 is
# smaller than the 9x9 displacement window (L6)
@pytest.mark.parametrize("shape", [(1, 8, 16, 4), (2, 14, 24, 7),
                                   (1, 7, 16, 5)])
def test_plain_matches_correlation_lax(shape):
    f1, f2 = _rand(shape, 1), _rand(shape, 2)
    ref = correlation_lax(jnp.asarray(f1), jnp.asarray(f2), pad_size=4,
                          max_displacement=4)
    out = correlation_plain(_nchw(f1), _nchw(f2), pad_size=4,
                            max_displacement=4)
    assert out.dtype == torch.float32
    # float32 sums in another order: the Pallas kernel's own bound
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("k,md,s1,s2,pad", [(3, 4, 1, 1, 4),   # k=3
                                            (1, 4, 1, 2, 4),   # stride2=2
                                            (1, 4, 2, 2, 4),   # stride1=2
                                            (1, 4, 1, 1, 2),   # pad < md
                                            (3, 2, 1, 1, 1)])  # pad < kr+md
def test_plain_non_hot_configs_match_lax(k, md, s1, s2, pad):
    shape = (1, 20, 24, 3)
    f1, f2 = _rand(shape, 3), _rand(shape, 4)
    kw = dict(pad_size=pad, kernel_size=k, max_displacement=md, stride1=s1,
              stride2=s2)
    ref = np.asarray(correlation_lax(jnp.asarray(f1), jnp.asarray(f2), **kw))
    out = correlation(_nchw(f1), _nchw(f2), **kw)   # dispatcher, CPU
    assert _nhwc(out).shape == ref.shape
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("force_windowed", [False, True])
@pytest.mark.parametrize("shape", [(1, 8, 16, 4), (2, 16, 24, 7)])
def test_plain_matches_pallas_kernel(shape, force_windowed):
    """Both Pallas strategies (K1 resident, K2 windowed) in interpret mode."""
    f1, f2 = _rand(shape, 5), _rand(shape, 6)
    ref = _corr_fwd_impl(jnp.asarray(f1), jnp.asarray(f2), 4, True,
                         force_windowed)
    out = correlation(_nchw(f1), _nchw(f2), pad_size=4, max_displacement=4)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_bf16_inputs_match_jax_bf16():
    shape = (1, 8, 16, 4)
    f1, f2 = _rand(shape, 7), _rand(shape, 8)
    ref = _corr_fwd_impl(jnp.asarray(f1).astype(jnp.bfloat16),
                         jnp.asarray(f2).astype(jnp.bfloat16), 4, True)
    assert ref.dtype == jnp.bfloat16
    out = correlation(_nchw(f1).bfloat16(), _nchw(f2).bfloat16(),
                      pad_size=4, max_displacement=4)
    # stored in the input dtype, like the kernel it stands for
    assert out.dtype == torch.bfloat16
    # the bf16 tolerance of tests/test_pallas_corr.py
    np.testing.assert_allclose(_nhwc(out),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """On the CPU the dispatcher runs the plain version because the tensor
    lies on the CPU, even with use_cuda=True; the kernel is not touched."""
    def boom(*a, **k):
        raise AssertionError("kernel called for a CPU tensor")
    monkeypatch.setattr(corr_cuda, "correlation_cuda", boom)
    f = _nchw(_rand((1, 8, 8, 3), 9))
    assert correlation(f, f, use_cuda=True).shape == (1, 81, 8, 8)


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "md"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """Checks run before any build or launch, so they hold on the CPU."""
    f = torch.zeros(1, 3, 8, 8)
    kw = {}
    if bad == "cpu":
        args = (f, f)
    elif bad == "dtype":
        args = (f.double(), f.double())
    elif bad == "shape":
        args = (f, f[:, :2])
    else:
        args, kw = (f, f), {"max_displacement": 6}
    if bad != "cpu":
        # present the tensors as CUDA ones without a card: the device check
        # passes, the check under test must fire
        args = tuple(_FakeCuda(a) for a in args)
    before = corr_cuda.correlation_cuda.launches
    with pytest.raises((ValueError, TypeError)):
        corr_cuda.correlation_cuda(*args, **kw)
    assert corr_cuda.correlation_cuda.launches == before


class _FakeCuda:
    """Just enough of a CUDA tensor for the wrapper's argument checks."""

    def __init__(self, t):
        self._t = t
        self.is_cuda = True
        self.device = torch.device("cuda", 0)
        self.dtype = t.dtype
        self.shape = t.shape
        self.requires_grad = False

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return True
