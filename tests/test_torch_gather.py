"""The port's row gather (plain PyTorch version, dispatcher, CUDA wrapper)
against ``jnp.take(x, idx, axis=0)``, the function the JAX package's
``scripts/probe_gather.py`` kernels compute.  The kernel itself is held
against the plain version on the card in ``tests/test_torch_cuda.py``."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opticalflow_tpu_torch.ops import gather
from opticalflow_tpu_torch.ops.gather import row_gather, row_gather_plain
from opticalflow_tpu_torch.scripts import probe_gather


def _take(x, idx):
    return np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx).reshape(-1),
                               axis=0))


@pytest.mark.parametrize("idx_shape", ["column", "flat"])
def test_plain_matches_jnp_take_at_the_probe_shape(idx_shape):
    """The probe's shape and seeds, with some indices made negative (they
    wrap) and some out of range either way (rows of NaN)."""
    n, m, c = probe_gather.N, probe_gather.M, probe_gather.C
    x = np.random.RandomState(0).randn(n, c).astype(np.float32)
    idx = np.random.RandomState(1).randint(0, n, (m, 1)).astype(np.int32)
    idx[::7] -= n                       # [-N, 0): wrap
    idx[3::11] += n                     # >= N: NaN
    idx[5::13] = -n - 1 - idx[5::13]    # < -N: NaN
    if idx_shape == "flat":
        idx = idx[:, 0]
    ref = _take(x, idx)
    out = row_gather_plain(torch.from_numpy(x), torch.from_numpy(idx))
    assert out.shape == (m, c) and out.dtype == torch.float32
    assert np.isnan(ref).all(axis=1).sum() > 100
    np.testing.assert_array_equal(out.numpy(), ref)   # NaN == NaN here


@pytest.mark.parametrize("n,m,c", [(1, 5, 3), (37, 300, 21), (5, 1, 128)])
def test_plain_matches_jnp_take_at_odd_shapes(n, m, c):
    rng = np.random.RandomState(n + m + c)
    x = rng.randn(n, c).astype(np.float32)
    idx = rng.randint(-2 * n, 2 * n, (m,)).astype(np.int32)
    out = row_gather(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), _take(x, idx))


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel called for a CPU tensor")
    before = gather.row_gather_cuda.launches
    monkeypatch.setattr(gather, "row_gather_cuda", boom)
    x = torch.randn(4, 8)
    out = gather.row_gather(x, torch.tensor([3, -1, 0], dtype=torch.int32))
    torch.testing.assert_close(out, x[[3, 3, 0]])
    monkeypatch.undo()
    assert gather.row_gather_cuda.launches == before


@pytest.mark.parametrize("bad", ["cpu", "dtype", "idx_dtype", "x_shape",
                                 "idx_shape", "idx_rank", "other_device",
                                 "noncontiguous", "idx_noncontiguous",
                                 "grad", "half"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, monkeypatch):
    """Checks run before any build or launch, so they hold on the CPU."""
    def no_build(*a, **k):
        raise AssertionError("a refused input reached the library")
    monkeypatch.setattr(gather._kernel, "load", no_build)
    x = torch.zeros(8, 4)
    idx = torch.zeros(5, 1, dtype=torch.int32)
    fx, fi = {}, {}
    expected = (ValueError, TypeError)
    if bad == "dtype":
        x = x.double()
    elif bad == "half":
        x = x.bfloat16()
    elif bad == "idx_dtype":
        idx = idx.long()       # int64 indices
    elif bad == "x_shape":
        x = x[None]
    elif bad == "idx_shape":
        idx = idx.reshape(1, 5)
    elif bad == "idx_rank":
        idx = idx.reshape(5, 1, 1)
    elif bad == "other_device":
        fi = {"device": torch.device("cuda", 1)}
    elif bad == "noncontiguous":
        fx = {"contiguous": False}
    elif bad == "idx_noncontiguous":
        fi = {"contiguous": False}
    elif bad == "grad":
        x, expected = x.requires_grad_(), RuntimeError
    args = (x, idx) if bad == "cpu" else (_FakeCuda(x, **fx),
                                          _FakeCuda(idx, **fi))
    before = gather.row_gather_cuda.launches
    with pytest.raises(expected):
        gather.row_gather_cuda(*args)
    assert gather.row_gather_cuda.launches == before


def test_probe_runs_on_the_cpu(capsys):
    assert probe_gather.main(["--device", "cpu"]) == {}
    assert "correct=True" in capsys.readouterr().out


class _FakeCuda:
    """Just enough of a CUDA tensor for the wrapper's argument checks."""

    def __init__(self, t, device=None, contiguous=True):
        self._t = t
        self.is_cuda = True
        self.device = device or torch.device("cuda", 0)
        self.dtype = t.dtype
        self.shape = t.shape
        self.requires_grad = t.requires_grad
        self._contiguous = contiguous

    def dim(self):
        return self._t.dim()

    def reshape(self, *shape):
        return _FakeCuda(self._t.reshape(*shape), self.device,
                         self._contiguous)

    def is_contiguous(self):
        return self._contiguous
