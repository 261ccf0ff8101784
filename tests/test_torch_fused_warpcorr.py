"""The port's fused warp⊕correlation (plain PyTorch version, dispatcher,
CUDA wrapper) against the JAX package's probe ``scripts/
probe_fused_warpcorr.py``: its XLA-side precompute ``_prep_gather`` and its
composed reference ``warp_with_mask → correlation_lax``.  The kernel itself
is held against the plain version on the card in
``tests/test_torch_cuda.py``."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opticalflow_tpu.ops.correlation import correlation_lax
from opticalflow_tpu.ops.warp import warp_with_mask as jwarp_with_mask
from opticalflow_tpu_torch.ops import fused_warpcorr
from opticalflow_tpu_torch.ops.correlation import correlation_plain
from opticalflow_tpu_torch.ops.fused_warpcorr import (fused_warp_corr,
                                                      fused_warp_corr_plain,
                                                      prep_gather)
from opticalflow_tpu_torch.ops.warp import warp_with_mask

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import probe_fused_warpcorr as jprobe  # noqa: E402

MD = 4


def _inputs(b, h, w, c, flow_px, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, c).astype(np.float32),
            rng.randn(b, h, w, c).astype(np.float32),
            (rng.randn(b, h, w, 2) * flow_px).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("thr", [0.9999, 0.999])
@pytest.mark.parametrize("b,h,w,flow_px", [(2, 16, 32, 5.0), (1, 13, 29, 5.0),
                                           (2, 16, 32, 0.0)])
def test_prep_gather_matches_jax(b, h, w, flow_px, thr):
    """The same sample points: equal packed corner indices, weights within
    1e-6 (the JAX precompute pads md rows, which the port does not)."""
    _, _, flow = _inputs(b, h, w, 1, flow_px, 0)
    idx, wv = jprobe._prep_gather(jnp.asarray(flow), h, w,
                                  mask_threshold=thr)
    x0, y0, ours = prep_gather(_nchw(flow), h, w, thr)
    assert x0.dtype == y0.dtype == torch.int32
    assert ours.dtype == torch.float32 and ours.shape == (b, 4, h, w)
    packed = ((y0.long() + 1).clamp(0, h) * (w + 1)
              + (x0.long() + 1).clamp(0, w))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(idx)[:, MD:-MD])
    np.testing.assert_allclose(_nhwc(ours), np.asarray(wv)[:, MD:-MD],
                               atol=1e-6, rtol=0)
    if flow_px:
        # the mask really zeroes some pixels at these flows
        assert (ours.sum(1) == 0).any()


@pytest.mark.parametrize("b,h,w,c", [(2, 16, 32, 8), (1, 13, 29, 6)])
def test_plain_matches_jax_composed_lax(b, h, w, c):
    """At the JAX probe test's shape and flow (×5 px), and at a ragged
    shape; its bound (tests/test_fused_probe.py)."""
    f1, f2, flow = _inputs(b, h, w, c, 5.0, 1)
    ref = jprobe.composed_lax(jnp.asarray(f1), jnp.asarray(f2),
                              jnp.asarray(flow))
    out = fused_warp_corr_plain(_nchw(f1), _nchw(f2), _nchw(flow))
    assert out.dtype == torch.float32 and out.shape == (b, 81, h, w)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_plain_old_threshold_matches_jax():
    """thr 0.999 (the old variant) against JAX warp_with_mask(…, 0.999) →
    correlation_lax."""
    f1, f2, flow = _inputs(1, 13, 29, 6, 5.0, 2)
    warped = jwarp_with_mask(jnp.asarray(f2), jnp.asarray(flow),
                             mask_threshold=0.999)
    ref = correlation_lax(jnp.asarray(f1), warped, max_displacement=MD)
    out = fused_warp_corr_plain(_nchw(f1), _nchw(f2), _nchw(flow),
                                mask_threshold=0.999)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("thr", [0.9999, 0.999])
def test_plain_matches_ports_composed_path(thr):
    """The kernel's formulation against the port's own warp (grid_sample)
    then correlation: another rounding of the same sample points."""
    f1, f2, flow = _inputs(2, 12, 20, 5, 3.0, 3)
    ref = correlation_plain(_nchw(f1), warp_with_mask(
        _nchw(f2), _nchw(flow), mask_threshold=thr))
    out = fused_warp_corr_plain(_nchw(f1), _nchw(f2), _nchw(flow),
                                mask_threshold=thr)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_bf16_features_keep_float32_warp():
    """bf16 features: gathered and combined in float32, the result cast to
    bf16 once (the f32 result of the same bf16 values, rounded)."""
    f1, f2, flow = _inputs(1, 10, 14, 4, 2.0, 4)
    b1, b2 = _nchw(f1).bfloat16(), _nchw(f2).bfloat16()
    out = fused_warp_corr_plain(b1, b2, _nchw(flow))
    assert out.dtype == torch.bfloat16
    ref = fused_warp_corr_plain(b1.float(), b2.float(), _nchw(flow))
    torch.testing.assert_close(out, ref.bfloat16(), atol=0, rtol=0)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """The dispatcher runs the plain version because the tensors lie on the
    CPU; the kernel's wrapper is not touched and its count stays put."""
    def boom(*a, **k):
        raise AssertionError("kernel called for a CPU tensor")
    before = fused_warpcorr.fused_warp_corr_cuda.launches
    monkeypatch.setattr(fused_warpcorr, "fused_warp_corr_cuda", boom)
    f1, f2, flow = _inputs(1, 8, 8, 3, 1.0, 5)
    out = fused_warp_corr(_nchw(f1), _nchw(f2), _nchw(flow))
    assert out.shape == (1, 81, 8, 8)
    monkeypatch.undo()
    assert fused_warpcorr.fused_warp_corr_cuda.launches == before


@pytest.mark.parametrize("bad", ["cpu", "dtype", "flow_dtype", "shape",
                                 "ndim", "grad", "dtype_mismatch",
                                 "f2_shape", "flow_channels", "other_device",
                                 "noncontiguous", "flow_grad"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, monkeypatch):
    """Checks run before any build or launch, so they hold on the CPU."""
    def no_build(*a, **k):
        raise AssertionError("a refused input reached the library")
    monkeypatch.setattr(fused_warpcorr._kernel, "load", no_build)
    f = torch.zeros(1, 3, 8, 8)
    flow = torch.zeros(1, 2, 8, 8)
    args = (f, f, flow)
    fake = [{}, {}, {}]
    if bad == "dtype":
        args = (f.double(), f.double(), flow)
    elif bad == "dtype_mismatch":
        args = (f, f.bfloat16(), flow)
    elif bad == "flow_dtype":
        args = (f, f, flow.double())
    elif bad == "shape":
        args = (f, f, flow[:, :, :4])
    elif bad == "f2_shape":
        args = (f, f[:, :2], flow)
    elif bad == "flow_channels":
        args = (f, f, torch.zeros(1, 3, 8, 8))
    elif bad == "ndim":
        args = (f[0], f[0], flow)
    elif bad == "grad":
        args = (f.clone().requires_grad_(), f, flow)
    elif bad == "flow_grad":
        args = (f, f, flow.clone().requires_grad_())
    elif bad == "other_device":
        fake[2] = {"device": torch.device("cuda", 1)}
    elif bad == "noncontiguous":
        fake[1] = {"contiguous": False}
    if bad != "cpu":
        # present the tensors as CUDA ones without a card: the device check
        # passes, the check under test must fire
        args = tuple(_FakeCuda(a, **k) for a, k in zip(args, fake))
    before = fused_warpcorr.fused_warp_corr_cuda.launches
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        fused_warpcorr.fused_warp_corr_cuda(*args)
    assert fused_warpcorr.fused_warp_corr_cuda.launches == before


@pytest.mark.parametrize("tile,split", [(8, 0), (-16, 0), (24, 1), (0, 9),
                                        (16, -1), (32, 16), ("16", 0),
                                        (0, None)])
def test_wrapper_rejects_a_bad_tile_or_split_before_any_build(tile, split,
                                                              monkeypatch):
    """On tensors the kernel would take, a tile other than 0/16/32 or a
    split outside 0..8 is refused in Python: nothing is built or launched."""
    def no_build(*a, **k):
        raise AssertionError("a refused plan reached the library")
    monkeypatch.setattr(fused_warpcorr._kernel, "load", no_build)
    monkeypatch.setattr(fused_warpcorr, "load_library", no_build)
    f = _FakeCuda(torch.zeros(1, 3, 8, 8))
    flow = _FakeCuda(torch.zeros(1, 2, 8, 8))
    before = fused_warpcorr.fused_warp_corr_cuda.launches
    with pytest.raises(ValueError, match="tile in .* split"):
        fused_warpcorr.fused_warp_corr_cuda(f, f, flow, tile=tile,
                                            split=split)
    with pytest.raises(ValueError, match="tile in .* split"):
        fused_warpcorr.launch_plan(1, 3, 8, 8, torch.float32, tile=tile,
                                   split=split)
    assert fused_warpcorr.fused_warp_corr_cuda.launches == before


@pytest.mark.parametrize("tile,split", [(16, 0), (0, 2), (32, 8)])
def test_cpu_tensors_refuse_a_forced_plan(tile, split):
    """tile= and split= steer the kernel only; the plain version has no
    plan, so on CPU tensors they raise rather than being dropped."""
    f1, f2, flow = _inputs(1, 8, 8, 3, 1.0, 6)
    args = (_nchw(f1), _nchw(f2), _nchw(flow))
    with pytest.raises(ValueError, match="steer the CUDA kernel only"):
        fused_warp_corr(*args, tile=tile, split=split)
    # 0, 0 is "the kernel's own choice": no plan is forced, the plain
    # version runs
    out = fused_warp_corr(*args, tile=0, split=0)
    torch.testing.assert_close(out, fused_warp_corr_plain(*args), atol=0,
                               rtol=0)


def test_launch_plan_binds_the_plan_entry_point_once(monkeypatch):
    """``launch_plan`` goes through ``fused_warp_corr_plan`` of the kernel's
    own library and reports what it wrote."""
    import ctypes
    calls = []

    def fake_plan(b, c, h, w, md, code, tile, split, device, plan):
        calls.append((b, c, h, w, md, code, tile, split, device))
        for i, v in enumerate((16, 7, 4, 16, 288, 41472)):
            plan[i] = v
        return 0 if tile != 32 else 1

    class Lib:
        fused_warp_corr_plan = staticmethod(fake_plan)

    loaded = []
    monkeypatch.setattr(fused_warpcorr, "_plan_fn", None)
    monkeypatch.setattr(fused_warpcorr, "load_library",
                        lambda name: loaded.append(name) or Lib)
    p = fused_warpcorr.launch_plan(2, 64, 56, 16, torch.bfloat16, split=4)
    assert loaded == ["fused_warp_corr"]
    assert calls == [(2, 64, 56, 16, 4, 1, 0, 4, 0)]
    assert p == {"tile": [8, 16], "tiles": 7, "split": 4,
                 "channels_per_split": 16, "threads": 288,
                 "smem_bytes": 41472, "grid": [7, 4, 2]}
    with pytest.raises(ValueError, match="cudaError 1"):
        fused_warpcorr.launch_plan(2, 64, 56, 16, torch.float32, tile=32)
    assert loaded == ["fused_warp_corr"]          # bound once
    assert fused_warpcorr._kernel._argtypes[-4:-2] == [ctypes.c_int] * 2


def test_probe_runs_on_the_cpu(capsys):
    from opticalflow_tpu_torch.scripts import probe_fused_warpcorr
    assert probe_fused_warpcorr.main(["--device", "cpu"]) == []
    out = capsys.readouterr().out
    assert "correctness vs composed" in out and "timing skipped" in out
    first = out.splitlines()[0]
    assert first.startswith("correctness vs composed (2x16x32x8 f32, cpu)")
    assert float(first.rsplit(" ", 1)[1]) < 1e-4


@pytest.mark.parametrize("dtype,rate", [(torch.float32, 67e12),
                                        (torch.bfloat16, 989e12)])
def test_probe_bound_uses_the_peak_of_the_operands_type(dtype, rate):
    """The fused call's bound: bytes in the features' dtype, operations at
    the float32 rate or, for bfloat16 operands, the tensor cores' rate."""
    from opticalflow_tpu_torch.scripts.probe_fused_warpcorr import fused_bound
    b, h, w, c = 8, 56, 128, 64
    size = 4 if dtype == torch.float32 else 2
    t_bytes = ((2 * c + 81) * size + 8) * b * h * w / 3.35e12
    t_ops = (2 * 81 + 8) * b * c * h * w / rate
    ms, by = fused_bound(b, h, w, c, dtype)
    assert ms == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


class _FakeCuda:
    """Just enough of a CUDA tensor for the wrapper's argument checks."""

    def __init__(self, t, device=None, contiguous=True):
        self.is_cuda = True
        self.device = device or torch.device("cuda", 0)
        self.dtype = t.dtype
        self.shape = t.shape
        self.requires_grad = t.requires_grad
        self._dim = t.dim()
        self._contiguous = contiguous

    def dim(self):
        return self._dim

    def is_contiguous(self):
        return self._contiguous
