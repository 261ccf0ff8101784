"""Tests of the port that need the card: the hand-written CUDA kernels
(correlation, fused warp⊕correlation, row gather) against their plain
PyTorch versions, and the model on the GPU against the same model on the
CPU.  They skip where ``torch.cuda.is_available()`` is False.  This file
imports neither JAX nor the JAX package, so the GPU machine (which has no
JAX) runs it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch.ops import corr_cuda, fused_warpcorr, gather
from opticalflow_tpu_torch.ops.correlation import (correlation,
                                                   correlation_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32, 112, 256), (2, 196, 7, 16),
                                   (1, 20, 9, 45), (1, 32, 272, 480)])
def test_kernel_matches_plain_on_the_card(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    f1 = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    f2 = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    before = corr_cuda.correlation_cuda.launches
    out = correlation(f1, f2, pad_size=4, max_displacement=4)
    assert corr_cuda.correlation_cuda.launches == before + 1
    assert out.dtype == dtype
    ref = correlation_plain(f1, f2, pad_size=4, max_displacement=4)
    if dtype == torch.float32:
        # float32 sums of <=196 products in another order
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:   # one bf16 rounding of the float32 sum, doubled for the order
        err = (out.float() - ref).abs()
        assert bool((err <= ref.abs() * 2.0 ** -8 + 1e-6).all())


def test_kernel_refuses_autograd(cuda_device):
    f = torch.randn(1, 4, 8, 8, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        corr_cuda.correlation_cuda(f, f)


@pytest.mark.parametrize("thr", [0.9999, 0.999])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,flow_px", [((1, 32, 112, 256), 3.0),
                                           ((2, 20, 9, 45), 20.0)])
def test_fused_warp_corr_matches_plain_on_the_card(cuda_device, shape,
                                                   flow_px, dtype, thr):
    b, c, h, w = shape
    g = torch.Generator(device=cuda_device).manual_seed(1)
    f1 = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    f2 = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    flow = torch.randn((b, 2, h, w), generator=g, device=cuda_device) * flow_px
    before = fused_warpcorr.fused_warp_corr_cuda.launches
    out = fused_warpcorr.fused_warp_corr(f1, f2, flow, mask_threshold=thr)
    assert fused_warpcorr.fused_warp_corr_cuda.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, 81, h, w)
    # the plain version in float32 (its warp and sums are float32 for
    # either dtype), before the final rounding to the features' dtype
    ref = fused_warpcorr.fused_warp_corr_plain(f1.float(), f2.float(), flow,
                                               mask_threshold=thr)
    err = (out.float() - ref).abs()
    if dtype == torch.float32:
        # float32 sums of <=32 products and of the 4 corner terms in
        # another order; the mask is computed with the plain version's
        # rounding, so no pixel flips
        assert float(err.max()) <= 1e-4
    else:   # one bf16 rounding of the float32 sum, doubled for the order
        assert bool((err <= ref.abs() * 2.0 ** -8 + 1e-5).all())


def test_fused_warp_corr_refuses_autograd(cuda_device):
    f = torch.randn(1, 4, 8, 8, device=cuda_device, requires_grad=True)
    flow = torch.zeros(1, 2, 8, 8, device=cuda_device)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_warpcorr.fused_warp_corr_cuda(f, f, flow)


@pytest.mark.parametrize("n,m,c", [(2048, 4096, 128), (37, 300, 21),
                                   (5, 64, 3)])
def test_row_gather_matches_plain_on_the_card(cuda_device, n, m, c):
    """Exact, NaN rows included: wrapped negative and out-of-range indices
    among the valid ones; C=21 and C=3 take the scalar path."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((n, c), generator=g, device=cuda_device)
    idx = torch.randint(-2 * n, 2 * n, (m, 1), generator=g,
                        device=cuda_device, dtype=torch.int32)
    before = gather.row_gather_cuda.launches
    out = gather.row_gather(x, idx)
    assert gather.row_gather_cuda.launches == before + 1
    ref = gather.row_gather_plain(x, idx)
    assert torch.isnan(ref).any()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref))


@pytest.mark.parametrize("dst", [(12, 40), (15, 1), (3, 5)])
def test_antialiased_flow_resize_on_gpu_matches_cpu(cuda_device, dst):
    """The tiny-frame resize of the engine's resize mode, on the card."""
    from opticalflow_tpu_torch.ops.resize import resize_linear_antialiased
    q = torch.from_numpy(
        np.random.RandomState(3).randn(2, 2, 16, 32).astype(np.float32))
    out = resize_linear_antialiased(q.to(cuda_device), *dst)
    torch.testing.assert_close(out.cpu(), resize_linear_antialiased(q, *dst),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("variant", ["new", "old"])
def test_model_on_gpu_matches_cpu(cuda_device, variant):
    """Same weights and input: GPU (kernel, cuDNN with TF32 off) against
    CPU (plain correlation), at the parity bound of the model tests."""
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    cpu = PWCDCNet(variant=variant,
                   generator=torch.Generator().manual_seed(0))
    for p in cpu.parameters():
        p.data *= 0.5
    gpu = PWCDCNet(variant=variant)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda_device).eval()
    x = torch.from_numpy(
        np.random.RandomState(0).rand(2, 6, 128, 192).astype(np.float32))
    before = corr_cuda.correlation_cuda.launches
    with torch.inference_mode():
        ref = cpu.eval()(x, train=True)
        out = gpu(x.to(cuda_device), train=True)
    assert corr_cuda.correlation_cuda.launches == before + 5
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.cpu().numpy(), r.numpy(), atol=2e-4,
                                   rtol=1e-3)
