"""Tests of the port that need the card: the hand-written CUDA kernel
against its plain PyTorch version, and the model on the GPU against the
same model on the CPU.  They skip where ``torch.cuda.is_available()`` is
False.  This file imports neither JAX nor the JAX package, so the GPU
machine (which has no JAX) runs it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from opticalflow_tpu_torch.ops import corr_cuda
from opticalflow_tpu_torch.ops.correlation import (correlation,
                                                   correlation_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the correlation kernel has no CPU "
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
