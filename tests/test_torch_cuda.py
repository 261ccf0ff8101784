"""Tests of the port that need the card: the hand-written CUDA kernels
(correlation forward and backward, fused warp⊕correlation, row gather)
against their plain PyTorch versions, the model on the GPU against the same
model on the CPU, and a train step through the kernels against one through
the plain correlation.  They skip where ``torch.cuda.is_available()`` is False.  This file
imports neither JAX nor the JAX package, so the GPU machine (which has no
JAX) runs it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
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


def _corr_inputs(device, shape, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device).to(dtype)
                 for _ in range(2))


def _assert_corr_close(out, f1, f2):
    ref = correlation_plain(f1, f2, pad_size=4, max_displacement=4)
    assert out.dtype == f1.dtype and out.shape == ref.shape
    if f1.dtype == torch.float32:
        # float32 sums of <=196 products in another order
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:   # one bf16 rounding of the float32 sum, doubled for the order
        err = (out.float() - ref).abs()
        assert bool((err <= ref.abs() * 2.0 ** -8 + 1e-6).all())


# C in {1, 17, 20, 196}: the channel split and the last chunk are ragged;
# W in {30, 45}: no 16-byte copies; (8, 196, 7, 16): B=8 at level 6
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 9, 45), (2, 17, 9, 45),
                                   (1, 20, 9, 45), (1, 196, 17, 30),
                                   (1, 17, 28, 64), (1, 20, 14, 32),
                                   (8, 196, 7, 16)])
@pytest.mark.parametrize("tile,split", [(0, 0), (16, 1), (16, 8), (32, 3),
                                        (32, 8)])
def test_kernel_matches_plain_at_every_tile_and_split(cuda_device, shape,
                                                      dtype, tile, split):
    """The kernel's own choice, and tiles and splits forced on it: ranks
    with no channel at all (C=1 split 8), an odd cluster size."""
    f1, f2 = _corr_inputs(cuda_device, shape, dtype)
    out = corr_cuda.correlation_cuda(f1, f2, tile=tile, split=split)
    _assert_corr_close(out, f1, f2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_a_base_pointer_off_by_one_element(cuda_device, dtype):
    """A tensor whose base is not 16-byte aligned takes the narrow path."""
    shape = (1, 20, 16, 64)
    n = 20 * 16 * 64
    g = torch.Generator(device=cuda_device).manual_seed(5)
    buf1 = torch.randn(n + 1, generator=g, device=cuda_device).to(dtype)
    buf2 = torch.randn(n + 1, generator=g, device=cuda_device).to(dtype)
    f1, f2 = buf1[1:].view(shape), buf2[1:].view(shape)
    assert f1.data_ptr() % 16 != 0 and f1.is_contiguous()
    out = corr_cuda.correlation_cuda(f1, f2)
    _assert_corr_close(out, f1, f2)
    # the aligned path on the same values gives the same bits
    assert torch.equal(out, corr_cuda.correlation_cuda(f1.clone(),
                                                       f2.clone()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64, 56, 128), (1, 196, 7, 16),
                                   (8, 128, 14, 32)])
def test_kernel_gives_the_same_bits_twice(cuda_device, shape, dtype):
    """The channel split is reduced in a fixed order: no atomics."""
    f1, f2 = _corr_inputs(cuda_device, shape, dtype, seed=6)
    plan = corr_cuda.launch_plan(*shape, dtype)
    assert plan["split"] > 1, plan
    first = corr_cuda.correlation_cuda(f1, f2)
    for _ in range(3):
        assert torch.equal(first, corr_cuda.correlation_cuda(f1, f2))


def test_kernel_launches_on_the_current_stream(cuda_device):
    """The stream handle is read at every call: a launch inside
    ``with torch.cuda.stream(side):`` runs on ``side``, behind the work
    queued there."""
    f1, f2 = _corr_inputs(cuda_device, (1, 96, 28, 64), torch.float32, 7)
    eager = corr_cuda.correlation_cuda(f1, f2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a = torch.zeros_like(f1)
        torch.cuda._sleep(20_000_000)     # ~10 ms before the copy lands
        a.copy_(f1)
        out = corr_cuda.correlation_cuda(a, f2)
    side.synchronize()
    assert torch.equal(out, eager)


def test_kernel_is_captured_and_replayed_by_a_cuda_graph(cuda_device):
    f1, f2 = _corr_inputs(cuda_device, (1, 128, 14, 32), torch.float32, 8)
    eager = corr_cuda.correlation_cuda(f1, f2)      # built before capture
    g1, g2 = _corr_inputs(cuda_device, (1, 128, 14, 32), torch.float32, 9)
    other = corr_cuda.correlation_cuda(g1, g2)
    assert not torch.equal(eager, other)
    s1, s2 = f1.clone(), f2.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = corr_cuda.correlation_cuda(s1, s2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    s1.copy_(g1)
    s2.copy_(g2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, other)


def test_fused_and_gather_launch_on_a_side_stream(cuda_device):
    """K3 and K4 through the same launch path, on a stream of the caller's."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    f1, f2 = _corr_inputs(cuda_device, (1, 20, 9, 45), torch.float32, 10)
    flow = torch.randn((1, 2, 9, 45), generator=g, device=cuda_device) * 3
    x = torch.randn((37, 21), generator=g, device=cuda_device)
    idx = torch.randint(-74, 74, (300, 1), generator=g, device=cuda_device,
                        dtype=torch.int32)
    eager3 = fused_warpcorr.fused_warp_corr_cuda(f1, f2, flow)
    eager4 = gather.row_gather_cuda(x, idx)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa, xa = torch.zeros_like(f1), torch.zeros_like(x)
        torch.cuda._sleep(20_000_000)
        fa.copy_(f1)
        xa.copy_(x)
        out3 = fused_warpcorr.fused_warp_corr_cuda(fa, f2, flow)
        out4 = gather.row_gather_cuda(xa, idx)
    side.synchronize()
    assert torch.equal(out3, eager3)
    assert torch.equal(torch.nan_to_num(out4), torch.nan_to_num(eager4))
    assert torch.equal(torch.isnan(out4), torch.isnan(eager4))


def test_launch_plan_fills_the_card_at_every_level(cuda_device):
    """The tile and split the C entry point chooses cover C and the image
    at every level; there is a block for every SM unless the channels
    cannot be split further (8 splits at most, 16 channels each at least)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for h, w, c in ((112, 256, 32), (56, 128, 64), (28, 64, 96),
                    (14, 32, 128), (7, 16, 196), (272, 480, 32),
                    (17, 30, 196), (9, 45, 20)):
        p = corr_cuda.launch_plan(1, c, h, w, torch.float32)
        th, tw = p["tile"]
        assert p["tiles"] == -(-h // th) * -(-w // tw), p
        assert p["split"] * p["channels_per_split"] >= c, p
        assert 1 <= p["split"] <= 8 and p["smem_bytes"] <= 232448, p
        blocks = p["tiles"] * p["split"]
        assert blocks >= sms or 2 * p["split"] > min(8, c // 16), p


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


PLANS = [(0, 0), (16, 1), (16, 8), (32, 3), (32, 8)]


def _fused_inputs(device, shape, dtype, flow_px, seed=0):
    b, _, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    f1 = torch.randn(shape, generator=g, device=device).to(dtype)
    f2 = torch.randn(shape, generator=g, device=device).to(dtype)
    flow = torch.randn((b, 2, h, w), generator=g, device=device) * flow_px
    return f1, f2, flow


def _assert_fused_close(out, f1, f2, flow, thr=0.9999):
    """Against the plain version in float32, before the rounding to the
    features' dtype.  A warped pixel whose mask sum is within 1e-6 of the
    threshold may decide otherwise: the outputs it reaches are left out."""
    b, _, h, w = f1.shape
    assert out.dtype == f1.dtype and out.shape == (b, 81, h, w)
    ref = fused_warpcorr.fused_warp_corr_plain(f1.float(), f2.float(), flow,
                                               mask_threshold=thr)
    _, _, wv = fused_warpcorr.prep_gather(flow, h, w, 0.0)
    near = ((wv.sum(1, keepdim=True) - thr).abs() < 1e-6).float()
    reach = torch.nn.functional.max_pool2d(near, 9, 1, 4) > 0
    err = (out.float() - ref).abs() * (~reach).float()
    if f1.dtype == torch.float32:
        # float32 sums of <=196 products and of the corner terms, in
        # another order
        assert float(err.max()) <= 1e-4
    else:   # one bf16 rounding of the float32 result, doubled for the order
        assert bool((err <= ref.abs() * 2.0 ** -8 + 1e-5).all())
    assert float(reach.float().mean()) < 0.25    # nearly all is compared


# C in {1, 17, 20, 196}: the channel split and the last chunk are ragged;
# W in {30, 45}: no 16-byte copies or stores; no H is a multiple of 8;
# (8, 196, 7, 16): B=8 at level 6
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 9, 45), (2, 17, 9, 45),
                                   (1, 20, 13, 30), (1, 196, 17, 30),
                                   (1, 17, 28, 64), (1, 20, 14, 32),
                                   (8, 196, 7, 16)])
@pytest.mark.parametrize("tile,split", PLANS)
def test_fused_matches_plain_at_every_tile_and_split(cuda_device, shape,
                                                     dtype, tile, split):
    """The kernel's own choice, and tiles and splits forced on it: ranks
    with no channel at all (C=1 split 8), an odd cluster size."""
    f1, f2, flow = _fused_inputs(cuda_device, shape, dtype, 3.0)
    out = fused_warpcorr.fused_warp_corr_cuda(f1, f2, flow, tile=tile,
                                              split=split)
    _assert_fused_close(out, f1, f2, flow)


@pytest.mark.parametrize("thr", [0.9999, 0.999])
@pytest.mark.parametrize("flow_px", [3.0, 20.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile,split", PLANS[1:])
def test_fused_at_forced_plans_takes_flows_and_thresholds(
        cuda_device, tile, split, dtype, flow_px, thr):
    f1, f2, flow = _fused_inputs(cuda_device, (2, 40, 21, 52), dtype,
                                 flow_px, seed=11)
    out = fused_warpcorr.fused_warp_corr_cuda(f1, f2, flow, tile=tile,
                                              split=split,
                                              mask_threshold=thr)
    _assert_fused_close(out, f1, f2, flow, thr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile,split", PLANS)
def test_fused_is_exactly_zero_where_every_sample_is_outside(
        cuda_device, tile, split, dtype):
    """A flow that throws every sample out of the image: every mask is 0,
    nothing is gathered, and the output is 0 to the bit."""
    f1, f2, flow = _fused_inputs(cuda_device, (2, 20, 13, 36), dtype, 1.0, 12)
    flow = flow + 100.0
    out = fused_warpcorr.fused_warp_corr_cuda(f1, f2, flow, tile=tile,
                                              split=split)
    assert int(torch.count_nonzero(out)) == 0
    assert not bool(torch.signbit(out.float()).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 11, 1), (2, 6, 1, 21),
                                   (1, 5, 1, 1), (1, 9, 2, 2)])
@pytest.mark.parametrize("tile,split", PLANS[:3])
def test_fused_takes_images_one_pixel_wide_or_high(cuda_device, tile, split,
                                                   shape, dtype):
    """W or H of 1: the sampled patch has one column or row, and the gather
    reads no neighbour.  A low threshold keeps half-inside samples alive
    (at 0.9999 such an image is masked out nearly everywhere)."""
    f1, f2, flow = _fused_inputs(cuda_device, shape, dtype, 0.4, seed=17)
    out = fused_warpcorr.fused_warp_corr_cuda(f1, f2, flow, tile=tile,
                                              split=split,
                                              mask_threshold=0.25)
    _assert_fused_close(out, f1, f2, flow, 0.25)
    if (shape[2] == 1) != (shape[3] == 1):
        # a line of pixels: many samples survive the mask (a 1x1 or 2x2
        # image holds at most 0.25 of a sample's weight at zero flow)
        assert int(torch.count_nonzero(out)) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_takes_a_base_pointer_off_by_one_element(cuda_device, dtype):
    """f1 not 16-byte aligned: element loads and scalar stores."""
    shape = (1, 20, 16, 64)
    n = 20 * 16 * 64
    g = torch.Generator(device=cuda_device).manual_seed(13)
    buf1 = torch.randn(n + 1, generator=g, device=cuda_device).to(dtype)
    buf2 = torch.randn(n + 1, generator=g, device=cuda_device).to(dtype)
    flow = torch.randn((1, 2, 16, 64), generator=g, device=cuda_device) * 3
    f1, f2 = buf1[1:].view(shape), buf2[1:].view(shape)
    assert f1.data_ptr() % 16 != 0 and f1.is_contiguous()
    for tile in (16, 32):
        out = fused_warpcorr.fused_warp_corr_cuda(f1, f2, flow, tile=tile)
        _assert_fused_close(out, f1, f2, flow)
        # the aligned path on the same values gives the same bits
        assert torch.equal(out, fused_warpcorr.fused_warp_corr_cuda(
            f1.clone(), f2.clone(), flow, tile=tile))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64, 56, 128), (8, 128, 14, 32),
                                   (1, 20, 13, 30)])
@pytest.mark.parametrize("tile,split", PLANS)
def test_fused_gives_the_same_bits_twice(cuda_device, tile, split, shape,
                                         dtype):
    """The channel split is reduced in a fixed order: no atomics."""
    f1, f2, flow = _fused_inputs(cuda_device, shape, dtype, 3.0, seed=14)
    first = fused_warpcorr.fused_warp_corr_cuda(f1, f2, flow, tile=tile,
                                                split=split)
    for _ in range(3):
        assert torch.equal(first, fused_warpcorr.fused_warp_corr_cuda(
            f1, f2, flow, tile=tile, split=split))


def test_fused_is_captured_and_replayed_by_a_cuda_graph(cuda_device):
    shape = (1, 128, 14, 32)
    f1, f2, flow = _fused_inputs(cuda_device, shape, torch.float32, 3.0, 15)
    eager = fused_warpcorr.fused_warp_corr_cuda(f1, f2, flow)   # built
    g1, g2, gflow = _fused_inputs(cuda_device, shape, torch.float32, 3.0, 16)
    other = fused_warpcorr.fused_warp_corr_cuda(g1, g2, gflow)
    assert not torch.equal(eager, other)
    s1, s2, sflow = f1.clone(), f2.clone(), flow.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_warpcorr.fused_warp_corr_cuda(s1, s2, sflow)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    s1.copy_(g1)
    s2.copy_(g2)
    sflow.copy_(gflow)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, other)


def test_fused_launch_plan_covers_the_image_and_the_channels(cuda_device):
    for h, w, c in ((112, 256, 32), (56, 128, 64), (28, 64, 96),
                    (14, 32, 128), (272, 480, 32), (9, 45, 20)):
        for dtype in (torch.float32, torch.bfloat16):
            p = fused_warpcorr.launch_plan(1, c, h, w, dtype)
            th, tw = p["tile"]
            assert th == 8 and tw in (16, 32), p
            assert p["tiles"] == -(-h // th) * -(-w // tw), p
            assert p["split"] * p["channels_per_split"] >= c, p
            assert 1 <= p["split"] <= 8 and p["smem_bytes"] <= 232448, p
            assert p["grid"] == [p["tiles"], p["split"], 1], p
    forced = fused_warpcorr.launch_plan(2, 64, 56, 128, torch.float32,
                                        tile=32, split=3)
    assert forced["tile"] == [8, 32] and forced["split"] == 3
    assert forced["channels_per_split"] == 22 and forced["threads"] == 576


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


# ---- the correlation backward (B1) ----------------------------------------

# every level of a 320x896 training crop at B=4, of a 448x1024 frame at
# B=1, and images one pixel wide or high
BWD_SHAPES = [(4, 32, 80, 224), (4, 64, 40, 112), (4, 96, 20, 56),
              (4, 128, 10, 28), (4, 196, 5, 14),
              (1, 32, 112, 256), (1, 64, 56, 128), (1, 96, 28, 64),
              (1, 128, 14, 32), (1, 196, 7, 16),
              (2, 6, 11, 1), (2, 6, 1, 21), (1, 3, 1, 1)]


def _bwd_inputs(device, shape, dtype, seed=0):
    b, _, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    f1 = torch.randn(shape, generator=g, device=device).to(dtype)
    f2 = torch.randn(shape, generator=g, device=device).to(dtype)
    gv = torch.randn((b, 81, h, w), generator=g, device=device).to(dtype)
    return f1, f2, gv


def _assert_bwd_close(got, f1, f2, gv):
    """Against the plain version on the same inputs: float32 within 1e-5 of
    the largest gradient (sums of 81 products in another order, fma against
    a rounded product), bfloat16 within 1e-2 of it (one bf16 rounding of
    the float32 sum, 2^-8 relative, in either version)."""
    ref = corr_cuda_plain_bwd(f1, f2, gv)
    for d, r in zip(got, ref):
        assert d.dtype == f1.dtype and d.shape == f1.shape
        scale = float(r.float().abs().max())
        tol = (1e-5 if f1.dtype == torch.float32 else 1e-2) * scale
        assert float((d.float() - r.float()).abs().max()) <= tol


def corr_cuda_plain_bwd(f1, f2, gv):
    from opticalflow_tpu_torch.ops.correlation import correlation_bwd_plain
    return correlation_bwd_plain(f1, f2, gv, max_displacement=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bwd_kernel_matches_plain_on_the_card(cuda_device, shape, dtype):
    f1, f2, gv = _bwd_inputs(cuda_device, shape, dtype)
    before = corr_cuda.correlation_bwd_cuda.launches
    got = corr_cuda.correlation_bwd_cuda(f1, f2, gv)
    assert corr_cuda.correlation_bwd_cuda.launches == before + 1
    _assert_bwd_close(got, f1, f2, gv)


# C=17 in 3 splits: a ragged last split and stage; 64 splits of C=17 leave
# most blocks without a channel; both tiles forced on every shape
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 17, 9, 45), (1, 196, 7, 16),
                                   (1, 5, 3, 70)])
@pytest.mark.parametrize("split", [1, 3, 64])
@pytest.mark.parametrize("tile", [0, 16, 32])
def test_bwd_kernel_matches_plain_at_forced_splits(cuda_device, shape, dtype,
                                                   split, tile):
    f1, f2, gv = _bwd_inputs(cuda_device, shape, dtype, seed=1)
    _assert_bwd_close(corr_cuda.correlation_bwd_cuda(f1, f2, gv, tile=tile,
                                                     split=split),
                      f1, f2, gv)


# ragged against the tile (4 rows of 16 or 32 columns) and its 4-pixel
# thread groups (W = 13, 30, 45, 70, 36; H = 9, 21, 11, 3, 17), and C
# against the 4-channel ring stage (1, 5, 7, 13, 6) and the split rule's
# 8-channel floor
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 9, 13), (3, 5, 21, 30),
                                   (2, 7, 11, 70), (1, 13, 3, 45),
                                   (2, 6, 17, 36)])
@pytest.mark.parametrize("tile", [16, 32])
def test_bwd_kernel_matches_plain_on_ragged_tiles_and_channels(
        cuda_device, shape, dtype, tile):
    f1, f2, gv = _bwd_inputs(cuda_device, shape, dtype, seed=11)
    _assert_bwd_close(corr_cuda.correlation_bwd_cuda(f1, f2, gv, tile=tile),
                      f1, f2, gv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_takes_a_base_pointer_off_by_one_element(cuda_device,
                                                            dtype):
    """Inputs whose base is not 16-byte aligned take the element-copy path
    and scalar stores; the aligned path gives the same bits."""
    b, c, h, w = 2, 12, 16, 64
    g = torch.Generator(device=cuda_device).manual_seed(12)
    bufs = [torch.randn(n + 1, generator=g, device=cuda_device).to(dtype)
            for n in (b * c * h * w, b * c * h * w, b * 81 * h * w)]
    f1 = bufs[0][1:].view(b, c, h, w)
    f2 = bufs[1][1:].view(b, c, h, w)
    gv = bufs[2][1:].view(b, 81, h, w)
    assert f1.data_ptr() % 16 != 0 and f1.is_contiguous()
    got = corr_cuda.correlation_bwd_cuda(f1, f2, gv)
    _assert_bwd_close(got, f1, f2, gv)
    again = corr_cuda.correlation_bwd_cuda(f1.clone(), f2.clone(),
                                           gv.clone())
    assert all(torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 32, 80, 224), (4, 196, 5, 14)])
def test_bwd_kernel_gives_the_same_bits_twice(cuda_device, shape, dtype):
    """The gather form: every output element is one thread's sum in a fixed
    order, no atomics."""
    f1, f2, gv = _bwd_inputs(cuda_device, shape, dtype, seed=2)
    first = corr_cuda.correlation_bwd_cuda(f1, f2, gv)
    for _ in range(3):
        again = corr_cuda.correlation_bwd_cuda(f1, f2, gv)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_bwd_kernel_launches_on_the_current_stream(cuda_device):
    f1, f2, gv = _bwd_inputs(cuda_device, (2, 64, 40, 112), torch.float32, 3)
    eager = corr_cuda.correlation_bwd_cuda(f1, f2, gv)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ga = torch.zeros_like(gv)
        torch.cuda._sleep(20_000_000)     # ~10 ms before the copy lands
        ga.copy_(gv)
        out = corr_cuda.correlation_bwd_cuda(f1, f2, ga)
    side.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))


def test_bwd_kernel_is_captured_and_replayed_by_a_cuda_graph(cuda_device):
    """B1 reads the stream at every call, so a CUDA graph captures it (the
    whole-step graph depends on that); a replay reads the new inputs."""
    shape = (4, 196, 5, 14)
    f1, f2, gv = _bwd_inputs(cuda_device, shape, torch.float32, 13)
    eager = corr_cuda.correlation_bwd_cuda(f1, f2, gv)   # built before capture
    o1, o2, ogv = _bwd_inputs(cuda_device, shape, torch.float32, 14)
    other = corr_cuda.correlation_bwd_cuda(o1, o2, ogv)
    assert not torch.equal(eager[0], other[0])
    s1, s2, sg = f1.clone(), f2.clone(), gv.clone()
    before = corr_cuda.correlation_bwd_cuda.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = corr_cuda.correlation_bwd_cuda(s1, s2, sg)
    assert corr_cuda.correlation_bwd_cuda.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(out, eager))
    s1.copy_(o1)
    s2.copy_(o2)
    sg.copy_(ogv)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(out, other))


def test_bwd_launch_plan_covers_the_image_and_the_channels(cuda_device):
    """The plan fills half the slots the occupancy API reports for the
    kernel it launches (blocks an SM × SMs), unless the channels cannot be
    split further (64 splits at most, 6 channels each at least)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for b, c, h, w in BWD_SHAPES:
            p = corr_cuda.bwd_launch_plan(b, c, h, w, dtype)
            th, tw = p["tile"]
            assert tw in (16, 32), p
            assert p["tiles"] == -(-h // th) * -(-w // tw), p
            assert p["split"] * p["channels_per_split"] >= c, p
            assert p["grid"] == [p["tiles"], p["split"], 2 * b], p
            per_sm = p["blocks_per_sm"]
            assert per_sm >= 1 and 0 < p["registers"] <= 255, p
            assert per_sm * p["threads"] * p["registers"] <= 65536, p
            assert per_sm * p["smem_bytes"] <= 233472, p
            blocks = 2 * b * p["tiles"] * p["split"]
            assert (2 * blocks >= sms * per_sm or 2 * p["split"] > 64
                    or c // (2 * p["split"]) < 6), p
    forced = corr_cuda.bwd_launch_plan(2, 17, 9, 45, torch.float32,
                                       tile=16, split=3)
    th = forced["tile"][0]
    assert forced["tile"] == [th, 16] and forced["split"] == 3
    assert forced["channels_per_split"] == 6
    assert forced["tiles"] == -(-9 // th) * 3


def test_bwd_kernel_refuses_autograd_and_a_bad_gradient(cuda_device):
    f = torch.randn(1, 4, 8, 8, device=cuda_device)
    gv = torch.randn(1, 81, 8, 8, device=cuda_device)
    with pytest.raises(RuntimeError, match="forward-only"):
        corr_cuda.correlation_bwd_cuda(f.requires_grad_(), f, gv)
    with pytest.raises(ValueError):
        corr_cuda.correlation_bwd_cuda(f.detach(), f.detach(), gv[:, :80])
    with pytest.raises(TypeError):
        corr_cuda.correlation_bwd_cuda(f.detach(), f.detach(),
                                       gv.bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 40, 112), (4, 196, 5, 14),
                                   (1, 7, 1, 13)])
def test_correlation_fn_grads_match_plain_autograd_on_the_card(
        cuda_device, shape, dtype):
    """``correlation()`` under grad runs K1 forward and B1 backward; the
    gradients equal autograd's through the plain version, on the card."""
    f1, f2, gv = _bwd_inputs(cuda_device, shape, dtype, seed=4)
    a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    fwd0 = corr_cuda.correlation_cuda.launches
    bwd0 = corr_cuda.correlation_bwd_cuda.launches
    out = correlation(a1, a2, pad_size=4, max_displacement=4)
    got = torch.autograd.grad(out, (a1, a2), gv)
    assert corr_cuda.correlation_cuda.launches == fwd0 + 1
    assert corr_cuda.correlation_bwd_cuda.launches == bwd0 + 1
    p1, p2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    ref_out = correlation_plain(p1, p2, pad_size=4, max_displacement=4)
    ref = torch.autograd.grad(ref_out.to(dtype), (p1, p2), gv)
    _assert_corr_close(out.detach(), f1, f2)
    for d, r in zip(got, ref):
        assert d.dtype == dtype
        scale = float(r.float().abs().max())
        tol = (1e-5 if dtype == torch.float32 else 1e-2) * scale
        assert float((d.float() - r.float()).abs().max()) <= tol


def test_train_step_through_the_kernels_matches_plain(cuda_device):
    """One parity-mode multiscale step's gradients through K1 and B1 against
    the same step through the plain correlation (autograd of
    ``correlation_plain``), 5 launches of each kernel, none without.

    Each parameter's gradient is held to 1e-3 of its largest value or to 4x
    cuDNN's run-to-run spread of that gradient, whichever is larger, as
    ``chip_smoke.py`` phase 8 measures it: cuDNN's backward algorithms add
    with atomics, so a small gradient (dc_conv1's, ≈5.7e-7 at most) moves
    by ≈1e-9 between two runs of the same step, over a fixed 1e-3 bound
    about one run in three.  The spread is measured here: the largest
    difference between repeats of the same step (the kernels' path twice,
    the plain path three times)."""
    from itertools import combinations

    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.train import trainer as T
    rng = np.random.RandomState(0)
    batch = {"images": rng.rand(2, 128, 192, 6).astype(np.float32),
             "flow": (rng.randn(2, 128, 192, 2) * 2).astype(np.float32),
             "valid": (rng.rand(2, 128, 192) > 0.2).astype(np.float32)}
    cpu = PWCDCNet(generator=torch.Generator().manual_seed(0))
    for p in cpu.parameters():
        p.data *= 0.5

    def grads(use_cuda_corr):
        model = PWCDCNet(use_cuda_corr=use_cuda_corr)
        model.load_state_dict(cpu.state_dict())
        model = model.to(cuda_device)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        state = T.TrainState(step=0, model=model, optimizer=opt)
        cfg = T.TrainConfig(loss="multiscale", grad_clip=0.0)
        f0 = corr_cuda.correlation_cuda.launches
        b0 = corr_cuda.correlation_bwd_cuda.launches
        _, m = T.make_train_step(model, opt, cfg)(state, batch)
        launched = (corr_cuda.correlation_cuda.launches - f0,
                    corr_cuda.correlation_bwd_cuda.launches - b0)
        return ({n: p.grad.detach().clone()
                 for n, p in model.named_parameters()},
                float(m["loss"]), launched)

    kernel = [grads(True) for _ in range(2)]
    plain = [grads(False) for _ in range(3)]
    (gk, loss_k, launched_k), (gp, loss_p, launched_p) = kernel[0], plain[0]
    assert all(r[2] == (5, 5) for r in kernel)
    assert all(r[2] == (0, 0) for r in plain)
    assert loss_k == pytest.approx(loss_p, rel=1e-5)
    pairs = (list(combinations([r[0] for r in kernel], 2))
             + list(combinations([r[0] for r in plain], 2)))
    top = max(float(g.abs().max()) for g in gp.values())
    for n in gp:
        spread = max(float((a[n] - b[n]).abs().max()) for a, b in pairs)
        # float32 throughout (TF32 off in the backward too); the kernels
        # sum in another order than the plain version: within 1e-3 of the
        # parameter's largest gradient, or of a millionth of the model's
        # largest where the gradient vanishes (upfeat6.weight's is 1.6e-17:
        # rounding noise only)
        scale = max(float(gp[n].abs().max()), 1e-6 * top)
        diff = float((gk[n] - gp[n]).abs().max())
        assert diff <= max(1e-3 * scale, 4 * spread), (n, diff, scale,
                                                       spread)


def _two_view_flow(h, w, seed=0):
    """A moving camera's dense flow over a surface of varying depth, with
    0.3 px of noise and 10% outliers (``test_torch_epipolar.two_view_flow``
    without JAX), as (2, H, W)."""
    rng = np.random.RandomState(seed)
    k = np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]])
    ang, t = 0.03, np.array([0.4, 0.1, 0.2])
    r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = 5.0 + 2.0 * np.sin(xx / 40.0) * np.cos(yy / 25.0)
    pts = (np.linalg.inv(k) @ np.stack([xx, yy, np.ones_like(xx)]).reshape(
        3, -1)) * depth.reshape(1, -1)
    p2 = k @ (r @ pts + t[:, None])
    x2 = (p2[:2] / p2[2:]).reshape(2, h, w)
    flow = np.stack([x2[0] - xx, x2[1] - yy]) + rng.randn(2, h, w) * 0.3
    bad = rng.rand(h, w) < 0.1
    flow[:, bad] += rng.randn(2, int(bad.sum())) * 8.0
    return torch.from_numpy(flow.astype(np.float32))


def test_epipolar_on_the_card_matches_the_cpu(cuda_device):
    """The RANSAC mask and F of a 384x512 flow (the CLI's --size and
    --epi-stride 6) on the card against the same call on the CPU with the
    same hypotheses: masks equal on >= 99.5% of pixels, F within 5e-4 of
    its largest entry (batched float32 SVDs from cuSOLVER and LAPACK), the
    Sampson penalty 1e-4 relative."""
    from opticalflow_tpu_torch.geometry import epipolar
    flow = _two_view_flow(384, 512)
    n = len(range(0, 384, 6)) * len(range(0, 512, 6))
    idx = torch.stack([torch.randperm(n, generator=torch.Generator(
        ).manual_seed(i))[:8] for i in range(256)])
    cpu_mask, cpu_f = epipolar.epipolar_mask_and_f(flow, stride=6,
                                                   sample_idx=idx)
    mask, f = epipolar.epipolar_mask_and_f(flow.to(cuda_device), stride=6,
                                           sample_idx=idx)
    assert mask.device.type == f.device.type == "cuda"
    assert (mask.cpu() == cpu_mask).float().mean() >= 0.995
    assert 0.0 < float(mask.float().mean()) < 1.0
    torch.testing.assert_close(f.cpu(), cpu_f, rtol=0,
                               atol=5e-4 * float(cpu_f.abs().max()))
    pen = epipolar.sampson_penalty(flow[None].to(cuda_device), f[None])
    cpu_pen = epipolar.sampson_penalty(flow[None], cpu_f[None])
    assert float(pen) == pytest.approx(float(cpu_pen), rel=1e-4)
    # the generator's own draws run on the card too
    g = torch.Generator(device=cuda_device).manual_seed(3)
    m2, f2 = epipolar.epipolar_mask_and_f(flow.to(cuda_device), g, stride=6)
    assert bool(torch.isfinite(f2).all()) and m2.shape == (384, 512)


def test_loader_device_prefetch_returns_the_cpu_batch_bytes(cuda_device):
    """``Loader(device="cuda")`` pins and copies each batch from its
    producer thread: the tensors on the card hold the numpy batch's bytes,
    batch after batch."""
    from opticalflow_tpu_torch.data.loader import Loader

    class Samples:
        def __len__(self):
            return 10

        def get(self, idx, epoch=0):
            rng = np.random.default_rng((epoch, idx))
            return {"images": rng.random((64, 96, 6)).astype(np.float32),
                    "valid": (rng.random((64, 96)) > 0.3).astype(
                        np.float32)}

    plain = list(Loader(Samples(), 2, seed=1, num_workers=2))
    moved = list(Loader(Samples(), 2, seed=1, num_workers=2,
                        device=cuda_device))
    assert len(plain) == len(moved) == 5
    for a, b in zip(plain, moved):
        for k in a:
            assert b[k].device.type == "cuda"
            np.testing.assert_array_equal(b[k].cpu().numpy(), a[k])


# ------------------------------------------------------------ video path

@pytest.mark.parametrize("h,w", [(64, 128), (70, 64), (94, 130)])
def test_i420_unpack_on_the_card_is_the_host_numpy(cuda_device, h, w):
    from opticalflow_tpu_torch.io.yuv import i420_to_rgb
    from opticalflow_tpu_torch.video import yuv_i420_to_rgb_u8
    yuvs = np.random.RandomState(1).randint(0, 256, (3, h * 3 // 2, w),
                                            np.uint8)
    got = yuv_i420_to_rgb_u8(torch.from_numpy(yuvs).to(cuda_device)).cpu()
    for k in range(3):
        np.testing.assert_array_equal(got[k].numpy(), i420_to_rgb(yuvs[k]))


def test_video_runner_on_the_card_matches_the_cpu(cuda_device):
    """The runner in float32 parity mode, both uploads and a grid
    readback, on the card against the same runner on the CPU (1e-4 mean
    EPE): K1 five times a window."""
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.video import VideoFlowRunner
    rng = np.random.RandomState(3)
    frames = [rng.randint(0, 256, (60, 120, 3), np.uint8) for _ in range(5)]
    model = PWCDCNet(generator=torch.Generator().manual_seed(0))
    sd = {k: v * 0.5 for k, v in model.state_dict().items()}
    for upload, grid in (("bgr", None), ("i420", 16)):
        kw = dict(batch=2, upload=upload, grid_step=grid)
        before = corr_cuda.correlation_cuda.launches
        card = VideoFlowRunner(PWCDCNet(), sd, device=cuda_device, **kw)
        got = [q for _, _, q in card.run(iter(frames))]
        assert corr_cuda.correlation_cuda.launches - before == \
            5 * card.stats["windows"] == 10
        want = [q for _, _, q in VideoFlowRunner(
            PWCDCNet(), sd, device="cpu", **kw).run(iter(frames))]
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):     # the card limit of PERF.md §2
            assert float(np.mean(np.hypot(*(a - b).transpose(2, 0, 1)))) \
                <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_correlation_operator_launches_the_kernel(cuda_device, dtype):
    """``torch.ops.opticalflow_tpu_torch.correlation`` (the node an exported
    program holds) on CUDA tensors is K1: one counted launch, the plain
    version's values."""
    f1, f2 = _corr_inputs(cuda_device, (2, 196, 7, 16), dtype, seed=11)
    before = corr_cuda.correlation_cuda.launches
    out = torch.ops.opticalflow_tpu_torch.correlation(f1, f2, 4)
    assert corr_cuda.correlation_cuda.launches == before + 1
    _assert_corr_close(out, f1, f2)


def test_loaded_artifact_launches_the_kernel(cuda_device, tmp_path):
    """A ``dynamic="all"`` artifact of the float32 parity model, exported
    and loaded on the card: 5 K1 launches a call, counted from inside the
    loaded program, at two shapes (a 64-pixel side among them); the eager
    model's flow within 1e-5 mean EPE though cuDNN's TF32 switch is on
    outside the call (the artifact runs under its stored precision), and
    the switches as they were after it."""
    from opticalflow_tpu_torch.export import export_program, load_exported
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    model = PWCDCNet(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    model = model.to(cuda_device).eval()
    path = str(tmp_path / "m.pt2")
    export_program(model, path, dynamic="all")
    fn = load_exported(path)
    assert fn.device.type == "cuda" and fn.metadata["precision"] == "highest"
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for shape in ((1, 6, 64, 128), (2, 6, 192, 256)):
            x = torch.rand(shape, generator=torch.Generator().manual_seed(1))
            x = x.to(cuda_device)
            before = corr_cuda.correlation_cuda.launches
            got = fn(x)
            assert corr_cuda.correlation_cuda.launches - before == 5
            assert torch.backends.cudnn.allow_tf32
            with torch.no_grad():
                want = model(x) * 20.0
            epe = (got - want).norm(dim=1).mean().item()
            assert epe < 1e-5, (shape, epe)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_interpret_kernels_runs_the_plain_versions_on_the_card(cuda_device):
    """Inside ``interpret_kernels(model)`` that model's forward launches no
    K1 and gives the plain correlation's flow (within 1e-5 mean EPE, cuDNN's
    run-to-run spread), while another model and the
    dispatcher itself go on launching K1; after it the model launches K1
    again (5 a forward)."""
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.utils.debugging import interpret_kernels
    model = PWCDCNet(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    model = model.to(cuda_device).eval()
    plain = PWCDCNet(use_cuda_corr=False).to(cuda_device).eval()
    plain.load_state_dict(model.state_dict())
    other = PWCDCNet().to(cuda_device).eval()
    x = torch.rand((1, 6, 128, 192),
                   generator=torch.Generator().manual_seed(1)).to(cuda_device)
    f1, f2 = _corr_inputs(cuda_device, (1, 32, 14, 32), torch.float32, 12)
    k1 = corr_cuda.correlation_cuda
    with torch.no_grad():
        with interpret_kernels(model):
            before = k1.launches
            got = model(x)
            assert k1.launches == before
            other(x)
            assert k1.launches == before + 5
            correlation(f1, f2, pad_size=4, max_displacement=4)
            assert k1.launches == before + 6
        want = plain(x)
        assert (got - want).norm(dim=1).mean().item() < 1e-5
        before = k1.launches
        model(x)
        assert k1.launches == before + 5


def test_make_mesh_after_a_gloo_init_on_a_card_is_on_that_card(cuda_device):
    """A group joined over gloo with no device is on the rank's card, and
    so is its mesh: nothing moves to the CPU unasked."""
    import socket
    from opticalflow_tpu_torch.parallel import mesh as meshlib
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        meshlib.distributed_init(f"127.0.0.1:{port}", 1, 0, backend="gloo",
                                 timeout_s=60)
        mesh = meshlib.make_mesh()
        assert mesh.backend == "gloo"
        assert mesh.device == torch.device("cuda",
                                           torch.cuda.current_device())
        t = torch.arange(4.0, device=mesh.device)
        got = meshlib.all_gather_rows(t, mesh)
        assert got.is_cuda and torch.equal(got, t)
    finally:
        meshlib.shutdown()


@pytest.mark.parametrize("method", ["farneback", "lucaskanade_dense"])
def test_farneback_on_the_card_matches_the_cpu(cuda_device, method):
    """Compare mode's Farneback baseline as torch ops on the card against
    the same function on the CPU (elementwise float32/float64, no
    convolution, so no TF32): within 1e-4 px mean EPE."""
    from opticalflow_tpu_torch.viz import farneback as fb
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:96, 0:160].astype(np.float64)
    waves = rng.uniform(-0.3, 0.3, (12, 2))

    def img(dx, dy):
        v = sum(np.sin(a * (xs - dx) + b * (ys - dy)) for a, b in waves)
        return np.clip(128 + 10 * v, 0, 255).astype(np.uint8)

    g1, g2 = img(0.0, 0.0), img(1.3, -0.7)
    keys = ("pyr_scale", "levels", "winsize", "iterations", "poly_n",
            "poly_sigma")
    params = dict(zip(keys, fb.FARNEBACK_PARAMS[method]))
    card = fb.farneback_flow(g1, g2, device="cuda", **params)
    cpu = fb.farneback_flow(g1, g2, device="cpu", **params)
    assert card.shape == cpu.shape == (96, 160, 2)
    assert np.hypot(*(card - cpu).transpose(2, 0, 1)).mean() <= 1e-4
