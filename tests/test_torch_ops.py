"""The port's warp, resize and conv helpers against the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opticalflow_tpu.ops import resize as jresize
from opticalflow_tpu.ops.convops import conv2d as jconv2d
from opticalflow_tpu.ops.convops import deconv2d as jdeconv2d
from opticalflow_tpu.ops.convops import leaky_relu as jleaky_relu
from opticalflow_tpu.ops.warp import bilinear_warp as jbilinear_warp
from opticalflow_tpu.ops.warp import warp_with_mask as jwarp_with_mask
from opticalflow_tpu_torch.ops import resize
from opticalflow_tpu_torch.ops.convops import conv2d, deconv2d, leaky_relu
from opticalflow_tpu_torch.ops.warp import bilinear_warp, warp_with_mask


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


# ----------------------------------------------------------------------- warp

@pytest.mark.parametrize("thr", [0.9999, 0.999])
@pytest.mark.parametrize("flow_scale", [0.0, 3.0, 9.0])
def test_warp_with_mask_matches_jax(thr, flow_scale):
    """Zero flow (not an identity under the reference's conventions), and
    flows that push many samples off the edge (mask at work)."""
    b, h, w, c = 2, 12, 18, 5
    x = _rand((b, h, w, c), 1)
    flow = _rand((b, h, w, 2), 2) * flow_scale
    ref = jwarp_with_mask(jnp.asarray(x), jnp.asarray(flow),
                          mask_threshold=thr)
    out = warp_with_mask(_nchw(x), _nchw(flow), mask_threshold=thr)
    assert out.dtype == torch.float32
    if flow_scale:
        # the mask really zeroes something at these flows
        assert (np.asarray(ref) == 0).all(axis=-1).any()
    # float32 bilinear weights computed in another order (the JAX package
    # holds its own warp to the reference at this bound, tests/test_ops.py)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_warp_with_mask_bf16_input_keeps_float32_mask():
    """0.9999 is below bf16 resolution: the mask is computed in float32."""
    b, h, w, c = 1, 10, 14, 4
    x = _rand((b, h, w, c), 3)
    flow = _rand((b, h, w, 2), 4) * 2.0
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    ref = jwarp_with_mask(jnp.asarray(xb), jnp.asarray(flow))
    out = warp_with_mask(_nchw(x).bfloat16(), _nchw(flow))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_bilinear_warp_matches_jax(padding):
    b, h, w, c = 2, 9, 13, 3
    x = _rand((b, h, w, c), 5)
    flow = _rand((b, h, w, 2), 6) * 6.0          # heavy out-of-bounds
    ref = jbilinear_warp(jnp.asarray(x), jnp.asarray(flow), padding=padding)
    out = bilinear_warp(_nchw(x), _nchw(flow), padding=padding)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_bilinear_warp_gradient_matches_jax(padding):
    """The gradient with respect to the flow, with points on every edge:
    a zero flow on the first and last rows and columns, and a v of -1.5e-6
    on the last row, which float32 rounds onto the edge.  There JAX's clip
    passes half the gradient; ``F.grid_sample``'s border mode passed none."""
    b, h, w, c = 2, 9, 13, 3
    x = _rand((b, h, w, c), 7)
    flow = _rand((b, h, w, 2), 8) * 3.0
    flow[:, [0, -1], :, :] = 0.0
    flow[:, :, [0, -1], :] = 0.0
    flow[:, -1, 2:6, 1] = -1.5e-6
    cot = _rand((b, h, w, c), 9)
    ref = jax.grad(lambda f: jnp.sum(jbilinear_warp(
        jnp.asarray(x), f, padding=padding) * cot))(jnp.asarray(flow))
    ft = _nchw(flow).requires_grad_()
    (bilinear_warp(_nchw(x), ft, padding=padding) * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(_nhwc(ft.grad), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)


def test_bilinear_warp_rejects_unknown_padding():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError):
        bilinear_warp(x, torch.zeros(1, 2, 4, 4), padding="reflect")


# --------------------------------------------------------------------- resize

@pytest.mark.parametrize("ac", [False, True])
@pytest.mark.parametrize("size", [(8, 12), (40, 60), (17, 33), (24, 36)])
def test_resize_bilinear_matches_jax(ac, size):
    x = _rand((2, 24, 36, 3), 7)
    ref = jresize.resize_bilinear(jnp.asarray(x), *size, align_corners=ac)
    out = resize.resize_bilinear(_nchw(x), *size, align_corners=ac)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("fn", ["upsample_flow_to", "flow_resize"])
@pytest.mark.parametrize("size", [(25, 35), (5, 6), (10, 14)])
def test_flow_resizes_match_jax(fn, size):
    flow = _rand((1, 10, 14, 2), 8)
    ref = getattr(jresize, fn)(jnp.asarray(flow), *size)
    out = getattr(resize, fn)(_nchw(flow), *size)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)


def test_upsample_flow_2x_matches_jax():
    flow = _rand((2, 6, 9, 2), 9)
    ref = jresize.upsample_flow_2x(jnp.asarray(flow))
    out = resize.upsample_flow_2x(_nchw(flow))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("size", [(7, 11), (40, 45), (20, 30)])
def test_resize_nearest_matches_jax(size):
    x = _rand((1, 20, 30, 2), 10)
    ref = jresize.resize_nearest(jnp.asarray(x), *size)
    out = resize.resize_nearest(_nchw(x), *size)
    np.testing.assert_array_equal(_nhwc(out), np.asarray(ref))


@pytest.mark.parametrize("src,dst", [((48, 80), (180, 318)),
                                     ((16, 16), (17, 33))])
def test_engine_upsampling_matches_jax_image_resize(src, dst):
    """The JAX engine's resize mode upsamples with jax.image.resize
    (method="linear"); the port's bilinear half-pixel resize must match it
    wherever the engine uses it (every side grows or stays)."""
    q = _rand((2,) + src + (2,), 11)
    ref = jax.image.resize(jnp.asarray(q), (2,) + dst + (2,),
                           method="linear")
    out = resize.resize_bilinear(_nchw(q), *dst, align_corners=False)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("src,dst", [((16, 16), (12, 40)),    # down, up
                                     ((16, 16), (3, 5)),      # down both
                                     ((16, 32), (15, 1)),
                                     ((16, 48), (7, 130)),
                                     ((48, 80), (180, 318))])  # up both
def test_antialiased_flow_resize_matches_jax_image_resize(src, dst):
    """What the engine's resize mode uses for frames under 16 px a side:
    jax.image.resize (method="linear") antialiases where it shrinks."""
    q = _rand((2,) + src + (2,), 18)
    ref = jax.image.resize(jnp.asarray(q), (2,) + dst + (2,),
                           method="linear")
    out = resize.resize_linear_antialiased(_nchw(q), *dst)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------------ conv ops

def test_deconv2d_matches_jax():
    ci, co, h, w = 6, 2, 9, 13
    x = _rand((1, h, w, ci), 12)
    wt = _rand((ci, co, 4, 4), 13)                 # torch IOHW
    bias = _rand((co,), 14)
    k = np.flip(wt, axis=(2, 3)).transpose(2, 3, 0, 1).copy()
    ref = jdeconv2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                    precision=jax.lax.Precision.HIGHEST)
    out = deconv2d(_nchw(x), torch.from_numpy(wt), torch.from_numpy(bias))
    assert out.shape == (1, co, 2 * h, 2 * w)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 4)])
def test_conv2d_and_leaky_relu_match_jax(stride, dilation):
    x = _rand((1, 16, 20, 5), 15)
    wt = _rand((7, 5, 3, 3), 16)                   # torch OIHW
    bias = _rand((7,), 17)
    ref = jleaky_relu(jconv2d(jnp.asarray(x),
                              jnp.asarray(wt.transpose(2, 3, 1, 0)),
                              jnp.asarray(bias), stride=stride,
                              padding=dilation, dilation=dilation,
                              precision=jax.lax.Precision.HIGHEST))
    out = leaky_relu(conv2d(_nchw(x), torch.from_numpy(wt),
                            torch.from_numpy(bias), stride=stride,
                            padding=dilation, dilation=dilation))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)
