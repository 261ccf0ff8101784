"""The port's PWCDCNet against the JAX package's, with the same weights
carried across by ``state_dict_from_jax``, and the port's loading of
reference-format checkpoints."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet
from opticalflow_tpu_torch.models.pwcnet import (PWCDCNet, pwc_dc_net,
                                                 pwc_dc_net_old)
from opticalflow_tpu_torch.models.torch_import import state_dict_from_jax
from opticalflow_tpu_torch.train.checkpoints import load_params
from oracles.torch_pwcnet import OraclePWC


@pytest.fixture(scope="module", params=["new", "old"])
def jax_pair(request):
    """One JAX train-mode forward per variant (flow2..flow6), the CPU
    compile count kept at two."""
    variant = request.param
    model = JaxPWCDCNet(variant=variant, precision="highest",
                        use_pallas_corr=False)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 6)))["params"]
    # scale down: random kaiming weights at 565-channel depth explode
    params = jax.tree.map(lambda p: np.asarray(p) * 0.5, params)
    x = np.random.RandomState(0).rand(1, 64, 128, 6).astype(np.float32)
    ref = jax.jit(lambda p, v: model.apply({"params": p}, v, train=True))(
        params, jnp.asarray(x))
    return variant, params, x, [np.asarray(r) for r in ref]


def test_model_matches_jax_all_levels(jax_pair):
    variant, params, x, ref = jax_pair
    model = PWCDCNet(variant=variant)
    model.load_state_dict(state_dict_from_jax(params))   # strict
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        # the bound tests/test_model_parity.py holds the JAX model to
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), r,
                                   atol=2e-4, rtol=1e-3)


def test_eval_output_is_flow2(jax_pair):
    variant, params, x, ref = jax_pair
    model = PWCDCNet(variant=variant)
    model.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        flow2 = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert flow2.shape == (1, 2, 16, 32)
    np.testing.assert_allclose(flow2.permute(0, 2, 3, 1).numpy(), ref[0],
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("variant", ["new", "old"])
@pytest.mark.parametrize("layout", ["flat", "state_dict", "model_state_dict"])
def test_reference_checkpoint_loads(tmp_path, variant, layout):
    """Reference layouts with ``module.`` prefixes and the dead
    ``deconv2`` load strictly and reproduce the torch oracle."""
    torch.manual_seed(0)
    oracle = OraclePWC(variant=variant).eval()
    for p in oracle.parameters():
        p.data *= 0.5
    sd = {f"module.{k}": v for k, v in oracle.state_dict_flat().items()}
    # the reference's PWCDCNet carries a deconv2 its forward never applies
    sd["module.deconv2.weight"] = torch.randn(2, 2, 4, 4)
    sd["module.deconv2.bias"] = torch.randn(2)
    path = str(tmp_path / "ckpt.pth.tar")
    torch.save(sd if layout == "flat" else {layout: sd, "epoch": 3}, path)
    factory = pwc_dc_net if variant == "new" else pwc_dc_net_old
    model = factory(path).eval()
    x = torch.from_numpy(
        np.random.RandomState(1).rand(1, 6, 64, 64).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model(x), oracle(x), atol=1e-5,
                                   rtol=1e-4)


def test_load_params_rejects_orbax_dirs_and_unknown_files(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_params(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "missing.pth"))
    with pytest.raises(ValueError):
        load_params(str(tmp_path / "weights.npz"))


def test_wrong_variant_checkpoint_fails_loudly():
    torch.manual_seed(0)
    sd = OraclePWC(variant="old").state_dict_flat()
    with pytest.raises(RuntimeError, match="conv1aa"):
        PWCDCNet(variant="new").load_state_dict(sd)


def test_param_count_and_seeded_init():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a, b = PWCDCNet(generator=g1), PWCDCNet(generator=g2)
    n = sum(p.numel() for p in a.parameters())
    assert 9_000_000 < n < 10_000_000
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_bf16_mode_close_to_float32():
    """bf16 convs, float32 flow heads: same graph, bf16 rounding."""
    g = torch.Generator().manual_seed(0)
    f32 = PWCDCNet(generator=g)
    for p in f32.parameters():
        p.data *= 0.5
    bf16 = PWCDCNet(dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    x = torch.from_numpy(
        np.random.RandomState(2).rand(1, 6, 64, 64).astype(np.float32))
    with torch.no_grad():
        ref, out = f32(x), bf16(x)
    assert out.dtype == torch.float32
    err = float((out - ref).abs().max())
    assert err <= 0.05 * float(ref.abs().max()) + 1e-3, err


def test_input_shape_is_checked():
    with pytest.raises(ValueError, match="multiples of 64"):
        PWCDCNet()(torch.zeros(1, 6, 64, 100))
