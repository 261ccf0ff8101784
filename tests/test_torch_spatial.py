"""The port's spatial inference (``opticalflow_tpu_torch/parallel/
spatial.py``) on the CPU: a 2-rank gloo world, launched once for the whole
file (``torch_parallel_ranks.py``), runs the tiled path (the tile batch
over the ranks) and the halo exchange (a slab each) at 256x64 and 512x64,
against the port in one process, its monolithic forward and JAX's
``halo_exchange_quarter_flow`` on two of the CPU devices; a 3-rank world
runs the halo exchange with an interior rank at 576x64 against JAX's on
three; the tile plan and the geometry errors against JAX's.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet
from opticalflow_tpu.parallel import mesh as jmesh
from opticalflow_tpu.parallel import spatial as jspatial
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.models.torch_import import state_dict_from_jax
from opticalflow_tpu_torch.parallel import mesh as meshlib
from opticalflow_tpu_torch.parallel import spatial
from torch_parallel_world import World


@pytest.fixture(scope="module")
def jax_params():
    model = JaxPWCDCNet(variant="new", precision="highest",
                        use_pallas_corr=False)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 6)))["params"]
    return model, jax.tree.map(lambda p: np.asarray(p) * 0.5, params)


@pytest.fixture(scope="module")
def inputs(jax_params):
    rng = np.random.RandomState(0)
    return {"sd": state_dict_from_jax(jax_params[1]),
            **{f"x{h}": torch.from_numpy(
                rng.rand(1, 6, h, 64).astype(np.float32))
               for h in (256, 512, 576)}}


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    w = World(str(tmp_path_factory.mktemp("world")), inputs, ["spatial"])
    yield w
    w.kill()


@pytest.fixture(scope="module")
def world3(inputs, tmp_path_factory):
    w = World(str(tmp_path_factory.mktemp("world3")), inputs, ["halo3"],
              world=3)
    yield w
    w.kill()


def _jax_halo(jax_params, x, n):
    """JAX's shard_map + ppermute halo exchange (halo 64) on ``n`` CPU
    devices, in the port's layout."""
    jmodel, params = jax_params
    mesh = jmesh.make_mesh(jax.devices()[:n], axis_name="space")
    return np.asarray(jspatial.halo_exchange_quarter_flow(
        jmodel, params, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
        halo=64, mesh=mesh)).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def model(inputs):
    m = PWCDCNet(variant="new", precision="highest")
    m.load_state_dict(inputs["sd"])
    return m.eval()


@pytest.fixture(scope="module")
def mono(model, inputs):
    with torch.no_grad():
        return model(inputs["x256"])


def test_plan_tiles_matches_jax():
    for h in range(64, 1088, 64):
        for tile_h in (64, 128, 256, 512):
            for halo in (0, 64, 128):
                assert spatial.plan_tiles(h, tile_h, halo) == \
                    jspatial.plan_tiles(h, tile_h, halo), (h, tile_h, halo)
    assert spatial.plan_tiles(512, tile_h=256, halo=64) == [
        (0, 320, 0, 256), (192, 512, 256, 512)]
    for bad in ((500, 256, 64), (512, 100, 64), (512, 256, 32)):
        with pytest.raises(ValueError) as ours:
            spatial.plan_tiles(*bad)
        with pytest.raises(ValueError) as theirs:
            jspatial.plan_tiles(*bad)
        assert str(ours.value) == str(theirs.value)


def test_halo_exchange_exact_case_matches_monolithic_and_jax(
        world, mono, jax_params, inputs):
    """Two slabs of 128 = 2·halo rows: each rank's slid window covers the
    whole image, so the result is the monolithic forward's, and JAX's
    shard_map + ppermute path on two devices gives the same.  (First of the
    world's tests: JAX compiles while the ranks run.)"""
    ref = _jax_halo(jax_params, inputs["x256"], 2)
    for r in world.results():
        assert r["halo"].shape == mono.shape == (1, 2, 64, 16)
        np.testing.assert_allclose(r["halo"].numpy(), mono.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r["halo"].numpy(), ref, rtol=0, atol=1e-5)


def test_halo_exchange_partial_windows_match_the_tiled_windows(
        world, model, inputs):
    """Two slabs of 256 > 2·halo: rank 0's window is rows 0-384, rank 1's
    128-512 (the edge windows slide to the border, the slab cropped at its
    origin in the window), which are the one-process tiled path's windows
    at tile_h 256, halo 2·64."""
    one = spatial.tiled_quarter_flow(model, inputs["x512"], tile_h=256,
                                     halo=128)
    assert one.shape == (1, 2, 128, 16)
    for r in world.results():
        np.testing.assert_allclose(r["halo_wide"].numpy(), one.numpy(),
                                   rtol=0, atol=1e-5)


def test_halo_exchange_three_ranks_matches_jax(world3, jax_params, inputs):
    """Three slabs of 192 > 2·halo: rank 1's window is centred on its slab
    (halo rows from each neighbour), the edge ranks' slide to the border;
    every rank's stitched flow equals JAX's on three devices."""
    ref = _jax_halo(jax_params, inputs["x576"], 3)
    results = world3.results()
    assert [r["world"] for r in results] == [3, 3, 3]
    for r in results:
        assert r["halo3"].shape == ref.shape == (1, 2, 144, 16)
        np.testing.assert_allclose(r["halo3"].numpy(), ref, rtol=0,
                                   atol=1e-5)


def test_tiled_over_two_ranks_matches_one_process(world, model, inputs,
                                                  mono):
    """The tile batch (2 tiles) split over the ranks equals the tiles in
    one process; the seams are within JAX's bounds of the monolithic
    forward (tests/test_spatial.py), the borders tight."""
    one = spatial.tiled_quarter_flow(model, inputs["x256"], tile_h=128,
                                     halo=64)
    assert one.shape == mono.shape == (1, 2, 64, 16)
    for r in world.results():
        np.testing.assert_allclose(r["tiled"].numpy(), one.numpy(), rtol=0,
                                   atol=1e-5)
    diff = (one - mono).abs().numpy()
    assert np.median(diff) < 2e-2 and diff.mean() < 5e-2
    assert diff[:, :, :8].mean() < 5e-3 and diff[:, :, -8:].mean() < 5e-3


def test_tiled_refuses_a_tile_batch_the_ranks_do_not_divide(world):
    """No silent unsharded fallback: 3 tiles over 2 ranks (JAX's
    message)."""
    for r in world.results():
        assert r["tiled_odd"].startswith(
            "tile batch 3 (= 3 tiles × batch 1) is not divisible by the "
            "2-device mesh")


def test_halo_exchange_validates_geometry(world):
    """A slab that is not /64, a slab under 2·halo, no mesh: JAX's
    messages."""
    for r in world.results():
        slabs, double, no_mesh = r["halo_errors"]
        assert slabs == ("H=192 must split into 2 slabs of a /64 height "
                         "with a /64 halo (got slab 96, halo 64)")
        assert double.startswith("slab height 128 must be ≥ 2·halo = 256")
        assert no_mesh == "halo_exchange_quarter_flow requires a mesh"


def test_one_rank_mesh_is_the_monolithic_forward(model, inputs, mono):
    """A one-rank group (``--data-parallel all`` with nothing launched):
    the halo path is the monolithic forward and the tiled path the tiles
    in one process."""
    try:
        mesh = meshlib.resolve_data_parallel("all", device="cpu")
        out = spatial.halo_exchange_quarter_flow(model, inputs["x256"],
                                                 mesh=mesh)
        torch.testing.assert_close(out, mono, rtol=0, atol=1e-6)
        tiled = spatial.tiled_quarter_flow(model, inputs["x256"],
                                           tile_h=128, mesh=mesh)
        one = spatial.tiled_quarter_flow(model, inputs["x256"], tile_h=128)
        torch.testing.assert_close(tiled, one, rtol=0, atol=0)
    finally:
        meshlib.shutdown()
