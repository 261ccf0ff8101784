"""The port's data parallelism (``opticalflow_tpu_torch/parallel/mesh.py``
and its users) on the CPU: a 2-rank gloo world, launched once for the whole
file (``torch_parallel_ranks.py``: every rank-side check runs in that one
launch, as the JAX package's ``EVAL_WORKER`` does), against the port's
single-process results and the JAX package's.

  * the train step on a batch whose halves have different valid fractions
    against the single-process step on the whole batch and JAX's 2-device
    mesh step (one JAX gradient compile), with the naive per-rank masked
    mean as a negative control; grad_accum=2 and the eval step;
  * the engine (a ragged N), ``evaluate_pairs`` and a lockstep
    ``FlowServer`` against one process;
  * ``VideoFlowRunner(mesh=)`` with a partial last window, in bgr and in
    i420 with ``grid_step``: each rank's triples against one process (the
    frames bit for bit, the flows to 1e-5);
  * ``replicate`` of divergent weights raises on every rank; a SIGTERM on
    one rank stops both after the same step; ``--resume`` refuses ranks
    that see different latest steps; a ``--distributed`` epoch loads
    disjoint shards, only rank 0 writes, and ``--resume`` continues;
  * ``resolve_data_parallel`` and ``check_eval_cli_mesh_args`` against
    JAX's messages, and the one-rank group of ``--data-parallel all``;
    the mesh's default device and the backend's default.

The spatial paths have their own world (``tests/test_torch_spatial.py``).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet
from opticalflow_tpu.parallel import mesh as jmesh
from opticalflow_tpu.train import trainer as JT
from opticalflow_tpu_torch.engine import FlowEngine
from opticalflow_tpu_torch.evaluate import evaluate_pairs
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.models.torch_import import state_dict_from_jax
from opticalflow_tpu_torch.parallel import mesh as meshlib
from opticalflow_tpu_torch.train import trainer as TT
from test_torch_train_data import synth_kitti
from torch_parallel_world import World, free_port

# valid fraction of each sample: the two ranks' shards differ
FRACTIONS_2 = (0.8, 0.3)
FRACTIONS_4 = (0.8, 0.3, 0.6, 0.1)


def _moving_frames(rng, n, h, w):
    base = (rng.rand(h + 20, w + 20, 3) * 255).astype(np.uint8)
    base = ((base.astype(np.uint16) + np.roll(base, 1, 0)
             + np.roll(base, 1, 1)) // 3).astype(np.uint8)
    return [np.ascontiguousarray(base[10 - i:10 - i + h, 10 - 2 * i:
                                      10 - 2 * i + w]) for i in range(n)]


def _batch(fractions, seed):
    rng = np.random.RandomState(seed)
    b = len(fractions)
    valid = np.stack([(rng.rand(64, 64) < f) for f in fractions])
    return {"images": rng.rand(b, 64, 64, 6).astype(np.float32),
            "flow": (rng.randn(b, 64, 64, 2) * 2).astype(np.float32),
            "valid": valid.astype(np.float32)}


@pytest.fixture(scope="module")
def jax_params():
    """The trainer test's weights: JAX's init, ×0.5."""
    model = JaxPWCDCNet(variant="new", precision="highest",
                        use_pallas_corr=False)
    params = jax.jit(lambda r, x: model.init(r, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)))["params"]
    return model, jax.tree.map(lambda p: np.asarray(p) * 0.5, params)


@pytest.fixture(scope="module")
def inputs(jax_params, tmp_path_factory):
    rng = np.random.RandomState(3)
    u8 = lambda: rng.randint(0, 256, (60, 70, 3), dtype=np.uint8)  # noqa
    return {
        "sd": state_dict_from_jax(jax_params[1]),
        "batch": _batch(FRACTIONS_2, 0), "batch4": _batch(FRACTIONS_4, 1),
        "im1s": [u8() for _ in range(4)], "im2s": [u8() for _ in range(4)],
        "gts": [rng.randn(60, 70, 2).astype(np.float32) for _ in range(4)],
        "x64": rng.rand(2, 64, 64, 6).astype(np.float32),
        # a texture moving 2 px right and 1 down a frame (the video runner)
        "video": _moving_frames(rng, 6, 64, 128),
        # 6 temporal pairs: 3 steps an epoch for each rank at batch 2
        "kitti": synth_kitti(str(tmp_path_factory.mktemp("kitti")),
                             n_images=7, h=72, w=96)}


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The 2-rank world, started here and read by the first test that
    needs it (the JAX references compile meanwhile)."""
    w = World(str(tmp_path_factory.mktemp("world")), inputs,
              ["train", "infer", "replicate", "video", "train_cli"])
    yield w
    w.kill()


def _model(inputs):
    model = PWCDCNet(variant="new", precision="highest")
    model.load_state_dict(inputs["sd"])
    return model


def _single_step(inputs, batch, accum=1):
    model = _model(inputs)
    cfg = TT.TrainConfig(loss="multiscale", grad_accum=accum)
    state, opt = TT.create_train_state(model, cfg)
    _, m = TT.make_train_step(model, opt, cfg)(state, batch)
    return ({k: float(v) for k, v in m.items()},
            {n: p.detach().clone() for n, p in model.named_parameters()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def _assert_params_close(got, ref, grads, lr=1e-4):
    """The trainer test's criterion for an Adam update from gradients that
    agree to rtol 1e-3: within one rounding of p and 1e-3·lr wherever the
    gradient is not within a few eps of 0 (there Adam's first step turns
    the gradients' disagreement into larger update differences)."""
    held = 0
    for name, p in got.items():
        a, b = p.numpy(), np.asarray(ref[name], np.float64)
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b).astype(np.float32)))
        keep = np.abs(grads[name].numpy()) >= 3e-8
        err = np.abs(a - b)
        assert np.all((err <= ulp + 1e-3 * lr)[keep]), (name, err[keep].max())
        held += int(keep.sum())
    assert held > 900_000


def _assert_grads_close(got, ref):
    for name, g in ref.items():
        g = g.numpy()
        np.testing.assert_allclose(got[name].numpy(), g, rtol=1e-3,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)


@pytest.fixture(scope="module")
def jax_mesh_step(jax_params, inputs):
    """JAX's make_train_step over a 2-device mesh on the same weights and
    global batch: (metrics, parameters after).  Its compile runs while the
    world does (the tests below ask for ``world`` first)."""
    model, params = jax_params
    cfg = JT.TrainConfig(loss="multiscale")
    mesh = jmesh.make_mesh(jax.devices()[:2])
    state, tx = JT.create_train_state(model, None, cfg, params=params)
    step = JT.make_train_step(model, tx, cfg, mesh=mesh)
    state, jm = step(jmesh.replicate(state, mesh),
                     jmesh.shard_batch(inputs["batch"], mesh))
    return ({k: float(v) for k, v in jm.items()},
            state_dict_from_jax(jax.tree.map(np.asarray, state.params)))


def test_train_step_matches_jax_mesh_step(world, jax_mesh_step):
    """The 2-rank step against JAX's 2-device mesh step."""
    jm, jparams = jax_mesh_step
    r0 = world.results()[0]["train"]
    for k in ("loss", "epe"):
        assert r0["metrics"][k] == pytest.approx(jm[k], rel=1e-5), k
    assert r0["metrics"]["grad_norm"] == pytest.approx(jm["grad_norm"],
                                                       rel=1e-4)
    _assert_params_close(r0["params"], jparams, r0["grads"])


def test_both_ranks_ran_every_check(world):
    r0, r1 = world.results()
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["world"] == 2 and r0["backend"] == "gloo"
    # one global program: the ranks agree exactly
    for name in ("train", "accum"):
        assert r0[name]["metrics"] == r1[name]["metrics"]
        for n, p in r0[name]["params"].items():
            assert torch.equal(p, r1[name]["params"][n]), n
    assert r0["eval_step"] == r1["eval_step"]


def test_train_step_matches_single_process(world, inputs):
    """Shards with different valid fractions: the global masked means make
    the 2-rank step the single-process step on the whole batch (the
    trainer test's tolerances)."""
    m, params, grads = _single_step(inputs, inputs["batch"])
    r0 = world.results()[0]["train"]
    assert set(r0["metrics"]) == set(m)
    for k in ("loss", "epe"):
        assert r0["metrics"][k] == pytest.approx(m[k], rel=1e-5), k
    assert r0["metrics"]["grad_norm"] == pytest.approx(m["grad_norm"],
                                                       rel=1e-4)
    _assert_grads_close(r0["grads"], grads)
    _assert_params_close(r0["params"], params, grads)


def test_per_rank_masked_mean_would_miss(inputs):
    """The negative control: each rank's own masked mean, averaged over
    the ranks, misses the loss and gradient tolerances above."""
    model = _model(inputs)
    cfg = TT.TrainConfig(loss="multiscale")
    dev = torch.device("cpu")
    whole = TT.batch_to_device(inputs["batch"], dev)
    with torch.no_grad():
        ref, _ = TT._compute_loss(model, whole, cfg)
    naive, grads = 0.0, None
    for half in range(2):
        model.zero_grad()
        shard = {k: v[half:half + 1] for k, v in whole.items()}
        loss, _ = TT._compute_loss(model, shard, cfg)
        loss.backward()
        naive += float(loss.detach()) / 2
        g = [p.grad.clone() / 2 for p in model.parameters()]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    assert abs(naive - float(ref)) > 1e-3 * abs(float(ref))
    _, _, ref_grads = _single_step(inputs, inputs["batch"])
    with pytest.raises(AssertionError):
        _assert_grads_close(dict(zip(ref_grads, grads)), ref_grads)


def test_grad_accum_and_eval_step_match_single_process(world, inputs):
    """grad_accum=2 on a batch of 4 (shard_batch gives each rank its share
    of each micro-batch), and the eval step's global metrics."""
    m, params, grads = _single_step(inputs, inputs["batch4"], accum=2)
    r0 = world.results()[0]
    for k in ("loss", "epe"):
        assert r0["accum"]["metrics"][k] == pytest.approx(m[k], rel=1e-5)
    assert r0["accum"]["metrics"]["grad_norm"] == pytest.approx(
        m["grad_norm"], rel=1e-4)
    _assert_grads_close(r0["accum"]["grads"], grads)
    _assert_params_close(r0["accum"]["params"], params, grads)
    ev = TT.make_eval_metrics_step(_model(inputs), TT.TrainConfig())(
        inputs["batch"])
    for k, v in ev.items():
        assert r0["eval_step"][k] == pytest.approx(float(v), rel=1e-5), k


@pytest.fixture(scope="module")
def engine(inputs):
    return FlowEngine(_model(inputs), inputs["sd"], device="cpu")


def test_engine_flows_match_one_process(world, inputs, engine):
    """A ragged N=3 (padded to 4, the padding dropped) in pad and resize
    mode, and flow_from_batch, on both ranks equal to one process."""
    for r in world.results():
        for mode, got in r["pairs"].items():
            ref = engine.flow_from_pairs(inputs["im1s"][:3],
                                         inputs["im2s"][:3], size_mode=mode)
            assert got.shape == ref.shape == (3, 60, 70, 2)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                       err_msg=mode)
        np.testing.assert_allclose(
            r["batch_flow"], engine.flow_from_batch(inputs["x64"]).numpy(),
            rtol=0, atol=1e-5)
        assert "not divisible" in r["batch_odd"]


def test_evaluate_pairs_matches_one_process(world, inputs, engine):
    ds = [{"im1": a, "im2": b, "flow": g, "stem": f"p{i}"}
          for i, (a, b, g) in enumerate(zip(inputs["im1s"], inputs["im2s"],
                                            inputs["gts"]))]
    ref = evaluate_pairs(engine, ds, size_mode="pad", batch=2, verbose=False)
    r0, r1 = world.results()
    for r in (r0, r1):
        for k in ("epe", "fl_all", "num_pairs"):
            assert r["eval"][k] == pytest.approx(ref[k], rel=1e-6), k
        assert "multiple of the engine's data-parallel width 2" in \
            r["eval_odd_batch"]
    # only rank 0 saves and prints
    assert r0["eval_saved"] == [f"p{i}.png" for i in range(4)]
    assert "Mean EPE" in r0["eval_printed"]
    assert r1["eval_saved"] == [] and r1["eval_printed"] == ""


def test_lockstep_server_matches_flow_from_pair(world, inputs, engine):
    ref = engine.flow_from_pair(inputs["im1s"][0], inputs["im2s"][0],
                                size_mode="pad")
    for r in world.results():
        assert r["buckets"] == [2]          # collapsed: lockstep
        np.testing.assert_allclose(r["serve"], ref, rtol=0, atol=1e-5)
        assert "positive multiple of the engine's data-parallel width 2" \
            in r["bad_max_batch"]


@pytest.mark.parametrize("name,kw", [
    ("bgr", {}), ("i420", {"upload": "i420", "grid_step": 16})])
def test_video_runner_over_the_mesh_matches_one_process(world, inputs, name,
                                                        kw):
    """Every rank yields the one-process runner's triples: the frames bit
    for bit, the flows to 1e-5; a batch the ranks do not divide is JAX's
    ValueError."""
    from opticalflow_tpu_torch.video import VideoFlowRunner
    one = list(VideoFlowRunner(_model(inputs), None, batch=2, device="cpu",
                               **kw).run(iter(inputs["video"])))
    assert len(one) == 5
    for r in world.results():
        got = r[f"video_{name}"]
        assert len(got) == len(one)
        for (a, b, f), (a1, b1, f1) in zip(got, one):
            np.testing.assert_array_equal(a, a1)
            np.testing.assert_array_equal(b, b1)
            assert f.shape == f1.shape
            np.testing.assert_allclose(f, f1, atol=1e-5, rtol=0)
        stats = r[f"video_{name}_stats"]
        assert stats["windows"] == 3 and stats["bytes_broadcast"] > 0
        assert r["video_odd"] == "batch 3 not divisible by mesh size 2"


def test_replicate_divergent_weights_raises_on_every_rank(world):
    """The JAX copy's fault (its rank 0 compares with itself and hangs):
    here every rank gathers every fingerprint and raises."""
    for r in world.results():
        assert "rank(s) [1] hold different replicated values" in \
            r["divergent"]
        assert r["same"] is None


def test_train_cli_distributed_epoch(world, inputs):
    """Disjoint shards of a common length; only rank 0 logs and saves."""
    r0, r1 = world.results()
    assert r0["cli_epoch"][0] == r1["cli_epoch"][0] == 0
    assert r0["cli_epoch"][1] == r1["cli_epoch"][1] == [1, 2, 3]
    assert len(r0["cli_seen"]) == len(r1["cli_seen"]) == 3
    assert not set(r0["cli_seen"]) & set(r1["cli_seen"])
    run = os.path.join(world.workdir, "run")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3]               # one writer
    assert "saved" in r0["cli_epoch"][2] and "e0 s1" in r0["cli_epoch"][2]
    assert "saved" not in r1["cli_epoch"][2] and "e0 s" not in \
        r1["cli_epoch"][2]
    assert sorted(n for n in os.listdir(run) if n.startswith("step_")) == \
        ["step_3", "step_3.meta.json"]
    assert "--val-frac with --distributed is not supported" in \
        r0["cli_val"][0]


def test_sigterm_on_one_rank_stops_both_and_resume_continues(world):
    """Rank 1 alone gets the SIGTERM after step 1: both ranks stop after
    step 1, rank 0 saves mid-epoch, and --resume runs steps 2-3."""
    r0, r1 = world.results()
    for r in (r0, r1):
        assert r["cli_stop"][:2] == (0, [1])
        assert r["cli_resume"][:2] == (0, [2, 3])
    assert "preempted: saved" in r0["cli_stop"][2]
    assert "resumed from step 1" in r0["cli_resume"][2]


def test_resume_refuses_ranks_that_see_different_steps(world):
    for r in world.results():
        assert "different checkpoint steps per process ([3, -1])" in \
            r["cli_apart"][0]
        assert r["cli_apart"][1] == []


@pytest.mark.parametrize("spec", ["0", "-2", "x", "1.5"])
def test_resolve_data_parallel_refuses_like_jax(spec):
    with pytest.raises(ValueError) as ours:
        meshlib.resolve_data_parallel(spec, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jmesh.resolve_data_parallel(spec)
    assert str(ours.value) == str(theirs.value)


def test_resolve_data_parallel_outside_a_launch():
    """1 is no mesh; N > 1 with nothing launched names the launch command;
    'all' is a one-rank group (every collective runs)."""
    assert meshlib.resolve_data_parallel("1", device="cpu") is None
    with pytest.raises(ValueError, match=(
            r"python -m torch.distributed.run --nproc-per-node 2 "
            r"-m opticalflow_tpu_torch.cli.train .* --data-parallel 2")):
        meshlib.resolve_data_parallel(
            "2", device="cpu", command="opticalflow_tpu_torch.cli.train")
    assert not torch.distributed.is_initialized()
    try:
        mesh = meshlib.resolve_data_parallel("all", device="cpu")
        assert (mesh.world, mesh.rank, mesh.shape) == (1, 0, {"data": 1})
        assert mesh.backend == "gloo" and mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match="does not match the 1 launched"):
            meshlib.resolve_data_parallel("2", device="cpu")
        t = torch.arange(3.0)
        assert torch.equal(meshlib.all_gather_rows(t, mesh), t)
        assert meshlib.any_rank(True, mesh) and not meshlib.any_rank(False,
                                                                      mesh)
    finally:
        meshlib.shutdown()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("chunk,batch", [(None, 4), (8, 4), (None, 3)])
def test_check_eval_cli_mesh_args_like_jax(chunk, batch):
    """The same messages as JAX's for the same mesh width (its check reads
    only ``mesh.shape["data"]``)."""
    mesh = meshlib.Mesh(group=None, rank=0, world=2,
                        device=torch.device("cpu"), backend="gloo")
    results = []
    for check in (meshlib.check_eval_cli_mesh_args,
                  jmesh.check_eval_cli_mesh_args):
        try:
            results.append(check(mesh, chunk, batch))
        except SystemExit as e:
            results.append(str(e))
    assert results[0] == results[1]
    assert (results[0] is None) == (chunk is None and batch % 2 == 0)


def test_shard_batch_rows():
    mesh = meshlib.Mesh(group=None, rank=1, world=2,
                        device=torch.device("cpu"), backend="gloo")
    a = np.arange(8)
    assert meshlib.shard_batch(a, mesh).tolist() == [4, 5, 6, 7]
    # grad_accum=2: this rank's share of each micro-batch ([0..3], [4..7])
    assert meshlib.shard_batch(a, mesh, 2).tolist() == [2, 3, 6, 7]
    t = meshlib.shard_batch({"x": torch.arange(8)}, mesh, 2)["x"]
    assert t.tolist() == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        meshlib.shard_batch(np.arange(3), mesh)
    assert dataclasses.replace(mesh, world=4).shape == {"data": 4}


def test_make_mesh_takes_the_device_distributed_init_selected():
    """With no device, the mesh is on the device the group was joined with
    (here the CPU, asked for); for a group joined otherwise it is the
    current card, and with no card it raises rather than take the CPU."""
    try:
        meshlib.distributed_init(f"127.0.0.1:{free_port()}", 1, 0,
                                 device="cpu", timeout_s=60)
        mesh = meshlib.make_mesh()
        assert (mesh.device, mesh.backend) == (torch.device("cpu"), "gloo")
    finally:
        meshlib.shutdown()
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.HashStore(), world_size=1, rank=0)
    try:
        if torch.cuda.is_available():
            assert meshlib.make_mesh().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                meshlib.make_mesh()
        assert meshlib.make_mesh("cpu").device == torch.device("cpu")
    finally:
        meshlib.shutdown()


@pytest.mark.parametrize("local_world,cards,want", [
    (None, 1, "nccl"), ("1", 1, "nccl"), ("2", 2, "nccl"), ("2", 1, "gloo"),
    ("4", 2, "gloo")])
def test_backend_is_gloo_where_the_ranks_share_cards(monkeypatch, local_world,
                                                     cards, want):
    """NCCL on a card unless the ranks launched on the host
    (``LOCAL_WORLD_SIZE``) outnumber its cards; gloo on the CPU; an
    explicit backend stands."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    card = torch.device("cuda", 0)
    assert meshlib._backend_for(None, card) == want
    assert meshlib._backend_for("nccl", card) == "nccl"
    assert meshlib._backend_for("gloo", card) == "gloo"
    assert meshlib._backend_for(None, torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        meshlib._backend_for("nccl", torch.device("cpu"))
