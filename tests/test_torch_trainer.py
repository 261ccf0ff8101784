"""The port's train step against the JAX package's on the same carried-across
weights and batch, and its own knobs (grad_accum, remat, clipping, the
plateau rule, the eval step), on the CPU.

Two JAX gradient compiles in all (module-scoped fixtures), one per loss,
one JAX forward compile for the validation metrics, and small optax ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet
from opticalflow_tpu.train import trainer as JT
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.models.torch_import import state_dict_from_jax
from opticalflow_tpu_torch.train import trainer as TT


def _batch(b=2, h=64, w=64, seed=0):
    """The JAX tests' batch recipe (``tests/test_train_step.py``)."""
    rng = np.random.RandomState(seed)
    return {
        "images": rng.rand(b, h, w, 6).astype(np.float32),
        "flow": (rng.randn(b, h, w, 2) * 2).astype(np.float32),
        "valid": (rng.rand(b, h, w) > 0.2).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_params():
    model = JaxPWCDCNet(variant="new", precision="highest",
                        use_pallas_corr=False)
    params = jax.jit(lambda r, x: model.init(r, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)))["params"]
    # scaled down as tests/test_torch_model.py does: random kaiming weights
    # at 565-channel depth explode
    return model, jax.tree.map(lambda p: np.asarray(p) * 0.5, params)


CONFIGS = {
    "multiscale": TT.TrainConfig(loss="multiscale"),     # AdamW, clip 1.0
    "charbonnier_full": TT.TrainConfig(loss="charbonnier_full",
                                       optimizer="adam", grad_clip=0.0),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_step(request, jax_params):
    """One JAX step: (cfg, metrics, grads, params after, grad norm)."""
    model, params = jax_params
    cfg = CONFIGS[request.param]
    jcfg = JT.TrainConfig(**dataclasses.asdict(cfg))
    tx = JT.make_optimizer(jcfg)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    @jax.jit
    def run(p):
        (_, m), g = jax.value_and_grad(
            lambda q: JT._compute_loss(model, q, batch, jcfg),
            has_aux=True)(p)
        updates, _ = tx.update(g, tx.init(p), p)
        return m, g, optax.apply_updates(p, updates), optax.global_norm(g)

    m, g, new, norm = run(params)
    tree = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return (cfg, {k: float(v) for k, v in m.items()}, tree(g), tree(new),
            float(norm))


def _port(params, cfg):
    model = PWCDCNet(variant="new", precision="highest")
    state, opt = TT.create_train_state(model, cfg, params=params)
    return state, opt


def test_one_step_matches_jax(jax_params, jax_step):
    _, params = jax_params
    cfg, jm, jgrads, jnew, jnorm = jax_step
    state, opt = _port(params, cfg)
    step = TT.make_train_step(state.model, opt, cfg)
    state, m = step(state, _batch())
    assert state.step == 1
    assert set(m) == set(jm) | {"grad_norm"}
    for k, v in jm.items():     # loss and epe: float32 sums in another order
        assert float(m[k]) == pytest.approx(v, rel=1e-5), k
    assert float(m["grad_norm"]) == pytest.approx(jnorm, rel=1e-4)
    # below the clip, the gradients left on the parameters are the raw ones
    assert not cfg.grad_clip or jnorm < cfg.grad_clip
    grads = state_dict_from_jax(jgrads)
    params_after = state_dict_from_jax(jnew)
    named = dict(state.model.named_parameters())
    assert set(named) == set(grads)
    for name, p in named.items():
        g_ref = grads[name].numpy()
        # gradients through 20 convolution layers and two correlation
        # backwards, summed in another order
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(g_ref).max(),
                                   err_msg=name)
    # The update.  (1) Against optax's chain (JT.make_optimizer) applied to
    # the port's own gradients, every element, within one rounding of p and
    # 1e-5·lr: optax forms Adam's bias correction 1 - β2^t in float32,
    # where 0.999 is not exact, and so scales its first update by 1 - 6.4e-6.
    # (2) Against the JAX step's parameters: Adam's first step is
    # lr·g/(|g|+eps), whose slope at |g| ≈ eps turns the gradients'
    # disagreement above into update differences up to ≈2e-3·lr, so (2)
    # leaves out the elements with |g_jax| < 3·eps (8,278,778 of 9,374,274
    # for multiscale, 8,428,974 for charbonnier_full: random weights'
    # gradients at 64×64 are mostly that small) and holds the rest to
    # 1e-3·lr; (1) covers those left out.
    before = state_dict_from_jax(params)
    tx = JT.make_optimizer(JT.TrainConfig(**dataclasses.asdict(cfg)))
    ref = {n: jnp.asarray(v.numpy()) for n, v in before.items()}
    port_g = {n: jnp.asarray(p.grad.numpy()) for n, p in named.items()}
    optax_after = jax.jit(lambda g, r: optax.apply_updates(
        r, tx.update(g, tx.init(r), r)[0]))(port_g, ref)
    left_out = 0
    for name, p in named.items():
        got = p.detach().numpy()
        p0 = before[name].numpy()
        ulp = np.spacing(np.maximum(np.abs(p0), np.abs(got)))
        err1 = np.abs(got - np.asarray(optax_after[name]))
        assert np.all(err1 <= ulp + 1e-5 * cfg.lr), (name, err1.max())
        keep = np.abs(grads[name].numpy()) >= 3e-8
        left_out += int(keep.size - keep.sum())
        err2 = np.abs(got.astype(np.float64) - params_after[name].numpy())
        assert np.all((err2 <= ulp + 1e-3 * cfg.lr)[keep]), (
            name, err2[keep].max() / cfg.lr)
    # ≈1 M elements held to (2): 945,300 and 1,095,496
    assert sum(p.numel() for p in named.values()) - left_out > 900_000


@pytest.mark.parametrize("cfg", [
    TT.TrainConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0),
    TT.TrainConfig(lr=1e-2, optimizer="adam", grad_clip=0.0),
    TT.TrainConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0,
                   plateau_factor=0.5),
], ids=["adamw_clip", "adam", "adamw_plateau"])
def test_optimizer_steps_match_optax(cfg):
    """Three updates of the port's optimizer behind the step's clip, against
    optax's chain (``JT.make_optimizer``) on the same gradients.  lr 1e-2
    and weight decay 0.1 make the decay visible in float32; gradients that
    change every step make the moments depend on both betas; magnitudes
    from 1e-9 to 1 put eps in play; global norms 3, 0.5 and 2 clip the
    first and last step only, which changes the moments' mix."""
    rng = np.random.RandomState(11)
    shapes = {"a": (3, 4, 5), "b": (7,), "c": (2, 9)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    opt = TT.make_optimizer(cfg, list(params.values()))
    tx = JT.make_optimizer(JT.TrainConfig(**dataclasses.asdict(cfg)))
    ref = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(ref)
    for norm in (3.0, 0.5, 2.0):
        g = {k: rng.choice([-1.0, 1.0], s) * 10.0 ** rng.uniform(-9, 0, s)
             for k, s in shapes.items()}
        scale = norm / np.sqrt(sum((v ** 2).sum() for v in g.values()))
        g = {k: (v * scale).astype(np.float32) for k, v in g.items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        TT.clip_by_global_norm_([p.grad for p in params.values()],
                                cfg.grad_clip)
        opt.step()
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, ref)
        ref = optax.apply_updates(ref, updates)
        for k, p in params.items():
            # a few roundings of p (|p| < 4) apart; a wrong beta moves the
            # second step by ≥5e-5, a wrong eps or decay by more
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[k]),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_eval_metrics_step_matches_jax_loss(jax_params, jax_step):
    _, params = jax_params
    cfg, jm, _, _, _ = jax_step
    state, _ = _port(params, cfg)
    m = TT.make_eval_metrics_step(state.model, cfg)(_batch())
    for k, v in jm.items():
        assert float(m[k]) == pytest.approx(v, rel=1e-5), k
    assert all(p.grad is None for p in state.model.parameters())


def _grads(model, cfg, batch):
    """The gradients of one step's loss (no update)."""
    model.zero_grad(set_to_none=True)
    b = TT.batch_to_device(batch, torch.device("cpu"))
    loss, _ = TT._compute_loss(model, b, cfg)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def port_model(jax_params):
    model = PWCDCNet(variant="new", precision="highest")
    model.load_state_dict(state_dict_from_jax(jax_params[1]))
    return model


def test_grad_accum_matches_full_batch(port_model):
    """grad_accum=2 averages the micro-batches' gradients: with valid=ones
    every micro-batch normalises alike, so the average is the full-batch
    gradient up to the order of the sums.  SGD(1.0) without clipping makes
    the parameter change the gradient itself."""
    cfg = TT.TrainConfig(loss="multiscale", grad_clip=0.0)
    batch = _batch()
    batch["valid"] = np.ones_like(batch["valid"])
    init = {k: v.clone() for k, v in port_model.state_dict().items()}

    def run(cfg_k):
        port_model.load_state_dict(init)
        opt = torch.optim.SGD(port_model.parameters(), lr=1.0)
        state = TT.TrainState(step=0, model=port_model, optimizer=opt)
        _, m = TT.make_train_step(port_model, opt, cfg_k)(state, batch)
        return {k: v.clone() for k, v in port_model.state_dict().items()}, m

    p1, m1 = run(cfg)
    p2, m2 = run(dataclasses.replace(cfg, grad_accum=2))
    port_model.load_state_dict(init)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-4)
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        run(dataclasses.replace(cfg, grad_accum=3))


@pytest.mark.parametrize("remat", [True, "l2"])
def test_remat_matches_no_remat_grads(port_model, remat):
    """Recomputing in the backward (the whole forward, or level 2's
    estimator and the context network) gives the no-remat gradients: the
    bound the JAX package's remat test holds."""
    cfg = TT.TrainConfig(loss="multiscale")
    g0 = _grads(port_model, cfg, _batch())
    gr = _grads(port_model, dataclasses.replace(cfg, remat=remat), _batch())
    for k in g0:
        torch.testing.assert_close(gr[k], g0[k], atol=1e-6, rtol=0)


def test_clip_is_optax_global_norm_rule():
    """g·max/‖g‖ once ‖g‖ reaches max, as optax.clip_by_global_norm."""
    rng = np.random.RandomState(3)
    arrays = [rng.randn(3, 4).astype(np.float32),
              rng.randn(5).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        grads = [torch.from_numpy(a.copy()) for a in arrays]
        norm = TT.clip_by_global_norm_(grads, max_norm)
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(a) for a in arrays], None)
        assert float(norm) == pytest.approx(
            float(optax.global_norm([jnp.asarray(a) for a in arrays])),
            rel=1e-6)
        for g, r in zip(grads, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("loss", ["proxy", "proxy_epipolar"])
def test_proxy_steps_run(port_model, loss):
    cfg = TT.TrainConfig(loss=loss)
    batch = {"images": _batch()["images"]}
    if loss == "proxy_epipolar":
        batch["photo_mask"] = (np.random.RandomState(5).rand(2, 64, 64)
                               > 0.4).astype(np.float32)
    init = {k: v.clone() for k, v in port_model.state_dict().items()}
    state, opt = TT.create_train_state(port_model, cfg)
    state, m = TT.make_train_step(port_model, opt, cfg)(state, batch)
    port_model.load_state_dict(init)
    for k in ("loss", "photo", "smooth", "grad_norm"):
        assert np.isfinite(float(m[k])), k


def test_unported_options_raise(port_model):
    opt = torch.optim.SGD(port_model.parameters(), lr=0.0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        TT.make_train_step(port_model, opt, TT.TrainConfig(), mesh=object())
    with pytest.raises(ValueError, match="unknown loss"):
        TT.make_train_step(port_model, opt, TT.TrainConfig(loss="l1"))
    with pytest.raises(ValueError, match="unknown optimizer"):
        TT.make_optimizer(TT.TrainConfig(optimizer="sgd"),
                          port_model.parameters())


def _lr_state(cfg):
    w = torch.nn.Parameter(torch.ones(3))
    opt = TT.make_optimizer(cfg, [w])
    return TT.TrainState(step=0, model=torch.nn.Module(), optimizer=opt)


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_plateau_controller_reduces_lr(grad_clip):
    """The rule of ``tests/test_train_step.py``'s plateau test, on the
    param groups' learning rate."""
    cfg = TT.TrainConfig(lr=1e-3, grad_clip=grad_clip, plateau_factor=0.5,
                         plateau_patience=2)
    state = _lr_state(cfg)
    lr = lambda: state.optimizer.param_groups[0]["lr"]   # noqa: E731
    pc = TT.PlateauController(cfg)
    state = pc.step(state, 1.0)            # establishes best
    state = pc.step(state, 1.0)            # bad epoch 1
    assert lr() == pytest.approx(1e-3)
    state = pc.step(state, 1.0)            # bad epoch 2 → reduce
    assert lr() == pytest.approx(5e-4)
    state = pc.step(state, 0.5)            # improvement resets the count
    state = pc.step(state, 0.6)
    assert lr() == pytest.approx(5e-4)
    # the optimizer still steps at the new rate
    w = state.optimizer.param_groups[0]["params"][0]
    w.grad = torch.ones(3)
    state.optimizer.step()
    assert torch.all(w < 1.0)


def test_plateau_controller_requires_a_plateau_optimizer():
    cfg = TT.TrainConfig(lr=1e-3, plateau_factor=0.0)
    state = _lr_state(cfg)                 # built with plateau off
    pc = TT.PlateauController(dataclasses.replace(cfg, plateau_factor=0.5,
                                                  plateau_patience=1))
    state = pc.step(state, 1.0)
    with pytest.raises(ValueError, match="plateau"):
        pc.step(state, 1.0)
    # with plateau off in the controller too, nothing happens
    off = TT.PlateauController(cfg)
    for _ in range(5):
        state = off.step(state, 1.0)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)


def test_selfsup_metrics_match_jax(jax_params, port_model):
    """The no-GT validation signals on both frame orders, against
    ``opticalflow_tpu.train.validate`` (one jitted JAX forward)."""
    from opticalflow_tpu.train.validate import selfsup_metrics as jax_metrics
    from opticalflow_tpu_torch.train.validate import selfsup_metrics
    model, params = jax_params
    images = _batch(b=1, seed=7)["images"]
    ref = jax.jit(lambda p, x: jax_metrics(model, p, x, flow_scale=20.0))(
        params, jnp.asarray(images))
    ours = selfsup_metrics(port_model, images, flow_scale=20.0)
    assert set(ours) == set(ref) == {"photometric", "fb_cycle", "oob_ratio"}
    for k in ref:
        # the forward's bound (tests/test_torch_model.py), carried through
        # a warp and a mean
        assert float(ours[k]) == pytest.approx(float(ref[k]), rel=1e-4,
                                               abs=1e-5), k
