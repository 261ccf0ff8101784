"""The port's export (``torch.export`` artifact with the correlation
operator), parity CLI, pruning, checkpoint converter, complexity table and
debugging utilities on the CPU, held to ``tests/test_export_prune.py``'s
cases and to the JAX package on the same weights and inputs.

One ``dynamic="all"`` export (module fixture) serves every artifact test."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from opticalflow_tpu.export import export_stablehlo
from opticalflow_tpu.export import load_exported as jax_load_exported
from opticalflow_tpu.models import prune as jax_prune
from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet
from opticalflow_tpu.utils.profiling import param_count as jax_param_count
from opticalflow_tpu_torch import export as E
from opticalflow_tpu_torch.cli import convert_ckpt, extract_video, parity
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.models import prune
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.models.torch_import import state_dict_from_jax
from opticalflow_tpu_torch.ops.correlation import correlation
from opticalflow_tpu_torch.train import checkpoints as ckpt
from opticalflow_tpu_torch.utils import debugging, profiling
from opticalflow_tpu_torch.viz.colorwheel import flow_to_color, magma_rgb

OP = "opticalflow_tpu_torch.correlation"


@pytest.fixture(scope="module")
def jax_small():
    """The JAX model of ``tests/test_export_prune.py`` and its initial
    weights, and the port's model carrying them."""
    model = JaxPWCDCNet(variant="new", precision="highest",
                        use_pallas_corr=False)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 6)))["params"]
    params = jax.tree.map(np.asarray, params)
    port = PWCDCNet()
    port.load_state_dict(state_dict_from_jax(params))
    return model, params, port.eval()


@pytest.fixture(scope="module")
def artifact(jax_small, tmp_path_factory):
    """One ``dynamic="all"`` export of the port's model, through the
    correlation operator, and the loaded artifact."""
    _, _, model = jax_small
    path = str(tmp_path_factory.mktemp("export") / "dyn.pt2")
    E.export_program(model, path, dynamic="all")
    return path, E.load_exported(path)


def _flow_tol(ref):
    # 1e-5 relative to the flow's largest component: the frameworks sum the
    # float32 convolutions in other orders (tests/test_torch_serve.py)
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


# ----------------------------------------------------------------- export

def test_dynamic_artifact_calls_the_correlation_operator(artifact):
    _, fn = artifact
    targets = [str(n.target) for n in fn.program.graph.nodes
               if n.op == "call_function"]
    assert sum(OP in t for t in targets) == 5      # levels 6..2
    assert fn.metadata["precision"] == "highest"
    assert fn.metadata["dynamic"] == "all"
    assert fn.metadata["flow_scale"] == 20.0
    assert fn.device == torch.device("cpu")


@pytest.mark.parametrize("b,h,w", [(1, 64, 64), (3, 64, 64), (2, 128, 192)])
def test_dynamic_artifact_serves_every_shape(artifact, jax_small, b, h, w):
    """One ``"all"`` artifact serves every batch and /64 size of JAX's
    dynamic test, 64x64 included (level 6 is 1 pixel wide there), at that
    test's bounds."""
    _, fn = artifact
    _, _, model = jax_small
    x = np.random.RandomState(b).rand(b, 6, h, w).astype(np.float32)
    got = fn(x)
    assert got.shape == (b, 2, h // 4, w // 4)
    with torch.no_grad():
        want = model(torch.from_numpy(x)) * 20.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_artifact_refuses_a_shape_outside_its_dims(artifact):
    _, fn = artifact
    with pytest.raises(Exception, match="64"):
        fn(torch.zeros(1, 6, 96, 64))


def test_artifact_matches_the_jax_artifact(artifact, jax_small, tmp_path):
    """The port's artifact and the JAX package's StableHLO artifact on the
    same input (``parity_check``'s: ``RandomState(0).rand`` of the NHWC
    shape, transposed for the port)."""
    jmodel, params, _ = jax_small
    path = str(tmp_path / "m.stablehlo")
    export_stablehlo(jmodel, params, path, input_shape=(1, 64, 64, 6))
    x = np.random.RandomState(0).rand(1, 64, 64, 6).astype(np.float32)
    want = np.asarray(jax_load_exported(path)(jnp.asarray(x)))
    _, fn = artifact
    got = fn(x.transpose(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 16, 16, 2)
    np.testing.assert_allclose(got, want, atol=_flow_tol(want), rtol=0)


def test_static_export_and_parity_check(jax_small, tmp_path):
    _, _, model = jax_small
    path = str(tmp_path / "static.pt2")
    E.export_program(model, path, input_shape=(1, 6, 64, 64))
    rep = E.parity_check(model, path, input_shape=(1, 6, 64, 64),
                         report_image=str(tmp_path / "report.png"))
    assert rep["epe_mean"] < 1e-5
    assert rep["agree@0.25"] == 100.0
    assert (tmp_path / "report.png").exists()
    fn = E.load_exported(path)
    assert fn.metadata["dynamic"] is None
    with pytest.raises(Exception):
        fn(torch.zeros(2, 6, 64, 64))     # the batch is fixed


def test_export_error_says_what_to_change(tmp_path):
    class ShapeBranch(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(6, 2, 1)

        def forward(self, x):
            return self.conv(x) * (2.0 if x.shape[0] > 2 else 1.0)

    with pytest.raises(ValueError, match="dynamic=None"):
        E.export_program(ShapeBranch(), str(tmp_path / "x.pt2"),
                         input_shape=(1, 6, 64, 64), dynamic="batch")
    with pytest.raises(ValueError, match="dynamic must be"):
        E.export_program(ShapeBranch(), str(tmp_path / "x.pt2"),
                         dynamic="height")
    with pytest.raises(ValueError, match="multiples of 64"):
        E.export_program(ShapeBranch(), str(tmp_path / "x.pt2"),
                         input_shape=(1, 6, 64, 100))


def test_report_figure_panels():
    """Every pixel of each panel: both flows by ``flow_to_color`` and the
    EPE map by matplotlib's magma (over the map's [min, max]), enlarged by
    an integer factor; each panel lies in the figure where it is placed."""
    import matplotlib
    rng = np.random.RandomState(2)
    src = (rng.randn(16, 24, 2) * 3).astype(np.float32)
    art = src + (rng.randn(16, 24, 2) * 0.01).astype(np.float32)
    rep = {"epe_mean": 0.0123, "agree@0.25": 100.0}
    fig, placed = E.report_figure(src, art, rep)
    assert set(placed) == {"source", "artifact", "epe", "metrics"}
    k = 256 // 24

    def big(img):
        return np.repeat(np.repeat(img, k, axis=0), k, axis=1)

    err = np.sqrt(((src.astype(np.float64) - art) ** 2).sum(-1))
    norm = (err - err.min()) / (err.max() - err.min())
    want = {"source": big(flow_to_color(src)),
            "artifact": big(flow_to_color(art)),
            "epe": big(matplotlib.colormaps["magma"](norm, bytes=True)
                       [..., :3])}
    for name, panel_want in want.items():
        y, x, panel = placed[name]
        np.testing.assert_array_equal(panel, panel_want, err_msg=name)
        np.testing.assert_array_equal(
            fig[y:y + panel.shape[0], x:x + panel.shape[1]], panel)
    y, x, text = placed["metrics"]
    assert (text < 128).any() and (text == 255).any()   # text on white
    np.testing.assert_array_equal(
        fig[y:y + text.shape[0], x:x + text.shape[1]], text)
    # an exact artifact: the EPE map is all zero, drawn as magma's first
    _, placed0 = E.report_figure(src, src, rep)
    np.testing.assert_array_equal(
        placed0["epe"][2], big(magma_rgb(np.zeros((16, 24)))))


def test_magma_table_equals_matplotlib():
    import matplotlib
    with np.load(os.path.join(os.path.dirname(E.__file__), "viz",
                              "magma.npz")) as z:
        table = z["magma"]
    np.testing.assert_array_equal(
        table, matplotlib.colormaps["magma"](np.arange(256))[:, :3])
    x = np.concatenate([np.linspace(-0.5, 1.5, 4001), [np.nan]])
    np.testing.assert_array_equal(
        magma_rgb(x), matplotlib.colormaps["magma"](x, bytes=True)[..., :3])


def _save_reference_ckpt(sd, path):
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)


def test_parity_cli(jax_small, tmp_path, capsys):
    """``cli/parity`` exports, checks and passes; its report PNG is the
    figure of the model's and the artifact's flows on the seed-0 input."""
    _, _, model = jax_small
    ref = str(tmp_path / "w.pth.tar")
    _save_reference_ckpt(model.state_dict(), ref)
    art = str(tmp_path / "sub" / "model.pt2")
    png = str(tmp_path / "report.png")
    rc = parity.main(["--ckpt", ref, "--artifact", art, "--shape", "1", "64",
                      "64", "--report-image", png, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "PARITY: PASS" in out and f"exported {art}" in out
    rep = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert rep["epe_mean"] <= 1e-5 and rep["agree@0.25"] == 100.0
    x = np.random.RandomState(0).rand(1, 64, 64, 6).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        src = (model(xt) * 20.0).permute(0, 2, 3, 1).numpy()
    got = E.load_exported(art)(xt).permute(0, 2, 3, 1).numpy()
    fig, _ = E.report_figure(src[0], got[0], rep)
    with open(png, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()), fig)
    # --skip-export reuses the artifact
    assert parity.main(["--ckpt", ref, "--artifact", art, "--shape", "1",
                        "64", "64", "--skip-export", "--device", "cpu"]) == 0
    assert "exported" not in capsys.readouterr().out


# ---------------------------------------------------------- convert_ckpt

def test_convert_ckpt_round_trip(jax_small, tmp_path, capsys):
    _, _, model = jax_small
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ref = str(tmp_path / "ref.pth.tar")
    _save_reference_ckpt(sd, ref)
    out_dir = str(tmp_path / "native")
    assert convert_ckpt.main([ref, out_dir]) == 0
    restored = ckpt.restore_train_state(out_dir)
    assert restored["step"] == 0
    assert restored["metadata"] == {"source": ref, "variant": "new"}
    back = str(tmp_path / "back.pth.tar")
    assert convert_ckpt.main([out_dir, back, "--to-torch"]) == 0
    data = torch.load(back, weights_only=True)
    assert set(data) == {"state_dict"}
    assert set(data["state_dict"]) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(data["state_dict"][k], v, rtol=0, atol=0)
    # the round trip's file loads strictly into a fresh model
    PWCDCNet().load_state_dict(ckpt.load_params(back))
    # a step directory works as well as a run directory
    assert convert_ckpt.main([os.path.join(out_dir, "step_0"),
                              str(tmp_path / "b2.pth.tar"),
                              "--to-torch"]) == 0


def test_convert_ckpt_refuses_orbax_and_the_wrong_variant(jax_small,
                                                          tmp_path):
    orbax = tmp_path / "orbax" / "0"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(SystemExit, match="orbax"):
        convert_ckpt.main([str(tmp_path / "orbax"), str(tmp_path / "x")])
    _, _, model = jax_small
    ref = str(tmp_path / "ref.pth.tar")
    _save_reference_ckpt(model.state_dict(), ref)
    with pytest.raises(RuntimeError, match="state_dict"):
        convert_ckpt.main([ref, str(tmp_path / "y"), "--variant", "old"])


# ------------------------------------------------------------------ prune

def test_magnitude_prune_mask_equals_jax(jax_small):
    """The same global ``np.quantile`` threshold: on carried-over weights
    the zeros are where JAX's are, the survivors unchanged, biases
    untouched; the global sparsity report equals JAX's."""
    _, params, model = jax_small
    jax_pruned = state_dict_from_jax(jax.tree.map(
        np.asarray, jax_prune.magnitude_prune(params, amount=0.3)))
    sd = model.state_dict()
    pruned = prune.magnitude_prune(sd, amount=0.3)
    assert set(pruned) == set(sd)
    for k in sd:
        if k.endswith(".bias"):
            assert torch.equal(pruned[k], sd[k]), k
            continue
        torch.testing.assert_close(pruned[k] == 0, jax_pruned[k] == 0,
                                   rtol=0, atol=0, msg=k)
        keep = pruned[k] != 0
        assert torch.equal(pruned[k][keep], sd[k][keep]), k
    # the same report, layer by layer, under the same names
    rep = prune.sparsity_report(pruned)
    assert rep == jax_prune.sparsity_report(
        jax_prune.magnitude_prune(params, amount=0.3))
    assert 0.25 < rep["_global"][1] < 0.35
    assert prune.sparsity_report(sd)["_global"] == \
        jax_prune.sparsity_report(params)["_global"]


def test_prune_a_module_in_place(jax_small):
    _, _, model = jax_small
    m = PWCDCNet()
    m.load_state_dict(model.state_dict())
    assert prune.magnitude_prune(m, amount=0.3) is m
    rep = prune.sparsity_report(m)
    assert rep["_global"] == prune.sparsity_report(
        prune.magnitude_prune(model.state_dict(), 0.3))["_global"]
    assert rep["conv1a"][0] == 16 * 3 * 3 * 3
    assert len(rep) - 1 == sum(
        isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d))
        for mod in m.modules())


def test_random_prune(jax_small):
    """The reference's criterion: about ``amount`` of the kernels zeroed,
    seeded, only weights changed (its draws cannot be jax.random's)."""
    _, _, model = jax_small
    sd = model.state_dict()
    pruned = prune.random_prune(sd, amount=0.3, seed=0)
    _, frac = prune.sparsity_report(pruned)["_global"]
    assert 0.25 < frac < 0.35
    for k in sd:
        if k.endswith(".bias"):
            assert torch.equal(pruned[k], sd[k])
        else:
            keep = pruned[k] != 0
            assert torch.equal(pruned[k][keep], sd[k][keep])
    again = prune.random_prune(sd, amount=0.3, seed=0)
    other = prune.random_prune(sd, amount=0.3, seed=1)
    assert all(torch.equal(pruned[k], again[k]) for k in sd)
    assert not all(torch.equal(pruned[k], other[k]) for k in sd)


# -------------------------------------------------------------- profiling

def _analytic_conv_flops(model, x):
    """2 FLOPs per multiply-add of every convolution (over its output) and
    transposed convolution (over its input), from the shapes the forward
    gives each module."""
    total = []

    def hook(mod, inp, out):
        (xin,) = inp
        kh, kw = mod.kernel_size
        if isinstance(mod, nn.ConvTranspose2d):
            n, _, h, w = xin.shape
        else:
            n, _, h, w = out.shape
        total.append(2 * n * h * w * mod.in_channels * mod.out_channels
                     * kh * kw)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))
             and not isinstance(m, nn.Sequential)]
    # ConvLR calls its conv's weight directly: hook the ConvLR itself
    hooks += [m.register_forward_hook(
        lambda mod, inp, out: hook(mod[0], inp, out))
        for m in model.modules() if type(m).__name__ == "ConvLR"]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return sum(total)


def test_model_complexity(jax_small):
    """Params equal JAX's ``param_count``; the FLOPs are the convolutions'
    (the analytic count), what FlopCounterMode counts."""
    _, params, model = jax_small
    rep = profiling.model_complexity(model, input_shape=(1, 6, 64, 128))
    assert rep["params"] == jax_param_count(params)
    assert 9_000_000 < rep["params"] < 10_000_000
    assert rep["params_m"] == pytest.approx(rep["params"] / 1e6)
    want = _analytic_conv_flops(model, torch.zeros(1, 6, 64, 128))
    assert rep["flops"] == want
    assert rep["gmacs"] == pytest.approx(want / 2e9)
    assert rep["input_shape"] == (1, 6, 64, 128)


def test_per_layer_complexity_table(jax_small):
    """Every module the JAX test names is a row, with its params and FLOPs;
    the rows' FLOPs add up to the total."""
    _, _, model = jax_small
    txt = profiling.per_layer_complexity(model, (1, 6, 64, 64))
    for mod in ("conv1a", "conv6b", "conv2_4", "predict_flow2", "dc_conv7"):
        assert mod in txt, mod
    assert "flops" in txt and "params" in txt
    lines = txt.splitlines()
    rows = {ln.split()[0]: ln.split() for ln in lines[2:]
            if ln.split() and ln.split()[0] in dict(model.named_children())}
    assert set(rows) == set(dict(model.named_children()))
    assert rows["conv1a"][2] == "2x16x32x32"       # the siamese 2B batch
    assert int(rows["conv1a"][3].replace(",", "")) == 16 * 3 * 9 + 16
    flops = sum(int(r[4].replace(",", "")) for r in rows.values())
    total = next(ln for ln in lines if ln.startswith("total")).split()
    assert int(total[4].replace(",", "")) == flops == \
        _analytic_conv_flops(model, torch.zeros(1, 6, 64, 64))


def test_timeit_and_trace(tmp_path):
    lin = nn.Linear(8, 8)
    t = profiling.timeit(lin, torch.zeros(2, 8), iters=2, warmup=1)
    assert t["mean_s"] > 0 and t["iters_per_s"] > 0
    with profiling.trace(str(tmp_path / "tr")):
        lin(torch.zeros(2, 8))
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert profiling.flops_estimate(lin, torch.zeros(2, 8)) == 2 * 2 * 8 * 8
    assert profiling.flops_estimate(lin, torch.zeros(2, 9)) is None


def test_extract_video_complexity(jax_small, tmp_path):
    """``extract_video --complexity`` prints the table and the totals at
    model load, then runs as usual."""
    _, _, model = jax_small
    ref = str(tmp_path / "w.pth.tar")
    _save_reference_ckpt(model.state_dict(), ref)
    clip = str(tmp_path / "clip.y4m")
    wr = vio.Y4MWriter(clip, 25.0, (64, 64))
    rng = np.random.RandomState(0)
    for _ in range(2):
        wr.write(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8))
    wr.release()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = extract_video.main([clip, str(tmp_path / "out.y4m"), "--ckpt",
                                 ref, "--dtype", "float32", "--batch", "1",
                                 "--device", "cpu", "--complexity"])
    out = buf.getvalue()
    assert rc == 0
    assert "predict_flow2" in out and "dc_conv7" in out and "flops" in out
    n = jax_param_count(jax_small[1])
    assert f"params: {n / 1e6:.2f} M" in out
    gmac = _analytic_conv_flops(model, torch.zeros(1, 6, 384, 512)) / 2e9
    assert f"{gmac:.1f} GMac @ (1, 6, 384, 512)" in out


# -------------------------------------------------------------- debugging

def test_nan_guard_raises_at_the_first_nan(jax_small):
    _, _, model = jax_small
    m = PWCDCNet()
    m.load_state_dict(model.state_dict())
    x = torch.rand(1, 6, 64, 64)
    with debugging.nan_guard(), torch.no_grad():
        m(x)                                  # clean: no raise
    with torch.no_grad():
        m.conv3aa[0].weight[0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="aten.convolution"):
        with debugging.nan_guard(), torch.no_grad():
            m(x)
    with torch.no_grad():                     # outside: no guard
        assert torch.isnan(m(x)).any()
    x2 = x.clone()
    x2[0, 0, 5, 5] = float("nan")
    with pytest.raises(FloatingPointError):
        with debugging.nan_guard():
            torch.rand(3) * x2.sum()


def _traced_targets(fn, *args):
    ep = torch.export.export(fn, args)
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]


def test_interpret_kernels_forces_the_plain_path():
    """Inside it, the given model's correlation takes its plain version: a
    traced forward is the plain operators, not the kernel's operator node.
    Its selectors are restored on exit, errors included; other models and
    the dispatcher itself keep the kernel; a model without a selector is
    refused."""

    class Corr(nn.Module):
        def __init__(self):
            super().__init__()
            self.use_cuda_corr = True

        def forward(self, a, b):
            return correlation(a, b, pad_size=4, max_displacement=4,
                               use_cuda=self.use_cuda_corr)

    class Pair(nn.Module):
        def __init__(self):
            super().__init__()
            self.inner, self.other = Corr(), Corr()

    a, b = torch.rand(1, 8, 6, 7), torch.rand(1, 8, 6, 7)
    m, bystander = Corr(), Corr()
    assert any(OP in t for t in _traced_targets(m, a, b))
    with debugging.interpret_kernels(m):
        with debugging.interpret_kernels(m):
            assert m.use_cuda_corr is False
        assert m.use_cuda_corr is False
        targets = _traced_targets(m, a, b)
        assert any(OP in t for t in _traced_targets(bystander, a, b))
        out = m(a, b)
    assert not any(OP in t for t in targets)
    assert m.use_cuda_corr is True
    pair = Pair()
    pair.other.use_cuda_corr = False
    with pytest.raises(KeyError):
        with debugging.interpret_kernels(pair):
            assert not pair.inner.use_cuda_corr
            raise KeyError("x")
    assert pair.inner.use_cuda_corr is True
    assert pair.other.use_cuda_corr is False
    net = PWCDCNet()
    with debugging.interpret_kernels(net):
        assert net.use_cuda_corr is False
    assert net.use_cuda_corr is True
    with pytest.raises(TypeError, match="use_cuda_corr"):
        with debugging.interpret_kernels(nn.Linear(2, 2)):
            pass
    torch.testing.assert_close(out, m(a, b), rtol=0, atol=0)


def test_check_finite():
    good = {"a": torch.ones(3), "b": {"c": np.zeros(2)},
            "n": torch.arange(3), "l": [torch.zeros(1)]}
    debugging.check_finite(good)
    bad = {"a": torch.tensor([1.0, float("inf"), float("nan")]),
           "b": {"c": np.array([np.nan, 1.0])}, "ok": torch.ones(2),
           "l": [torch.zeros(1), torch.tensor([float("-inf")])]}
    with pytest.raises(ValueError) as e:
        debugging.check_finite(bad, "state")
    msg = str(e.value)
    assert msg.startswith("non-finite values in state: ")
    assert "a (2/3 non-finite)" in msg and "b/c (1/2 non-finite)" in msg
    assert "l/1 (1/1 non-finite)" in msg and "ok" not in msg
    m = nn.Linear(2, 2)
    with torch.no_grad():
        m.bias[0] = float("nan")
    with pytest.raises(ValueError, match=r"bias \(1/2"):
        debugging.check_finite(m)
