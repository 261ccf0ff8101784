"""The port's evaluation runner, metrics and eval CLIs on the CPU: the
port's ``evaluate_pairs`` against the JAX package's on the stub engine and
datasets of ``tests/test_evaluate.py`` (padding, shape groups, bounded
residency, error forwarding, no-GT NaN), ``utils.metrics`` against the JAX
package's, and both CLIs end to end on tiny synthetic trees."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import os
import threading
import time

import numpy as np
import pytest
import torch

from opticalflow_tpu import evaluate as jevaluate
from opticalflow_tpu.utils import metrics as jmetrics
from opticalflow_tpu_torch import evaluate
from opticalflow_tpu_torch.cli import eval_sintel, infer_kitti
from opticalflow_tpu_torch.engine import FlowEngine
from opticalflow_tpu_torch.io import images
from opticalflow_tpu_torch.io.flo import read_flo, write_flo
from opticalflow_tpu_torch.io.kitti import write_flow_png
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.parallel import mesh
from opticalflow_tpu_torch.utils import metrics
from oracles.torch_pwcnet import OraclePWC
from test_evaluate import LazyDataset, StubDataset, StubEngine


def _three_shapes():
    ds = StubDataset(4)
    s = ds.samples[2]
    for k in ("im1", "im2", "flow", "valid"):
        s[k] = s[k][:32]
    return ds


SCENARIOS = {
    "perfect": (lambda: StubDataset(), {}, {}),
    "pads_final_chunk": (lambda: StubDataset(3), {}, {"batch": 2}),
    "groups_by_shape": (_three_shapes, {}, {"batch": 4}),
    "wrong_flow": (lambda: StubDataset(), {"flow_uv": (5.0, 3.0)}, {}),
    "limit_and_size_mode": (lambda: StubDataset(), {},
                            {"size_mode": "resize", "limit": 2}),
    "streaming_bounded": (lambda: LazyDataset(30), {}, {"batch": 4}),
    "streaming_wrong": (lambda: LazyDataset(9), {"flow_uv": (5.0, 3.0)},
                        {"batch": 2}),
    "no_gt": (lambda: StubDataset(with_gt=False), {}, {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_evaluate_pairs_matches_jax(name):
    make_ds, eng_kw, kw = SCENARIOS[name]
    ours_eng, ref_eng = StubEngine(**eng_kw), StubEngine(**eng_kw)
    ours = evaluate.evaluate_pairs(ours_eng, make_ds(), verbose=False, **kw)
    ref = jevaluate.evaluate_pairs(ref_eng, make_ds(), verbose=False, **kw)
    assert ours_eng.calls == ref_eng.calls    # batches, shapes and modes
    assert set(ours) == set(ref)
    for k in ref:
        if k == "peak_resident":
            # timing-dependent: bounded by ~2 batches in both
            assert ours[k] <= 2 * kw.get("batch", 8) + 1
        else:
            np.testing.assert_equal(ours[k], ref[k])


@pytest.mark.parametrize("fmt", ["kitti_png", "flo"])
def test_save_formats_need_no_opencv(tmp_path, fmt):
    evaluate.evaluate_pairs(StubEngine(), StubDataset(2), batch=2,
                            save_dir=str(tmp_path), save_format=fmt,
                            verbose=False)
    names = sorted(p.name for p in tmp_path.iterdir())
    ext = "png" if fmt == "kitti_png" else "flo"
    assert names == [f"s0.{ext}", f"s1.{ext}"]
    if fmt == "flo":
        np.testing.assert_allclose(read_flo(str(tmp_path / "s0.flo"))[0, 0],
                                   [2.0, -1.0])


def test_dataset_error_raises_instead_of_hanging():
    class _BadDS(StubDataset):
        def __getitem__(self, i):
            if i == 2:
                raise IOError("corrupt png")
            return self.samples[i]

    with pytest.raises(IOError, match="corrupt png"):
        evaluate.evaluate_pairs(StubEngine(), _BadDS(4), batch=4,
                                verbose=False)


def test_engine_error_unblocks_producer_thread():
    class _Boom:
        def flow_from_pairs(self, *a, **k):
            raise RuntimeError("engine boom")

    class _DS:
        def __len__(self):
            return 64

        def __getitem__(self, i):
            z = np.zeros((8, 8, 3), np.uint8)
            return {"im1": z, "im2": z, "stem": str(i)}

    with pytest.raises(RuntimeError, match="engine boom"):
        evaluate.evaluate_pairs(_Boom(), _DS(), batch=4, verbose=False)
    for _ in range(40):
        if not any(t.name == "evaluate-producer" and t.is_alive()
                   for t in threading.enumerate()):
            break
        time.sleep(0.1)
    else:
        raise AssertionError("evaluate-producer thread leaked")


@pytest.mark.parametrize("with_valid", [False, True])
def test_metrics_match_jax(with_valid):
    rng = np.random.RandomState(1)
    a = (rng.randn(13, 17, 2) * 4).astype(np.float32)
    b = (rng.randn(13, 17, 2) * 4).astype(np.float32)
    v = rng.rand(13, 17) > 0.4 if with_valid else None
    np.testing.assert_array_equal(metrics.epe_map(a, b),
                                  jmetrics.epe_map(a, b))
    assert metrics.epe(a, b, v) == jmetrics.epe(a, b, v)
    assert metrics.fl_all(a, b, v) == jmetrics.fl_all(a, b, v)
    assert metrics.parity_report(a, b) == jmetrics.parity_report(a, b)
    none = np.zeros((13, 17), bool)
    assert np.isnan(metrics.epe(a, b, none))
    assert np.isnan(metrics.fl_all(a, b, none))


@pytest.fixture(scope="module")
def fake_ckpt(tmp_path_factory):
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for p in net.parameters():
        p.data *= 0.5
    sd = net.state_dict_flat()
    path = str(tmp_path_factory.mktemp("ckpt") / "fake.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    return sd, path


def _write_u8(path, img):
    with open(path, "wb") as f:
        f.write(images.encode_png(img))


def _pair(rng, h, w):
    im1 = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return im1, np.roll(im1, (1, 2), axis=(0, 1))


def test_infer_kitti_cli_on_the_cpu(tmp_path, fake_ckpt, capsys):
    """3 pairs at batch 2 (the last chunk padded), GT written by the port
    from its own engine at batch 1: the EPE is the PNG's 1/64 px
    truncation."""
    sd, ckpt = fake_ckpt
    base = tmp_path / "training"
    (base / "image_2").mkdir(parents=True)
    (base / "flow_occ").mkdir()
    rng = np.random.RandomState(2)
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cpu")
    for i in range(3):
        im1, im2 = _pair(rng, 40, 70)
        _write_u8(str(base / "image_2" / f"{i:06d}_10.png"), im1)
        _write_u8(str(base / "image_2" / f"{i:06d}_11.png"), im2)
        flow = engine.flow_from_pair(im1, im2, preset="rgb_imagenet",
                                     size_mode="pad")
        write_flow_png(str(base / "flow_occ" / f"{i:06d}_10.png"), flow,
                       rng.rand(40, 70) > 0.3)
    rc = infer_kitti.main(["--root", str(tmp_path), "--ckpt", ckpt,
                           "--batch", "2", "--device", "cpu",
                           "--save-dir", str(tmp_path / "out")])
    assert rc == 0
    mean = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("Mean EPE:")]
    assert float(mean[0].split(":")[1]) <= 0.02
    assert len(os.listdir(tmp_path / "out")) == 3


def test_eval_sintel_cli_on_the_cpu(tmp_path, fake_ckpt):
    sd, ckpt = fake_ckpt
    rng = np.random.RandomState(3)
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=20.0, device="cpu")
    seq = tmp_path / "training" / "clean" / "alley_1"
    gt = tmp_path / "training" / "flow" / "alley_1"
    seq.mkdir(parents=True)
    gt.mkdir(parents=True)
    frames = list(_pair(rng, 36, 60)) + [
        rng.randint(0, 256, (36, 60, 3)).astype(np.uint8)]
    for k, im in enumerate(frames, start=1):
        _write_u8(str(seq / f"frame_{k:04d}.png"), im)
    for k in (1, 2):
        write_flo(str(gt / f"frame_{k:04d}.flo"),
                  engine.flow_from_pair(frames[k - 1], frames[k],
                                        size_mode="pad"))
    out = tmp_path / "out"
    assert eval_sintel.main(["--root", str(tmp_path), "--ckpt", ckpt,
                             "--batch", "2", "--device", "cpu",
                             "--save-dir", str(out)]) == 0
    for k in (1, 2):
        pred = read_flo(str(out / f"alley_1_frame_{k:04d}.flo"))
        ref = read_flo(str(gt / f"frame_{k:04d}.flo"))
        # batch 2 against batch 1: float32 sums in another order
        assert metrics.epe(pred, ref) < 1e-4


def test_cli_refuses_what_is_not_ported(tmp_path, fake_ckpt):
    """--data-parallel N > 1 outside a launch names the command that would
    launch N ranks; 0 is refused with JAX's message; --dispatch-chunk and
    an indivisible --batch are refused on a mesh before the checkpoint
    load (here a one-rank group of --data-parallel all)."""
    _, ckpt = fake_ckpt
    for name, main in (("infer_kitti", infer_kitti.main),
                       ("eval_sintel", eval_sintel.main)):
        base = ["--root", str(tmp_path), "--ckpt", ckpt, "--device", "cpu"]
        with pytest.raises(SystemExit, match=(
                r"torch.distributed.run --nproc-per-node 2 -m "
                rf"opticalflow_tpu_torch.cli.{name} .* --data-parallel 2")):
            main(base + ["--data-parallel", "2"])
        with pytest.raises(SystemExit, match=r"must be >= 1 \(or 'all'\)"):
            main(base + ["--data-parallel", "0"])
        try:
            with pytest.raises(SystemExit, match="mutually exclusive"):
                main(base + ["--data-parallel", "all", "--dispatch-chunk",
                             "2", "--ckpt", str(tmp_path / "none")])
        finally:
            mesh.shutdown()
    base = tmp_path / "training" / "image_2"
    base.mkdir(parents=True)
    z = np.zeros((40, 70, 3), np.uint8)
    _write_u8(str(base / "000000_10.png"), z)
    _write_u8(str(base / "000000_11.png"), z)
    with pytest.raises(ValueError, match="multiple of 64"):
        infer_kitti.main(["--root", str(tmp_path), "--ckpt", ckpt,
                          "--size-mode", "resize_fixed", "--image-size",
                          "100", "128", "--device", "cpu"])


def test_engine_takes_image_size_none(fake_ckpt):
    """The JAX engine's signature, which evaluate_pairs calls."""
    sd, _ = fake_ckpt
    engine = FlowEngine(PWCDCNet(), sd, device="cpu")
    z = np.zeros((40, 70, 3), np.uint8)
    a = engine.flow_from_pair(z, z, size_mode="pad", image_size=None)
    b = engine.flow_from_pairs([z], [z], size_mode="pad")[0]
    np.testing.assert_array_equal(a, b)
    c = engine.flow_from_pairs([z], [z], size_mode="resize_fixed",
                               image_size=(64, 128))
    assert c.shape == (1, 40, 70, 2)
