"""The port's training data path against the JAX package's on the CPU:
``KittiFlowTrain`` and ``ConsecutiveFrames`` (the JAX side decodes and
resizes with OpenCV here), the uint8 resize bit-exact to ``cv2.resize``
when it shrinks, the float32 and nearest resizes of the upsize step, and
the ``Loader`` (order, state/restore, error forwarding) against the JAX
``Loader``.  Trees are written by the port's own PNG encoder.

Tolerances: images 1e-5 (on [0, 1]); flow 1e-4 px; the valid mask equal
on ≥ 99.9% of pixels (a warped value at the 0.5 threshold can fall either
side); the upsize step's float32 resize two float32 ulps of 1.0; uint8
resizes, ``ConsecutiveFrames`` samples and everything else equal.
"""

import os
import threading

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu.data import loader as jloader
from opticalflow_tpu.io import images as jimages
from opticalflow_tpu_torch.data import datasets, loader
from opticalflow_tpu_torch.io import images
from opticalflow_tpu_torch.io.kitti import write_flow_png

IMG_TOL = 1e-5
FLOW_TOL = 1e-4
MASK_AGREE = 0.999


def smooth_frames(rng, n, h, w, step=(2, 3)):
    """``n`` uint8 frames: a smooth random texture moved by ``step`` px
    (rows, columns) from one frame to the next, plus a little noise."""
    coarse = torch.from_numpy(rng.random((1, 3, h // 6 + 2, w // 6 + 2)
                                         ).astype(np.float32))
    base = F.interpolate(coarse, size=(h + n * step[0], w + n * step[1]),
                         mode="bilinear", align_corners=False)[0]
    base = base.permute(1, 2, 0).numpy()
    frames = []
    for i in range(n):
        crop = base[i * step[0]:i * step[0] + h, i * step[1]:i * step[1] + w]
        noisy = crop * 255 + rng.integers(-3, 4, crop.shape)
        frames.append(np.clip(noisy, 0, 255).astype(np.uint8))
    return frames


def write_png(path, img):
    with open(path, "wb") as f:
        f.write(images.encode_png(img))


def synth_kitti(root, n_images=6, h=48, w=72, seed=0, invalid=0.3):
    """A KITTI training tree: ``image_2/{i:06d}_10.png`` frames of a moving
    texture and, for each temporal pair (i, i+1), ``flow_occ`` with a
    smooth flow and ``invalid`` of the pixels marked invalid."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "image_2"))
    os.makedirs(os.path.join(root, "flow_occ"))
    for i, im in enumerate(smooth_frames(rng, n_images, h, w)):
        write_png(os.path.join(root, "image_2", f"{i:06d}_10.png"), im)
        if i < n_images - 1:
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            flow = np.stack([3.0 + 2.0 * np.sin(xx / 9.0 + i),
                             2.0 + np.cos(yy / 7.0)], axis=-1)
            write_flow_png(os.path.join(root, "flow_occ", f"{i:06d}_10.png"),
                           flow, rng.random((h, w)) > invalid)
    return root


def assert_samples_match(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape and ours[k].dtype == ref[k].dtype
    np.testing.assert_allclose(ours["images"], ref["images"], rtol=0,
                               atol=IMG_TOL)
    if "flow" in ref:
        np.testing.assert_allclose(ours["flow"], ref["flow"], rtol=0,
                                   atol=FLOW_TOL)
        assert (ours["valid"] == ref["valid"]).mean() >= MASK_AGREE


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return synth_kitti(str(tmp_path_factory.mktemp("kitti")))


@pytest.mark.parametrize("crop", [(32, 48), (56, 80)],
                         ids=["crop", "upsize"])
@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 3), (7, 1)])
def test_kitti_flow_train_matches_jax(kitti_root, seed, epoch, crop):
    """``get(idx, epoch)`` for every idx: the same draws from
    default_rng((seed, epoch, idx)), so the same affine, crop and flip; a
    crop larger than the 48x72 frames takes the upsize branch."""
    ds = datasets.KittiFlowTrain(kitti_root, crop_hw=crop, seed=seed)
    jds = jdatasets.KittiFlowTrain(kitti_root, crop_hw=crop, seed=seed)
    assert ds.samples == jds.samples and len(ds) == 5
    for idx in range(len(ds)):
        s = ds.get(idx, epoch)
        assert s["images"].shape == crop + (6,)
        assert_samples_match(s, jds.get(idx, epoch))
    assert_samples_match(ds[1], jds[1])


def test_kitti_flow_train_pairings_and_list_file(kitti_root, tmp_path):
    """Stereo pairing (image_2 with image_3: frame 2 has no right view and
    frame 2's flow is missing, so two samples), a list file (its malformed
    line skipped), and the refusals."""
    stereo_root = str(tmp_path / "stereo")
    synth_kitti(stereo_root, n_images=3)
    os.makedirs(os.path.join(stereo_root, "image_3"))
    for i in range(2):
        os.link(os.path.join(stereo_root, "image_2", f"{i:06d}_10.png"),
                os.path.join(stereo_root, "image_3", f"{i:06d}_10.png"))
    ours = datasets.KittiFlowTrain(stereo_root, crop_hw=(32, 48),
                                   pairing="stereo")
    ref = jdatasets.KittiFlowTrain(stereo_root, crop_hw=(32, 48),
                                   pairing="stereo")
    assert ours.samples == ref.samples and len(ours.samples) == 2
    lst = tmp_path / "list.txt"
    jds = jdatasets.KittiFlowTrain(kitti_root)
    lst.write_text("\n".join(" ".join(s) for s in jds.samples[::2])
                   + "\nbad line\n")
    ours = datasets.KittiFlowTrain("", list_file=str(lst), crop_hw=(32, 48))
    assert ours.samples == jdatasets.KittiFlowTrain(
        "", list_file=str(lst)).samples == jds.samples[::2]
    with pytest.raises(ValueError, match="pairing"):
        datasets.KittiFlowTrain(kitti_root, pairing="diagonal")
    with pytest.raises(FileNotFoundError):
        datasets.KittiFlowTrain(str(tmp_path / "empty"))


def test_upsize_resizes_match_opencv():
    """The upsize step's float32 INTER_LINEAR (images on [0, 1], flow)
    within two float32 ulps of 1.0 of ``cv2.resize`` (the same weights,
    summed in another order), and its INTER_NEAREST index rule
    (floor(i·src/dst), not half-pixel) exactly, at ragged sizes."""
    rng = np.random.default_rng(5)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(3, 60, 2))
        nh, nw = h + int(rng.integers(0, 50)), w + int(rng.integers(0, 50))
        for shape in ((h, w), (h, w, 3)):
            x = rng.random(shape).astype(np.float32)
            ours = images.resize_bilinear_f32(x, nh, nw)
            ref = cv2.resize(x, (nw, nh))
            assert ours.shape == ref.shape and ours.dtype == ref.dtype
            np.testing.assert_allclose(
                ours, ref, rtol=0, atol=2 * np.finfo(np.float32).eps)
        v = (rng.random((h, w)) > 0.5).astype(np.float32)
        np.testing.assert_array_equal(
            images.resize_nearest(v, nh, nw),
            cv2.resize(v, (nw, nh), interpolation=cv2.INTER_NEAREST))
    flow = rng.normal(0, 10, (40, 50, 2)).astype(np.float32)
    np.testing.assert_allclose(datasets._resize_flow(flow, 64, 96),
                               jdatasets._resize_flow(flow, 64, 96),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("src,dst", [
    ((1080, 1920), (384, 512)), ((720, 1280), (384, 512)),
    ((768, 1024), (384, 512)), ((480, 640), (384, 512)),
    ((500, 700), (384, 512)), ((375, 1242), (384, 512)),
    ((1080, 1920), (540, 960))],
    ids=["1080p", "720p", "768x1024", "vga", "500x700", "kitti",
         "exact-half"])
def test_uint8_resize_shrinks_bit_exact_to_opencv(src, dst):
    """``resize_bilinear_u8`` at the frame sizes ``ConsecutiveFrames`` sees:
    shrinking to the default --size 384x512 (and one side enlarging), and
    exactly half, where OpenCV averages 2x2 blocks."""
    img = np.random.default_rng(sum(src)).integers(
        0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(images.resize_bilinear_u8(img, *dst),
                                  cv2.resize(img, dst[::-1]))


def test_uint8_resize_bit_exact_at_ragged_sizes():
    """A seeded spread of ragged sizes, each side enlarging or shrinking."""
    rng = np.random.default_rng(11)
    for _ in range(150):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 80, 4))
        c = int(rng.choice((1, 3)))
        img = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
        ref = cv2.resize(img, (ow, oh)).reshape(oh, ow, c)
        np.testing.assert_array_equal(images.resize_bilinear_u8(img, oh, ow),
                                      ref, err_msg=f"{h}x{w}->{oh}x{ow}")


@pytest.mark.parametrize("preset", ["bgr_unit", "rgb_unit", "rgb_imagenet"])
def test_preprocess_pair_matches_jax(preset):
    rng = np.random.default_rng(2)
    a, b = (rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)
            for _ in range(2))
    ours = images.preprocess_pair(a, b, preset)
    ref = jimages.preprocess_pair(a, b, preset)
    assert ours.shape == ref.shape == (1, 9, 13, 6)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError, match="preset"):
        images.preprocess_pair(a, b, "bgr_imagenet")


@pytest.mark.parametrize("stride", [1, 2])
def test_consecutive_frames_match_jax(tmp_path, stride):
    """A directory of PNG frames at 60x90, resized to 32x48 (shrinking)
    and preprocessed with rgb_imagenet: the same pairs and samples."""
    rng = np.random.default_rng(stride)
    for i, im in enumerate(smooth_frames(rng, 5, 60, 90)):
        write_png(str(tmp_path / f"frame_{i:04d}.png"), im)
    ds = datasets.ConsecutiveFrames(str(tmp_path), size_hw=(32, 48),
                                    stride=stride)
    jds = jdatasets.ConsecutiveFrames(str(tmp_path), size_hw=(32, 48),
                                      stride=stride)
    assert ds.index == jds.index and len(ds) == 5 - stride
    for i in range(len(ds)):
        s, r = ds[i], jds[i]
        assert s["images"].shape == (32, 48, 6)
        # the uint8 resize is bit-exact, so only float32 rounding of the
        # same expression remains
        np.testing.assert_array_equal(s["images"], r["images"])


def test_consecutive_frames_refuses_video_files_and_missing_sources(tmp_path):
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\x00\x00\x00\x18ftypmp42")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        datasets.ConsecutiveFrames(str(video))
    with pytest.raises(FileNotFoundError):
        datasets.ConsecutiveFrames(str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="not enough frames"):
        datasets.ConsecutiveFrames(str(tmp_path))


def test_jpeg_frames_without_a_decoder_name_what_is_missing(tmp_path,
                                                            monkeypatch):
    """A frame the port's PNG decoder does not read goes to imageio, then
    PIL; with neither installed the error names both."""
    import builtins
    path = tmp_path / "f.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0 not really a jpeg")
    real_import = builtins.__import__

    def no_decoders(name, *args, **kwargs):
        if name.split(".")[0] in ("imageio", "PIL"):
            raise ImportError(f"no module named {name}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_decoders)
    with pytest.raises(ImportError, match="neither imageio nor PIL"):
        images.load_image(str(path))


# ---------------------------------------------------------------- loader


class _Indexed:
    """A dataset whose samples say which (idx, epoch) they are."""

    def __init__(self, n, shape=(2, 3)):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def get(self, idx, epoch=0):
        return {"x": np.full(self.shape, idx + 100 * epoch, np.float32),
                "tag": f"{epoch}:{idx}"}


def _ids(batches):
    return [b["tag"] for b in batches]


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_order_matches_jax(shuffle, drop_last):
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=3, seed=4)
    ours = loader.Loader(_Indexed(11), 3, **kw)
    ref = jloader.Loader(_Indexed(11), 3, **kw)
    assert len(ours) == len(ref) == (3 if drop_last else 4)
    for _ in range(2):                  # two epochs, each its own order
        a, b = list(ours), list(ref)
        assert _ids(a) == _ids(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["x"], y["x"])
            assert x["x"].dtype == y["x"].dtype
    assert ours.state() == ref.state() == {"epoch": 2, "batch": 0, "seed": 4}


def test_loader_state_restore_matches_jax():
    """restore() to a mid-epoch position resumes there, and state() keeps
    the absolute position; an abandoned iterator leaves it where it
    stopped."""
    ours = loader.Loader(_Indexed(12), 2, num_workers=2, seed=1)
    ref = jloader.Loader(_Indexed(12), 2, num_workers=2, seed=1)
    full = _ids(list(loader.Loader(_Indexed(12), 2, seed=1)))
    for lo in (ours, ref):
        lo.restore({"epoch": 0, "batch": 2, "seed": 1})
        it = iter(lo)
        assert next(it)["tag"] == full[2]
        assert lo.state() == {"epoch": 0, "batch": 3, "seed": 1}
        it.close()
        assert lo.state() == {"epoch": 0, "batch": 3, "seed": 1}
        assert _ids(list(lo)) == full[3:]
        assert lo.state() == {"epoch": 1, "batch": 0, "seed": 1}


def test_subset_split_and_shard_match_jax():
    ds = _Indexed(10)
    for frac in (0.0, 0.25, 1.0):
        ours = loader.train_val_split(ds, frac, seed=3)
        ref = jloader.train_val_split(ds, frac, seed=3)
        for o, r in zip(ours, ref):
            assert (o is None) == (r is None)
            if o is not None:
                assert o.indices == list(r.indices)
                assert o.get(1, epoch=2)["tag"] == r.get(1, epoch=2)["tag"]
    for pid in range(3):
        assert (loader.process_shard(ds, pid, 3).indices
                == jloader.process_shard(ds, pid, 3).indices)


class _Failing(_Indexed):
    def get(self, idx, epoch=0):
        if idx == 5:
            raise OSError(f"cannot read sample {idx}")
        return super().get(idx, epoch)


def test_loader_forwards_producer_errors_like_jax():
    """A fetch that fails in the producer re-raises in the consumer after
    the batches before it, as the JAX loader does; no thread is left."""
    before = threading.active_count()
    for cls in (loader.Loader, jloader.Loader):
        lo = cls(_Failing(8), 2, shuffle=False, num_workers=2)
        got = []
        with pytest.raises(OSError, match="sample 5"):
            for b in lo:
                got.append(b["tag"])
        assert got == [["0:0", "0:1"], ["0:2", "0:3"]]
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


def test_loader_device_cpu_gives_tensors_of_the_same_bytes():
    """``device=`` hands out tensors (here on the CPU; the card's copy is
    in tests/test_torch_cuda.py) holding the numpy batch's bytes."""
    plain = list(loader.Loader(_Indexed(6), 2, seed=2))
    moved = list(loader.Loader(_Indexed(6), 2, seed=2, device="cpu"))
    for a, b in zip(plain, moved):
        assert torch.is_tensor(b["x"]) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), a["x"])
        assert b["tag"] == a["tag"]
