"""The port's KITTI flow PNG I/O and evaluation datasets, with no OpenCV,
imageio or PIL: 16-bit PNG decoding (every row filter, every colour type),
the port's encoder, ``read_flow_png`` against the JAX package's reader (cv2
here) on files from both writers, and ``KittiPairsEval`` / ``SintelPairs``
against the JAX package's on temporary trees."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import struct
import zlib

import cv2
import numpy as np
import pytest

from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu.io import kitti as jkitti
from opticalflow_tpu.io.flo import write_flo
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import images, kitti
from test_torch_images import _chunk, _filter_row


@pytest.mark.parametrize("channels,colour", [(1, 0), (3, 2), (4, 6)])
def test_16bit_rows_under_every_filter(channels, colour):
    """A 16-bit PNG written row by row with filters none, sub, up, average
    and paeth (a pixel is 2·channels bytes) decodes to its samples."""
    h, w = 10, 7
    img = np.random.RandomState(channels).randint(
        0, 65536, (h, w, channels)).astype(np.uint16)
    img[3:5] = 40000                  # flat rows
    rows = img.astype(">u2").view(np.uint8).reshape(h, -1)
    raw = b""
    prev = np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        ftype = y % 5
        raw += bytes([ftype]) + _filter_row(rows[y], prev, ftype,
                                            2 * channels).tobytes()
        prev = rows[y]
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, colour, 0,
                                         0, 0))
           + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    out = images.decode_png(png)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out.reshape(h, w, channels), img)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3), (9, 13, 4)],
                         ids=["grey", "rgb", "rgba"])
def test_encoder_round_trips_and_cv2_reads_it(tmp_path, dtype, shape):
    img = np.random.RandomState(1).randint(
        0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    data = images.encode_png(img)
    np.testing.assert_array_equal(images.decode_png(data), img)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:                  # BGR(A) → RGB(A)
        ref = ref[..., [2, 1, 0, 3][:shape[2]]]
    np.testing.assert_array_equal(ref, img)


def test_cv2_16bit_files_decode_bit_exact(tmp_path):
    """libpng's own filter choice (cv2.imwrite) on a KITTI-sized file."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 65536, (60, 311, 3)).astype(np.uint16)
    img[:, 100:200] = rng.randint(30000, 30010, (60, 100, 3))
    path = str(tmp_path / "cv.png")
    assert cv2.imwrite(path, img[..., ::-1])
    with open(path, "rb") as f:
        np.testing.assert_array_equal(images.decode_png(f.read()), img)


def test_load_image_keeps_8bit_rgb_from_a_16bit_file(tmp_path):
    img = np.random.RandomState(3).randint(0, 65536, (5, 6, 3)).astype(
        np.uint16)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(images.encode_png(img))
    out = images.load_image(path)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, (img >> 8).astype(np.uint8))


def _flow_and_valid(h=23, w=41, seed=4):
    rng = np.random.RandomState(seed)
    return ((rng.randn(h, w, 2) * 40).astype(np.float32),
            rng.rand(h, w) > 0.3)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_read_flow_png_matches_jax(tmp_path, writer):
    flow, valid = _flow_and_valid()
    path = str(tmp_path / "f.png")
    (kitti if writer == "port" else jkitti).write_flow_png(path, flow, valid)
    f, v = kitti.read_flow_png(path)
    jf, jv = jkitti.read_flow_png(path)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(v, valid)
    # the encoding truncates to 1/64 px
    assert float(np.abs(f - flow).max()) < 1 / 64


def test_write_flow_png_is_jax_writers_file(tmp_path):
    """Both writers store the same samples (the files' bytes may differ:
    cv2 chooses its own filters)."""
    flow, valid = _flow_and_valid(seed=5)
    kitti.write_flow_png(str(tmp_path / "a.png"), flow, valid)
    jkitti.write_flow_png(str(tmp_path / "b.png"), flow, valid)
    a = cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp_path / "b.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(a, b)


def test_read_flow_png_refuses_an_8bit_file(tmp_path):
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(images.encode_png(np.zeros((4, 4, 3), np.uint8)))
    with pytest.raises(ValueError, match="uint16"):
        kitti.read_flow_png(path)


def _write_u8(path, img):
    with open(path, "wb") as f:
        f.write(images.encode_png(img))


@pytest.fixture
def kitti_tree(tmp_path):
    """KITTI 2015 training layout, 3 pairs (the last without GT), plus a
    stray _10 frame without its _11."""
    rng = np.random.RandomState(6)
    base = tmp_path / "kitti" / "training"
    (base / "image_2").mkdir(parents=True)
    (base / "flow_occ").mkdir()
    for i in range(3):
        for k in (10, 11):
            _write_u8(str(base / "image_2" / f"{i:06d}_{k}.png"),
                      rng.randint(0, 256, (19, 33, 3)).astype(np.uint8))
        if i < 2:
            flow, valid = _flow_and_valid(19, 33, seed=10 + i)
            kitti.write_flow_png(str(base / "flow_occ" / f"{i:06d}_10.png"),
                                 flow, valid)
    _write_u8(str(base / "image_2" / "000009_10.png"),
              np.zeros((19, 33, 3), np.uint8))
    return str(tmp_path / "kitti")


def _assert_same_samples(ours, ref):
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        for k in a:
            if k == "stem":
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(a[k], b[k])


def test_kitti_pairs_eval_matches_jax(kitti_tree):
    ours = datasets.KittiPairsEval(kitti_tree)
    ref = jdatasets.KittiPairsEval(kitti_tree)
    assert len(ours) == 3
    _assert_same_samples(ours, ref)
    assert "flow" not in ours[2]
    with pytest.raises(FileNotFoundError):
        datasets.KittiPairsEval(kitti_tree, split="testing")


def test_sintel_pairs_matches_jax(tmp_path):
    rng = np.random.RandomState(7)
    root = tmp_path / "sintel"
    for seq, n in (("alley_1", 3), ("bamboo_2", 2)):
        (root / "training" / "clean" / seq).mkdir(parents=True)
        (root / "training" / "flow" / seq).mkdir(parents=True)
        for k in range(1, n + 1):
            _write_u8(str(root / "training" / "clean" / seq
                          / f"frame_{k:04d}.png"),
                      rng.randint(0, 256, (11, 17, 3)).astype(np.uint8))
        for k in range(1, n):
            if (seq, k) != ("alley_1", 2):       # one pair without GT
                write_flo(str(root / "training" / "flow" / seq
                              / f"frame_{k:04d}.flo"),
                          rng.randn(11, 17, 2).astype(np.float32))
    ours = datasets.SintelPairs(str(root))
    _assert_same_samples(ours, jdatasets.SintelPairs(str(root)))
    assert [s for _, _, _, s in ours.pairs] == [
        "alley_1/frame_0001", "alley_1/frame_0002", "bamboo_2/frame_0001"]
    assert "flow" not in ours[1]
    with pytest.raises(FileNotFoundError):
        datasets.SintelPairs(str(root), render="final")
