"""The port's own PNG decoder (stdlib zlib + numpy) and host image helpers,
bit-exact against imageio and the JAX package's numpy helpers."""

import glob
import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from opticalflow_tpu.io import images as jimages
from opticalflow_tpu_torch.io import images

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(GOLD,
                                                               "*.png"))),
                         ids=os.path.basename)
def test_goldens_decode_bit_exact(path):
    with open(path, "rb") as f:
        ours = images.decode_png(f.read())
    np.testing.assert_array_equal(ours, np.asarray(imageio.imread(path)))
    np.testing.assert_array_equal(images.load_image(path),
                                  jimages.load_image(path))


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (37, 53, 4)],
                         ids=["grey", "rgb", "rgba"])
def test_colour_types_match_imageio(tmp_path, shape):
    x = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    x[5:12] = 9                       # flat rows invite other filters
    path = str(tmp_path / "x.png")
    imageio.imwrite(path, x)
    np.testing.assert_array_equal(images.load_image(path),
                                  jimages.load_image(path))
    with open(path, "rb") as f:
        np.testing.assert_array_equal(images.decode_png(f.read()), x)


def _filter_row(row, prev, ftype, bpp):
    """Encoder side of the PNG filters (the inverse of what is tested)."""
    r = row.astype(np.int64)
    p = prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(r)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = p
    elif ftype == 3:
        pred = (left + p) // 2
    else:
        pa, pb, pc = (np.abs(p - upleft), np.abs(left - upleft),
                      np.abs(left + p - 2 * upleft))
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, p, upleft))
    return ((r - pred) % 256).astype(np.uint8)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


@pytest.mark.parametrize("channels,colour", [(1, 0), (3, 2), (4, 6)])
def test_all_five_row_filters(channels, colour):
    """Every row filter (none, sub, up, average, paeth) on every colour
    type, from a PNG written here row by row."""
    h, w = 10, 7
    img = np.random.RandomState(channels).randint(
        0, 256, (h, w * channels)).astype(np.uint8)
    raw = b""
    prev = np.zeros(w * channels, np.uint8)
    for y in range(h):
        ftype = y % 5
        raw += bytes([ftype]) + _filter_row(img[y], prev, ftype,
                                            channels).tobytes()
        prev = img[y]
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                         0))
           + _chunk(b"IDAT", zlib.compress(raw))
           + _chunk(b"IEND", b""))
    out = images.decode_png(png)
    np.testing.assert_array_equal(out.reshape(h, w * channels), img)


def test_other_png_flavours_are_handed_on():
    """Interlaced, palette or 4-bit PNGs go to a full decoder (None here);
    16-bit ones are decoded (``tests/test_torch_kitti.py``)."""
    for depth, colour, interlace in ((16, 2, 1), (8, 3, 0), (4, 0, 0)):
        ihdr = struct.pack(">IIBBBBB", 2, 2, depth, colour, 0, 0, interlace)
        png = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
               + _chunk(b"IEND", b""))
        assert images.decode_png(png) is None
    assert images.decode_png(b"GIF89a") is None


@pytest.mark.parametrize("h,w", [(180, 318), (436, 1024), (375, 1242),
                                 (1080, 1920)],
                         ids=["goldens", "sintel", "kitti", "1080p"])
def test_resize_bit_exact_to_cv2(h, w):
    """The numpy resize against the OpenCV it replaces, at the sizes users
    run: every byte equal."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(h + w).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    ours, oh, ow = images.resize_to_multiple_of_64(img)
    assert (oh, ow) == (h, w)
    ref = cv2.resize(img, ours.shape[1::-1])
    assert ours.shape == ref.shape == (-(-h // 64) * 64, -(-w // 64) * 64, 3)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("hs", [range(1, 71, 7), range(2, 71, 7),
                                range(3, 71, 7), range(64, 71)],
                         ids=["1mod7", "2mod7", "3mod7", "64-70"])
def test_resize_bit_exact_to_cv2_small_sizes(hs):
    """A cheap subset of 1..70 x 1..70: for each height, every width in a
    stride-5 comb, edges and the identity (/64 sizes) included."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(len(hs))
    for h in hs:
        for w in (*range(1 + h % 5, 71, 5), 64):
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            ours = images.resize_to_multiple_of_64(img)[0]
            np.testing.assert_array_equal(
                ours, cv2.resize(img, ours.shape[1::-1]),
                err_msg=f"{h}x{w}")


def test_uint8_resize_refuses_to_shrink():
    """The uint8 resize no longer refuses a shrinking side: it shrinks as
    cv2 does, bit for bit (``tests/test_torch_train_data.py`` holds it at
    the frame sizes training uses), and keeps an unchanged size as it is."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(4).randint(0, 256, (10, 12, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(images.resize_bilinear_u8(img, 10, 12),
                                  img)
    for hw in ((9, 12), (10, 11), (5, 6), (3, 17)):
        np.testing.assert_array_equal(images.resize_bilinear_u8(img, *hw),
                                      cv2.resize(img, hw[::-1]))


def test_geometry_helpers_match_jax_package():
    x = np.random.RandomState(1).randint(0, 256, (2, 180, 318, 6)).astype(
        np.uint8)
    ours, ph, pw = images.pad_to_multiple_of_64(x)
    ref, rph, rpw = jimages.pad_to_multiple_of_64(x)
    np.testing.assert_array_equal(ours, ref)
    assert (ph, pw) == (rph, rpw) == (12, 2)
    np.testing.assert_array_equal(images.unpad(ours, ph, pw), x)
    im = x[0, ..., :3]
    np.testing.assert_array_equal(images.resize_to_multiple_of_64(im)[0],
                                  jimages.resize_to_multiple_of_64(im)[0])
