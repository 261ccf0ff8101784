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
    """16-bit or interlaced PNGs go to a full decoder (None here)."""
    ihdr = struct.pack(">IIBBBBB", 2, 2, 16, 2, 0, 0, 0)
    png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IEND", b"")
    assert images.decode_png(png) is None
    assert images.decode_png(b"GIF89a") is None


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
