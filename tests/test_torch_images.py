"""The port's own PNG decoder (stdlib zlib + numpy) and host image helpers,
bit-exact against imageio and the JAX package's numpy helpers."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
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


def _pack(samples, depth):
    """(h, w, c) samples → (h, row bytes) as PNG packs them: big-endian
    16-bit, bytes, or 1/2/4-bit values from each byte's high bit."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = (samples.reshape(h, -1, 1) >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png(samples, depth, colour, interlace=0, palette=None):
    """A PNG of ``samples`` ((h, w, c) raw sample values) written here,
    row filters cycling through all five, Adam7 when ``interlace``."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    subimages = ([samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7]
                 if interlace else [samples])
    raw = b""
    for sub in subimages:
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _pack(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for y, row in enumerate(rows):
            ftype = y % 5
            raw += bytes([ftype]) + _filter_row(row, prev, ftype,
                                                bpp).tobytes()
            prev = row
    png = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                             interlace))
    if palette is not None:
        png += _chunk(b"PLTE", palette.tobytes())
    return png + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def test_other_png_flavours_are_handed_on():
    """The flavours a full decoder once had to read now decode here: an
    interlaced 16-bit RGB, an 8-bit palette and a 4-bit grey PNG give the
    pixels they were written with; bytes that are no PNG (a GIF) are still
    handed on (None)."""
    rng = np.random.RandomState(9)
    rgb16 = rng.randint(0, 65536, (5, 6, 3)).astype(np.uint16)
    got = images.decode_png(_png(rgb16, 16, 2, interlace=1))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, rgb16)
    idx = rng.randint(0, 4, (5, 6, 1))
    pal = rng.randint(0, 256, (4, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        images.decode_png(_png(idx, 8, 3, palette=pal)), pal[idx[..., 0]])
    grey4 = rng.randint(0, 16, (5, 6, 1))
    np.testing.assert_array_equal(images.decode_png(_png(grey4, 4, 0)),
                                  grey4[..., 0] * 17)
    assert images.decode_png(b"GIF89a") is None


# (colour type, bit depth, interlace): every flavour of the PNG spec that
# the decoder once handed on, plus interlaced forms of the old ones
FLAVOURS = [(0, 1, 0), (0, 2, 0), (0, 4, 0), (0, 1, 1), (0, 4, 1),
            (3, 1, 0), (3, 2, 0), (3, 4, 0), (3, 8, 0), (3, 2, 1), (3, 8, 1),
            (4, 8, 0), (4, 16, 0), (4, 8, 1), (0, 8, 1), (2, 8, 1),
            (2, 16, 1), (6, 8, 1), (6, 16, 1)]


@pytest.mark.parametrize("colour,depth,interlace", FLAVOURS,
                         ids=lambda v: str(v))
def test_png_flavours_match_pil_and_cv2(tmp_path, colour, depth, interlace):
    """Palette (tRNS ignored), grey+alpha, 1/2/4-bit and Adam7 PNGs,
    written here at odd sizes: ``load_image`` equals PIL's
    ``convert("RGB")`` and the server's ``decode_image`` equals
    ``cv2.imdecode(..., IMREAD_COLOR)``."""
    cv2 = pytest.importorskip("cv2")
    from PIL import Image
    from opticalflow_tpu_torch.serve import decode_image
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    for h, w in ((1, 1), (3, 5), (9, 7), (17, 19)):
        rng = np.random.RandomState(h * 100 + w + depth)
        top = 2 ** depth
        samples = rng.randint(0, top, (h, w, channels))
        palette = None
        if colour == 3:              # a short palette: some indices past it
            palette = rng.randint(0, 256, (max(1, top - 1), 3)).astype(
                np.uint8)
        png = _png(samples, depth, colour, interlace, palette)
        path = str(tmp_path / f"{h}x{w}.png")
        with open(path, "wb") as f:
            f.write(png)
        ref = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(images.load_image(path), ref,
                                      err_msg=f"{h}x{w}")
        want = cv2.imdecode(np.frombuffer(png, np.uint8),
                            cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(decode_image(png), want,
                                      err_msg=f"{h}x{w}")


def test_png_palette_transparency_is_ignored():
    """A tRNS chunk after PLTE changes nothing: ``convert("RGB")`` drops
    it."""
    from PIL import Image
    import io
    idx = np.random.RandomState(1).randint(0, 3, (4, 5, 1))
    pal = np.array([[10, 20, 30], [40, 50, 60], [70, 80, 90]], np.uint8)
    png = _png(idx, 8, 3, palette=pal)
    at = png.index(b"IDAT") - 4
    png = png[:at] + _chunk(b"tRNS", bytes([0, 128, 255])) + png[at:]
    ref = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
    np.testing.assert_array_equal(images.rgb8(images.decode_png(png)), ref)
    np.testing.assert_array_equal(ref, pal[idx[..., 0]])


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
