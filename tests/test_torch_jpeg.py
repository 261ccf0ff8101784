"""The port's JPEG decoder (``runtime/jpeg``) against PIL and OpenCV, which
both run libjpeg-turbo here: the pixels bit for bit (tolerance 0) over a
matrix of subsampling, quality, size, restart intervals, progressive and
optimised files; EXIF orientation as ``cv2.imdecode`` applies it; the
committed fixtures against their manifest; the JAX package's
``load_image`` on them; the port's readers with PIL, imageio and OpenCV
blocked, as on the GPU machine; declined flavours, build failures and
corrupt bytes."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import builtins
import hashlib
import io
import json
import os
import struct
import sys
import threading

import cv2
import numpy as np
import pytest
from PIL import Image

from opticalflow_tpu.io import images as jimages
from opticalflow_tpu_torch.io import images
from opticalflow_tpu_torch.runtime import jpeg
from opticalflow_tpu_torch.serve import decode_image

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
SIZES = ((1, 1), (2, 3), (7, 9), (8, 8), (16, 17), (37, 53), (53, 37))
# OpenCV's IMWRITE_JPEG_SAMPLING_FACTOR values, by name
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}


def _image(h, w, seed, noise=False):
    rng = np.random.RandomState(seed * 1000 + h * 37 + w)
    if noise:
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 7 + y * 3, x * x // 5 + y, y * y // 3 + 2 * x], -1)
    return ((base + rng.randint(0, 40, base.shape)) % 256).astype(np.uint8)


def _cv2_encode(img, *params):
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(bgr), list(params))
    assert ok
    return enc.tobytes()


def _pil_encode(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _cv2(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


def _check(data, what=""):
    """Our pixels equal PIL's convert("RGB") and cv2.imdecode's."""
    ours = jpeg.decode_jpeg(data, orient=False)
    assert ours is not None, jpeg.declined_reason(data)
    ref = _pil(data)
    assert ours.shape == ref.shape and ours.dtype == np.uint8, what
    np.testing.assert_array_equal(ours, ref, err_msg=what)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, orient=True),
                                  _cv2(data), err_msg=what)


@pytest.mark.parametrize("quality", [10, 50, 90, 100])
@pytest.mark.parametrize("sampling", [*SAMPLING, "grey"])
def test_sequential_matches_pil_and_cv2(sampling, quality):
    """Baseline files by OpenCV's encoder at every size in SIZES, a smooth
    texture and noise."""
    for h, w in SIZES:
        for noise in (False, True):
            img = _image(h, w, quality, noise)
            if sampling == "grey":
                data = _cv2_encode(img[..., 1], cv2.IMWRITE_JPEG_QUALITY,
                                   quality)
            else:
                data = _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   SAMPLING[sampling])
            _check(data, f"{sampling} q{quality} {h}x{w} noise={noise}")


@pytest.mark.parametrize("interval", [1, 2, 5])
def test_restart_intervals(interval):
    for sampling in ("444", "420", "411"):
        for h, w in ((7, 9), (37, 53)):
            data = _cv2_encode(_image(h, w, interval), cv2.IMWRITE_JPEG_QUALITY,
                               80, cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               SAMPLING[sampling])
            assert b"\xff\xdd" in data
            _check(data, f"RST {interval} {sampling} {h}x{w}")


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 95])
def test_progressive_matches_pil_and_cv2(subsampling, quality):
    """PIL's progressive files (libjpeg's scan script: spectral selection
    and successive approximation, EOB runs), with and without optimised
    tables; OpenCV's progressive writer too."""
    for h, w in SIZES:
        for noise in (False, True):
            img = _image(h, w, subsampling, noise)
            for optimize in (False, True):
                data = _pil_encode(img, quality=quality, progressive=True,
                                   subsampling=subsampling, optimize=optimize)
                assert b"\xff\xc2" in data
                _check(data, f"progressive {h}x{w} {subsampling}")
    data = _cv2_encode(_image(37, 53, 1), cv2.IMWRITE_JPEG_QUALITY, quality,
                       cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    _check(data, "cv2 progressive")


def test_progressive_grey_and_restarts():
    img = _image(37, 53, 3)
    _check(_pil_encode(img[..., 0], quality=90, progressive=True), "grey")
    _check(_cv2_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                       cv2.IMWRITE_JPEG_RST_INTERVAL, 2), "progressive RST")


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_optimized_tables_and_sintel_size(subsampling):
    for h, w in SIZES:
        _check(_pil_encode(_image(h, w, 5), quality=75, optimize=True,
                           subsampling=subsampling), f"optimized {h}x{w}")
    if subsampling == 2:        # the full-width frame, once
        _check(_pil_encode(_image(436, 1024, 0), quality=90), "436x1024")


def _digest(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixtures_match_manifest_and_jax_load_image(name):
    """Each committed file: ``load_image`` gives PIL's digest (and equals
    the JAX package's ``load_image``), ``decode_image`` OpenCV's (EXIF
    orientation applied)."""
    path = os.path.join(FIXTURES, name)
    want = MANIFEST[name]
    ours = images.load_image(path)
    assert list(ours.shape) == want["shape"]
    assert _digest(ours) == want["sha256_pil"]
    np.testing.assert_array_equal(ours, jimages.load_image(path))
    with open(path, "rb") as f:
        served = decode_image(f.read())
    assert list(served.shape) == want["cv2_shape"]
    assert _digest(served) == want["sha256_cv2"]


def _exif_app1(orientation, little_endian):
    """An APP1 EXIF segment whose IFD0 holds ImageWidth and Orientation."""
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 2)
            + struct.pack(e + "HHIHH", 0x0100, 3, 1, 53, 0)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2_applies_it(tmp_path, orientation):
    """``decode_image`` (the server) rotates as ``cv2.imdecode`` does;
    ``load_image`` (the CLI) does not, as the JAX ``load_image`` does not;
    in either byte order."""
    img = _image(37, 53, orientation)
    plain = _pil_encode(img, quality=90, subsampling=2)
    for little in (False, True):
        data = plain[:2] + _exif_app1(orientation, little) + plain[2:]
        served = decode_image(data)
        np.testing.assert_array_equal(served, _cv2(data))
        assert served.shape == ((53, 37, 3) if orientation >= 5
                                else (37, 53, 3))
        path = str(tmp_path / f"o{orientation}{little}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(images.load_image(path),
                                      jimages.load_image(path))
        np.testing.assert_array_equal(images.load_image(path), _pil(data))


def _patched(data, marker, offset, value):
    """``data`` with the byte ``offset`` past ``marker``'s code set."""
    at = data.index(marker) + 2 + offset
    return data[:at] + bytes([value]) + data[at + 1:]


def _declined_flavours():
    base = _pil_encode(_image(16, 16, 0), quality=90)
    sof = b"\xff\xc0"
    cmyk = io.BytesIO()
    Image.new("CMYK", (8, 8), (10, 20, 30, 40)).save(cmyk, "JPEG")
    return {"arithmetic-coded JPEG": _patched(base, sof, -1, 0xC9),
            "lossless JPEG": _patched(base, sof, -1, 0xC3),
            "12-bit JPEG": _patched(base, sof, 2, 12),
            "4-component JPEG": cmyk.getvalue()}


@pytest.mark.parametrize("flavour", ["arithmetic-coded JPEG", "lossless JPEG",
                                     "12-bit JPEG", "4-component JPEG"])
def test_declined_flavours_are_named(flavour):
    data = _declined_flavours()[flavour]
    assert jpeg.decode_jpeg(data, orient=False) is None
    assert jpeg.declined_reason(data).startswith(flavour)
    assert images.unread_format(data).startswith(flavour)


def test_progressive_file_needing_block_smoothing_is_declined(tmp_path):
    """A progressive file cut after its first scans (EOI appended) leaves
    AC coefficients unrefined: libjpeg would smooth its blocks, so the
    decoder declines it and ``load_image`` hands it to PIL."""
    data = _pil_encode(_image(37, 53, 8), quality=90, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    cut = data[:sos[3]] + b"\xff\xd9"
    assert jpeg.decode_jpeg(cut, orient=False) is None
    assert "smooth" in jpeg.declined_reason(cut)
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(cut)
    np.testing.assert_array_equal(images.load_image(path), _pil(cut))


def _blocked(monkeypatch):
    """Make PIL, imageio and OpenCV unimportable, as on the GPU machine."""
    real_import = builtins.__import__

    def no_decoders(name, *args, **kwargs):
        if name.split(".")[0] in ("PIL", "imageio", "cv2"):
            raise ImportError(f"no module named {name}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_decoders)
    for mod in [m for m in sys.modules
                if m.split(".")[0] in ("PIL", "imageio", "cv2")]:
        monkeypatch.setitem(sys.modules, mod, None)


def test_readers_without_pil_imageio_or_cv2(tmp_path, monkeypatch):
    """``load_image``, ``decode_image``, ``ConsecutiveFrames`` and
    ``io/video.read_frames`` read baseline and progressive JPEG with the
    third-party decoders blocked; an arithmetic-coded file raises naming
    its format."""
    from opticalflow_tpu_torch.data.datasets import ConsecutiveFrames
    from opticalflow_tpu_torch.io import video
    frames = [_image(40, 56, i) for i in range(3)]
    files = {f"f{i}.jpg": _pil_encode(im, quality=90, progressive=i == 1)
             for i, im in enumerate(frames)}
    refs = {n: _pil(d) for n, d in files.items()}
    arith = _declined_flavours()["arithmetic-coded JPEG"]
    jdir = tmp_path / "frames"
    jdir.mkdir()
    for n, d in files.items():
        (jdir / n).write_bytes(d)
    (tmp_path / "arith.jpg").write_bytes(arith)
    _blocked(monkeypatch)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    for n, d in files.items():
        np.testing.assert_array_equal(images.load_image(str(jdir / n)),
                                      refs[n])
        np.testing.assert_array_equal(decode_image(d), refs[n])
    got = list(video.read_frames(str(jdir)))
    assert len(got) == 3
    for g, n in zip(got, sorted(files)):
        np.testing.assert_array_equal(g, refs[n][..., ::-1])
    ds = ConsecutiveFrames(str(jdir), size_hw=(32, 48), stride=1)
    assert len(ds) == 2 and ds[1]["images"].shape == (32, 48, 6)
    with pytest.raises(ImportError, match="arithmetic-coded JPEG"):
        images.load_image(str(tmp_path / "arith.jpg"))
    with pytest.raises(ValueError, match="arithmetic-coded JPEG"):
        decode_image(arith, "im1")
    assert not any(sys.modules.get(m) for m in ("PIL", "imageio", "cv2"))


def test_a_failed_build_raises_and_nothing_falls_back_to_pil(monkeypatch,
                                                             tmp_path):
    from opticalflow_tpu_torch.runtime import _native
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(jpeg, "_FLAGS", jpeg._FLAGS + ("-fno-such-flag",))
    path = tmp_path / "x.jpg"
    path.write_bytes(_pil_encode(_image(8, 8, 0), quality=90))
    with pytest.raises(RuntimeError, match="building jpeg.cpp failed"):
        images.load_image(str(path))
    with pytest.raises(RuntimeError, match="fno-such-flag"):
        decode_image(path.read_bytes())


def test_corrupt_truncated_and_fuzzed_bytes_raise_value_error():
    """Truncations and single-byte changes of a few files (seeded, a few
    thousand decodes): an array or ``ValueError``, never a crash; a corrupt
    file reaching ``decode_image`` is a ValueError naming the input."""
    rng = np.random.RandomState(0)
    names = ("progressive_37x53.jpg", "rst_37x53.jpg", "s422_37x53.jpg",
             "grey_37x53.jpg", "s411_7x9.jpg")
    outcomes = {"array": 0, "error": 0, "declined": 0}
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        cases = [data[:k] for k in range(3, len(data), 7)]
        for _ in range(300):
            b = bytearray(data)
            b[rng.randint(2, len(b))] = rng.randint(0, 256)
            cases.append(bytes(b))
        for c in cases:
            try:
                out = jpeg.decode_jpeg(c, orient=True)
            except ValueError:
                outcomes["error"] += 1
                continue
            if out is None:
                outcomes["declined"] += 1
            else:
                assert out.dtype == np.uint8 and out.ndim == 3
                outcomes["array"] += 1
    assert outcomes["error"] > 100 and outcomes["array"] > 100, outcomes
    with open(os.path.join(FIXTURES, "rst_37x53.jpg"), "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match="could not decode im2"):
        decode_image(data[:len(data) // 2], "im2")


def test_threads_decode_in_parallel_and_agree():
    """Eight threads (more than the cores the tests get) race to load the
    library and decode the same files: every result equals the serial
    one."""
    names = ["sintel_im1.jpg", "progressive_37x53.jpg", "s411_37x53.jpg"]
    blobs = [open(os.path.join(FIXTURES, n), "rb").read() for n in names]
    want = [jpeg.decode_jpeg(b, orient=False) for b in blobs]
    errors, results = [], []

    def work(k):
        try:
            for i in range(6):
                j = (i + k) % len(blobs)
                results.append((j, jpeg.decode_jpeg(blobs[j], orient=False)))
        except Exception as e:          # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(results) == 48
    for j, got in results:
        np.testing.assert_array_equal(got, want[j])
