"""The port's H.263 decoder (``runtime/h263``) behind ``io/video``, in AVI,
3GP, QuickTime and Matroska, against OpenCV's FFmpeg (``cv2.VideoCapture``
runs FFmpeg's h263 decoder and swscale) and the JAX package's cv2-based
readers.

Tolerance: 0 throughout.  H.263 reconstruction is exact integer arithmetic
and the conversion is swscale's, so every frame equals cv2's bit for bit:
on the committed fixtures (``tests/goldens/video/h263_*``: cv2's writer at
three sizes and in four containers, and libavcodec's encoder for advanced
prediction, 8x8 vectors with DQUANT, GOB headers with PSUPP, a size change
and the 4CIF Sintel clip; each frame's digest in the manifest, which the
GPU machine checks without cv2), through every seek cv2's
``CAP_PROP_POS_FRAMES`` makes (the manifest records the frame each reads),
and in the CLIs.  The library is built once for the module (g++, a few
seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
import hashlib
import io
import json
import os

import cv2
import numpy as np
import pytest

from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.avi import AviFile, H263_TAGS, codec_of
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.runtime import h263
from opticalflow_tpu_torch.runtime.mpeg4 import Unsupported

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
H263 = sorted(n for n in MANIFEST if n.startswith("h263_"))
AVI = os.path.join(FIXTURES, "h263_176x144.avi")
OBMC = os.path.join(FIXTURES, "h263_obmc_176x144.avi")


@pytest.fixture(scope="module", autouse=True)
def library():
    return h263.load()


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            cap.release()
            return out
        out.append(frame)


def _cv2_info(path):
    cap = cv2.VideoCapture(path)
    info = {"fps": cap.get(cv2.CAP_PROP_FPS),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    cap.release()
    return info


def _digest(frame):
    return hashlib.sha256(np.ascontiguousarray(frame).tobytes()).hexdigest()


def _same(a, b):
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {k}")


def _packets(path):
    box = vio.EncodedVideo(path).box
    with open(path, "rb") as f:
        return [box.sample(f, i) for i in range(len(box.sizes))]


# ---------------------------------------------------------------- fixtures

def test_fixtures_cover_the_containers_sizes_and_tools():
    assert {"h263_128x96.avi", "h263_176x144.avi", "h263_352x288.avi",
            "h263_176x144.3gp", "h263_176x144.mov", "h263_176x144.mkv",
            "h263_sintel_704x576.avi", "h263_obmc_176x144.avi",
            "h263_mv4_176x144.avi", "h263_gob_352x288.avi",
            "h263_resize.avi"} <= set(H263)
    assert not any("port_refuses" in MANIFEST[n] for n in H263)


@pytest.mark.parametrize("name", H263)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = os.path.join(FIXTURES, name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]
    assert len(got) == MANIFEST[name]["decoded"]


@pytest.mark.parametrize("name", H263)
def test_video_info_equals_cv2(name):
    path = os.path.join(FIXTURES, name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", H263)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """A CAP_PROP_POS_FRAMES seek to each index reads the frame the
    manifest records cv2 reading: the decode starts at the keyframe
    (``idx1``'s flag, ``stss``, the block's flag) before it."""
    path = os.path.join(FIXTURES, name)
    want = MANIFEST[name]
    video = vio.EncodedVideo(path)
    for t, hit in want["seeks"].items():
        assert _digest(video.frame(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", ["h263_176x144.avi", "h263_obmc_176x144.avi",
                                  "h263_176x144.3gp"])
def test_seeks_equal_live_cv2(name):
    path = os.path.join(FIXTURES, name)
    for i in (3, 12, 13):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, want = cap.read()
        cap.release()
        assert ok
        np.testing.assert_array_equal(vio.read_frame(path, i), want,
                                      err_msg=f"{i}")


@pytest.mark.parametrize("name", H263)
def test_manifest_features_are_the_decoders(name):
    dec = h263.Decoder(name)
    for p in _packets(os.path.join(FIXTURES, name)):
        dec.decode(p)
    assert dec.features == MANIFEST[name]["h263_features"]


def test_what_each_fixture_reaches_and_what_none_does():
    """libavcodec's streams reach what cv2's writer leaves off: Annex F
    (advanced prediction, so it is read, not refused), 8x8 vectors with
    DQUANT, GOB headers, PSUPP, a size change; what no stream reaches is
    named."""
    need = {"h263_128x96.avi": {"sub_qcif", "p_pictures", "intra_mb_in_p"},
            "h263_352x288.avi": {"cif"},
            "h263_sintel_704x576.avi": {"4cif", "skipped_mb"},
            "h263_obmc_176x144.avi": {"advanced_prediction", "mv4", "dquant",
                                      "skipped_mb"},
            "h263_mv4_176x144.avi": {"mv4", "dquant"},
            "h263_gob_352x288.avi": {"gob_headers", "pei", "mcbpc_stuffing"},
            "h263_resize.avi": {"size_change", "qcif", "sub_qcif"},
            "h263_176x144.avi": {"escape", "dc_128"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["h263_features"]), name
    assert "advanced_prediction" not in MANIFEST["h263_mv4_176x144.avi"][
        "h263_features"]
    reached = {f for n in H263 for f in MANIFEST[n]["h263_features"]}
    assert _MANIFEST["h263_unreached"] == [f for f in h263.FEATURES
                                           if f not in reached]
    assert set(_MANIFEST["h263_unreached"]) == {
        "16cif", "escape_extended", "extended_par", "ufep_0"}


def test_picture_header_helpers():
    packets = _packets(AVI)
    assert h263.picture_size(packets[0]) == (176, 144)
    assert [h263.is_intra(p) for p in packets[:13]] == [True] + [False] * 11 \
        + [True]
    assert h263.picture_size(b"\x00\x00\x00junk") is None
    assert not h263.is_intra(b"")


# ------------------------------------------------------------- containers

def test_riff_tags_map_to_h263_in_any_case():
    for tag in sorted(H263_TAGS):
        for t in (tag, tag.lower()):
            assert codec_of(t, "x.avi") == "h263"
    with pytest.raises(Unsupported, match="ZyGo.*item 8"):
        codec_of("ZyGo", "x.avi")
    with pytest.raises(Unsupported, match="Intel H.263.*item 8"):
        codec_of("I263", "x.avi")
    box = AviFile(AVI)
    assert (box.codec, box.tag) == ("h263", "H263")
    assert vio.EncodedVideo(AVI).keyframes == [0, 12]


def test_3gp_and_mov_sample_entries(tmp_path):
    """cv2 writes ``s263`` into .3gp and ``H263`` into .mov; FFmpeg's mov
    demuxer takes ``h263`` too (the same stream under that entry reads to
    the same frames)."""
    src = os.path.join(FIXTURES, "h263_176x144.3gp")
    gp = Mp4File(src)
    mov = Mp4File(os.path.join(FIXTURES, "h263_176x144.mov"))
    assert (gp.codec, gp.tag) == ("h263", "s263")
    assert mov.codec == "h263" and mov.tag in ("H263", "s263", "h263")
    data = open(src, "rb").read()
    path = str(tmp_path / "h263.3gp")
    with open(path, "wb") as f:
        f.write(data.replace(b"s263", b"h263", 1))
    assert Mp4File(path).tag == "h263"
    _same(list(vio.read_frames(path)), list(vio.read_frames(src)))


def test_matroska_vfw_fourcc():
    box = MkvFile(os.path.join(FIXTURES, "h263_176x144.mkv"))
    assert (box.codec, box.tag) == ("h263", "H263")


# ------------------------------------------------------------- refusals

def _ptype_patched(packet: bytes, bit: int, value: int = 1) -> bytes:
    """``packet`` with PTYPE bit ``bit`` (1-13, the standard's numbering)
    set to ``value``."""
    b = bytearray(packet)
    pos = 22 + 8 + bit - 1
    mask = 0x80 >> (pos & 7)
    b[pos >> 3] = b[pos >> 3] | mask if value else b[pos >> 3] & ~mask
    return bytes(b)


@pytest.mark.parametrize("what,bit,match", [
    ("unrestricted vectors", 10, "Annex D"),
    ("arithmetic coding", 11, "Annex E"),
    ("PB-frames", 13, "Annex G")])
def test_crafted_ptype_raises_unsupported_naming_item_8(what, bit, match):
    packet = _packets(AVI)[1]
    with pytest.raises(Unsupported, match=f"{match}.*item 8"):
        dec = h263.Decoder(what)
        dec.decode(_packets(AVI)[0])
        dec.decode(_ptype_patched(packet, bit))


@pytest.mark.parametrize("fmt", [6, 7])
def test_plusptype_raises_unsupported_naming_item_8(fmt):
    """Source format 7 announces PLUSPTYPE (H.263+), 6 is FFmpeg's too: a
    baseline picture's bits read as one are damaged (ValueError, no UFEP
    before), an H.263+ picture decodes, and its OPPTYPE's arithmetic
    coding bit (Annex E) raises Unsupported naming item 8."""
    packet = bytearray(_packets(AVI)[0])
    for k in range(3):
        packet = bytearray(_ptype_patched(bytes(packet), 6 + k,
                                          fmt >> (2 - k) & 1))
    with pytest.raises(ValueError):
        h263.Decoder("plus").decode(bytes(packet))
    plus = _packets(os.path.join(FIXTURES, "h263_plus_176x144.avi"))[0]
    as_fmt = _ptype_patched(plus, 8, fmt & 1)
    want = h263.Decoder("plus").decode(plus)
    for a, b in zip(h263.Decoder(f"format {fmt}").decode(as_fmt), want):
        np.testing.assert_array_equal(a, b)
    assert h263.picture_size(as_fmt) == (176, 144)
    sac = _ptype_patched(as_fmt, 17)     # after UFEP, the format, CPCF, UMV
    with pytest.raises(Unsupported, match="Annex E.*item 8"):
        h263.Decoder("sac").decode(sac)


def test_a_p_picture_without_a_reference_raises_value_error():
    with pytest.raises(ValueError, match="without a reference"):
        h263.Decoder("p").decode(_packets(AVI)[1])
    with pytest.raises(ValueError, match="no picture start code"):
        h263.Decoder("junk").decode(b"\x12\x34" * 20)


def test_corrupt_packets_raise_only_value_error():
    """Seeded byte flips and truncations of the OBMC stream's packets:
    a packet decodes or raises ValueError, never anything else."""
    rng = np.random.default_rng(2)
    packets = _packets(OBMC)[:6]
    raised = 0
    for trial in range(90):
        dec = h263.Decoder("fuzz")
        for k, pkt in enumerate(packets):
            data = bytearray(pkt)
            if k == trial % 6:
                if trial % 3 == 0:
                    data = data[:int(rng.integers(0, len(data)))]
                else:
                    for _ in range(int(rng.integers(1, 6))):
                        data[int(rng.integers(0, len(data)))] ^= int(
                            rng.integers(1, 256))
            try:
                dec.decode(bytes(data))
            except ValueError:
                raised += 1
    assert raised > 10


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["h263_176x144.avi", "h263_176x144.3gp",
                                  "h263_resize.avi"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = os.path.join(FIXTURES, name)
    _same(list(vio.read_frames(path, max_frames=10, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=10, stride=2)))


@pytest.mark.parametrize("name", ["h263_obmc_176x144.avi",
                                  "h263_176x144.mkv"])
def test_jax_consecutive_frames_equal(name):
    """In order (one open decoder), then out of order: every other read a
    seek."""
    path = os.path.join(FIXTURES, name)
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    assert ds.index == jds.index
    for i in (0, 1, 2, 9, 4, 11, 6):
        if i < len(ds.index):
            np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                          err_msg=f"pair {i}")


@pytest.mark.parametrize("name", ["h263_176x144.3gp", "h263_gob_352x288.avi"])
def test_jax_capture_frame_equals(tmp_path, name):
    path = os.path.join(FIXTURES, name)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "5", a]) == 0
        assert jcapture.main([path, "5", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))
