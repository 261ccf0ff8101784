"""H.263+ (PLUSPTYPE pictures) in the port's H.263 decoder
(``runtime/h263``) behind ``io/video``, against OpenCV's FFmpeg
(``cv2.VideoCapture`` runs FFmpeg's h263 decoder and swscale) and the JAX
package's cv2-based readers.

Tolerance: 0 throughout.  The committed fixtures
(``tests/goldens/video/h263_plus_*``: libavcodec's ``h263p`` encoder, each
of Annexes D, F, I, J, K, S and T alone and combined, custom formats and
clocks, a size change, the Sintel pair at 436x1024, in AVI, raw ``.h263``,
Matroska and 3GP) decode to cv2's frames, counts, fps and seeks in
``tests/test_torch_h263.py``, which takes every ``h263_*`` fixture; here:
what the fixtures reach, the PLUSPTYPE header fields, the annexes the port
refuses (``Unsupported`` naming ROADMAP item 8), damaged pictures, live
seeks, and the JAX package's readers.  The library is built once for the
module (g++, a few seconds).
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import contextlib
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
from opticalflow_tpu_torch.io.elementary import ElementaryFile
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.io.mkv import MkvFile
from opticalflow_tpu_torch.io.mp4 import Mp4File
from opticalflow_tpu_torch.runtime import h263
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
from make_video_fixtures import _bits, _bytes

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
PLUS = sorted(n for n in MANIFEST if n.startswith("h263_plus_"))
AVI = os.path.join(FIXTURES, "h263_plus_176x144.avi")


@pytest.fixture(scope="module", autouse=True)
def library():
    return h263.load()


def _packets(path):
    box = vio.EncodedVideo(path).box
    with open(path, "rb") as f:
        return [box.sample(f, i) for i in range(len(box.sizes))]


def _patched(packet: bytes, pos: int, value: str) -> bytes:
    """``packet`` with the bits from ``pos`` (counted from the PSC)
    replaced by ``value``."""
    bits = _bits(packet)
    return _bytes(bits[:pos] + value + bits[pos + len(value):])


# where the fields of libavcodec's PLUSPTYPE header lie (bits from the
# PSC): PTYPE's format at 35, UFEP at 38, OPPTYPE at 41 (its format, then
# CPCF at 44, UMV, SAC, AP, AIC, DF, SS, RPS at 51, ISD, AIV, MQ), MPPTYPE at
# 59 (picture type, RPR at 62, RRU, RTYPE at 64), CPM at 68
OPPTYPE, MPPTYPE = 41, 59


def _same(a, b):
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {k}")


# ---------------------------------------------------------------- fixtures

def test_fixtures_reach_every_annex_the_port_reads():
    """Annexes D, F, I, J, K, S and T, the custom format and clock and the
    alternating rounding type are each reached by a committed fixture;
    what none reaches is named in the manifest."""
    need = {"h263_plus_umv_176x144.avi": {"umv", "rounding_type"},
            "h263_plus_obmc_176x144.avi": {"advanced_prediction", "mv4"},
            "h263_plus_aic_176x144.avi": {"aic", "modified_quant"},
            "h263_plus_aic_intra_176x144.avi": {
                "aic_vertical", "aic_horizontal", "dquant", "dquant_escape",
                "modified_quant"},
            "h263_plus_loop_176x144.avi": {"loop_filter"},
            "h263_plus_slices_352x288.avi": {"slices", "gob_headers"},
            "h263_plus_aiv_176x144.avi": {"alt_inter_vlc"},
            "h263_plus_umv_aiv_176x144.avi": {"umv", "umv_stuffing",
                                              "alt_inter_vlc",
                                              "alt_inter_retry"},
            "h263_plus_all_352x288.avi": {
                "umv", "advanced_prediction", "aic", "loop_filter", "slices",
                "alt_inter_vlc", "modified_quant"},
            "h263_plus_100x60.avi": {"custom_format", "custom_clock"},
            "h263_plus_sintel_436x1024.avi": {"custom_format", "umv_long"},
            "h263_plus_resize.avi": {"size_change"}}
    for name, feats in need.items():
        assert {"plusptype"} | feats <= set(
            MANIFEST[name]["h263_features"]), name
    # the standard clock (1001/30000) is no custom one
    assert "custom_clock" not in MANIFEST["h263_plus_176x144.avi"][
        "h263_features"]
    assert not any("port_refuses" in MANIFEST[n] for n in PLUS)
    assert set(_MANIFEST["h263_unreached"]) >= {"extended_par", "ufep_0"}
    assert not {"umv", "aic", "loop_filter", "slices", "alt_inter_vlc",
                "modified_quant", "custom_format", "custom_clock",
                "rounding_type"} & set(_MANIFEST["h263_unreached"])


def test_fixtures_cover_the_containers():
    assert {"h263_plus_176x144.avi", "h263_plus_176x144.h263",
            "h263_plus_176x144.mkv", "h263_plus_176x144.3gp"} <= set(PLUS)
    mkv = MkvFile(os.path.join(FIXTURES, "h263_plus_176x144.mkv"))
    gp = Mp4File(os.path.join(FIXTURES, "h263_plus_176x144.3gp"))
    es = ElementaryFile(os.path.join(FIXTURES, "h263_plus_176x144.h263"))
    assert (mkv.codec, mkv.tag) == ("h263", "H263")
    assert (gp.codec, gp.tag) == ("h263", "s263")
    assert es.codec == "h263" and (es.width, es.height) == (176, 144)
    frames = list(vio.read_frames(AVI))
    for ext in ("mkv", "3gp", "h263"):
        _same(list(vio.read_frames(os.path.join(
            FIXTURES, f"h263_plus_176x144.{ext}"))), frames)


def test_sintel_clip_is_the_cards_input():
    """The 436x1024 clip phase 24 of chip_smoke.py runs: a custom format
    (a height of 436 is no multiple of 16), 13 pictures alternating the
    pair."""
    path = os.path.join(FIXTURES, "h263_plus_sintel_436x1024.avi")
    info = vio.video_info(path)
    assert (info["width"], info["height"], info["frames"]) == (1024, 436, 13)
    assert h263.picture_size(_packets(path)[0]) == (1024, 436)


@pytest.mark.parametrize("name", ["h263_plus_176x144.avi",
                                  "h263_plus_all_352x288.avi",
                                  "h263_plus_176x144.3gp"])
def test_seeks_equal_live_cv2(name):
    path = os.path.join(FIXTURES, name)
    for i in (1, 5, 7):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, want = cap.read()
        cap.release()
        assert ok
        np.testing.assert_array_equal(vio.read_frame(path, i), want,
                                      err_msg=f"{i}")


# ------------------------------------------------------- picture headers

def test_plusptype_header_helpers():
    """``picture_size`` reads OPPTYPE's format and CPFMT's size,
    ``is_intra`` MPPTYPE's picture type; a header without UFEP names no
    size."""
    packets = _packets(AVI)
    assert h263.picture_size(packets[0]) == (176, 144)
    assert [h263.is_intra(p) for p in packets] == [True] + [False] * 11 \
        + [True, False]
    for name, size in (("h263_plus_100x60.avi", (100, 60)),
                       ("h263_plus_320x240.avi", (320, 240))):
        assert h263.picture_size(_packets(os.path.join(FIXTURES, name))[0]) \
            == size
    assert h263.picture_size(_patched(packets[1], 38, "000")) is None


def test_p_pictures_alternate_the_rounding_type():
    """libavcodec's h263p sets flipflop_rounding: RTYPE flips from one
    P-picture to the next (and the I-picture's is 0)."""
    rtype = [_bits(p)[MPPTYPE + 5] for p in _packets(AVI)]
    assert rtype[0] == "0"
    assert all(a != b for a, b in zip(rtype[1:12], rtype[2:12]))


def test_custom_clock_and_format_fields():
    """CPCFC gives 25 Hz as 1800000 / (1000 · 72); CPFMT's width is (PWI +
    1) · 4 and its height PHI · 4."""
    bits = _bits(_packets(os.path.join(FIXTURES, "h263_plus_100x60.avi"))[0])
    assert bits[OPPTYPE:OPPTYPE + 4] == "1101"      # custom format, CPCF 1
    cpfmt = MPPTYPE + 10
    assert (int(bits[cpfmt + 4:cpfmt + 13], 2) + 1) * 4 == 100
    assert int(bits[cpfmt + 14:cpfmt + 23], 2) * 4 == 60
    cpcfc = cpfmt + 23
    assert bits[cpcfc] == "0" and int(bits[cpcfc + 1:cpcfc + 8], 2) == 72


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("pos,value,match", [
    (OPPTYPE + 5, "1", "arithmetic coding.*Annex E"),
    (OPPTYPE + 10, "1", "reference picture selection.*Annex N"),
    (OPPTYPE + 11, "1", "independent segment decoding.*Annex R"),
    (MPPTYPE, "010", "improved PB-frames.*Annex M"),
    (MPPTYPE, "011", "B-pictures.*Annex O"),
    (MPPTYPE + 3, "1", "resampling.*Annex P"),
    (MPPTYPE + 4, "1", "reduced-resolution update.*Annex Q")])
def test_refused_annexes_raise_unsupported_naming_item_8(pos, value, match):
    packet = _patched(_packets(AVI)[0], pos, value)
    with pytest.raises(Unsupported, match=f"{match}.*{ITEM_8}"):
        h263.Decoder("refused").decode(packet)


def test_rectangular_and_unordered_slices_raise_unsupported():
    """Annex K's submodes follow UUI in a slice-structured header."""
    packet = _packets(os.path.join(FIXTURES,
                                   "h263_plus_slices_352x288.avi"))[0]
    bits = _bits(packet)
    assert bits[OPPTYPE + 3] == "1" and bits[OPPTYPE + 9] == "1"  # CPCF, SS
    submodes = MPPTYPE + 10 + 8 + 2                  # after CPCFC and ETR
    assert bits[submodes:submodes + 2] == "00"
    for k, what in enumerate(("rectangular", "arbitrary slice ordering")):
        with pytest.raises(Unsupported, match=f"{what}.*{ITEM_8}"):
            h263.Decoder("ss").decode(_patched(packet, submodes + k, "1"))


def test_damaged_plusptype_headers_raise_value_error():
    packet = _packets(AVI)[0]
    with pytest.raises(ValueError, match="UFEP"):
        h263.Decoder("ufep").decode(_patched(packet, 38, "010"))
    with pytest.raises(ValueError, match="without UFEP"):
        h263.Decoder("ufep0").decode(_patched(packet, 38, "000"))
    with pytest.raises(ValueError, match="reserved"):
        h263.Decoder("type").decode(_patched(packet, MPPTYPE, "101"))


def test_corrupt_packets_raise_only_value_error():
    """Seeded byte flips and truncations of the combined stream's packets
    (slices, OBMC, Annexes D, I, J, S and T): a packet decodes or raises
    ValueError, never anything else."""
    rng = np.random.default_rng(20)
    packets = _packets(os.path.join(FIXTURES, "h263_plus_all_352x288.avi"))
    raised = 0
    for trial in range(60):
        dec = h263.Decoder("fuzz")
        for k, pkt in enumerate(packets[:4]):
            data = bytearray(pkt)
            if k == trial % 4:
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

@pytest.mark.parametrize("name", ["h263_plus_all_352x288.avi",
                                  "h263_plus_176x144.mkv"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = os.path.join(FIXTURES, name)
    _same(list(vio.read_frames(path, max_frames=8, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=8, stride=2)))


@pytest.mark.parametrize("name", ["h263_plus_aic_loop_ss_obmc_176x144.avi",
                                  "h263_plus_176x144.3gp"])
def test_jax_consecutive_frames_equal(name):
    """In order (one open decoder), then out of order: every other read a
    seek."""
    path = os.path.join(FIXTURES, name)
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    assert ds.index == jds.index
    for i in (0, 1, 2, 4, 3):
        if i < len(ds.index):
            np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                          err_msg=f"pair {i}")


@pytest.mark.parametrize("name,frame", [("h263_plus_umv_aiv_176x144.avi", 5),
                                        ("h263_plus_100x60.avi", 9)])
def test_jax_capture_frame_equals(tmp_path, name, frame):
    path = os.path.join(FIXTURES, name)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, str(frame), a]) == 0
        assert jcapture.main([path, str(frame), b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))
