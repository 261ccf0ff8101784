"""The port's MPEG-1/2 decoder (``runtime/mpeg12``) and program-stream
demuxer (``io/mpegps``) behind ``io/video``, in ``.mpg``, AVI, Matroska and
MP4, against OpenCV's FFmpeg (``cv2.VideoCapture`` runs FFmpeg's
mpeg1video/mpeg2video decoder and swscale) and the JAX package's cv2-based
readers.

Tolerance: 0 throughout.  MPEG-1/2 reconstruction is exact integer
arithmetic and the conversion is swscale's, so every frame equals cv2's bit
for bit: on the committed fixtures (``tests/goldens/video/mpeg[12]_*``:
cv2's writer, byte patches of what it wrote, and libavcodec's encoder with
the tools cv2's writer leaves off; each frame's digest in the manifest,
which the GPU machine checks without cv2), through every seek cv2's
``CAP_PROP_POS_FRAMES`` makes (its quirks included: the manifest records
the frame each seek reads), and in the CLIs.  The library is built once
for the module (g++, a few seconds).
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
import torch

from opticalflow_tpu import video as jvideo
from opticalflow_tpu.cli import capture_frame as jcapture
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.cli import capture_frame, extract_video
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.avi import MPEG12_TAGS, codec_of
from opticalflow_tpu_torch.io.images import decode_png
from opticalflow_tpu_torch.io.mpegps import MpegPsFile
from opticalflow_tpu_torch.runtime import mpeg12
from opticalflow_tpu_torch.runtime.mpeg4 import Unsupported, i420_to_bgr

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    _MANIFEST = json.load(_f)
MANIFEST = _MANIFEST["files"]
# MPEG-1/2 in program streams, AVI, Matroska and MP4; transport and
# elementary streams are tests/test_torch_mpegts.py's
STREAM_EXTS = (".ts", ".m2ts", ".mts", ".m1v", ".m2v", ".mpv")
MPEG = sorted(n for n in MANIFEST if n.startswith(("mpeg1_", "mpeg2_"))
              and not n.endswith(STREAM_EXTS))
READ = [n for n in MPEG if "port_refuses" not in MANIFEST[n]]
CONTAINERS = [f"mpeg{v}_176x144.{ext}" for v in (1, 2)
              for ext in ("mpg", "avi", "mkv", "mp4")]
MPG2 = os.path.join(FIXTURES, "mpeg2_176x144.mpg")
PIM1_AVI = os.path.join(FIXTURES, "mpeg1_176x144.avi")


@pytest.fixture(scope="module", autouse=True)
def library():
    return mpeg12.load()


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            cap.release()
            return out
        out.append(frame)


def _cv2_seek(path, i):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, i)
    ok, frame = cap.read()
    cap.release()
    return frame if ok else None


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


def _ps_samples(path):
    box = MpegPsFile(path)
    with open(path, "rb") as f:
        return [box.sample(f, i) for i in range(len(box.sizes))]


# ---------------------------------------------------------------- fixtures

@pytest.mark.parametrize("name", READ)
def test_fixture_frames_equal_cv2_and_the_manifest(name):
    path = os.path.join(FIXTURES, name)
    got = list(vio.read_frames(path))
    _same(got, _cv2_frames(path))
    assert [_digest(f) for f in got] == MANIFEST[name]["sha256"]


@pytest.mark.parametrize("name", READ)
def test_video_info_equals_cv2(name):
    """fps, size and CAP_PROP_FRAME_COUNT: a program stream's count is
    FFmpeg's duration estimate from its PTS, which falls short of the
    pictures where the last PES packets start early (35 of 40)."""
    path = os.path.join(FIXTURES, name)
    assert vio.video_info(path) == _cv2_info(path) == {
        k: MANIFEST[name][k] for k in ("fps", "width", "height", "frames")}


@pytest.mark.parametrize("name", READ)
def test_every_seek_reads_the_frame_cv2_reads(name):
    """A CAP_PROP_POS_FRAMES seek to each index reads the frame the
    manifest records cv2 reading (a digest of the sequential decode), or
    none where cv2 reads none."""
    path = os.path.join(FIXTURES, name)
    want = MANIFEST[name]
    video = vio.EncodedVideo(path)
    for t, hit in want["seeks"].items():
        if hit is None:
            with pytest.raises(ValueError, match="reads no frame"):
                video.frame(int(t))
        else:
            assert _digest(video.frame(int(t))) == want["sha256"][hit], t


@pytest.mark.parametrize("name", CONTAINERS)
def test_seeks_into_later_gops_equal_live_cv2(name):
    """Seeks into the second, third and fourth GOP (and into the first)
    of each container, against cv2 itself: exact in .mkv and .mp4;
    clamped to the estimated count in the MPEG-2 .mpg; one frame early in
    the MPEG-1 AVI."""
    path = os.path.join(FIXTURES, name)
    for i in (5, 13, 26, 38):
        want = _cv2_seek(path, i)
        np.testing.assert_array_equal(vio.read_frame(path, i), want,
                                      err_msg=f"{i}")


def test_the_seek_quirks_are_cv2s():
    """What cv2 reads after a seek, named: the PIM1 AVI one frame early
    (FFmpeg stamps an I- or P-picture with the packet that hands it over);
    the MPEG-2 .mpg clamped to its estimated count; the Sintel .mpg, whose
    second picture starts a PES packet stamped with the first's time, lands
    past the first GOP (frame 12) and reads nothing after a seek to 1-12."""
    frames = list(vio.read_frames(PIM1_AVI))
    video = vio.EncodedVideo(PIM1_AVI)
    for i in (5, 13, 26, 38):
        assert video.seek_target(i) == i - 1
        np.testing.assert_array_equal(video.frame(i), frames[i - 1])
    assert [vio.EncodedVideo(MPG2).seek_target(i) for i in (5, 38)] == [5, 35]
    sintel = vio.EncodedVideo(os.path.join(FIXTURES,
                                           "mpeg2_sintel_436x1024.mpg"))
    assert [sintel.seek_target(i) for i in range(13)] == [12] + [None] * 12


def test_read_counts_on_from_the_index_asked_for():
    """ConsecutiveFrames' reads: after a quirky seek cv2 reads on from the
    frame it landed on, while the caller counts from the index it asked
    for; ``read`` keeps the two apart as cv2 does."""
    frames = list(vio.read_frames(PIM1_AVI))
    video = vio.EncodedVideo(PIM1_AVI)
    np.testing.assert_array_equal(video.read(0), frames[0])
    np.testing.assert_array_equal(video.read(1), frames[1])
    np.testing.assert_array_equal(video.read(20), frames[19])
    np.testing.assert_array_equal(video.read(21), frames[20])
    video.close()


def test_manifest_lists_each_fixtures_features_and_what_none_reached():
    """The manifest's ``mpeg12_features`` are what the decoder meets;
    libavcodec's streams and the header rewrites reach what cv2's writer
    leaves out; what no stream reaches is named."""
    for name in ("mpeg2_tools.mpg", "mpeg1_176x144.mpg"):
        dec = mpeg12.Decoder(name)
        for s in _ps_samples(os.path.join(FIXTURES, name)):
            dec.decode(s)
        assert dec.features == MANIFEST[name]["mpeg12_features"], name
    need = {"mpeg1_176x144.mpg": {"mpeg1", "p_pictures", "no_mc"},
            "mpeg2_176x144.mpg": {"mpeg2", "b_pictures", "skipped_b",
                                  "bidirectional", "backward", "open_gop"},
            "mpeg2_tools.mpg": {"alternate_scan", "intra_vlc_format",
                                "q_scale_type", "intra_dc_precision_10",
                                "intra_matrix", "inter_matrix",
                                "quant_matrix_extension",
                                "colour_description", "broken_link",
                                "mb_quant"},
            "mpeg2_dc9.mpg": {"intra_dc_precision_9"},
            "mpeg2_dc11.mpg": {"intra_dc_precision_11"},
            "mpeg1_matrices.mpg": {"intra_matrix", "oddify_zero"},
            "mpeg1_still_176x144.mpg": {"mb_escape", "skipped_p"},
            "mpeg2_low_delay.mpg": {"low_delay"},
            "mpeg2_interlaced.mpg": {"interlaced_sequence"}}
    for name, feats in need.items():
        assert feats <= set(MANIFEST[name]["mpeg12_features"]), name
    reached = {f for n in MPEG for f in MANIFEST[n]["mpeg12_features"]}
    assert _MANIFEST["mpeg12_unreached"] == [f for f in mpeg12.FEATURES
                                             if f not in reached]
    assert set(_MANIFEST["mpeg12_unreached"]) == {
        "concealment_motion_vectors", "full_pel", "escape_long",
        "mb_stuffing", "frame_motion_type"}


def test_headers_picture_types_and_display_order():
    samples = _ps_samples(MPG2)
    seq = mpeg12.sequence_info(samples[0])
    assert (seq.width, seq.height, float(seq.fps), seq.mpeg2,
            seq.low_delay) == (176, 144, 25.0, True, False)
    assert not mpeg12.sequence_info(
        _ps_samples(os.path.join(FIXTURES, "mpeg1_176x144.mpg"))[0]).mpeg2
    types = [mpeg12.picture_info(s)[0] for s in samples]
    assert "".join(" IPB"[t] for t in types[:13]) == "IPBBPBBPBBIBB"
    video = vio.EncodedVideo(MPG2)
    assert video.display[:13] == [0, 3, 1, 2, 6, 4, 5, 9, 7, 8, 12, 10, 11]
    assert video.keyframes == [0, 10, 22, 34]
    # every picture comes out, in display order, with its packet number
    dec = mpeg12.Decoder("mpg")
    order = []
    for s in samples + [None]:
        dec.decode(s) if s is not None else dec.flush()
        order += [video.display[k] for k in dec.serials]
    assert order == list(range(40))


def test_codec_headers_from_the_container():
    """A container's codec headers (Matroska's CodecPrivate, MP4's
    DecoderSpecificInfo) read before the first packet: the first sample
    without its sequence header decodes as with it."""
    samples = _ps_samples(MPG2)
    head = samples[0][:samples[0].find(b"\x00\x00\x01\xb8")]
    assert head.startswith(b"\x00\x00\x01\xb3") and len(head) > 12
    a, b = mpeg12.Decoder("in band"), mpeg12.Decoder("extradata", head)
    assert (b.width, b.height) == (176, 144)
    for k, s in enumerate(samples[:8]):
        pa, pb = a.decode(s), b.decode(s[len(head):] if k == 0 else s)
        assert len(pa) == len(pb)
        for x, y in zip(pa, pb):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)


def test_open_gop_leading_b_pictures_are_dropped_after_a_seek():
    """Decoding from the second GOP's I-picture, the two B-pictures
    before it in display order reference the first GOP (an open GOP):
    FFmpeg drops them, so the first picture out is the I-picture."""
    samples = _ps_samples(MPG2)
    dec = mpeg12.Decoder("mpg")
    out = []
    for s in samples[10:16]:
        out += [(p, 10 + k) for p, k in zip(dec.decode(s), dec.serials)]
    video = vio.EncodedVideo(MPG2)
    assert [k for _, k in out] == [10, 14, 15]
    assert [video.display[k] for _, k in out] == [12, 13, 14]
    frames = list(vio.read_frames(MPG2))
    for (p, k) in out:
        np.testing.assert_array_equal(
            i420_to_bgr(*p, False, mpeg12.CHROMA_SITE[True]),
            frames[video.display[k]])


# ----------------------------------------------------------- colour

@pytest.mark.parametrize("name,site", [("mpeg1_175x143.mpg", "center"),
                                       ("mpeg2_175x143.mpg", "left"),
                                       ("mpeg2_53x37.mpg", "left")])
def test_odd_heights_use_the_codecs_chroma_site(name, site):
    """At an odd height swscale interpolates the chroma from the site the
    decoder reports: centred for MPEG-1, left for MPEG-2."""
    from opticalflow_tpu_torch.runtime.mpeg4 import CHROMA_SITES
    path = os.path.join(FIXTURES, name)
    video = vio.EncodedVideo(path)
    assert video.chroma == CHROMA_SITES[site]
    planes = [p for _, p in video.planes()]
    want = _cv2_frames(path)
    other = CHROMA_SITES["left" if site == "center" else "center"]
    assert any(not np.array_equal(i420_to_bgr(*p, False, other), w)
               for p, w in zip(planes, want))


def test_sequence_display_extension_names_the_matrix():
    """libavcodec's stream with a colour description of BT.709: cv2
    converts it with swscale's BT.709 matrix; BT.601 is off."""
    path = os.path.join(FIXTURES, "mpeg2_tools.mpg")
    video = vio.EncodedVideo(path)
    planes = [p for _, p in video.planes()]
    assert video.matrix == "bt709"
    want = _cv2_frames(path)
    _same([i420_to_bgr(*p, False, video.chroma, "bt709") for p in planes],
          want)
    assert max(int(np.abs(i420_to_bgr(*p).astype(int) - w).max())
               for p, w in zip(planes, want)) >= 4
    assert [mpeg12.matrix(c) for c in (1, 2, 4, 5, 6, 7, 9, 10, 8)] == [
        "bt709", "bt601", "fcc", "bt601", "bt601", "smpte240m", "bt2020",
        "bt2020", "bt601"]


# ------------------------------------------------------------- refusals

def _patch(data: bytes, code: int, nibble, offset: int, mask: int,
           value: int) -> bytes:
    """``data`` with the byte ``offset`` into the body of its first start
    code ``code`` (whose first nibble is ``nibble``, where given) set to
    ``value`` under ``mask``."""
    k = next(i for i in range(len(data) - 4)
             if data[i:i + 4] == bytes((0, 0, 1, code))
             and (nibble is None or data[i + 4] >> 4 == nibble))
    b = bytearray(data)
    b[k + 4 + offset] = (b[k + 4 + offset] & ~mask) | value
    return bytes(b)


@pytest.mark.parametrize("what,patch,match", [
    ("field picture", (0xB5, 8, 2, 0x03, 0x01), "field pictures"),
    ("repeat_first_field", (0xB5, 8, 3, 0x02, 0x02), "repeat_first_field"),
    ("interlaced frame", (0xB5, 8, 4, 0x80, 0x00), "interlaced frames"),
    ("4:2:2", (0xB5, 1, 1, 0x06, 0x04), "4:2:2"),
    ("4:4:4", (0xB5, 1, 1, 0x06, 0x06), "4:4:4"),
    ("SNR scalable profile", (0xB5, 1, 0, 0x07, 0x03), "scalable"),
    ("D-picture", (0x00, None, 1, 0x38, 0x20), "D-pictures")])
def test_crafted_headers_raise_unsupported_naming_item_8(what, patch,
                                                         match):
    sample = _ps_samples(MPG2 if what != "D-picture" else os.path.join(
        FIXTURES, "mpeg1_176x144.mpg"))[0]
    with pytest.raises(Unsupported, match=f"{match}.*item 8"):
        mpeg12.Decoder(what).decode(_patch(sample, *patch))


def test_scalable_extensions_raise_unsupported():
    sample = _ps_samples(MPG2)[0]
    k = sample.find(b"\x00\x00\x01\xb8")
    for ext in (b"\x50\x00\x00", b"\x90\x00\x00", b"\xa0\x00\x00"):
        crafted = sample[:k] + b"\x00\x00\x01\xb5" + ext + sample[k:]
        with pytest.raises(Unsupported, match="scalable.*item 8"):
            mpeg12.Decoder("scalable").decode(crafted)


def test_interlaced_fixture_is_refused_in_every_reader():
    path = os.path.join(FIXTURES, "mpeg2_interlaced.mpg")
    assert "interlaced" in MANIFEST["mpeg2_interlaced.mpg"]["port_refuses"]
    with pytest.raises(Unsupported, match="interlaced frames.*item 8"):
        list(vio.read_frames(path))
    with pytest.raises(Unsupported, match="interlaced frames.*item 8"):
        next(vio.EncodedVideo(path).planes(1))


def test_truncated_and_damaged_program_streams_raise_value_error(tmp_path):
    data = open(MPG2, "rb").read()
    for cut in (3, 13, 40, 2000, len(data) * 2 // 3, len(data) - 1):
        path = str(tmp_path / f"cut{cut}.mpg")
        with open(path, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(ValueError):
            list(vio.read_frames(path))
    path = str(tmp_path / "junk.mpg")
    with open(path, "wb") as f:
        f.write(data[:4000] + b"\x12\x34" + data[4000:])
    with pytest.raises(ValueError, match="start code|damaged"):
        vio.video_info(path)
    with open(path, "wb") as f:
        f.write(b"\x00\x00\x01\xba\x44\x00\x04\x00\x04\x01\x01\x89\xc3\xf8"
                b"\x00\x00\x01\xe0\x00\x08\x81\x80\x05\x21\x00\x01\x00\x01")
    with pytest.raises(ValueError):
        vio.video_info(path)


def test_fuzzed_program_streams_raise_only_value_error(tmp_path):
    """Seeded byte flips and truncations of the program stream (packs,
    PES headers, the video inside): opening and reading it returns frames
    or raises ValueError, and never anything else."""
    rng = np.random.default_rng(0)
    data = open(os.path.join(FIXTURES, "mpeg2_tools.mpg"), "rb").read()
    raised = read = 0
    for trial in range(60):
        b = bytearray(data)
        if trial % 4 == 0:
            b = b[:int(rng.integers(0, len(b)))]
        else:
            for _ in range(int(rng.integers(1, 8))):
                b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        path = str(tmp_path / f"f{trial}.mpg")
        with open(path, "wb") as f:
            f.write(bytes(b))
        try:
            for _ in vio.read_frames(path):
                pass
            read += 1
        except ValueError:
            raised += 1
    assert raised > 10 and raised + read == 60


def test_corrupt_packets_raise_only_value_error():
    rng = np.random.default_rng(1)
    packets = _ps_samples(MPG2)[:8]
    raised = 0
    for trial in range(120):
        dec = mpeg12.Decoder("fuzz")
        for k, pkt in enumerate(packets):
            data = bytearray(pkt)
            if k == trial % 8:
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
                break
    assert raised > 20


# ------------------------------------------------------------- containers

def test_container_tags_name_mpeg12():
    """FFmpeg's riff.c tags of mpeg1video/mpeg2video in any case (cv2
    writes mpg2 for MPG2); Matroska's V_MPEG1/V_MPEG2; MP4's mp4v with
    objectTypeIndication 0x6A (MPEG-1) and 0x60-0x65 (MPEG-2)."""
    for tag in sorted(MPEG12_TAGS) + ["mpg1", "mpg2", "pim1", "mpgv"]:
        assert codec_of(tag, "t") == "mpeg12", tag
    with pytest.raises(Unsupported, match="MPEG-1, MPEG-2.*item 8"):
        codec_of("M701", "t")
    from opticalflow_tpu_torch.io.mkv import MkvFile
    from opticalflow_tpu_torch.io.mp4 import Mp4File
    assert MkvFile(os.path.join(FIXTURES, "mpeg2_176x144.mkv")).tag == \
        "V_MPEG2"
    assert MkvFile(os.path.join(FIXTURES, "mpeg1_176x144.mkv")).codec == \
        "mpeg12"
    for v in (1, 2):
        assert Mp4File(os.path.join(FIXTURES,
                                    f"mpeg{v}_176x144.mp4")).codec == "mpeg12"


# ------------------------------------------------------- the JAX package

@pytest.mark.parametrize("name", ["mpeg2_176x144.mpg", "mpeg1_176x144.avi",
                                  "mpeg2_176x144.mkv"])
def test_jax_frame_pairs_from_video_equal_read_frames(name):
    path = os.path.join(FIXTURES, name)
    _same(list(vio.read_frames(path, max_frames=20, stride=2)),
          list(jvideo.frame_pairs_from_video(path, max_frames=20, stride=2)))


@pytest.mark.parametrize("name", ["mpeg2_176x144.mpg", "mpeg1_176x144.avi",
                                  "mpeg2_176x144.mp4"])
def test_jax_consecutive_frames_equal(name):
    """In order (one open decoder), then out of order: seeks, the AVI's
    one-early one and the .mpg's clamp among them."""
    path = os.path.join(FIXTURES, name)
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96), stride=2)
    assert ds.index == jds.index
    for i in (0, 1, 2, 15, 16, 5, 33, 34, 23):
        if i < len(ds.index):
            np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                          err_msg=f"pair {i}")


def test_jax_consecutive_frames_equal_on_the_sintel_mpg():
    """A capture just opened reads frame 0 without a seek, though a seek
    to 0 in this file reads frame 12 (test_the_seek_quirks_are_cv2s): the
    pairs read in order from the start are the JAX class's."""
    path = os.path.join(FIXTURES, "mpeg2_sintel_436x1024.mpg")
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96))
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96))
    assert ds.index == jds.index
    for i in range(4):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_jax_consecutive_frames_equal_on_the_training_clip_in_any_order():
    """The Sintel clip's first 10 pictures with a PTS on each, as the card
    run's pseudo regime reads them: shuffled, every read a seek."""
    path = os.path.join(FIXTURES, "mpeg2_sintel_head_436x1024.mpg")
    ds = datasets.ConsecutiveFrames(path, size_hw=(64, 96))
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(64, 96))
    assert ds.index == jds.index == [(i, i + 1) for i in range(9)]
    for i in (5, 2, 8, 0, 7, 3):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"],
                                      err_msg=f"pair {i}")


def test_a_capture_just_opened_reads_frame_0_in_order():
    """``read(0)`` on a video just opened, or closed since, decodes from
    the start as cv2's first read does; ``frame(0)`` seeks as
    CAP_PROP_POS_FRAMES does."""
    path = os.path.join(FIXTURES, "mpeg2_sintel_436x1024.mpg")
    frames = list(vio.read_frames(path))
    video = vio.EncodedVideo(path)
    for _ in range(2):
        np.testing.assert_array_equal(video.read(0), frames[0])
        np.testing.assert_array_equal(video.read(1), frames[1])
        video.close()
    np.testing.assert_array_equal(video.frame(0), frames[12])


def test_a_decoder_that_leaves_ffmpegs_output_order_raises(monkeypatch):
    """The decoder's pictures are numbered by the output order FFmpeg's
    gives: a picture handed over out of that order, or one never handed
    over, raises rather than renumbering or dropping frames."""
    real = mpeg12.output_order
    video = vio.EncodedVideo(MPG2)
    monkeypatch.setattr(vio, "output_order", lambda *a: real(*a)[1:])
    with pytest.raises(ValueError, match="handed over picture"):
        list(video)
    monkeypatch.setattr(vio, "output_order",
                        lambda *a: real(*a) + [len(a[0]) - 1])
    with pytest.raises(ValueError, match="never handed over"):
        list(video)


@pytest.mark.parametrize("name", ["mpeg2_176x144.mpg", "mpeg1_176x144.avi"])
def test_jax_capture_frame_equals(tmp_path, name):
    """Frame 13 of the MPEG-2 stream is a B-picture."""
    path = os.path.join(FIXTURES, name)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([path, "13", a]) == 0
        assert jcapture.main([path, "13", b]) == 0
    with open(a, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got[..., ::-1], cv2.imread(b))


def _fake_ckpt(tmp_path):
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from oracles.torch_pwcnet import OraclePWC
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for p in net.parameters():
        p.data *= 0.5
    ckpt = str(tmp_path / "fake.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               net.state_dict_flat().items()}}, ckpt)
    return ckpt


def _write_mpg(path, n, h=64, w=96):
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from make_video_fixtures import moving_clip
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MPG2"), 25.0, (w, h))
    for f in moving_clip(h, w, n, seed=9, speed=3.0):
        wr.write(f)
    wr.release()


def test_extract_video_mpg_in_mp4_out(tmp_path, monkeypatch):
    """The video CLI over a cv2-written MPEG-2 .mpg: the frames it reads
    are cv2.VideoCapture's, and cv2 reads its .mp4 output with the clip's
    count (one frame a pair), fps and size, frame for frame as the port."""
    ckpt = _fake_ckpt(tmp_path)
    src = str(tmp_path / "clip.mpg")
    _write_mpg(src, 5)
    import opticalflow_tpu_torch.video as tvideo
    seen, read = [], tvideo.read_frames

    def recording(*args, **kwargs):
        for frame in read(*args, **kwargs):
            seen.append(frame)
            yield frame
    monkeypatch.setattr(tvideo, "read_frames", recording)
    out = str(tmp_path / "arrows.mp4")
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_video.main([src, out, "--ckpt", ckpt, "--batch", "2",
                                   "--dtype", "float32", "--device",
                                   "cpu"]) == 0
    _same(seen, _cv2_frames(src))
    assert _cv2_info(out) == vio.video_info(out) == {
        "fps": 25.0, "width": 96, "height": 64, "frames": 4}
    _same(list(vio.read_frames(out)), _cv2_frames(out))


def test_train_pseudo_regime_on_an_mpg(tmp_path):
    """The pseudo regime reads an MPEG-2 .mpg (its pairs are the JAX
    class's; a 12-frame clip, whose PTS cv2 counts as 9 frames): two steps
    at batch 4, finite losses."""
    from opticalflow_tpu_torch.cli import train as cli
    src = str(tmp_path / "clip.mpg")
    _write_mpg(src, 12, 72, 96)
    ds = cli._make_dataset(cli.build_parser().parse_args(
        ["--regime", "pseudo", "--data-root", src, "--size", "64", "96"]))
    jds = jdatasets.ConsecutiveFrames(src, size_hw=(64, 96))
    assert ds.index == jds.index
    np.testing.assert_array_equal(ds[3]["images"], jds[3]["images"])
    out = str(tmp_path / "run")
    assert cli.main(["--regime", "pseudo", "--data-root", src, "--out-dir",
                     out, "--epochs", "1", "--size", "64", "64", "--crop",
                     "64", "64", "--batch", "4", "--workers", "2",
                     "--log-every", "1", "--seed", "0", "--device",
                     "cpu"]) == 0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "step" in r]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_sequence_of_another_size_drops_the_held_picture_as_ffmpeg():
    """Two libavcodec MPEG-2 streams in one program stream, the second's
    sequence header 128x96: FFmpeg reinitialises at the new size and the
    reference picture it held back for display (the first stream's last)
    is never handed over, so cv2 reads 12 of the 13 pictures; the rest
    come out at the first size, scaled as swscale scales them."""
    name = "mpeg2_resize.mpg"
    path = os.path.join(FIXTURES, name)
    video = vio.EncodedVideo(path)
    assert video.resets == [7]
    assert video.display == list(range(6)) + [None] + list(range(6, 12))
    assert mpeg12.output_order([1, 2, 2, 1, 2], [True] + [None] * 4,
                               resets=[3]) == [0, 1, 3, 4]
    frames = list(vio.read_frames(path))
    _same(frames, _cv2_frames(path))
    assert len(frames) == 12 and MANIFEST[name]["frames"] == 13
    assert "size_change" in MANIFEST[name]["mpeg12_features"]
