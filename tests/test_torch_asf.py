"""The ASF demuxer (``io/asf``) against OpenCV's FFmpeg: the header
fields, data packets with one payload or several, media objects split
over packets, the Simple Index, the frame rate FFmpeg's probe fits to
millisecond times, and truncated or crafted files.

Tolerance: 0 throughout (every frame, fps, count and seek as cv2's).  The
files are the committed fixtures (``tests/goldens/video``, group
``msmpeg4``: cv2's asf muxer and the fixture writer's ``asf_mux``) and
files written or rewritten here.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest

from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.asf import (DATA, FILE_PROPERTIES, HEADER,
                                          SIMPLE_INDEX, AsfFile, guid)
from opticalflow_tpu_torch.runtime import msmpeg4
from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

FIXTURES = os.path.join(os.path.dirname(__file__), "goldens", "video")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
ASF = sorted(n for n in MANIFEST if n.endswith((".wmv", ".asf")))
SINTEL = "msm_sintel_436x1024.wmv"


def _path(name):
    return os.path.join(FIXTURES, name)


def _make():
    sys.path.insert(0, os.path.dirname(__file__))
    import make_video_fixtures
    return make_video_fixtures


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


def _packets(box):
    with open(box.path, "rb") as f:
        return [box.sample(f, i) for i in range(len(box.sizes))]


def _same(a, b):
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {k}")


# ------------------------------------------------------------- the header

def test_guids_are_stored_little_endian():
    assert HEADER == bytes.fromhex("3026b2758e66cf11a6d900aa0062ce6c")
    assert guid("75B22636-668E-11CF-A6D9-00AA0062CE6C") == DATA


@pytest.mark.parametrize("name", ASF)
def test_header_fields(name):
    """cv2's asf muxer: 3200-byte packets, 3100 ms of preroll, a play
    duration of the frames' span plus the preroll, stream 1 the video with
    the writer's BITMAPINFOHEADER (WMV8's 4 bytes of extradata after it)."""
    box = AsfFile(_path(name))
    info = MANIFEST[name]
    assert (box.width, box.height) == (info["width"], info["height"])
    assert box.stream == 1 and not box.broadcast
    assert box.preroll == 3100
    assert box.packet_size == (256 if "single" in name else 3200)
    assert box.file_size == os.path.getsize(box.path)
    assert len(box.sizes) == info["decoded"]
    assert box.packets == (os.path.getsize(box.path) - box.data_offset - len(
        _index_object(box.path))) // box.packet_size
    assert (len(box.dsi) == 4) == (box.codec == "wmv2")
    assert box.stamps[0] == 0


def _index_object(path):
    data = open(path, "rb").read()
    at = data.find(SIMPLE_INDEX, 30)
    return data[at:] if at >= 0 else b""


@pytest.mark.parametrize("name", ASF)
def test_fps_count_and_frames_equal_cv2(name):
    box = AsfFile(_path(name))
    assert vio.video_info(_path(name)) == _cv2_info(_path(name))
    assert box.fps == MANIFEST[name]["fps"]
    assert box.frames == MANIFEST[name]["frames"]
    assert box.numbered


def test_rates_fit_as_ffmpegs_probe_fits_them():
    """ASF keeps millisecond times and no rate: 30000/1001 comes back as
    cv2's 29.97002997002997 (not the 29.97 an AVI stores), 24 and 15 fps
    exactly."""
    want = {"msm_wmv2_2997_96x64.wmv": 30000 / 1001,
            "msm_wmv2_24fps_96x64.wmv": 24.0,
            "msm_div3_15fps_96x64.wmv": 15.0, "msm_wmv2_96x64.wmv": 25.0}
    for name, fps in want.items():
        assert AsfFile(_path(name)).fps == fps == MANIFEST[name]["fps"]
    box = AsfFile(_path("msm_wmv2_2997_96x64.wmv"))
    assert box.stamps[:4] == [0, 33, 67, 100] and len(box.stamps) == 45


# ------------------------------------------------------------- the data

def test_many_payloads_in_one_packet():
    """cv2's 30 small pictures share one packet as 30 payloads."""
    box = AsfFile(_path("msm_wmv2_96x64.wmv"))
    assert box.packets == 1
    assert all(len(p) == 1 for p in box.pieces)
    starts = [p[0][0] for p in box.pieces]
    assert starts == sorted(starts)
    assert all(box.data_offset < s < box.data_offset + 3200 for s in starts)


def test_media_objects_split_over_packets():
    """The 436x1024 pictures span many 3200-byte packets: each sample is
    its fragments joined, and the decoder reads each as cv2 does."""
    box = AsfFile(_path(SINTEL))
    assert len(box.sizes) == 13 and box.keyframes == [0, 12]
    assert min(len(p) for p in box.pieces) > 3
    assert all(sum(n for _, n in p) == s for p, s in zip(box.pieces,
                                                         box.sizes))
    assert [msmpeg4.is_keyframe(p, "wmv2") for p in _packets(box)] == [
        i in (0, 12) for i in range(13)]


def test_one_payload_a_packet_without_error_correction():
    """``asf_mux``'s 256-byte packets, each one payload and no error
    correction data: a picture in many packets, read as cv2 reads it."""
    name = "msm_asf_single_wmv1_96x64.asf"
    box = AsfFile(_path(name))
    with open(box.path, "rb") as f:
        f.seek(box.data_offset)
        assert f.read(1)[0] == 0x10        # WORD padding, one payload
    assert sum(len(p) for p in box.pieces) == box.packets
    _same(list(vio.read_frames(_path(name))), _cv2_frames(_path(name)))


def test_the_simple_index():
    """An entry a second, each the packet where the last key frame at or
    before that second (less the preroll) starts; its key frame lies at or
    before the entry's time, as FFmpeg's seek needs."""
    for name in (SINTEL, "msm_wmv2_2997_96x64.wmv", "msm_div3_96x64.wmv"):
        box = AsfFile(_path(name))
        assert box.index and box.index[0] == (0, 0)
        for ms, packet in box.index:
            start = box.data_offset + packet * box.packet_size
            keys = [i for i in box.keyframes
                    if start <= box.pieces[i][0][0] < start + box.packet_size]
            assert keys and box.stamps[keys[0]] <= ms, (name, ms, packet)


@pytest.mark.parametrize("multiple,ec,size", [(True, True, 3200),
                                              (True, False, 700),
                                              (False, True, 300)])
def test_asf_mux_layouts_read_as_cv2(tmp_path, multiple, ec, size):
    """v3 pictures at 30000/1001 through the fixture writer's muxer in three
    layouts: the port's frames, fps, count and seeks are cv2's."""
    src = AsfFile(_path("msm_div3_96x64.wmv"))
    path = str(tmp_path / "clip.asf")
    _make().asf_mux(path, _packets(src), 96, 64, "DIV3", fps=30000 / 1001,
                    packet_size=size, multiple=multiple, ec=ec)
    box = AsfFile(path)
    assert box.fps == 30000 / 1001 and (box.packets > 1) == (size < 3200)
    _same(list(vio.read_frames(path)), _cv2_frames(path))
    assert vio.video_info(path) == _cv2_info(path)
    video = vio.EncodedVideo(path)
    for t in (5, 13, 25, 29):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, t)
        ok, frame = cap.read()
        cap.release()
        assert ok
        np.testing.assert_array_equal(video.frame(t), frame, err_msg=str(t))


# ------------------------------------------------------------- refusals

def _patch(data, at, new):
    b = bytearray(data)
    b[at:at + len(new)] = new
    return bytes(b)


def _props_at(data):
    return data.find(FILE_PROPERTIES) + 24


def test_truncated_and_foreign_files_raise(tmp_path):
    data = open(_path(SINTEL), "rb").read()
    path = tmp_path / "cut.wmv"
    path.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        AsfFile(str(path))
    path.write_bytes(data[:200])
    with pytest.raises(ValueError, match="header runs past"):
        AsfFile(str(path))
    path.write_bytes(b"RIFF" + bytes(60))
    with pytest.raises(ValueError, match="not an ASF file"):
        vio.video_info(str(path))
    # packets of two sizes
    p = _props_at(data)
    path.write_bytes(_patch(data, p + 68, struct.pack("<I", 1600)))
    with pytest.raises(ValueError, match="fixed size"):
        AsfFile(str(path))


def test_a_damaged_packet_raises(tmp_path):
    data = open(_path("msm_wmv2_96x64.wmv"), "rb").read()
    box = AsfFile(_path("msm_wmv2_96x64.wmv"))
    path = tmp_path / "bad.wmv"
    path.write_bytes(_patch(data, box.data_offset, b"\x82\x01\x00"))
    with pytest.raises(ValueError, match="error correction"):
        AsfFile(str(path))
    # the first payload's replicated data cut to 4 bytes
    at = box.pieces[0][0][0] - 2 - 9
    path.write_bytes(_patch(data, at, b"\x04"))
    with pytest.raises(ValueError, match="replicated data of 4"):
        AsfFile(str(path))


def test_compressed_payloads_and_guessed_counts_raise_naming_item_8(
        tmp_path):
    data = open(_path("msm_wmv2_96x64.wmv"), "rb").read()
    box = AsfFile(_path("msm_wmv2_96x64.wmv"))
    path = tmp_path / "x.wmv"
    at = box.pieces[0][0][0] - 2 - 9           # replicated data's length
    path.write_bytes(_patch(data, at, b"\x01"))
    with pytest.raises(Unsupported, match=f"compressed ASF.*{ITEM_8}"):
        AsfFile(str(path))
    p = _props_at(data)
    path.write_bytes(_patch(data, p + 64, struct.pack("<I", 3)))   # broadcast
    with pytest.raises(Unsupported, match=f"play duration.*{ITEM_8}"):
        AsfFile(str(path))
    path.write_bytes(_patch(data, p + 16, struct.pack("<Q", len(data) * 2)))
    with pytest.raises(Unsupported, match=f"play duration.*{ITEM_8}"):
        AsfFile(str(path))


def test_times_no_rate_fits_raise_naming_item_8(tmp_path):
    """Frame times FFmpeg's probe fits no rate to as its average (two
    frames, or periods alternating 20 and 60 ms) are refused; so is a seek
    where OpenCV would number the frames otherwise than their indices."""
    src = AsfFile(_path("msm_div3_96x64.wmv"))
    packets = _packets(src)
    path = str(tmp_path / "two.asf")
    _make().asf_mux(path, packets[:2], 96, 64, "DIV3")
    with pytest.raises(Unsupported, match=f"no frame rate.*{ITEM_8}"):
        AsfFile(path)
    path = str(tmp_path / "jitter.asf")
    _make().asf_mux(path, packets, 96, 64, "DIV3")
    data = bytearray(open(path, "rb").read())
    box = AsfFile(path)
    for i in range(1, len(packets), 2):        # odd frames 20 ms early
        at = box.pieces[i][0][0] - 2 - 4
        stamp = struct.unpack("<I", data[at:at + 4])[0]
        data[at:at + 4] = struct.pack("<I", stamp - 20)
    open(path, "wb").write(bytes(data))
    with pytest.raises(Unsupported, match=f"no frame rate.*{ITEM_8}"):
        AsfFile(path)


def test_a_seek_numbered_otherwise_raises_naming_item_8(tmp_path):
    src = AsfFile(_path("msm_div3_96x64.wmv"))
    path = str(tmp_path / "late.asf")
    _make().asf_mux(path, _packets(src), 96, 64, "DIV3")
    data = bytearray(open(path, "rb").read())
    box = AsfFile(path)
    at = box.pieces[20][0][0] - 2 - 4           # frame 20 27 ms late
    stamp = struct.unpack("<I", data[at:at + 4])[0]
    data[at:at + 4] = struct.pack("<I", stamp + 27)
    open(path, "wb").write(bytes(data))
    box = AsfFile(path)
    assert box.fps == 25.0 and not box.numbered
    video = vio.EncodedVideo(path)
    with pytest.raises(Unsupported, match=f"FLV or ASF.*{ITEM_8}"):
        video.frame(20)


def test_huffyuv_in_asf_takes_its_bit_count(tmp_path):
    """HuffYUV and FFVHuff read their version from the BITMAPINFOHEADER's
    bit count, which ASF carries too (found by the census: the port once
    had none for ASF)."""
    for fourcc in ("HFYU", "FFVH"):
        path = str(tmp_path / f"{fourcc}.wmv")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25.0,
                             (96, 64))
        for f in _make().moving_clip(64, 96, 3, seed=31):
            wr.write(f)
        wr.release()
        box = AsfFile(path)
        assert box.codec == "huffyuv" and box.bpc in (12, 16, 24, 32)
        _same(list(vio.read_frames(path)), _cv2_frames(path))
