"""The video writer's containers (``io/video.AsyncVideoWriter`` and
``Mpeg4Writer`` into ``io/mp4``, ``io/nut``, ``io/asf``, ``io/mpegps`` and
``io/mpegts``) against OpenCV's ``mp4v`` writer and reader.

Tolerance: 0 throughout.  For every extension cv2's ``mp4v`` writer opens,
the port writes MPEG-4 Part 2 (its own encoder: an I-VOP every 12 frames,
quantiser 3) into the container FFmpeg's muxer writes there, and:

  * cv2 reads the port's file back to the encoder's reconstruction, frame
    for frame, and ``video_info`` equals what cv2 reports;
  * cv2's count, fps (within 1e-4: the port's 29.97 is 30000/1001, cv2's
    2997/100) and the frames its seeks to 0, 11, 12, 13 and 24 land on
    equal those on cv2's own file of the same frames.  A program stream is
    the exception for the count and the seeks: FFmpeg counts to the last
    PES packet that opens with a picture and seeks by those packets, which
    depend on the pictures' sizes, and the two encoders' pictures differ in
    size.  There the port's muxer is held to FFmpeg's instead: cv2's own
    pictures remuxed by the port come out as cv2's file, byte for byte;
  * the port's reader reads the port's file as cv2 does (frames, count,
    fps, seeks).

The extensions cv2's writer does not open raise ``ValueError`` naming what
the port writes.  At 25 and 30000/1001 fps at 96x64, and at 53x37, which
cv2 and the port both crop to 52x36.
"""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import struct

import cv2
import numpy as np
import pytest

from make_video_fixtures import moving_clip
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.asf import AsfFile, AsfWriter
from opticalflow_tpu_torch.io.mpegps import MpegPsFile, PsWriter
from opticalflow_tpu_torch.io.mpegts import MpegTsFile, TsWriter
from opticalflow_tpu_torch.io.nut import INDEX, INFO, NutFile, NutWriter
from opticalflow_tpu_torch.runtime import mpeg4

# every extension cv2's mp4v writer opens beyond .mp4, .avi and .mkv
WRITABLE = (".mov", ".m4v", ".3gp", ".3g2", ".nut", ".wmv", ".asf", ".mpg",
            ".mpeg", ".vob", ".ts", ".mts", ".m2t", ".m2ts")
PROGRAM = (".mpg", ".mpeg", ".vob")
# where cv2's mp4v writer does not open
REFUSED = (".flv", ".webm", ".mxf", ".ogv", ".m1v", ".m2v", ".drc", ".h263")
CASES = [(25.0, (96, 64)), (30000 / 1001, (96, 64)), (25.0, (53, 37))]
SEEKS = (0, 11, 12, 13, 24)


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            return out
        out.append(frame)


def _cv2_info(path):
    cap = cv2.VideoCapture(path)
    return {"fps": cap.get(cv2.CAP_PROP_FPS),
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}


def _fourcc(path):
    cap = cv2.VideoCapture(path)
    return int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little")


def _landing(path, frames):
    """The index (into ``frames``, cv2's sequential read) of the frame each
    of cv2's seeks reads, None where it reads none."""
    out = []
    for t in SEEKS:
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, t)
        ok, got = cap.read()
        out.append(None if not ok else next(
            (i for i, f in enumerate(frames) if np.array_equal(f, got)), -1))
    return out


def _cv2_write(path, frames, fps):
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert wr.isOpened(), path
    for f in frames:
        wr.write(f)
    wr.release()


@pytest.mark.parametrize("fps,size", CASES)
@pytest.mark.parametrize("ext", WRITABLE)
def test_port_written_file_reads_in_cv2_as_cv2s_own(tmp_path, ext, fps, size):
    w, h = size
    frames = moving_clip(h, w, 25, seed=26, speed=3.0)
    port, own = str(tmp_path / f"port{ext}"), str(tmp_path / f"cv2{ext}")
    wr = vio.Mpeg4Writer(port, fps, size, keep_recon=True)
    for f in frames:
        wr.write(f)
    wr.release()
    _cv2_write(own, frames, fps)

    got = _cv2_frames(port)
    want = [mpeg4.i420_to_bgr(*r) for r in wr.recon]
    assert len(got) == len(want) == 25
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    info, theirs = _cv2_info(port), _cv2_info(own)
    assert vio.video_info(port) == info
    assert (info["width"], info["height"]) == (w & ~1, h & ~1)
    assert _fourcc(port) == _fourcc(own) == b"FMP4"
    assert info["fps"] == pytest.approx(theirs["fps"], rel=1e-4)
    landing = _landing(port, got)
    if ext not in PROGRAM:
        assert info["frames"] == theirs["frames"]
        assert landing == _landing(own, _cv2_frames(own))

    # the port's reader reads the port's file as cv2 does
    mine = list(vio.read_frames(port))
    assert len(mine) == len(got)
    for k, (a, b) in enumerate(zip(mine, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    video = vio.EncodedVideo(port)
    for t, hit in zip(SEEKS, landing):
        if hit is None:
            with pytest.raises(ValueError, match="reads no frame"):
                video.frame(t)
        else:
            np.testing.assert_array_equal(video.frame(t), got[hit],
                                          err_msg=f"seek {t}")


@pytest.mark.parametrize("ext", REFUSED)
def test_what_cv2s_writer_does_not_open_is_refused(tmp_path, ext):
    """The port raises naming what it writes (the JAX CLI, which never
    checks ``isOpened``, runs on and writes nothing there)."""
    with pytest.raises(ValueError, match=r"cannot write.*the port writes"):
        vio.AsyncVideoWriter(str(tmp_path / f"out{ext}"), 25.0, (64, 48))
    assert not cv2.VideoWriter(str(tmp_path / f"cv2{ext}"),
                               cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                               (64, 48)).isOpened()


@pytest.mark.parametrize("ext", WRITABLE)
def test_async_writer_writes_what_the_writer_writes(tmp_path, ext):
    """``AsyncVideoWriter`` (the video CLI's ``--out``) writes the bytes
    ``Mpeg4Writer`` writes, behind its encode thread."""
    frames = moving_clip(48, 64, 14, seed=3, speed=2.0)
    a, b = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    wr = vio.AsyncVideoWriter(a, 25.0, (64, 48))
    for f in frames:
        wr.write(f)
    wr.release()
    wr = vio.Mpeg4Writer(b, 25.0, (64, 48))
    for f in frames:
        wr.write(f)
    wr.release()
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# ----------------------------------------- the muxers against FFmpeg's

@pytest.fixture(scope="module")
def cv2_files(tmp_path_factory):
    """cv2's own mp4v files of one clip, by extension."""
    root = tmp_path_factory.mktemp("own")
    frames = moving_clip(64, 96, 25, seed=60, speed=3.0)
    out = {}
    for ext in (".mpg", ".vob", ".ts", ".nut", ".wmv"):
        out[ext] = str(root / f"cv2{ext}")
        _cv2_write(out[ext], frames, 25.0)
    return out


@pytest.mark.parametrize("ext,mpeg2", [(".mpg", False), (".vob", True)])
def test_program_stream_muxer_is_ffmpegs(tmp_path, cv2_files, ext, mpeg2):
    """cv2's pictures (VOL headers in band), demuxed by the port and muxed
    again, come out as cv2's file byte for byte: 2048-byte packs, the
    system header, PTS where a picture opens a PES packet, padding, the
    SCR bumps, and (``svcd`` for .vob) the empty first pack and MPEG-2's
    P-STD extension."""
    box = MpegPsFile(cv2_files[ext])
    out = str(tmp_path / f"re{ext}")
    with open(box.path, "rb") as f:
        samples = [box.sample(f, i) for i in range(len(box.starts))]
    wr = PsWriter(out, (25, 1), mpeg2=mpeg2)
    for s in samples:
        wr.write(s, False)
    wr.release()
    with open(out, "rb") as a, open(box.path, "rb") as b:
        assert a.read() == b.read()


def test_transport_stream_muxer_is_ffmpegs(tmp_path, cv2_files):
    """The same for a transport stream: cv2's file without FFmpeg's SDT
    packets (PID 0x11, its provider and service names) is the port's."""
    box = MpegTsFile(cv2_files[".ts"])
    out = str(tmp_path / "re.ts")
    wr = TsWriter(out, (25, 1))
    with open(box.path, "rb") as f:
        for i in range(len(box.starts)):
            wr.write(box.sample(f, i), i in box.keyframes)
    wr.release()
    with open(box.path, "rb") as f:
        data = f.read()
    want = b"".join(data[k:k + 188] for k in range(0, len(data), 188)
                    if (data[k + 1] & 0x1F) << 8 | data[k + 2] != 0x11)
    with open(out, "rb") as f:
        assert f.read() == want


def test_nut_muxer_is_ffmpegs(tmp_path, cv2_files):
    """The same for NUT: cv2's file without FFmpeg's global info packet
    (its encoder's name) is the port's up to the index, whose syncpoint
    positions then differ by that packet's length; the index reads the
    same."""
    box = NutFile(cv2_files[".nut"])
    out = str(tmp_path / "re.nut")
    wr = NutWriter(out, (box.width, box.height), (25, 1), box.dsi)
    with open(box.path, "rb") as f:
        for i in range(len(box.sizes)):
            wr.write(box.sample(f, i), box.keys[i])
    wr.release()
    with open(box.path, "rb") as f:
        data = f.read()
    info = data.find(INFO.to_bytes(8, "big"))
    size = data[info + 8]                    # one byte of forward pointer
    assert size < 128 and data[info + 9 + size:].startswith(
        INFO.to_bytes(8, "big"))             # the stream's info follows
    want = data[:info] + data[info + 9 + size:]
    with open(out, "rb") as f:
        got = f.read()
    cut = want.rfind(INDEX.to_bytes(8, "big"))
    assert got[:got.rfind(INDEX.to_bytes(8, "big"))] == want[:cut]
    mine = NutFile(out)
    assert [t for t, _ in mine.index] == [t for t, _ in box.index]
    for nut in (mine, box):     # positions in 16-byte units, as NUT keeps
        starts = {sp >> 4 << 4 for sp, _, _ in nut.syncpoints}
        assert all(at in starts for _, at in nut.index)
    assert (mine.max_pts, mine.keyframes, mine.pts) == (
        box.max_pts, box.keyframes, box.pts)


def test_asf_muxer_is_ffmpegs(tmp_path, cv2_files):
    """The same for ASF: the Data Object (3200-byte packets, several
    payloads each, the padding's length type, send times and durations)
    and the Simple Index are cv2's byte for byte; the Header Object leaves
    out FFmpeg's codec list and its encoder's name."""
    box = AsfFile(cv2_files[".wmv"])
    out = str(tmp_path / "re.wmv")
    wr = AsfWriter(out, (box.width, box.height), (25, 1), box.dsi)
    with open(box.path, "rb") as f:
        for i in range(len(box.sizes)):
            s = box.sample(f, i)
            wr.write(s, s[3:4] == b"\xb3")
    wr.release()

    def tail(path):
        with open(path, "rb") as f:
            data = f.read()
        size = struct.unpack("<Q", data[16:24])[0]   # the Header Object's
        return data[size:]

    assert tail(out) == tail(box.path)
