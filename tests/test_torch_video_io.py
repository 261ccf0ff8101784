"""The port's frame I/O (``io/video.py``): ``.y4m`` and PNG directories in
and out, JPEG directories in (``.mp4``/``.avi`` in ``test_torch_mp4.py``),
without OpenCV, held against ``cv2.VideoCapture`` (a ``.y4m`` reads
through FFmpeg's yuv4mpeg demuxer and swscale, as the JAX package reads
it), OpenCV's I420 conversion (what the writer stores) and the JAX
package's ``AsyncVideoWriter`` behaviour and ``ConsecutiveFrames``.
Tolerance: bit-exact throughout."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import os

import numpy as np
import pytest

from make_video_fixtures import h264_field_mp4
from opticalflow_tpu.data import datasets as jdatasets
from opticalflow_tpu_torch.data import datasets
from opticalflow_tpu_torch.io import video as vio
from opticalflow_tpu_torch.io.images import encode_png

cv2 = pytest.importorskip("cv2")


def _frames(n, h, w, seed=0):
    rng = np.random.RandomState(seed)
    return [cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(np.uint8),
                             (0, 0), 1.5) for _ in range(n)]


def _cv2_capture(path):
    """Every frame ``cv2.VideoCapture`` reads from ``path``."""
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def _write_y4m(path, frames, fps=25.0):
    h, w = frames[0].shape[:2]
    wr = vio.Y4MWriter(path, fps, (w, h))
    for f in frames:
        wr.write(f)
    wr.release()


def test_y4m_round_trip_is_opencvs_i420(tmp_path):
    """The writer stores OpenCV's I420; the reader gives what
    ``cv2.VideoCapture`` gives (swscale's conversion, not ``cvtColor``'s:
    the JAX package reads a ``.y4m`` through FFmpeg)."""
    path = str(tmp_path / "a.y4m")
    frames = _frames(4, 36, 52)
    _write_y4m(path, frames)
    info = vio.video_info(path)
    assert info == {"fps": 25.0, "width": 52, "height": 36, "frames": 4}
    got = list(vio.read_frames(path))
    want = _cv2_capture(path)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(vio.read_frame(path, 2), got[2])
    # the planes on disk are OpenCV's I420, after a one-line header and
    # a FRAME line
    with open(path, "rb") as fh:
        assert fh.readline() == b"YUV4MPEG2 W52 H36 F25:1 Ip A1:1 C420jpeg\n"
        assert fh.readline() == b"FRAME\n"
        plane = np.frombuffer(fh.read(36 * 52 * 3 // 2), np.uint8)
    np.testing.assert_array_equal(
        plane, cv2.cvtColor(frames[0], cv2.COLOR_BGR2YUV_I420).ravel())


@pytest.mark.parametrize("h,w", [(7, 9), (36, 53), (37, 52), (2, 2)])
def test_y4m_odd_sides_and_frame_parameters(tmp_path, h, w):
    """Odd sides (chroma planes of ceil(n/2); an odd height through
    swscale's scaler), every colour tag the reader takes (each its chroma
    site), full range, frame headers with parameters: each frame equals
    ``cv2.VideoCapture``'s; without an F tag the rate is yuv4mpegdec's
    25 fps."""
    rng = np.random.RandomState(2)
    y = rng.randint(0, 256, (h, w), np.uint8)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    u, v = (rng.randint(0, 256, (ch, cw), np.uint8) for _ in range(2))
    for tag in ("C420jpeg", "C420mpeg2", "C420paldv", "C420", "",
                "C420mpeg2 XCOLORRANGE=FULL", "XYSCSS=420JPEG"):
        path = str(tmp_path / f"odd{tag.replace(' ', '_')}.y4m")
        with open(path, "wb") as fh:
            fh.write(f"YUV4MPEG2 W{w} H{h} F30000:1001 {tag}\n".encode())
            fh.write(b"FRAME Ixyz\n" + y.tobytes() + u.tobytes()
                     + v.tobytes())
        (got,) = list(vio.read_frames(path))
        (want,) = _cv2_capture(path)
        np.testing.assert_array_equal(got, want, err_msg=tag)
        assert vio.video_info(path)["fps"] == pytest.approx(30000 / 1001)
    path = str(tmp_path / "norate.y4m")
    with open(path, "wb") as fh:
        fh.write(f"YUV4MPEG2 W{w} H{h}\n".encode())
        fh.write(b"FRAME\n" + y.tobytes() + u.tobytes() + v.tobytes())
    cap = cv2.VideoCapture(path)
    assert vio.video_info(path)["fps"] == cap.get(cv2.CAP_PROP_FPS) == 25.0
    cap.release()
    # an odd-sided stream written by the port reads back at its size
    path = str(tmp_path / "w.y4m")
    _write_y4m(path, _frames(2, 7, 9))
    assert [f.shape for f in vio.read_frames(path)] == [(7, 9, 3)] * 2


def test_y4m_refuses_what_it_does_not_read(tmp_path):
    for header in (b"YUV4MPEG2 W8 H8 C444\n", b"YUV4MPEG2 W8 H8 C420p10\n",
                   b"YUV4MPEG2 W8 H8 Cmono\n", b"YUV4MPEG2 H8\n",
                   b"RIFF1234"):
        path = str(tmp_path / "bad.y4m")
        with open(path, "wb") as fh:
            fh.write(header + b"FRAME\n" + b"\0" * 96)
        with pytest.raises(ValueError):
            list(vio.read_frames(path))


def test_png_directory_in_and_out(tmp_path):
    frames = _frames(3, 20, 30, seed=1)
    out = str(tmp_path / "frames")
    wr = vio.AsyncVideoWriter(out, 12.0, (30, 20))
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()
    assert sorted(os.listdir(out)) == ["000000.png", "000001.png",
                                       "000002.png"]
    for f, name in zip(frames, sorted(os.listdir(out))):
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(out, name), cv2.IMREAD_COLOR), f)
    got = list(vio.read_frames(out, stride=2))
    assert len(got) == 2
    np.testing.assert_array_equal(got[1], frames[2])
    assert vio.video_info(out) == {"fps": 30.0, "width": 30, "height": 20,
                                   "frames": 3}


def test_jpeg_directory_reads_as_cv2_videocapture(tmp_path):
    """A directory of ``%06d.jpg`` frames: each frame equals ``cv2.imread``
    (libjpeg-turbo, BGR, no EXIF rotation) bit for bit.  The JAX package's
    ``cv2.VideoCapture`` over the same sequence decodes through FFmpeg's
    own JPEG decoder and colour conversion: the same frames within a mean
    of 4 levels (2.93 on these frames; its largest difference 17).
    ``*.jpeg`` reads too; a directory mixing kinds raises."""
    frames = _frames(4, 21, 30, seed=4)
    jdir = tmp_path / "jpg"
    jdir.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(jdir / f"{i:06d}.jpg"), f)
    want = [cv2.imread(str(jdir / f"{i:06d}.jpg"), cv2.IMREAD_COLOR)
            for i in range(4)]
    got = list(vio.read_frames(str(jdir)))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    cap = cv2.VideoCapture(str(jdir / "%06d.jpg"))
    try:
        for g in got:
            ok, fr = cap.read()
            if not ok:               # no image-sequence backend here
                break
            assert np.abs(fr.astype(np.int64) - g).mean() < 4
    finally:
        cap.release()
    np.testing.assert_array_equal(vio.read_frame(str(jdir), 2), want[2])
    assert vio.video_info(str(jdir)) == {"fps": 30.0, "width": 30,
                                         "height": 21, "frames": 4}
    jpeg_dir = tmp_path / "jpeg"
    jpeg_dir.mkdir()
    (jpeg_dir / "a.jpeg").write_bytes((jdir / "000001.jpg").read_bytes())
    np.testing.assert_array_equal(vio.read_frame(str(jpeg_dir), 0), want[1])
    (jdir / "000009.png").write_bytes(encode_png(frames[0]))
    with pytest.raises(ValueError, match="more than one kind"):
        list(vio.read_frames(str(jdir)))


def test_async_writer_y4m_and_max_frames(tmp_path):
    frames = _frames(5, 16, 24, seed=3)
    path = str(tmp_path / "o.y4m")
    wr = vio.AsyncVideoWriter(path, 30.0, (24, 16), queue_size=2)
    for f in frames:
        wr.write(f)
    wr.release()
    got = list(vio.read_frames(path, max_frames=3))
    assert len(got) == 3
    np.testing.assert_array_equal(got[2], _cv2_capture(path)[2])


def test_async_writer_encoder_error_surfaces_not_deadlocks(tmp_path):
    """The JAX writer's behaviour: if the encoder thread dies mid-stream,
    write() raises its error instead of blocking on the full queue."""
    wr = vio.AsyncVideoWriter(str(tmp_path / "x.y4m"), 10, (32, 16),
                              queue_size=2)

    class _Boom:
        def write(self, frame):
            raise RuntimeError("encoder boom")

        def release(self):
            pass

    wr._wr = _Boom()
    frame = np.zeros((16, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="encoder boom"):
        for _ in range(50):
            wr.write(frame)
    with pytest.raises(RuntimeError, match="encoder boom"):
        wr.release()


def test_other_containers_raise_naming_the_two_formats(tmp_path):
    """Field-coded H.264 in MP4 raises naming ROADMAP item 8; a truncated MP4 says so;
    Motion JPEG in AVI and MPEG-2 in a program stream, once refused, read
    as cv2.VideoCapture reads them; an unknown extension (.flv) names the
    formats the port handles; a program stream's bytes under a transport
    or elementary stream's extension (which the port reads now, by
    extension, where FFmpeg probes the content) are refused saying what
    they are not; and
    AsyncVideoWriter now writes .mp4, which cv2 reads."""
    fixtures = os.path.join(os.path.dirname(__file__), "goldens", "video")
    mp4 = open(os.path.join(fixtures, "moving_176x144.mp4"), "rb").read()
    h264, cut = tmp_path / "h264.mp4", tmp_path / "cut.mp4"
    h264.write_bytes(h264_field_mp4(str(tmp_path / "field.mp4")))
    cut.write_bytes(mp4[:len(mp4) - 50])
    for path, match in ((str(h264), "H.264.*frame_mbs_only.*Queue 1 item 8"),
                        (str(cut), "truncated")):
        for fn in (lambda: list(vio.read_frames(path)),
                   lambda: vio.video_info(path)):
            with pytest.raises(ValueError, match=match):
                fn()
    mjpg = os.path.join(fixtures, "mjpg.avi")
    cap = cv2.VideoCapture(mjpg)
    want = [cap.read()[1] for _ in range(2)]
    cap.release()
    got = list(vio.read_frames(mjpg))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert vio.video_info(mjpg) == {"fps": 25.0, "width": 32, "height": 24,
                                    "frames": 2}
    flv = tmp_path / "clip.flv"
    flv.write_bytes(b"FLV\x01")
    with pytest.raises(ValueError, match="truncated"):
        vio.video_info(str(flv))
    rm = tmp_path / "clip.rm"
    rm.write_bytes(b"FLV\x01")
    with pytest.raises(ValueError, match=r"\.mp4.*\.mkv.*\.y4m.*PNG.*item 8"):
        vio.video_info(str(rm))
    # an MPEG-2 program stream, once refused as the .rm is, reads as cv2
    # reads it; under a transport or elementary stream's name it is
    # refused
    mpg = os.path.join(fixtures, "mpeg2_176x144.mpg")
    got, want = list(vio.read_frames(mpg)), _cv2_capture(mpg)
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for ext, match in ((".ts", "not an MPEG transport stream"),
                       (".m2v", r"a program stream.*\.mpg")):
        other = tmp_path / f"clip{ext}"
        other.write_bytes(open(mpg, "rb").read())
        with pytest.raises(ValueError, match=match):
            vio.video_info(str(other))
    mkv = tmp_path / "clip.mkv"        # Matroska reads now: a cut one raises
    mkv.write_bytes(b"\x1a\x45\xdf\xa3")
    with pytest.raises(ValueError, match="truncated Matroska"):
        vio.video_info(str(mkv))
    out = str(tmp_path / "o.mp4")
    frames = _frames(3, 16, 32)
    wr = vio.AsyncVideoWriter(out, 30, (32, 16))
    for f in frames:
        wr.write(f)
    wr.release()
    cap = cv2.VideoCapture(out)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 3
    assert cap.get(cv2.CAP_PROP_FPS) == 30.0
    ok, first = cap.read()
    assert ok and first.shape == (16, 32, 3)
    np.testing.assert_array_equal(first, vio.read_frame(out, 0))
    with pytest.raises(FileNotFoundError):
        vio.video_info(str(tmp_path / "missing.y4m"))
    with pytest.raises(FileNotFoundError):
        list(vio.read_frames(str(tmp_path)))       # a directory of no PNGs


@pytest.mark.parametrize("stride", [1, 2])
def test_consecutive_frames_from_y4m_match_jax(tmp_path, stride):
    """``ConsecutiveFrames`` on a .y4m against the JAX dataset reading the
    same .y4m through ``cv2.VideoCapture`` (rgb_imagenet, resized 48x64 →
    32x40)."""
    path = str(tmp_path / "clip.y4m")
    _write_y4m(path, _frames(5, 48, 64, seed=stride))
    ds = datasets.ConsecutiveFrames(path, size_hw=(32, 40), stride=stride)
    jds = jdatasets.ConsecutiveFrames(path, size_hw=(32, 40), stride=stride)
    assert ds.index == jds.index and len(ds) == 5 - stride
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i]["images"], jds[i]["images"])
