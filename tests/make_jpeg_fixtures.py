"""Regenerate ``tests/goldens/jpeg/``: the JPEG files the port's decoder is
held to where no encoder exists (the GPU machine has neither PIL nor
OpenCV), and ``manifest.json`` with each file's shape and the SHA-256 of
the pixels PIL's ``convert("RGB")`` and ``cv2.imdecode(..., IMREAD_COLOR)``
(as RGB, EXIF orientation applied) decode from it, and of the BGR frame
``cv2.VideoCapture`` reads from it as a one-file image sequence
(``sha256_videocapture``: FFmpeg's decoder and swscale, no EXIF rotation).

    python tests/make_jpeg_fixtures.py

Needs PIL and OpenCV; the manifest records their versions.  Every file is
made from the golden frames ``tests/goldens/real_im{1,2}.png`` (resized
with the port's own ``resize_bilinear_u8``) or from seeded noise:

  * ``sintel_im{1,2}.jpg``: the pair at 436x1024 (Sintel), 4:2:0 baseline
    q90 by PIL, as cameras and ``ffmpeg -i in.mp4 dir/%06d.jpg`` write;
  * ``frame_1080p.jpg``: real_im1 at 1080x1920, the same way;
  * small feature files at 1x1, 7x9 and 37x53: subsampling 4:4:4, 4:2:2,
    4:4:0 and 4:1:1 (OpenCV's ``IMWRITE_JPEG_SAMPLING_FACTOR``), grey,
    restart intervals, progressive, optimised Huffman tables; q100 noise;
    EXIF orientation 6 and 8.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "goldens")
OUT = os.path.join(GOLD, "jpeg")


def pixel_digest(img: np.ndarray) -> str:
    """SHA-256 of a C-contiguous (H, W, 3) uint8 array's bytes."""
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8).tobytes()
                          ).hexdigest()


def _pil_jpeg(img, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cv2_jpeg(img, *params) -> bytes:
    import cv2
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(bgr), list(params))
    assert ok
    return enc.tobytes()


def _exif(orientation: int) -> bytes:
    from PIL import Image
    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex.tobytes()


def fixtures():
    """{file name: JPEG bytes}."""
    import cv2
    sys.path.insert(0, os.path.dirname(HERE))
    from PIL import Image
    from opticalflow_tpu_torch.io.images import resize_bilinear_u8
    frames = [np.asarray(Image.open(os.path.join(GOLD, f"real_im{i}.png"))
                         .convert("RGB")) for i in (1, 2)]
    files = {}
    for i, fr in enumerate(frames, 1):
        files[f"sintel_im{i}.jpg"] = _pil_jpeg(
            resize_bilinear_u8(fr, 436, 1024), quality=90, subsampling=2)
    files["frame_1080p.jpg"] = _pil_jpeg(
        resize_bilinear_u8(frames[0], 1080, 1920), quality=90,
        subsampling=2)
    sf = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
          "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
          "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
          "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    for h, w in ((1, 1), (7, 9), (37, 53)):
        crop = np.ascontiguousarray(frames[0][60:60 + h, 100:100 + w])
        tag = f"{h}x{w}"
        for name, factor in sf.items():
            files[f"s{name}_{tag}.jpg"] = _cv2_jpeg(
                crop, cv2.IMWRITE_JPEG_QUALITY, 90,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor)
        files[f"grey_{tag}.jpg"] = _pil_jpeg(crop[..., 1], quality=90)
        files[f"rst_{tag}.jpg"] = _cv2_jpeg(
            crop, cv2.IMWRITE_JPEG_QUALITY, 75,
            cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
        files[f"progressive_{tag}.jpg"] = _pil_jpeg(
            crop, quality=85, progressive=True)
        files[f"optimized_{tag}.jpg"] = _pil_jpeg(
            crop, quality=85, optimize=True)
    noise = np.random.RandomState(0).randint(0, 256, (37, 53, 3)).astype(
        np.uint8)
    files["q100_noise_37x53.jpg"] = _pil_jpeg(noise, quality=100,
                                              subsampling=0)
    crop = np.ascontiguousarray(frames[1][40:77, 150:203])
    for o in (6, 8):
        files[f"exif{o}_37x53.jpg"] = _pil_jpeg(crop, quality=90,
                                               exif=_exif(o))
    return files


def videocapture_frame(data: bytes) -> np.ndarray:
    """The BGR frame ``cv2.VideoCapture`` reads from JPEG bytes, as the one
    file of a ``%06d.jpg`` sequence."""
    import shutil
    import tempfile
    import cv2
    tmp = tempfile.mkdtemp()
    try:
        with open(os.path.join(tmp, "000000.jpg"), "wb") as f:
            f.write(data)
        cap = cv2.VideoCapture(os.path.join(tmp, "%06d.jpg"))
        ok, frame = cap.read()
        cap.release()
    finally:
        shutil.rmtree(tmp)
    assert ok
    return frame


def main() -> int:
    import cv2
    import PIL
    from PIL import Image, features
    os.makedirs(OUT, exist_ok=True)
    manifest = {"written_by": "tests/make_jpeg_fixtures.py",
                "pil": PIL.__version__,
                "pil_libjpeg_turbo": features.version("libjpeg_turbo"),
                "cv2": cv2.__version__, "files": {}}
    for name, data in sorted(fixtures().items()):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        ocv = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_COLOR)[..., ::-1]
        manifest["files"][name] = {
            "shape": list(pil.shape), "sha256_pil": pixel_digest(pil),
            "cv2_shape": list(ocv.shape), "sha256_cv2": pixel_digest(ocv),
            "sha256_videocapture": pixel_digest(videocapture_frame(data))}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"{len(manifest['files'])} files, {total} bytes in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
