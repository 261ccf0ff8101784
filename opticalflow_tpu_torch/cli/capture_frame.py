"""Grab frame N of a video as a PNG (a fixture generator: the reference's
``capture_frame.py`` capability), without OpenCV.

Counterpart of ``opticalflow_tpu.cli.capture_frame``: the video is any
file ``io/video.py`` reads (``.mp4``, ``.avi``, ``.mkv``, ``.webm``,
``.nut``, ``.wmv``, ... of the codecs it decodes, from the keyframe before
the frame, as FFmpeg's seek does), an MPEG program or transport stream
(``.mpg``, ``.mpeg``, ``.vob``, ``.ts``, ``.m2ts``, ``.mts``: the frame
OpenCV's seek reads, its quirks included; a seek that reads nothing, as
after any seek in a Dirac ``.nut``, exits 1, as the JAX CLI does), an
elementary stream (``.m2v``, ``.h263``, ``.drc``, ...), a ``.y4m`` file, an
image
sequence named by a pattern (``frames/%06d.jpg``, read as
``cv2.VideoCapture`` reads it) or a directory of PNG or JPEG frames
(``io/video.py``)::

    python -m opticalflow_tpu_torch.cli.capture_frame clip.mp4 10 frame.png
    python -m opticalflow_tpu_torch.cli.capture_frame 'frames/%06d.jpg' 10 frame.png
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Save one video frame as PNG")
    p.add_argument("video", help=".mp4, .avi, .mkv, .webm, .nut, .wmv, "
                                 "... (the codecs io/video.py reads), "
                                 ".mpg/.ts/.m2ts/.m2v/.h263/.drc or .y4m file, "
                                 "image "
                                 "sequence pattern "
                                 "(frames/%%06d.jpg) or PNG/JPEG frame "
                                 "directory")
    p.add_argument("frame", type=int)
    p.add_argument("out", nargs="?", default=None)
    args = p.parse_args(argv)

    from opticalflow_tpu_torch.io.images import encode_png
    from opticalflow_tpu_torch.io.video import read_frame, video_info
    try:
        total = int(video_info(args.video)["frames"])
    except (OSError, ValueError) as e:
        print(f"error: cannot open {args.video}: {e}", file=sys.stderr)
        return 1
    if not 0 <= args.frame < total:
        print(f"error: frame {args.frame} out of range (video has {total})",
              file=sys.stderr)
        return 1
    try:
        frame = read_frame(args.video, args.frame)
    except ValueError as e:     # a seek that reads nothing, as cv2's may
        print(f"error: failed to decode frame {args.frame}: {e}",
              file=sys.stderr)
        return 1
    out = args.out or f"{args.video}frame_{args.frame}.png"
    with open(out, "wb") as f:
        f.write(encode_png(frame[..., ::-1]))
    print(f"wrote {out} ({frame.shape[1]}x{frame.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
