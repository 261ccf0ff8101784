"""Streaming video flow extraction on the GPU (the
``pwc_extract_flow_video.py`` / ``..._vanishpoint.py`` equivalent): video
in, overlay video out.

Counterpart of ``opticalflow_tpu.cli.extract_video`` with the same flags
plus ``--device`` (default ``cuda``).  Video is read and written as
``.y4m`` (YUV4MPEG2, 8-bit 4:2:0) or a directory of PNG frames
(``io/video.py``): the GPU machine has no H.264 decoder or encoder.
Overlay modes:

  * ``arrows``  — arrow quiver (default)
  * ``color``   — Middlebury colour wheel beside the frame
  * ``vanish``  — arrows + vanishing-point marker
  * ``topview`` — perspective warp to a top view, dominant-direction arrows
  * ``compare`` — beside an OpenCV flow baseline: not ported (it raises,
    ROADMAP Queue 1 item 7)

::

    python -m opticalflow_tpu_torch.cli.extract_video clip.y4m out.y4m \\
        --ckpt pwc_net.pth.tar --mode arrows --upload i420
"""

from __future__ import annotations

import argparse
import sys
import time

from opticalflow_tpu_torch.cli.extract_flow import build_model

# the JAX CLI's titles, kept so both draw the same frames
ARROWS_TITLE = "PWC-Net (TPU)"
VANISH_TITLE = "PWC-Net VP (TPU)"


def build_parser():
    p = argparse.ArgumentParser(
        description="Video optical-flow extraction (PyTorch/CUDA)")
    p.add_argument("video", help="input .y4m file or PNG frame directory")
    p.add_argument("out", help="output .y4m file or PNG frame directory")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--variant", choices=("new", "old"), default="new")
    p.add_argument("--mode", default="arrows",
                   choices=("arrows", "color", "vanish", "compare", "topview"))
    p.add_argument("--preset", default="rgb_unit")
    p.add_argument("--flow-scale", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--step", type=int, default=16, help="arrow grid stride")
    p.add_argument("--arrow-scale", type=float, default=1.0)
    p.add_argument("--shrink", type=float, default=1.0,
                   help="vanish mode: shrink-to-center canvas ratio (<1 "
                        "shows off-frame vanishing points on black margin)")
    p.add_argument("--compare-method", default="farneback",
                   choices=("farneback", "dis", "lucaskanade_dense"))
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--no-decimate", action="store_true",
                   help="arrows/vanish: read back the full quarter-res flow "
                        "instead of the arrow grid decimated on the card")
    p.add_argument("--upload", choices=("bgr", "i420"), default="bgr",
                   help="i420: upload planar YUV 4:2:0 windows (half the "
                        "bytes, unpacked on the card bit-exactly to OpenCV)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="bfloat16")
    p.add_argument("--complexity", action="store_true",
                   help="print the per-layer params/FLOPs table at model "
                        "load (the reference's ptflops print; FLOPs of the "
                        "convolutions at 1x6x384x512)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


class Overlay:
    """Draws one output frame per (frame, flow) in the CLI's mode."""

    def __init__(self, args, h: int, w: int, gstep):
        from opticalflow_tpu_torch.viz import topview as tv
        self.args, self.h, self.w, self.gstep = args, h, w, gstep
        self.tv_matrix = (tv.perspective_matrix(w, h)
                          if args.mode == "topview" else None)

    def __call__(self, frame, qflow):
        from opticalflow_tpu_torch.runtime.flowviz import (
            flow_to_color_native, resize_flow_native)
        from opticalflow_tpu_torch.viz import overlay as ov
        from opticalflow_tpu_torch.viz import topview as tv
        from opticalflow_tpu_torch.viz.vanishing import (
            draw_vanishing_point, estimate_vanishing_point, vanish_frame)
        a, h, w, gstep = self.args, self.h, self.w, self.gstep
        if a.mode == "arrows":
            return ov.arrow_overlay(frame, qflow, step=a.step,
                                    scale=a.arrow_scale, title=ARROWS_TITLE,
                                    grid_step=gstep)
        if a.mode == "color":
            full = resize_flow_native(qflow, h, w)
            return ov.side_by_side(frame,
                                   flow_to_color_native(full)[..., ::-1])
        if a.mode == "vanish":
            if a.shrink < 1.0:
                return vanish_frame(frame, qflow, step=a.step,
                                    scale=a.arrow_scale, shrink_ratio=a.shrink,
                                    title=VANISH_TITLE, grid_step=gstep)
            if gstep is None:   # --no-decimate: the full-res field on host
                qflow = resize_flow_native(qflow, h, w)
            out = ov.arrow_overlay(frame, qflow, step=a.step,
                                   scale=a.arrow_scale, grid_step=gstep)
            return draw_vanishing_point(out, estimate_vanishing_point(
                qflow, step=a.step, grid_step=gstep, frame_hw=(h, w)))
        # topview: the frames were warped before the runner saw them
        full = ov.resize_flow_np(qflow, h, w)
        return tv.draw_direction_arrows(frame, full, step=20, scale=5.0,
                                        dominant=tv.dominant_direction(full))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "compare":
        from opticalflow_tpu_torch.viz.overlay import opencv_flow
        opencv_flow(None, None, args.compare_method)   # not ported: raises
    from opticalflow_tpu_torch.io.video import AsyncVideoWriter, video_info
    from opticalflow_tpu_torch.train.checkpoints import load_params
    from opticalflow_tpu_torch.utils.profiling import param_count
    from opticalflow_tpu_torch.video import (VideoFlowRunner,
                                             frame_pairs_from_video)
    from opticalflow_tpu_torch.viz import topview as tv

    # arrows/vanish read only every --step-th pixel: decimate on the card so
    # the readback ships the arrow grid, not the quarter-res field
    gstep = (args.step if args.mode in ("arrows", "vanish")
             and not args.no_decimate else None)
    runner = VideoFlowRunner(build_model(args.variant, args.dtype),
                             load_params(args.ckpt), preset=args.preset,
                             flow_scale=args.flow_scale, batch=args.batch,
                             grid_step=gstep, upload=args.upload,
                             device=args.device)
    if args.complexity:
        from opticalflow_tpu_torch.utils.profiling import (
            model_complexity, per_layer_complexity)
        print(per_layer_complexity(runner.model))
        rep = model_complexity(runner.model)
        print(f"params: {rep['params_m']:.2f} M"
              + (f"   {rep['gmacs']:.1f} GMac @ {rep['input_shape']}"
                 if "gmacs" in rep else ""))
    print(f"model: PWCDCNet[{args.variant}] "
          f"{param_count(runner.model) / 1e6:.2f}M params, {args.dtype}")

    info = video_info(args.video)
    w, h = int(info["width"]), int(info["height"])
    out_w = w * 2 if args.mode == "color" else w
    writer = AsyncVideoWriter(args.out, info["fps"], (out_w, h))
    draw = Overlay(args, h, w, gstep)
    frames = frame_pairs_from_video(args.video, max_frames=args.max_frames)
    if args.mode == "topview":
        frames = (tv.warp_topview(f, draw.tv_matrix) for f in frames)

    n = 0
    t0 = None  # start timing after the first (build- and warm-up-laden) result
    try:
        for frame, _, qflow in runner.run(frames):
            if t0 is None:
                t0 = time.perf_counter()
            writer.write(draw(frame, qflow)[:h, :out_w])
            n += 1
    finally:
        writer.release()
    dt = (time.perf_counter() - t0) if t0 is not None else 0.0
    fps_out = (n - 1) / dt if (n > 1 and dt > 0) else float("nan")
    print(f"{n} frame pairs -> {args.out}  ({fps_out:.1f} fps steady-state)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
