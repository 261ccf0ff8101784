"""Serving CLI on the GPU: an HTTP optical-flow endpoint with dynamic
batching.

Counterpart of ``opticalflow_tpu.cli.serve`` with the same flags plus
``--device {cuda,cuda:N,cpu}`` (default ``cuda``)::

    python -m opticalflow_tpu_torch.cli.serve --ckpt pwc_net.pth.tar --port 8080

Then ``POST /v1/flow`` ``{"im1": <base64 PNG or JPEG>, "im2": <...>}`` (or
the two raw uint8 RGB frames as ``application/octet-stream`` with
``X-Frame-Shape: HxWx3``) → Middlebury ``.flo`` bytes; ``GET /healthz``
and ``GET /metrics`` for probes.  ``--port 0`` takes a free port; the
``serving on`` line names it.  SIGTERM stops taking connections, finishes
every request in flight and exits 0.

``--dtype bfloat16`` (the default) serves the bfloat16 fast model;
``float32`` the float32 parity model (TF32 off).

``--data-parallel N`` shards each dispatched batch over N ranks launched by
``python -m torch.distributed.run --nproc-per-node N``: every rank runs its
own HTTP server (rank r on ``--port`` + r, or a free port with ``--port
0``) and dispatch thread, and pads every launch to ``--max-batch`` (which
must divide by N), so the ranks must be sent the same requests in the same
order: their forwards meet in one all-gather.
"""

from __future__ import annotations

import argparse
import sys

from opticalflow_tpu_torch.cli.infer_kitti import (add_data_parallel_args,
                                                   data_parallel_mesh)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PWC-Net flow serving "
                                            "(PyTorch/CUDA)")
    p.add_argument("--ckpt", default="./pwc_net.pth.tar")
    p.add_argument("--variant", choices=("new", "old"), default="new")
    p.add_argument("--preset", default="bgr_unit")
    p.add_argument("--flow-scale", type=float, default=20.0)
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="bfloat16",
                   help="bfloat16 fast path by default for serving")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 takes a free port (printed at start)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--bucket-sizes", default="auto", metavar="auto|none|N,..",
                   help="allowed padded launch sizes; partial batches pad "
                        "to the smallest fitting bucket so a lone request "
                        "rides a B=1 forward instead of shipping max-batch "
                        "frames (default auto = powers of two up to "
                        "max-batch; none = always pad to max-batch)")
    p.add_argument("--warmup", metavar="HxW", default=None,
                   help="run every bucket once at this frame size before "
                        "serving, e.g. 436x1024")
    p.add_argument("--warmup-modes", default="resize,pad",
                   help="comma-separated size modes --warmup runs (default "
                        "resize,pad); an unwarmed mode's first request pays "
                        "cuDNN's first-call set-up on the dispatch thread")
    add_data_parallel_args(p, "each dispatched batch (--max-batch must "
                              "divide by N)")
    return p


def parse_bucket_sizes(spec: str, max_batch: int):
    """The ``--bucket-sizes`` flag → FlowServer's ``bucket_sizes``: "auto",
    None for "none", or a list of ints in [1, max_batch].  Raises
    SystemExit on anything else, an empty list included."""
    if spec in ("auto", "none"):
        return None if spec == "none" else "auto"
    try:
        buckets = [int(v) for v in spec.split(",") if v.strip()]
    except ValueError:
        buckets = None
    if not buckets:
        raise SystemExit(
            f"--bucket-sizes must be 'auto', 'none' or a comma list of "
            f"ints, got {spec!r}")
    for b in buckets:
        if b < 1 or b > max_batch:
            raise SystemExit(f"--bucket-sizes value {b} outside "
                             f"[1, max-batch={max_batch}]")
    return buckets


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # flag-shaped mistakes fail before the checkpoint load
    buckets = parse_bucket_sizes(args.bucket_sizes, args.max_batch)
    mesh = data_parallel_mesh(args, "opticalflow_tpu_torch.cli.serve")

    import signal
    import threading

    import torch
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.serve import FlowServer, make_http_server
    from opticalflow_tpu_torch.train.checkpoints import load_params

    bf16 = args.dtype == "bfloat16"
    model = PWCDCNet(variant=args.variant,
                     dtype=torch.bfloat16 if bf16 else torch.float32,
                     precision="fast" if bf16 else "highest")
    if mesh is not None:
        print(f"data-parallel serving over {mesh.world} ranks (rank "
              f"{mesh.rank}, {mesh.backend}; max "
              f"{-(-args.max_batch // mesh.world)} pairs/rank/batch)",
              flush=True)
    engine = FlowEngine(model, load_params(args.ckpt),
                        flow_scale=args.flow_scale,
                        device=args.device if mesh is None else None,
                        mesh=mesh)
    try:
        server = FlowServer(engine, max_batch=args.max_batch,
                            max_delay_ms=args.max_delay_ms,
                            preset=args.preset, bucket_sizes=buckets)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.warmup:
        h, w = (int(v) for v in args.warmup.split("x"))
        modes = tuple(m.strip() for m in args.warmup_modes.split(",")
                      if m.strip())
        server.warmup(h, w, size_modes=modes)
        print(f"warmed up buckets={server.bucket_sizes} at {h}x{w} "
              f"(modes: {', '.join(modes)})", flush=True)
    port = args.port + mesh.rank if mesh is not None and args.port else \
        args.port
    httpd = make_http_server(server, args.host, port)

    def _shutdown(signum, frame):
        # serve_forever() returns after shutdown(), which must be called
        # from another thread or it deadlocks inside serve_forever
        httpd.draining.set()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _shutdown)
    except ValueError:
        pass   # embedded off the main thread: no signal-driven drain
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port}  (device={engine.device}, "
          f"dtype={args.dtype}, max_batch={args.max_batch}, "
          f"delay={args.max_delay_ms}ms)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # Drain order: server_close() joins the handler threads while the
        # dispatcher still serves, so every accepted request, one whose
        # body was still being read included, gets its flow and its
        # response is written; then the dispatcher drains and stops.  (The
        # other order refuses a request that reaches the queue after the
        # dispatcher stopped.)
        httpd.draining.set()
        httpd.server_close()
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
