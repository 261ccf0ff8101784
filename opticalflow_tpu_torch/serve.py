"""Batched optical-flow serving with dynamic request batching, on the GPU.

Counterpart of ``opticalflow_tpu.serve``: throughput comes from batch
occupancy, so concurrent requests ride one forward.

  * :class:`FlowServer` owns a :class:`~opticalflow_tpu_torch.engine.FlowEngine`
    and one dispatch thread.  Incoming pairs queue up; the dispatcher
    drains up to ``max_batch`` requests (waiting at most ``max_delay_ms``
    from the oldest one), groups them by (frame shape, size mode), pads
    each group to the smallest allowed bucket size (powers of two up to
    ``max_batch`` by default, so a lone request rides a B=1 forward), and
    fans the results back out to the waiting callers.
  * :func:`make_http_server` is a stdlib ``ThreadingHTTPServer`` front:
    ``POST /v1/flow`` with a JSON body ``{"im1": <b64 PNG>, "im2": <b64>,
    "size_mode": "resize"}`` returns the flow as a Middlebury ``.flo``
    body; ``GET /healthz`` and ``GET /metrics`` for probes.  For hot paths,
    POST ``Content-Type: application/octet-stream`` to the same route with
    the two raw uint8 RGB frames back to back and ``X-Frame-Shape: HxWx3``
    (plus optional ``X-Size-Mode`` / ``X-Timeout`` headers): no base64, no
    PNG decode.

The JSON route decodes PNGs with the port's own decoder
(``io/images.decode_png``) by ``cv2.imread(..., IMREAD_COLOR)``'s rules:
alpha dropped, grey replicated, 16-bit samples cut to their high byte.
Other formats (JPEG) go to PIL where it is installed, and are answered 400
where it is not.

Every bucket is a shape the engine has to set up once (the kernel build at
the first call, cuDNN's first-call set-up per shape): :meth:`FlowServer.warmup`
pays that before traffic arrives.  Data-parallel serving over several
cards is ROADMAP Queue 1 item 6.

Run:  ``python -m opticalflow_tpu_torch.cli.serve --ckpt pwc_net.pth.tar``.
"""

from __future__ import annotations

import base64
import collections
import collections.abc
import io
import json
import math
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from opticalflow_tpu_torch.io.flo import write_flo_bytes
from opticalflow_tpu_torch.io.images import decode_png

__all__ = ["FlowServer", "ServerMetrics", "make_http_server",
           "decode_image"]


@dataclass
class _Pending:
    im1: np.ndarray
    im2: np.ndarray
    size_mode: str
    done: threading.Event = field(default_factory=threading.Event)
    flow: Optional[np.ndarray] = None
    error: Optional[Exception] = None
    abandoned: bool = False      # caller timed out; skip at dispatch
    t_enqueue: float = field(default_factory=time.perf_counter)


@dataclass
class ServerMetrics:
    """Rolling serving metrics; all access goes through the lock (mutations
    race with /metrics snapshots on handler threads)."""
    requests: int = 0
    batches: int = 0
    occupancy_sum: int = 0
    errors: int = 0
    latencies: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=1024))
    lock: threading.Lock = field(default_factory=threading.Lock)

    def snapshot(self) -> dict:
        with self.lock:
            lats = sorted(self.latencies)
            requests, batches = self.requests, self.batches
            errors, occ = self.errors, self.occupancy_sum
        pct = (lambda q: lats[min(len(lats) - 1, int(q * len(lats)))]
               if lats else 0.0)
        return {
            "requests": requests,
            "batches": batches,
            "errors": errors,
            "mean_batch_occupancy": occ / batches if batches else 0.0,
            "latency_s": {"p50": pct(0.50), "p90": pct(0.90),
                          "p99": pct(0.99)},
        }


class FlowServer:
    """Dynamic-batching dispatcher over a FlowEngine.

    Args:
      engine: a ready :class:`~opticalflow_tpu_torch.engine.FlowEngine` (or
        anything with its ``flow_from_pairs`` and ``warmup``).
      max_batch: the most requests one forward takes; the dispatcher never
        drains more.
      max_delay_ms: how long the dispatcher waits, from the oldest queued
        request, for the batch to fill before launching anyway.
      preset: preprocessing preset forwarded to the engine.
      bucket_sizes: allowed padded launch sizes.  Each drained batch is
        padded up to the SMALLEST allowed bucket that fits, so a lone
        request rides a B=1 forward instead of ``max_batch`` frames.
        ``"auto"`` (default) = the powers of two below ``max_batch``, then
        ``max_batch``; ``None`` = always pad to ``max_batch``; an explicit
        sequence of ints in [1, max_batch] is sorted and gets ``max_batch``
        appended.  Anything else raises ``ValueError``.
    """

    def __init__(self, engine, *, max_batch: int = 8,
                 max_delay_ms: float = 5.0, preset: str = "bgr_unit",
                 bucket_sizes="auto"):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self.preset = preset
        self.bucket_sizes = self._resolve_buckets(bucket_sizes)
        self.metrics = ServerMetrics()
        self._queue: collections.deque[_Pending] = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="flow-dispatch", daemon=True)
        self._thread.start()

    def _resolve_buckets(self, spec) -> List[int]:
        """Validated ascending launch sizes, always ending in max_batch."""
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if spec is None:
            return [self.max_batch]
        if isinstance(spec, str):
            if spec != "auto":
                raise ValueError(
                    f"bucket_sizes must be 'auto', None or a sequence of "
                    f"ints, got {spec!r}")
            sizes, b = [], 1
            while b < self.max_batch:
                sizes.append(b)
                b *= 2
            return sizes + [self.max_batch]
        if not isinstance(spec, collections.abc.Iterable):
            raise ValueError(
                f"bucket_sizes must be 'auto', None or a sequence of ints, "
                f"got {spec!r}")
        spec = list(spec)
        if any(isinstance(b, (bool, np.bool_)) for b in spec):
            raise ValueError(
                f"bucket_sizes must be a sequence of ints, got {spec!r}")
        sizes = sorted({int(b) for b in spec})
        for b in sizes:
            if b < 1 or b > self.max_batch:
                raise ValueError(
                    f"bucket size {b} outside [1, max_batch={self.max_batch}]")
        if not sizes or sizes[-1] != self.max_batch:
            sizes.append(self.max_batch)
        return sizes

    def warmup(self, height: int, width: int,
               size_modes=("resize", "pad"), **kw) -> None:
        """Run the engine once per (size mode, bucket) at this frame size, so
        no request pays the kernel build or cuDNN's first call at a new
        shape on the dispatch thread.  Extra kwargs forward to
        :meth:`FlowEngine.warmup` (e.g. ``image_size=``)."""
        for b in self.bucket_sizes:
            self.engine.warmup(height, width, batch=b, preset=self.preset,
                               size_modes=size_modes, **kw)

    # ------------------------------------------------------------- client

    def flow(self, im1: np.ndarray, im2: np.ndarray,
             size_mode: str = "resize",
             timeout: Optional[float] = None) -> np.ndarray:
        """Blocking request: uint8 RGB pair → (H, W, 2) float32 flow.

        Thread-safe; concurrent callers share forwards."""
        if im1.shape != im2.shape:
            raise ValueError(f"frame shapes differ: {im1.shape} vs {im2.shape}")
        p = _Pending(im1, im2, size_mode)
        with self._cv:
            if self._stop:
                raise RuntimeError("server is shut down")
            self._queue.append(p)
            self._cv.notify_all()
        if not p.done.wait(timeout):
            # mark abandoned so the dispatcher drops it instead of spending
            # a padded batch on a result nobody will read
            with self._cv:
                p.abandoned = True
            raise TimeoutError("flow request timed out")
        if p.error is not None:
            raise p.error
        with self.metrics.lock:
            self.metrics.requests += 1
            self.metrics.latencies.append(
                time.perf_counter() - p.t_enqueue)
        return p.flow

    def close(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting requests and drain the queue.

        The dispatcher finishes every already-queued request (callers are
        still parked on their events) before exiting.  Returns True if it
        exited within ``timeout`` (None: wait for the whole drain)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    # --------------------------------------------------------- dispatcher

    def _take_batch(self) -> List[_Pending]:
        """Wait for work, then drain one shape-consistent batch."""
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait()
            if self._stop and not self._queue:
                return []
            # The wait budget belongs to the oldest queued request, which may
            # have been enqueued while the previous batch was on the card:
            # counting from now would surcharge every batch under load.
            deadline = self._queue[0].t_enqueue + self.max_delay
            while len(self._queue) < self.max_batch and not self._stop:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                self._cv.wait(timeout=left)
            # drop requests whose callers already timed out
            while self._queue and self._queue[0].abandoned:
                self._queue.popleft()
            if not self._queue:
                return []
            # one (shape, size_mode) group per launch, FIFO within it
            key = (self._queue[0].im1.shape, self._queue[0].size_mode)
            batch, keep = [], collections.deque()
            while self._queue and len(batch) < self.max_batch:
                p = self._queue.popleft()
                if p.abandoned:
                    continue
                if (p.im1.shape, p.size_mode) == key:
                    batch.append(p)
                else:
                    keep.append(p)
            self._queue.extendleft(reversed(keep))
            return batch

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                with self._cv:
                    if self._stop and not self._queue:
                        return
                continue  # everything drained was abandoned; keep serving
            try:
                im1s = [p.im1 for p in batch]
                im2s = [p.im2 for p in batch]
                # pad to the smallest allowed bucket: a partial batch
                # uploads bucket-sized frames, not max_batch-sized ones
                bucket = next(b for b in self.bucket_sizes
                              if b >= len(batch))
                pad = bucket - len(batch)
                im1s += [im1s[-1]] * pad
                im2s += [im2s[-1]] * pad
                flows = self.engine.flow_from_pairs(
                    im1s, im2s, preset=self.preset,
                    size_mode=batch[0].size_mode)
                for p, f in zip(batch, flows):
                    p.flow = np.asarray(f)
                    p.done.set()
                with self.metrics.lock:
                    self.metrics.batches += 1
                    self.metrics.occupancy_sum += len(batch)
            except Exception as e:  # propagate to all waiters, keep serving
                for p in batch:
                    p.error = e
                    p.done.set()
                with self.metrics.lock:
                    self.metrics.errors += len(batch)


# ------------------------------------------------------------------ HTTP

def decode_image(data: bytes, what: str = "image") -> np.ndarray:
    """Encoded image bytes → (H, W, 3) uint8 RGB, as ``cv2.imdecode(buf,
    IMREAD_COLOR)[..., ::-1]`` gives it for a PNG: alpha dropped, grey
    replicated, a 16-bit sample cut to its high byte.  A PNG flavour the
    port's decoder does not read, or another format, goes to PIL where it
    is installed; otherwise ``ValueError`` names the missing decoder."""
    try:
        img = decode_png(data)
    except (ValueError, zlib.error, struct.error) as e:
        raise ValueError(f"could not decode {what}: {e}") from None
    if img is None:
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(
                f"{what} is not a PNG this server decodes (8- or 16-bit grey, "
                "RGB or RGBA), and PIL is not installed to decode other "
                "formats (no JPEG decoder here): send PNGs, or the raw "
                "application/octet-stream body") from None
        try:
            img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception as e:      # PIL raises many types on bad bytes
            raise ValueError(f"could not decode {what}: {e}") from None
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def make_http_server(server: FlowServer, host: str = "127.0.0.1",
                     port: int = 8080) -> ThreadingHTTPServer:
    """Wrap a FlowServer in a stdlib threading HTTP server (call
    ``serve_forever()`` on the result; one OS thread per connection, all
    funnelling into the shared dispatcher).  Its ``draining`` event, once
    set, makes every response close its connection: a shutdown sets it,
    so that ``server_close()`` need not wait out idle keep-alive
    connections."""

    class Handler(BaseHTTPRequestHandler):
        # a socket timeout, so a silent client cannot pin a handler thread
        # forever (server_close joins them on a clean shutdown)
        timeout = 30

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if self.server.draining.is_set():
                # shutting down: end keep-alive connections after this
                # response, so the handler threads can be joined
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b'{"ok": true}')
            elif self.path == "/metrics":
                self._send(200, json.dumps(
                    server.metrics.snapshot()).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        @staticmethod
        def _check_opts(size_mode, timeout):
            """Validate request options at parse time, so a client's
            mistake is a 400 and not a retryable 5xx from the engine."""
            if size_mode not in ("resize", "pad", "pad_ref"):
                raise ValueError(
                    "size_mode must be 'resize', 'pad' or 'pad_ref', "
                    f"got {size_mode!r}")
            t = float(timeout)
            if not math.isfinite(t) or t <= 0:   # inf makes Event.wait raise
                raise ValueError(f"timeout must be finite and > 0, got {t}")
            return size_mode, t

        def _parse_json(self, body: bytes):
            """b64-PNG JSON body → (im1, im2, size_mode, timeout)."""
            req = json.loads(body)
            ims = [decode_image(base64.b64decode(req[k]), k)
                   for k in ("im1", "im2")]
            size_mode, timeout = self._check_opts(
                req.get("size_mode", "resize"), req.get("timeout", 60.0))
            return ims[0], ims[1], size_mode, timeout

        def _parse_raw(self, body: bytes):
            """octet-stream body (two raw uint8 RGB frames back to back,
            shape in X-Frame-Shape) → (im1, im2, size_mode, timeout)."""
            hdr = self.headers.get("X-Frame-Shape", "")
            try:
                shape = tuple(int(v) for v in hdr.lower().split("x"))
            except ValueError:
                shape = ()
            if len(shape) != 3 or shape[2] != 3 or min(shape) <= 0:
                raise ValueError(
                    f"X-Frame-Shape must be 'HxWx3', got {hdr!r}")
            need = 2 * shape[0] * shape[1] * shape[2]
            if len(body) != need:
                raise ValueError(
                    f"body must be exactly {need} bytes for two "
                    f"{shape} uint8 frames, got {len(body)}")
            buf = np.frombuffer(body, np.uint8)
            im1 = buf[: need // 2].reshape(shape)
            im2 = buf[need // 2:].reshape(shape)
            size_mode, timeout = self._check_opts(
                self.headers.get("X-Size-Mode", "resize"),
                self.headers.get("X-Timeout", "60"))
            return im1, im2, size_mode, timeout

        def do_POST(self):
            if self.path != "/v1/flow":
                self._send(404, b'{"error": "not found"}')
                return
            try:  # client-side faults -> 400
                # read the whole body first: an error response that leaves
                # unread body bytes on the socket corrupts the next request
                # on a keep-alive connection.  Where the length is unknown
                # or untrusted (chunked, a bad Content-Length), close the
                # connection after the response instead.
                n_hdr = self.headers.get("Content-Length")
                te = (self.headers.get("Transfer-Encoding") or "").lower()
                if n_hdr is None or "chunked" in te:
                    self.close_connection = True
                    raise ValueError("Content-Length required "
                                     "(chunked bodies unsupported)")
                try:
                    n = int(n_hdr)
                except ValueError:
                    self.close_connection = True
                    raise ValueError(f"bad Content-Length: {n_hdr!r}")
                body = self.rfile.read(n)
                ctype = self.headers.get(
                    "Content-Type",
                    "application/json").split(";")[0].strip().lower()
                if ctype == "application/octet-stream":
                    im1, im2, size_mode, timeout = self._parse_raw(body)
                else:
                    im1, im2, size_mode, timeout = self._parse_json(body)
                if im1.shape != im2.shape:
                    raise ValueError(
                        f"frame shapes differ: {im1.shape} vs {im2.shape}")
                if size_mode == "pad_ref":
                    # the engine raises for frames where the reference's
                    # unpad-quarter-by-full-pad order empties the flow;
                    # that is the client's mistake: 400 here, not a
                    # retryable 500 out of the dispatch thread
                    h, w = im1.shape[:2]
                    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
                    if (hp - h) >= hp // 4 or (wp - w) >= wp // 4:
                        raise ValueError(
                            "size_mode='pad_ref' produces an empty flow "
                            f"for {h}x{w} frames (unpad-quarter-by-full-"
                            "pad, see MIGRATION.md); use size_mode='pad'")
            except Exception as e:
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            try:  # server-side faults -> 5xx (retryable)
                flow = server.flow(im1, im2, size_mode=size_mode,
                                   timeout=timeout)
                self._send(200, write_flo_bytes(flow),
                           ctype="application/octet-stream")
            except TimeoutError as e:   # overloaded: the queue's backlog
                self._send(503, json.dumps({"error": str(e)}).encode())
            except Exception as e:
                self._send(500, json.dumps({"error": str(e)}).encode())

    class _Server(ThreadingHTTPServer):
        # non-daemon handler threads, joined on server_close(): a SIGTERM
        # drain lets in-flight responses finish writing instead of killing
        # the threads mid-response when the process exits
        daemon_threads = False
        block_on_close = True

    httpd = _Server((host, port), Handler)
    # set when shutting down: responses then close their connections
    httpd.draining = threading.Event()
    return httpd
