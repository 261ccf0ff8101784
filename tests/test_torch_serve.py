"""The port's serving layer (``opticalflow_tpu_torch.serve``,
``cli/serve.py``) on the CPU: each case of ``tests/test_serve.py`` through
the port's ``FlowServer`` (a fake engine for the dispatcher), the HTTP
round trips through a real port ``FlowEngine`` held to the JAX engine on
the same pair and weights, the three ``ADVICE.md`` fixes, and the JSON
route's PNG decode against ``cv2.imdecode(..., IMREAD_COLOR)``."""

import base64
import builtins
import http.client
import json
import os
import signal
import struct
import subprocess
import sys
import threading
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflow_tpu.engine import FlowEngine as JaxFlowEngine
from opticalflow_tpu.models.pwcnet import PWCDCNet as JaxPWCDCNet
from opticalflow_tpu_torch.cli import serve as serve_cli
from opticalflow_tpu_torch.engine import FlowEngine
from opticalflow_tpu_torch.io.flo import TAG_FLOAT
from opticalflow_tpu_torch.io.images import encode_png
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.models.torch_import import state_dict_from_jax
from opticalflow_tpu_torch.serve import (FlowServer, decode_image,
                                         make_http_server)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeEngine:
    """Counts launches; 'flow' = mean of the pair, broadcast to (H, W, 2)."""

    def __init__(self):
        self.calls = []  # batch sizes as launched (padded)

    def flow_from_pairs(self, im1s, im2s, *, preset, size_mode):
        self.calls.append(len(im1s))
        out = []
        for a, b in zip(im1s, im2s):
            h, w = a.shape[:2]
            val = (a.astype(np.float32).mean()
                   + b.astype(np.float32).mean())
            out.append(np.full((h, w, 2), val, np.float32))
        time.sleep(0.01)  # make batching windows observable
        return np.stack(out)


def _img(seed, h=8, w=12):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8)


def _serve(srv):
    httpd = make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def _stop(httpd, srv):
    httpd.shutdown()
    srv.close()
    httpd.server_close()


def _post(conn, body, headers):
    conn.request("POST", "/v1/flow", body, headers)
    resp = conn.getresponse()
    return resp.status, resp.read()


def _flo(data):
    tag, w, h = struct.unpack("<fii", data[:12])
    assert abs(tag - TAG_FLOAT) < 1e-3
    return np.frombuffer(data[12:], "<f4").reshape(h, w, 2)


# ------------------------------------------------------------- dispatcher

def test_concurrent_requests_share_a_batch():
    eng = _FakeEngine()
    srv = FlowServer(eng, max_batch=4, max_delay_ms=200)
    try:
        results = {}

        def call(i):
            results[i] = srv.flow(_img(i), _img(100 + i), timeout=10)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert len(results) == 4
        for i in range(4):
            exp = (_img(i).astype(np.float32).mean()
                   + _img(100 + i).astype(np.float32).mean())
            np.testing.assert_allclose(results[i][0, 0, 0], exp, rtol=1e-6)
        # few launches, each padded to an allowed bucket (1, 2, 4)
        assert sum(eng.calls) <= 4 * 4
        assert all(c in (1, 2, 4) for c in eng.calls)
        snap = srv.metrics.snapshot()
        assert snap["requests"] == 4
        assert snap["mean_batch_occupancy"] >= 1.0
    finally:
        srv.close()


def test_mixed_shapes_bucketed_not_mixed():
    eng = _FakeEngine()
    srv = FlowServer(eng, max_batch=4, max_delay_ms=30)
    try:
        outs = {}

        def call(i, h):
            outs[i] = srv.flow(_img(i, h=h), _img(50 + i, h=h), timeout=10)

        threads = [threading.Thread(target=call, args=(i, 8 + 8 * (i % 2)))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert {outs[i].shape for i in range(6)} == {(8, 12, 2), (16, 12, 2)}
    finally:
        srv.close()


def test_bucketed_dispatch_pads_to_smallest_bucket():
    """A lone request rides the B=1 forward, not max_batch frames."""
    eng = _FakeEngine()
    srv = FlowServer(eng, max_batch=8, max_delay_ms=1)
    try:
        assert srv.bucket_sizes == [1, 2, 4, 8]
        srv.flow(_img(0), _img(1), timeout=10)
        assert eng.calls == [1]
        outs = {}

        def call(i):
            outs[i] = srv.flow(_img(i), _img(40 + i), timeout=10)

        srv.max_delay = 0.2              # let them share a batch
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert len(outs) == 3
        assert all(c in (1, 2, 4, 8) for c in eng.calls[1:])
    finally:
        srv.close()


def test_bucket_sizes_resolution_and_validation():
    eng = _FakeEngine()
    srv = FlowServer(eng, max_batch=8, max_delay_ms=1, bucket_sizes=None)
    try:
        assert srv.bucket_sizes == [8]
        srv.flow(_img(0), _img(1), timeout=10)
        assert eng.calls == [8]
    finally:
        srv.close()
    srv = FlowServer(eng, max_batch=6, max_delay_ms=1, bucket_sizes=[2, 1])
    try:
        assert srv.bucket_sizes == [1, 2, 6]
    finally:
        srv.close()
    for bad in ([0], [9], "banana", [3, -1]):
        with pytest.raises(ValueError):
            FlowServer(eng, max_batch=8, bucket_sizes=bad)
    with pytest.raises(ValueError):
        FlowServer(eng, max_batch=0)


@pytest.mark.parametrize("max_batch,ladder", [
    (1, [1]), (3, [1, 2, 3]), (8, [1, 2, 4, 8]),
    (5000, [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 5000])])
def test_auto_ladder_reaches_max_batch(max_batch, ladder):
    """ADVICE: the "auto" ladder is every power of two below max_batch, not
    only those of range(11) (which stopped at 1024)."""
    srv = FlowServer(_FakeEngine(), max_batch=max_batch, max_delay_ms=1)
    try:
        assert srv.bucket_sizes == ladder
    finally:
        srv.close()


@pytest.mark.parametrize("spec", [5, True, 2.0, object()])
def test_bucket_spec_that_is_no_sequence_is_refused(spec):
    """ADVICE: a spec that is not a sequence raises a ValueError that says
    what is accepted (JAX's iterates it and raises a bare TypeError)."""
    with pytest.raises(ValueError, match="'auto', None or a sequence"):
        FlowServer(_FakeEngine(), max_batch=8, bucket_sizes=spec)
    with pytest.raises(ValueError, match="sequence of ints"):
        FlowServer(_FakeEngine(), max_batch=8, bucket_sizes=[True, 2])


@pytest.mark.parametrize("flag", ["", ",", " , ", "x", "1,9"])
def test_cli_refuses_bad_bucket_flags_before_loading(flag, tmp_path):
    """ADVICE: an empty --bucket-sizes ('' or ',') is refused, not passed
    through as []; every refusal comes before the checkpoint load (the
    checkpoint here does not exist)."""
    with pytest.raises(SystemExit, match="bucket-sizes"):
        serve_cli.main(["--ckpt", str(tmp_path / "none.pth.tar"),
                        "--bucket-sizes", flag, "--device", "cpu"])
    assert serve_cli.parse_bucket_sizes("4,1,2", 8) == [4, 1, 2]
    assert serve_cli.parse_bucket_sizes("none", 8) is None
    assert serve_cli.parse_bucket_sizes("auto", 8) == "auto"


def test_cli_refuses_data_parallel(tmp_path):
    with pytest.raises(SystemExit, match="Queue 1 item 6"):
        serve_cli.main(["--ckpt", str(tmp_path / "none.pth.tar"),
                        "--data-parallel", "2", "--device", "cpu"])


def test_server_warmup_runs_every_bucket():
    """warmup() runs each bucket once, so no first request pays the kernel
    build or cuDNN's first call at a new shape on the dispatch thread."""

    class _Warm(_FakeEngine):
        def __init__(self):
            super().__init__()
            self.warmed = []

        def warmup(self, height, width, *, batch, preset, size_modes):
            self.warmed.append((height, width, batch, tuple(size_modes)))

    eng = _Warm()
    srv = FlowServer(eng, max_batch=8, max_delay_ms=1, preset="bgr_unit")
    try:
        srv.warmup(48, 64, size_modes=("resize",))
        assert eng.warmed == [(48, 64, b, ("resize",)) for b in (1, 2, 4, 8)]
    finally:
        srv.close()


def test_error_propagates_and_server_survives():
    class _Boom(_FakeEngine):
        def flow_from_pairs(self, im1s, im2s, **kw):
            if len(self.calls) == 0:
                self.calls.append(0)
                raise RuntimeError("boom")
            return super().flow_from_pairs(im1s, im2s, **kw)

    srv = FlowServer(_Boom(), max_batch=2, max_delay_ms=1)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            srv.flow(_img(0), _img(1), timeout=10)
        assert srv.flow(_img(2), _img(3), timeout=10).shape == (8, 12, 2)
        assert srv.metrics.snapshot()["errors"] == 1
    finally:
        srv.close()


def test_close_drains_queued_requests():
    """close() lets already-queued requests finish (the SIGTERM drain)."""
    gate = threading.Event()   # holds the first batch on "the card"

    class _GatedEngine:
        def flow_from_pairs(self, im1s, im2s, preset="bgr_unit",
                            size_mode="resize"):
            gate.wait(10)
            h, w = im1s[0].shape[:2]
            return np.zeros((len(im1s), h, w, 2), np.float32)

    srv = FlowServer(_GatedEngine(), max_batch=1, max_delay_ms=1)
    im = np.zeros((8, 8, 3), np.uint8)
    results = {}

    def _req(i):
        results[i] = srv.flow(im, im, timeout=10)

    threads = [threading.Thread(target=_req, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 5
    while len(srv._queue) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(srv._queue) >= 2
    drained = []
    closer = threading.Thread(
        target=lambda: drained.append(srv.close(timeout=10)))
    closer.start()
    time.sleep(0.05)
    gate.set()
    closer.join(timeout=10)
    assert drained == [True]
    for t in threads:
        t.join(timeout=10)
    assert sorted(results) == [0, 1, 2]
    with pytest.raises(RuntimeError, match="shut down"):
        srv.flow(im, im, timeout=1)


def test_abandoned_request_not_dispatched():
    gate = threading.Event()

    class _Slow(_FakeEngine):
        def flow_from_pairs(self, im1s, im2s, **kw):
            out = super().flow_from_pairs(im1s, im2s, **kw)
            gate.wait(10)  # hold the dispatcher on the first launch
            return out

    eng = _Slow()
    srv = FlowServer(eng, max_batch=1, max_delay_ms=1)
    try:
        t1 = threading.Thread(
            target=lambda: srv.flow(_img(0), _img(1), timeout=10))
        t1.start()
        time.sleep(0.2)  # the dispatcher is now inside launch 1
        with pytest.raises(TimeoutError):
            srv.flow(_img(2), _img(3), timeout=0.05)  # abandoned in queue
        gate.set()
        t1.join(timeout=10)
        assert srv.flow(_img(4), _img(5), timeout=10).shape == (8, 12, 2)
        assert len(eng.calls) == 2    # not the abandoned request
    finally:
        gate.set()
        srv.close()


def test_metrics_snapshot_during_traffic():
    srv = FlowServer(_FakeEngine(), max_batch=2, max_delay_ms=1)
    errs = []

    def snap_loop():
        try:
            for _ in range(300):
                srv.metrics.snapshot()
        except Exception as e:  # pragma: no cover - the bug
            errs.append(e)

    try:
        t = threading.Thread(target=snap_loop)
        t.start()
        for i in range(40):
            srv.flow(_img(i), _img(i + 1), timeout=10)
        t.join(timeout=30)
        assert not errs
        assert srv.metrics.snapshot()["requests"] == 40
    finally:
        srv.close()


# ------------------------------------------------------------ JSON decode

def _png_cases():
    rng = np.random.RandomState(3)
    rgb = rng.randint(0, 256, (10, 14, 3)).astype(np.uint8)
    return {
        "rgb8": encode_png(rgb),
        "rgba8": encode_png(rng.randint(0, 256, (10, 14, 4)).astype(np.uint8)),
        "grey8": encode_png(rng.randint(0, 256, (10, 14)).astype(np.uint8)),
        "rgb16": encode_png(rng.randint(0, 65536, (10, 14, 3))
                            .astype(np.uint16)),
        "grey16": encode_png(rng.randint(0, 65536, (10, 14))
                             .astype(np.uint16)),
        # OpenCV's own encoder: other row filters and zlib settings
        "cv2_rgb8": cv2.imencode(".png", rgb[:, :, ::-1])[1].tobytes(),
    }


@pytest.mark.parametrize("case", sorted(_png_cases()))
def test_json_decode_matches_cv2_imdecode(case):
    """The JSON route's decode equals ``cv2.imdecode(buf, IMREAD_COLOR)``
    (BGR → RGB) for 8-bit RGB, RGBA and grey and 16-bit PNGs: alpha
    dropped, grey replicated, 16-bit samples cut to their high byte."""
    data = _png_cases()[case]
    want = cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[:, :, ::-1]
    got = decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_json_body_that_is_no_png_needs_pil(monkeypatch):
    """A JPEG goes to PIL where it is installed; without PIL the request is
    a ValueError (HTTP 400) that names the missing decoder."""
    rgb = np.random.RandomState(4).randint(0, 256, (16, 16, 3)).astype(
        np.uint8)
    jpg = cv2.imencode(".jpg", rgb[:, :, ::-1])[1].tobytes()
    assert decode_image(jpg).shape == (16, 16, 3)
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ValueError, match="no JPEG decoder"):
        decode_image(jpg, "im1")
    with pytest.raises(ValueError, match="could not decode im2"):
        decode_image(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40, "im2")


# ----------------------------------------------------------- HTTP, fake

def test_http_raw_tensor_endpoint():
    """The octet-stream route returns the engine's flow; malformed headers
    or bodies are 400, not 500."""
    srv = FlowServer(_FakeEngine(), max_batch=2, max_delay_ms=1)
    httpd, port = _serve(srv)
    try:
        im1, im2 = _img(0, h=10, w=14), _img(1, h=10, w=14)
        body = im1.tobytes() + im2.tobytes()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        status, data = _post(conn, body, {
            "Content-Type": "application/octet-stream",
            "X-Frame-Shape": "10x14x3", "X-Timeout": "30"})
        assert status == 200, data
        flow = _flo(data)
        assert flow.shape == (10, 14, 2)
        exp = im1.astype(np.float32).mean() + im2.astype(np.float32).mean()
        np.testing.assert_allclose(flow[0, 0, 0], exp, rtol=1e-6)
        raw = {"Content-Type": "application/octet-stream"}
        assert _post(conn, body, {**raw, "X-Frame-Shape": "banana"})[0] == 400
        assert _post(conn, body[:-7],
                     {**raw, "X-Frame-Shape": "10x14x3"})[0] == 400
        # media types are case-insensitive (RFC 7231)
        assert _post(conn, body, {
            "Content-Type": "Application/Octet-Stream; charset=binary",
            "X-Frame-Shape": "10x14x3"})[0] == 200
        for hdrs in ({"X-Timeout": "inf"}, {"X-Timeout": "-3"},
                     {"X-Size-Mode": "stretch"}):
            status, data = _post(conn, body, {**raw, "X-Frame-Shape":
                                              "10x14x3", **hdrs})
            assert status == 400, (hdrs, data)
        # pad_ref on a frame the reference's unpad order would empty
        status, data = _post(conn, body, {**raw, "X-Frame-Shape": "10x14x3",
                                          "X-Size-Mode": "pad_ref"})
        assert status == 400 and b"pad_ref" in data
        # a JSON body that is not an image, and an unknown route
        status, data = _post(conn, json.dumps(
            {"im1": base64.b64encode(b"nope").decode(),
             "im2": base64.b64encode(b"nope").decode()}).encode(),
            {"Content-Type": "application/json"})
        assert status == 400, data
        conn.request("POST", "/v2/flow", body, raw)
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
        # chunked bodies are refused, and the connection is dropped
        conn2 = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn2.putrequest("POST", "/v1/flow")
        conn2.putheader("Transfer-Encoding", "chunked")
        conn2.putheader("Content-Type", "application/octet-stream")
        conn2.endheaders()
        conn2.send(b"0\r\n\r\n")
        resp = conn2.getresponse()
        assert resp.status == 400 and b"Content-Length" in resp.read()
        conn2.close()
    finally:
        _stop(httpd, srv)


def test_http_timeout_is_503():
    gate = threading.Event()

    class _Stuck(_FakeEngine):
        def flow_from_pairs(self, im1s, im2s, **kw):
            gate.wait(10)
            return super().flow_from_pairs(im1s, im2s, **kw)

    srv = FlowServer(_Stuck(), max_batch=1, max_delay_ms=1)
    httpd, port = _serve(srv)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        status, data = _post(conn, _img(0).tobytes() + _img(1).tobytes(), {
            "Content-Type": "application/octet-stream",
            "X-Frame-Shape": "8x12x3", "X-Timeout": "0.1"})
        assert status == 503 and b"timed out" in data
    finally:
        gate.set()
        _stop(httpd, srv)


# ----------------------------------------------------------- HTTP, real

@pytest.fixture(scope="module")
def real():
    """The JAX model's initial weights (as ``tests/test_serve.py`` makes
    them), carried to the port; a 48x60 pair and the JAX engine's flow."""
    model = JaxPWCDCNet(variant="new", precision="highest",
                        use_pallas_corr=False)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6), jnp.float32))["params"]
    im1, im2 = _img(0, h=48, w=60), _img(7, h=48, w=60)
    jax_engine = JaxFlowEngine(model, params, flow_scale=20.0)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params))
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=20.0, device="cpu")
    return {"sd": sd, "engine": engine, "pair": (im1, im2),
            "jax": jax_engine.flow_from_pair(im1, im2),
            # the raw round trip's batch of two
            "jax_pad": jax_engine.flow_from_pairs(
                [im1, im1], [im2, im2], size_mode="pad")[0]}


def _assert_like_jax(flow, jax_flow):
    # JAX's test holds its HTTP path to its own engine at 1e-5 absolute;
    # here that 1e-5 is relative to the flow's largest component (10.7 px),
    # since the two frameworks sum the float32 convolutions in other
    # orders: they differ by 1.4e-5 (resize, B=1) and 4.4e-5 (pad, B=2)
    # at most on this pair (measured).  The serving layer itself adds no
    # numerics: its responses equal the port engine's bit for bit.
    scale = max(1.0, float(np.abs(jax_flow).max()))
    np.testing.assert_allclose(flow, jax_flow, atol=1e-5 * scale, rtol=0)


def test_http_round_trip_with_real_engine(real):
    """HTTP POST (base64 PNGs) → dispatcher → the port's engine → .flo; the
    flow equals the port engine's own and agrees with the JAX engine's;
    /healthz and /metrics served alongside."""
    engine = real["engine"]
    im1, im2 = real["pair"]
    srv = FlowServer(engine, max_batch=2, max_delay_ms=5)
    httpd, port = _serve(srv)
    try:
        body = json.dumps({
            "im1": base64.b64encode(encode_png(im1)).decode(),
            "im2": base64.b64encode(cv2.imencode(
                ".png", im2[:, :, ::-1])[1].tobytes()).decode(),
            "timeout": 600}).encode()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        status, data = _post(conn, body, {"Content-Type": "application/json"})
        assert status == 200, data
        flow = _flo(data)
        assert flow.shape == (48, 60, 2) and np.isfinite(flow).all()
        np.testing.assert_array_equal(flow, engine.flow_from_pair(im1, im2))
        _assert_like_jax(flow, real["jax"])
        conn.request("GET", "/healthz")
        assert conn.getresponse().read() == b'{"ok": true}'
        conn.request("GET", "/metrics")
        m = json.loads(conn.getresponse().read())
        assert m["requests"] == 1 and m["errors"] == 0 and m["batches"] == 1
        assert set(m) == {"requests", "batches", "errors",
                          "mean_batch_occupancy", "latency_s"}
        assert set(m["latency_s"]) == {"p50", "p90", "p99"}
    finally:
        _stop(httpd, srv)


def test_http_raw_round_trip_with_real_engine(real):
    """The octet-stream route, in pad mode, on the real engine: the same
    flow as the port engine's, close to the JAX engine's; two concurrent
    requests share a batch of 2."""
    engine = real["engine"]
    im1, im2 = real["pair"]
    # a long window: the batch launches as soon as both have arrived
    srv = FlowServer(engine, max_batch=2, max_delay_ms=5000)
    httpd, port = _serve(srv)
    try:
        out = {}

        def call(i):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            out[i] = _post(conn, im1.tobytes() + im2.tobytes(), {
                "Content-Type": "application/octet-stream",
                "X-Frame-Shape": "48x60x3", "X-Size-Mode": "pad",
                "X-Timeout": "600"})

        threads = [threading.Thread(target=call, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        direct = engine.flow_from_pairs([im1, im1], [im2, im2],
                                        size_mode="pad")[0]
        for i in (0, 1):
            status, data = out[i]
            assert status == 200, data
            np.testing.assert_array_equal(_flo(data), direct)
            _assert_like_jax(_flo(data), real["jax_pad"])
        snap = srv.metrics.snapshot()
        assert snap["requests"] == 2 and snap["batches"] == 1
        assert snap["mean_batch_occupancy"] == 2.0
    finally:
        _stop(httpd, srv)


def test_serve_cli_serves_and_drains_on_sigterm(real, tmp_path):
    """``python -m opticalflow_tpu_torch.cli.serve --device cpu --port 0``:
    the raw route answers, and a SIGTERM while a request is in flight
    lets it finish with a 200 before the process exits 0."""
    ckpt = str(tmp_path / "w.pth.tar")
    torch.save({"state_dict": real["sd"]}, ckpt)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "opticalflow_tpu_torch.cli.serve",
         "--ckpt", ckpt, "--port", "0", "--device", "cpu", "--dtype",
         "float32", "--max-batch", "2", "--max-delay-ms", "3000"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = ""
        while "serving on" not in line:
            line = proc.stdout.readline()
            assert line, "the server exited before serving"
        port = int(line.split("serving on http://")[1].split()[0]
                   .rsplit(":", 1)[1])
        im1, im2 = real["pair"]
        got = {}

        def call():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            got["r"] = _post(conn, im1.tobytes() + im2.tobytes(), {
                "Content-Type": "application/octet-stream",
                "X-Frame-Shape": "48x60x3", "X-Timeout": "600"})

        t = threading.Thread(target=call)
        t.start()
        time.sleep(1.0)          # queued, inside the dispatcher's 3 s window
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=300)
        assert proc.wait(timeout=120) == 0
        status, data = got["r"]
        assert status == 200, data
        np.testing.assert_array_equal(
            _flo(data), real["engine"].flow_from_pair(im1, im2))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
