"""The port's serving daemon vs the JAX package's, on the CPU.

Every test of ``tests/test_serving.py`` has a counterpart here, run once
over each implementation (``impl`` is ``jax`` or ``port``: the serving and
client modules of that package) wherever the behaviour must be equal: the
batcher (order, coalescing, slicing, errors, close, backpressure, timeouts,
hot swaps), the HTTP contract (status codes, JSON keys, ``/healthz`` and
``/metrics``), keep-alive after an error, the body cap, a 64-client burst,
graceful shutdown and the second-signal escape, hot reload by SIGHUP,
``tools/serve_loadtest.py`` against the daemon, the client (retries,
health, metrics, confidences) and the refusals of ``serving_predict_fn``.

Port only:

* JAX's daemon and the port's over the same weights (fp32) answer the same
  PNG, JPEG and JSON-batch requests with the same status, keys and strings,
  with and without confidences, and expose the same metric names; the same
  for progressive and CMYK JPEG and TIFF bodies, and Group 4 TIFF, RLE8 and
  1-bit BMP and YCbCr JPEG-in-TIFF bodies against PNG twins of their
  pixels (which the port's daemon answered with 400 before its decoders
  read them);
* the live engine's long-line routes give JAX's strings through the fn;
* a daemon over the port's engine equals the in-process
  ``predict_serving``;
* ``serving_predict_fn`` refuses anything but the port's ``OCRInference``
  (serving artifacts: ``tests/test_torch_port_artifact.py``);
* ``python -m rcnn_ocr_tpu_torch.serve --device cpu`` serves, reloads on
  SIGHUP and drains on SIGTERM; its flag checks fail as ``tools/serve.py``'s
  do, and the options of later slices exit naming them.
"""

import base64
import http.client
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rcnn_ocr_tpu import client as jax_client  # noqa: E402
from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference  # noqa: E402
from rcnn_ocr_tpu import serving as jax_serving  # noqa: E402
from rcnn_ocr_tpu_torch import client as port_client  # noqa: E402
from rcnn_ocr_tpu_torch import serving as port_serving  # noqa: E402
from rcnn_ocr_tpu_torch.inference import OCRInference  # noqa: E402
from tests.test_torch_port_beam_engine import IMG_H, _images, files  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class RecordingEngine:
    """predict(list)->list echoing a per-image tag; records batch tags."""

    def __init__(self, delay_s: float = 0.0, fail_on=None, gate=None):
        self.batches = []
        self.delay_s = delay_s
        self.fail_on = fail_on or set()
        self.gate = gate

    def predict(self, images):
        tags = [int(np.asarray(img).ravel()[0]) for img in images]
        self.batches.append(tags)
        if self.gate is not None:
            assert self.gate.wait(30)
        if self.delay_s:
            time.sleep(self.delay_s)
        out = []
        for tag in tags:
            if tag in self.fail_on:
                raise ValueError(f"bad image {tag}")
            out.append(f"t{tag}")
        return out


def _fake_engine(name, **attrs):
    """An engine that fails nothing before validation: a bare object for
    JAX, an uninitialized ``OCRInference`` for the port (whose fn takes
    only its own engine)."""
    eng = object.__new__(OCRInference) if name == "port" else types.SimpleNamespace()
    for k, v in attrs.items():
        setattr(eng, k, v)
    return eng


@pytest.fixture(params=["jax", "port"])
def impl(request):
    serving, client = {"jax": (jax_serving, jax_client),
                       "port": (port_serving, port_client)}[request.param]
    return types.SimpleNamespace(name=request.param, serving=serving, client=client)


def _imgs(tags):
    return [np.full((4, 4, 3), t, np.uint8) for t in tags]


def _post(url, data, ctype):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _png_bytes(img):
    ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


def _jpeg_bytes(img, quality=95):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.address[:2]
    return f"http://{host}:{port}", thread


def _stop(server, thread):
    server.close()
    thread.join(timeout=10)


@pytest.fixture()
def http_server(impl):
    eng = RecordingEngine()
    server = impl.serving.OCRServer(eng.predict, host="127.0.0.1", port=0, max_batch=8,
                                    max_wait_ms=0)
    base, thread = _start(server)
    yield base, eng
    _stop(server, thread)


# --- the batcher ----------------------------------------------------------------------

def test_batcher_roundtrip_and_order(impl):
    eng = RecordingEngine()
    b = impl.serving.MicroBatcher(eng.predict, max_batch=8, max_wait_ms=0)
    try:
        assert b.submit(_imgs([3, 1, 2])) == ["t3", "t1", "t2"]
        assert b.submit([]) == []
        assert b.served == 3
    finally:
        b.close()


def test_batcher_coalesces_across_requests(impl):
    eng = RecordingEngine(delay_s=0.02)
    b = impl.serving.MicroBatcher(eng.predict, max_batch=64, max_wait_ms=200)
    results = {}

    def worker(tag):
        results[tag] = b.submit(_imgs([tag]))[0]

    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == {t: f"t{t}" for t in range(6)}
        assert len(eng.batches) < 6
        assert sum(len(x) for x in eng.batches) == 6
    finally:
        b.close()


def test_batcher_slices_oversized_requests(impl):
    eng = RecordingEngine()
    b = impl.serving.MicroBatcher(eng.predict, max_batch=4, max_wait_ms=0)
    try:
        tags = list(range(10))
        assert b.submit(_imgs(tags)) == [f"t{t}" for t in tags]
        assert max(len(x) for x in eng.batches) <= 4
        assert sum(len(x) for x in eng.batches) == 10
    finally:
        b.close()


def test_batcher_delivers_engine_errors(impl):
    eng = RecordingEngine(fail_on={7})
    b = impl.serving.MicroBatcher(eng.predict, max_batch=8, max_wait_ms=0)
    try:
        with pytest.raises(ValueError, match="bad image 7"):
            b.submit(_imgs([7]))
        assert b.submit(_imgs([1])) == ["t1"]
    finally:
        b.close()


def test_batcher_close_unblocks_submitters(impl):
    b = impl.serving.MicroBatcher(RecordingEngine().predict, max_batch=8, max_wait_ms=0)
    b.close()
    with pytest.raises(impl.serving.DrainingError):
        b.submit(_imgs([1]))


def test_batcher_queue_full_backpressure(impl):
    gate = threading.Event()
    eng = RecordingEngine(gate=gate)
    b = impl.serving.MicroBatcher(eng.predict, max_batch=2, max_wait_ms=0, max_queued=4)
    try:
        t1 = threading.Thread(target=lambda: b.submit(_imgs([1, 2])))
        t1.start()
        deadline = time.monotonic() + 10
        while not eng.batches and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng.batches
        t2 = threading.Thread(target=lambda: b.submit(_imgs([3, 4, 5, 6])))
        t2.start()
        deadline = time.monotonic() + 10
        while b.pending() < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(impl.serving.QueueFullError):
            b.submit(_imgs([7]))
        gate.set()
        t1.join(10)
        t2.join(10)
        assert not t1.is_alive() and not t2.is_alive()
    finally:
        gate.set()
        b.close()


def test_batcher_timeout_abandons_queued_spans(impl):
    gate = threading.Event()
    eng = RecordingEngine(gate=gate)
    b = impl.serving.MicroBatcher(eng.predict, max_batch=2, max_wait_ms=0)
    try:
        t1 = threading.Thread(target=lambda: b.submit(_imgs([1])))
        t1.start()
        deadline = time.monotonic() + 10
        while not eng.batches and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(TimeoutError):
            b.submit(_imgs([9]), timeout=0.05)
        gate.set()
        t1.join(10)
        assert b.submit(_imgs([2])) == ["t2"]
        assert 9 not in [t for tags in eng.batches for t in tags]
    finally:
        gate.set()
        b.close()


def test_batcher_swap_predict_fn(impl):
    b = impl.serving.MicroBatcher(lambda imgs: [f"old{i}" for i in range(len(imgs))],
                                  max_batch=4, max_wait_ms=0)
    try:
        assert b.submit(_imgs([1])) == ["old0"]
        assert "engine_swaps" not in b.stats()
        b.swap_predict_fn(lambda imgs: [f"new{i}" for i in range(len(imgs))])
        assert b.submit(_imgs([2])) == ["new0"]
        assert b.stats()["engine_swaps"] == 1
    finally:
        b.close()


def test_batcher_swap_resizes_max_batch(impl):
    b = impl.serving.MicroBatcher(lambda imgs: ["x"] * len(imgs), max_batch=8, max_wait_ms=0)
    try:
        assert (b.max_batch, b.max_queued) == (8, 128)
        b.swap_predict_fn(lambda imgs: ["y"] * len(imgs), max_batch=2)
        assert (b.max_batch, b.max_queued) == (2, 32)
        assert b.submit(_imgs([1, 2, 3, 4, 5])) == ["y"] * 5
    finally:
        b.close()
    b2 = impl.serving.MicroBatcher(lambda imgs: ["x"] * len(imgs), max_batch=8,
                                   max_wait_ms=0, max_queued=100)
    try:
        b2.swap_predict_fn(lambda imgs: ["y"] * len(imgs), max_batch=4)
        assert (b2.max_batch, b2.max_queued) == (4, 100)
    finally:
        b2.close()


# --- HTTP -----------------------------------------------------------------------------

def test_http_contract(http_server):
    base, eng = http_server
    with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
        assert json.loads(resp.read())["status"] == "ok"
    status, out = _post(base + "/predict", _png_bytes(np.full((6, 9, 3), 42, np.uint8)),
                        "image/png")
    assert status == 200 and out == {"texts": ["t42"]}
    status, out = _post(base + "/predict", _jpeg_bytes(np.full((6, 9, 3), 42, np.uint8)),
                        "image/jpeg")
    assert status == 200 and out == {"texts": ["t42"]}
    imgs = [np.full((5, 7, 3), t, np.uint8) for t in (9, 11)]
    payload = json.dumps(
        {"images": [base64.b64encode(_png_bytes(i)).decode() for i in imgs]}).encode()
    status, out = _post(base + "/predict", payload, "application/json")
    assert status == 200 and out == {"texts": ["t9", "t11"]}
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/predict", b"not an image", "image/png")
    assert err.value.code == 400 and "bad request" in json.loads(err.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/nope", b"", "image/png")
    assert err.value.code == 404
    with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
        health = json.loads(resp.read())
    assert health["served"] == 4 and health["uptime_s"] >= 0
    assert set(health) == {"status", "pending", "served", "uptime_s", "latency_ms", "batch_size"}
    assert set(health["latency_ms"]) == {"p50", "p95", "p99"}
    assert health["latency_ms"]["p99"] >= health["latency_ms"]["p50"] >= 0
    assert set(health["batch_size"]) == {"mean", "max", "batches"}
    assert 1 <= health["batch_size"]["mean"] <= health["batch_size"]["max"] <= 8


def test_server_close_without_serve_does_not_deadlock(impl):
    server = impl.serving.OCRServer(RecordingEngine().predict, host="127.0.0.1", port=0)
    done = threading.Event()

    def closer():
        server.close()
        done.set()

    threading.Thread(target=closer, daemon=True).start()
    assert done.wait(10)


def test_http_keepalive_survives_404_with_body(http_server):
    base, _ = http_server
    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("POST", "/nope", body=b"X" * 4096, headers={"Content-Type": "image/png"})
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["status"] == "ok"
    finally:
        conn.close()


def test_http_body_size_cap(impl):
    eng = RecordingEngine()
    server = impl.serving.OCRServer(eng.predict, host="127.0.0.1", port=0, max_body_bytes=1024)
    base, thread = _start(server)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/predict", b"Y" * 2048, "image/png")
        assert err.value.code == 413
        assert eng.batches == []
    finally:
        _stop(server, thread)


def test_engine_error_is_500_and_timeout_is_504(impl):
    eng = RecordingEngine(fail_on={5})
    server = impl.serving.OCRServer(eng.predict, host="127.0.0.1", port=0, max_batch=8,
                                    max_wait_ms=0)
    base, thread = _start(server)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/predict", _png_bytes(_imgs([5])[0]), "image/png")
        assert err.value.code == 500 and json.loads(err.value.read()) == {"error": "bad image 5"}
    finally:
        _stop(server, thread)
    gate = threading.Event()
    slow = RecordingEngine(gate=gate)
    server = impl.serving.OCRServer(slow.predict, host="127.0.0.1", port=0, max_batch=8,
                                    max_wait_ms=0, request_timeout_s=0.2)
    base, thread = _start(server)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/predict", _png_bytes(_imgs([6])[0]), "image/png")
        assert err.value.code == 504 and json.loads(err.value.read()) == {
            "error": "decode timed out"}
    finally:
        gate.set()
        _stop(server, thread)


def test_metrics_endpoint_prometheus_format(http_server):
    base, _ = http_server
    img = np.full((6, 9, 3), 3, np.uint8)
    status, _ = _post(base + "/predict", _png_bytes(img), "image/png")
    assert status == 200
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    for line in ("# TYPE ocr_served_images_total counter", "ocr_served_images_total 1",
                 "ocr_engine_batches_total 1", "ocr_engine_batch_errors_total 0",
                 "ocr_pending_images 0", "ocr_draining 0",
                 'ocr_request_latency_seconds{quantile="0.99"}',
                 'ocr_http_responses_total{code="200"}'):
        assert line in text, line
    _post(base + "/predict", _png_bytes(img), "image/png")
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        text2 = resp.read().decode()
    assert "ocr_served_images_total 2" in text2
    m = re.search(r'ocr_http_responses_total\{code="200"\} (\d+)', text2)
    assert m and int(m.group(1)) >= 3


def test_serve_loadtest_tool(http_server):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import serve_loadtest as lt
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    base, _ = http_server
    result = lt.run_loadtest(base, _png_bytes(np.full((6, 9, 3), 42, np.uint8)),
                             n_requests=12, concurrency=4)
    assert result["ok"] == 12 and result["errors"] == 0
    assert result["server"]["images_served"] == 12
    assert 1 <= result["server"]["engine_batches"] <= 12
    assert result["server"]["engine_errors"] == 0
    assert result["latency_ms"]["p99"] >= result["latency_ms"]["p50"] > 0


def test_burst_concurrency_no_connection_resets(impl):
    eng = RecordingEngine()
    server = impl.serving.OCRServer(eng.predict, host="127.0.0.1", port=0, max_batch=16,
                                    max_wait_ms=5)
    base, thread = _start(server)
    try:
        body = _png_bytes(np.full((6, 9, 3), 7, np.uint8))
        errors, done, lock = [], [], threading.Lock()

        def client():
            try:
                status, _ = _post(base + "/predict", body, "image/png")
                with lock:
                    done.append(status)
            except Exception as e:
                with lock:
                    errors.append(repr(e))

        clients = [threading.Thread(target=client, daemon=True) for _ in range(64)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert not errors, errors[:5]
        assert len(done) == 64 and all(s == 200 for s in done)
        assert server.batcher.served == 64
    finally:
        _stop(server, thread)


# --- signals --------------------------------------------------------------------------

def test_graceful_shutdown_drains_inflight_requests(impl):
    gate = threading.Event()
    eng = RecordingEngine(gate=gate)
    server = impl.serving.OCRServer(eng.predict, host="127.0.0.1", port=0, max_batch=8,
                                    max_wait_ms=0)
    base, thread = _start(server)
    old_handler = signal.getsignal(signal.SIGTERM)
    try:
        impl.serving.install_graceful_shutdown(server, signals=(signal.SIGTERM,))
        inflight = {}

        def request_a():
            try:
                inflight["result"] = _post(base + "/predict", _png_bytes(_imgs([7])[0]),
                                           "image/png")
            except BaseException as e:  # pragma: no cover - failure detail
                inflight["error"] = e

        t_a = threading.Thread(target=request_a, daemon=True)
        t_a.start()
        deadline = time.monotonic() + 30
        while not eng.batches and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.batches
        signal.raise_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                if json.loads(r.read())["status"] == "draining":
                    break
            time.sleep(0.01)
        else:
            pytest.fail("healthz never reported draining")
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/predict", _png_bytes(_imgs([9])[0]), "image/png")
        assert exc.value.code == 503
        assert "draining" in json.loads(exc.value.read())["error"]
        gate.set()
        t_a.join(timeout=30)
        assert "error" not in inflight, inflight.get("error")
        assert inflight["result"] == (200, {"texts": ["t7"]})
        thread.join(timeout=30)
        assert not thread.is_alive()
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        gate.set()
        server.close()


def test_graceful_shutdown_second_signal_forces_exit(impl, monkeypatch):
    exits = []
    monkeypatch.setattr(os, "_exit", lambda code: exits.append(code))
    drain_started = threading.Event()

    class _WedgedServer:
        def shutdown_gracefully(self):
            drain_started.set()
            time.sleep(60)

    old_handler = signal.getsignal(signal.SIGTERM)
    try:
        impl.serving.install_graceful_shutdown(_WedgedServer(), signals=(signal.SIGTERM,))
        signal.raise_signal(signal.SIGTERM)
        assert drain_started.wait(timeout=10)
        assert exits == []
        signal.raise_signal(signal.SIGTERM)
        assert exits == [128 + signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, old_handler)


def test_install_hot_reload_sighup_swaps_engine(impl):
    eng = RecordingEngine()
    server = impl.serving.OCRServer(eng.predict, host="127.0.0.1", port=0, max_batch=8,
                                    max_wait_ms=0)
    base, thread = _start(server)
    builds = []

    def build_ok():
        builds.append("ok")
        return lambda imgs: ["reloaded"] * len(imgs)

    old_handler = signal.getsignal(signal.SIGHUP)
    try:
        impl.serving.install_hot_reload(server, build_ok)
        img = _imgs([3])[0]
        assert _post(base + "/predict", _png_bytes(img), "image/png") == (200, {"texts": ["t3"]})
        signal.raise_signal(signal.SIGHUP)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            _, out = _post(base + "/predict", _png_bytes(img), "image/png")
            if out["texts"] == ["reloaded"]:
                break
            time.sleep(0.01)
        assert out["texts"] == ["reloaded"] and builds == ["ok"]

        def build_bad():
            raise RuntimeError("corrupt checkpoint")

        impl.serving.install_hot_reload(server, build_bad)
        signal.raise_signal(signal.SIGHUP)
        time.sleep(0.3)
        assert _post(base + "/predict", _png_bytes(img), "image/png") == (
            200, {"texts": ["reloaded"]})
        with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
            assert "ocr_engine_swaps_total 1" in resp.read().decode()
    finally:
        signal.signal(signal.SIGHUP, old_handler)
        _stop(server, thread)


def test_install_hot_reload_tuple_build_resizes_batcher(impl):
    server = impl.serving.OCRServer(RecordingEngine().predict, host="127.0.0.1", port=0,
                                    max_batch=8, max_wait_ms=0)
    old_handler = signal.getsignal(signal.SIGHUP)
    try:
        impl.serving.install_hot_reload(server, lambda: (lambda imgs: ["swapped"] * len(imgs), 2))
        signal.raise_signal(signal.SIGHUP)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and server.batcher.max_batch != 2:
            time.sleep(0.01)
        assert server.batcher.max_batch == 2
        assert server.batcher.submit(_imgs([1])) == ["swapped"]
    finally:
        signal.signal(signal.SIGHUP, old_handler)
        server.close()


# --- the client -----------------------------------------------------------------------

def test_ocr_client_predict_health_metrics(impl, tmp_path):
    eng = RecordingEngine()
    server = impl.serving.OCRServer(eng.predict, host="127.0.0.1", port=0, max_batch=8,
                                    max_wait_ms=0)
    base, thread = _start(server)
    try:
        client = impl.client.OCRClient(base, timeout_s=30)
        assert client.wait_ready(timeout_s=30)["status"] == "ok"
        imgs = _imgs([1, 2, 3, 4])
        path = tmp_path / "img.png"
        path.write_bytes(_png_bytes(imgs[0]))
        out = client.predict([str(path), imgs[1], _png_bytes(imgs[2]), _jpeg_bytes(imgs[3])])
        assert out == ["t1", "t2", "t3", "t4"]
        assert client.health()["served"] == 4
        assert "ocr_served_images_total 4" in client.metrics()
        assert client.predict([]) == []
    finally:
        _stop(server, thread)


def test_ocr_client_retries_503_and_raises_permanent(impl):
    eng = RecordingEngine()
    server = impl.serving.OCRServer(eng.predict, host="127.0.0.1", port=0, max_batch=8,
                                    max_wait_ms=0)
    base, thread = _start(server)
    try:
        client = impl.client.OCRClient(base, timeout_s=30, max_retries=10, backoff_s=0.05)
        server._draining = True

        def recover():
            time.sleep(0.4)
            server._draining = False

        threading.Thread(target=recover, daemon=True).start()
        assert client.predict(_imgs([4])) == ["t4"]
        t0 = time.monotonic()
        with pytest.raises(impl.client.OCRClientError) as ei:
            client.predict([b"not an image"])
        assert ei.value.status == 400 and time.monotonic() - t0 < 5
        server._draining = True
        fast = impl.client.OCRClient(base, timeout_s=30, max_retries=1, backoff_s=0.01)
        with pytest.raises(impl.client.OCRClientError) as ei:
            fast.predict(_imgs([5]))
        assert ei.value.status == 503
    finally:
        server._draining = False
        _stop(server, thread)


def test_daemon_confidence_responses_and_client(impl):
    def predict_conf(images):
        return [(f"t{int(np.asarray(im).ravel()[0])}", 0.5) for im in images]

    server = impl.serving.OCRServer(predict_conf, host="127.0.0.1", port=0, max_batch=8,
                                    max_wait_ms=0, confidence=True)
    base, thread = _start(server)
    try:
        status, out = _post(base + "/predict", _png_bytes(_imgs([7])[0]), "image/png")
        assert status == 200 and out == {"texts": ["t7"], "confidences": [0.5]}
        client = impl.client.OCRClient(base, timeout_s=30)
        assert client.predict(_imgs([3, 4]), confidence=True) == [("t3", 0.5), ("t4", 0.5)]
        assert client.predict(_imgs([5])) == ["t5"]
    finally:
        _stop(server, thread)
    server2 = impl.serving.OCRServer(RecordingEngine().predict, host="127.0.0.1", port=0,
                                     max_batch=8, max_wait_ms=0)
    base, thread = _start(server2)
    try:
        with pytest.raises(impl.client.OCRClientError, match="confidence"):
            impl.client.OCRClient(base, timeout_s=30).predict(_imgs([1]), confidence=True)
    finally:
        _stop(server2, thread)


# --- serving_predict_fn refusals ------------------------------------------------------

def test_serving_predict_fn_rejects_misplaced_tiling_knobs(impl):
    fn, eng = impl.serving.serving_predict_fn, _fake_engine(impl.name)
    with pytest.raises(ValueError, match="tile_w"):
        fn(eng, method="ctc_greedy", tile_w=128)
    with pytest.raises(ValueError, match="tile_w"):
        fn(eng, method="attention_beam", overlap=16)
    with pytest.raises(ValueError, match="snap"):
        fn(eng, method="attention_long", snap="blank")
    with pytest.raises(ValueError, match="snap"):
        fn(eng, method="hybrid_long", snap="blank")


@pytest.mark.parametrize("method,knob", [("ctc_long_beam", "lm_weight"),
                                         ("ctc_long", "length_penalty"),
                                         ("hybrid_long", "lm_weight"),
                                         ("hybrid_long", "length_penalty"),
                                         ("attention_long", "lm_weight"),
                                         ("attention_long", "length_penalty")])
def test_serving_predict_fn_rejects_fusion_knobs(impl, method, knob):
    with pytest.raises(ValueError, match=knob) as err:
        impl.serving.serving_predict_fn(_fake_engine(impl.name, img_w=64), method=method,
                                        **{knob: 0.4})
    assert f"method={method!r}" in str(err.value)


def test_attention_long_daemon_fails_fast_on_unaligned_width(impl):
    eng = _fake_engine(impl.name, img_w=100)
    with pytest.raises(ValueError, match="multiple"):
        impl.serving.serving_predict_fn(eng, method="attention_long", merge="align")
    assert callable(impl.serving.serving_predict_fn(eng, method="attention_long", merge="text"))


def test_serving_predict_fn_confidence_validation(impl):
    eng = _fake_engine(impl.name)
    for method in ("attention_long", "attention_long_beam"):
        with pytest.raises(ValueError, match="return_confidence"):
            impl.serving.serving_predict_fn(eng, method=method, return_confidence=True)
    for ok in ("ctc_greedy", "ctc_long", "attention", "hybrid_long"):
        assert callable(impl.serving.serving_predict_fn(eng, method=ok, return_confidence=True))


def test_port_serving_predict_fn_refuses_other_engines():
    class _Artifact:
        def predict(self, images):
            return [""] * len(images)

    with pytest.raises(TypeError, match="OCRInference or ServingArtifact"):
        port_serving.serving_predict_fn(_Artifact())


# --- real engines: the port's daemon against JAX's ------------------------------------

@pytest.fixture(scope="module")
def engines(files):
    ckpt, charset, _ = files
    kw = dict(img_h=IMG_H, img_w=64)
    return (OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, **kw),
            JaxOCRInference(ckpt, charset, dtype=jnp.float32, verbose=False, **kw))


def _requests(seed=4):
    rng = np.random.default_rng(seed)
    imgs = _images(6, seed=seed, widths=(40, 64, 52, 30, 80, 24))
    imgs[3] = np.ascontiguousarray(imgs[3][: int(rng.integers(20, 30))])  # a shorter line
    bodies = [("image/png", _png_bytes(imgs[0])), ("image/jpeg", _jpeg_bytes(imgs[1])),
              ("application/json", json.dumps({"images": [
                  base64.b64encode(_png_bytes(imgs[2])).decode(),
                  base64.b64encode(_jpeg_bytes(imgs[3])).decode(),
                  base64.b64encode(_jpeg_bytes(imgs[4], 80)).decode(),
                  base64.b64encode(_png_bytes(imgs[5])).decode()]}).encode()),
              ("image/png", b"not an image"), ("application/json", b"{bad json")]
    return imgs, bodies


def _answer(base, ctype, body):
    try:
        return _post(base + "/predict", body, ctype)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("method,confidence", [("ctc_greedy", False), ("ctc_greedy", True),
                                               ("attention", False), ("attention", True)])
def test_port_daemon_answers_as_the_jax_daemon(engines, method, confidence):
    _, bodies = _requests()
    answers, metric_names = {}, {}
    for name, eng, serving in (("port", engines[0], port_serving),
                               ("jax", engines[1], jax_serving)):
        fn = serving.serving_predict_fn(eng, method=method, batch_size=4, canvas=(48, 96),
                                        max_length=5, return_confidence=confidence)
        server = serving.OCRServer(fn, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=0,
                                   confidence=confidence)
        base, thread = _start(server)
        try:
            answers[name] = [_answer(base, ctype, body) for ctype, body in bodies]
            with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
                metric_names[name] = sorted(set(re.findall(r"^(ocr_\w+)", resp.read().decode(),
                                                           re.M)))
        finally:
            _stop(server, thread)
    got, want = answers["port"], answers["jax"]
    assert [s for s, _ in got] == [s for s, _ in want] == [200, 200, 200, 400, 400]
    for (_, g), (_, w) in zip(got[:3], want[:3]):
        assert set(g) == set(w) == ({"texts", "confidences"} if confidence else {"texts"})
        assert g["texts"] == w["texts"]
        if confidence:
            np.testing.assert_allclose(g["confidences"], w["confidences"], rtol=1e-5, atol=1e-5)
    assert len(got[2][1]["texts"]) == 4 and len({t for _, a in got[:3] for t in a["texts"]}) > 1
    for (_, g), (_, w) in zip(got[3:], want[3:]):
        assert set(g) == set(w) == {"error"} and g["error"].startswith("bad request")
    assert metric_names["port"] == metric_names["jax"]


@pytest.mark.parametrize("method", ["ctc_greedy", "attention"])
def test_port_daemon_answers_progressive_and_tiff_bodies_as_the_jax_daemon(engines, method):
    from PIL import Image

    from tests.torch_port_data.make_tiff_fixtures import tiff_bytes

    imgs, _ = _requests()  # the lines of the PNG and baseline JPEG test
    ok, prog = cv2.imencode(".jpg", cv2.cvtColor(imgs[0], cv2.COLOR_RGB2BGR),
                            [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert ok
    cmyk = io.BytesIO()
    Image.fromarray(imgs[2]).convert("CMYK").save(cmyk, format="JPEG", quality=95)
    pil_prog = io.BytesIO()
    Image.fromarray(imgs[4]).save(pil_prog, format="JPEG", quality=90, progressive=True)
    bodies = [("image/jpeg", prog.tobytes()),
              ("image/tiff", tiff_bytes(imgs[1], photometric=2, compression="lzw", predictor=2)),
              ("application/json", json.dumps({"images": [
                  base64.b64encode(cmyk.getvalue()).decode(),
                  base64.b64encode(tiff_bytes(imgs[3].astype(np.uint16) * 257, bits=16,
                                              photometric=2, compression="deflate",
                                              order=">")).decode(),
                  base64.b64encode(pil_prog.getvalue()).decode()]}).encode())]
    answers = {}
    for name, eng, serving in (("port", engines[0], port_serving),
                               ("jax", engines[1], jax_serving)):
        fn = serving.serving_predict_fn(eng, method=method, batch_size=4, canvas=(48, 96),
                                        max_length=5)
        server = serving.OCRServer(fn, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=0)
        base, thread = _start(server)
        try:
            answers[name] = [_answer(base, ctype, body) for ctype, body in bodies]
        finally:
            _stop(server, thread)
    assert [s for s, _ in answers["port"]] == [s for s, _ in answers["jax"]] == [200] * 3
    assert answers["port"] == answers["jax"]
    texts = [t for _, a in answers["port"] for t in a["texts"]]
    assert len(texts) == 5 and len(set(texts)) > 1


@pytest.mark.parametrize("method", ["ctc_greedy", "attention"])
def test_port_daemon_answers_fax_bmp_and_ycbcr_bodies_as_their_png_twins(engines, method):
    """A Group 4 TIFF, an RLE8 and a 1-bit BMP and a YCbCr JPEG-in-TIFF
    (which the port's daemon answered 400 before its decoders read them):
    both daemons answer each as they answer a PNG of cv2's pixels of it."""
    from PIL import Image

    from rcnn_ocr_tpu.data.transforms import imdecode_cv2
    from tests.torch_port_data.make_bmp_fixtures import bmp_bytes
    from tests.torch_port_data.make_tiff_fixtures import jpeg_tiff, tiff_bytes

    imgs, _ = _requests()
    bilevel = (imgs[0].mean(axis=2) < 128).astype(np.uint8)[:, :, None]
    levels = np.repeat(np.array([[0], [85], [170], [255]], np.uint8), 3, axis=1)
    one_bit = io.BytesIO()
    Image.fromarray(imgs[2]).convert("1").save(one_bit, format="BMP")
    bodies = [("image/tiff", tiff_bytes(bilevel, bits=1, photometric=0, compression="g4",
                                        rows_per_strip=len(bilevel))),
              ("image/bmp", bmp_bytes((imgs[1].mean(axis=2) // 64).astype(np.uint8), 8, "rle8",
                                      palette=levels)),
              ("image/bmp", one_bit.getvalue()),
              ("image/tiff", jpeg_tiff(imgs[4], 6, sampling="420", rows_per_strip=16))]
    bodies += [("image/png", _png_bytes(imdecode_cv2(body))) for _, body in bodies]
    answers = {}
    for name, eng, serving in (("port", engines[0], port_serving),
                               ("jax", engines[1], jax_serving)):
        fn = serving.serving_predict_fn(eng, method=method, batch_size=4, canvas=(48, 96),
                                        max_length=5)
        server = serving.OCRServer(fn, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=0)
        base, thread = _start(server)
        try:
            answers[name] = [_answer(base, ctype, body) for ctype, body in bodies]
        finally:
            _stop(server, thread)
    assert [s for s, _ in answers["port"]] == [s for s, _ in answers["jax"]] == [200] * 8
    assert answers["port"] == answers["jax"]
    assert answers["port"][:4] == answers["port"][4:]


def test_port_daemon_equals_in_process_predict_serving(engines):
    ours = engines[0]
    imgs, bodies = _requests(seed=9)
    fn = port_serving.serving_predict_fn(ours, method="ctc_greedy", batch_size=4,
                                         canvas=(48, 96), max_length=5)
    server = port_serving.OCRServer(fn, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=0)
    base, thread = _start(server)
    try:
        got = [_answer(base, ctype, body)[1]["texts"] for ctype, body in bodies[:3]]
    finally:
        _stop(server, thread)
    from rcnn_ocr_tpu_torch.data.image_io import imdecode

    decoded = [imdecode(_png_bytes(imgs[0])), imdecode(_jpeg_bytes(imgs[1])),
               *[imdecode(b) for b in (_png_bytes(imgs[2]), _jpeg_bytes(imgs[3]),
                                        _jpeg_bytes(imgs[4], 80), _png_bytes(imgs[5]))]]
    want = ours.predict_serving(decoded, method="ctc_greedy", batch_size=4, canvas=(48, 96),
                                max_length=5)
    assert [t for texts in got for t in texts] == want


def test_long_line_routes_match_jax(engines):
    ours, theirs = engines
    rng = np.random.default_rng(7)
    wide = rng.integers(0, 256, (32, 300, 3)).astype(np.uint8)
    narrow = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    for kw in (dict(method="ctc_long"), dict(method="ctc_long_beam", beam_width=4),
               dict(method="ctc_long", tile_w=64, overlap=16, snap="blank"),
               dict(method="hybrid_long", max_length=5),
               dict(method="attention_long", max_length=5, merge="text")):
        got = port_serving.serving_predict_fn(ours, batch_size=2, **kw)([narrow, wide])
        want = jax_serving.serving_predict_fn(theirs, batch_size=2, **kw)([narrow, wide])
        assert got == want, kw


# --- python -m rcnn_ocr_tpu_torch.serve ----------------------------------------------

def _serve_argv(files, *extra):
    ckpt, charset, _ = files
    return ["--model", ckpt, "--charset", charset, "--img-h", "32", "--img-w", "64",
            "--canvas", "48,96", "--batch-size", "4", "--max-length", "5", *extra]


@pytest.mark.parametrize("extra,message", [
    (["--min-gap", "4"], "--min-gap/--margin require a hybrid_long method"),
    (["--merge", "text"], "--merge requires an attention_long method"),
    (["--tile-w", "64"], "--tile-w/--overlap require a *_long method"),
    (["--snap", "blank"], "--snap requires a ctc_long method"),
    (["--method", "attention_long", "--confidence"], "--confidence is not supported"),
])
def test_serve_cli_checks_match_tools_serve(files, monkeypatch, capsys, extra, message):
    import importlib.util

    from rcnn_ocr_tpu_torch import serve

    spec = importlib.util.spec_from_file_location("jax_tools_serve",
                                                  os.path.join(REPO, "tools", "serve.py"))
    tools_serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools_serve)
    argv = _serve_argv(files, *extra)
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    with pytest.raises(SystemExit) as err:
        tools_serve.main()
    want = capsys.readouterr().err.splitlines()[-1].split("error: ", 1)[1]
    with pytest.raises(SystemExit) as err2:
        serve.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().err.splitlines()[-1].split("error: ", 1)[1]
    assert err.value.code == err2.value.code == 2
    assert got == want and message in got


@pytest.mark.parametrize("extra,item", [(["--mesh"], None),
                                        (["--compile-cache-dir", "c"], "no XLA compile cache")])
def test_serve_cli_refuses_later_slices(files, capsys, monkeypatch, extra, item):
    """XLA's compile cache is refused, beside a checkpoint and beside an
    artifact (``--quantize`` and ``--artifact`` are served:
    ``tests/test_torch_port_artifact.py``).  ``--mesh`` is served: both
    builders get ``mesh=True`` (one CPU replica with ``--device cpu``);
    ``tests/test_torch_port_mesh.py`` runs such daemons."""
    from rcnn_ocr_tpu_torch import serve

    if item is None:
        built, engines = {}, []
        real = port_serving.serving_predict_fn
        monkeypatch.setattr(port_serving, "serving_predict_fn",
                            lambda engine, **kw: engines.append(engine) or real(engine, **kw))

        def fake_serve(args, build_predict):
            built["fn"], built["max_batch"] = build_predict()

        monkeypatch.setattr(serve, "_serve", fake_serve)
        serve.main([*_serve_argv(files), "--device", "cpu", *extra])
        assert engines[0]._mesh == [torch.device("cpu")] and built["max_batch"] == 4
        line = [np.full((20, 40, 3), 200, np.uint8)]
        assert built["fn"](line) == engines[0].predict_serving(
            line, method="ctc_greedy", batch_size=4, canvas=(48, 96), max_length=5)
        return
    with pytest.raises(SystemExit) as err:
        serve.main([*_serve_argv(files), "--device", "cpu", *extra])
    assert err.value.code == 2 and item in capsys.readouterr().err
    with pytest.raises(SystemExit) as err:
        serve.main(["--artifact", "dir", "--device", "cpu", *extra])
    assert err.value.code == 2 and item in capsys.readouterr().err


def _read_until(lines, pattern, timeout=120):
    """The first line of the daemon's stdout (fed to ``lines`` by a reader
    thread) that matches ``pattern``, waiting at most ``timeout`` s."""
    import queue

    seen, deadline = [], time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        seen.append(line)
        m = re.search(pattern, line)
        if m:
            return m
    raise AssertionError(f"no {pattern!r} in the daemon's output: {seen}")


def test_serve_cli_serves_reloads_and_drains(files):
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rcnn_ocr_tpu_torch.serve", *_serve_argv(files),
         "--port", "0", "--device", "cpu", "--method", "attention"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    import queue

    lines = queue.Queue()
    reader = threading.Thread(target=lambda: ([lines.put(x) for x in proc.stdout],
                                              lines.put(None)), daemon=True)
    reader.start()
    try:
        base = _read_until(lines, r"Serving on (http://\S+)").group(1)
        imgs, bodies = _requests(seed=11)
        ckpt, charset, _ = files  # the daemon's engine: bf16, the default
        want = OCRInference(ckpt, charset, device="cpu", img_h=32, img_w=64).predict_serving(
            [imgs[0]], method="attention", batch_size=4, canvas=(48, 96), max_length=5)
        assert _answer(base, *bodies[0]) == (200, {"texts": want})
        proc.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
                if "ocr_engine_swaps_total 1" in resp.read().decode():
                    break
            time.sleep(0.1)
        else:
            pytest.fail("the daemon never swapped engines after SIGHUP")
        assert _answer(base, *bodies[0]) == (200, {"texts": want})
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        reader.join(10)
        rest = []
        while not lines.empty():
            rest.append(lines.get() or "")
        assert "Drained; exiting." in "".join(rest)
        assert "engine reloaded" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
