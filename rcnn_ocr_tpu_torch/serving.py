"""Micro-batching OCR serving daemon (stdlib HTTP, no extra dependencies).

Counterpart of ``rcnn_ocr_tpu/serving.py``: ``MicroBatcher``, ``OCRServer``,
``prometheus_metrics``, ``install_graceful_shutdown``, ``install_hot_reload``
and ``serving_predict_fn``, with the same HTTP contract (paths, status
codes, JSON keys, ``/healthz`` fields, ``/metrics`` names and labels).  The
engine behind it is the port's
:class:`~rcnn_ocr_tpu_torch.inference.OCRInference` on the card, pinned to
``predict_serving`` (or a long-line decode) by :func:`serving_predict_fn`,
or a loaded :class:`~rcnn_ocr_tpu_torch.export.ServingArtifact`;
request bodies are decoded by the port's own
:func:`~rcnn_ocr_tpu_torch.data.image_io.imdecode` (PNG, BMP, JPEG, TIFF,
WebP, GIF, Netpbm, JPEG 2000, Sun raster, PFM and Radiance HDR, no cv2),
whose JPEG, TIFF, WebP, GIF and JPEG 2000 bit-level loops are host C++
called through ctypes, so handler threads decode in parallel.

Handler threads enqueue decoded images and block; ONE dispatcher thread
drains the queue into batches of up to ``max_batch`` (waiting at most
``max_wait_ms`` after the first queued item) and runs the engine once per
batch, so many concurrent clients share one device batch.  The engine is
not thread-safe; only the dispatcher thread calls it.

HTTP API::

    GET  /healthz   -> {"status": "ok", "pending": N, "served": M,
                        "uptime_s": S, "latency_ms": {p50/p95/p99},
                        "batch_size": {mean/max/batches}}  (rolling stats)
    GET  /metrics   -> the same data in the Prometheus text exposition
                       format (+ responses-by-status and engine-error
                       counters), ready to scrape
    POST /predict   body = raw encoded image bytes (PNG/JPEG/BMP/TIFF/WebP/GIF/PNM)
                    or JSON {"images": ["<base64>", ...]}
                    -> {"texts": ["...", ...]}   (raw body -> one entry)
                    (+ "confidences": [...] when the daemon runs with
                    --confidence; every method except attention_long*)

Run it: ``python -m rcnn_ocr_tpu_torch.serve --model W.msgpack|W.pth
--charset cs.txt --port 8000``.  Signals: SIGTERM/SIGINT drain gracefully
(:func:`install_graceful_shutdown`), SIGHUP hot-reloads the model from disk
with zero downtime (:func:`install_hot_reload`).
"""

from __future__ import annotations

import base64
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, List, Optional


class _Pending:
    """One request's images waiting for a dispatcher slot."""

    __slots__ = ("images", "done", "texts", "error", "abandoned")

    def __init__(self, images: List[Any]):
        self.images = images
        self.done = threading.Event()
        self.texts: Optional[List[str]] = None
        self.error: Optional[BaseException] = None
        self.abandoned = False  # timed-out submitter left; skip its spans


class QueueFullError(RuntimeError):
    """Backpressure: the batcher's queue is at max_queued images."""


class DrainingError(RuntimeError):
    """The server is draining (shutdown in progress): new work is refused."""


class MicroBatcher:
    """Cross-request batcher: many submitters, one engine thread.

    ``predict_fn(list_of_images) -> list_of_texts`` is only ever called
    from the dispatcher thread, serially, with up to ``max_batch`` images
    merged across requests.  ``max_wait_ms`` bounds added latency: the
    dispatcher ships a partial batch once the oldest queued image has
    waited that long (0 ships immediately — pure request coalescing).
    ``max_queued`` bounds queue depth (decoded images are ~100 KB each);
    beyond it :meth:`submit` raises :class:`QueueFullError` so the HTTP
    layer can shed load with a 503 instead of accumulating work.
    """

    def __init__(
        self,
        predict_fn: Callable[[List[Any]], List[str]],
        max_batch: int = 256,
        max_wait_ms: float = 5.0,
        max_queued: Optional[int] = None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._predict = predict_fn
        self.max_batch = int(max_batch)
        self._max_queued_auto = not max_queued  # derived, rescale on swap
        self.max_queued = int(max_queued) if max_queued else 16 * self.max_batch
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self._queue: deque = deque()  # (_Pending, lo, hi) image spans
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self.served = 0  # images decoded since start
        self.dispatched_batches = 0  # engine calls that returned texts
        self.errored_batches = 0  # engine calls that raised
        self.engine_swaps = 0  # hot reloads (swap_predict_fn calls)
        self.started = time.monotonic()
        # rolling observability windows (lock-protected): request latencies
        # (enqueue -> done, seconds) and dispatched batch sizes
        self._latencies: deque = deque(maxlen=1024)
        self._batch_sizes: deque = deque(maxlen=1024)
        self._thread = threading.Thread(
            target=self._run, name="ocr-microbatcher", daemon=True
        )
        self._thread.start()

    # -- submitter side ------------------------------------------------------
    def submit(self, images: List[Any], timeout: Optional[float] = None) -> List[str]:
        """Block until this request's images are decoded; returns texts.

        Oversized requests are fine — the dispatcher slices them into
        ``max_batch`` spans and reassembles the result.
        """
        if not images:
            return []
        t0 = time.monotonic()
        pending = _Pending(list(images))
        with self._wake:
            if self._stop:
                raise DrainingError("server is shutting down")
            queued = sum(hi - lo for _, lo, hi, _ in self._queue)
            if queued + len(pending.images) > self.max_queued:
                raise QueueFullError(
                    f"queue full ({queued} images pending, "
                    f"max_queued={self.max_queued})"
                )
            for lo in range(0, len(pending.images), self.max_batch):
                hi = min(lo + self.max_batch, len(pending.images))
                self._queue.append((pending, lo, hi, time.monotonic()))
            self._wake.notify()
        if not pending.done.wait(timeout):
            # mark abandoned so the dispatcher drops still-queued spans
            # instead of decoding for a client that already got its 504
            pending.abandoned = True
            raise TimeoutError("decode did not complete in time")
        if pending.error is not None:
            raise pending.error
        assert pending.texts is not None
        with self._lock:
            self._latencies.append(time.monotonic() - t0)
        return pending.texts

    def pending(self) -> int:
        with self._lock:
            return sum(hi - lo for _, lo, hi, _ in self._queue)

    def swap_predict_fn(
        self,
        fn: Callable[[List[Any]], List[str]],
        max_batch: Optional[int] = None,
    ) -> None:
        """Atomically replace the engine (hot reload).

        The dispatcher reads ``self._predict`` once per batch, so the
        in-flight batch finishes on the engine that started it and every
        later batch runs the new one — no queued request is dropped and
        no response mixes engines.  Pass ``max_batch`` when the new
        engine's device batch differs (a re-exported artifact): the
        dispatcher cuts the new size from the next batch on, and a
        default-derived ``max_queued`` rescales with it."""
        with self._wake:
            self._predict = fn
            self.engine_swaps += 1
            if max_batch is not None and int(max_batch) != self.max_batch:
                if max_batch < 1:
                    raise ValueError("max_batch must be >= 1")
                self.max_batch = int(max_batch)
                if self._max_queued_auto:
                    self.max_queued = 16 * self.max_batch

    def stats(self) -> dict:
        """Rolling serving stats for /healthz (last <=1024 requests/batches).

        Request latency = submit entry -> decode delivered, so it includes
        queueing and the coalescing wait — what a client actually sees."""
        with self._lock:
            lats = sorted(self._latencies)
            sizes = list(self._batch_sizes)
        out = {
            "served": self.served,
            "uptime_s": round(time.monotonic() - self.started, 1),
        }
        if self.engine_swaps:
            out["engine_swaps"] = self.engine_swaps
        if lats:
            pick = lambda q: round(lats[min(len(lats) - 1, int(q * len(lats)))] * 1e3, 2)
            out["latency_ms"] = {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99)}
        if sizes:
            out["batch_size"] = {
                "mean": round(sum(sizes) / len(sizes), 1),
                "max": max(sizes),
                "batches": len(sizes),
            }
        return out

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting work, drain what's queued, join the dispatcher.

        With ``timeout=None`` (default) this waits for the drain — the
        dispatcher keeps cutting batches until the queue is empty, then
        exits.  Pass a timeout to bound the wait; queued requests are
        failed only if the dispatcher actually died (otherwise they are
        left to complete — killing them while the engine still runs
        would strand submitters that a later batch WOULD have served)."""
        with self._wake:
            self._stop = True
            self._wake.notify()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            return  # still draining; submitters keep their spans
        # dispatcher is gone: fail anything still queued so submitters
        # don't hang forever
        with self._lock:
            leftovers = list(self._queue)
            self._queue.clear()
        for pending, _, _, _ in leftovers:
            pending.error = DrainingError("server is shutting down")
            pending.done.set()

    # -- dispatcher side -----------------------------------------------------
    def _take_batch(self) -> List[tuple]:
        """Wait for work, then cut one <= max_batch slice of the queue.

        Spans whose submitter timed out (``abandoned``) are dropped here,
        not decoded.  Returns ``[]`` only on stop-and-drained."""
        with self._wake:
            while True:
                while not self._queue and not self._stop:
                    self._wake.wait()
                if self._stop and not self._queue:
                    return []
                # coalesce: once anything is queued, give followers
                # max_wait to pile on (skip the nap when already full)
                deadline = self._queue[0][3] + self.max_wait_s
                while (
                    not self._stop
                    and sum(hi - lo for _, lo, hi, _ in self._queue)
                    < self.max_batch
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._wake.wait(timeout=remaining)
                batch, n = [], 0
                while self._queue and n < self.max_batch:
                    pending, lo, hi, t0 = self._queue[0]
                    if pending.abandoned:
                        self._queue.popleft()
                        continue
                    take = min(hi - lo, self.max_batch - n)
                    batch.append((pending, lo, lo + take))
                    n += take
                    if take == hi - lo:
                        self._queue.popleft()
                    else:
                        self._queue[0] = (pending, lo + take, hi, t0)
                if batch:
                    return batch
                # everything cut was abandoned — wait for real work

    def _run(self) -> None:
        inflight: dict = {}  # pending -> [spans done? via counter]
        while True:
            batch = self._take_batch()
            if not batch:
                return
            images = [
                img
                for pending, lo, hi in batch
                for img in pending.images[lo:hi]
            ]
            try:
                texts = self._predict(images)
                if len(texts) != len(images):
                    raise RuntimeError(
                        f"engine returned {len(texts)} results for "
                        f"{len(images)} images"
                    )
            except BaseException as e:  # deliver, don't kill the loop
                with self._lock:
                    self.errored_batches += 1
                for pending, _, _ in batch:
                    pending.error = e
                    inflight.pop(pending, None)
                    pending.done.set()
                continue
            self.served += len(images)
            with self._lock:
                self.dispatched_batches += 1
                self._batch_sizes.append(len(images))
            pos = 0
            for pending, lo, hi in batch:
                span = texts[pos : pos + (hi - lo)]
                pos += hi - lo
                if pending.done.is_set():
                    continue  # an earlier span already failed this request
                if pending.texts is None:
                    pending.texts = [""] * len(pending.images)
                    inflight[pending] = 0
                pending.texts[lo:hi] = span
                inflight[pending] += hi - lo
                if inflight[pending] == len(pending.images):
                    del inflight[pending]
                    pending.done.set()


def prometheus_metrics(
    batcher: MicroBatcher,
    draining: bool = False,
    response_counts: Optional[dict] = None,
) -> str:
    """Render serving stats in the Prometheus text exposition format.

    Same data as ``/healthz`` (plus HTTP response counters), shaped for a
    scrape target: monotonic counters for served images / engine batches /
    engine errors / responses-by-status, gauges for queue depth, uptime,
    and the draining flag, and the rolling latency window as a summary
    with 0.5/0.95/0.99 quantiles."""
    stats = batcher.stats()
    with batcher._lock:
        dispatched = batcher.dispatched_batches
        errored = batcher.errored_batches
    lines = [
        "# HELP ocr_served_images_total Images decoded since server start.",
        "# TYPE ocr_served_images_total counter",
        f"ocr_served_images_total {stats['served']}",
        "# HELP ocr_engine_batches_total Batches the engine decoded.",
        "# TYPE ocr_engine_batches_total counter",
        f"ocr_engine_batches_total {dispatched}",
        "# HELP ocr_engine_batch_errors_total Batches that raised in the engine.",
        "# TYPE ocr_engine_batch_errors_total counter",
        f"ocr_engine_batch_errors_total {errored}",
        "# HELP ocr_pending_images Images currently queued for decode.",
        "# TYPE ocr_pending_images gauge",
        f"ocr_pending_images {batcher.pending()}",
        "# HELP ocr_uptime_seconds Seconds since the batcher started.",
        "# TYPE ocr_uptime_seconds gauge",
        f"ocr_uptime_seconds {stats['uptime_s']}",
        "# HELP ocr_draining Server is draining (1) or accepting work (0).",
        "# TYPE ocr_draining gauge",
        f"ocr_draining {1 if draining else 0}",
        "# HELP ocr_engine_swaps_total Hot engine reloads since start.",
        "# TYPE ocr_engine_swaps_total counter",
        f"ocr_engine_swaps_total {batcher.engine_swaps}",
    ]
    if "latency_ms" in stats:
        lines += [
            "# HELP ocr_request_latency_seconds Rolling request latency"
            " (enqueue to delivery, last <=1024 requests).",
            "# TYPE ocr_request_latency_seconds summary",
        ]
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            val = stats["latency_ms"][key] / 1e3
            lines.append(
                f'ocr_request_latency_seconds{{quantile="{q}"}} {val:.6f}'
            )
    if "batch_size" in stats:
        lines += [
            "# HELP ocr_batch_size_mean Mean dispatched batch size"
            " (rolling window).",
            "# TYPE ocr_batch_size_mean gauge",
            f"ocr_batch_size_mean {stats['batch_size']['mean']}",
        ]
    if response_counts is not None:
        lines += [
            "# HELP ocr_http_responses_total HTTP responses by status code.",
            "# TYPE ocr_http_responses_total counter",
        ]
        for code in sorted(response_counts):
            lines.append(
                f'ocr_http_responses_total{{code="{code}"}} '
                f"{response_counts[code]}"
            )
    return "\n".join(lines) + "\n"


def _make_handler(
    batcher: MicroBatcher,
    timeout_s: float,
    max_body_bytes: int,
    is_draining: Callable[[], bool] = lambda: False,
    response_counts: Optional[dict] = None,
    confidence: bool = False,  # engine yields (text, conf) pairs
):
    from rcnn_ocr_tpu_torch.data.image_io import imdecode

    counts = response_counts if response_counts is not None else {}
    counts_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            with counts_lock:
                counts[code] = counts.get(code, 0) + 1
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, payload: dict) -> None:
            self._send(
                code,
                json.dumps(payload, ensure_ascii=False).encode("utf-8"),
                "application/json; charset=utf-8",
            )

        def _drain_body(self) -> Optional[bytes]:
            """Read the request body (keep-alive requires consuming it
            even on error paths — an unread body desyncs the connection:
            the bytes get parsed as the NEXT request's request line).
            Returns None when Content-Length exceeds ``max_body_bytes``;
            the oversized body is then unread, so the connection is also
            marked close-after-response."""
            length = int(self.headers.get("Content-Length", 0) or 0)
            if length > max_body_bytes:
                self.close_connection = True
                return None
            return self.rfile.read(length)

        def do_GET(self):
            if self.path == "/metrics":
                with counts_lock:
                    snapshot = dict(counts)
                return self._send(
                    200,
                    prometheus_metrics(
                        batcher, draining=is_draining(),
                        response_counts=snapshot,
                    ).encode("utf-8"),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            self._reply(
                200,
                {
                    # "draining": shutdown in progress — load balancers
                    # should route new traffic elsewhere
                    "status": "draining" if is_draining() else "ok",
                    "pending": batcher.pending(),
                    **batcher.stats(),
                },
            )

        def do_POST(self):
            body = self._drain_body()
            if body is None:
                return self._reply(
                    413, {"error": f"body exceeds {max_body_bytes} bytes"}
                )
            if self.path != "/predict":
                return self._reply(404, {"error": "unknown path"})
            if is_draining():
                # shed new submissions with a retryable status while the
                # in-flight queue drains (parallel to QueueFullError)
                return self._reply(503, {"error": "server is draining"})
            try:
                ctype = (self.headers.get("Content-Type") or "").lower()
                single = not ctype.startswith("application/json")
                if single:
                    images = [imdecode(body)]
                else:
                    req = json.loads(body)
                    images = [
                        imdecode(base64.b64decode(b64))
                        for b64 in req.get("images", [])
                    ]
            except Exception as e:
                return self._reply(400, {"error": f"bad request: {e}"})
            try:
                texts = batcher.submit(images, timeout=timeout_s)
            except (QueueFullError, DrainingError) as e:
                return self._reply(503, {"error": str(e)})
            except TimeoutError:
                return self._reply(504, {"error": "decode timed out"})
            except Exception as e:
                return self._reply(500, {"error": str(e)})
            if confidence:
                return self._reply(200, {
                    "texts": [t for t, _ in texts],
                    "confidences": [float(c) for _, c in texts],
                })
            self._reply(200, {"texts": texts})

    return Handler


class OCRServer:
    """HTTP front-end: ``OCRServer(engine).serve_forever()``.

    ``predict_fn`` maps a list of RGB uint8 images to a list of strings:
    the port's ``OCRInference`` or ``ServingArtifact`` wrapped by
    :func:`serving_predict_fn`, which pins the serving-path kwargs.
    """

    def __init__(
        self,
        predict_fn: Callable[[List[Any]], List[str]],
        host: str = "127.0.0.1",
        port: int = 8000,
        max_batch: int = 256,
        max_wait_ms: float = 5.0,
        request_timeout_s: float = 120.0,
        max_queued: Optional[int] = None,
        max_body_bytes: int = 64 * 1024 * 1024,
        listen_backlog: int = 128,
        confidence: bool = False,  # predict_fn yields (text, conf) pairs
    ):
        self.batcher = MicroBatcher(
            predict_fn,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            max_queued=max_queued,
        )
        self._draining = False
        self.response_counts: dict = {}  # status code -> replies sent

        # the stdlib default listen backlog (request_queue_size=5) drops
        # connections with RST under bursty concurrency; a deep backlog
        # costs nothing and lets the micro-batcher, not the kernel, do the
        # queueing
        class _Server(ThreadingHTTPServer):
            request_queue_size = int(listen_backlog)

        self.httpd = _Server(
            (host, port),
            _make_handler(
                self.batcher, request_timeout_s, max_body_bytes,
                is_draining=lambda: self._draining,
                response_counts=self.response_counts,
                confidence=confidence,
            ),
        )
        self.httpd.daemon_threads = True
        self._serving = False

    @property
    def address(self) -> tuple:
        return self.httpd.server_address

    def serve_forever(self) -> None:
        self._serving = True
        try:
            self.httpd.serve_forever()
        finally:
            self._serving = False
            self.close()

    def shutdown_gracefully(self, timeout: Optional[float] = None) -> None:
        """Drain and stop — what SIGTERM should do in production.

        Ordered so no accepted request is dropped: (1) mark draining — new
        ``POST /predict`` gets a retryable 503 and ``/healthz`` reports
        ``draining``; (2) drain the batcher — the dispatcher keeps cutting
        batches until the queue is empty, so every already-queued and
        in-flight request receives its completed response; (3) stop the
        HTTP loop and close the socket.  Safe to call from any thread except
        the one inside ``serve_forever`` (use
        :func:`install_graceful_shutdown` from a signal handler).
        """
        self._draining = True
        self.batcher.close(timeout=timeout)
        self.close()

    def swap_predict_fn(
        self,
        fn: Callable[[List[Any]], List[str]],
        max_batch: Optional[int] = None,
    ) -> None:
        """Hot-swap the engine without dropping traffic (see
        :meth:`MicroBatcher.swap_predict_fn`; wire a signal with
        :func:`install_hot_reload`)."""
        self.batcher.swap_predict_fn(fn, max_batch=max_batch)

    def close(self) -> None:
        # httpd.shutdown() waits on an event that only serve_forever()
        # sets — calling it on a never-started server deadlocks forever
        if self._serving:
            self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()


def install_graceful_shutdown(server: OCRServer, signals=None) -> None:
    """Route SIGTERM (and SIGINT) to a draining shutdown.

    Container runtimes and batch schedulers send SIGTERM; without this the
    process dies with requests in flight (connection resets instead of
    completed responses / retryable 503s).  The drain runs on a helper
    thread because signal handlers execute on the main thread — the one
    blocked inside ``serve_forever``, which ``httpd.shutdown()`` must not
    be called from.  After the drain ``serve_forever`` returns and the
    process can exit 0.

    A SECOND signal is the operator's escape hatch: if the drain wedges
    (a hung engine call, a client that never reads its response), a
    repeated Ctrl-C / SIGTERM must still kill the process rather than be
    swallowed by the already-draining handler — it force-exits with
    status ``128+signum``, the conventional killed-by-signal code.
    """
    import os as _os
    import signal as _signal

    if signals is None:
        signals = (_signal.SIGTERM, _signal.SIGINT)

    draining = threading.Event()

    def _handler(signum, frame):
        if draining.is_set():
            _os.write(2, b"second signal during drain: forcing exit\n")
            _os._exit(128 + signum)
        draining.set()
        threading.Thread(
            target=server.shutdown_gracefully, name="ocr-drain", daemon=True
        ).start()

    for s in signals:
        _signal.signal(s, _handler)


def install_hot_reload(
    server: OCRServer,
    build_predict_fn: Callable[[], Callable[[List[Any]], List[str]]],
    signals=None,
) -> None:
    """Route SIGHUP to a zero-downtime engine reload.

    The production upgrade story: the operator replaces the checkpoint on
    disk and sends SIGHUP; the daemon builds the NEW engine on a helper
    thread while the old one keeps serving, then swaps atomically
    (:meth:`OCRServer.swap_predict_fn`) — no process restart, no dropped
    requests, no cold-start window for clients.

    ``build_predict_fn`` re-reads the deployment unit from disk and
    returns the new ``list -> list[str]`` callable, or a ``(callable,
    max_batch)`` pair when the new engine's device batch differs — the
    batcher re-sizes from the next batch on.  Run any warmup INSIDE the
    build (one dummy predict builds and warms the new engine on this
    helper thread instead of stalling the dispatcher —
    ``python -m rcnn_ocr_tpu_torch.serve`` does).  A FAILED build never
    touches the running engine: the error is logged to stderr and serving
    continues on the old one — a bad checkpoint push must not take the
    daemon down.
    Concurrent signals coalesce (one reload at a time; signals during a
    reload are dropped — send another after it finishes).
    """
    import os as _os
    import signal as _signal

    if signals is None:
        signals = (_signal.SIGHUP,)

    reload_gate = threading.Lock()

    def _work():
        if not reload_gate.acquire(blocking=False):
            _os.write(2, b"reload already in progress: signal ignored\n")
            return
        try:
            built = build_predict_fn()
            fn, mb = built if isinstance(built, tuple) else (built, None)
            server.swap_predict_fn(fn, max_batch=mb)
            _os.write(2, b"engine reloaded\n")
        except BaseException as e:
            msg = (
                "engine reload FAILED (serving continues on the old "
                f"engine): {type(e).__name__}: {e}\n"
            )
            _os.write(2, msg.encode("utf-8", "replace"))
        finally:
            reload_gate.release()

    def _handler(signum, frame):
        threading.Thread(target=_work, name="ocr-reload", daemon=True).start()

    for s in signals:
        _signal.signal(s, _handler)


def serving_predict_fn(
    engine,
    method: str = "ctc_greedy",
    batch_size: int = 256,
    canvas=(64, 512),
    max_length: int = 25,
    beam_width: int = 16,
    length_penalty: float = 0.0,
    lm_weight: float = 0.0,
    merge: str = "align",  # attention_long*: junction merge policy
    min_gap: int = 3,  # hybrid_long*: blank frames that split segments
    margin: int = 1,  # hybrid_long*: context frames around each segment
    tile_w: Optional[int] = None,  # *_long: tile width (default engine img_w)
    overlap: Optional[int] = None,  # *_long: junction overlap px
    snap: str = "midpoint",  # ctc_long*: junction cuts "midpoint" | "blank"
    return_confidence: bool = False,  # (text, conf) pairs
) -> Callable[[List[Any]], List[str]]:
    """Adapt an engine to the batcher's ``list -> list[str]`` contract.

    A :class:`~rcnn_ocr_tpu_torch.export.ServingArtifact` already matches
    (its decode is baked in: the other kwargs are not read); the port's
    ``OCRInference`` gets its ``predict_serving`` (or long-line) kwargs
    pinned here so every dispatched batch runs the same decode.  With
    ``return_confidence`` the fn yields ``(text, confidence)`` pairs
    (``OCRServer(confidence=True)`` formats them), refused at construction
    for methods with no confidence contract, as the engines refuse them
    (for an artifact, also one exported without the CTC confidence
    outputs).  Knobs a method would drop are refused at construction too.
    Any other engine raises ``TypeError``.
    """
    from rcnn_ocr_tpu_torch.export import ServingArtifact
    from rcnn_ocr_tpu_torch.inference import OCRInference

    # every decode method carries a confidence contract EXCEPT the tiled
    # attention merge (junction-merged decodes have no step-aligned
    # confidence)
    NO_CONF_METHODS = ("attention_long", "attention_long_beam")
    if isinstance(engine, ServingArtifact):
        if not return_confidence:
            return engine.predict
        if engine.method in NO_CONF_METHODS:
            raise ValueError(
                "return_confidence is not supported by tiled attention-merge "
                f"artifacts (got method={engine.method!r})"
            )
        # an artifact without the CTC confidence outputs refuses at server
        # start, not on the first request
        engine.predict([], return_confidence=True)

        def fn_art_conf(images: List[Any]):
            out = engine.predict(images, return_confidence=True)
            return out if isinstance(out, list) else [out]

        return fn_art_conf
    if not isinstance(engine, OCRInference):
        raise TypeError(
            "serving_predict_fn takes the port's OCRInference or ServingArtifact, "
            f"got {type(engine).__name__}"
        )
    if return_confidence and method in NO_CONF_METHODS:
        raise ValueError(
            f"return_confidence is not supported with method={method!r} "
            "(junction-merged tile decodes have no step-aligned confidence)"
        )

    long_method = method.startswith(("ctc_long", "attention_long", "hybrid_long"))
    # tiling knobs only steer the long routes — refuse them loudly on the
    # fixed-width paths instead of silently pinning an unused value
    if (tile_w is not None or overlap is not None) and not long_method:
        raise ValueError(
            f"tile_w/overlap are not supported with method={method!r} "
            "(fixed-width decode does not tile)"
        )
    # junction cuts exist only where frames are stitched (the CTC stitcher)
    if snap != "midpoint" and not method.startswith("ctc_long"):
        raise ValueError(f"snap is not supported with method={method!r}")

    if method in ("ctc_long", "ctc_long_beam"):
        # the stitched decode collapses on the host, which has no fusion /
        # rank-normalization hooks — refuse the knobs loudly instead of
        # starting a server with them silently off
        if lm_weight:
            raise ValueError(f"lm_weight is not supported with method={method!r}")
        if length_penalty:
            raise ValueError(
                f"length_penalty is not supported with method={method!r}"
            )

        # unbounded-width decode (predict_ctc_long): requests of wildly
        # different widths still share the per-tile static-shape kernel
        def fn_long(images: List[Any]):
            out = engine.predict_ctc_long(
                images,
                tile_w=tile_w,
                overlap=overlap,
                batch_size=batch_size,
                method="beam" if method == "ctc_long_beam" else "greedy",
                beam_width=beam_width,
                snap=snap,
                return_confidence=return_confidence,
            )
            return out if isinstance(out, list) else [out]

        return fn_long

    if method in ("hybrid_long", "hybrid_long_beam"):
        # CTC-segment + attention-read (predict_hybrid_long): the beam
        # flavor decodes segments with the device beam and carries the
        # fusion/rank knobs; greedy refuses them like every other path
        hybrid_beam = method == "hybrid_long_beam"
        if lm_weight and not hybrid_beam:
            raise ValueError(f"lm_weight is not supported with method={method!r}")
        if length_penalty and not hybrid_beam:
            raise ValueError(
                f"length_penalty is not supported with method={method!r}"
            )

        def fn_hybrid(images: List[Any]) -> List[str]:
            out = engine.predict_hybrid_long(
                images,
                tile_w=tile_w,
                overlap=overlap,
                batch_size=batch_size,
                max_length=max_length,
                beam=hybrid_beam,
                beam_width=beam_width,
                length_penalty=length_penalty,
                lm_weight=lm_weight,
                min_gap=min_gap,
                margin=margin,
                return_confidence=return_confidence,
            )
            return out if isinstance(out, list) else [out]

        return fn_hybrid

    if method in ("attention_long", "attention_long_beam"):
        # attention-head long lines: per-tile seq2seq decode + junction
        # merge (predict_long) — frame-aligned by the decoder's attention
        # positions by default, text-space with merge="text".  The
        # per-tile BEAM kernel carries the fusion/rank knobs; the greedy
        # variant has none to carry.
        attn_long_beam = method == "attention_long_beam"
        if lm_weight and not attn_long_beam:
            raise ValueError(f"lm_weight is not supported with method={method!r}")
        if length_penalty and not attn_long_beam:
            raise ValueError(
                f"length_penalty is not supported with method={method!r}"
            )
        # fail at server START, not on every request: the aligned merge
        # needs a frame-aligned tile width (the --tile-w override or the
        # engine img_w default)
        from rcnn_ocr_tpu_torch.long_lines import resolve_tiling

        resolve_tiling(
            engine.img_w, tile_w, overlap,
            require_frame_aligned=(merge == "align"),
        )

        def fn_attn_long(images: List[Any]) -> List[str]:
            out = engine.predict_long(
                images,
                method="attention_beam" if attn_long_beam else "attention",
                tile_w=tile_w,
                overlap=overlap,
                batch_size=batch_size,
                max_length=max_length,
                beam_width=beam_width,
                length_penalty=length_penalty,
                lm_weight=lm_weight,
                merge=merge,
            )
            return out if isinstance(out, list) else [out]

        return fn_attn_long

    def fn(images: List[Any]) -> List[str]:
        out = engine.predict_serving(
            images,
            method=method,
            batch_size=batch_size,
            canvas=canvas,
            max_length=max_length,
            beam_width=beam_width,
            length_penalty=length_penalty,
            lm_weight=lm_weight,
            return_confidence=return_confidence,
        )
        return out if isinstance(out, list) else [out]

    return fn
