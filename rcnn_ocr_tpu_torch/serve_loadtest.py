"""Concurrent load generator for the serving daemon.

Drives ``python -m rcnn_ocr_tpu_torch.serve`` the way production traffic
does (many parallel HTTP clients, one image per request) and reports
client-side throughput and latency percentiles beside the server's own
``/metrics`` deltas, so micro-batching shows (the server's batch size
climbing with concurrency while per-request latency stays bounded):

    python -m rcnn_ocr_tpu_torch.serve_loadtest --url http://127.0.0.1:8000 \\
        --image line.png --requests 200 --concurrency 16

The port's copy of the JAX package's ``tools/serve_loadtest.py``: the same
arguments, ``run_loadtest`` and final JSON line, standard library only.
With ``--image`` omitted a synthetic text-line PNG is generated (dark
glyph-like bars on white, written by this module's own PNG encoder where
the JAX tool draws text with cv2).  Prints one JSON line (machine-readable)
after the human summary.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import threading
import time
import urllib.request
import zlib


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read().decode()


def _metric(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return 0.0


def _synthetic_png(height: int = 64, width: int = 512) -> bytes:
    """A white RGB line with 19 dark bars where a text would stand, as a PNG
    (filter None on every row)."""
    white, ink = b"\xff\xff\xff", b"\x20\x20\x20"
    rows = []
    for y in range(height):
        row = bytearray(white * width)
        if 12 <= y < 52:
            for k in range(19):  # "loadtest 0123456789": one bar a character
                x0 = 8 + 26 * k
                row[3 * x0: 3 * (x0 + 14)] = ink * 14
        rows.append(b"\x00" + bytes(row))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(rows), 6)) + chunk(b"IEND", b""))


def run_loadtest(
    url: str, body: bytes, n_requests: int, concurrency: int,
) -> dict:
    """Fire ``n_requests`` POST /predict from ``concurrency`` threads."""
    latencies: list = []
    errors: list = []
    lock = threading.Lock()
    remaining = [n_requests]

    def worker() -> None:
        while True:
            with lock:
                if remaining[0] <= 0:
                    return
                remaining[0] -= 1
            req = urllib.request.Request(
                url + "/predict", data=body,
                headers={"Content-Type": "image/png"}, method="POST",
            )
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    json.loads(resp.read())
                with lock:
                    latencies.append(time.perf_counter() - t0)
            except Exception as e:  # count, keep loading
                with lock:
                    errors.append(str(e))

    before = _get(url + "/metrics")
    threads = [
        threading.Thread(target=worker, daemon=True)
        for _ in range(concurrency)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    after = _get(url + "/metrics")

    lats = sorted(latencies)
    return {
        "requests": n_requests,
        "concurrency": concurrency,
        "ok": len(latencies),
        "errors": len(errors),
        "error_samples": errors[:3],
        "wall_s": round(wall, 3),
        "rps": round(len(latencies) / wall, 1) if wall else 0.0,
        "latency_ms": {
            "p50": round(_percentile(lats, 0.50) * 1e3, 1),
            "p95": round(_percentile(lats, 0.95) * 1e3, 1),
            "p99": round(_percentile(lats, 0.99) * 1e3, 1),
        },
        "server": {
            "images_served": int(
                _metric(after, "ocr_served_images_total")
                - _metric(before, "ocr_served_images_total")
            ),
            "engine_batches": int(
                _metric(after, "ocr_engine_batches_total")
                - _metric(before, "ocr_engine_batches_total")
            ),
            "engine_errors": int(
                _metric(after, "ocr_engine_batch_errors_total")
                - _metric(before, "ocr_engine_batch_errors_total")
            ),
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                prog="python -m rcnn_ocr_tpu_torch.serve_loadtest")
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("--image", default=None, help="image file to POST (default: synthetic)")
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--concurrency", type=int, default=16)
    args = p.parse_args(argv)

    if args.image:
        with open(args.image, "rb") as f:
            body = f.read()
    else:
        body = _synthetic_png()
    result = run_loadtest(args.url, body, args.requests, args.concurrency)

    srv = result["server"]
    batches = srv["engine_batches"]
    mean_batch = srv["images_served"] / batches if batches else 0.0
    print(
        f"[loadtest] {result['ok']}/{result['requests']} ok, "
        f"{result['errors']} errors, {result['rps']} req/s over "
        f"{result['wall_s']} s at concurrency {result['concurrency']}"
    )
    print(
        f"[loadtest] client latency ms p50/p95/p99 = "
        f"{result['latency_ms']['p50']}/{result['latency_ms']['p95']}/"
        f"{result['latency_ms']['p99']}"
    )
    print(
        f"[loadtest] server: {srv['images_served']} images in "
        f"{batches} engine batches (mean batch {mean_batch:.1f}), "
        f"{srv['engine_errors']} engine errors"
    )
    print(json.dumps(result), flush=True)
    return 0 if result["errors"] == 0 and result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
