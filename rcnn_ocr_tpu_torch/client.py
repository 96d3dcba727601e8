"""HTTP client for the serving daemon (stdlib and numpy only).

Counterpart of ``rcnn_ocr_tpu/client.py`` (``OCRClient``,
``OCRClientError``, ``main``), the consumer side of
:mod:`rcnn_ocr_tpu_torch.serving`:

    from rcnn_ocr_tpu_torch.client import OCRClient

    client = OCRClient("http://gpu-host:8000")
    client.wait_ready()                    # cover the daemon's start-up
    texts = client.predict(["a.png", img_array, jpeg_bytes])

* ``predict`` accepts paths, raw encoded bytes, and uint8 numpy arrays;
  everything ships as ONE JSON base64 batch so the server's micro-batcher
  sees the whole request at once.  Arrays are PNG-encoded losslessly by
  :func:`rcnn_ocr_tpu_torch.data.image_io.png_encode`, in the JAX client's
  channel order: it hands arrays to ``cv2.imencode``, which takes them as
  BGR, so a 3-channel array goes on the wire with its channels reversed
  (and a 4-channel one as BGRA).  Both clients put the same pixels on the
  wire for the same array.
* 503 is the daemon's RETRYABLE status (queue full, draining) — the
  client retries it with exponential backoff.  500/400/404 are not
  retried: they mean the request itself is bad.
* ``wait_ready`` polls ``/healthz`` until the daemon answers, so deploy
  scripts need no sleep loop.

Also a CLI: ``python -m rcnn_ocr_tpu_torch.client http://host:8000 img1.png
...`` prints one decoded line per image.
"""

from __future__ import annotations

import base64
import json
import os
import time
import urllib.error
import urllib.request
from typing import Any, List, Optional


class OCRClientError(RuntimeError):
    """A request failed permanently (non-retryable status or retries
    exhausted).  ``status`` carries the last HTTP code (None for
    transport errors)."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


def _encode_image(image: Any) -> bytes:
    """Image -> encoded bytes: pass through ``bytes``, read paths, and
    PNG-encode uint8 arrays (lossless, so the server's decode is exact)."""
    if isinstance(image, (bytes, bytearray)):
        return bytes(image)
    if isinstance(image, (str, os.PathLike)):
        with open(image, "rb") as f:
            return f.read()
    import numpy as np

    from rcnn_ocr_tpu_torch.data.image_io import png_encode

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise TypeError(
            f"array images must be uint8 (got {arr.dtype}); encode or "
            "convert before sending"
        )
    # the JAX client's cv2.imencode reads colour arrays as BGR(A): write the
    # same PNG pixels it writes
    if arr.ndim == 3 and arr.shape[2] == 3:
        arr = arr[:, :, ::-1]
    elif arr.ndim == 3 and arr.shape[2] == 4:
        arr = arr[:, :, [2, 1, 0, 3]]
    return png_encode(np.ascontiguousarray(arr))


class OCRClient:
    """Client for one daemon endpoint.

    ``timeout_s`` is the per-request socket timeout — keep it above the
    server's coalescing window + decode time (its own request timeout
    defaults to 120 s).  503s retry up to ``max_retries`` times with
    exponential backoff starting at ``backoff_s``.
    """

    def __init__(
        self,
        base_url: str,
        timeout_s: float = 120.0,
        max_retries: int = 3,
        backoff_s: float = 0.5,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)

    # -- raw HTTP ------------------------------------------------------------
    def _request(
        self, path: str, body: Optional[bytes] = None, ctype: str = ""
    ) -> tuple:
        req = urllib.request.Request(self.base_url + path, data=body)
        if ctype:
            req.add_header("Content-Type", ctype)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def _json(self, status: int, raw: bytes) -> dict:
        try:
            return json.loads(raw)
        except Exception:
            raise OCRClientError(
                f"non-JSON response (HTTP {status}): {raw[:200]!r}",
                status=status,
            )

    # -- API -----------------------------------------------------------------
    def predict(
        self, images: List[Any], confidence: bool = False
    ) -> List[Any]:
        """Decode a batch of images (paths / encoded bytes / uint8 arrays).

        Ships one JSON base64 batch; retries the daemon's retryable 503s
        (queue full, draining) with exponential backoff; raises
        :class:`OCRClientError` on permanent failure.  With
        ``confidence=True`` returns ``(text, confidence)`` pairs — the
        daemon must have been started with ``--confidence`` (every
        method except the tiled attention merge), else this raises.
        """
        if not images:
            return []
        payload = json.dumps({
            "images": [
                base64.b64encode(_encode_image(im)).decode("ascii")
                for im in images
            ]
        }).encode("utf-8")
        attempt = 0
        while True:
            try:
                status, raw = self._request(
                    "/predict", payload, "application/json"
                )
            except OSError as e:  # connection refused / reset / timeout
                status, raw = None, repr(e).encode()
            if status == 200:
                out = self._json(status, raw)
                texts = out.get("texts")
                if not isinstance(texts, list) or len(texts) != len(images):
                    raise OCRClientError(
                        f"malformed response: {out!r}", status=status
                    )
                if confidence:
                    confs = out.get("confidences")
                    if not isinstance(confs, list) or len(confs) != len(texts):
                        raise OCRClientError(
                            "server returned no confidences — start the "
                            "daemon with --confidence",
                            status=status,
                        )
                    return list(zip(texts, confs))
                return texts
            retryable = status in (503, None)
            if not retryable or attempt >= self.max_retries:
                raise OCRClientError(
                    f"predict failed (HTTP {status}): {raw[:200]!r}",
                    status=status,
                )
            time.sleep(self.backoff_s * (2 ** attempt))
            attempt += 1

    def health(self) -> dict:
        """``GET /healthz`` as a dict (raises on non-200)."""
        status, raw = self._request("/healthz")
        out = self._json(status, raw)
        if status != 200:
            raise OCRClientError(f"healthz: HTTP {status}: {out}", status=status)
        return out

    def metrics(self) -> str:
        """``GET /metrics`` — the Prometheus text exposition."""
        status, raw = self._request("/metrics")
        if status != 200:
            raise OCRClientError(f"metrics: HTTP {status}", status=status)
        return raw.decode("utf-8")

    def wait_ready(self, timeout_s: float = 600.0, poll_s: float = 1.0) -> dict:
        """Poll ``/healthz`` until the daemon answers ``ok`` (not
        draining); returns the health dict."""
        deadline = time.monotonic() + timeout_s
        last: Any = None
        while time.monotonic() < deadline:
            try:
                out = self.health()
                if out.get("status") == "ok":
                    return out
                last = out
            except (OCRClientError, OSError) as e:
                last = e
            time.sleep(poll_s)
        raise OCRClientError(f"daemon not ready after {timeout_s}s: {last!r}")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Decode images against a serving daemon",
        prog="python -m rcnn_ocr_tpu_torch.client",
    )
    p.add_argument("url", help="daemon base URL, e.g. http://host:8000")
    p.add_argument("images", nargs="+", help="image files to decode")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument(
        "--wait-ready", action="store_true",
        help="poll /healthz until the daemon is up before predicting",
    )
    args = p.parse_args(argv)
    client = OCRClient(args.url, timeout_s=args.timeout)
    if args.wait_ready:
        client.wait_ready()
    try:
        texts = client.predict(list(args.images))
    except OCRClientError as e:
        print(f"error: {e}")
        return 1
    for path, text in zip(args.images, texts):
        print(f"{path}\t{text}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
