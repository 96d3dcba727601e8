"""Step timing and device traces.

Counterpart of ``rcnn_ocr_tpu/utils/profiling.py``: :class:`StepTimer` is
the same host-side ring buffer of step times; :func:`trace` becomes a
``torch.profiler`` capture (JAX's wraps ``jax.profiler``).  The training
loop's ``profile_steps`` key opens it over a window of steps.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


class TraceSummary:
    """What a :func:`trace` window saw: its wall seconds, the device's busy
    seconds (kernel time summed by ``torch.profiler``; ``None`` when it saw
    no device), the idle share ``1 - busy / wall``, and the seconds the
    profiler then took to process its events (outside the window)."""

    def __init__(self):
        self.wall_s: Optional[float] = None
        self.device_busy_s: Optional[float] = None
        self.kernels: int = 0
        self.processing_s: Optional[float] = None

    @property
    def device_idle_share(self) -> Optional[float]:
        if not self.wall_s or self.device_busy_s is None:
            return None
        return 1.0 - self.device_busy_s / self.wall_s

    def as_dict(self) -> dict:
        return {"wall_s": self.wall_s, "device_busy_s": self.device_busy_s,
                "kernels": self.kernels, "device_idle_share": self.device_idle_share,
                "processing_s": self.processing_s}


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[TraceSummary]:
    """Profile the enclosed work with ``torch.profiler`` (the card's kernels
    when a card is present, else the CPU's operators); on exit, write the
    per-kernel table to ``log_dir/profile_summary.txt`` and fill the
    yielded summary."""
    summary = TraceSummary()
    if not enabled:
        yield summary
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield summary
        if cuda:
            torch.cuda.synchronize()
        summary.wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    if cuda:
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        summary.device_busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
        summary.kernels = sum(e.count for e in kernels)
    os.makedirs(log_dir, exist_ok=True)
    sort = "self_device_time_total" if cuda else "self_cpu_time_total"
    with open(os.path.join(log_dir, "profile_summary.txt"), "w", encoding="utf-8") as f:
        f.write(events.table(sort_by=sort, row_limit=60))
    summary.processing_s = time.perf_counter() - t0 - summary.wall_s


class StepTimer:
    """Rolling step-time statistics (mean / p50 / p95, images/sec)."""

    def __init__(self, window: int = 200):
        self.window = window
        self._times: list = []
        self._images: list = []
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self, n_images: int = 0) -> float:
        if self._last is None:
            return 0.0
        dt = time.perf_counter() - self._last
        self._last = None
        self._times.append(dt)
        self._images.append(n_images)
        if len(self._times) > self.window:
            self._times.pop(0)
            self._images.pop(0)
        return dt

    @property
    def count(self) -> int:
        return len(self._times)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        t = np.asarray(self._times)
        imgs = float(np.sum(self._images))
        return {
            "steps": len(t),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
            "images_per_sec": imgs / float(t.sum()) if t.sum() > 0 else 0.0,
        }
