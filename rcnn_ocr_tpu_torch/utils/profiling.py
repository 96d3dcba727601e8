"""Step timing, spans and device traces.

Counterpart of ``rcnn_ocr_tpu/utils/profiling.py``: :class:`StepTimer` is
the same host-side ring buffer of step times; :func:`trace` becomes a
``torch.profiler`` capture (JAX's wraps ``jax.profiler``).  The training
loop's ``profile_steps`` key opens it over a window of steps.

:class:`span` is the program's one kind of span.  While no profiler runs it
reads one global and records nothing; while one runs (a :func:`trace`, or
any ``torch.profiler.profile``) it opens a ``record_function`` of its name,
so the capture holds it on the thread the capture watches, and keeps a
record in this module's store on every thread: name, thread, parent span,
start and end on ``time.time_ns()`` (the capture's clock, so stored spans
of any thread can be set against the capture's device intervals), its
counts and, for a device range, two CUDA events on the current stream.
:func:`spans` reads the store, :func:`host_seconds` and
:func:`device_seconds` total it by name, :func:`clear` empties it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

# the store holds at most this many spans; the rest are counted in `dropped()`
MAX_SPANS = 1 << 17
# the device activities whose union is the device's busy time
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")

_records: List["_Record"] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()


class _Record:
    __slots__ = ("id", "name", "thread", "parent", "start_ns", "end_ns", "counts", "events")

    def __init__(self, name: str, parent: Optional[int], counts: dict):
        self.id = next(_ids)
        self.name = name
        self.thread = threading.get_ident()
        self.parent = parent
        self.counts = counts
        self.start_ns: int = 0
        self.end_ns: Optional[int] = None
        self.events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None


class span:
    """``with span(name, device=None, **counts):`` one span of the program.

    ``device``: the ``torch.device`` whose current stream times the range
    (a CUDA device records a start and an end event there; ``None`` or a
    CPU device: host time only).  A range's device seconds are the time
    between its two events on the stream, which includes any time the
    device waited inside the range for the host to launch work.  ``counts``
    are numbers stored with the span (rows, a call id, a chunk index).
    Gated: while no profiler runs, entering and leaving read
    ``torch.autograd.profiler._is_profiler_enabled`` and do nothing else.
    """

    __slots__ = ("name", "device", "counts", "_record", "_function")

    def __init__(self, name: str, device: Optional[torch.device] = None, **counts):
        self.name = name
        self.device = device
        self.counts = counts
        self._record: Optional[_Record] = None
        self._function = None

    def __enter__(self) -> "span":
        if not _autograd_profiler._is_profiler_enabled:
            return self
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        record = _Record(self.name, stack[-1].id if stack else None, self.counts)
        if _keep(record):
            self._record = record
            stack.append(record)
        self._function = torch.profiler.record_function(self.name)
        record.start_ns = time.time_ns()
        self._function.__enter__()
        if self._record is not None and self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            record.events = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
            record.events[0].record(stream)
        return self

    def __exit__(self, *exc) -> None:
        if self._function is None:
            return
        record = self._record
        if record is not None and record.events is not None:
            record.events[1].record(torch.cuda.current_stream(self.device))
        self._function.__exit__(*exc)
        if record is not None:
            record.end_ns = time.time_ns()
            _local.stack.pop()


def _keep(record: _Record) -> bool:
    global _dropped
    with _lock:
        if len(_records) >= MAX_SPANS:
            _dropped += 1
            return False
        _records.append(record)
        return True


def clear() -> None:
    """Empty the store and its count of dropped spans."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def dropped() -> int:
    """Spans not stored since the last :func:`clear`: the store was full."""
    return _dropped


def spans() -> List[dict]:
    """The stored spans, each ``{id, name, thread, parent, start_ns, end_ns,
    counts, device_s}`` (``end_ns`` None while open; ``device_s`` None
    unless a closed device range).  A range's events are read here: call
    it after the work has been synchronized."""
    with _lock:
        records = list(_records)
    out = []
    for r in records:
        device_s = None
        if r.events is not None and r.end_ns is not None:
            r.events[1].synchronize()
            device_s = r.events[0].elapsed_time(r.events[1]) / 1e3
        out.append({"id": r.id, "name": r.name, "thread": r.thread, "parent": r.parent,
                    "start_ns": r.start_ns, "end_ns": r.end_ns, "counts": dict(r.counts),
                    "device_s": device_s})
    return out


def host_seconds(name: str, records: Optional[List[dict]] = None) -> Optional[float]:
    """Host seconds of the closed spans named ``name`` (None: there are none)."""
    closed = [r for r in (spans() if records is None else records)
              if r["name"] == name and r["end_ns"] is not None]
    if not closed:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in closed) / 1e9


def device_seconds(name: str, records: Optional[List[dict]] = None) -> Optional[float]:
    """Device seconds of the ranges named ``name`` (None: there are none)."""
    timed = [r["device_s"] for r in (spans() if records is None else records)
             if r["name"] == name and r["device_s"] is not None]
    return sum(timed) if timed else None


def span_totals(records: Optional[List[dict]] = None) -> Dict[str, dict]:
    """Per span name: ``{count, host_s, device_s}`` (``device_s`` None for
    host-only spans)."""
    records = spans() if records is None else records
    return {name: {"count": sum(r["name"] == name for r in records),
                   "host_s": host_seconds(name, records),
                   "device_s": device_seconds(name, records)}
            for name in sorted({r["name"] for r in records})}


def busy_seconds(intervals: Iterable[Tuple[str, int, int]]) -> float:
    """Seconds covered by the union of the ``(activity, start_ns, end_ns)``
    intervals whose activity is a kernel, a copy or a memset: overlapping
    device work counts once."""
    iv = np.array([(s, e) for kind, s, e in intervals if kind in DEVICE_ACTIVITIES and e > s],
                  np.int64).reshape(-1, 2)
    if len(iv) == 0:
        return 0.0
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    # each interval adds what lies past every earlier-starting interval's end
    reach = np.concatenate([iv[:1, 0], np.maximum.accumulate(iv[:, 1])[:-1]])
    return float(np.maximum(iv[:, 1] - np.maximum(iv[:, 0], reach), 0).sum()) / 1e9


def _activity(event) -> str:
    """A kineto event's activity (``kernel``, ``gpu_memcpy``, ``gpu_memset``,
    ``user_annotation``, ``gpu_user_annotation``, ``cpu_op``), from the
    event's device, its annotation flag and CUPTI's names of copies
    (``Memcpy ...``) and memsets (``Memset ...``): every torch the port runs
    on gives these, where not every one has ``activity_type()``."""
    annotation = event.is_user_annotation()
    if event.device_type() != torch.autograd.DeviceType.CUDA:
        return "user_annotation" if annotation else "cpu_op"
    if annotation:
        return "gpu_user_annotation"
    name = event.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else \
        "gpu_memset" if name.startswith("Memset") else "kernel"


class TraceSummary:
    """What a :func:`trace` window saw: its wall seconds, the device's busy
    seconds (the union of its kernel, copy and memset intervals, so
    overlapping work counts once; ``None`` when it saw no device), the idle
    share ``1 - busy / wall``, the kernels it counted (copies and memsets
    not among them), per span name the spans' count, host and device
    seconds (:func:`span_totals`; ``rcnn.encode`` / ``rcnn.decode`` split
    the model's device time), the spans the store dropped, and the seconds
    the profiler then took to process its events (outside the window)."""

    def __init__(self):
        self.wall_s: Optional[float] = None
        self.device_busy_s: Optional[float] = None
        self.kernels: int = 0
        self.spans: Dict[str, dict] = {}
        self.spans_dropped: int = 0
        self.processing_s: Optional[float] = None

    @property
    def device_idle_share(self) -> Optional[float]:
        if not self.wall_s or self.device_busy_s is None:
            return None
        return 1.0 - self.device_busy_s / self.wall_s

    def as_dict(self) -> dict:
        return {"wall_s": self.wall_s, "device_busy_s": self.device_busy_s,
                "kernels": self.kernels, "device_idle_share": self.device_idle_share,
                "spans": self.spans, "spans_dropped": self.spans_dropped,
                "processing_s": self.processing_s}


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[TraceSummary]:
    """Profile the enclosed work with ``torch.profiler`` (the card's kernels
    when a card is present, else the CPU's operators) and keep its spans
    (the store is emptied on entry); on exit, write the per-kernel table to
    ``log_dir/profile_summary.txt`` and fill the yielded summary."""
    summary = TraceSummary()
    if not enabled:
        yield summary
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
    clear()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield summary
        if cuda:
            torch.cuda.synchronize()
        summary.wall_s = time.perf_counter() - t0
    if cuda:
        device = [(_activity(e), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()]
        summary.device_busy_s = busy_seconds(device)
        summary.kernels = sum(kind == "kernel" for kind, _, _ in device)
    summary.spans = span_totals()
    summary.spans_dropped = dropped()
    events = prof.key_averages()
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
