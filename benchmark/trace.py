"""The traced window: a ``torch.profiler`` capture of the card and the host,
reduced to what the per-layer readers and the breakdown need.

Device busy time is the union of the intervals in which a kernel, a copy or
a memset ran on the card (so kernels that overlap count once), clipped to
the window, which is the benchmark's own ``bench.window`` span.  Idle gaps
are the window's stretches outside that union; each is named by what the
host was doing at its middle: the innermost operator or benchmark span
running then on any thread.  Kernel time by class (convolutions, K1, K2)
sums the kernels whose names match ``kernel_classes.json``.
"""

from __future__ import annotations

import contextlib
import json
import re
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

WINDOW = "bench.window"
SPANS = (WINDOW, "predict_serving")  # the benchmark's own spans
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation")
CLASSES = json.loads((Path(__file__).parent / "kernel_classes.json").read_text())
NAME_CHARS = 120


def span(name: str):
    """A benchmark span (one of ``SPANS``) around one call into a layer
    (recorded when traced)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def window(trace: bool) -> Iterator[dict]:
    """The measured window; with ``trace`` a profiler capture of it.  The
    yielded dict gets ``events`` (the profiler's events) after the block."""
    out: dict = {}
    if not trace:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span(WINDOW):
            yield out
            torch.cuda.synchronize()
    out["events"] = list(prof.profiler.kineto_results.events())


def union_seconds(intervals: np.ndarray) -> Tuple[float, np.ndarray]:
    """``(covered seconds, merged [N, 2])`` of ``[N, 2]`` ns intervals."""
    if len(intervals) == 0:
        return 0.0, np.zeros((0, 2), np.int64)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    starts_new = np.ones(len(iv), bool)
    starts_new[1:] = iv[1:, 0] > ends[:-1]
    idx = np.flatnonzero(starts_new)
    merged = np.stack([iv[idx, 0], np.append(ends[idx[1:] - 1], ends[-1])], axis=1)
    return float((merged[:, 1] - merged[:, 0]).sum()) / 1e9, merged


def kernel_class(name: str) -> Optional[str]:
    for cls, patterns in CLASSES.items():
        if any(re.search(p, name) for p in patterns):
            return cls
    return None


def _kind(e) -> str:
    """The event's activity: ``kernel`` for any device operation (a kernel, a
    copy, a memset), ``user_annotation`` for a span, ``cpu_op`` for any other
    host event; ``gpu_user_annotation`` for a span mirrored on the device."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    span_ = getattr(e, "is_user_annotation", lambda: False)()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if span_ else "kernel"
    return "user_annotation" if span_ else "cpu_op"


def reduce(events) -> dict:
    """``window_s``, ``busy_s``, ``class_seconds`` and the ``breakdown`` of a
    :func:`window` capture."""
    win = [e for e in events if e.name() == WINDOW and _kind(e) in HOST_ACTIVITIES]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev, names, host, host_names = [], [], [], []
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_ACTIVITIES and e.name() not in SPANS:
            s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if t > s:
                dev.append((s, t))
                names.append(e.name())
        elif kind in HOST_ACTIVITIES and e.name() != WINDOW:
            host.append((e.start_ns(), e.end_ns()))
            host_names.append(e.name())
    dev_iv = np.array(dev, np.int64).reshape(-1, 2)
    busy_s, merged = union_seconds(dev_iv)
    window_s = (w1 - w0) / 1e9

    by_name: Dict[str, float] = {}
    by_class: Dict[str, float] = {cls: 0.0 for cls in CLASSES}
    durations = (dev_iv[:, 1] - dev_iv[:, 0]) / 1e9
    cls_of: Dict[str, Optional[str]] = {}
    for name, d in zip(names, durations):
        by_name[name] = by_name.get(name, 0.0) + float(d)
        if name not in cls_of:
            cls_of[name] = kernel_class(name)
        if cls_of[name] is not None:
            by_class[cls_of[name]] += float(d)

    # idle gaps: the window less the merged busy intervals
    edges = np.concatenate([[w0], merged.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:10]]
    host_iv = np.array(host, np.int64).reshape(-1, 2)
    idle = []
    for g0, g1 in longest:
        mid = (g0 + g1) // 2
        covering = np.flatnonzero((host_iv[:, 0] <= mid) & (host_iv[:, 1] >= mid))
        if len(covering):
            inner = covering[np.argmax(host_iv[covering, 0])]
            label = host_names[inner]
        else:
            label = "no host operator or span (waiting or in Python)"
        idle.append([label[:NAME_CHARS], float(g1 - g0) / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy_s, "class_seconds": by_class,
            "kernels": len(dev), "breakdown": {
                "device_ops": [[n[:NAME_CHARS], s] for n, s in top], "idle_gaps": idle}}

