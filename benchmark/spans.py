"""The program's own spans, read after a traced window.

``rcnn_ocr_tpu_torch.utils.profiling`` keeps a span store while a profiler
runs; in a ``--trace 1`` run it holds exactly the window (the warm-up and
the judge run with the profiler off).  :func:`share` gives the host or the
device seconds of one span name as a percent of the window, or ``None``
where there is nothing to read: a program without the store, a name it
never recorded, device ranges on the CPU.
"""

from __future__ import annotations

from typing import Optional


def share(ctx: dict, name: str, device: bool = False) -> Optional[float]:
    """Percent of ``ctx["window_s"]`` spent in the spans named ``name``:
    their host seconds (on whichever thread), or with ``device`` the device
    seconds between each range's two events."""
    try:
        from rcnn_ocr_tpu_torch.utils import profiling
    except ImportError:
        return None
    total = getattr(profiling, "device_seconds" if device else "host_seconds", None)
    if total is None or ctx["window_s"] <= 0.0:
        return None
    seconds = total(name)
    return None if seconds is None else 100.0 * seconds / ctx["window_s"]
