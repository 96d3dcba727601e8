"""Percent of the window the letterbox worker was busy: host seconds in the
program's ``serving.letterbox`` spans (``_to_rgb``, ``pad_rows``, the C++
letterbox, the geometry) over the window; 100 less it is the host input's
headroom."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, "serving.letterbox")
