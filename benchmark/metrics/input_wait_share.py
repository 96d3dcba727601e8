"""Percent of the window the caller's thread waited for the worker's next
letterbox: host seconds in the program's ``serving.input_wait`` spans over
the window (the host input on the critical path)."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, "serving.input_wait")
