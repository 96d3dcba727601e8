"""Percent of the window in which no kernel, copy or memset ran on the card
(1 - busy / window, busy the union of the device intervals)."""


def read(ctx):
    if ctx["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
