"""Percent of the window the caller's thread spent turning decoded rows into
text: host seconds in the program's ``serving.strings`` spans over the
window.  While it runs, nothing new is queued on the card."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, "serving.strings")
