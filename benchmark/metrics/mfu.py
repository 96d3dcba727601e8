"""Percent of the card's bf16 dense peak that the window's model operations
fill: the configuration's operations per line (convs, squeeze-excite,
BiLSTMs, the head's configured steps) times the lines, over the window."""

from benchmark import flops


def read(ctx):
    return flops.mfu(ctx)
