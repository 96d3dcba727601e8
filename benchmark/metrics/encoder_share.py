"""Percent of the window inside the encoder's device ranges: the seconds
between the two CUDA events of each of the program's ``rcnn.encode`` ranges
(CNN, height mean, BiLSTMs), summed, over the window.  A range counts any
time the card waited inside it for the host to launch work."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, "rcnn.encode", device=True)
