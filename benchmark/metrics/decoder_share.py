"""Percent of the window inside the decoder's device ranges: the seconds
between the two CUDA events of each of the program's ``rcnn.decode`` ranges
(everything after the encoder up to the kernel's outputs: the attention
loop with its argmax and softmax, or the CTC projection and greedy
collapse), summed, over the window.  A range counts any time the card
waited inside it for the host to launch work."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, "rcnn.decode", device=True)
