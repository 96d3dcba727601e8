"""Percent of its roofline reached by K2, the BiLSTM recurrence
kernel (csrc/bilstm_scan.cu): the least time the window's calls could take
(each call's operations over the peak rate or its bytes over the peak
bandwidth, the larger) over the time its kernels took."""

from benchmark import flops


def read(ctx):
    return flops.roofline_share(ctx, "k2")
