"""Operations and bytes from shapes: the yardstick of the rooflines and of
``mfu``.

Operations count every multiply-add of a matrix product or convolution as
two (as ``torch.utils.flop_counter`` does); element-wise work is not
counted.  Bytes count each input read once and each output written once in
the dtype the program keeps it in (bf16 activations and weights, the BiLSTM
scan's fp32 gate inputs and states), whatever a kernel reads again.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark.reference import rcnn

BF16, FP32 = 2, 4


def encode_flops(cfg: dict) -> int:
    """Operations of one line's encode: convs, squeeze-excite, the BiLSTMs."""
    total = sum(conv_flops(c) for c in rcnn.conv_specs(cfg))
    total += sum(4 * s["c"] * s["squeeze"] for s in rcnn.se_specs(cfg))
    t, hid, d = rcnn.frames(cfg), cfg["hidden_size"], 512
    for _ in range(cfg["lstm_layers"]):
        # input projection and recurrence, both directions; output projection
        total += 2 * (2 * t * d * 4 * hid) + 2 * (2 * t * hid * 4 * hid) + 2 * t * 2 * hid * hid
        d = hid
    return total


def head_flops(cfg: dict, head: str, steps: int) -> int:
    """Operations of one line's head: ``ctc``, or ``attention`` over ``steps``."""
    t, hid, v = rcnn.frames(cfg), cfg["hidden_size"], cfg["num_classes"]
    if head == "ctc":
        return 2 * t * hid * v
    keys = 2 * t * hid * hid
    step = 2 * hid * hid + 2 * t * hid + 2 * t * hid + 2 * 2 * hid * 4 * hid + 2 * hid * v
    return keys + steps * step


def line_flops(cfg: dict, head: str, steps: int) -> int:
    return encode_flops(cfg) + head_flops(cfg, head, steps)


def conv_flops(c: dict) -> int:
    return 2 * c["ho"] * c["wo"] * c["cout"] * c["cin"] * c["k"][0] * c["k"][1]


def conv_calls(cfg: dict, batch: int) -> List[Tuple[int, int]]:
    """(operations, bytes) of each convolution of one encode at ``batch``."""
    out = []
    for c in rcnn.conv_specs(cfg):
        nbytes = BF16 * (batch * (c["cin"] * c["h"] * c["w"] + c["cout"] * c["ho"] * c["wo"])
                         + c["cout"] * c["cin"] * c["k"][0] * c["k"][1])
        out.append((batch * conv_flops(c), nbytes))
    return out


def se_calls(cfg: dict, batch: int) -> List[Tuple[int, int]]:
    """(operations, bytes) of each squeeze-excite (K1) launch of one encode:
    the mean, the two small products and the scaling; x read once and the
    result written once, the two gate weights read once."""
    out = []
    for s in rcnn.se_specs(cfg):
        act = batch * s["h"] * s["w"] * s["c"]
        flops = 2 * act + batch * 4 * s["c"] * s["squeeze"]
        out.append((flops, BF16 * (2 * act + 2 * s["c"] * s["squeeze"])))
    return out


def scan_calls(cfg: dict, batch: int) -> List[Tuple[int, int]]:
    """(operations, bytes) of each BiLSTM recurrence (K2) launch of one
    encode: both directions' ``h @ w_hh`` at every step; the fp32 gate inputs
    read and the fp32 states written once, ``w_hh`` read once."""
    t, hid = rcnn.frames(cfg), cfg["hidden_size"]
    flops = 2 * t * 2 * batch * hid * 4 * hid
    nbytes = FP32 * (t * 2 * batch * 4 * hid + t * 2 * batch * hid) + BF16 * 2 * hid * 4 * hid
    return [(flops, nbytes)] * cfg["lstm_layers"]


KERNEL_CALLS = {"conv": conv_calls, "k1": se_calls, "k2": scan_calls}


def least_seconds(calls: List[Tuple[int, int]], peaks: Dict[str, float]) -> float:
    """The least time the chip could take for these calls: each call's
    operations over the peak rate or its bytes over the peak bandwidth,
    whichever is longer."""
    return sum(max(f / peaks["flops"], b / peaks["bytes_per_s"]) for f, b in calls)


def peak(ctx: dict) -> Optional[Dict[str, float]]:
    """``{"flops", "bytes_per_s"}`` of the card at the configuration's dtype
    (None: the card or the dtype is not in ``peaks.json``)."""
    card = ctx["peaks"]
    if card is None or ctx["config"]["compute_dtype"] not in card["flops"]:
        return None
    return {"flops": card["flops"][ctx["config"]["compute_dtype"]],
            "bytes_per_s": card["bytes_per_s"]}


def roofline_share(ctx: dict, cls: str) -> Optional[float]:
    """Percent of the least time the window's ``cls`` calls could take on
    the card against the time its kernels took (None: nothing to read)."""
    peaks = peak(ctx)
    spent = ctx["class_seconds"].get(cls, 0.0)
    if peaks is None or spent <= 0.0 or not ctx["encodes"]:
        return None
    least = sum(n * least_seconds(KERNEL_CALLS[cls](ctx["config"], batch), peaks)
                for batch, n in ctx["encodes"].items())
    return 100.0 * least / spent


def mfu(ctx: dict) -> Optional[float]:
    """Percent of the card's peak rate that the window's lines' model
    operations would fill."""
    peaks = peak(ctx)
    if peaks is None or ctx["window_s"] <= 0.0:
        return None
    work = ctx["lines"] * line_flops(ctx["config"], ctx["head"], ctx["steps"])
    return 100.0 * work / ctx["window_s"] / peaks["flops"]
