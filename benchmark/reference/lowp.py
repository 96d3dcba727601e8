"""The control: the plain reference computed one precision below the
configuration's bfloat16, in float8 (e4m3).

Every convolution and matrix product takes its inputs rounded to float8
e4m3 with one scale per tensor (its largest magnitude onto float8's largest,
448), the usual float8 inference recipe, and accumulates in float32; the
rest is the float32 reference.  :func:`greedy_strings` decodes lines with
it as the program's greedy decodes do, so the control's strings can be
judged as the program's are.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from benchmark.reference import rcnn

F8_MAX = 448.0
PRODUCTS = {F.conv2d, torch.matmul, torch.Tensor.__matmul__, torch.bmm}


def to_f8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Float8Products(TorchFunctionMode):
    """Round the two operands of every product to scaled float8."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in PRODUCTS:
            args = (to_f8(args[0]), to_f8(args[1])) + tuple(args[2:])
        return func(*args, **kwargs)


def greedy_strings(W, cfg: dict, x: torch.Tensor, head: str, steps: int,
                   itos: Sequence[str]) -> List[str]:
    """Greedy strings of the normalized lines ``x`` under :class:`Float8Products`:
    CTC, each frame's best class with repeats merged and the invisible tokens
    dropped; attention, the best token fed back for ``steps`` steps, cut at EOS."""
    invisible = {itos.index(t) for t in cfg["invisible_tokens"]}
    with Float8Products():
        enc = rcnn.encode(W, x, cfg)
        if head == "ctc":
            frames = rcnn.ctc_logits(W, enc).argmax(-1).tolist()
            out = []
            for row in frames:
                kept = [t for i, t in enumerate(row) if i == 0 or t != row[i - 1]]
                out.append("".join(itos[t] for t in kept if t not in invisible))
            return out
        sos, eos = itos.index("<SOS>"), itos.index("<EOS>")
        tokens = rcnn.attention_greedy(W, enc, sos, steps, cfg["hidden_size"]).tolist()
    out = []
    for row in tokens:
        row = row[:row.index(eos)] if eos in row else row
        out.append("".join(itos[t] for t in row if t not in invisible))
    return out
