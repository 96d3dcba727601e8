"""Seeded weights for a configuration, drawn on the card in one call.

Convolution kernels are N(0, 2 / fan-in) (He normal: each feeds a ReLU, and
with LeCun's 1 / fan-in the 31-layer backbone's features fade), every other
matrix N(0, 1 / fan-in) (LeCun normal), biases 0, batch norm scale 1 and
shift 0.  The configuration's ``weights.logit_bias`` sets the generator bias
of tokens a trained attention head never emits before EOS (PAD and SOS: no
training target holds them there), so every token the greedy decode emits
shows in its string.

:func:`calibrate_batch_norm` then measures the batch norms' running
statistics on seeded lines, as training leaves them measured on its data.
Left at their initial values (mean 0, variance 1) the backbone's features
carry a large offset that hides the image: most lines then decode to one of
a few strings, and a decode that swaps lines' strings would go unseen.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import preprocess, rcnn


def make_weights(cfg: dict, itos, seed: int, device) -> Dict[str, torch.Tensor]:
    """Flat ``{path: float32 tensor on device}`` in the reference's layout."""
    layout = rcnn.param_layout(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    gain = {"he": 2.0, "normal": 1.0}
    total = sum(int(np.prod(shape)) for _, shape, kind, _ in layout if kind in gain)
    draws = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for path, shape, kind, fan_in in layout:
        n = int(np.prod(shape))
        if kind in gain:
            out[path] = (draws[pos:pos + n] * (gain[kind] / fan_in) ** 0.5).reshape(shape)
            pos += n
        else:
            out[path] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
    stoi = {tok: i for i, tok in enumerate(itos)}
    for tok, bias in cfg["weights"]["logit_bias"].items():
        out["params/attn/b_gen"][stoi[tok]] = bias
    return out


def as_tree(flat: Dict[str, torch.Tensor]) -> dict:
    """The flat weights as a nested ``{"params": ..., "batch_stats": ...}``
    tree of float32 numpy arrays, the form the program's engine loads."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree


def calibrate_batch_norm(W: Dict[str, torch.Tensor], cfg: dict, lines, device) -> None:
    """Every batch norm's running mean and variance, in ``W``, measured by
    the float32 reference on ``lines`` (layer by layer, each on the
    statistics already set before it)."""
    x = preprocess.model_input(lines, cfg["img_h"], cfg["img_w"])
    with rcnn.plain_fp32(), torch.no_grad():
        rcnn.backbone(W, torch.from_numpy(x).to(device), calibrate=True)
