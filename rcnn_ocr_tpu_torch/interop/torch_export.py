"""A JAX variable tree (or the port's model) -> the reference's ``.pth`` checkpoints.

The port's own copy of ``rcnn_ocr_tpu/interop/torch_export.py``
(``export_torch_state_dict``, ``save_torch_checkpoint``), the exact inverse
of :mod:`rcnn_ocr_tpu_torch.interop.torch_import`: a model trained here (in
either package) becomes a checkpoint the reference stack loads with
``strict=True``.

Layout translation (flax -> torch): conv kernels HWIO -> OIHW; Linear
weights ``[in, out]`` -> ``[out, in]``; batch norm ``scale/bias`` params and
``mean/var`` batch stats -> ``weight/bias/running_mean/running_var`` (and
``num_batches_tracked = 0``); BiLSTM ``w_ih [2, D, 4H]`` -> cuDNN
``weight_ih_l0{,_reverse}`` ``[4H, D]``, the summed bias into ``bias_ih_l0``
and a zero ``bias_hh_l0`` (torch adds the two, so the sum is all that
counts); the decoder's ``w_ctx [C, 4H]`` and ``w_emb [V, 4H]`` concatenated
back into the LSTMCell's input weight ``[4H, C+V]``.

Only the reference architecture's parameters are written: the CTC head
(``ctc_proj``) and int8 ``quant_stats`` have no torch counterpart and are
skipped.  The arrays are numpy's; :func:`save_torch_checkpoint` writes them
with ``torch.save``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables

Variables = Union[Dict[str, Any], nn.Module]


def _np32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _get(tree: Dict[str, Any], path: str):
    node = tree
    for p in path.split("/"):
        node = node[p]
    return node


def _has(tree: Dict[str, Any], path: str) -> bool:
    node = tree
    for p in path.split("/"):
        if not isinstance(node, Mapping) or p not in node:
            return False
        node = node[p]
    return True


def _tree(variables: Variables) -> Dict[str, Any]:
    """A JAX variable tree, as given or read from the port's model."""
    return to_jax_variables(variables) if isinstance(variables, nn.Module) else variables


class _StateDictBuilder:
    def __init__(self, params: Dict[str, Any], stats: Dict[str, Any]):
        self.params = params
        self.stats = stats
        self.sd: Dict[str, np.ndarray] = {}

    def conv(self, flax_path: str, torch_key: str):
        k = _np32(_get(self.params, f"{flax_path}/conv/kernel"))
        self.sd[f"{torch_key}.weight"] = k.transpose(3, 2, 0, 1)  # HWIO -> OIHW

    def bn(self, flax_path: str, torch_key: str):
        self.sd[f"{torch_key}.weight"] = _np32(_get(self.params, f"{flax_path}/bn/scale"))
        self.sd[f"{torch_key}.bias"] = _np32(_get(self.params, f"{flax_path}/bn/bias"))
        self.sd[f"{torch_key}.running_mean"] = _np32(_get(self.stats, f"{flax_path}/bn/mean"))
        self.sd[f"{torch_key}.running_var"] = _np32(_get(self.stats, f"{flax_path}/bn/var"))
        self.sd[f"{torch_key}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)

    def conv_bn(self, flax_path: str, torch_conv: str, torch_bn: str):
        self.conv(flax_path, torch_conv)
        self.bn(flax_path, torch_bn)

    def linear(self, flax_path: str, torch_key: str):
        self.sd[f"{torch_key}.weight"] = _np32(_get(self.params, flax_path)).T  # [in, out] -> [out, in]


def export_torch_state_dict(variables: Variables, strict: bool = True) -> Dict[str, np.ndarray]:
    """``{"params", "batch_stats"}`` (or the port's ``RCNN``) -> the reference's
    torch ``state_dict`` as numpy arrays, keyed as the reference's
    ``RCNN().state_dict()``.

    ``strict`` (the default) requires what the reference can load: a
    64-channel stem (width 1.0).  ``strict=False`` skips that check for
    round trips through this package's importer, which reads every shape
    from the tensors.  Two encoder BiLSTMs are required either way.
    """
    variables = _tree(variables)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    b = _StateDictBuilder(params, stats)

    if strict:
        stem_w = int(np.asarray(_get(params, "cnn/stem0/conv/kernel")).shape[-1])
        if stem_w != 64:
            raise ValueError(
                f"reference architecture has a 64-channel stem, found "
                f"{stem_w} (width_mult != 1.0 checkpoints cannot export a "
                "reference-loadable .pth; pass strict=False for a "
                "framework-internal one)"
            )

    b.conv_bn("cnn/stem0", "cnn.conv0.0", "cnn.conv0.1")
    b.conv_bn("cnn/stem1", "cnn.conv0.3", "cnn.conv0.4")
    for layer, blocks in {1: 1, 2: 2, 3: 5, 4: 3}.items():
        for blk in range(blocks):
            fpre = f"cnn/layer{layer}_block{blk}"
            tpre = f"cnn.layer{layer}.{blk}"
            b.conv_bn(f"{fpre}/conv1", f"{tpre}.conv1", f"{tpre}.bn1")
            b.conv_bn(f"{fpre}/conv2", f"{tpre}.conv2", f"{tpre}.bn2")
            b.linear(f"{fpre}/se/fc1", f"{tpre}.se.fc.0")
            b.linear(f"{fpre}/se/fc2", f"{tpre}.se.fc.2")
            if _has(params, f"{fpre}/downsample"):
                b.conv_bn(f"{fpre}/downsample", f"{tpre}.downsample.0", f"{tpre}.downsample.1")
    b.conv_bn("cnn/out0", "cnn.conv_out.0", "cnn.conv_out.1")
    b.conv_bn("cnn/out1", "cnn.conv_out.3", "cnn.conv_out.4")

    i = 0
    while _has(params, f"enc_rnn{i}"):
        fpre, tpre = f"enc_rnn{i}", f"enc_rnn.{i}"
        w_ih = _np32(_get(params, f"{fpre}/w_ih"))  # [2, D, 4H]
        w_hh = _np32(_get(params, f"{fpre}/w_hh"))
        bias = _np32(_get(params, f"{fpre}/bias"))  # [2, 4H], the summed pair
        zeros = np.zeros_like(bias[0])
        for d, sfx in enumerate(("", "_reverse")):
            b.sd[f"{tpre}.rnn.weight_ih_l0{sfx}"] = w_ih[d].T
            b.sd[f"{tpre}.rnn.weight_hh_l0{sfx}"] = w_hh[d].T
            b.sd[f"{tpre}.rnn.bias_ih_l0{sfx}"] = bias[d]
            b.sd[f"{tpre}.rnn.bias_hh_l0{sfx}"] = zeros
        b.linear(f"{fpre}/proj/kernel", f"{tpre}.linear")
        b.sd[f"{tpre}.linear.bias"] = _np32(_get(params, f"{fpre}/proj/bias"))
        i += 1
    if i != 2:
        raise ValueError(
            f"reference architecture has exactly 2 encoder BiLSTMs, found {i} "
            "(lstm_layers != 2 checkpoints have no reference counterpart)"
        )

    if _has(params, "attn"):  # a CTC-only model has no decoder
        b.linear("attn/w_i2h", "attn.attention_cell.i2h")
        b.linear("attn/w_h2h", "attn.attention_cell.h2h")
        b.sd["attn.attention_cell.h2h.bias"] = _np32(_get(params, "attn/b_h2h"))
        b.linear("attn/v_score", "attn.attention_cell.score")
        w_ctx = _np32(_get(params, "attn/w_ctx"))  # [C, 4H]
        w_emb = _np32(_get(params, "attn/w_emb"))  # [V, 4H]
        b.sd["attn.attention_cell.rnn.weight_ih"] = np.concatenate([w_ctx, w_emb], axis=0).T
        b.sd["attn.attention_cell.rnn.weight_hh"] = _np32(_get(params, "attn/w_hh")).T
        b_cell = _np32(_get(params, "attn/b_cell"))
        b.sd["attn.attention_cell.rnn.bias_ih"] = b_cell
        b.sd["attn.attention_cell.rnn.bias_hh"] = np.zeros_like(b_cell)
        b.linear("attn/w_gen", "attn.generator")
        b.sd["attn.generator.bias"] = _np32(_get(params, "attn/b_gen"))

    return b.sd


def save_torch_checkpoint(
    path: str,
    variables: Variables,
    layout: str = "full",
    itos: Optional[List[str]] = None,
    stoi: Optional[Dict[str, int]] = None,
    config: Optional[Dict[str, Any]] = None,
    hidden_size: Optional[int] = None,  # default: read from the tensors
    strict: bool = True,
) -> None:
    """Write a reference-layout ``.pth``: ``"full"`` (``model_state`` with
    the charset and config), ``"legacy"`` (``model_state_dict`` and
    ``hidden_size``) or ``"bare"`` (the state_dict alone)."""
    variables = _tree(variables)
    if hidden_size is None:
        hidden_size = int(np.asarray(_get(variables["params"], "enc_rnn0/w_hh")).shape[1])
    sd = {
        # a copy: restored arrays may be read-only views, which torch.save would share
        k: torch.from_numpy(np.array(v, copy=True))
        for k, v in export_torch_state_dict(variables, strict=strict).items()
    }
    if layout == "bare":
        blob: Any = sd
    elif layout == "legacy":
        blob = {"model_state_dict": sd, "hidden_size": hidden_size}
    elif layout == "full":
        cfg = dict(config or {})
        cfg.setdefault("hidden_size", hidden_size)
        blob = {"model_state": sd, "itos": itos, "stoi": stoi, "config": cfg}
    else:
        raise ValueError(f"unknown layout {layout!r} (full|legacy|bare)")
    torch.save(blob, path)
