"""The reference's PyTorch ``.pth`` checkpoints -> a JAX (flax) variable tree.

The port's own copy of ``rcnn_ocr_tpu/interop/torch_import.py``
(``import_torch_state_dict``, ``import_torch_checkpoint``).  The output is
the flax-layout numpy tree ``{"params", "batch_stats"}`` that
:func:`rcnn_ocr_tpu_torch.interop.jax_params.load_jax_variables` loads, so a
``.pth`` reaches the port's modules along the same road as a msgpack.

The three on-disk layouts the reference writes and reads:

1. full: ``{"model_state", "itos", "stoi", "config"}``;
2. legacy: ``{"model_state_dict", "hidden_size"}``;
3. a bare ``state_dict``.

Layout translation (torch -> flax): conv kernels OIHW -> HWIO; Linear
weights ``[out, in]`` -> ``[in, out]``; batch norm ``weight/bias/
running_mean/running_var`` -> ``scale/bias`` params and ``mean/var`` batch
stats; cuDNN LSTM ``weight_ih_l0{,_reverse}`` ``[4H, D]`` (gates i, f, g,
o) -> ``w_ih [2, D, 4H]`` with the two biases summed; the decoder
LSTMCell's input weight ``[4H, C+V]`` split into ``w_ctx [C, 4H]`` and the
one-hot part ``w_emb [V, 4H]``.

The files are read with ``torch.load(weights_only=True)``: the three
layouts hold only tensors, lists, dicts, strings and numbers, so nothing
needs unpickling of arbitrary objects (JAX's copy reads with
``weights_only=False``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _conv(sd: Dict[str, Any], key: str) -> np.ndarray:
    return _np(sd[key]).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _linear_w(sd: Dict[str, Any], key: str) -> np.ndarray:
    return _np(sd[key]).T  # [out, in] -> [in, out]


def _bn(sd: Dict[str, Any], prefix: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


class _VariableTrees:
    """Accumulates params and batch_stats trees keyed by '/'-joined paths."""

    def __init__(self):
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}

    @staticmethod
    def set(tree: Dict[str, Any], path: str, value) -> None:
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def conv_bn(self, sd, torch_conv: str, torch_bn: str, path: str) -> None:
        self.set(self.params, f"{path}/conv/kernel", _conv(sd, f"{torch_conv}.weight"))
        bn_params, bn_stats = _bn(sd, torch_bn)
        for k, v in bn_params.items():
            self.set(self.params, f"{path}/bn/{k}", v)
        for k, v in bn_stats.items():
            self.set(self.stats, f"{path}/bn/{k}", v)


def import_torch_state_dict(state_dict: Dict[str, Any], num_classes: int,
                            hidden_size: int = 256) -> Dict[str, Any]:
    """torch state_dict -> flax variables ``{"params": ..., "batch_stats": ...}``.

    Every shape comes from the tensors; ``hidden_size`` is checked against
    the encoder's ``weight_hh``, so a wrong expectation fails here."""
    sd = state_dict
    hh = sd.get("enc_rnn.0.rnn.weight_hh_l0")
    if hh is not None and int(_np(hh).shape[1]) != int(hidden_size):
        raise ValueError(
            f"hidden_size={hidden_size} does not match the checkpoint "
            f"(enc_rnn weight_hh is {int(_np(hh).shape[1])}-hidden)"
        )
    tb = _VariableTrees()

    tb.conv_bn(sd, "cnn.conv0.0", "cnn.conv0.1", "cnn/stem0")
    tb.conv_bn(sd, "cnn.conv0.3", "cnn.conv0.4", "cnn/stem1")
    for layer, blocks in {1: 1, 2: 2, 3: 5, 4: 3}.items():
        for b in range(blocks):
            tpre, fpre = f"cnn.layer{layer}.{b}", f"cnn/layer{layer}_block{b}"
            tb.conv_bn(sd, f"{tpre}.conv1", f"{tpre}.bn1", f"{fpre}/conv1")
            tb.conv_bn(sd, f"{tpre}.conv2", f"{tpre}.bn2", f"{fpre}/conv2")
            tb.set(tb.params, f"{fpre}/se/fc1", _linear_w(sd, f"{tpre}.se.fc.0.weight"))
            tb.set(tb.params, f"{fpre}/se/fc2", _linear_w(sd, f"{tpre}.se.fc.2.weight"))
            if f"{tpre}.downsample.0.weight" in sd:
                tb.conv_bn(sd, f"{tpre}.downsample.0", f"{tpre}.downsample.1",
                           f"{fpre}/downsample")
    tb.conv_bn(sd, "cnn.conv_out.0", "cnn.conv_out.1", "cnn/out0")
    tb.conv_bn(sd, "cnn.conv_out.3", "cnn.conv_out.4", "cnn/out1")

    for i in range(2):
        tpre, fpre = f"enc_rnn.{i}", f"enc_rnn{i}"
        rnn = f"{tpre}.rnn"
        tb.set(tb.params, f"{fpre}/w_ih", np.stack([_np(sd[f"{rnn}.weight_ih_l0"]).T,
                                                    _np(sd[f"{rnn}.weight_ih_l0_reverse"]).T]))
        tb.set(tb.params, f"{fpre}/w_hh", np.stack([_np(sd[f"{rnn}.weight_hh_l0"]).T,
                                                    _np(sd[f"{rnn}.weight_hh_l0_reverse"]).T]))
        tb.set(tb.params, f"{fpre}/bias", np.stack([
            _np(sd[f"{rnn}.bias_ih_l0"]) + _np(sd[f"{rnn}.bias_hh_l0"]),
            _np(sd[f"{rnn}.bias_ih_l0_reverse"]) + _np(sd[f"{rnn}.bias_hh_l0_reverse"]),
        ]))
        tb.set(tb.params, f"{fpre}/proj/kernel", _linear_w(sd, f"{tpre}.linear.weight"))
        tb.set(tb.params, f"{fpre}/proj/bias", _np(sd[f"{tpre}.linear.bias"]))

    if "attn.attention_cell.i2h.weight" in sd:
        cell = "attn.attention_cell"
        tb.set(tb.params, "attn/w_i2h", _linear_w(sd, f"{cell}.i2h.weight"))
        tb.set(tb.params, "attn/w_h2h", _linear_w(sd, f"{cell}.h2h.weight"))
        tb.set(tb.params, "attn/b_h2h", _np(sd[f"{cell}.h2h.bias"]))
        tb.set(tb.params, "attn/v_score", _linear_w(sd, f"{cell}.score.weight"))
        w_cell_ih = _np(sd[f"{cell}.rnn.weight_ih"]).T  # [C+V, 4H]
        ctx_dim = w_cell_ih.shape[0] - num_classes
        tb.set(tb.params, "attn/w_ctx", w_cell_ih[:ctx_dim])
        tb.set(tb.params, "attn/w_emb", w_cell_ih[ctx_dim:])
        tb.set(tb.params, "attn/w_hh", _np(sd[f"{cell}.rnn.weight_hh"]).T)
        tb.set(tb.params, "attn/b_cell",
               _np(sd[f"{cell}.rnn.bias_ih"]) + _np(sd[f"{cell}.rnn.bias_hh"]))
        tb.set(tb.params, "attn/w_gen", _linear_w(sd, "attn.generator.weight"))
        tb.set(tb.params, "attn/b_gen", _np(sd["attn.generator.bias"]))

    return {"params": tb.params, "batch_stats": tb.stats}


def import_torch_checkpoint(path: str, num_classes: Optional[int] = None,
                            hidden_size: Optional[int] = None) -> Dict[str, Any]:
    """Load a reference ``.pth`` checkpoint in any of the three layouts.

    Returns ``{"variables", "itos", "stoi", "hidden_size", "num_classes",
    "config"}``; the charset and config fields are ``None`` when absent.
    ``num_classes`` comes from ``itos``, else the generator's bias;
    ``hidden_size`` from the config, the legacy field, else the encoder's
    ``weight_hh``.
    """
    blob = torch.load(path, map_location="cpu", weights_only=True)

    itos = stoi = config = None
    if isinstance(blob, dict) and "model_state" in blob:
        sd = blob["model_state"]
        itos, stoi, config = blob.get("itos"), blob.get("stoi"), blob.get("config")
        if hidden_size is None and config:
            hidden_size = config.get("hidden_size", 256)
    elif isinstance(blob, dict) and "model_state_dict" in blob:
        sd = blob["model_state_dict"]
        if hidden_size is None:
            hidden_size = blob.get("hidden_size", 256)
    else:
        sd = blob

    if num_classes is None:
        if itos is not None:
            num_classes = len(itos)
        elif "attn.generator.bias" in sd:
            num_classes = int(_np(sd["attn.generator.bias"]).shape[0])
        else:
            raise ValueError("num_classes not derivable; pass it explicitly")
    if hidden_size is None:
        hh = sd.get("enc_rnn.0.rnn.weight_hh_l0")
        hidden_size = int(_np(hh).shape[1]) if hh is not None else 256

    variables = import_torch_state_dict(sd, num_classes=num_classes, hidden_size=hidden_size)
    return {"variables": variables, "itos": itos, "stoi": stoi, "hidden_size": hidden_size,
            "num_classes": num_classes, "config": config}
