"""JAX variable trees <-> the port's modules, key by key.

A JAX (flax) checkpoint holds ``{"params": tree, "batch_stats": tree}`` of
numpy arrays, and a calibrated int8 one also ``"quant_stats"``.  The port's
modules carry the JAX names, so every leaf maps to one tensor of the module:

* ``.../conv/kernel`` HWIO <-> ``Conv2d.weight`` OIHW;
* Dense ``kernel [in, out]`` / ``bias`` <-> ``Linear.weight [out, in]`` / ``bias``
  (BiLSTM ``proj`` and ``ctc_proj``);
* BatchNorm ``scale`` / ``bias`` (params) and ``mean`` / ``var``
  (batch_stats) <-> ``weight`` / ``bias`` / ``running_mean`` / ``running_var``;
* ``quant_stats/.../conv/act_absmax`` <-> the static int8 conv's
  ``act_absmax`` buffer (only a model built with ``act_quant="static"`` has
  them);
* every other parameter (LSTM ``w_ih``/``w_hh``/``bias``, SE ``fc1``/``fc2``,
  the attention decoder's raw weights) as it is.

:func:`load_jax_variables` is strict: a missing, unexpected or mis-shaped key
raises, naming the key.  :func:`to_jax_variables` is its exact inverse.
:func:`params_by_name` maps any tree shaped like ``params`` (an optimizer's
moments, an EMA) to the port's parameter names, for full checkpoints.
:func:`port_state_from_jax` applies the same rules by leaf name alone, with
no model: a serving artifact's loader feeds its exported programs with it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]
_Leaf = Tuple[Path, torch.Tensor, Callable[[np.ndarray], np.ndarray], Callable[[np.ndarray], np.ndarray]]


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _leaves(model: nn.Module) -> Iterator[_Leaf]:
    """(path incl. collection, tensor, jax->port, port->jax) for every leaf."""
    for mname, mod in model.named_modules():
        prefix = tuple(mname.split(".")) if mname else ()
        if isinstance(mod, nn.Conv2d):
            yield (("params",) + prefix + ("kernel",), mod.weight,
                   lambda a: a.transpose(3, 2, 0, 1), lambda a: a.transpose(2, 3, 1, 0))
            if hasattr(mod, "act_absmax"):
                yield ("quant_stats",) + prefix + ("act_absmax",), mod.act_absmax, _same, _same
        elif isinstance(mod, nn.Linear):
            yield ("params",) + prefix + ("kernel",), mod.weight, np.transpose, np.transpose
            yield ("params",) + prefix + ("bias",), mod.bias, _same, _same
        elif isinstance(mod, nn.BatchNorm2d):
            yield ("params",) + prefix + ("scale",), mod.weight, _same, _same
            yield ("params",) + prefix + ("bias",), mod.bias, _same, _same
            yield ("batch_stats",) + prefix + ("mean",), mod.running_mean, _same, _same
            yield ("batch_stats",) + prefix + ("var",), mod.running_var, _same, _same
        else:
            for pname, p in mod.named_parameters(recurse=False):
                yield ("params",) + prefix + (pname,), p, _same, _same


def _flatten(tree: Any, prefix: Path = ()) -> Dict[Path, Any]:
    if isinstance(tree, dict):
        out: Dict[Path, Any] = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def load_jax_variables(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Copy a JAX ``{"params", "batch_stats"[, "quant_stats"]}`` numpy tree
    into ``model``."""
    cols = ("params", "batch_stats", "quant_stats")
    flat = {k: v for col in cols for k, v in _flatten(variables.get(col, {}), (col,)).items()}
    extra_cols = set(variables) - set(cols)
    if extra_cols:
        raise KeyError(f"unexpected variable collections: {sorted(extra_cols)}")
    leaves = list(_leaves(model))
    wanted = {path for path, *_ in leaves}
    missing = sorted("/".join(p) for p in wanted - set(flat))
    unexpected = sorted("/".join(p) for p in set(flat) - wanted)
    if missing or unexpected:
        raise KeyError(f"checkpoint does not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for path, tensor, to_port, _ in leaves:
            arr = to_port(np.asarray(flat[path], dtype=np.float32))
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(f"{'/'.join(path)}: checkpoint shape {tuple(arr.shape)} "
                                 f"does not fit the model's {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(np.array(arr)))
    return model


def params_by_name(model: nn.Module, params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX ``params``-shaped tree (weights, or optimizer moments, or an
    EMA) -> float32 arrays in the port's layout, by parameter name; strict
    like :func:`load_jax_variables`."""
    flat = _flatten(params, ("params",))
    names = {id(p): n for n, p in model.named_parameters()}
    leaves = [leaf for leaf in _leaves(model) if leaf[0][0] == "params"]
    wanted = {path for path, *_ in leaves}
    if wanted != set(flat):
        raise KeyError(f"tree does not fit the model's parameters: missing "
                       f"{sorted('/'.join(p) for p in wanted - set(flat))}, unexpected "
                       f"{sorted('/'.join(p) for p in set(flat) - wanted)}")
    out = {}
    for path, tensor, to_port, _ in leaves:
        arr = np.array(to_port(np.asarray(flat[path], dtype=np.float32)))
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(arr.shape)} does not fit the "
                             f"model's {tuple(tensor.shape)}")
        out[names[id(tensor)]] = arr
    return out


def to_jax_variables(model: nn.Module, params: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, Dict[str, Any]]:
    """The model's weights as a JAX ``{"params", "batch_stats"}`` numpy tree,
    plus ``"quant_stats"`` for a static int8 model (copies: later updates of
    the model do not reach it).  ``params``, by parameter name, stands in for
    the model's own parameters (an EMA copy)."""
    names = {id(p): n for n, p in model.named_parameters()}
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for path, tensor, _, to_jax in _leaves(model):
        if params is not None and id(tensor) in names:
            tensor = params[names[id(tensor)]]
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        arr = tensor.detach().float().cpu().numpy()
        node[path[-1]] = np.array(to_jax(arr), order="C")
    return out


# leaf name (collection, name) -> the port's tensor name, by the rules of _leaves
_PORT_NAMES = {("params", "scale"): "weight", ("batch_stats", "mean"): "running_mean",
               ("batch_stats", "var"): "running_var", ("params", "kernel"): "weight"}


def port_state_from_jax(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX variable tree -> float32 arrays by the port's state names
    (``cnn.stem0.conv.weight``, ``cnn.stem0.bn.running_mean``, ...), the
    layout transforms of :func:`load_jax_variables` applied: a 4-d
    ``kernel`` is a conv (HWIO -> OIHW), a 2-d one a Dense (transposed)."""
    out: Dict[str, np.ndarray] = {}
    for col in ("params", "batch_stats", "quant_stats"):
        for path, leaf in _flatten(variables.get(col, {})).items():
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            name = _PORT_NAMES.get((col, path[-1]), path[-1])
            out[".".join(path[:-1] + (name,))] = np.array(arr, order="C")  # keeps 0-d shapes
    return out
