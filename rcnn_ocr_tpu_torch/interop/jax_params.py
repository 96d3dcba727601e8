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

Tensor parallelism: :func:`shard_model` places a model on a mesh's model
axis by :func:`rcnn_ocr_tpu_torch.parallel.mesh.param_shardings` over its
JAX paths (:func:`jax_param_shapes`).  Each sharded parameter keeps this
rank's contiguous block (:func:`shard_block`) of the torch dimension that
holds the JAX dimension the spec names (:func:`torch_dim`: HWIO's O is
OIHW's dim 0, a Dense kernel is transposed, every other leaf keeps JAX's
layout).  The trees stay whole: :func:`load_jax_variables` and
:func:`params_by_name` cut each full leaf to the rank's block, and
:func:`to_jax_variables` gathers the blocks of every sharded leaf from the
model ranks (:func:`join_blocks`' order; a collective, so every rank of the
job calls it), so a sharded run reads and writes the same files as one
process.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rcnn_ocr_tpu_torch.parallel.mesh import (
    Mesh,
    TPShard,
    _iter_paths,
    gather_blocks,
    param_shardings,
    tp_shard,
)

Path = Tuple[str, ...]
# torch dim k of a leaf holds JAX dim perm[k] (None: the same layout)
Perm = Optional[Tuple[int, ...]]
_Leaf = Tuple[Path, torch.Tensor, Perm]
_HWIO_TO_OIHW = (3, 2, 0, 1)
_DENSE = (1, 0)


def _to_port(a: np.ndarray, perm: Perm) -> np.ndarray:
    return a if perm is None else a.transpose(perm)


def _to_jax(a: np.ndarray, perm: Perm) -> np.ndarray:
    return a if perm is None else a.transpose(np.argsort(perm))


def torch_dim(perm: Perm, jax_dim: int) -> int:
    """The torch dimension that holds a leaf's JAX dimension ``jax_dim``."""
    return jax_dim if perm is None else perm.index(jax_dim)


def _leaves(model: nn.Module) -> Iterator[_Leaf]:
    """(path incl. collection, tensor, layout) for every leaf."""
    for mname, mod in model.named_modules():
        prefix = tuple(mname.split(".")) if mname else ()
        if isinstance(mod, nn.Conv2d):
            yield ("params",) + prefix + ("kernel",), mod.weight, _HWIO_TO_OIHW
            if hasattr(mod, "act_absmax"):
                yield ("quant_stats",) + prefix + ("act_absmax",), mod.act_absmax, None
        elif isinstance(mod, nn.Linear):
            yield ("params",) + prefix + ("kernel",), mod.weight, _DENSE
            yield ("params",) + prefix + ("bias",), mod.bias, None
        elif isinstance(mod, nn.BatchNorm2d):
            yield ("params",) + prefix + ("scale",), mod.weight, None
            yield ("params",) + prefix + ("bias",), mod.bias, None
            yield ("batch_stats",) + prefix + ("mean",), mod.running_mean, None
            yield ("batch_stats",) + prefix + ("var",), mod.running_var, None
        else:
            for pname, p in mod.named_parameters(recurse=False):
                yield ("params",) + prefix + (pname,), p, None


def shard_block(a, dim: int, index: int, count: int):
    """Block ``index`` of ``count`` contiguous blocks of ``a``'s ``dim`` (a
    numpy array or a tensor)."""
    k = a.shape[dim] // count
    return a.narrow(dim, index * k, k) if isinstance(a, torch.Tensor) else \
        np.take(a, np.arange(index * k, (index + 1) * k), axis=dim)


def join_blocks(blocks, dim: int):
    """The blocks of :func:`shard_block` joined in order."""
    if isinstance(blocks[0], torch.Tensor):
        return torch.cat(list(blocks), dim=dim)
    return np.concatenate(blocks, axis=dim)


def _local(arr: np.ndarray, tensor: torch.Tensor) -> np.ndarray:
    """A full leaf in the port's layout, cut to the block a sharded tensor
    holds."""
    s = tp_shard(tensor)
    if s is None:
        return arr
    return shard_block(arr, s.dim, s.mesh.model_index, s.mesh.n_model)


def jax_param_shapes(model: nn.Module) -> Dict[str, Any]:
    """The model's ``params`` tree in JAX's paths and shapes, each leaf a
    meta tensor (shape only), for ``param_shardings``; a sharded parameter
    counts with its whole shape."""
    out: Dict[str, Any] = {}
    for path, tensor, perm in _leaves(model):
        if path[0] != "params":
            continue
        shape = list(tensor.shape)
        s = tp_shard(tensor)
        if s is not None:
            shape[s.dim] = s.full
        jax_shape = shape if perm is None else [shape[perm.index(d)] for d in range(len(perm))]
        node = out
        for key in path[1:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty(jax_shape, device="meta")
    return out


def shard_model(model: nn.Module, mesh: Mesh) -> Dict[str, str]:
    """Place ``model`` on ``mesh``: every parameter ``DEFAULT_TP_RULES``
    shards (after JAX's divisibility fallback) is replaced, in place, by
    this rank's block with its :class:`TPShard`, and ``model.mesh`` is set
    (the train and eval steps reduce over its data group).  Every rank must
    hold the same whole weights before (the same seed, or the same file).
    Call it before the optimizer is made.  Returns the ``tp_report``.

    The int8 and space-to-depth paths are serving options with no model
    axis in JAX, and a model built with them refuses a model axis."""
    model.mesh = mesh
    if mesh.n_model == 1:
        return {}
    cnn = getattr(model, "cnn", None)
    if cnn is not None and (cnn.quantize or cnn.stem0.s2d or cnn.stem0.quantize):
        raise ValueError("tensor parallelism: the int8 and space-to-depth serving paths "
                         "have no model axis (as in JAX); build the model without them")
    # every spec of the default rules names the model axis on one dimension
    specs = dict(_iter_paths(param_shardings(jax_param_shapes(model), mesh)))
    owner = {id(p): (mod, name) for mod in model.modules()
             for name, p in mod.named_parameters(recurse=False)}
    report = {}
    for path, tensor, perm in list(_leaves(model)):
        key = "/".join(path[1:])
        spec = specs.get(key, ()) if path[0] == "params" else ()
        if "model" not in spec:
            continue
        dim = torch_dim(perm, spec.index("model"))
        mod, name = owner[id(tensor)]
        block = nn.Parameter(shard_block(tensor.detach(), dim, mesh.model_index,
                                         mesh.n_model).clone(),
                             requires_grad=tensor.requires_grad)
        block.tp_shard = TPShard(dim, tensor.shape[dim], mesh)
        setattr(mod, name, block)
        report[key] = str(spec)
    return report


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
        for path, tensor, perm in leaves:
            arr = _local(_to_port(np.asarray(flat[path], dtype=np.float32), perm), tensor)
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
    for path, tensor, perm in leaves:
        arr = np.array(_local(_to_port(np.asarray(flat[path], dtype=np.float32), perm), tensor))
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
    the model's own parameters (an EMA copy, or an optimizer's moments): a
    sharded parameter's blocks are gathered, whole leaves come out."""
    names = {id(p): n for n, p in model.named_parameters()}
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for path, tensor, perm in _leaves(model):
        s = tp_shard(tensor)
        if params is not None and id(tensor) in names:
            tensor = params[names[id(tensor)]]
        tensor = tensor.detach()
        if s is not None:
            tensor = gather_blocks(tensor.contiguous(), s.dim, s.mesh)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(_to_jax(tensor.float().cpu().numpy(), perm), order="C")
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
