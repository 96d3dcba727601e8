"""Read and write the JAX package's msgpack checkpoints without flax or msgpack.

Counterpart of ``rcnn_ocr_tpu/training/checkpoint.py``: ``load_checkpoint_blob``
(with its format-version refusal), ``load_variables``, ``save_weights``,
``save_checkpoint``, ``restore_train_state`` and ``AsyncCheckpointer``.
Those files are written by ``flax.serialization.msgpack_serialize``: plain
msgpack maps, arrays, strings, binaries, ints, floats, nil and booleans,
plus flax's extension types 1 (an ndarray, itself msgpack ``(shape, dtype
name, raw bytes)``) and 3 (a numpy scalar in the same encoding), with arrays
over 1 GiB split into ``__msgpack_chunked_array__`` maps.  This module
decodes exactly that, in pure Python and numpy (bfloat16 arrays come back as
float32: numpy has no bfloat16), and :func:`msgpack_serialize` encodes the
same types as flax does, byte for byte (maps with their keys sorted, as
flax's pass through ``jax.tree_util`` leaves them; arrays over 1 GiB are
refused, not chunked).

A full checkpoint has JAX's layout key for key: ``format_version``,
``epoch``, ``global_step``, ``params``, ``batch_stats``, ``opt_state``,
``scheduler_state``, ``best_val_loss``, ``best_val_acc``, ``itos``,
``stoi``, ``config``, ``log_dir`` and, for an EMA run, ``ema_params``.
``opt_state`` is the ``flax.serialization.to_state_dict`` form of the optax
tree JAX's ``build_optimizer`` makes: ``inject_hyperparams`` (``count``,
``hyperparams.learning_rate``, an empty ``hyperparams_states``) over the
chain of an optional ``clip_by_global_norm``, then Adam's
``add_decayed_weights`` (with weight decay), ``scale_by_adam`` (``count``,
``mu``, ``nu``) and ``scale``; AdamW's ``adamw`` chain (``scale_by_adam``,
decay, scale); SGD's decay, ``trace`` (``trace``, with momentum) and
``scale``; stateless links are empty maps under their chain index.  The
moments map to the torch optimizer's ``exp_avg`` / ``exp_avg_sq`` /
``step`` (SGD: ``momentum_buffer``) through the parameter names of
:mod:`rcnn_ocr_tpu_torch.interop.jax_params`, so JAX resumes a checkpoint
the port wrote and the port resumes one JAX wrote.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rcnn_ocr_tpu_torch.interop.jax_params import (
    load_jax_variables,
    params_by_name,
    to_jax_variables,
)

CHECKPOINT_FORMAT_VERSION = 1

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# msgpack type bytes beyond the fix* ranges
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {  # type byte -> (length format, reader method)
    0xC4: (">B", "binary"), 0xC5: (">H", "binary"), 0xC6: (">I", "binary"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xD9: (">B", "text"), 0xDA: (">H", "text"), 0xDB: (">I", "text"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"), 0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.text(b & 0x1F)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _SIZED:
            fmt, method = _SIZED[b]
            return getattr(self, method)(self.unpack(fmt))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def binary(self, n: int) -> bytes:
        return bytes(self.take(n))

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack_restore(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """Decode one msgpack document as ``flax.serialization.msgpack_restore`` does."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack document")
    return _unchunk(out)


def load_checkpoint_blob(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        blob = msgpack_restore(f.read())
    version = int(blob.get("format_version", 1)) if isinstance(blob, dict) else 1
    if version > CHECKPOINT_FORMAT_VERSION:
        raise ValueError(
            f"{path} is checkpoint format {version}, newer than this loader "
            f"({CHECKPOINT_FORMAT_VERSION})"
        )
    return blob


def load_variables(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Model variables ``{"params", "batch_stats"}`` from a weights or full
    checkpoint file, with ``"quant_stats"`` when the file carries calibrated
    static int8 scales, and the whole blob (``itos``, ``config``, ...)."""
    blob = load_checkpoint_blob(path)
    if "params" not in blob:
        raise ValueError(f"{path} holds no model parameters")
    variables = {"params": blob["params"], "batch_stats": blob.get("batch_stats", {})}
    if blob.get("quant_stats"):
        variables["quant_stats"] = blob["quant_stats"]
    return variables, blob


def _header(small: int, fix_limit: int, sized: Tuple[int, int, int], n: int) -> bytes:
    """A fix* byte for ``n < fix_limit`` (``small | n``), else the 8/16/32-bit
    length form from ``sized`` (the 8-bit one may be 0: not offered)."""
    if n < fix_limit:
        return bytes([small | n])
    for code, fmt, limit in zip(sized, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack item of length {n} is too long")


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15), (0xD2, ">i", 2**31),
                                 (0xD3, ">q", 2**63)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _ext_head(code: int, n: int) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixext[n]]) if n in fixext else _header(0, 0, (0xC7, 0xC8, 0xC9), n)
    return head + struct.pack(">b", code)


def _pack_ndarray(code: int, arr: np.ndarray, out: List) -> None:
    """An ndarray (or numpy scalar) as flax's extension: ``(shape, dtype
    name, raw bytes)`` inside an ext of type ``code``; the raw bytes go in
    as a view, not a copy."""
    if arr.dtype.hasobject or arr.nbytes > 2**30:
        raise ValueError(f"cannot write an array of {arr.dtype} and {arr.nbytes} bytes")
    meta: List = []
    _pack_into([list(arr.shape), arr.dtype.name], meta)
    raw = memoryview(np.ascontiguousarray(arr)).cast("B")
    inner = [b"\x93", *meta[1:], _header(0, 0, (0xC4, 0xC5, 0xC6), raw.nbytes), raw]
    out.append(_ext_head(code, sum(len(c) for c in inner)))
    out.extend(inner)


def _pack_into(v: Any, out: List) -> None:
    """Append the msgpack encoding of ``v`` to ``out`` as chunks (a tree of
    arrays is encoded without copying it level by level)."""
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, np.ndarray):
        _pack_ndarray(_EXT_NDARRAY, v, out)
    elif isinstance(v, np.generic):
        _pack_ndarray(_EXT_NPSCALAR, np.asarray(v), out)
    elif isinstance(v, int):
        out.append(_pack_int(v))
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(_header(0xA0, 32, (0xD9, 0xDA, 0xDB), len(raw)) + raw)
    elif isinstance(v, bytes):
        out.append(_header(0, 0, (0xC4, 0xC5, 0xC6), len(v)) + v)
    elif isinstance(v, (list, tuple)):
        out.append(_header(0x90, 16, (0, 0xDC, 0xDD), len(v)))
        for x in v:
            _pack_into(x, out)
    elif isinstance(v, dict):
        items = sorted(v.items())
        out.append(_header(0x80, 16, (0, 0xDE, 0xDF), len(items)))
        for k, x in items:
            _pack_into(k, out)
            _pack_into(x, out)
    else:
        raise TypeError(f"cannot write {type(v).__name__} to msgpack")


def _chunks(tree: Any) -> List:
    out: List = []
    _pack_into(tree, out)
    return out


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a tree of dicts (string keys), lists, strings, bytes, numbers,
    booleans, None and numpy arrays / scalars as
    ``flax.serialization.msgpack_serialize`` does."""
    return b"".join(_chunks(tree))


CKPT_SUFFIX = "_ckpt.msgpack"
WEIGHTS_SUFFIX = "_weights.msgpack"


def _atomic_write(path: str, tree: Any) -> int:
    """Encode ``tree`` into ``path + ".tmp"`` and move it into place: an
    interrupted write never leaves a torn slot.  Returns the bytes written."""
    tmp = path + ".tmp"
    chunks = _chunks(tree)
    with open(tmp, "wb") as f:
        f.writelines(chunks)
        size = f.tell()
    os.replace(tmp, path)
    return size


def _weights_blob(state) -> Dict[str, Any]:
    """The model variables an EMA run deploys (its EMA parameters, as JAX's
    ``_weights_blob``), else the model's own."""
    return {"format_version": CHECKPOINT_FORMAT_VERSION,
            **to_jax_variables(state.model, state.ema_params)}


def save_weights(path: str, state) -> None:
    """Write a train state's bare weights file ``{"format_version",
    "params", "batch_stats"}``, atomically."""
    _atomic_write(path, _weights_blob(state))


# --- optimizer state <-> optax's tree ------------------------------------------------

def _chain(spec) -> List[str]:
    """The links of JAX's ``build_optimizer`` chain for ``spec``, in order."""
    links = ["clip"] if spec.grad_clip else []
    if spec.name == "Adam":
        links += (["decay"] if spec.weight_decay else []) + ["adam", "scale"]
    elif spec.name == "AdamW":
        links.append("adamw")
    else:
        links += ((["decay"] if spec.weight_decay else []) + (["trace"] if spec.momentum else [])
                  + ["scale"])
    return links


def optimizer_state_tree(state) -> Dict[str, Any]:
    """The torch optimizer's state as JAX's ``to_state_dict(opt_state)``."""
    model, opt = state.model, state.optimizer
    named = list(model.named_parameters())

    def moments(key: str) -> Dict[str, Any]:
        return to_jax_variables(model, {
            n: opt.state.get(p, {}).get(key, torch.zeros_like(p)) for n, p in named})["params"]

    def adam() -> Dict[str, Any]:
        steps = [float(opt.state[p]["step"]) for _, p in named if "step" in opt.state.get(p, {})]
        return {"count": np.asarray(int(max(steps, default=0)), np.int32),
                "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")}

    inner: Dict[str, Any] = {}
    for i, link in enumerate(_chain(state.tx)):
        if link == "adam":
            inner[str(i)] = adam()
        elif link == "adamw":
            inner[str(i)] = {"0": adam(), "1": {}, "2": {}}
        elif link == "trace":
            inner[str(i)] = {"trace": moments("momentum_buffer")}
        else:
            inner[str(i)] = {}
    return {"count": np.asarray(state.step, np.int32),
            "hyperparams": {"learning_rate": np.asarray(opt.param_groups[0]["lr"], np.float32)},
            "hyperparams_states": {}, "inner_state": inner}


def load_optimizer_state(state, tree: Dict[str, Any]) -> None:
    """Set the torch optimizer's moments, step counts and learning rate from
    JAX's ``to_state_dict(opt_state)`` for the state's optimizer spec."""
    model, opt = state.model, state.optimizer
    links = _chain(state.tx)
    inner = tree["inner_state"]
    if sorted(inner, key=int) != [str(i) for i in range(len(links))]:
        raise KeyError(f"opt_state has chain links {sorted(inner)}, the {state.tx.name} "
                       f"optimizer of this run has {links}")
    params = dict(model.named_parameters())
    per_param: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in params}

    def put(key: str, moment_tree: Dict[str, Any]) -> None:
        for n, arr in params_by_name(model, moment_tree).items():
            per_param[n][key] = torch.from_numpy(arr).to(params[n].device)

    for i, link in enumerate(links):
        node = inner[str(i)]
        if link == "adamw":
            node = node["0"]
        if link in ("adam", "adamw"):
            put("exp_avg", node["mu"])
            put("exp_avg_sq", node["nu"])
            step = torch.tensor(float(np.asarray(node["count"])), dtype=torch.float32)
            for n in per_param:
                per_param[n]["step"] = step.clone()
        elif link == "trace":
            put("momentum_buffer", node["trace"])
    opt.state.clear()
    for n, values in per_param.items():
        if values:
            opt.state[params[n]] = values
    lr = float(np.asarray(tree["hyperparams"]["learning_rate"], np.float32))
    for group in opt.param_groups:
        group["lr"] = lr


# --- full checkpoints -----------------------------------------------------------------

def _ckpt_blob(state, scheduler_state, epoch, global_step, best_val_loss, best_val_acc,
               itos, stoi, config, log_dir) -> Dict[str, Any]:
    variables = to_jax_variables(state.model)
    blob = {
        "format_version": CHECKPOINT_FORMAT_VERSION,
        "epoch": int(epoch),
        "global_step": int(global_step),
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": optimizer_state_tree(state),
        "scheduler_state": scheduler_state or {},
        "best_val_loss": float(best_val_loss),
        "best_val_acc": float(best_val_acc),
        "itos": list(itos),
        "stoi": {str(k): int(v) for k, v in stoi.items()},
        "config": config,
        "log_dir": log_dir,
    }
    if state.ema_params is not None:
        blob["ema_params"] = to_jax_variables(state.model, state.ema_params)["params"]
    return blob


def save_checkpoint(path: str, state, scheduler_state: Optional[Dict[str, Any]], epoch: int,
                    global_step: int, best_val_loss: float, best_val_acc: float,
                    itos: List[str], stoi: Dict[str, int], config: Dict[str, Any],
                    log_dir: str) -> None:
    """Write a full checkpoint (JAX's layout) atomically."""
    _atomic_write(path, _ckpt_blob(state, scheduler_state, epoch, global_step, best_val_loss,
                                   best_val_acc, itos, stoi, config, log_dir))


def restore_train_state(blob: Dict[str, Any], state):
    """Load a full checkpoint blob into ``state`` (in place; returned):
    parameters, batch statistics, the optimizer's moments, counts and
    learning rate, the step (``global_step``) and, when the state keeps one,
    the EMA (from the blob's, else a copy of the restored parameters)."""
    load_jax_variables(state.model, {"params": blob["params"],
                                     "batch_stats": blob["batch_stats"]})
    load_optimizer_state(state, blob["opt_state"])
    if state.ema_params is not None:
        if blob.get("ema_params"):
            ema = params_by_name(state.model, blob["ema_params"])
            for n, t in state.ema_params.items():
                t.copy_(torch.from_numpy(ema[n]))
        else:
            for n, p in state.model.named_parameters():
                state.ema_params[n].copy_(p.detach())
    state.step = int(blob.get("global_step", 0))
    return state


class AsyncCheckpointer:
    """Background checkpoint writer: the blob is taken from the state (a
    device-to-host copy) in the caller's thread, so the next step may change
    the state at once; msgpack encoding and the file write run on one worker
    thread behind a queue of one.  ``wait()`` drains it and raises the first
    write error; ``close()`` drains and stops the worker."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._errors: list = []
        self.bytes_written = 0  # by the worker: encoded bytes and seconds
        self.write_seconds = 0.0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, blob = item
                t0 = time.perf_counter()
                self.bytes_written += _atomic_write(path, blob)
                self.write_seconds += time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 - raised by wait()
                self._errors.append((item[0], e))
            finally:
                self._q.task_done()

    def save_checkpoint(self, path: str, state, scheduler_state, epoch, global_step,
                        best_val_loss, best_val_acc, itos, stoi, config, log_dir) -> None:
        self._q.put((path, _ckpt_blob(state, scheduler_state, epoch, global_step,
                                      best_val_loss, best_val_acc, itos, stoi, config,
                                      log_dir)))

    def save_weights(self, path: str, state) -> None:
        self._q.put((path, _weights_blob(state)))

    def wait(self) -> None:
        """Block until every queued write is on disk; raise the first error."""
        self._q.join()
        if self._errors:
            path, err = self._errors[0]
            self._errors.clear()
            raise RuntimeError(f"async checkpoint write failed for {path}: {err}") from err

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._worker.join(timeout=5.0)
