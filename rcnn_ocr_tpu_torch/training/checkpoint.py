"""Read and write the JAX package's msgpack checkpoints without flax or msgpack.

Counterpart of ``rcnn_ocr_tpu/training/checkpoint.py``: ``load_checkpoint_blob``
(with its format-version refusal), ``load_variables``, ``save_weights``,
``save_checkpoint``, ``restore_train_state`` and ``AsyncCheckpointer``.
The msgpack format itself (flax's encoding, byte for byte, and the
format-version refusal) is :mod:`rcnn_ocr_tpu_torch.training.msgpack_codec`,
re-exported here.

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

On a model axis the files hold the whole tree all the same: building a blob
(:func:`checkpoint_blob`, :func:`weights_blob`, :func:`optimizer_state_tree`)
gathers every sharded parameter, EMA leaf and moment from the model ranks,
so every rank of the job builds it (a collective) and the lead rank writes
it; loading (:func:`restore_train_state`, :func:`load_optimizer_state`)
cuts each leaf to the rank's block.  A sharded run resumes from one
process's checkpoint, and one process from a sharded run's.
"""

from __future__ import annotations

import queue
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
from rcnn_ocr_tpu_torch.training.msgpack_codec import (  # noqa: F401 - re-exported
    CHECKPOINT_FORMAT_VERSION,
    BFloat16Array,
    _atomic_write,
    load_checkpoint_blob,
    msgpack_restore,
    msgpack_serialize,
)


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


CKPT_SUFFIX = "_ckpt.msgpack"
WEIGHTS_SUFFIX = "_weights.msgpack"


def weights_blob(state) -> Dict[str, Any]:
    """The model variables an EMA run deploys (its EMA parameters, as JAX's
    ``_weights_blob``), else the model's own."""
    return {"format_version": CHECKPOINT_FORMAT_VERSION,
            **to_jax_variables(state.model, state.ema_params)}


def save_weights(path: str, state) -> None:
    """Write a train state's bare weights file ``{"format_version",
    "params", "batch_stats"}``, atomically."""
    _atomic_write(path, weights_blob(state))


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

def checkpoint_blob(state, scheduler_state, epoch, global_step, best_val_loss, best_val_acc,
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
    _atomic_write(path, checkpoint_blob(state, scheduler_state, epoch, global_step, best_val_loss,
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
        self._q.put((path, checkpoint_blob(state, scheduler_state, epoch, global_step,
                                      best_val_loss, best_val_acc, itos, stoi, config,
                                      log_dir)))

    def save_weights(self, path: str, state) -> None:
        self._q.put((path, weights_blob(state)))

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
