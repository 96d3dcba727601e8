"""The train and eval steps.

Counterpart of ``rcnn_ocr_tpu/training/train_step.py``.  A
:class:`TrainState` holds the model (its parameters and its batch-norm
running statistics), its device (the card unless the CPU is asked for), the
torch optimizer, the step count and, for an EMA run, an fp32 copy of the
parameters.  :func:`make_train_step` returns
``train_step(state, batch, generator) -> metrics``, which runs the model in
train mode on the batch (the batch dict of the JAX step: ``image`` NHWC
normalized, ``text_in``, ``target_y``, ``valid``, ``ctc_labels``,
``ctc_paddings``; numpy arrays or tensors), takes one optimizer step and
returns the losses as 0-d tensors on the model's device (no host sync).

Losses, as in JAX: token-mean cross-entropy over non-PAD targets of valid
rows (``masked_token_ce``, optional label smoothing) for the attention head,
:func:`rcnn_ocr_tpu_torch.ops.ctc.ctc_loss` for the CTC head, and
``attn + ctc_loss_weight * ctc`` for ``head="both"``.

``grad_accum=A > 1`` takes the batch stacked ``[A, B/A, ...]`` like JAX's
and runs the A microbatches in turn at fixed parameters: the update uses
the mean of their gradients, and batch norm's running statistics advance
once per microbatch.  ``ema_decay=d > 0`` advances ``ema <- d * ema +
(1 - d) * params`` after each update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rcnn_ocr_tpu_torch.inference import resolve_device
from rcnn_ocr_tpu_torch.ops import augment as augment_ops
from rcnn_ocr_tpu_torch.ops.augment import device_normalize
from rcnn_ocr_tpu_torch.ops.ctc import ctc_loss
from rcnn_ocr_tpu_torch.training.optim import OptimizerSpec

HEADS = ("attention", "ctc", "both")


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    device: torch.device  # where the model's parameters live
    # fp32 exponential moving average of the parameters, by name (None
    # unless the run keeps one): the weights an EMA run evaluates and saves
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    # the spec the optimizer came from (a full checkpoint writes its state
    # as the optax chain this spec names)
    tx: Optional[OptimizerSpec] = None


def create_train_state(model: nn.Module, tx: OptimizerSpec, ema: bool = False,
                       device: Union[str, torch.device] = "cuda") -> TrainState:
    """Step 0 with the model moved to ``device`` (the card unless ``"cpu"``
    is asked for; raises when there is no card), the optimizer over its
    parameters, and an fp32 EMA copy of them when ``ema``."""
    model.to(resolve_device(device))
    ema_params = None
    if ema:
        ema_params = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    return TrainState(step=0, model=model, optimizer=tx.init(model.parameters()),
                      device=next(model.parameters()).device, ema_params=ema_params, tx=tx)


def _model_device(model: nn.Module, state: TrainState) -> torch.device:
    if state.model is not model:
        raise ValueError("the state holds another model than this step was made for")
    device = next(model.parameters()).device
    if device != state.device:
        raise ValueError(f"the model is on {device}, its train state on {state.device}")
    return device


def masked_token_ce(logits: torch.Tensor, targets: torch.Tensor, pad_id: int,
                    valid_rows: Optional[torch.Tensor] = None,
                    label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over non-PAD tokens of valid rows; with
    ``label_smoothing = eps``, ``(1 - eps) * CE(target) + eps * mean_v(-log p_v)``
    per token."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (-logp.mean(dim=-1))
    mask = (targets != pad_id).float()
    if valid_rows is not None:
        mask = mask * valid_rows.float()[:, None]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _on_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device, non_blocking=True)
    return out


def _ctc(logits: torch.Tensor, batch: Dict[str, torch.Tensor], blank_id: int) -> torch.Tensor:
    frames = torch.zeros(logits.shape[:2], device=logits.device)  # no frame is padded
    return ctc_loss(logits, frames, batch["ctc_labels"], batch["ctc_paddings"], blank_id,
                    valid=batch.get("valid"))


def make_train_step(model: nn.Module, tx: OptimizerSpec, max_len: int, pad_id: int,
                    head: str = "attention", ctc_blank_id: int = 0,
                    ctc_loss_weight: float = 1.0, augment: Optional[Dict] = None,
                    grad_accum: int = 1, ema_decay: float = 0.0,
                    label_smoothing: float = 0.0) -> Callable:
    """``train_step(state, batch, generator) -> metrics`` for ``model`` (the
    state's) and ``tx`` (the spec its optimizer came from); ``generator`` (a
    ``torch.Generator`` on the model's device) gives every random bit.

    ``augment`` (the host pipeline's config keys): ``batch["image"]``
    arrives resize-padded uint8 and goes through
    :func:`rcnn_ocr_tpu_torch.ops.augment.device_train_augment` on the
    model's device with the step's generator, before the model's draws."""
    if head not in HEADS:
        raise ValueError(f"unknown head: {head}")

    def loss_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        x, valid = batch["image"], batch.get("valid")
        if augment is not None:
            if generator is None:
                raise ValueError("device augmentation draws from the step's generator; pass one")
            x = augment_ops.device_train_augment(x, generator, augment)
        losses = {}
        if head == "ctc":
            losses["ctc_loss"] = _ctc(model.ctc_logits(x, train=True, generator=generator),
                                      batch, ctc_blank_id)
            return losses["ctc_loss"], losses
        if head == "attention":
            attn = model(x, text=batch["text_in"], batch_max_length=max_len, train=True,
                         generator=generator)
        else:
            attn, ctc = model.forward_both(x, text=batch["text_in"], batch_max_length=max_len,
                                           train=True, generator=generator)
            losses["ctc_loss"] = _ctc(ctc, batch, ctc_blank_id)
        losses["attn_loss"] = masked_token_ce(attn, batch["target_y"], pad_id, valid,
                                              label_smoothing)
        total = losses["attn_loss"]
        if head == "both":
            total = total + ctc_loss_weight * losses["ctc_loss"]
        return total, losses

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        device = _model_device(model, state)
        if ema_decay > 0.0 and state.ema_params is None:
            raise ValueError("ema_decay > 0 requires a state built with "
                             "create_train_state(..., ema=True)")
        batch = _on_device(batch, device)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        for a in range(grad_accum):
            micro = batch if grad_accum == 1 else {k: v[a] for k, v in batch.items()}
            total, losses = loss_fn(micro, generator)
            (total / grad_accum).backward()
            for k, v in {"loss": total, **losses}.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        tx.apply(opt)
        if ema_decay > 0.0:
            d = float(ema_decay)
            names = list(state.ema_params)
            own = dict(model.named_parameters())
            with torch.no_grad():
                ema = [state.ema_params[n] for n in names]
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [own[n].detach().float() for n in names], alpha=1.0 - d)
        state.step += 1
        return {k: v / grad_accum for k, v in sums.items()}

    return train_step


def make_eval_step(model: nn.Module, max_len: int, pad_id: int, head: str = "attention",
                   ctc_blank_id: int = 0, use_ema: bool = False) -> Callable:
    """``eval_step(state, batch) -> outputs`` from one encode in eval mode
    (running statistics, nothing dropped): ``val_loss`` (teacher-forced) and
    ``pred_ids`` (greedy) for an attention head, ``ctc_val_loss`` and
    ``ctc_frame_ids`` for a CTC head (``val_loss`` is the CTC loss when the
    head is ``"ctc"``).  ``batch["image"]`` may be uint8 (normalized here) or
    normalized float.

    ``use_ema=True`` evaluates ``state.ema_params`` (the weights an EMA run
    saves), as JAX's ``make_eval_step(use_ema=True)`` does: each parameter's
    storage is swapped for its EMA tensor for the call and swapped back
    after it, so nothing is copied and nothing stays behind."""
    if head not in HEADS:
        raise ValueError(f"unknown head: {head}")
    with_attention = head in ("attention", "both")
    with_ctc = head in ("ctc", "both")

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        device = _model_device(model, state)
        if not use_ema:
            return evaluate(device, batch)
        if state.ema_params is None:
            raise ValueError("use_ema=True requires a state built with "
                             "create_train_state(..., ema=True)")
        params = dict(model.named_parameters())
        own = {n: p.data for n, p in params.items()}
        try:
            for n, p in params.items():
                p.data = state.ema_params[n]
            return evaluate(device, batch)
        finally:
            for n, p in params.items():
                p.data = own[n]

    def evaluate(device: torch.device, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        batch = _on_device(batch, device)
        outs = model.eval_outputs(device_normalize(batch["image"]),
                                  text=batch["text_in"] if with_attention else None,
                                  batch_max_length=max_len, with_attention=with_attention,
                                  with_ctc=with_ctc)
        out = {}
        if with_attention:
            out["val_loss"] = masked_token_ce(outs["tf_logits"], batch["target_y"], pad_id,
                                              batch.get("valid"))
            out["pred_ids"] = torch.argmax(outs["greedy_logits"], dim=-1)
        if with_ctc:
            logits = outs["ctc_logits"]
            loss = (_ctc(logits, batch, ctc_blank_id) if "ctc_labels" in batch
                    else torch.zeros((), device=device))
            out["ctc_val_loss"] = loss
            out["ctc_frame_ids"] = torch.argmax(logits, dim=-1)
            if head == "ctc":
                out["val_loss"] = loss
        return out

    return eval_step
