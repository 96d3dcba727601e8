"""Optimizers and learning-rate schedulers.

Counterpart of ``rcnn_ocr_tpu/training/optim.py``, with the semantics of
its optax chains:

* ``Adam``: L2 weight decay added to the gradient before Adam
  (``optax.add_decayed_weights`` then ``scale_by_adam``, eps 1e-8, eps_root
  0), which is what ``torch.optim.Adam(weight_decay=w)`` does;
* ``AdamW``: decoupled decay (``optax.adamw``, ``torch.optim.AdamW``);
* ``SGD``: L2 decay, then ``optax.trace(decay=momentum)`` (a heavy-ball
  buffer ``t = g + momentum * t``, ``torch.optim.SGD``'s with no dampening);
* ``grad_clip > 0``: the raw gradients are scaled by optax's
  ``clip_by_global_norm`` factor, ``max_norm / ‖g‖`` when ``‖g‖ >= max_norm``
  (not ``clip_grad_norm_``'s ``max_norm / (‖g‖ + 1e-6)``), before the
  optimizer sees them.

:func:`build_optimizer` returns an :class:`OptimizerSpec`; its ``init``
makes the torch optimizer over a model's parameters and its ``apply``
clips and steps.  The schedulers are pure Python and set the learning rate
through :func:`set_lr`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional

import torch

from rcnn_ocr_tpu_torch.parallel.mesh import model_all_reduce, tp_shard


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str
    lr: float
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 0.0

    def init(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        params = list(params)
        if self.name == "Adam":
            return torch.optim.Adam(params, lr=self.lr, eps=1e-8, weight_decay=self.weight_decay)
        if self.name == "AdamW":
            return torch.optim.AdamW(params, lr=self.lr, eps=1e-8,
                                     weight_decay=self.weight_decay)
        return torch.optim.SGD(params, lr=self.lr, momentum=self.momentum,
                               weight_decay=self.weight_decay)

    def apply(self, optimizer: torch.optim.Optimizer) -> None:
        """Clip the gradients (when ``grad_clip``) and take one step."""
        if self.grad_clip:
            clip_by_global_norm_(
                [p for g in optimizer.param_groups for p in g["params"] if p.grad is not None],
                self.grad_clip)
        optimizer.step()


def clip_by_global_norm_(params: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by ``max_norm / ‖g‖`` when the global
    norm ``‖g‖ >= max_norm`` (optax's rule); returns ``‖g‖``.  No host sync
    (on a model axis, one all_reduce).

    ``‖g‖`` is the norm of the logical parameters: on a model axis the
    squares of the sharded parameters' blocks are summed over the model
    ranks once, and a replicated parameter, whole on every rank, counts
    once."""
    grads = [p.grad for p in params]
    shards = [tp_shard(p) for p in params]
    sharded = [g for g, s in zip(grads, shards) if s is not None]
    if not sharded:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    else:
        def sq(gs):
            return torch.stack([torch.linalg.vector_norm(g.float()) ** 2 for g in gs]).sum()
        own = model_all_reduce(sq(sharded), next(s for s in shards if s is not None).mesh)
        rest = [g for g, s in zip(grads, shards) if s is None]
        norm = torch.sqrt(own + sq(rest) if rest else own)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm


def build_optimizer(name: str, lr: float, weight_decay: float = 0.0, momentum: float = 0.9,
                    grad_clip: float = 0.0) -> OptimizerSpec:
    """Adam / AdamW / SGD with optional global-norm gradient clipping."""
    if name not in ("Adam", "AdamW", "SGD"):
        raise ValueError(f"Unknown optimizer: {name}")
    return OptimizerSpec(name, lr, weight_decay, momentum, grad_clip)


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (takes effect at the
    next step; nothing is rebuilt)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch-semantics plateau scheduler (mode=min, rel threshold)."""

    base_lr: float
    factor: float = 0.5
    patience: int = 3
    min_lr: float = 1e-7
    threshold: float = 1e-4
    lr: float = None  # type: ignore[assignment]
    best: float = math.inf
    num_bad_epochs: int = 0

    def __post_init__(self):
        if self.lr is None:
            self.lr = self.base_lr

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.lr = float(state["lr"])
        self.best = float(state["best"])
        self.num_bad_epochs = int(state["num_bad_epochs"])


@dataclasses.dataclass
class CosineAnnealingLR:
    """torch CosineAnnealingLR, stepped per epoch."""

    base_lr: float
    t_max: int
    eta_min: float = 0.0
    epoch: int = 0
    lr: float = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.lr is None:
            self.lr = self.base_lr

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        self.lr = self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.epoch / max(self.t_max, 1))
        ) / 2
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "lr": self.lr}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.epoch = int(state["epoch"])
        self.lr = float(state["lr"])


def build_scheduler(name: Optional[str], base_lr: float, epochs: int):
    """``None`` / ``"None"``, ``"ReduceLROnPlateau"`` or ``"CosineAnnealingLR"``."""
    if name is None or (isinstance(name, str) and name.lower() == "none"):
        return None
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(base_lr=base_lr)
    if name == "CosineAnnealingLR":
        return CosineAnnealingLR(base_lr=base_lr, t_max=epochs)
    raise ValueError(f"Unknown scheduler: {name}")
