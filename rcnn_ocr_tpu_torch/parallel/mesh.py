"""Data parallelism across processes: one rank per card, ``torch.distributed``.

Counterpart of ``rcnn_ocr_tpu/parallel/mesh.py`` for its ``data`` axis.  In
JAX one program spans every device of the mesh and GSPMD inserts the
reductions; here the data axis is the process group's ranks, each holding
its own rows of every global batch (``data/loader.py:ProcessShardedBatchSampler``)
on its own card, and the port writes the reductions out:

* :func:`init_distributed` joins the group that ``python -m
  torch.distributed.run`` describes (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for a card, gloo
  for the CPU, or the backend the caller names;
* :func:`batch_shard` marks a thread's work as this rank's contiguous block
  of a global batch.  Inside it :func:`rand_rows` draws what one process
  would draw for the whole global batch and keeps this rank's rows, and
  :func:`global_sum` sums over the ranks (with autograd), which is how batch
  norm takes the global batch's statistics and the losses divide by the
  global count;
* :func:`global_metric_sum` sums a small host vector over the ranks, so
  that every rank takes the same best-slot, scheduler and pruning decisions.

The one collective used is all_reduce, which gloo serves on CUDA tensors
too (two ranks may share one card over gloo; NCCL refuses that).
A ``model`` axis over 1 (tensor parallelism) is not ported and raises
(ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import threading
import warnings
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

UNPORTED = "ROADMAP queue 1, item 13"

_DEVICE_SCOPE = threading.local()
_SHARD = threading.local()


def init_distributed(backend: Optional[str] = None, device: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group of a ``torch.distributed.run`` launch and
    return this rank's device: ``cuda:<LOCAL_RANK>`` when ``device`` is
    ``None`` or ``"cuda"``, else ``device`` as named.  ``backend`` defaults to
    NCCL for a card and gloo for the CPU; a named backend is used as it is.
    ``timeout_s`` bounds every collective (a rank that stops answering fails
    the others instead of hanging them)."""
    try:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(f"init_distributed: {e.args[0]} is not set; start the job with "
                           "python -m torch.distributed.run") from None
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(f"cuda:{local}" if device in (None, "cuda") else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs: Dict[str, Any] = {}
    if timeout_s:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            **kwargs)
    return dev


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks (1 without a group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@contextlib.contextmanager
def device_scope(devices: Sequence[Any]):
    """Pin the work of this thread to a device subset (parallel HPO trials,
    :mod:`rcnn_ocr_tpu_torch.hpo.driver`).  Thread-local, as in JAX."""
    prev = getattr(_DEVICE_SCOPE, "devices", None)
    _DEVICE_SCOPE.devices = list(devices)
    try:
        yield
    finally:
        _DEVICE_SCOPE.devices = prev


def scoped_devices() -> Optional[list]:
    """The device subset pinned by :func:`device_scope` (None = all)."""
    return getattr(_DEVICE_SCOPE, "devices", None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis over the ranks: ``shape`` maps axis name -> size and
    ``devices`` lists the ranks, one card each."""

    shape: Dict[str, int]
    devices: List[int]

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the ranks (``devices``: every rank by default).

    ``shape=None`` is pure data parallelism.  A shape asking for any axis but
    the first over 1 (a ``model`` axis: tensor parallelism) raises
    ``NotImplementedError``, since that is not ported.  A data-only shape
    whose product does not equal the rank count falls back to pure DP over
    all ranks with a warning, as ``rcnn_ocr_tpu/parallel/mesh.py:make_mesh``
    does.
    """
    devices = list(devices if devices is not None else range(process_count()))
    n = len(devices)
    dp_shape = (n,) + (1,) * (len(axis_names) - 1)
    if shape is None:
        shape = dp_shape
    else:
        shape = tuple(int(s) for s in shape)
        if any(size > 1 for size in shape[1:]):
            raise NotImplementedError(
                f"mesh shape {shape} over axes {tuple(axis_names)}: an axis besides "
                f"{axis_names[0]!r} over 1 asks for tensor parallelism, which is not ported "
                f"({UNPORTED})")
        if math.prod(shape) != n:
            warnings.warn(f"mesh shape {shape} does not tile {n} device(s); "
                          f"falling back to pure data-parallel {dp_shape}", stacklevel=2)
            shape = dp_shape
    return Mesh(shape=dict(zip(axis_names, shape)), devices=devices)


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's block ``[index * b, (index + 1) * b)`` of a global batch of
    ``count * b`` rows."""

    index: int
    count: int


@contextlib.contextmanager
def batch_shard() -> Iterator[Optional[Shard]]:
    """Inside, this thread's batch is its rank's block of the global batch
    (see the module docstring).  Without an initialized group it is a
    no-op."""
    if not (dist.is_available() and dist.is_initialized()):
        yield None
        return
    prev = getattr(_SHARD, "shard", None)
    _SHARD.shard = Shard(dist.get_rank(), dist.get_world_size())
    try:
        yield _SHARD.shard
    finally:
        _SHARD.shard = prev


def current_shard() -> Optional[Shard]:
    """The :func:`batch_shard` in force on this thread, if any."""
    return getattr(_SHARD, "shard", None)


def rand_rows(shape: Sequence[int], generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """``torch.rand(shape)`` of a batch-leading shape, as the global batch
    draws it: under :func:`batch_shard` the draw covers all ``count * b``
    rows (so the generator advances as in one process) and this rank's
    ``b`` rows are returned."""
    shard = current_shard()
    if shard is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    b = int(shape[0])
    full = torch.rand((b * shard.count, *shape[1:]), generator=generator, device=device)
    return full[shard.index * b:(shard.index + 1) * b]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks under :func:`batch_shard` (the
    identity outside it), differentiable: the gradient of a rank's share is
    the sum of the ranks' gradients of the total, as batch norm over the
    global batch needs.  Runs even at one rank, so the backend is exercised
    and the result is the same bits."""
    shard = current_shard()
    if shard is None:
        return t
    return _AllReduceSum.apply(t)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def sum_into_place(tensors: List[torch.Tensor]) -> None:
    """Sum ``tensors`` (one dtype and device) over the ranks in place with a
    single all_reduce of their concatenation."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def _metric_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_metric_sum(values: Sequence[float]) -> np.ndarray:
    """Sum a small host metric vector over the ranks (identity at one rank)
    in float64 with one all_reduce: every rank receives the same sums, so
    control decisions driven by validation metrics stay identical across
    ranks (``rcnn_ocr_tpu/parallel/mesh.py:global_metric_sum``)."""
    arr = np.asarray(values, np.float64)
    if process_count() == 1:
        return arr
    t = torch.from_numpy(arr.copy()).to(_metric_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def local_batch_rows(*arrays) -> list:
    """This rank's rows of batch outputs, as numpy arrays, row-aligned.

    In JAX a batch-sharded output spans devices of other hosts, and this
    gathers the addressable shards in global row order.  Here a rank only
    ever holds its own rows, so it is a conversion: tensors are fetched to
    the host, arrays pass through."""
    return [a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in arrays]
