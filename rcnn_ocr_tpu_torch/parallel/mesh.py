"""Data parallelism: ranks for training, replicas for serving.

Counterpart of ``rcnn_ocr_tpu/parallel/mesh.py`` for its ``data`` axis.  In
JAX one program spans every device of the mesh and GSPMD inserts the
reductions.  The port has two counterparts.

Serving (``OCRInference(mesh=)``, ``ServingArtifact.load(mesh=)``): one
process holds a replica of the weights on each device that
:func:`serving_devices` names, and a :class:`ReplicaSet` splits every batch
into contiguous row blocks in replica order (JAX's ``P("data")``), runs each
block on its own device in its own thread and stream, and the host gathers
the outputs in row order (:func:`gather_rows`).  Decoding needs no
collective, as in JAX.

Training: the data axis is the process group's ranks, each holding
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
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from rcnn_ocr_tpu_torch.ops import kernels

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


# --- serving replicas ---------------------------------------------------------------

def serving_devices(mesh: Any, device: Union[str, torch.device]) -> Optional[List[torch.device]]:
    """The replicas' devices for a serving engine's ``mesh=`` argument
    (``rcnn_ocr_tpu/inference.py``'s ``mesh=``), or ``None`` for no mesh.

    ``True`` is every visible card, ``cuda:0`` to ``cuda:{n-1}``; it raises
    when there is none, and with a CPU ``device`` it is one CPU replica.  A
    sequence of devices stands for JAX's explicit ``Mesh``: one replica per
    entry, so a device named twice holds two replicas (this is how one card,
    or the CPU, serves several).  Its devices must be of ``device``'s type.
    ``None`` and ``False`` are no mesh.
    """
    if mesh is None or mesh is False:
        return None
    dev = torch.device(device)
    if mesh is True:
        if dev.type == "cpu":
            return [torch.device("cpu")]
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("mesh=True serves on every visible card and none is visible; "
                               "pass device='cpu' to serve on the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(mesh, (str, torch.device)) or not isinstance(mesh, Sequence):
        raise TypeError(f"mesh must be True, False, None or a sequence of devices, got {mesh!r}")
    devices = [torch.device(d) for d in mesh]
    if not devices:
        raise ValueError("mesh: an empty device list")
    for i, d in enumerate(devices):
        if d.type != dev.type:
            raise ValueError(f"mesh device {d} is not a {dev.type} device (the engine's device "
                             f"is {dev})")
        if d.type == "cuda":
            if d.index is None:
                devices[i] = d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"mesh device {d}: only {torch.cuda.device_count()} card(s) "
                                 "are visible")
    return devices


def to_host(out):
    """A kernel's output (a tensor or a tuple of them) as numpy arrays."""
    if isinstance(out, (tuple, list)):
        return tuple(to_host(t) for t in out)
    return out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def gather_rows(parts: List[Any]):
    """The replicas' host outputs (arrays, or tuples of arrays) joined along
    the batch axis in replica order."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate([p[k] for p in parts]) for k in range(len(parts[0])))
    return np.concatenate(parts)


class ReplicaSet:
    """The devices of a serving engine's replicas and how a batch runs on them.

    Without a mesh there is one replica, and :meth:`run` calls its work on
    the calling thread.  Under a mesh every replica has a worker thread and,
    on a card, a stream of its own: :meth:`run` splits the batch's rows into
    equal contiguous blocks in replica order, runs each replica's work in
    its thread with its card current and its stream the current one, waits
    for every block and returns their results in replica order.  A
    replica's exception propagates.
    """

    def __init__(self, devices: Sequence[torch.device], mesh: bool):
        self.devices = list(devices)
        self.mesh = bool(mesh)
        self._streams = [torch.cuda.Stream(device=d) if self.mesh and d.type == "cuda" else None
                         for d in self.devices]
        # one thread per replica, so a replica always runs on the same thread
        # (and cuBLAS keeps one workspace per replica)
        self._workers = [ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"replica{i}")
                         for i in range(len(self.devices))] if self.mesh else []

    def __len__(self) -> int:
        return len(self.devices)

    def round_batch(self, batch_size: int) -> int:
        """A batch size that tiles the replicas: rounded up to a multiple of
        their count (``rcnn_ocr_tpu/inference.py:_round_batch``)."""
        if not self.mesh:
            return batch_size
        n = len(self.devices)
        return max(n, -(-batch_size // n) * n)

    @contextlib.contextmanager
    def _scope(self, i: int) -> Iterator[None]:
        """Replica ``i``'s card current and its stream the current one (a
        no-op for a CPU replica or without a mesh)."""
        stream = self._streams[i] if self.mesh else None
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[i]), torch.cuda.stream(stream):
            yield

    def run(self, work: Callable[[int, int, int], Any], rows: int) -> List[Any]:
        """``[work(i, lo, hi) for each replica i]``, replica ``i`` taking rows
        ``[lo, hi)`` of ``rows``; under a mesh each in its own thread and
        stream, every replica's device work complete on return."""
        if not self.mesh:
            return [work(0, 0, rows)]
        n = len(self.devices)
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not tile {n} replicas")
        per = rows // n
        plain = kernels.plain_forced()

        def replica(i: int):
            with self._scope(i), kernels.plain_only() if plain else contextlib.nullcontext():
                out = work(i, i * per, (i + 1) * per)
                if self._streams[i] is not None:
                    self._streams[i].synchronize()
                return out

        futures = [w.submit(replica, i) for i, w in enumerate(self._workers)]
        wait(futures)
        return [f.result() for f in futures]
