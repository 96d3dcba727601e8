"""Data and tensor parallelism: ranks for training, replicas for serving.

Counterpart of ``rcnn_ocr_tpu/parallel/mesh.py``.  In JAX one program
spans every device of a ``("data", "model")`` mesh and GSPMD inserts the
collectives.  The port has two counterparts.

Serving (``OCRInference(mesh=)``, ``ServingArtifact.load(mesh=)``): one
process holds a replica of the weights on each device that
:func:`serving_devices` names, and a :class:`ReplicaSet` splits every batch
into contiguous row blocks in replica order (JAX's ``P("data")``), runs each
block on its own device in its own thread and stream, and the host gathers
the outputs in row order (:func:`gather_rows`).  Decoding needs no
collective, as in JAX.

Training: the mesh is the process group's ranks, ``D x M`` of them, rank
``r`` at data index ``r // M`` and model index ``r % M`` (JAX's
``np.array(devices).reshape(shape)``).  :func:`make_mesh` builds one group
per model column (the ranks of one model index: the *data group*) and one
per data row (the ranks of one data index: the *model group*).  The ranks
of a data row hold the same rows of every global batch
(``data/loader.py:ProcessShardedBatchSampler`` over the data index and
count) and draw the same masks; the port writes the reductions out:

* :func:`init_distributed` joins the group that ``python -m
  torch.distributed.run`` describes (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for a card, gloo
  for the CPU, or the backend the caller names;
* :func:`batch_shard` marks a thread's work as this data index's block of
  a global batch.  Inside it :func:`rand_rows` draws what one process would
  draw for the whole global batch and keeps the block's rows, and
  :func:`global_sum` sums over the data group (with autograd), which is how
  batch norm takes the global batch's statistics and the losses divide by
  the global count;
* :func:`global_metric_sum` sums a small host vector over the data group
  (or every rank), so that every rank takes the same best-slot, scheduler
  and pruning decisions.

The ``model`` axis (tensor parallelism) shards the big weights as
:data:`DEFAULT_TP_RULES` says (:func:`param_shardings`, JAX's rules matched
against JAX's leaf paths; :func:`tp_report` / :func:`tp_fallback_report`
spell the outcome as JAX does).  A sharded parameter holds this rank's
contiguous block of one dimension (:class:`TPShard`,
``interop/jax_params.py:shard_model``) and the modules that own one call
the autograd Functions below, written for a model axis whose downstream
work is replicated: every model rank computes the same values after a
gather, so a gather's backward takes this rank's slice with no
communication (``torch.distributed.nn``'s all_gather would reduce-scatter
and so scale every gradient by M):

* :func:`copy_to_model` (forward identity, backward all-reduce) on the
  replicated input of a column-sharded op, and :func:`gather_from_model`
  (forward all-gather, backward own slice) on its output: "the first
  consumer gathers";
* :func:`gather_param` (the same pair's gather) on a sharded weight that
  runs whole, ``w_hh`` for the recurrence kernel, ``w_emb`` for the row
  gather;
* :func:`scatter_to_model` (forward own slice, backward all-gather) and
  :func:`reduce_from_model` (forward all-reduce, backward identity) around
  a row-sharded op.

Every collective is an all_reduce, which gloo serves on CUDA tensors too
(two ranks may share one card over gloo; NCCL refuses that): a gather is an
all_reduce of a zeroed buffer into which each rank writes its block, exact
since each element is one rank's value plus zeros.  :data:`TP_TRAFFIC`
counts the model axis's collectives, bytes and host seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import re
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from rcnn_ocr_tpu_torch.ops import kernels

# what stays refused across ranks (a deliberate divergence, ROADMAP.md queue 3)
UNPORTED = "ROADMAP.md queue 3 deliberate divergence: HPO's concurrent trials across ranks"

_DEVICE_SCOPE = threading.local()
_SHARD = threading.local()
# one set of groups per mesh shape: every rank creates every group, in order
_GROUPS: Dict[tuple, tuple] = {}
# the model axis's collectives: calls, bytes of the buffers reduced, host seconds
TP_TRAFFIC: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0}


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
    """The ranks as a ``(data, model)`` grid: ``shape`` maps axis name ->
    size and ``devices`` lists the ranks.  Under a process group the mesh
    knows this rank's place, ``data_index`` and ``model_index``, and its
    two groups: ``data_group`` (the ranks of its model index, over which
    rows and gradients are summed; ``None``, every rank, when the model
    axis is 1) and ``model_group`` (the ranks of its data index, over which
    a sharded weight's blocks are gathered)."""

    shape: Dict[str, int]
    devices: List[int]
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def n_data(self) -> int:
        return self.shape[self.axis_names[0]]

    @property
    def n_model(self) -> int:
        return self.shape.get("model", 1)


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the ranks (``devices``: every rank by default).

    ``shape=None`` is pure data parallelism.  A shape whose product does not
    equal the rank count falls back to pure DP over all ranks with a
    warning, as ``rcnn_ocr_tpu/parallel/mesh.py:make_mesh`` does.  The
    first axis is the data axis; an axis named ``model`` is tensor
    parallelism; any other axis over 1 raises ``NotImplementedError``.
    Under an initialized process group with the default ``devices`` the
    mesh places this rank and builds its groups (see :class:`Mesh`).
    """
    default = devices is None
    devices = list(devices if devices is not None else range(process_count()))
    n = len(devices)
    dp_shape = (n,) + (1,) * (len(axis_names) - 1)
    if shape is None:
        shape = dp_shape
    else:
        shape = tuple(int(s) for s in shape)
        if math.prod(shape) != n:
            warnings.warn(f"mesh shape {shape} does not tile {n} device(s); "
                          f"falling back to pure data-parallel {dp_shape}", stacklevel=2)
            shape = dp_shape
    mesh = Mesh(shape=dict(zip(axis_names, shape)), devices=devices)
    other = {a: s for a, s in list(mesh.shape.items())[1:] if a != "model" and s > 1}
    if axis_names[0] == "model" or other:
        raise NotImplementedError(f"mesh axes {dict(mesh.shape)}: the port places ranks on a "
                                  "data axis first and a 'model' axis after it")
    if not (default and dist.is_available() and dist.is_initialized()):
        return mesh
    d_count, m_count = mesh.n_data, mesh.n_model
    d, m = divmod(dist.get_rank(), m_count)
    if m_count == 1:  # pure DP: the data group is every rank
        return dataclasses.replace(mesh, data_index=d)
    key = (d_count, m_count)
    if key not in _GROUPS:
        _GROUPS[key] = (
            [dist.new_group([i * m_count + j for i in range(d_count)]) for j in range(m_count)],
            [dist.new_group([i * m_count + j for j in range(m_count)]) for i in range(d_count)])
    data_groups, model_groups = _GROUPS[key]
    return dataclasses.replace(mesh, data_index=d, model_index=m, data_group=data_groups[m],
                               model_group=model_groups[d])


@dataclasses.dataclass(frozen=True)
class Shard:
    """This data index's block ``[index * b, (index + 1) * b)`` of a global
    batch of ``count * b`` rows; ``group`` sums over the data axis (``None``:
    every rank)."""

    index: int
    count: int
    group: Any = None


@contextlib.contextmanager
def batch_shard(mesh: Optional[Mesh] = None) -> Iterator[Optional[Shard]]:
    """Inside, this thread's batch is its data index's block of the global
    batch (see the module docstring): ``mesh``'s data index, count and
    group, or every rank as the data axis without one.  Without an
    initialized group it is a no-op."""
    if not (dist.is_available() and dist.is_initialized()):
        yield None
        return
    prev = getattr(_SHARD, "shard", None)
    if mesh is None:
        _SHARD.shard = Shard(dist.get_rank(), dist.get_world_size())
    else:
        _SHARD.shard = Shard(mesh.data_index, mesh.n_data, mesh.data_group)
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
    rows (so the generator advances as in one process) and this block's
    ``b`` rows are returned."""
    shard = current_shard()
    if shard is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    b = int(shape[0])
    full = torch.rand((b * shard.count, *shape[1:]), generator=generator, device=device)
    return full[shard.index * b:(shard.index + 1) * b]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the data axis under :func:`batch_shard` (the
    identity outside it), differentiable: the gradient of a block's share is
    the sum of the data group's gradients of the total, as batch norm over
    the global batch needs.  Runs even at one rank, so the backend is
    exercised and the result is the same bits."""
    shard = current_shard()
    if shard is None:
        return t
    return _AllReduceSum.apply(t, shard.group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the group's gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_into_place(tensors: List[torch.Tensor], group: Any = None) -> None:
    """Sum ``tensors`` (one dtype and device) over ``group`` (every rank by
    default) in place with a single all_reduce of their concatenation."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def _metric_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_metric_sum(values: Sequence[float], group: Any = None) -> np.ndarray:
    """Sum a small host metric vector over ``group`` (every rank by default;
    a mesh's ``data_group`` counts each row once under a model axis; the
    identity in one process) in float64 with one all_reduce: every rank
    receives the same sums, so control decisions driven by validation
    metrics stay identical across ranks
    (``rcnn_ocr_tpu/parallel/mesh.py:global_metric_sum``)."""
    arr = np.asarray(values, np.float64)
    if process_count() == 1:
        return arr
    t = torch.from_numpy(arr.copy()).to(_metric_device())
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


# --- the model axis: rules, reports and collectives --------------------------------

class PartitionSpec(tuple):
    """A leaf's placement, one mesh axis name (or ``None``) per dimension,
    spelled as ``jax.sharding.PartitionSpec`` prints:
    ``PartitionSpec(None, None, 'model')``, ``PartitionSpec('model',)``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


P = PartitionSpec

# Tensor-parallel rules, JAX's (rcnn_ocr_tpu/parallel/mesh.py:105-118):
# param-path regex -> PartitionSpec over the JAX layout.  Paths are
# '/'-joined keys of the params tree; everything unmatched is replicated.
DEFAULT_TP_RULES: Tuple[Tuple[str, PartitionSpec], ...] = (
    (r"enc_rnn\d+/w_ih$", P(None, None, "model")),  # [2, D, 4H] -> shard gates
    (r"enc_rnn\d+/w_hh$", P(None, None, "model")),
    (r"enc_rnn\d+/bias$", P(None, "model")),
    (r"enc_rnn\d+/proj/kernel$", P("model", None)),  # consume sharded 2H
    (r"attn/w_gen$", P(None, "model")),  # [H, V] -> vocab-sharded logits
    (r"attn/b_gen$", P("model")),
    (r"attn/w_emb$", P(None, "model")),
    (r"ctc_proj/kernel$", P(None, "model")),
    (r"ctc_proj/bias$", P("model")),
    (r"cnn/layer[34]_block\d+/conv\d/conv/kernel$", P(None, None, None, "model")),
)


def _iter_paths(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _rebuild(tree: Any, leaf_of: Callable[[str], Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_of, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return leaf_of(prefix)


def _uses_tp(mesh: Mesh) -> bool:
    return "model" in mesh.axis_names and mesh.shape.get("model", 1) > 1


def param_shardings(params: Any, mesh: Mesh,
                    rules: Optional[Sequence[Tuple[str, PartitionSpec]]] = None) -> Any:
    """A params tree (JAX's layout and paths; leaves with ``.shape`` and
    ``.ndim``) -> a tree of :class:`PartitionSpec`.

    With no ``model`` axis (or one of size 1) everything is replicated.
    Otherwise a path a rule matches gets the rule's spec when every
    dimension it names divides evenly by the size of the axis it names,
    else it falls back to replication, as JAX's ``param_shardings`` does."""
    use_tp = _uses_tp(mesh)
    if rules is None:
        rules = DEFAULT_TP_RULES if use_tp else ()
    compiled = [(re.compile(pat), spec) for pat, spec in rules] if use_tp else []
    model_size = mesh.shape.get("model", 1)

    def assign(path: str, leaf) -> PartitionSpec:
        for pat, spec in compiled:
            if pat.search(path):
                ok = True
                for dim, axis in enumerate(spec):
                    if axis is None:
                        continue
                    # against the axis the spec names (a custom rule may
                    # shard over any mesh axis)
                    axis_size = mesh.shape.get(axis, model_size)
                    if dim >= leaf.ndim or leaf.shape[dim] % axis_size != 0:
                        ok = False
                        break
                if ok:
                    return PartitionSpec(*spec)
        return PartitionSpec()

    flat = dict(_iter_paths(params))
    return _rebuild(params, lambda path: assign(path, flat[path]))


def tp_report(shardings: Any) -> Dict[str, str]:
    """``{param_path: str(spec)}`` for every param sharded on an axis."""
    return {path: str(spec) for path, spec in _iter_paths(shardings)
            if any(axis is not None for axis in spec)}


def tp_fallback_report(params: Any, mesh: Mesh,
                       rules: Optional[Sequence[Tuple[str, PartitionSpec]]] = None
                       ) -> Dict[str, str]:
    """Params a rule matches that fell back to replication on divisibility
    (JAX's ``tp_fallback_report``): empty at the production shape on a
    model axis of 2; a model axis that does not divide the vocabulary (8 at
    194 tokens) lands the vocabulary heads here."""
    if not _uses_tp(mesh):
        return {}
    if rules is None:
        rules = DEFAULT_TP_RULES
    compiled = [re.compile(pat) for pat, _ in rules]
    sharded = tp_report(param_shardings(params, mesh, rules))
    return {path: f"shape {tuple(leaf.shape)} indivisible on mesh {dict(mesh.shape)}"
            for path, leaf in _iter_paths(params)
            if path not in sharded and any(pat.search(path) for pat in compiled)}


@dataclasses.dataclass(frozen=True)
class TPShard:
    """What a sharded parameter holds: this rank's contiguous block of torch
    dimension ``dim`` of a tensor whose ``dim`` is ``full`` long, over
    ``mesh``'s model axis."""

    dim: int
    full: int
    mesh: Mesh


def tp_shard(t: torch.Tensor) -> Optional[TPShard]:
    """The :class:`TPShard` of a sharded parameter, else ``None``."""
    return getattr(t, "tp_shard", None)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A contiguous view of ``t``'s storage (a channels-last 4-d tensor as
    NHWC), or a contiguous copy."""
    if t.is_contiguous():
        return t
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1)
    return t.contiguous()


def model_all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over ``mesh``'s model group in place and return it,
    counted in :data:`TP_TRAFFIC`.  Over gloo a card's tensor goes through
    the host: its queued work is waited for before the clock starts, and
    16-bit floats are summed in fp32."""
    buf = _dense(t)
    gloo = dist.get_backend(mesh.model_group) == "gloo"
    if buf.is_cuda and gloo:
        torch.cuda.synchronize(buf.device)
    t0 = time.perf_counter()
    if gloo and buf.dtype in (torch.bfloat16, torch.float16):
        wide = buf.float()
        dist.all_reduce(wide, group=mesh.model_group)
        buf.copy_(wide)
    else:
        dist.all_reduce(buf, group=mesh.model_group)
    TP_TRAFFIC["seconds"] += time.perf_counter() - t0
    TP_TRAFFIC["bytes"] += buf.numel() * buf.element_size()
    TP_TRAFFIC["calls"] += 1
    if buf.data_ptr() != t.data_ptr():  # summed in a contiguous copy
        t.copy_(buf.view_as(t) if buf.shape == t.shape else buf)
    return t


def _own_block(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    k = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model_index * k, k)


def gather_blocks(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The model ranks' blocks of ``dim`` joined in model order (no
    autograd): an all_reduce of a zeroed buffer holding this rank's block,
    which gloo serves on a card's tensors as it does not serve all_gather."""
    dim = dim % t.dim()
    shape = list(t.shape)
    shape[dim] *= mesh.n_model
    buf = t.new_zeros(shape)
    _own_block(buf, dim, mesh).copy_(t)
    return model_all_reduce(buf, mesh)


class _CopyToModel(torch.autograd.Function):
    """Forward identity; backward sums the model ranks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_all_reduce(grad.clone(), ctx.mesh), None


class _GatherFromModel(torch.autograd.Function):
    """Forward all-gather along ``dim``; backward this rank's slice (the
    downstream work is replicated, so every rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return gather_blocks(x.detach(), dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _own_block(grad, ctx.dim, ctx.mesh), None, None


class _ScatterToModel(torch.autograd.Function):
    """Forward this rank's slice along ``dim``; backward all-gather."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _own_block(x, dim, mesh).clone()

    @staticmethod
    def backward(ctx, grad):
        return gather_blocks(grad, ctx.dim, ctx.mesh), None, None


class _ReduceFromModel(torch.autograd.Function):
    """Forward sum over the model ranks; backward identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return model_all_reduce(x.clone(memory_format=torch.contiguous_format), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The replicated input of a column-sharded op (backward: all-reduce)."""
    return _CopyToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """A column-sharded op's output, gathered along ``dim`` (backward: own
    slice)."""
    return _GatherFromModel.apply(x, dim, mesh)


def scatter_to_model(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a replicated tensor's ``dim`` (backward:
    all-gather)."""
    return _ScatterToModel.apply(x, dim, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-sharded op's partial sums, summed (backward: identity)."""
    return _ReduceFromModel.apply(x, mesh)


def gather_param(p: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a parameter: its blocks gathered when it is
    sharded (backward: own slice), else ``p``."""
    s = tp_shard(p)
    return p if s is None else gather_from_model(p, s.dim, s.mesh)


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
