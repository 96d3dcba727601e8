"""Bidirectional LSTM recurrence from precomputed input projections.

Counterpart of ``rcnn_ocr_tpu/ops/lstm_pallas.py:bilstm_scan``.  Takes
``xs [T, 2, B, 4H]`` (direction 1 pre-flipped in time, see
:class:`rcnn_ocr_tpu_torch.models.lstm.BiLSTM`) and ``w_hh [2, H, 4H]`` and
returns ``ys [T, 2, B, H]`` in fp32.  h stays in fp32 across steps and the
gates are computed in fp32 whatever ``w_hh``'s dtype, as in the Pallas
kernel.  On a CUDA tensor :func:`bilstm_scan` launches ``csrc/bilstm_scan.cu``
(one launch per layer, both directions, all steps; :func:`route` says which
of its two routes a shape takes); on a CPU tensor it runs
:func:`scan_reference`.  That choice lives in the registered operator
``torch.ops.rcnn_ocr_tpu_torch.bilstm_scan`` (:func:`bilstm_scan_op`), whose
fake implementation gives ``torch.export`` the output's shape: an exported
serving program calls the same operator, and so the same kernel, on the
card.

:func:`bilstm_scan` is differentiable on both devices: a
``torch.autograd.Function`` whose backward recomputes :func:`scan_reference`
under autograd and takes its gradients, as ``lstm_pallas.py:_bilstm_bwd``
does through ``jax.vjp`` of ``_scan_reference`` (one forward recompute in
place of hand-derived BPTT).
"""

from __future__ import annotations

import torch

from rcnn_ocr_tpu_torch.models.lstm import lstm_cell_gates
from rcnn_ocr_tpu_torch.ops import kernels

_W_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def scan_reference(xs: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    """Plain version: the step loop of ``lstm_pallas.py:_scan_reference``."""
    t_steps, _, batch, _ = xs.shape
    w = w_hh.float()
    h = xs.new_zeros((2, batch, hidden), dtype=torch.float32)
    c = torch.zeros_like(h)
    ys = []
    for t in range(t_steps):
        gates = xs[t].float() + torch.bmm(h, w)
        h, c = lstm_cell_gates(gates, c, hidden)
        ys.append(h)
    return torch.stack(ys, dim=0)


def route(batch: int, hidden: int, w_dtype: torch.dtype, device=None) -> dict:
    """The route ``csrc/bilstm_scan.cu`` takes for this shape on ``device``
    (a card; default the current one): ``resident`` (w_hh in the shared
    memory of a cluster of ``cluster`` CTAs per ``rows`` batch rows,
    ``active_clusters`` of them at once) or ``streaming``."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    cluster, rows, smem, active = kernels.BILSTM_SCAN.plan(dev, batch, hidden,
                                                           _W_DTYPES[w_dtype])
    return dict(route="resident" if cluster else "streaming", cluster=cluster, rows=rows,
                smem=smem, active_clusters=active)


@torch.library.custom_op("rcnn_ocr_tpu_torch::bilstm_scan", mutates_args=())
def bilstm_scan_op(xs: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    """The forward as a registered operator, so that ``torch.export`` records
    it in a program: on a CUDA tensor the kernel, on a CPU tensor
    :func:`scan_reference`.  As for ``se_scale_op``, the kernel's branch
    makes its inputs contiguous (a no-op on the live path)."""
    if not kernels.use_kernel(xs):
        return scan_reference(xs, w_hh, hidden)
    return _launch(xs.contiguous(), w_hh.contiguous(), hidden)


@bilstm_scan_op.register_fake
def _bilstm_scan_fake(xs, w_hh, hidden):
    return xs.new_empty((xs.shape[0], 2, xs.shape[2], hidden), dtype=torch.float32)


class _BiLSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, w_hh, hidden):
        ctx.save_for_backward(xs, w_hh)
        ctx.hidden = hidden
        return bilstm_scan_op(xs, w_hh, hidden)

    @staticmethod
    def backward(ctx, dys):
        xs, w_hh = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip((xs, w_hh), wanted)]
            ys = scan_reference(*leaves, ctx.hidden)
            grads = torch.autograd.grad(ys, [t for t in leaves if t.requires_grad], dys)
        it = iter(grads)
        return tuple(next(it) if need else None for need in wanted) + (None,)


def bilstm_scan(xs: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    """Run the recurrence; returns ``ys [T, 2, B, H]`` fp32.  Differentiable
    in ``xs`` and ``w_hh`` (w_hh's gradient comes back in w_hh's dtype)."""
    return _BiLSTMScan.apply(xs, w_hh, hidden)


def _launch(xs: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    t_steps, two, batch, g4 = xs.shape
    if two != 2 or g4 != 4 * hidden or tuple(w_hh.shape) != (2, hidden, 4 * hidden):
        raise ValueError(
            f"bilstm_scan: xs {tuple(xs.shape)} / w_hh {tuple(w_hh.shape)} do not fit H={hidden}"
        )
    if xs.dtype != torch.float32 or not xs.is_contiguous():
        raise ValueError("bilstm_scan: xs must be contiguous float32")
    if w_hh.dtype not in _W_DTYPES or not w_hh.is_contiguous() or w_hh.device != xs.device:
        raise ValueError("bilstm_scan: w_hh must be contiguous float32/bfloat16 on xs's device")
    if hidden > 1024:
        raise ValueError(f"bilstm_scan: kernel takes H <= 1024, got {hidden}")
    ys = torch.empty((t_steps, 2, batch, hidden), device=xs.device, dtype=torch.float32)
    if ys.numel() == 0:
        return ys
    kernels.BILSTM_SCAN.launch(xs.device, xs.data_ptr(), w_hh.data_ptr(), ys.data_ptr(),
                               t_steps, batch, hidden, _W_DTYPES[w_hh.dtype])
    return ys
