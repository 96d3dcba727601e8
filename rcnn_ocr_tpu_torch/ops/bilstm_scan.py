"""Bidirectional LSTM recurrence from precomputed input projections.

Counterpart of ``rcnn_ocr_tpu/ops/lstm_pallas.py:bilstm_scan``.  Takes
``xs [T, 2, B, 4H]`` (direction 1 pre-flipped in time, see
:class:`rcnn_ocr_tpu_torch.models.lstm.BiLSTM`) and ``w_hh [2, H, 4H]`` and
returns ``ys [T, 2, B, H]`` in fp32.  h stays in fp32 across steps and the
gates are computed in fp32 whatever ``w_hh``'s dtype, as in the Pallas
kernel.  On a CUDA tensor :func:`bilstm_scan` launches ``csrc/bilstm_scan.cu``
(one launch per layer, both directions, all steps); on a CPU tensor it runs
:func:`scan_reference`.  Forward only: the training slice adds the backward.
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


def bilstm_scan(xs: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    """Run the recurrence; returns ``ys [T, 2, B, H]`` fp32."""
    if not kernels.use_kernel(xs):
        return scan_reference(xs, w_hh, hidden)
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
    fn = kernels.BILSTM_SCAN.fn()
    err = fn(xs.data_ptr(), w_hh.data_ptr(), ys.data_ptr(), t_steps, batch, hidden,
             _W_DTYPES[w_hh.dtype], kernels.stream_ptr())
    kernels.BILSTM_SCAN.check(err)
    kernels.BILSTM_SCAN.launches += 1
    return ys
