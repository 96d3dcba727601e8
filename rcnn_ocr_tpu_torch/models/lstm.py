"""Bidirectional LSTM encoder layer.

Counterpart of ``rcnn_ocr_tpu/models/lstm.py``, with the same parameter
layout (``w_ih [2, D, 4H]``, ``w_hh [2, H, 4H]``, ``bias [2, 4H]``, gate
order (i, f, g, o), direction 0 forward) so checkpoints carry across as
they are:

* the input projection for every step and both directions is one einsum
  outside the recurrence;
* the backward stream is flipped in time before the recurrence and the
  outputs are flipped back after it;
* the recurrence itself is :func:`rcnn_ocr_tpu_torch.ops.bilstm_scan.bilstm_scan`
  (the CUDA kernel on the card).

On a model axis (``DEFAULT_TP_RULES``) ``w_ih`` and ``bias`` hold this
rank's gate columns: the input projection runs on them and is gathered
whole; ``w_hh`` is gathered, so the recurrence runs whole and unchanged on
every rank; ``proj`` holds rows of the 2H inputs, and its partial products
are summed over the ranks.
"""

from __future__ import annotations

import torch
from torch import nn

from rcnn_ocr_tpu_torch.parallel.mesh import (
    copy_to_model,
    gather_from_model,
    gather_param,
    reduce_from_model,
    scatter_to_model,
    tp_shard,
)


def lstm_cell_gates(gates: torch.Tensor, c: torch.Tensor, hidden: int):
    """Apply the (i, f, g, o) LSTM nonlinearity.  ``gates``: [..., 4H]."""
    i = torch.sigmoid(gates[..., :hidden])
    f = torch.sigmoid(gates[..., hidden : 2 * hidden])
    g = torch.tanh(gates[..., 2 * hidden : 3 * hidden])
    o = torch.sigmoid(gates[..., 3 * hidden :])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


class BiLSTM(nn.Module):
    """1-layer bidirectional LSTM + Linear(2H -> out), input/output [B, T, *]."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype
        h4 = 4 * hidden_size
        self.w_ih = nn.Parameter(torch.zeros(2, in_size, h4))
        self.w_hh = nn.Parameter(torch.zeros(2, hidden_size, h4))
        self.bias = nn.Parameter(torch.zeros(2, h4))
        self.proj = nn.Linear(2 * hidden_size, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from rcnn_ocr_tpu_torch.ops.bilstm_scan import bilstm_scan

        dt = self.dtype
        hidden = self.hidden_size
        x = x.to(dt)
        # one matmul for every step of both directions: [2, B, T, 4H] fp32
        ih = tp_shard(self.w_ih)
        if ih is None:
            x_proj = torch.einsum("btd,kdg->kbtg", x, self.w_ih.to(dt)).float()
            x_proj = x_proj + self.bias[:, None, None, :]
        else:  # this rank's 4H/M gate columns, gathered whole
            x_proj = torch.einsum("btd,kdg->kbtg", copy_to_model(x, ih.mesh),
                                  self.w_ih.to(dt)).float()
            x_proj = x_proj + self.bias[:, None, None, :]  # its columns too
            x_proj = gather_from_model(x_proj, -1, ih.mesh)
        # time-major, backward stream pre-flipped: xs[t, 1] = proj_bw[T-1-t]
        xs = torch.stack([x_proj[0], torch.flip(x_proj[1], dims=(1,))], dim=0)
        xs = xs.permute(2, 0, 1, 3).contiguous()  # [T, 2, B, 4H]
        # the recurrence runs whole on every rank (a sharded w_hh gathered)
        ys = bilstm_scan(xs, gather_param(self.w_hh).to(dt).contiguous(), hidden)  # [T, 2, B, H]
        fw = ys[:, 0].transpose(0, 1)
        bw = torch.flip(ys[:, 1], dims=(0,)).transpose(0, 1)
        h_cat = torch.cat([fw, bw], dim=-1).to(dt)  # [B, T, 2H]
        pj = tp_shard(self.proj.weight)
        if pj is None:
            return nn.functional.linear(h_cat, self.proj.weight.to(dt), self.proj.bias.to(dt))
        # row-sharded: this rank's 2H/M inputs times its rows, summed over the ranks
        part = nn.functional.linear(scatter_to_model(h_cat, -1, pj.mesh),
                                    self.proj.weight.to(dt)).float()
        return (reduce_from_model(part, pj.mesh) + self.proj.bias.float()).to(dt)
