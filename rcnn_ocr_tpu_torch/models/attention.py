"""Additive-attention LSTM decoder (eval: teacher-forced and greedy).

Counterpart of ``rcnn_ocr_tpu/models/attention.py:AttentionDecoder`` with
the same raw parameters:

* the attention key projection ``w_i2h`` is applied once, outside the step
  loop;
* the LSTM cell's input weight is split into ``w_ctx`` (context part) and
  ``w_emb`` (a row gather instead of a one-hot matmul);
* blank logits are set to -1e4 when the charset has a blank;
* exactly ``batch_max_length + 1`` steps, with no early exit; greedy feeds
  back the argmax of the blank-masked logits.

Matmuls run in the compute dtype, the cell and softmaxes in fp32, as in
JAX.  Eval only: no attention dropout or scheduled sampling, and beam
search is a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rcnn_ocr_tpu_torch.models.lstm import lstm_cell_gates


class AttentionDecoder(nn.Module):
    def __init__(self, num_classes: int, enc_size: int, hidden_size: int = 256,
                 sos_id: int = 1, eos_id: int = 2, pad_id: int = 0,
                 blank_id: Optional[int] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.hidden_size = hidden_size
        self.sos_id = sos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.blank_id = blank_id
        self.dtype = dtype
        h, v, c = hidden_size, num_classes, enc_size
        self.w_i2h = nn.Parameter(torch.zeros(c, h))
        self.w_h2h = nn.Parameter(torch.zeros(h, h))
        self.b_h2h = nn.Parameter(torch.zeros(h))
        self.v_score = nn.Parameter(torch.zeros(h, 1))
        self.w_ctx = nn.Parameter(torch.zeros(c, 4 * h))
        self.w_emb = nn.Parameter(torch.zeros(v, 4 * h))
        self.w_hh = nn.Parameter(torch.zeros(h, 4 * h))
        self.b_cell = nn.Parameter(torch.zeros(4 * h))
        self.w_gen = nn.Parameter(torch.zeros(h, v))
        self.b_gen = nn.Parameter(torch.zeros(v))

    def _mask_blank(self, logits: torch.Tensor) -> torch.Tensor:
        if self.blank_id is None:
            return logits
        logits = logits.clone()
        logits[..., self.blank_id] = -1e4
        return logits

    def forward(self, batch_H: torch.Tensor, text: Optional[torch.Tensor] = None,
                batch_max_length: int = 25, return_alignment: bool = False):
        """``batch_H [B, T, C]`` -> logits ``[B, steps, V]`` fp32.

        With ``text [B, >= steps]`` (SOS at ``[:, 0]``) the decoder is
        teacher-forced; without it, greedy (``return_alignment`` adds the
        per-step attention argmax ``[B, steps]``).
        """
        batch = batch_H.shape[0]
        hidden = self.hidden_size
        steps = batch_max_length + 1
        dt = self.dtype
        if return_alignment and text is not None:
            raise ValueError("return_alignment is a greedy-decode feature (text=None)")

        bh = batch_H.to(dt)
        keys = torch.matmul(bh, self.w_i2h.to(dt)).float()  # hoisted attention keys
        w_h2h = self.w_h2h.to(dt)
        v = self.v_score.to(dt)
        w_ctx = self.w_ctx.to(dt)
        w_hh = self.w_hh.to(dt)
        w_gen = self.w_gen.to(dt)

        def step(h, c, targets):
            proj_h = torch.matmul(h.to(dt), w_h2h).float() + self.b_h2h
            e = torch.matmul(torch.tanh(keys + proj_h[:, None, :]).to(dt), v)[..., 0]
            alpha = torch.softmax(e.float(), dim=1)  # [B, T]
            align = torch.argmax(alpha, dim=1)
            context = torch.bmm(alpha.to(dt)[:, None, :], bh)[:, 0].float()
            gates = (
                torch.matmul(context.to(dt), w_ctx).float()
                + self.w_emb[targets]  # one-hot matmul == row gather
                + torch.matmul(h.to(dt), w_hh).float()
                + self.b_cell
            )
            h_new, c_new = lstm_cell_gates(gates, c, hidden)
            return h_new, c_new, align

        h = bh.new_zeros((batch, hidden), dtype=torch.float32)
        c = torch.zeros_like(h)

        if text is not None:
            hs = []
            for t in range(steps):
                h, c, _ = step(h, c, text[:, t].long())
                hs.append(h)
            out_hid = torch.stack(hs, dim=1)  # [B, steps, H]
            logits = torch.matmul(out_hid.to(dt), w_gen).float() + self.b_gen
            return self._mask_blank(logits)

        targets = torch.full((batch,), self.sos_id, dtype=torch.long, device=bh.device)
        logits_s, align_s = [], []
        for _ in range(steps):
            h, c, align = step(h, c, targets)
            logits_t = torch.matmul(h.to(dt), w_gen).float() + self.b_gen
            logits_t = self._mask_blank(logits_t)
            targets = torch.argmax(logits_t, dim=-1)
            logits_s.append(logits_t)
            align_s.append(align)
        logits = torch.stack(logits_s, dim=1)
        if return_alignment:
            return logits, torch.stack(align_s, dim=1)
        return logits
