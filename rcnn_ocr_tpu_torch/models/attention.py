"""Additive-attention LSTM decoder: teacher-forced, greedy, beam and train mode.

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
JAX.  With ``train=True`` (``text`` required):

* α-dropout: each step's softmaxed attention weights keep each entry with
  probability ``1 - dropout_p`` and scale it by ``1 / (1 - dropout_p)``, a
  fresh mask every step;
* scheduled sampling (``sampling_prob > 0``): one coin per step for the
  whole batch; on heads the next input is the argmax of the step's
  blank-masked logits (JAX's deliberate divergence from the torch
  reference, ``attention.py:215-223``), else ``text[:, t+1]``;
* the logits come from the raw hidden states, one generator matmul over
  all steps.

The random bits come from the caller's ``torch.Generator``: the coins for
all steps are drawn before any dropout mask, so they do not depend on
whether dropout is on (JAX keeps them apart by folding in ``100_000 + t``).
:meth:`AttentionDecoder.beam_search` is JAX's ``_beam_search`` (eval only).

On a model axis (``DEFAULT_TP_RULES``) ``w_emb`` holds gate columns and is
gathered whole for the row gather, and ``w_gen`` / ``b_gen`` hold vocabulary
columns: every step's logits are computed on them and gathered before the
loss, the argmax or the softmax.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rcnn_ocr_tpu_torch.models.dropblock import dropout
from rcnn_ocr_tpu_torch.models.lstm import lstm_cell_gates
from rcnn_ocr_tpu_torch.ops.topk import top_k
from rcnn_ocr_tpu_torch.parallel.mesh import (
    copy_to_model,
    gather_from_model,
    gather_param,
    tp_shard,
)


class AttentionDecoder(nn.Module):
    def __init__(self, num_classes: int, enc_size: int, hidden_size: int = 256,
                 sos_id: int = 1, eos_id: int = 2, pad_id: int = 0,
                 blank_id: Optional[int] = None, dropout_p: float = 0.1,
                 sampling_prob: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_p = dropout_p
        self.sampling_prob = sampling_prob
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

    def _decoder(self, batch_H: torch.Tensor, drop: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        """The step-invariant part of decoding: ``(step, logits_of, keys, bh)``.

        ``keys`` are the hoisted attention keys ``[B, T, H]`` fp32, ``bh`` the
        encoder states in the compute dtype (the attention values).
        ``step(h, c, targets, keys, values)`` is one decoder step (attention
        context, then the LSTM cell) and returns ``(h, c, align)``, ``align``
        the attention argmax; a beam passes its repeated keys and values.
        ``logits_of(h)`` is the generator, fp32 and unmasked."""
        dt = self.dtype
        bh = batch_H.to(dt)
        keys = torch.matmul(bh, self.w_i2h.to(dt)).float()  # hoisted attention keys
        w_h2h = self.w_h2h.to(dt)
        v = self.v_score.to(dt)
        w_ctx = self.w_ctx.to(dt)
        w_hh = self.w_hh.to(dt)
        w_gen = self.w_gen.to(dt)
        w_emb = gather_param(self.w_emb)  # the embedding rows, whole on every rank
        gen = tp_shard(self.w_gen)  # b_gen holds the same vocabulary columns

        def step(h, c, targets, keys=keys, values=bh):
            proj_h = torch.matmul(h.to(dt), w_h2h).float() + self.b_h2h
            e = torch.matmul(torch.tanh(keys + proj_h[:, None, :]).to(dt), v)[..., 0]
            alpha = torch.softmax(e.float(), dim=1)  # [B, T]
            align = torch.argmax(alpha, dim=1)
            if drop > 0.0:
                alpha = dropout(alpha, drop, generator)
            context = torch.bmm(alpha.to(dt)[:, None, :], values)[:, 0].float()
            gates = (
                torch.matmul(context.to(dt), w_ctx).float()
                + w_emb[targets]  # one-hot matmul == row gather
                + torch.matmul(h.to(dt), w_hh).float()
                + self.b_cell
            )
            h_new, c_new = lstm_cell_gates(gates, c, self.hidden_size)
            return h_new, c_new, align

        def logits_of(h):
            if gen is None:
                return torch.matmul(h.to(dt), w_gen).float() + self.b_gen
            # this rank's V/M vocabulary columns, gathered before any use
            part = torch.matmul(copy_to_model(h.to(dt), gen.mesh), w_gen).float() + self.b_gen
            return gather_from_model(part, -1, gen.mesh)

        return step, logits_of, keys, bh

    def forward(self, batch_H: torch.Tensor, text: Optional[torch.Tensor] = None,
                batch_max_length: int = 25, return_alignment: bool = False,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """``batch_H [B, T, C]`` -> logits ``[B, steps, V]`` fp32.

        With ``text [B, >= steps]`` (SOS at ``[:, 0]``) the decoder is
        teacher-forced; without it, greedy (``return_alignment`` adds the
        per-step attention argmax ``[B, steps]``).  ``train=True`` adds
        α-dropout and scheduled sampling, drawn from ``generator``.
        """
        batch = batch_H.shape[0]
        steps = batch_max_length + 1
        if return_alignment and text is not None:
            raise ValueError("return_alignment is a greedy-decode feature (text=None)")
        if train and text is None:
            raise ValueError("teacher-forced decoding requires `text` with SOS at [:, 0]")
        drop = self.dropout_p if train else 0.0
        sampling = train and self.sampling_prob > 0.0
        if (drop > 0.0 or sampling) and generator is None:
            raise ValueError("train-mode decoding draws from a torch.Generator; pass one")
        coins = torch.rand(steps, generator=generator, device=batch_H.device) if sampling else None

        step, logits_of, _, bh = self._decoder(batch_H, drop, generator)
        h = bh.new_zeros((batch, self.hidden_size), dtype=torch.float32)
        c = torch.zeros_like(h)

        if text is not None:
            hs = []
            targets = text[:, 0].long()
            for t in range(steps):
                h, c, _ = step(h, c, targets)
                hs.append(h)
                if t + 1 < steps:
                    targets = text[:, t + 1].long()
                    if sampling:
                        pred = torch.argmax(self._mask_blank(logits_of(h)), dim=-1)
                        targets = torch.where(coins[t] < self.sampling_prob, pred, targets)
            out_hid = torch.stack(hs, dim=1)  # [B, steps, H]
            return self._mask_blank(logits_of(out_hid))

        targets = torch.full((batch,), self.sos_id, dtype=torch.long, device=bh.device)
        logits_s, align_s = [], []
        for _ in range(steps):
            h, c, align = step(h, c, targets)
            logits_t = self._mask_blank(logits_of(h))
            targets = torch.argmax(logits_t, dim=-1)
            logits_s.append(logits_t)
            align_s.append(align)
        logits = torch.stack(logits_s, dim=1)
        if return_alignment:
            return logits, torch.stack(align_s, dim=1)
        return logits

    def beam_search(self, batch_H: torch.Tensor, beam_width: int, batch_max_length: int = 25,
                    length_penalty: float = 0.0, lm_logp=None, lm_weight: float = 0.0,
                    return_alignment: bool = False):
        """Beam search over the decoder (``models/attention.py:_beam_search``).

        Each row keeps ``K = beam_width`` hypotheses, beam-major (row b's at
        ``[b*K, (b+1)*K)``); only beam 0 is live at the first step (the
        others start at -1e30).  Every step expands all ``K * V``
        continuations and keeps the top K of the row, ties to the lower
        index as ``lax.top_k`` breaks them; h, c, the token history and the
        finished flags follow each child's parent.  A hypothesis that emitted
        EOS is finished: its only continuation is PAD at log-prob 0.

        ``lm_logp`` ``[V, V]`` fuses a bigram table: ``lm_weight *
        lm_logp[prev]`` is added to the step's log-probs before the top K.
        ``length_penalty > 0`` ranks the final hypotheses by ``score /
        len ** length_penalty`` (``len`` through the first EOS, else all
        steps) but the returned score stays the raw cumulative (fused)
        log-prob.  Returns ``(tokens [B, steps], scores [B] fp32)``, plus
        ``align [B, steps]`` (each token's parent's attention argmax) with
        ``return_alignment``.
        """
        batch = batch_H.shape[0]
        hidden, vocab, K = self.hidden_size, self.num_classes, int(beam_width)
        steps = batch_max_length + 1
        dev = batch_H.device
        lm_c = None
        if lm_logp is not None:
            lm_c = torch.as_tensor(lm_logp, dtype=torch.float32, device=dev)
            if tuple(lm_c.shape) != (vocab, vocab):
                raise ValueError(f"lm_logp must be [V, V] = {(vocab, vocab)}, "
                                 f"got {tuple(lm_c.shape)}")
        neg_inf = -1e30
        step, logits_of, keys, bh = self._decoder(batch_H)
        keys_k = keys.repeat_interleave(K, dim=0)
        values_k = bh.repeat_interleave(K, dim=0)
        pad_only = torch.full((vocab,), neg_inf, device=dev)
        pad_only[self.pad_id] = 0.0

        h = torch.zeros((batch * K, hidden), device=dev)
        c = torch.zeros_like(h)
        prev = torch.full((batch, K), self.sos_id, dtype=torch.long, device=dev)
        cum = torch.full((batch, K), neg_inf, device=dev)
        cum[:, 0] = 0.0
        finished = torch.zeros((batch, K), dtype=torch.bool, device=dev)
        hist = torch.zeros((batch, K, steps), dtype=torch.long, device=dev)
        ahist = torch.zeros_like(hist) if return_alignment else None

        def by_parent(a, parent):  # a [B, K, ...] -> the rows of each child's parent
            idx = parent.view(batch, K, *([1] * (a.dim() - 2))).expand(batch, K, *a.shape[2:])
            return torch.gather(a, 1, idx)

        for t in range(steps):
            h_new, c_new, align_t = step(h, c, prev.reshape(batch * K), keys_k, values_k)
            logits_t = self._mask_blank(logits_of(h_new))
            logp = torch.log_softmax(logits_t, dim=-1).reshape(batch, K, vocab)
            if lm_c is not None:
                logp = logp + lm_weight * lm_c[prev]
            logp = torch.where(finished[:, :, None], pad_only, logp)
            total = cum[:, :, None] + logp  # [B, K, V]
            cum, idx = top_k(total.reshape(batch, K * vocab), K)
            parent = idx // vocab
            prev = idx % vocab
            h = by_parent(h_new.reshape(batch, K, hidden), parent).reshape(batch * K, hidden)
            c = by_parent(c_new.reshape(batch, K, hidden), parent).reshape(batch * K, hidden)
            finished = by_parent(finished, parent) | (prev == self.eos_id)
            hist = by_parent(hist, parent)
            hist[:, :, t] = prev
            if return_alignment:
                ahist = by_parent(ahist, parent)
                ahist[:, :, t] = by_parent(align_t.reshape(batch, K), parent)

        rank = cum
        if length_penalty > 0.0:
            is_eos = hist == self.eos_id
            first_eos = torch.argmax(is_eos.to(torch.int32), dim=-1)
            lengths = torch.where(is_eos.any(dim=-1), first_eos + 1,
                                  torch.full_like(first_eos, steps)).float()
            rank = cum / lengths ** length_penalty
        best = torch.argmax(rank, dim=1)
        rows = torch.arange(batch, device=dev)
        if return_alignment:
            return hist[rows, best], cum[rows, best], ahist[rows, best]
        return hist[rows, best], cum[rows, best]
