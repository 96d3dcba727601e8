"""CTC loss and greedy decoding on the device, and ids -> text on the host.

Counterpart of ``rcnn_ocr_tpu/ops/ctc.py:ctc_loss``,
``ctc_greedy_decode_jnp`` and ``ids_to_text``.  The beam searches arrive in
a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean per-sequence CTC negative log-likelihood, with optax's layout:
    ``logits [B, T, V]``, ``logit_paddings [B, T]`` and ``label_paddings
    [B, L]`` 1.0 where padded, ``labels [B, L]``.

    Rows whose label cannot be aligned (``label_len + adjacent_repeats >
    frames``) and rows with ``valid`` False are left out of the mean, as in
    JAX.  Such a row gives 0 to the loss and its gradient, never NaN: torch
    charges an impossible alignment inf (``zero_infinity`` turns it into 0)
    and the mask is a ``torch.where``, not a product with inf.
    """
    logp = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # [T, B, V]
    frames = (1.0 - logit_paddings.float()).sum(dim=1)
    lab_real = 1.0 - label_paddings.float()
    lab_len = lab_real.sum(dim=1)
    per_seq = F.ctc_loss(logp, labels.long(), frames.long(), lab_len.long(), blank=blank_id,
                         reduction="none", zero_infinity=True)
    repeats = ((labels[:, 1:] == labels[:, :-1]).float() * lab_real[:, 1:] * lab_real[:, :-1]
               ).sum(dim=1)
    keep = lab_len + repeats <= frames
    if valid is not None:
        keep = keep & valid.bool()
    total = torch.where(keep, per_seq, torch.zeros_like(per_seq)).sum()
    return total / keep.sum().clamp_min(1).float()


def ctc_greedy_decode(logits: torch.Tensor, blank_id: int, return_confidence: bool = False):
    """Greedy decode of ``logits [B, T, V]``.

    Returns ``(tokens, valid)``: ``tokens [B, T]`` holds the collapsed label
    ids (repeats merged, blanks dropped) left-packed and padded with
    ``blank_id``; ``valid [B]`` the counts.  ``return_confidence`` adds
    ``conf [B]`` fp32: the mean max-softmax over the emitted frames, or over
    all frames when nothing was emitted.
    """
    pred = torch.argmax(logits, dim=-1)  # [B, T]
    batch, t_steps = pred.shape
    prev = torch.cat([torch.full_like(pred[:, :1], -1), pred[:, :-1]], dim=1)
    keep = (pred != blank_id) & (pred != prev)  # new non-blank symbols
    t_idx = torch.arange(t_steps, device=pred.device).expand(batch, t_steps)
    order = torch.argsort(torch.where(keep, t_idx, t_idx + t_steps), dim=1)
    packed = torch.gather(pred, 1, order)
    valid = keep.sum(dim=1, dtype=torch.int32)
    tokens = torch.where(t_idx < valid[:, None], packed, torch.full_like(packed, blank_id))
    if not return_confidence:
        return tokens, valid
    lg = logits.float()
    maxp = torch.exp(lg.max(dim=-1).values - torch.logsumexp(lg, dim=-1))
    emitted = torch.where(keep, maxp, torch.zeros_like(maxp)).sum(dim=1) / torch.clamp(
        valid.float(), min=1.0
    )
    all_frames = maxp.mean(dim=1)
    conf = torch.where(valid > 0, emitted, all_frames)
    return tokens, valid, conf


def ids_to_text(
    label_rows: Sequence[Sequence[int]],
    itos: Sequence[str],
    skip_ids: Sequence[int] = (),
) -> List[str]:
    """Collapsed CTC label ids -> strings (specials dropped)."""
    skip = set(skip_ids)
    return [
        "".join(itos[int(t)] for t in row if int(t) not in skip) for row in label_rows
    ]
