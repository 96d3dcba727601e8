"""CTC loss, greedy and prefix-beam decoding, and ids -> text.

Counterpart of ``rcnn_ocr_tpu/ops/ctc.py``: ``ctc_loss``,
``ctc_greedy_decode_jnp`` (:func:`ctc_greedy_decode`),
``ctc_greedy_collapse_np``, ``ids_to_text``, the batched device prefix beam
``ctc_beam_search_jax`` (:func:`ctc_beam_search_device`) with
``ctc_beam_from_logits``, and the host beam ``ctc_beam_search`` (the C++
trie search of ``rcnn_ocr_tpu_torch/csrc/host/ctc_beam.cpp`` through
:mod:`rcnn_ocr_tpu_torch.native`) with its pure-Python twin
``_ctc_beam_py``, which the tests hold the C++ search to.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rcnn_ocr_tpu_torch.ops.topk import top_k
from rcnn_ocr_tpu_torch.parallel.mesh import global_sum


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
    and the mask is a ``torch.where``, not a product with inf.  Under a
    data-parallel step (:func:`rcnn_ocr_tpu_torch.parallel.mesh.batch_shard`)
    the count divided by is the global batch's, so the ranks' losses sum to
    the global mean.
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
    return total / global_sum(keep.sum().float()).clamp_min(1.0)


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


def ctc_greedy_collapse_np(pred_ids: np.ndarray, blank_id: int,
                           lengths: Optional[np.ndarray] = None) -> List[List[int]]:
    """Per-frame argmax rows ``[B, T]`` -> label ids: repeats merged, then
    blanks dropped; ``lengths [B]`` cuts each row to its valid frames."""
    out: List[List[int]] = []
    for b, row in enumerate(np.asarray(pred_ids)):
        if lengths is not None:
            row = row[: int(lengths[b])]
        if row.size == 0:
            out.append([])
            continue
        keep = np.ones(row.size, dtype=bool)
        keep[1:] = row[1:] != row[:-1]
        collapsed = row[keep]
        out.append(collapsed[collapsed != blank_id].tolist())
    return out


# rolling-hash multipliers of the two prefix-hash channels (odd, independent)
_M1, _M2 = 2654435761, 2246822519
_U32 = 0xFFFFFFFF


def _mul_u32(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h * m mod 2**32`` for int64 ``h`` in [0, 2**32): torch has no uint32
    arithmetic, so the product is formed from 16-bit halves of ``h`` and no
    intermediate reaches 2**49 (int64 never wraps)."""
    return (((h & 0xFFFF) * m) + (((h >> 16) * (m & 0xFFFF)) << 16)) & _U32


def _child_hash(h1: torch.Tensor, h2: torch.Tensor, c: torch.Tensor):
    """The hashes of a prefix extended by class ``c``, as JAX's uint32
    ``h * m + (c + 2)``."""
    cc = c + 2
    return (_mul_u32(h1, _M1) + cc) & _U32, (_mul_u32(h2, _M2) + cc) & _U32


def ctc_beam_search_device(top_vals: torch.Tensor, top_idx: torch.Tensor, blank_id: int,
                           beam_width: int = 16, lengths: Optional[torch.Tensor] = None,
                           lm_logp=None, lm_weight: float = 0.0, sos_id: int = 1,
                           return_posterior: bool = False):
    """Batched CTC prefix beam search on the tensors' device
    (``rcnn_ocr_tpu/ops/ctc.py:ctc_beam_search_jax``).

    ``top_vals`` / ``top_idx`` ``[B, T, K]`` are each frame's K candidate
    log-probs and class ids; a class outside them counts as -inf.  Each row
    keeps ``W = beam_width`` prefixes with their blank- and non-blank-ending
    log-probs.  Per frame every beam yields one same-prefix candidate
    (blank, or the last label repeated) and K children (a label appended;
    blank masked out).  Beams are distinct prefixes, so candidates collide
    in pairs at most: a child equal to an existing beam's prefix, found by
    comparing two 32-bit rolling hashes, folds into that beam's same-prefix
    candidate.  The ``W + W*K`` candidates are cut to the top W (ties to the
    lower pool index, as ``lax.top_k``); rows whose ``lengths`` are spent
    keep their state.

    ``lm_logp [V, V]`` with ``lm_weight`` adds ``lm_weight * lm_logp[last,
    c]`` to each label extension (the empty prefix reads row ``sos_id``);
    blank and repeat carry none, so merge partners share their LM mass.

    Returns ``(labels [B, T], lengths [B], log_probs [B])``, labels
    left-packed and padded with ``blank_id``, plus the winner's posterior
    among the final beams ``[B]`` with ``return_posterior``.
    """
    top_vals = top_vals.float()
    top_idx = top_idx.long()
    b_sz, t_steps, k = top_vals.shape
    w = int(beam_width)
    dev = top_vals.device
    neg_inf = float("-inf")
    lm_c = None
    if lm_logp is not None and lm_weight:
        lm_c = torch.as_tensor(lm_logp, dtype=torch.float32, device=dev) * lm_weight

    pb = torch.full((b_sz, w), neg_inf, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((b_sz, w), neg_inf, device=dev)
    # beam 0 = the empty prefix; dead beams get distinct garbage hashes
    slots = torch.arange(w, dtype=torch.long, device=dev)
    h1 = (((slots * 0x9E3779B9) & _U32) | 1).expand(b_sz, w)
    h2 = (((slots * 0x85EBCA6B) & _U32) | 1).expand(b_sz, w)
    last = torch.full((b_sz, w), -1, dtype=torch.long, device=dev)
    length = torch.zeros((b_sz, w), dtype=torch.long, device=dev)
    labels = torch.full((b_sz, w, t_steps), blank_id, dtype=torch.long, device=dev)
    frame_t = torch.arange(t_steps, device=dev)
    valid_t = (torch.full((b_sz,), t_steps, dtype=torch.long, device=dev) if lengths is None
               else torch.as_tensor(lengths, device=dev).long())
    neg = torch.full((b_sz, w * k), neg_inf, device=dev)

    for t in range(t_steps):
        vals, idx = top_vals[:, t], top_idx[:, t]  # [B, K]
        total = torch.logaddexp(pb, pnb)  # [B, W]
        blank_lp = torch.where(idx == blank_id, vals, neg_inf).amax(dim=1)  # [B]
        is_rep = idx[:, None, :] == last[:, :, None]  # [B, W, K]
        last_lp = torch.where(is_rep, vals[:, None, :], neg_inf).amax(dim=2)  # [B, W]

        # same-prefix candidates: blank extension + repeat-last (no gap)
        same_pb = total + blank_lp[:, None]
        same_pnb = pnb + last_lp  # -inf at the root (last = -1)

        # children: beam i extended by class c (blank masked out)
        child_pnb = torch.where(is_rep, pb[:, :, None], total[:, :, None]) + vals[:, None, :]
        if lm_c is not None:
            prev = torch.where(last < 0, sos_id, last)
            child_pnb = child_pnb + lm_c[prev[:, :, None], idx[:, None, :]]
        child_pnb = torch.where(idx[:, None, :] == blank_id, neg_inf, child_pnb)
        ch1, ch2 = _child_hash(h1[:, :, None], h2[:, :, None], idx[:, None, :])  # [B, W, K]

        # a child that IS an existing beam's prefix folds into that beam
        match = ((h1[:, :, None, None] == ch1[:, None, :, :])
                 & (h2[:, :, None, None] == ch2[:, None, :, :]))  # [B, Wsame, Wchild, K]
        folded = torch.where(match, child_pnb[:, None, :, :], neg_inf).amax(dim=(2, 3))
        same_pnb = torch.logaddexp(same_pnb, folded)  # max == logsumexp: <= 1 child matches
        child_pnb = torch.where(match.any(dim=1), neg_inf, child_pnb)

        # pool same + child candidates, keep the top W by total
        pool_pb = torch.cat([same_pb, neg], dim=1)
        pool_pnb = torch.cat([same_pnb, child_pnb.reshape(b_sz, w * k)], dim=1)
        _, keep = top_k(torch.logaddexp(pool_pb, pool_pnb), w)  # [B, W] pool indices

        is_child = keep >= w
        src = torch.where(is_child, (keep - w) // k, keep)  # source beam
        slot = torch.where(is_child, (keep - w) % k, 0)  # candidate class slot
        c_new = torch.gather(idx, 1, slot)
        old_h1, old_h2 = torch.gather(h1, 1, src), torch.gather(h2, 1, src)
        old_len = torch.gather(length, 1, src)
        old_labels = torch.gather(labels, 1, src[:, :, None].expand(b_sz, w, t_steps))
        nh1, nh2 = _child_hash(old_h1, old_h2, c_new)
        appended = torch.where(frame_t == old_len[:, :, None], c_new[:, :, None], old_labels)

        # rows whose valid frames are spent keep their state
        active = (t < valid_t)[:, None]
        pb = torch.where(active, torch.gather(pool_pb, 1, keep), pb)
        pnb = torch.where(active, torch.gather(pool_pnb, 1, keep), pnb)
        h1 = torch.where(active, torch.where(is_child, nh1, old_h1), h1)
        h2 = torch.where(active, torch.where(is_child, nh2, old_h2), h2)
        last = torch.where(active, torch.where(is_child, c_new, torch.gather(last, 1, src)), last)
        length = torch.where(active, old_len + is_child.long(), length)
        labels = torch.where(active[:, :, None],
                             torch.where(is_child[:, :, None], appended, old_labels), labels)

    total = torch.logaddexp(pb, pnb)
    best = torch.argmax(total, dim=1)
    rows = torch.arange(b_sz, device=dev)
    out = (labels[rows, best], length[rows, best], total[rows, best])
    if not return_posterior:
        return out
    # winner's normalized posterior among the W final prefixes (dead beams
    # sit at -inf and drop out)
    return out + (torch.exp(out[2] - torch.logsumexp(total, dim=1)),)


def ctc_top_frames(logits: torch.Tensor, prune_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """log-softmax of ``logits [B, T, V]``, then each frame's ``prune_k``
    best ``(log-probs, class ids)`` ``[B, T, k]`` in ``lax.top_k``'s order."""
    if prune_k < 1:
        raise ValueError(f"prune_k must be >= 1 for the device beam, got {prune_k}")
    return top_k(torch.log_softmax(logits.float(), dim=-1), prune_k)


def ctc_beam_from_logits(logits: torch.Tensor, *, blank_id: int, beam_width: int, prune_k: int,
                         lm_logp=None, lm_weight: float = 0.0, sos_id: int = 1,
                         return_confidence: bool = False):
    """log-softmax -> top-k frame pruning -> device prefix beam
    (``rcnn_ocr_tpu/ops/ctc.py:ctc_beam_from_logits``).  Returns ``(labels
    [B, T], lengths [B])`` plus the winner's posterior ``[B]`` with
    ``return_confidence``."""
    vals, idx = ctc_top_frames(logits, prune_k)
    out = ctc_beam_search_device(vals, idx, blank_id=blank_id, beam_width=beam_width,
                                 lm_logp=lm_logp, lm_weight=lm_weight, sos_id=sos_id,
                                 return_posterior=return_confidence)
    if return_confidence:
        return out[0], out[1], out[3]
    return out[0], out[1]


def _ctc_beam_py(log_probs: np.ndarray, blank: int, beam_width: int):
    """Pure-Python prefix beam search of one sequence ``[T, V]``:
    ``(labels, log-prob of the best, logsumexp over the final beams)``; the
    plain twin of the C++ search, which considers the same top
    ``beam_width + 1`` classes per frame."""
    t_steps, _ = log_probs.shape
    neg_inf = -np.inf
    beams = {(): (0.0, neg_inf)}  # prefix -> (log p ending blank, ending non-blank)
    for t in range(t_steps):
        row = log_probs[t]
        nxt: dict = {}

        def add(prefix, pb=neg_inf, pnb=neg_inf):
            old = nxt.get(prefix, (neg_inf, neg_inf))
            nxt[prefix] = (np.logaddexp(old[0], pb), np.logaddexp(old[1], pnb))

        for prefix, (pb, pnb) in beams.items():
            total = np.logaddexp(pb, pnb)
            add(prefix, pb=total + row[blank])
            if prefix:
                add(prefix, pnb=pnb + row[prefix[-1]])
            for c in np.argsort(row)[::-1][: beam_width + 1]:
                c = int(c)
                if c == blank:
                    continue
                ext = prefix + (c,)
                if prefix and c == prefix[-1]:
                    add(ext, pnb=pb + row[c])
                else:
                    add(ext, pnb=total + row[c])
        beams = dict(sorted(nxt.items(), key=lambda kv: -np.logaddexp(*kv[1]))[:beam_width])
    best, (pb, pnb) = max(beams.items(), key=lambda kv: np.logaddexp(*kv[1]))
    finals = np.array([np.logaddexp(pb_, pnb_) for pb_, pnb_ in beams.values()])
    m = float(finals.max())
    total = m + float(np.log(np.exp(finals - m).sum()))
    return list(best), float(np.logaddexp(pb, pnb)), total


def ctc_beam_search(logits: np.ndarray, blank_id: int, beam_width: int = 16,
                    lengths: Optional[np.ndarray] = None, already_log_probs: bool = False,
                    return_totals: bool = False):
    """Batched prefix beam search on the host, by the C++ search of
    :mod:`rcnn_ocr_tpu_torch.native` (``rcnn_ocr_tpu/ops/ctc.py:ctc_beam_search``).

    ``logits [B, T, V]`` (raw, or log-probs with ``already_log_probs``) ->
    ``(label lists, log-probs [B])``, plus each row's logsumexp over its
    final beams with ``return_totals`` (the winner's posterior is
    ``exp(best - total)``).  The library is built at first use and a failed
    build raises: there is no silent Python fallback.
    """
    from rcnn_ocr_tpu_torch import native

    logits = np.asarray(logits, dtype=np.float32)
    if already_log_probs:
        log_probs = logits
    else:
        m = logits.max(axis=-1, keepdims=True)
        log_probs = logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))
    return native.ctc_beam_search_batch(log_probs, blank=blank_id, beam_width=beam_width,
                                        lengths=lengths, want_totals=return_totals)
