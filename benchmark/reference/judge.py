"""How far the served strings lie from the reference's best choices.

For each served line the reference's float32 logits say how much lower the
served token's logit lies than the reference's best at that position (the
gap; 0 where both pick the same token).  A line's number is its widest gap.

* Attention head: the reference is teacher-forced with the served tokens
  (SOS first) and read at every served token and, when the string ended
  before the last step, at the EOS that ended it.
* CTC head: the served string is collapsed, so the frames are not served.
  The line's number is the least, over every frame path that collapses to
  the string, of the widest gap along the path (a min-max Viterbi over the
  CTC lattice).  Tokens a string cannot show (``invisible``: the blank and
  the specials the decoder drops) act as the separator state, at the gap of
  the best of them.

A string the charset cannot spell, or one longer than the decode allows,
gets an infinite gap.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def tokenize(text: str, stoi: Dict[str, int]) -> Optional[List[int]]:
    """A served string -> token ids, one per character (None: not spelled by
    the charset)."""
    ids = [stoi.get(ch) for ch in text]
    return None if any(i is None for i in ids) else ids


def attention_gaps(logits_fn, texts: Sequence[str], stoi: Dict[str, int], sos: int, eos: int,
                   steps: int, device) -> np.ndarray:
    """Per line, the widest gap of its served tokens.

    ``logits_fn(rows, inputs [n, S] long)`` returns the reference's
    teacher-forced logits ``[n, S, V]`` for the lines ``rows``."""
    gaps = np.full(len(texts), np.inf)
    rows, targets = [], []
    for i, text in enumerate(texts):
        ids = tokenize(text, stoi)
        if ids is None or len(ids) > steps:
            continue
        rows.append(i)
        targets.append(ids + [eos] if len(ids) < steps else ids)
    if not rows:
        return gaps
    width = max(len(t) for t in targets)
    tgt = torch.full((len(rows), width), -1, dtype=torch.long)
    for k, t in enumerate(targets):
        tgt[k, :len(t)] = torch.tensor(t)
    inputs = torch.cat([torch.full((len(rows), 1), sos, dtype=torch.long),
                        tgt[:, :-1].clamp_min(0)], dim=1)
    logits = logits_fn(rows, inputs.to(device)).float().cpu()
    valid = tgt >= 0
    served = logits.gather(2, tgt.clamp_min(0)[..., None])[..., 0]
    gap = torch.where(valid, logits.amax(dim=2) - served, torch.zeros_like(served))
    gaps[rows] = gap.amax(dim=1).double().numpy()
    return gaps


def ctc_gaps(logits: np.ndarray, texts: Sequence[str], stoi: Dict[str, int],
             invisible: Sequence[int]) -> np.ndarray:
    """Per line, the min-max frame gap of the served string (``logits [B, T, V]``)."""
    batch, t_steps, _ = logits.shape
    logits = logits.astype(np.float64)
    best = logits.max(axis=2)  # [B, T]
    sep_gap = best - logits[:, :, list(invisible)].max(axis=2)
    labels = [tokenize(t, stoi) for t in texts]
    ok = np.array([ids is not None and len(ids) <= t_steps for ids in labels])
    n_lab = max([len(ids) for ids, good in zip(labels, ok) if good], default=0)
    s_max = 2 * n_lab + 1
    # the lattice: separators at even states, the string's tokens at odd ones
    ext = np.full((batch, s_max), -1, np.int64)
    n_states = np.ones(batch, np.int64)
    for b, ids in enumerate(labels):
        if ok[b]:
            ext[b, 1:2 * len(ids):2] = ids
            n_states[b] = 2 * len(ids) + 1
    state = np.arange(s_max)[None, :]
    real = state < n_states[:, None]
    is_char = (state % 2 == 1) & real
    cost = np.where(is_char[:, None, :],
                    best[:, :, None] - np.take_along_axis(
                        logits, np.clip(ext, 0, None)[:, None, :].repeat(t_steps, 1), axis=2),
                    sep_gap[:, :, None])
    cost = np.where(real[:, None, :], cost, np.inf)
    skip = np.zeros((batch, s_max), bool)  # a token may follow the previous token directly
    skip[:, 2:] = is_char[:, 2:] & (ext[:, 2:] != ext[:, :-2])
    value = np.full((batch, s_max), np.inf)
    value[:, :2] = cost[:, 0, :2]
    for t in range(1, t_steps):
        prev = value.copy()
        prev[:, 1:] = np.minimum(prev[:, 1:], value[:, :-1])
        prev[:, 2:] = np.where(skip[:, 2:], np.minimum(prev[:, 2:], value[:, :-2]), prev[:, 2:])
        value = np.maximum(cost[:, t], prev)
    last = np.take_along_axis(value, (n_states - 1)[:, None], 1)[:, 0]
    before = np.take_along_axis(value, np.clip(n_states - 2, 0, None)[:, None], 1)[:, 0]
    out = np.where(n_states > 1, np.minimum(last, before), last)
    return np.where(ok, out, np.inf)
