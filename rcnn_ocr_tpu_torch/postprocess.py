"""Host-side decode post-processing: batch padding, chunking, rows -> text.

Counterpart of ``rcnn_ocr_tpu/postprocess.py:pad_rows``, ``chunk_indices``,
``ctc_skip_ids``, ``decode_ctc_batch``, ``decode_attention_row`` and
``decode_beam_row``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.ops.ctc import ids_to_text
from rcnn_ocr_tpu_torch.vocab.charset import decode_tokens


def pad_rows(rows: List[Any], batch_size: int) -> Tuple[List[Any], int]:
    """Pad a short chunk to the static batch by repeating the last row."""
    n_real = len(rows)
    if n_real == 0:
        raise ValueError("pad_rows needs at least one row")
    if n_real < batch_size:
        rows = rows + [rows[-1]] * (batch_size - n_real)
    return rows, n_real


def chunk_indices(
    groups: Dict[Any, List[int]], batch_size: int
) -> List[Tuple[Any, List[int]]]:
    """Split each group's image indices into batch-sized chunks."""
    return [
        (key, indices[i : i + batch_size])
        for key, indices in groups.items()
        for i in range(0, len(indices), batch_size)
    ]


def ctc_skip_ids(
    pad_id: Optional[int],
    sos_id: Optional[int],
    eos_id: Optional[int],
    ctc_blank_id: Optional[int],
) -> set:
    """Token ids a CTC decode drops (None entries are simply absent)."""
    return {v for v in (pad_id, sos_id, eos_id, ctc_blank_id) if v is not None}


def decode_ctc_batch(pred, valid, n_real: int, itos: Sequence[str], skip_ids: set) -> List[str]:
    """``[B, T]`` left-packed label rows and their valid lengths -> the texts
    of the first ``n_real`` rows."""
    pred = np.asarray(pred)
    valid = np.asarray(valid)
    rows = [pred[j, : valid[j]].tolist() for j in range(n_real)]
    return ids_to_text(rows, itos, skip_ids=skip_ids)


def decode_attention_row(
    pred_row: np.ndarray,
    maxp_row,
    itos: Sequence[str],
    pad_id: Optional[int],
    eos_id: Optional[int],
    blank_id: Optional[int],
    return_confidence: bool,
):
    """One attention-decoded row -> text, or (text, confidence): the mean
    max-softmax over the non-PAD, non-EOS steps."""
    text = decode_tokens(pred_row, itos, pad_id=pad_id, eos_id=eos_id, blank_id=blank_id)
    if not return_confidence:
        return text
    mask = (pred_row != pad_id) & (pred_row != eos_id)
    conf = float(maxp_row[mask].mean()) if mask.sum() > 0 else 0.0
    return (text, conf)


def decode_beam_row(
    pred_row: np.ndarray,
    score,
    itos: Sequence[str],
    pad_id: Optional[int],
    eos_id: Optional[int],
    blank_id: Optional[int],
    return_confidence: bool,
):
    """One beam-searched row and its cumulative log-prob -> text, or (text,
    confidence): ``exp(score / len)``, the geometric mean of the emitted
    tokens' probabilities, ``len`` counted through the first EOS."""
    text = decode_tokens(pred_row, itos, pad_id=pad_id, eos_id=eos_id, blank_id=blank_id)
    if not return_confidence:
        return text
    n_tok = int(np.argmax(pred_row == eos_id) + 1 if eos_id in pred_row else pred_row.shape[0])
    return (text, float(np.exp(float(score) / max(n_tok, 1))))
