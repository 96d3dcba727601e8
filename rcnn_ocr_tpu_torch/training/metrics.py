"""OCR quality metrics: CER, WER, exact-match accuracy, edit operations.

Counterpart of ``rcnn_ocr_tpu/training/metrics.py`` (``levenshtein``,
``character_error_rate``, ``word_error_rate``, ``compute_accuracy``,
``edit_ops``, ``batch_character_error_rate``) in pure Python, after its
``_levenshtein_py`` (the port has no native module):

* CER = character edit distance / len(reference); an empty reference gives
  ``inf`` against a non-empty hypothesis, else 0;
* WER = the same over whitespace-split words;
* accuracy = the exact-match rate.
"""

from __future__ import annotations

from typing import List, Sequence


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance over any sequences (characters of strings, words),
    by the two-row dynamic program."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def character_error_rate(reference: str, hypothesis: str) -> float:
    if len(reference) == 0:
        return float("inf") if len(hypothesis) > 0 else 0.0
    return levenshtein(reference, hypothesis) / len(reference)


def word_error_rate(reference: str, hypothesis: str) -> float:
    ref_words, hyp_words = reference.split(), hypothesis.split()
    if len(ref_words) == 0:
        return float("inf") if len(hyp_words) > 0 else 0.0
    return levenshtein(ref_words, hyp_words) / len(ref_words)


def compute_accuracy(references: List[str], hypotheses: List[str]) -> float:
    if not references:
        return 0.0
    return sum(1 for r, h in zip(references, hypotheses) if r == h) / len(references)


def edit_ops(reference: str, hypothesis: str) -> List[tuple]:
    """The error operations of one optimal alignment, in reference order:
    ``("sub", r, h)``, ``("del", r, None)``, ``("ins", None, h)``; ties
    break substitution first, then deletion."""
    n, m = len(reference), len(hypothesis)
    rows = [list(range(m + 1))]
    for i in range(1, n + 1):
        prev, cur = rows[-1], [i] + [0] * m
        for j in range(1, m + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (reference[i - 1] != hypothesis[j - 1]))
        rows.append(cur)
    ops: List[tuple] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and rows[i][j] == rows[i - 1][j - 1] + (
                reference[i - 1] != hypothesis[j - 1]):
            if reference[i - 1] != hypothesis[j - 1]:
                ops.append(("sub", reference[i - 1], hypothesis[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and rows[i][j] == rows[i - 1][j] + 1:
            ops.append(("del", reference[i - 1], None))
            i -= 1
        else:
            ops.append(("ins", None, hypothesis[j - 1]))
            j -= 1
    ops.reverse()
    return ops


def batch_character_error_rate(references: List[str], hypotheses: List[str]) -> List[float]:
    """``character_error_rate`` of each pair."""
    return [character_error_rate(r, h) for r, h in zip(references, hypotheses)]
