"""Character bigram language model for beam shallow fusion.

Counterpart of ``rcnn_ocr_tpu/lm.py`` (``bigram_counts``, ``bigram_logp``,
``train_bigram_lm``, ``save_lm``, ``load_lm``) and of
``tools/train_lm.py`` (:func:`main`).  Files are interchangeable between
the two packages: an ``.npz`` with ``logp`` (``[V, V]`` fp32) and ``itos``
(the charset's tokens, an object array, so loading needs pickle).

Row = previous token (the ``<SOS>`` row is the start distribution),
column = next token.  Add-alpha smoothing keeps unseen pairs finite; the
``<PAD>``, ``<EOS>`` and ``<BLANK>`` rows are exactly uniform, so fusing
them adds the same constant to every hypothesis.  The ``last -> <EOS>``
column stays informative: where a line ends is part of the prior.

Build one from labels CSVs::

    python -m rcnn_ocr_tpu_torch.lm --charset configs/charset.txt \\
        --out lm.npz --alpha 1.0 data/a/labels.csv data/b/labels.csv

and pass it to ``OCRInference(..., lm="lm.npz")`` with a per-call
``lm_weight``.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Iterable, Iterator

import numpy as np

from rcnn_ocr_tpu_torch.vocab.charset import Charset


def bigram_counts(texts: Iterable[str], charset) -> np.ndarray:
    """``[V, V]`` transition counts from label strings; characters missing
    from the charset are skipped, and each label adds ``<SOS> -> first``
    and ``last -> <EOS>``."""
    V = charset.num_classes
    counts = np.zeros((V, V), np.float64)
    stoi = charset.stoi
    sos, eos = charset.sos_id, charset.eos_id
    for text in texts:
        prev = sos
        for ch in text:
            cur = stoi.get(ch)
            if cur is None:
                continue
            counts[prev, cur] += 1.0
            prev = cur
        counts[prev, eos] += 1.0
    return counts


def bigram_logp(counts: np.ndarray, charset, alpha: float = 1.0) -> np.ndarray:
    """Counts -> row-normalized ``log P(next | prev)`` (fp32) with add-``alpha``;
    the ``<PAD>``, ``<EOS>`` (and ``<BLANK>``) rows uniform."""
    if alpha <= 0:
        raise ValueError("alpha must be > 0 (add-alpha smoothing)")
    counts = counts.astype(np.float64) + alpha
    neutral_rows = [charset.pad_id, charset.eos_id]
    if charset.blank_id is not None:
        neutral_rows.append(charset.blank_id)
    for r in neutral_rows:
        counts[r, :] = 1.0
    logp = np.log(counts) - np.log(counts.sum(axis=1, keepdims=True))
    return logp.astype(np.float32)


def train_bigram_lm(texts: Iterable[str], charset, alpha: float = 1.0) -> np.ndarray:
    """Label strings -> a fusion-ready ``[V, V]`` table."""
    return bigram_logp(bigram_counts(texts, charset), charset, alpha=alpha)


def save_lm(path: str, logp: np.ndarray, itos) -> None:
    """Write the table and its charset (the token order is part of the file)."""
    np.savez_compressed(path, logp=logp.astype(np.float32),
                        itos=np.asarray(list(itos), object))


def load_lm(path: str, charset=None) -> np.ndarray:
    """Load a saved table; with ``charset``, refuse a file built for another
    token order."""
    with np.load(path, allow_pickle=True) as z:
        logp = z["logp"]
        itos = [str(t) for t in z["itos"]]
    if charset is not None and itos != list(charset.itos):
        raise ValueError(
            f"LM charset mismatch: table was built for {len(itos)} tokens, "
            f"engine charset has {charset.num_classes} (or different order)"
        )
    return np.asarray(logp, np.float32)


def iter_labels(csv_path: str) -> Iterator[str]:
    """The texts of a headerless ``filename,text`` CSV (``.tsv``: tabs); an
    eval-style ``filename,text`` header row is skipped."""
    delim = "\t" if csv_path.endswith(".tsv") else ","
    with open(csv_path, newline="", encoding="utf-8") as f:
        for i, row in enumerate(csv.reader(f, delimiter=delim)):
            if len(row) < 2:
                continue
            if i == 0 and row[0].strip().lower() == "filename":
                continue
            yield row[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Build a character bigram LM from labels CSVs for beam shallow fusion")
    ap.add_argument("csvs", nargs="+", help="labels CSV/TSV files")
    ap.add_argument("--charset", required=True, help="token-per-line charset")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--alpha", type=float, default=1.0, help="add-alpha smoothing")
    args = ap.parse_args(argv)

    charset = Charset.from_file(args.charset)
    counts = bigram_counts((t for path in args.csvs for t in iter_labels(path)), charset)
    n_trans = int(counts.sum())
    logp = bigram_logp(counts, charset, alpha=args.alpha)
    save_lm(args.out, logp, charset.itos)
    size_kb = os.path.getsize(args.out) / 1e3
    print(
        f"bigram LM: {n_trans:,} transitions from {len(args.csvs)} file(s) -> "
        f"{args.out} ([{charset.num_classes}, {charset.num_classes}] fp32, "
        f"{size_kb:.0f} kB, alpha={args.alpha})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
