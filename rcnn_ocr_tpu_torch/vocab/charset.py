"""Charset loading and token decoding.

Counterpart of ``rcnn_ocr_tpu/vocab/charset.py``: a charset file holds one
token per line, the line index is the id, empty lines are skipped (a space
is a line holding one space).  Encoding drops unknown characters (and
``<BLANK>``); decoding stops at ``<EOS>`` and skips ``<PAD>`` and
``<BLANK>``.  :func:`pack_attention_targets` and :func:`pack_ctc_targets`
build the training targets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD_TOKEN = "<PAD>"
SOS_TOKEN = "<SOS>"
EOS_TOKEN = "<EOS>"
BLANK_TOKEN = "<BLANK>"


def load_charset(charset_path: str) -> Tuple[List[str], Dict[str, int]]:
    """Read a token-per-line charset file -> (itos, stoi)."""
    itos: List[str] = []
    with open(charset_path, "r", encoding="utf-8") as f:
        for line in f:
            tok = line.rstrip("\n")
            if tok == "":
                continue
            itos.append(tok)
    return itos, {s: i for i, s in enumerate(itos)}


@dataclasses.dataclass(frozen=True)
class Charset:
    """A charset plus the special-token ids looked up from its contents."""

    itos: Tuple[str, ...]
    stoi: Dict[str, int]

    @classmethod
    def from_file(cls, charset_path: str) -> "Charset":
        itos, stoi = load_charset(charset_path)
        return cls(itos=tuple(itos), stoi=stoi)

    @classmethod
    def from_tokens(cls, tokens: Sequence[str]) -> "Charset":
        itos = tuple(tokens)
        return cls(itos=itos, stoi={s: i for i, s in enumerate(itos)})

    def __len__(self) -> int:
        return len(self.itos)

    @property
    def num_classes(self) -> int:
        return len(self.itos)

    @property
    def pad_id(self) -> int:
        return self.stoi[PAD_TOKEN]

    @property
    def sos_id(self) -> int:
        return self.stoi[SOS_TOKEN]

    @property
    def eos_id(self) -> int:
        return self.stoi[EOS_TOKEN]

    @property
    def blank_id(self) -> Optional[int]:
        return self.stoi.get(BLANK_TOKEN, None)

    @property
    def ctc_blank_id(self) -> int:
        """``<BLANK>`` when the charset has one, else ``<PAD>``."""
        b = self.blank_id
        return self.pad_id if b is None else b

    def encode(self, text: str) -> List[int]:
        """Text -> ids, dropping unknown characters and BLANK."""
        return _encode_ids(text, self.stoi, self.blank_id)

    def decode(self, ids: Sequence[int]) -> str:
        return decode_tokens(ids, list(self.itos), self.pad_id, self.eos_id, self.blank_id)


def _encode_ids(text: str, stoi: Dict[str, int], blank: Optional[int]) -> List[int]:
    ids = []
    for ch in text:
        idx = stoi.get(ch)
        if idx is None or (blank is not None and idx == blank):
            continue
        ids.append(idx)
    return ids


def pack_attention_targets(texts: Sequence[str], stoi: Dict[str, int],
                           max_len: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(text_in, target_y, lengths)`` int32 ``[B, max_len + 1]``, ``[B]``:
    ``text_in`` = SOS, ids, PAD...; ``target_y`` = ids, EOS, PAD...;
    ``lengths`` = ids + 1 (ids cut at ``max_len``)."""
    pad, sos, eos = stoi[PAD_TOKEN], stoi[SOS_TOKEN], stoi[EOS_TOKEN]
    blank = stoi.get(BLANK_TOKEN, None)
    batch, steps = len(texts), max_len + 1
    text_in = np.full((batch, steps), pad, dtype=np.int32)
    text_in[:, 0] = sos
    target_y = np.full((batch, steps), pad, dtype=np.int32)
    lengths = np.zeros((batch,), dtype=np.int32)
    for i, s in enumerate(texts):
        ids = _encode_ids(s, stoi, blank)[:max_len]
        n = len(ids)
        text_in[i, 1 : 1 + n] = ids
        target_y[i, :n] = ids
        target_y[i, n] = eos
        lengths[i] = n + 1
    return text_in, target_y, lengths


def pack_ctc_targets(texts: Sequence[str], charset: Charset,
                     max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(labels int32, label_paddings float32)``, both ``[B, max_len]``: the
    label ids without blanks, and 1.0 where padded (optax's layout)."""
    labels = np.zeros((len(texts), max_len), dtype=np.int32)
    paddings = np.ones((len(texts), max_len), dtype=np.float32)
    blank = charset.ctc_blank_id
    for i, s in enumerate(texts):
        ids = [t for t in charset.encode(s) if t != blank][:max_len]
        labels[i, : len(ids)] = ids
        paddings[i, : len(ids)] = 0.0
    return labels, paddings


def decode_tokens(
    ids: Sequence[int],
    itos: Sequence[str],
    pad_id: int,
    eos_id: int,
    blank_id: Optional[int] = None,
) -> str:
    """Token ids -> string: stop at EOS, skip PAD and BLANK."""
    out = []
    for t in ids:
        t = int(t)
        if t == eos_id:
            break
        if t == pad_id or (blank_id is not None and t == blank_id):
            continue
        out.append(itos[t])
    return "".join(out)
