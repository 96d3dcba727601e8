"""Charset loading and token decoding.

Counterpart of ``rcnn_ocr_tpu/vocab/charset.py`` (the serving subset): a
charset file holds one token per line, the line index is the id, empty
lines are skipped (a space is a line holding one space).  Decoding stops at
``<EOS>`` and skips ``<PAD>`` and ``<BLANK>``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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

    def decode(self, ids: Sequence[int]) -> str:
        return decode_tokens(ids, list(self.itos), self.pad_id, self.eos_id, self.blank_id)


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
