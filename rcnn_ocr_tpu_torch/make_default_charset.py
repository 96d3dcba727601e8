"""Write the default charset file (``configs/charset.txt``), as
``tools/make_default_charset.py`` writes it.

The 194 tokens (``<PAD>``, ``<SOS>``, ``<EOS>``, space, Latin, digits,
Cyrillic with its pre-reform letters, punctuation), one a line in UTF-8,
in the order that defines the token ids checkpoints and labels use.  The
port's own copy: it imports nothing of ``tools/``.

Run: ``python -m rcnn_ocr_tpu_torch.make_default_charset [out_path]``
"""

import os
import sys

SPECIALS = ["<PAD>", "<SOS>", "<EOS>"]

LATIN_LOWER = "abcdefghijklmnopqrstuvwxyz"
DIGITS = "0123456789"
CYRILLIC_LOWER = "абвгдеёжзийклмнопрстуфхцчшщъыьэюя"
# pre-reform / historic Cyrillic, lower-then-upper pairs
OLD_CYRILLIC = "ѣѢіІѳѲѵѴѫѪѭѬѯѮѱѰѡѠѕЅѧѦѩѨ"
PUNCT = ".,:;!?-–—…«»()[]{}\"'`/\\|_+=*^%$#@&<>~№"


def default_tokens():
    chars = (" " + LATIN_LOWER + LATIN_LOWER.upper() + DIGITS + CYRILLIC_LOWER
             + CYRILLIC_LOWER.upper() + OLD_CYRILLIC + PUNCT)
    return SPECIALS + list(chars)


def main(out_path: str = "configs/charset.txt") -> None:
    parent = os.path.dirname(out_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tokens = default_tokens()
    with open(out_path, "w", encoding="utf-8", newline="\n") as f:
        for tok in tokens:
            f.write(tok + "\n")
    print(f"wrote {len(tokens)} tokens to {out_path}")


if __name__ == "__main__":
    main(*sys.argv[1:])
