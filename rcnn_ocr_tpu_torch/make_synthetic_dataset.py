"""Generate a ready-to-train synthetic OCR dataset (train + val + config).

The port's counterpart of ``tools/make_synthetic_dataset.py``, with its
flags and its output layout::

    OUT/
      train/            rendered line images + labels.csv (headerless)
      val/              rendered line images + labels.csv, PLUS eval.csv
                        (headered filename,text, the eval CLI's form)
      charset.txt       token-per-line charset covering the alphabet
                        (specials first; order defines ids)
      config.json       a runnable training config pointing at the above

Run::

    python -m rcnn_ocr_tpu_torch.make_synthetic_dataset --out data/synth --n-train 2000
    python -m rcnn_ocr_tpu_torch.training.train data/synth/config.json
    python -m rcnn_ocr_tpu_torch.evaluate --model ... --charset data/synth/charset.txt \\
        --csv data/synth/val/eval.csv --root data/synth/val

The lines come from ``data/synthetic.py`` (no PIL, no OpenCV); the dataset
is a pure function of (--seed, counts, difficulty, alphabet, the fonts
found on this host).  Generation runs on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from rcnn_ocr_tpu_torch.data.synthetic import (
    DIFFICULTIES,
    GENERATION_ALPHABET,
    HOMOGLYPH_FREE_ALPHABET,
    discover_fonts,
    generate_dataset,
)
from rcnn_ocr_tpu_torch.vocab.charset import EOS_TOKEN, PAD_TOKEN, SOS_TOKEN


def write_charset(path: str, alphabet: str) -> int:
    """Specials + one token per alphabet char, in alphabet order."""
    tokens = [PAD_TOKEN, SOS_TOKEN, EOS_TOKEN] + list(alphabet)
    with open(path, "w", encoding="utf-8", newline="\n") as f:
        for tok in tokens:
            f.write(tok + "\n")
    return len(tokens)


def write_dataset(out: str, n_train: int, n_val: int, *, fonts: Sequence[str], seed: int = 0,
                  img_h: int = 48, difficulty: str = "medium",
                  alphabet: str = GENERATION_ALPHABET, corpus: Optional[Sequence[str]] = None,
                  max_len: int = 25, epochs: int = 150) -> dict:
    """``OUT``'s train and val sets (through :func:`generate_dataset`),
    ``val/eval.csv``, ``charset.txt`` and ``config.json``, as the CLI writes
    them; returns their paths and the charset's size."""
    os.makedirs(out, exist_ok=True)
    common = dict(img_h=img_h, difficulty=difficulty, alphabet=alphabet, corpus=corpus,
                  fonts=fonts, max_len=max_len)
    train_csv, _ = generate_dataset(os.path.join(out, "train"), n_train, seed=seed, **common)
    # a seed stream of its own: val must not repeat train's labels or images
    val_csv, val_root = generate_dataset(os.path.join(out, "val"), n_val,
                                         seed=seed + 1_000_003, **common)
    eval_csv = os.path.join(val_root, "eval.csv")
    with open(val_csv, encoding="utf-8") as src, open(eval_csv, "w", encoding="utf-8",
                                                      newline="\n") as dst:
        dst.write("filename,text\n")
        dst.write(src.read())
    charset_path = os.path.join(out, "charset.txt")
    n_tokens = write_charset(charset_path, alphabet)
    config = {
        "train_csvs": [os.path.join(out, "train", "labels.csv")],
        "train_roots": [os.path.join(out, "train")],
        "val_csvs": [os.path.join(out, "val", "labels.csv")],
        "val_roots": [os.path.join(out, "val")],
        "charset_path": charset_path,
        "img_h": 32,
        "img_w": 128,
        "max_len": max_len,
        "batch_size": 128,
        # the shipped model needs thousands of steps before attention
        # aligns on random-string labels
        "epochs": epochs,
        "lr": 1e-3,
        "scheduler": "CosineAnnealingLR",
        "head": "attention",
        "eval_every": 5,
        "exp_dir": os.path.join(out, "exp"),
        # augmentation on the device, leaving the host a deterministic
        # resize-pad that the disk transform cache memory-maps
        "device_augment": True,
        "cache_dir": os.path.join(out, "cache"),
        "num_workers": 0,
    }
    config_path = os.path.join(out, "config.json")
    with open(config_path, "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2, ensure_ascii=False)
    return dict(train_csv=train_csv, val_csv=val_csv, eval_csv=eval_csv,
                charset=charset_path, config=config_path, n_tokens=n_tokens)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                prog="python -m rcnn_ocr_tpu_torch.make_synthetic_dataset")
    p.add_argument("--out", required=True, help="output dataset directory")
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--n-val", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--img-h", type=int, default=48, help="rendered line height (px)")
    p.add_argument(
        "--difficulty", choices=sorted(DIFFICULTIES), default="medium",
        help="effect-chain strength (clean|medium|hard)",
    )
    p.add_argument(
        "--chars", default=None,
        help="generation alphabet: literal characters, or 'homoglyph-free' "
        "(drops Latin/Cyrillic twins like a/а so exact-match accuracy can "
        "reach 1.0 — use for learning-curve demos and accuracy gates; "
        "default: full latin+digits+cyrillic+punct)",
    )
    p.add_argument(
        "--corpus", default=None,
        help="word list file (one word per line) to sample labels from",
    )
    p.add_argument("--max-len", type=int, default=25, help="label length cap")
    p.add_argument(
        "--epochs", type=int, default=150,
        help="epochs written into the generated config (the 46M flagship "
        "needs ~100+ epochs on 2k lines before attention aligns)",
    )
    args = p.parse_args(argv)

    if args.chars == "homoglyph-free":
        alphabet = HOMOGLYPH_FREE_ALPHABET
    else:
        alphabet = args.chars if args.chars else GENERATION_ALPHABET
    corpus = None
    if args.corpus:
        with open(args.corpus, encoding="utf-8") as f:
            corpus = [w.strip() for w in f if w.strip()]
        if not corpus:
            p.error(f"--corpus {args.corpus} contains no words")
        bad = sorted({c for w in corpus for c in w if c not in set(alphabet)})
        if bad:
            alphabet = alphabet + "".join(bad)
            print(f"[synth] extended alphabet with corpus chars: {''.join(bad)!r}")

    fonts = discover_fonts()
    if not fonts:
        print("ERROR: no usable TrueType fonts found on this host", file=sys.stderr)
        return 2
    made = write_dataset(args.out, args.n_train, args.n_val, fonts=fonts, seed=args.seed,
                         img_h=args.img_h, difficulty=args.difficulty, alphabet=alphabet,
                         corpus=corpus, max_len=args.max_len, epochs=args.epochs)
    print(
        f"[synth] wrote {args.n_train} train + {args.n_val} val lines "
        f"({args.difficulty}, {len(fonts)} fonts, {made['n_tokens']}-token charset)"
    )
    print(f"[synth] train: {made['train_csv']}")
    print(f"[synth] val:   {made['val_csv']}  (eval CLI form: {made['eval_csv']})")
    print(f"[synth] next:  python -m rcnn_ocr_tpu_torch.training.train {made['config']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
