"""The port's bigram LM (``rcnn_ocr_tpu_torch/lm.py``) vs ``rcnn_ocr_tpu/lm.py``.

* counts and log-prob tables equal to JAX's (bit for bit: both are float64
  numpy rounded once to fp32);
* an ``.npz`` written by either package loads in the other with an equal
  table, and a table built for another token order is refused with JAX's
  message;
* ``python -m rcnn_ocr_tpu_torch.lm`` writes the same file contents as
  ``tools/train_lm.py`` from the same CSVs.
"""

import csv
import os
import sys

import numpy as np
import pytest

from rcnn_ocr_tpu import lm as jax_lm
from rcnn_ocr_tpu.vocab.charset import Charset as JaxCharset
from rcnn_ocr_tpu_torch import lm
from rcnn_ocr_tpu_torch.vocab.charset import Charset

TOKENS = ["<PAD>", "<SOS>", "<EOS>", "<BLANK>", "a", "b", "c"]
TEXTS = ["ab", "bca", "cab x", "", "aaab", "cc"]


@pytest.mark.parametrize("alpha", [1.0, 0.25])
@pytest.mark.parametrize("tokens", [TOKENS, [t for t in TOKENS if t != "<BLANK>"]])
def test_tables_equal_jax(alpha, tokens):
    ours, theirs = Charset.from_tokens(tokens), JaxCharset.from_tokens(tokens)
    np.testing.assert_array_equal(lm.bigram_counts(TEXTS, ours),
                                  jax_lm.bigram_counts(TEXTS, theirs))
    got = lm.train_bigram_lm(TEXTS, ours, alpha=alpha)
    want = jax_lm.train_bigram_lm(TEXTS, theirs, alpha=alpha)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="alpha must be > 0"):
        lm.bigram_logp(lm.bigram_counts(TEXTS, ours), ours, alpha=0.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_load_across_packages(tmp_path, writer):
    ours, theirs = Charset.from_tokens(TOKENS), JaxCharset.from_tokens(TOKENS)
    table = lm.train_bigram_lm(TEXTS, ours)
    path = str(tmp_path / "lm.npz")
    (lm.save_lm if writer == "port" else jax_lm.save_lm)(path, table, TOKENS)
    np.testing.assert_array_equal(lm.load_lm(path, ours), table)
    np.testing.assert_array_equal(jax_lm.load_lm(path, theirs), table)
    np.testing.assert_array_equal(lm.load_lm(path), table)

    other = TOKENS[:-1]
    with pytest.raises(ValueError) as got:
        lm.load_lm(path, Charset.from_tokens(other))
    with pytest.raises(ValueError) as want:
        jax_lm.load_lm(path, JaxCharset.from_tokens(other))
    assert "LM charset mismatch" in str(got.value) and str(got.value) == str(want.value)
    swapped = TOKENS[:4] + ["b", "a", "c"]  # same size, other order
    with pytest.raises(ValueError, match="charset mismatch"):
        lm.load_lm(path, Charset.from_tokens(swapped))


def test_cli_writes_what_tools_train_lm_writes(tmp_path, monkeypatch, capsys):
    from tools.train_lm import main as jax_main

    cs_path = tmp_path / "cs.txt"
    cs_path.write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    headerless = tmp_path / "labels.csv"
    with open(headerless, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows([(f"{i}.png", t) for i, t in enumerate(TEXTS)])
    with_header = tmp_path / "eval.tsv"
    with_header.write_text("filename\ttext\nz.png\tbcab\nshort\n", encoding="utf-8")
    csvs = [str(headerless), str(with_header)]

    ours = str(tmp_path / "ours.npz")
    assert lm.main([*csvs, "--charset", str(cs_path), "--out", ours, "--alpha", "0.5"]) == 0
    out_ours = capsys.readouterr().out
    theirs = str(tmp_path / "theirs.npz")
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *csvs, "--charset", str(cs_path),
                                      "--out", theirs, "--alpha", "0.5"])
    assert jax_main() == 0
    out_theirs = capsys.readouterr().out
    with np.load(ours, allow_pickle=True) as a, np.load(theirs, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files) == ["itos", "logp"]
        np.testing.assert_array_equal(a["logp"], b["logp"])
        assert list(a["itos"]) == list(b["itos"]) == TOKENS
    # the same summary line, apart from the output path
    assert out_ours.replace(ours, "X") == out_theirs.replace(theirs, "X")
    assert "25 transitions" in out_ours and os.path.getsize(ours) > 0
