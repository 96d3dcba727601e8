"""``correct`` comes out false when the timed path is broken underneath.

The CPU tests skip the look for a card and drive the rest of a run (set-up,
window, the reference's comparison) at a small size with the program in
float32, once sound and once with each fault a cell can have: a token
altered where it is produced, and half of each batch's rows left out (their
strings taken from the other half).  The card test runs the control, the
reference computed in float8 in the program's place (``reference/lowp.py``),
at the cells' sizes on three seeds and sees it fail the limit
(``python -m pytest benchmark/tests -m cuda -p no:xdist``).
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"lines": {"n_lines": 24}, "call": {"batch_size": 8},
         "check": {"sample_lines": 24, "longest": 4}}


def _run(cell, seed=2**31 + 5):
    out, _ = run.run_cell(BENCH, cell, seed, 1.0, False, device="cpu", dtype=torch.float32,
                          overrides=SMALL)
    return out


def _altered(text):
    """The string with one token changed: its first character moved to the
    next letter, or one letter where it was empty."""
    if not text:
        return "a"
    return chr(ord("a") + (ord(text[0]) - ord("a") + 1) % 26) + text[1:] \
        if "a" <= text[0] <= "z" else "a" + text[1:]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    limits = run.load_cell(cell, BENCH)[2]["check"]["limits"]
    assert set(out["checks"]) == set(limits) | {"failed"}
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_token_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from rcnn_ocr_tpu_torch import inference, serving_engine

    real_ctc = serving_engine.decode_ctc_batch
    real_attn = inference.OCRInference._decode_attention_row
    monkeypatch.setattr(serving_engine, "decode_ctc_batch",
                        lambda *a, **k: [_altered(t) for t in real_ctc(*a, **k)])
    monkeypatch.setattr(inference.OCRInference, "_decode_attention_row",
                        lambda self, *a, **k: _altered(real_attn(self, *a, **k)))
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["widest_gap"]["value"] > out["checks"]["widest_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_each_batch_left_out_is_not_correct(cell, monkeypatch):
    from rcnn_ocr_tpu_torch import inference

    real = inference.OCRInference._serving_fn

    def half(self, *a, **k):
        kernel = real(self, *a, **k)

        def run_half(raw, sizes, replica=0):
            n = raw.shape[0] // 2
            # decode the first half only; the second half's rows repeat it
            rows = kernel(raw[:n], sizes[:n], replica=replica)
            return tuple(torch.cat([r, r[:raw.shape[0] - n]]) for r in rows)
        return run_half

    monkeypatch.setattr(inference.OCRInference, "_serving_fn", half)
    out = _run(cell)
    assert not out["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest benchmark/tests -m cuda -p no:xdist)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 901, 2**31 + 902, 2**31 + 903])
def test_the_float8_control_fails_the_limit_on_the_card(card, cell, seed):
    out, checks = run.run_cell(BENCH, cell, seed, 3.0, False, device=card, control=True)
    print(cell, seed, checks)
    assert not out["correct"]
    assert out["checks"]["widest_gap"]["value"] > out["checks"]["widest_gap"]["limit"]
