"""``python -m rcnn_ocr_tpu_torch.evaluate`` vs ``evaluate_dataset.py``, fp32 on the CPU.

One checkpoint and one labeled CSV of PNG lines (32 high, so resize-pad
only pads), each CLI run in its own working directory, the JAX one with
its ``OCRInference`` fixed to fp32:

* ``evaluate_model`` for the four decodes (with list and ``auto:K`` width
  buckets): accuracy, CER, WER, the sample count and the per-sample CSV
  equal;
* ``main`` with an LM-weight sweep, ``--error-analysis`` and
  ``--report-json``: the same JSON report;
* ``main`` with ``--serving`` for each of the four decodes, and each
  ``*_long`` decode with ``--tile-w`` / ``--overlap``: the same report and
  per-sample rows; ``--tile-w`` without a long decode and ``--serving``
  with one exit 1 with JAX's messages;
* ``load_dataset``: the same paths and texts (a filename without its
  extension, a missing image); a CSV without the columns raises;
* ``--compile-cache-dir`` exits 1 naming why.
"""

import csv
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import evaluate_dataset  # noqa: E402
from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference  # noqa: E402
from rcnn_ocr_tpu_torch import evaluate  # noqa: E402
from rcnn_ocr_tpu_torch.data.image_io import imread  # noqa: E402
from tests.test_torch_port_beam_engine import TOKENS, _images, files  # noqa: E402,F401

LABELS = ["b", "cbb", "c", "cb", "b", "bb", "cbbb", "a b"]
WIDTHS = (40, 64, 52, 24, 64, 36, 60, 48)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Eight PNG lines and their CSV (one name without its extension, one
    row whose image is missing)."""
    import cv2

    root = tmp_path_factory.mktemp("eval_cli")
    images = root / "images"
    images.mkdir()
    rows = []
    for i, (img, label) in enumerate(zip(_images(8, seed=3, widths=WIDTHS), LABELS)):
        assert cv2.imwrite(str(images / f"line{i}.png"), img[:, :, ::-1])
        rows.append((f"line{i}" if i == 2 else f"line{i}.png", label))
    rows.append(("absent.png", "x"))
    path = root / "labels.csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows([("filename", "text"), *rows])
    return str(path), str(images)


def _run_both(tmp_path, monkeypatch, run_jax, run_port):
    """Each CLI in its own working directory; returns both results and the
    per-sample CSV texts."""
    monkeypatch.setattr(evaluate_dataset, "OCRInference",
                        functools.partial(JaxOCRInference, dtype=jnp.float32, verbose=False))
    out = []
    for name, run in (("jax", run_jax), ("port", run_port)):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        result = run()
        sample_csvs = sorted(p for p in os.listdir(cwd) if p.startswith("evaluation_results_"))
        out.append((result, {p: (cwd / p).read_text(encoding="utf-8") for p in sample_csvs}))
    return out


@pytest.mark.parametrize("decode,buckets", [("attention", None), ("attention_beam", "auto:2"),
                                            ("ctc_greedy", [32, 64]), ("ctc_beam", None)])
def test_evaluate_model_matches_jax(files, dataset, tmp_path, monkeypatch, decode, buckets):
    ckpt, charset, lm = files
    csv_path, root = dataset
    kw = dict(csv_path=csv_path, root_path=root, batch_size=3, img_h=32, img_w=64,
              decode=decode, max_length=5, beam_width=3, width_buckets=buckets,
              lm=lm if decode.endswith("beam") else None,
              lm_weight=0.4 if decode.endswith("beam") else 0.0,
              length_penalty=0.6 if decode == "attention_beam" else 0.0)
    (want, want_csv), (got, got_csv) = _run_both(
        tmp_path, monkeypatch,
        lambda: evaluate_dataset.evaluate_model(model_path=ckpt, charset_path=charset, **kw),
        lambda: evaluate.evaluate_model(ckpt, charset, device="cpu", dtype=torch.float32, **kw))
    assert got == want and got["n"] == 8
    assert list(got_csv) == list(want_csv) == ["evaluation_results_w_weights.msgpack.csv"]
    rows = list(csv.reader(got_csv[list(got_csv)[0]].splitlines()))
    assert rows == list(csv.reader(want_csv[list(want_csv)[0]].splitlines()))
    assert rows[0] == ["image_path", "true_text", "predicted_text", "cer", "wer", "exact_match"]
    assert len(rows) == 9
    if decode.startswith("attention"):  # the random CTC head reads these lines alike
        assert len({r[2] for r in rows[1:]}) > 1


def test_lm_weight_sweep_and_report_match_jax(files, dataset, tmp_path, monkeypatch, capsys):
    ckpt, charset, lm = files
    csv_path, root = dataset
    argv = ["--model", ckpt, "--charset", charset, "--csv", csv_path, "--root", root,
            "--img-h", "32", "--img-w", "64", "--max-length", "5", "--batch-size", "4",
            "--beam-width", "3", "--decode", "attention_beam", "--lm", lm,
            "--lm-weight", "0,0.5", "--width-buckets", "40,64", "--error-analysis",
            "--max-samples", "7"]
    monkeypatch.setattr(evaluate, "evaluate_model",
                        functools.partial(evaluate.evaluate_model, dtype=torch.float32))

    def run_jax():
        monkeypatch.setattr(sys, "argv", ["evaluate_dataset.py", *argv,
                                          "--report-json", "report.json"])
        return evaluate_dataset.main(), json.load(open("report.json", encoding="utf-8"))

    def run_port():
        code = evaluate.main([*argv, "--device", "cpu", "--report-json", "report.json"])
        return code, json.load(open("report.json", encoding="utf-8"))

    (want, _), (got, _) = _run_both(tmp_path, monkeypatch, run_jax, run_port)
    assert got == want and got[0] == 0
    sweep = got[1]["sweep"]
    assert [m["lm_weight"] for m in sweep] == [0.0, 0.5]
    assert all(m["n"] == 7 and "by_length" in m["analysis"] for m in sweep)
    assert "LM-weight sweep (pick the CER minimum):" in capsys.readouterr().out


def test_load_dataset_matches_jax(dataset, tmp_path):
    csv_path, root = dataset
    got = evaluate.load_dataset(csv_path, root)
    assert got == evaluate_dataset.load_dataset(csv_path, root)
    assert len(got[0]) == 8 and got[0][2].endswith("line2.png") and got[1][2] == "c"
    np.testing.assert_array_equal(imread(got[0][0]).shape, (32, WIDTHS[0], 3))
    bad = tmp_path / "bad.csv"
    bad.write_text("file,label\nline0.png,b\n", encoding="utf-8")
    with pytest.raises(ValueError, match="'filename' and 'text'"):
        evaluate.load_dataset(str(bad), root)
    with pytest.raises(FileNotFoundError):
        evaluate.load_dataset(str(tmp_path / "none.csv"), root)


@pytest.mark.parametrize("extra", [
    ["--decode", "attention", "--serving"], ["--decode", "attention_beam", "--serving"],
    ["--decode", "ctc_greedy", "--serving"], ["--decode", "ctc_beam", "--serving"],
    ["--decode", "ctc_long", "--tile-w", "32", "--overlap", "16"],
    ["--decode", "ctc_long_beam", "--tile-w", "32", "--overlap", "16"],
    ["--decode", "attention_long", "--tile-w", "32", "--overlap", "16"],
    ["--decode", "attention_long_beam", "--tile-w", "32", "--overlap", "8"],
    ["--decode", "hybrid_long", "--tile-w", "32"],
    ["--decode", "hybrid_long_beam", "--tile-w", "40", "--overlap", "16"],
])
def test_serving_and_long_decodes_match_jax(files, dataset, tmp_path, monkeypatch, extra):
    """``--serving`` with each fixed-width decode, and each ``*_long`` decode
    at a 32-40 px tile (the 24-64 px lines span 1-3 tiles): the same report
    and per-sample rows as ``evaluate_dataset.py``."""
    ckpt, charset, _ = files
    csv_path, root = dataset
    argv = ["--model", ckpt, "--charset", charset, "--csv", csv_path, "--root", root,
            "--img-h", "32", "--img-w", "64", "--max-length", "5", "--batch-size", "3",
            "--beam-width", "3", *extra, "--report-json", "report.json"]
    monkeypatch.setattr(evaluate, "evaluate_model",
                        functools.partial(evaluate.evaluate_model, dtype=torch.float32))

    def run_jax():
        monkeypatch.setattr(sys, "argv", ["evaluate_dataset.py", *argv])
        return evaluate_dataset.main(), json.load(open("report.json", encoding="utf-8"))

    def run_port():
        return evaluate.main([*argv, "--device", "cpu"]), json.load(open("report.json",
                                                                         encoding="utf-8"))

    (want, want_csv), (got, got_csv) = _run_both(tmp_path, monkeypatch, run_jax, run_port)
    assert got == want and got[0] == 0 and got[1]["n"] == 8
    assert got_csv == want_csv and len(got_csv) == 1
    rows = list(csv.reader(list(got_csv.values())[0].splitlines()))
    assert len(rows) == 9


@pytest.mark.parametrize("extra", [["--tile-w", "32"], ["--serving", "--decode", "ctc_long"]])
def test_argument_checks_exit_1_with_jax_messages(files, dataset, monkeypatch, capsys, extra):
    ckpt, charset, _ = files
    csv_path, root = dataset
    argv = ["--model", ckpt, "--charset", charset, "--csv", csv_path, "--root", root, *extra]
    monkeypatch.setattr(sys, "argv", ["evaluate_dataset.py", *argv])
    assert evaluate_dataset.main() == 1
    want = capsys.readouterr().out.strip().splitlines()[-1].replace("Error: ", "")
    assert evaluate.main([*argv, "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert want in out and "Evaluating" not in out
    assert want.startswith(("--tile-w/--overlap require", "--serving does not support"))


def test_later_slice_options_exit_1(files, dataset, capsys):
    """XLA's compile cache has no counterpart in the port; the int8 and
    artifact options are served (``tests/test_torch_port_artifact.py``)."""
    ckpt, charset, _ = files
    csv_path, root = dataset
    code = evaluate.main(["--model", ckpt, "--charset", charset, "--csv", csv_path,
                          "--root", root, "--device", "cpu", "--compile-cache-dir", "cache"])
    out = capsys.readouterr().out
    assert code == 1
    assert "not in the PyTorch port yet" in out and "slice" in out and "Evaluating" not in out


def test_bad_arguments_exit_1(files, dataset, capsys):
    ckpt, charset, _ = files
    csv_path, root = dataset
    base = ["--csv", csv_path, "--root", root, "--device", "cpu"]
    assert evaluate.main(["--model", ckpt, *base]) == 1
    assert evaluate.main(["--model", ckpt + ".none", "--charset", charset, *base]) == 1
    assert evaluate.main(["--model", ckpt, "--charset", charset, "--lm-weight", "x", *base]) == 1
    assert evaluate.main(["--model", ckpt, "--charset", charset, "--lm-weight", ",", *base]) == 1
    out = capsys.readouterr().out
    assert "--charset is required" in out and "Model not found" in out
    assert "not a comma list" in out and "empty sweep" in out
