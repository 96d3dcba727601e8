"""The artifact and int8 entry points of the port on the CPU.

* ``python -m rcnn_ocr_tpu_torch.serve --artifact``: answers as the
  artifact does in-process, warns on the flags an artifact bakes in, and a
  SIGHUP after a re-export with another batch size swaps the engine and
  re-sizes the batcher without dropping a request;
* the eval CLI: ``--artifact`` against ``evaluate_dataset.py --artifact``
  on each package's artifact of the same checkpoint, its refusals beside
  ``--artifact`` with JAX's messages; ``--quantize`` against
  ``evaluate_dataset.py`` (the same report), ``--static-quant
  --save-calibration`` (JAX's scales, the port engine's strings, a file that
  reopens on the static path);
* ``run_training(export_artifact={quantize, calibrate})`` at the tiny
  config: the artifact carries the calibrated scales and decodes as an
  engine built from its own ``params.msgpack``.
"""

import functools
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import evaluate_dataset  # noqa: E402
from rcnn_ocr_tpu import export as jax_export  # noqa: E402
from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference  # noqa: E402
from rcnn_ocr_tpu_torch import evaluate  # noqa: E402
from rcnn_ocr_tpu_torch.export import ServingArtifact, export_serving_artifact  # noqa: E402
from rcnn_ocr_tpu_torch.inference import OCRInference  # noqa: E402
from rcnn_ocr_tpu_torch.training.train import run_training  # noqa: E402
from tests.test_torch_port_beam_engine import IMG_H, _images, files  # noqa: E402,F401
from tests.test_torch_port_daemon import _answer, _png_bytes, _read_until  # noqa: E402
from tests.test_torch_port_eval_cli import _run_both, dataset  # noqa: E402,F401
from tests.test_torch_port_train_loop import _cfg, tiny  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _metrics(base):
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        return resp.read().decode()


def _healthz(base):
    with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
        return json.loads(resp.read())


def test_serve_cli_from_an_artifact_reloads_and_drains(files, tmp_path):
    ckpt, charset, _ = files
    ocr = OCRInference(ckpt, charset, device="cpu", img_h=IMG_H, img_w=64)  # bf16
    art_dir = str(tmp_path / "artifact")
    export_serving_artifact(ocr, art_dir, method="ctc_greedy", batch_size=4, canvas=(48, 96),
                            max_length=5)
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rcnn_ocr_tpu_torch.serve", "--artifact", art_dir, "--port", "0",
         "--device", "cpu", "--batch-size", "8", "--quantize"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: ([lines.put(x) for x in proc.stdout],
                                              lines.put(None)), daemon=True)
    reader.start()
    try:
        warning = _read_until(lines, r"WARNING: (.*) ignored with --artifact").group(1)
        assert warning == "--batch-size, --quantize"
        base = _read_until(lines, r"Serving on (http://\S+)").group(1)
        imgs = _images(6, seed=12, widths=(40, 64, 30))
        want = ServingArtifact.load(art_dir, device="cpu").predict(imgs)
        assert _answer(base, "image/png", _png_bytes(imgs[0])) == (200, {"texts": want[:1]})
        # re-export at another batch size, then swap it in
        export_serving_artifact(ocr, art_dir, method="ctc_greedy", batch_size=2,
                                canvas=(48, 96), max_length=5)
        proc.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 120
        while "ocr_engine_swaps_total 1" not in _metrics(base):
            assert time.monotonic() < deadline, "the daemon never swapped engines"
            time.sleep(0.1)
        import base64

        body = json.dumps({"images": [base64.b64encode(_png_bytes(i)).decode()
                                      for i in imgs]}).encode()
        assert _answer(base, "application/json", body) == (200, {"texts": want})
        assert _healthz(base)["batch_size"]["max"] == 2  # the new artifact's batch
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        reader.join(10)
        rest = []
        while not lines.empty():
            rest.append(lines.get() or "")
        assert "Drained; exiting." in "".join(rest)
        assert "engine reloaded" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_eval_cli_artifact_matches_jax(files, dataset, tmp_path, monkeypatch, capsys):
    ckpt, charset, _ = files
    csv_path, root = dataset
    port_dir, jax_dir = str(tmp_path / "port_art"), str(tmp_path / "jax_art")
    kw = dict(method="ctc_greedy", batch_size=3, canvas=(48, 96), max_length=5)
    export_serving_artifact(OCRInference(ckpt, charset, device="cpu", img_h=IMG_H, img_w=64,
                                         dtype=torch.float32), port_dir, **kw)
    jax_export.export_serving_artifact(
        JaxOCRInference(ckpt, charset, img_h=IMG_H, img_w=64, dtype=jnp.float32,
                        verbose=False), jax_dir, **kw)
    argv = ["--csv", csv_path, "--root", root, "--report-json", "report.json"]

    def run_jax():
        monkeypatch.setattr(sys, "argv", ["evaluate_dataset.py", "--artifact", jax_dir, *argv])
        return evaluate_dataset.main(), json.load(open("report.json", encoding="utf-8"))

    def run_port():
        code = evaluate.main(["--artifact", port_dir, *argv, "--device", "cpu"])
        return code, json.load(open("report.json", encoding="utf-8"))

    (want, _), (got, _) = _run_both(tmp_path, monkeypatch, run_jax, run_port)
    assert got == want and got[0] == 0 and got[1]["n"] == 8
    capsys.readouterr()
    for extra in (["--decode", "attention", "--batch-size", "4"], ["--charset", charset],
                  ["--save-calibration", "c.msgpack", "--static-quant"]):
        bad = ["--artifact", port_dir, "--csv", csv_path, "--root", root, *extra]
        monkeypatch.setattr(sys, "argv", ["evaluate_dataset.py", *bad])
        assert evaluate_dataset.main() == 1
        message = capsys.readouterr().out.strip().splitlines()[-1]
        assert evaluate.main([*bad, "--device", "cpu"]) == 1
        assert capsys.readouterr().out.strip().splitlines()[-1] == message
        assert "cannot be used with --artifact" in message
    for bad in (["--artifact", port_dir, "--model", ckpt], []):
        assert evaluate.main([*bad, "--csv", csv_path, "--root", root, "--device", "cpu"]) == 1
        assert "Pass exactly one of --model or --artifact" in capsys.readouterr().out


def _eval_argv(files, dataset, *extra):
    ckpt, charset, _ = files
    csv_path, root = dataset
    return ["--model", ckpt, "--charset", charset, "--csv", csv_path, "--root", root,
            "--img-h", "32", "--img-w", "64", "--max-length", "5", "--batch-size", "3",
            *extra, "--report-json", "report.json"]


def _run_cli_pair(tmp_path, monkeypatch, argv):
    monkeypatch.setattr(evaluate, "evaluate_model",
                        functools.partial(evaluate.evaluate_model, dtype=torch.float32))

    def run_jax():
        monkeypatch.setattr(sys, "argv", ["evaluate_dataset.py", *argv])
        return evaluate_dataset.main(), json.load(open("report.json", encoding="utf-8"))

    def run_port():
        return evaluate.main([*argv, "--device", "cpu"]), json.load(open("report.json",
                                                                         encoding="utf-8"))

    return _run_both(tmp_path, monkeypatch, run_jax, run_port)


def test_eval_cli_quantize_matches_jax(files, dataset, tmp_path, monkeypatch):
    argv = _eval_argv(files, dataset, "--quantize", "--decode", "ctc_greedy")
    (want, want_csv), (got, got_csv) = _run_cli_pair(tmp_path, monkeypatch, argv)
    assert got == want and got[0] == 0 and got[1]["n"] == 8
    assert got_csv == want_csv


def test_eval_cli_static_quant_and_save_calibration(files, dataset, tmp_path, monkeypatch):
    """``--static-quant --save-calibration``: both CLIs calibrate on the eight
    images and write the calibrated checkpoint; the scales agree within the
    quant test's ``STATS_RTOL``; the port's report is the port engine's own
    (calibrated, then decoded) and its file reopens on the static path.  The
    strings are not held to JAX's here: on this model a stem activation that
    the two packages' float convs round apart flips an int8 code in the
    first quantized conv, and row 6's last attention step, whose two best
    logits lie 5.1e-4 apart, then moves by 2.5e-3 and turns (the int8 model
    against JAX, at given scales: ``tests/test_torch_port_quant.py``)."""
    from tests.test_torch_port_quant import STATS_RTOL, _leaves
    from rcnn_ocr_tpu_torch.training.checkpoint import load_variables

    ckpt, charset, _ = files
    argv = _eval_argv(files, dataset, "--static-quant", "--decode", "attention",
                      "--save-calibration", "calibrated.msgpack")
    (want, _), (got, got_csv) = _run_cli_pair(tmp_path, monkeypatch, argv)
    assert got[0] == want[0] == 0 and got[1]["n"] == want[1]["n"] == 8
    saved = {who: str(tmp_path / who / "calibrated.msgpack") for who in ("jax", "port")}
    stats = {who: _leaves(load_variables(path)[0]["quant_stats"]) for who, path in saved.items()}
    assert sorted(stats["port"]) == sorted(stats["jax"]) and len(stats["port"]) == 24
    for key, value in stats["jax"].items():
        np.testing.assert_allclose(stats["port"][key], value, rtol=STATS_RTOL, err_msg=key)
    paths, _ = evaluate.load_dataset(*dataset)
    eng = OCRInference(ckpt, charset, device="cpu", img_h=IMG_H, img_w=64,
                       dtype=torch.float32, quantize=True)
    eng.calibrate(paths, batch_size=3)
    import csv

    rows = [r[2] for r in list(csv.reader(list(got_csv.values())[0].splitlines()))[1:]]
    assert rows == eng.predict(paths, max_length=5, batch_size=3)
    again = OCRInference(saved["port"], charset, device="cpu", img_h=IMG_H, img_w=64,
                         dtype=torch.float32, quantize=True)
    assert again.model.act_quant == "static"
    assert again.predict(paths, max_length=5, batch_size=3) == rows


def test_run_training_exports_a_calibrated_int8_artifact(tiny):
    req = {"method": "ctc_greedy", "quantize": True, "calibrate": 6, "canvas": [32, 160],
           "batch_size": 4, "slot": "last"}
    result = run_training(_cfg(tiny, "export", head="both", epochs=1, export_artifact=req),
                          device="cpu")
    art_dir = result["artifact_dir"]
    assert art_dir == os.path.join(result["exp_dir"], "artifact")
    art = ServingArtifact.load(art_dir, device="cpu")
    m = art.manifest
    assert (m["method"], m["quantize"], m["act_quant"], m["batch_size"]) == \
        ("ctc_greedy", True, "static", 4)
    stats = [float(v) for v in jax.tree_util.tree_leaves(art.variables["quant_stats"])]
    assert len(stats) == 24 and all(v > 0 for v in stats)
    # the artifact decodes as the engine its own params.msgpack makes (in
    # the training run's default bf16, as the export's engine)
    live = OCRInference(art.variables, tiny["charset"], device="cpu", img_h=32, img_w=64,
                        quantize=True)
    assert live.model.act_quant == "static"
    imgs = _images(5, seed=14, widths=(40, 120, 64))
    assert art.predict(imgs) == live.predict_serving(imgs, batch_size=4, canvas=(32, 160),
                                                     method="ctc_greedy")
    log = open(os.path.join(result["exp_dir"], "train.log"), encoding="utf-8").read()
    assert "Calibrated static int8 scales on 6 validation images" in log
    assert "Exported serving artifact" in log
