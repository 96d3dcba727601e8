"""The port's checkpoint tools against the JAX package's (CPU).

``python -m rcnn_ocr_tpu_torch.ckpt_info`` and ``python -m
rcnn_ocr_tpu_torch.average_checkpoints`` take the place of
``tools/ckpt_info.py`` and ``tools/average_checkpoints.py`` where flax does
not import.  Seeded blobs of a tiny model (width 0.0625, hidden 16, one
BiLSTM, both heads) are written with flax's ``msgpack_serialize`` (in this
test only): full checkpoints, bare weights, an EMA checkpoint and one with
an empty EMA map, a stats-less and a version-less blob, one carrying
``quant_stats``, a format-2 blob, blobs with a bfloat16 leaf, trees that do
not match, and a blob without ``params``.  JAX's tools run as subprocesses
(``JAX_PLATFORMS=cpu``, four at a time), the port's ``main(argv)``
in-process, from directories at the same depth so that relative paths print
alike.  Held, case by case:

* ``average_checkpoints``: the exit code, the standard output and the
  output file's bytes equal JAX's; on an error, JAX's last line of standard
  error starts with the port's message (argparse errors: the text after
  ``error:``; a format-2 input: JAX's loader adds an upgrade hint);
* ``ckpt_info``: the exit code and the text, or the ``--json`` object,
  equal JAX's (0, 1 and 2 all occur);
* JAX's ``load_variables`` and the port's ``OCRInference(device="cpu")``
  load the port's averaged file to the same arrays;
* ``BFloat16Array.from_float64`` rounds as numpy's cast to ml_dtypes'
  bfloat16 (through float32, ties to even), and a bfloat16 leaf round-trips
  through the port's reader and writer bit for bit.
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from rcnn_ocr_tpu.models import RCNN as JaxRCNN
from rcnn_ocr_tpu.training import checkpoint as jax_ckpt
from rcnn_ocr_tpu_torch import average_checkpoints as port_avg
from rcnn_ocr_tpu_torch import ckpt_info as port_info
from rcnn_ocr_tpu_torch.inference import OCRInference
from rcnn_ocr_tpu_torch.training import checkpoint as port_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
CONFIG = {"img_h": 32, "img_w": 64, "hidden_size": 16, "head": "both", "max_length": 4,
          "batch_size": 8, "width_mult": 0.0625, "lr": 1e-3, "use_ema": False,
          "train_csvs": ["a.csv", None], "grad_clip": None}


def _variables():
    model = JaxRCNN(num_classes=len(TOKENS), hidden_size=16, width_mult=0.0625,
                    lstm_layers=1, with_ctc_head=True, dtype=jnp.float32)
    v = model.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 32, 64, 3)),
                   text=jnp.zeros((1, 5), jnp.int32), batch_max_length=4,
                   method=model.init_all)
    return jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                               "batch_stats": v["batch_stats"]})


def _nudged(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(a.dtype), tree)


def _full(v, seed, **extra):
    return {"format_version": 1, "epoch": seed, "global_step": 100 * seed,
            "params": _nudged(v["params"], seed),
            "batch_stats": _nudged(v["batch_stats"], seed + 50),
            "opt_state": {"count": np.asarray(7 * seed, np.int32)}, "scheduler_state": {},
            "best_val_loss": 1.0 / seed, "best_val_acc": 0.1 * seed, "itos": list(TOKENS),
            "stoi": {t: i for i, t in enumerate(TOKENS)}, "config": dict(CONFIG),
            "log_dir": "logs", **extra}


def _weights(v, seed, **extra):
    return {"format_version": 1, "params": _nudged(v["params"], seed),
            "batch_stats": _nudged(v["batch_stats"], seed + 50), **extra}


def _with_bf16(blob):
    out = dict(blob, params=dict(blob["params"]))
    proj = dict(out["params"]["ctc_proj"])
    proj["bias"] = proj["bias"].astype(ml_dtypes.bfloat16)
    out["params"]["ctc_proj"] = proj
    return out


def _blobs():
    v = _variables()
    quant = {"cnn": {"layer1_block0": {"conv1": {"conv": {
        "act_absmax": np.asarray(3.5, np.float32)}}}}}
    ema = _full(v, 4)
    ema["ema_params"] = _nudged(v["params"], 40)
    missing_leaf = _weights(v, 9)
    missing_leaf["params"] = {k: t for k, t in missing_leaf["params"].items() if k != "ctc_proj"}
    stats_mismatch = _weights(v, 10)
    stats_mismatch["batch_stats"] = {"cnn": {"stem0": stats_mismatch["batch_stats"]["cnn"]["stem0"]}}
    legacy = _weights(v, 11)
    del legacy["format_version"]
    return {
        "full_a": _full(v, 1), "full_b": _full(v, 2), "full_c": _full(v, 3),
        "ema": ema, "empty_ema": _full(v, 5, ema_params={}),
        "weights_a": _weights(v, 6), "weights_b": _weights(v, 7),
        "statsless": {"format_version": 1, "params": _nudged(v["params"], 8)},
        "quant": _weights(v, 12, quant_stats=quant), "legacy": legacy,
        "format2": dict(_full(v, 13), format_version=2),
        "bf16_a": _with_bf16(_weights(v, 14)), "bf16_b": _with_bf16(_weights(v, 15)),
        "bf16_full": _with_bf16(_full(v, 16)),
        "missing_leaf": missing_leaf, "stats_mismatch": stats_mismatch,
        "no_params": {"format_version": 1, "epoch": 3},
    }


def _blob(name):
    return f"../blobs/{name}.msgpack"


AVERAGE_CASES = {
    "uniform": [_blob("full_a"), _blob("full_b"), _blob("full_c")],
    "weighted": [_blob("full_a"), _blob("full_b"), _blob("full_c"), "--weights", "0.5,0.3,0.2"],
    "ema_first": [_blob("ema"), _blob("full_b")],
    "empty_ema": [_blob("empty_ema"), _blob("full_a")],
    "weights_files": [_blob("weights_a"), _blob("weights_b"), _blob("full_c")],
    "stats_mass": [_blob("weights_a"), _blob("statsless"), "--weights", "0.7,0.3"],
    "statsless_first": [_blob("statsless"), _blob("weights_a")],
    "quant_stats": [_blob("quant"), _blob("weights_b")],
    "version_less": [_blob("legacy"), _blob("weights_b")],
    "bf16": [_blob("bf16_a"), _blob("bf16_b"), _blob("bf16_full"), "--weights", "2,1,1"],
    "one_checkpoint": [_blob("full_a")],
    "weight_count": [_blob("full_a"), _blob("full_b"), "--weights", "1,2,3"],
    "weight_sum": [_blob("full_a"), _blob("full_b"), "--weights", "1,-1"],
    "params_mismatch": [_blob("weights_a"), _blob("missing_leaf")],
    "stats_mismatch": [_blob("weights_a"), _blob("stats_mismatch")],
    "no_params": [_blob("full_a"), _blob("no_params")],
    "format2_input": [_blob("full_a"), _blob("format2")],
}
INFO_CASES = ["full_a", "weights_a", "ema", "statsless", "quant", "legacy", "format2", "bf16_full",
              "no_params", "missing"]
OUT = "avg.msgpack"


def _run_jax(tool, args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", tool), *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)
    out_path = os.path.join(cwd, OUT)
    data = None
    if os.path.exists(out_path):
        with open(out_path, "rb") as f:
            data = f.read()
    return proc.returncode, proc.stdout, proc.stderr, data


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Every blob on disk and every case run through JAX's tools."""
    root = tmp_path_factory.mktemp("ckpt_tools")
    os.makedirs(root / "blobs")
    for name, blob in _blobs().items():
        (root / "blobs" / f"{name}.msgpack").write_bytes(serialization.msgpack_serialize(blob))
    jobs = {}
    for case, args in AVERAGE_CASES.items():
        os.makedirs(root / f"jax_avg_{case}")
        jobs[("avg", case)] = ("average_checkpoints.py", ["--out", OUT, *args],
                               str(root / f"jax_avg_{case}"))
    os.makedirs(root / "jax_info")
    for case in INFO_CASES:
        for mode in ("text", "json"):
            args = [_blob(case)] + (["--json"] if mode == "json" else [])
            jobs[("info", case, mode)] = ("ckpt_info.py", args, str(root / "jax_info"))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = {key: pool.submit(_run_jax, *job) for key, job in jobs.items()}
        results = {key: f.result() for key, f in futures.items()}
    return root, results


def _port(main, argv, cwd, capsys, monkeypatch):
    """``(exit code, stdout, error line)`` of the port's ``main(argv)`` run in ``cwd``."""
    monkeypatch.chdir(cwd)
    err_line = ""
    try:
        rc = main(argv)
    except SystemExit as e:  # argparse errors (2) and SystemExit(message) (1)
        rc = e.code if isinstance(e.code, int) else 1
        if isinstance(e.code, str):
            err_line = e.code
    except ValueError as e:
        rc, err_line = 1, f"ValueError: {e}"
    out, err = capsys.readouterr()
    if not err_line and err.strip():
        err_line = err.strip().splitlines()[-1]
    return rc, out, err_line


def _error_text(line):
    return line.split("error: ", 1)[1] if "error: " in line else line


@pytest.mark.parametrize("case", list(AVERAGE_CASES))
def test_average_checkpoints_matches_jax(case, jax_runs, capsys, monkeypatch):
    root, results = jax_runs
    want_rc, want_out, want_err, want_bytes = results[("avg", case)]
    cwd = root / f"port_avg_{case}"
    os.makedirs(cwd)
    rc, out, err_line = _port(port_avg.main, ["--out", OUT, *AVERAGE_CASES[case]], cwd, capsys,
                              monkeypatch)
    assert rc == want_rc, (rc, want_rc, want_err)
    assert out == want_out
    got_bytes = (cwd / OUT).read_bytes() if (cwd / OUT).exists() else None
    if want_rc == 0:
        assert got_bytes is not None and got_bytes == want_bytes
        return
    assert got_bytes is None and want_bytes is None
    jax_line = want_err.strip().splitlines()[-1]
    assert err_line and _error_text(jax_line).startswith(_error_text(err_line)), (err_line,
                                                                                  jax_line)


@pytest.mark.parametrize("mode", ["text", "json"])
@pytest.mark.parametrize("case", INFO_CASES)
def test_ckpt_info_matches_jax(case, mode, jax_runs, capsys, monkeypatch):
    root, results = jax_runs
    want_rc, want_out, _, _ = results[("info", case, mode)]
    argv = [_blob(case)] + (["--json"] if mode == "json" else [])
    rc, out, _ = _port(port_info.main, argv, root / "jax_info", capsys, monkeypatch)
    assert rc == want_rc
    expected_rc = {"format2": 2, "no_params": 1, "missing": 1}.get(case, 0)
    assert rc == expected_rc
    if mode == "json" and rc != 1:
        assert json.loads(out) == json.loads(want_out)
    assert out == want_out


def test_bf16_dtype_is_reported_as_stored(jax_runs):
    root, _ = jax_runs
    info = port_info.ckpt_info(str(root / "blobs" / "bf16_full.msgpack"))
    assert info["params"]["dtypes"]["bfloat16"] == len(TOKENS)
    plain = port_info.ckpt_info(str(root / "blobs" / "full_a.msgpack"))["params"]
    assert info["params"]["bytes"] == plain["bytes"] - 2 * len(TOKENS)  # 4 -> 2 bytes a value


def test_averaged_file_loads_in_both_packages(jax_runs, capsys, monkeypatch):
    root, _ = jax_runs
    cwd = root / "port_load"
    os.makedirs(cwd)
    rc, _, _ = _port(port_avg.main, ["--out", OUT, *AVERAGE_CASES["weighted"]], cwd, capsys,
                     monkeypatch)
    assert rc == 0
    path = str(cwd / OUT)
    jax_vars, jax_blob = jax_ckpt.load_variables(path)
    assert jax_blob["itos"] == TOKENS and jax_blob["config"] == CONFIG
    engine = OCRInference(path, device="cpu", dtype=torch.float32)
    got = engine.variables
    for col in ("params", "batch_stats"):
        want_leaves = jax.tree_util.tree_leaves_with_path(jax_vars[col])
        got_flat = dict(jax.tree_util.tree_leaves_with_path(got[col]))
        assert len(want_leaves) == len(got_flat)
        for key, leaf in want_leaves:
            np.testing.assert_array_equal(got_flat[key], np.asarray(leaf))
    # and the averaged leaves are the float64 mix of the inputs
    blobs = [port_ckpt.load_checkpoint_blob(str(root / "blobs" / f"full_{s}.msgpack"))
             for s in "abc"]
    kernel = [b["params"]["cnn"]["stem0"]["conv"]["kernel"].astype(np.float64) for b in blobs]
    want = (kernel[0] * 0.5 + kernel[1] * 0.3 + kernel[2] * 0.2).astype(np.float32)
    np.testing.assert_array_equal(jax_vars["params"]["cnn"]["stem0"]["conv"]["kernel"], want)
    texts = engine.predict_ctc([np.full((20, 50, 3), 200, np.uint8)], batch_size=2)
    assert len(texts) == 1 and isinstance(texts[0], str)


@pytest.mark.parametrize("tool,args,rc", [
    ("ckpt_info", ["../blobs/format2.msgpack"], 2),
    ("average_checkpoints", ["--out", "m.msgpack", "../blobs/full_a.msgpack",
                             "../blobs/full_b.msgpack"], 0),
])
def test_module_entry_points(tool, args, rc, jax_runs):
    root, _ = jax_runs
    cwd = root / f"module_{tool}"
    os.makedirs(cwd)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", f"rcnn_ocr_tpu_torch.{tool}", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == rc, proc.stdout + proc.stderr


def test_bfloat16_rounding_matches_ml_dtypes():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4000) * np.exp(rng.uniform(-30, 30, size=4000)),
        # ties and near-ties of bfloat16, and one that float32 turns into a
        # tie first (1 + 2^-8 + 2^-30 rounds to 1.0, not up)
        1.0 + np.array([2.0 ** -8, 3 * 2.0 ** -8, 2.0 ** -8 + 2.0 ** -30, -(2.0 ** -9)]),
        [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 3.4e38, 1e300, -1e300, 2.0 ** -140],
    ])
    with np.errstate(over="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = port_ckpt.BFloat16Array.from_float64(x).bits
    np.testing.assert_array_equal(got, want)


def test_bfloat16_leaf_round_trips_through_the_port():
    bits = np.random.default_rng(1).normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    tree = {"a": bits, "s": np.asarray(1.5, ml_dtypes.bfloat16)[()], "f": np.ones(2, np.float32)}
    data = serialization.msgpack_serialize(tree)
    kept = port_ckpt.msgpack_restore(data, keep_bfloat16=True)
    assert isinstance(kept["a"], port_ckpt.BFloat16Array) and kept["s"].scalar
    assert port_ckpt.msgpack_serialize(kept) == data
    plain = port_ckpt.msgpack_restore(data)
    np.testing.assert_array_equal(plain["a"], bits.astype(np.float32))
    assert plain["a"].dtype == np.float32 and float(plain["s"]) == 1.5
