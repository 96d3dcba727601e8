"""Serving artifacts of the port against the JAX package's (fp32, CPU).

One tiny JAX checkpoint (``tests/test_export.py``'s model: width 0.0625,
hidden 16, one BiLSTM, both heads), exported by both packages:

* the manifests are equal but for ``files`` / ``decode_files`` (``.pt2``
  programs in place of ``.stablehlo``) and the version field
  (``torch_version`` in place of ``jax_version``), on every branch of the
  ``format_version`` ladder (v2 fixed width and top-k tiles, v3 aligned
  attention_long, v4 argmax tiles, v5 CTC confidence);
* ``params.msgpack`` restores in JAX (``flax.serialization``) to JAX's own
  arrays;
* ``ctc_greedy`` and ``attention`` artifacts give JAX's artifact's strings;
* ``validate_export_request`` and the exporter's refusals
  (``tests/test_export.py:293,539,627,670,708,764,796``), run over both
  packages where the function is shared;
* the port's ``export_serving`` and ``artifact_info`` CLIs against
  ``tools/export_serving.py`` and ``tools/artifact_info.py``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rcnn_ocr_tpu import export as jax_export
from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference
from rcnn_ocr_tpu.models import RCNN as JaxRCNN
from rcnn_ocr_tpu.training import checkpoint as jax_ckpt_io
from rcnn_ocr_tpu.training.optim import build_optimizer
from rcnn_ocr_tpu.training.train_step import create_train_state
from rcnn_ocr_tpu_torch import artifact_info as port_ai
from rcnn_ocr_tpu_torch import export as port_export
from rcnn_ocr_tpu_torch import export_serving as port_export_cli
from rcnn_ocr_tpu_torch.export import ServingArtifact, export_serving_artifact
from rcnn_ocr_tpu_torch.inference import OCRInference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
PACKAGES = {"jax": jax_export, "torch": port_export}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    model = JaxRCNN(num_classes=len(TOKENS), hidden_size=16, width_mult=0.0625,
                    lstm_layers=1, with_ctc_head=True, dtype=jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 32, 64, 3)),
                           text=jnp.zeros((1, 5), jnp.int32), batch_max_length=4,
                           method=model.init_all)
    state = create_train_state(model, variables, build_optimizer("Adam", 1e-3))
    d = tmp_path_factory.mktemp("port_export_ckpt")
    charset_path = d / "cs.txt"
    charset_path.write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    ckpt_path = str(d / "w.msgpack")
    jax_ckpt_io.save_weights(ckpt_path, state)
    return ckpt_path, str(charset_path)


@pytest.fixture(scope="module")
def engines(tiny_ckpt):
    ckpt, charset = tiny_ckpt
    kw = dict(img_h=32, img_w=64)
    return (OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, **kw),
            JaxOCRInference(ckpt, charset, dtype=jnp.float32, verbose=False, **kw))


def _images(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (24, 30 + 17 * i, 3)).astype(np.uint8) for i in range(n)]


def _manifest(path):
    with open(os.path.join(path, "manifest.json"), encoding="utf-8") as f:
        return json.load(f)


# one request per branch of the format ladder (and the fixed-width pair
# whose strings are held to JAX's artifact)
LADDER = {
    "ctc_greedy": (dict(method="ctc_greedy", canvas=(32, 64)), 2),
    "attention": (dict(method="attention", canvas=(32, 64), max_length=4), 2),
    "ctc_greedy_conf": (dict(method="ctc_greedy", canvas=(32, 64), with_confidence=True), 5),
    "attention_long_align": (dict(method="attention_long", max_length=4), 3),
    "ctc_long_midpoint": (dict(method="ctc_long", max_length=4), 4),
    "ctc_long_beam_topk": (dict(method="ctc_long_beam", beam_width=3, tile_w=48,
                                overlap=16), 2),
}


@pytest.mark.parametrize("case", list(LADDER))
def test_manifest_and_params_match_jax(engines, tmp_path, case):
    req, fmt = LADDER[case]
    ours, theirs = engines
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    export_serving_artifact(ours, got_dir, batch_size=2, **req)
    jax_export.export_serving_artifact(theirs, want_dir, batch_size=2, **req)
    got, want = _manifest(got_dir), _manifest(want_dir)
    assert got["format_version"] == want["format_version"] == fmt
    assert got.pop("torch_version") == torch.__version__ and "jax_version" in want
    for key in ("files", "decode_files"):
        g, w = got.pop(key, None), want.pop(key, None)
        assert (g is None) == (w is None), key
        if g is not None:
            assert sorted(g) == sorted(w) and all(v.endswith(".pt2") for v in g.values())
    want.pop("jax_version")
    assert got == want
    with open(os.path.join(got_dir, "params.msgpack"), "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    with open(os.path.join(want_dir, "params.msgpack"), "rb") as f:
        jax_restored = serialization.msgpack_restore(f.read())
    flat_got = dict(jax.tree_util.tree_leaves_with_path(restored))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax_restored))
    assert sorted(flat_got, key=str) == sorted(flat_want, key=str)
    for key, arr in flat_want.items():
        np.testing.assert_array_equal(flat_got[key], arr, err_msg=jax.tree_util.keystr(key))
    if case in ("ctc_greedy", "attention"):
        imgs = _images(seed=4, n=5)
        assert ServingArtifact.load(got_dir, device="cpu").predict(imgs) == \
            jax_export.ServingArtifact.load(want_dir).predict(imgs)


def test_artifact_rejects_unknown_method(engines, tmp_path):
    ours = engines[0]
    out_dir = str(tmp_path / "art")
    export_serving_artifact(ours, out_dir, method="attention", batch_size=2, canvas=(32, 64),
                            max_length=4)
    assert _manifest(out_dir)["format_version"] == 2 <= port_export.MANIFEST_VERSION
    art = ServingArtifact.load(out_dir, device="cpu")
    art.method = "from_the_future"
    with pytest.raises(ValueError, match="unknown to this loader"):
        art._decode_rows(np.zeros((2, 5), np.int32), np.zeros((2, 5)), 2, False)
    manifest = _manifest(out_dir)
    manifest["format_version"] = port_export.MANIFEST_VERSION + 1
    with open(os.path.join(out_dir, "manifest.json"), "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="newer than this loader"):
        ServingArtifact.load(out_dir, device="cpu")


def test_export_validates_knobs_before_touching_output(engines, tmp_path):
    ours = engines[0]
    out_dir = str(tmp_path / "art_good")
    export_serving_artifact(ours, out_dir, method="ctc_long", batch_size=2, max_length=4)
    before = {n: os.path.getmtime(os.path.join(out_dir, n)) for n in sorted(os.listdir(out_dir))}
    for kw, match in ((dict(method="ctc_long", snap="nearest"), "snap"),
                      (dict(method="attention_long", merge="vote"), "merge"),
                      (dict(method="ctc_long", width_buckets=(64, 128)), "width_buckets"),
                      (dict(method="ctc_greedy", platforms=("tpu",)), "platforms"),
                      (dict(method="attention", lm_weight=0.5), "lm_weight"),
                      (dict(method="ctc_beam", length_penalty=0.6), "length_penalty")):
        with pytest.raises(ValueError, match=match):
            export_serving_artifact(ours, out_dir, batch_size=2, **kw)
    after = {n: os.path.getmtime(os.path.join(out_dir, n)) for n in sorted(os.listdir(out_dir))}
    assert after == before, "a rejected export modified the artifact dir"
    assert isinstance(ServingArtifact.load(out_dir, device="cpu").predict(_images(n=1))[0], str)


def test_failed_reexport_leaves_artifact_intact(tiny_ckpt, engines, tmp_path):
    ckpt, charset = tiny_ckpt
    out_dir = str(tmp_path / "artifact")
    export_serving_artifact(engines[0], out_dir, method="attention", batch_size=2,
                            canvas=(32, 64), max_length=4)
    imgs = _images(n=2)
    before = ServingArtifact.load(out_dir, device="cpu").predict(imgs)
    attn_only = OCRInference(ckpt, charset, device="cpu", img_h=32, img_w=64,
                             dtype=torch.float32, with_ctc_head=False)
    with pytest.raises(ValueError, match="CTC head"):
        export_serving_artifact(attn_only, out_dir, method="ctc_greedy", batch_size=2,
                                canvas=(32, 64))
    assert ServingArtifact.load(out_dir, device="cpu").predict(imgs) == before


# --- validate_export_request, over both packages --------------------------------------

@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_validate_export_request(pkg):
    validate = PACKAGES[pkg].validate_export_request
    assert validate(True, head="both")["method"] == "attention"
    assert validate(True, head="ctc")["method"] == "ctc_greedy"
    assert validate(True, head="attention")["slot"] == "best_acc"
    out = validate({"method": "ctc_long", "canvas": [32, 64], "slot": "last"}, head="both")
    assert out["canvas"] == (32, 64) and out["slot"] == "last"
    for req, head, match in (
        ({"methd": "attention"}, "both", "unknown key"),
        ({"method": "telepathy"}, "both", "unknown method"),
        ({"method": "ctc_greedy"}, "attention", "CTC head"),
        ({"method": "attention_beam"}, "ctc", "attention head"),
        ({"method": "hybrid_long"}, "ctc", "attention head"),
        ({"slot": "best_vibes"}, "both", "slot"),
        ({"method": "attention", "snap": "blank"}, "both", "snap"),
        ({"method": "ctc_greedy", "tile_w": 128}, "both", "tile_w"),
        ({"method": "attention", "canvas": [64]}, "both", "canvas"),
    ):
        with pytest.raises(ValueError, match=match):
            validate(req, head=head)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_validate_export_request_mirrors_exporter_refusals(pkg):
    validate = PACKAGES[pkg].validate_export_request
    for req, match in (
        ({"method": "ctc_greedy", "length_penalty": 0.6}, "length_penalty"),
        ({"method": "ctc_long", "width_buckets": [64, 128]}, "width_buckets"),
        ({"method": "ctc_greedy", "lm_weight": 0.3, "lm": "x.npz"}, "fusion"),
        ({"method": "attention_beam", "lm_weight": 0.3}, "requires lm"),
    ):
        with pytest.raises(ValueError, match=match):
            validate(req, head="both")
    out = validate({"method": "attention_beam", "lm": "lm.npz", "lm_weight": 0.3,
                    "length_penalty": 0.6}, head="both")
    assert out["lm_weight"] == 0.3
    for bad in ("true", 1):
        with pytest.raises(ValueError, match="must be true or a dict"):
            validate(bad, head="both")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_validate_export_request_calibrate_rules(pkg):
    validate = PACKAGES[pkg].validate_export_request
    out = validate({"method": "ctc_greedy", "quantize": True, "calibrate": 64}, head="both")
    assert out["calibrate"] == 64
    with pytest.raises(ValueError, match="quantize"):
        validate({"method": "ctc_greedy", "calibrate": True}, head="both")
    for bad in (0, "lots"):
        with pytest.raises(ValueError, match="positive"):
            validate({"method": "ctc_greedy", "quantize": True, "calibrate": bad}, head="both")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_validate_export_request_knob_presence_rules(pkg):
    validate = PACKAGES[pkg].validate_export_request
    for req, match in (
        ({"method": "ctc_long", "merge": "text"}, "merge only steers"),
        ({"method": "ctc_long", "min_gap": 5}, "min_gap only steers"),
        ({"method": "attention", "margin": 2}, "margin only steers"),
        ({"method": "hybrid_long", "snap": "midpoint"}, "snap only steers"),
        ({"method": "attention_beam", "lm": "lm.npz"}, "never fuses"),
    ):
        with pytest.raises(ValueError, match=match):
            validate(req, head="both")
    assert validate({"method": "hybrid_long", "min_gap": 5, "margin": 2},
                    head="both")["min_gap"] == 5
    assert validate({"method": "ctc_long", "snap": "blank"}, head="both")["snap"] == "blank"


def test_request_constants_match_jax():
    for name in ("MANIFEST_VERSION", "EXPORT_REQUEST_KEYS", "ALL_METHODS", "LONG_METHODS",
                 "FIXED_METHODS", "CTC_LONG_METHODS", "ATTN_LONG_METHODS",
                 "HYBRID_LONG_METHODS"):
        assert getattr(port_export, name) == getattr(jax_export, name), name


# --- the two CLIs -------------------------------------------------------------------------

def _tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_export_serving_cli_matches_tools_export_serving(tiny_ckpt, tmp_path, monkeypatch,
                                                         capsys):
    ckpt, charset = tiny_ckpt
    argv = ["--model", ckpt, "--charset", charset, "--method", "ctc_long", "--img-h", "32",
            "--img-w", "64", "--batch-size", "2", "--max-length", "4", "--tile-w", "48",
            "--overlap", "16", "--platforms", "cpu"]
    jax_tool = _tool("export_serving")
    monkeypatch.setattr(sys, "argv", ["export_serving.py", *argv, "--out", str(tmp_path / "j")])
    jax_tool.main()
    port_export_cli.main([*argv, "--out", str(tmp_path / "p"), "--device", "cpu"])
    out = [line for line in capsys.readouterr().out.splitlines()
           if not line.startswith(("OCR model", "Charset size", "Input image size"))]
    assert out == [f"Artifact written to: {tmp_path / 'j'}",
                   f"Artifact written to: {tmp_path / 'p'}"]
    got, want = _manifest(tmp_path / "p"), _manifest(tmp_path / "j")
    for m in (got, want):
        m.pop("files"), m.pop("torch_version", None), m.pop("jax_version", None)
    # the JAX engine runs in bf16 by default and the port's too; the manifest
    # records neither
    assert got == want
    base = ["--model", ckpt, "--charset", charset, "--out", str(tmp_path / "x"),
            "--device", "cpu"]
    for extra, message in ((["--method", "attention", "--tile-w", "64"],
                            "--tile-w/--overlap require"),
                           (["--method", "ctc_greedy", "--snap", "blank"], "--snap requires")):
        with pytest.raises(SystemExit) as err:
            port_export_cli.main([*base, *extra])
        assert err.value.code == 2 and message in capsys.readouterr().err


def test_artifact_info_cli_matches_tools_artifact_info(engines, tmp_path, monkeypatch, capsys):
    jax_tool = _tool("artifact_info")
    assert port_ai.KNOWN_MANIFEST_VERSION == port_export.MANIFEST_VERSION
    ours, theirs = engines
    got_dir, want_dir = str(tmp_path / "art_info"), str(tmp_path / "jax_info")
    export_serving_artifact(ours, got_dir, method="ctc_long", batch_size=2, max_length=4)
    jax_export.export_serving_artifact(theirs, want_dir, method="ctc_long", batch_size=2,
                                       max_length=4)
    got, want = port_ai.artifact_info(got_dir), jax_tool.artifact_info(want_dir)
    assert got["format_version"] == 4 and got["readable"] and got["tile_kernel"] == "argmax"
    assert got["kernel_count"] == 1 and got["total_bytes"] > 0
    assert got.pop("torch_version") == torch.__version__
    for info in (got, want):
        for key in ("dir", "files", "total_bytes", "jax_version"):
            info.pop(key, None)
    assert got == want
    assert port_ai.main([got_dir]) == 0
    text = capsys.readouterr().out
    assert "format_version:  4" in text and f"exported with torch {torch.__version__}" in text
    assert "tiles_w64.pt2" in text
    assert port_ai.main([got_dir, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["method"] == "ctc_long"
    manifest = _manifest(got_dir)
    manifest["format_version"] = port_ai.KNOWN_MANIFEST_VERSION + 1
    with open(os.path.join(got_dir, "manifest.json"), "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    assert port_ai.main([got_dir]) == 2 and "NEWER" in capsys.readouterr().out
    assert port_ai.main([str(tmp_path)]) == 1
