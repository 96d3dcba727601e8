"""The port's serving artifacts against its live engine (CPU).

Every method of ``ALL_METHODS`` is exported from one tiny engine, loaded in
a fresh ``ServingArtifact`` and held to the live decode it was exported
from on every row (``predict_serving`` for the fixed-width methods,
``predict_ctc_long`` / ``predict_long`` / ``predict_hybrid_long`` for the
long ones, with one- and several-tile lines): LM fusion and the length
penalty baked into the beams, ``merge`` ``align`` and ``text``, the v5 CTC
confidence outputs, width buckets, and the int8 engine with dynamic and
calibrated static scales (``quant_stats`` ride in ``params.msgpack``).
Also: the loader's device rules (``platforms``), ``mesh=`` served, and
``serving_predict_fn`` over an artifact with and without confidences.
"""

import json
import os

import numpy as np
import pytest
import torch

from rcnn_ocr_tpu_torch import export as port_export
from rcnn_ocr_tpu_torch.export import ALL_METHODS, ServingArtifact, export_serving_artifact
from rcnn_ocr_tpu_torch.inference import OCRInference
from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_params
from rcnn_ocr_tpu_torch.serving import serving_predict_fn

TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
IMG_H, IMG_W, BATCH, MAX_LEN, BEAM = 32, 64, 2, 4, 3


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Seeded weights of a tiny two-head model and a bigram table."""
    model = RCNN(len(TOKENS), hidden_size=16, width_mult=0.0625, with_ctc_head=True,
                 lstm_layers=1)
    init_params(model, torch.Generator().manual_seed(0))
    root = tmp_path_factory.mktemp("port_artifact")
    charset = root / "cs.txt"
    charset.write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    logits = np.random.default_rng(1).normal(size=(len(TOKENS), len(TOKENS)))
    lm = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    return to_jax_variables(model), str(charset), lm


def _engine(ckpt, **kw):
    variables, charset, lm = ckpt
    return OCRInference(variables, charset, device="cpu", img_h=IMG_H, img_w=IMG_W,
                        dtype=torch.float32, lm=lm, **kw)


@pytest.fixture(scope="module")
def engine(ckpt):
    return _engine(ckpt)


def _images(seed=0):
    rng = np.random.default_rng(seed)
    short = [rng.integers(0, 256, (24, w, 3)).astype(np.uint8) for w in (30, 47, 64, 20)]
    return short, short[:2] + [rng.integers(0, 256, (28, 260, 3)).astype(np.uint8)]


def _live(ocr, method, images, kw, return_confidence=False):
    """The live decode an artifact of ``method`` exported with ``kw`` runs."""
    beam = method.endswith("beam")
    common = dict(batch_size=BATCH, return_confidence=return_confidence)
    if method.startswith("ctc_long"):
        return ocr.predict_ctc_long(images, method="beam" if beam else "greedy",
                                    beam_width=kw.get("beam_width", 16),
                                    snap=kw.get("snap", "midpoint"), **common)
    if method.startswith("hybrid_long"):
        return ocr.predict_hybrid_long(images, max_length=MAX_LEN, beam=beam,
                                       beam_width=kw.get("beam_width", 16),
                                       length_penalty=kw.get("length_penalty", 0.0),
                                       lm_weight=kw.get("lm_weight", 0.0), **common)
    if method.startswith("attention_long"):
        return ocr.predict_long(images, method="attention_beam" if beam else "attention",
                                max_length=MAX_LEN, beam_width=kw.get("beam_width", 16),
                                length_penalty=kw.get("length_penalty", 0.0),
                                lm_weight=kw.get("lm_weight", 0.0),
                                merge=kw.get("merge", "align"), batch_size=BATCH)
    return ocr.predict_serving(images, max_length=MAX_LEN, canvas=(IMG_H, 96), method=method,
                               beam_width=kw.get("beam_width", 16),
                               length_penalty=kw.get("length_penalty", 0.0),
                               lm_weight=kw.get("lm_weight", 0.0), **common)


CASES = {
    "attention": {},
    "attention_beam": dict(beam_width=BEAM, lm_weight=0.5, length_penalty=0.6),
    "ctc_greedy": dict(with_confidence=True),
    "ctc_beam": dict(beam_width=BEAM, lm_weight=0.5, with_confidence=True),
    "ctc_long": dict(with_confidence=True),
    "ctc_long_beam": dict(beam_width=BEAM, snap="blank"),
    "attention_long": dict(merge="align"),
    "attention_long_beam": dict(beam_width=BEAM, merge="text", lm_weight=0.5),
    "hybrid_long": {},
    "hybrid_long_beam": dict(beam_width=BEAM, length_penalty=0.6),
}
assert sorted(CASES) == sorted(ALL_METHODS)


@pytest.mark.parametrize("method", list(CASES))
def test_every_method_equals_the_live_engine(engine, tmp_path, method):
    kw = CASES[method]
    out_dir = str(tmp_path / method)
    export_serving_artifact(engine, out_dir, method=method, batch_size=BATCH,
                            canvas=(IMG_H, 96), max_length=MAX_LEN, **kw)
    art = ServingArtifact.load(out_dir, device="cpu")
    short, long = _images(seed=len(method))
    images = long if method in port_export.LONG_METHODS else short
    live = _live(engine, method, images, kw)
    assert art.predict(images) == live
    assert art.predict(images[1]) == live[1] and art.predict([]) == []
    if method not in port_export.ATTN_LONG_METHODS:
        got = art.predict(images, return_confidence=True)
        want = _live(engine, method, images, kw, return_confidence=True)
        assert [t for t, _ in got] == [t for t, _ in want]
        np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=1e-6,
                                   atol=1e-7)
    files = sorted(os.listdir(out_dir))
    assert "manifest.json" in files and "params.msgpack" in files
    programs = [f for f in files if f.endswith(".pt2")]
    assert programs and all(f.startswith(port_export.KERNEL_PREFIXES) for f in programs)
    for f in programs:  # the weights live in params.msgpack only
        ep = torch.export.load(os.path.join(out_dir, f))
        assert not ep.state_dict and ep.example_inputs is None
        assert max(t.numel() for t in ep.constants.values()) <= 256  # LM, normalize table


def test_confidence_contract_and_width_buckets(ckpt, engine, tmp_path):
    plain = str(tmp_path / "ctc_plain")
    export_serving_artifact(engine, plain, method="ctc_greedy", batch_size=BATCH,
                            canvas=(IMG_H, 96))
    art = ServingArtifact.load(plain, device="cpu")
    assert art.manifest["format_version"] == 2 and art.manifest["ctc_confidence"] is False
    with pytest.raises(ValueError, match="re-export"):
        art.predict(_images()[0], return_confidence=True)
    with pytest.raises(ValueError, match="re-export"):
        serving_predict_fn(art, return_confidence=True)
    assert serving_predict_fn(art) == art.predict
    long_plain = str(tmp_path / "ctc_long_plain")
    export_serving_artifact(engine, long_plain, method="ctc_long", batch_size=BATCH)
    art = ServingArtifact.load(long_plain, device="cpu")
    assert art.manifest["tile_kernel"] == "argmax" and art.manifest["format_version"] == 4
    lines = _images(seed=6)[1]
    assert art.predict(lines) == engine.predict_ctc_long(lines, batch_size=BATCH)
    with pytest.raises(ValueError, match="re-export"):
        art.predict(lines, return_confidence=True)
    bucketed = _engine(ckpt, width_buckets=[32, 64])
    out_dir = str(tmp_path / "buckets")
    export_serving_artifact(bucketed, out_dir, method="attention", batch_size=BATCH,
                            canvas=(IMG_H, 96), max_length=MAX_LEN)
    art = ServingArtifact.load(out_dir, device="cpu")
    assert sorted(art.manifest["files"]) == ["32", "64"]
    short = _images(seed=3)[0]
    assert art.predict(short) == bucketed.predict_serving(short, max_length=MAX_LEN,
                                                          batch_size=BATCH, canvas=(IMG_H, 96))
    fn = serving_predict_fn(art, return_confidence=True)
    assert fn(short) == art.predict(short, return_confidence=True)


@pytest.mark.parametrize("method", ["ctc_greedy", "attention"])
def test_int8_dynamic_and_static_artifacts(ckpt, tmp_path, method):
    ocr = _engine(ckpt, quantize=True)
    short = _images(seed=9)[0]
    dyn_dir = str(tmp_path / "int8_dyn")
    export_serving_artifact(ocr, dyn_dir, method=method, batch_size=BATCH, canvas=(IMG_H, 96),
                            max_length=MAX_LEN)
    art = ServingArtifact.load(dyn_dir, device="cpu")
    assert art.manifest["quantize"] is True and art.manifest["act_quant"] == "dynamic"
    assert art.predict(short) == _live(ocr, method, short, {})
    ocr.calibrate(short, batch_size=BATCH)
    st_dir = str(tmp_path / "int8_static")
    export_serving_artifact(ocr, st_dir, method=method, batch_size=BATCH, canvas=(IMG_H, 96),
                            max_length=MAX_LEN)
    art = ServingArtifact.load(st_dir, device="cpu")
    assert art.manifest["act_quant"] == "static" and "quant_stats" in art.variables
    assert art.predict(short) == _live(ocr, method, short, {})


def test_loader_device_rules(engine, tmp_path, monkeypatch):
    out_dir = str(tmp_path / "multi")
    export_serving_artifact(engine, out_dir, method="ctc_greedy", batch_size=BATCH,
                            canvas=(IMG_H, 96), platforms=("cuda", "cpu"))
    short = _images(seed=5)[0]
    live = engine.predict_serving(short, batch_size=BATCH, canvas=(IMG_H, 96),
                                  method="ctc_greedy")
    assert ServingArtifact.load(out_dir, device="cpu").manifest["platforms"] == ["cuda", "cpu"]
    # a program from another device is moved when the manifest lists this one
    monkeypatch.setattr(port_export, "_program_device", lambda ep: "cuda")
    assert ServingArtifact.load(out_dir, device="cpu").predict(short) == live
    manifest = json.load(open(os.path.join(out_dir, "manifest.json"), encoding="utf-8"))
    manifest["platforms"] = None
    json.dump(manifest, open(os.path.join(out_dir, "manifest.json"), "w", encoding="utf-8"))
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        ServingArtifact.load(out_dir, device="cpu")
    monkeypatch.undo()
    # mesh=True on the CPU is one CPU replica; two named replicas split the batch
    for mesh in (True, ["cpu", "cpu"]):
        sharded = ServingArtifact.load(out_dir, device="cpu", mesh=mesh)
        assert len(sharded._replicas) == (1 if mesh is True else 2)
        assert sharded.predict(short) == live
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingArtifact.load(out_dir, device=device)


def test_programs_copy_the_stem_input_to_nhwc(engine, tmp_path):
    """The stem's input is a recorded copy to channels_last in every program.
    A `contiguous` there was traced as a no-op (the traced tensor was NHWC
    already), and on the card the device resize's strided output then
    reached the stem convs as NCHW: cuDNN rounded otherwise, and strings
    left the live engine's."""
    out_dir = str(tmp_path / "ctc")
    export_serving_artifact(engine, out_dir, method="ctc_greedy", batch_size=BATCH,
                            canvas=(IMG_H, 96))
    ep = torch.export.load(os.path.join(out_dir, "serving_w64.pt2"))
    conv = next(n for n in ep.graph.nodes
                if n.op == "call_function" and "conv" in str(n.target))
    src = conv.args[0]
    assert "clone" in str(src.target), src.target
    assert src.kwargs.get("memory_format") == torch.channels_last
