"""The reference's ``.pth`` checkpoints in the port vs in the JAX package, on the CPU.

Weights are written in each of the three reference layouts (full with
``itos``/``stoi``/``config``, legacy ``model_state_dict`` + ``hidden_size``,
and a bare state_dict) by the JAX package's
``interop/torch_export.py:save_torch_checkpoint``.  Held:

* the port's ``import_torch_checkpoint`` (``torch.load(weights_only=True)``)
  gives JAX's leaves exactly, and the same charset, hidden size, class
  count and config;
* ``OCRInference(.pth)`` gives JAX's ``OCRInference(.pth)`` strings;
* ``load_model`` resolves the charset in JAX's order (``itos``, ``stoi``,
  ``charset_path``, the embedded one) and loads JAX's leaves;
* ``run_training`` warm-starts from ``.pth`` / ``.pt``: the model holds
  JAX's imported leaves before the first step, and the run trains;
* a wrong ``hidden_size`` raises as JAX's does.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference  # noqa: E402
from rcnn_ocr_tpu.interop import torch_import as jax_import  # noqa: E402
from rcnn_ocr_tpu.interop.torch_export import save_torch_checkpoint  # noqa: E402
from rcnn_ocr_tpu.utils.common import load_model as jax_load_model  # noqa: E402
from rcnn_ocr_tpu_torch.inference import OCRInference  # noqa: E402
from rcnn_ocr_tpu_torch.interop import torch_import  # noqa: E402
from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables  # noqa: E402
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_train_params  # noqa: E402
from rcnn_ocr_tpu_torch.utils.common import load_model  # noqa: E402
from rcnn_ocr_tpu_torch.vocab.charset import Charset  # noqa: E402
from tests.test_torch_port_beam_engine import _images  # noqa: E402
from tests.test_torch_port_train_loop import tiny  # noqa: E402,F401

TOKENS = ["<PAD>", "<SOS>", "<EOS>", "<BLANK>", "a", "b", "c"]
HIDDEN, WIDTH, IMG_H, IMG_W, MAX_LEN = 16, 0.25, 32, 64, 5
LAYOUTS = ("full", "legacy", "bare")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_same_leaves(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg="/".join(key))


def _reference_variables(tokens, hidden, width, seed):
    """Seeded weights of the reference architecture (attention head, two
    BiLSTMs), sharpened so that a random model reads lines apart."""
    cs = Charset.from_tokens(tokens)
    model = RCNN(num_classes=len(tokens), hidden_size=hidden, width_mult=width,
                 sos_id=cs.sos_id, eos_id=cs.eos_id, pad_id=cs.pad_id, blank_id=cs.blank_id)
    init_train_params(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.attn.w_ctx.mul_(10.0)
        model.attn.w_emb.mul_(0.1)
        model.attn.w_hh.mul_(0.1)
        model.attn.w_gen.mul_(4.0)
    return to_jax_variables(model)


def _write(path, variables, layout, tokens):
    cs = Charset.from_tokens(tokens)
    kw = {}
    if layout == "full":
        kw = dict(itos=list(cs.itos), stoi=dict(cs.stoi),
                  config={"img_h": IMG_H, "img_w": IMG_W, "batch_size": 8, "lr": 1e-3,
                          "charset_path": "cs.txt", "train_csvs": ["a.csv"]})
    save_torch_checkpoint(str(path), variables, layout=layout, strict=False, **kw)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("pth")
    variables = _reference_variables(TOKENS, HIDDEN, WIDTH, seed=3)
    charset = root / "cs.txt"
    charset.write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    paths = {layout: _write(root / f"w_{layout}.pth", variables, layout, TOKENS)
             for layout in LAYOUTS}
    return paths, str(charset)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_import_matches_jax(checkpoints, layout):
    paths, _ = checkpoints
    torch.load(paths[layout], map_location="cpu", weights_only=True)  # loads as weights only
    got = torch_import.import_torch_checkpoint(paths[layout])
    want = jax_import.import_torch_checkpoint(paths[layout])
    _assert_same_leaves(got["variables"], want["variables"])
    for key in ("itos", "stoi", "hidden_size", "num_classes", "config"):
        assert got[key] == want[key], key
    assert got["hidden_size"] == HIDDEN and got["num_classes"] == len(TOKENS)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ocr_inference_from_pth_matches_jax(checkpoints, layout):
    paths, charset = checkpoints
    cs = None if layout == "full" else charset  # the full layout embeds its charset
    size = {} if layout == "full" else dict(img_h=IMG_H, img_w=IMG_W)
    ours = OCRInference(paths[layout], cs, device="cpu", dtype=torch.float32, **size)
    theirs = JaxOCRInference(paths[layout], cs, dtype=jnp.float32, verbose=False, **size)
    assert (ours.img_h, ours.img_w) == (theirs.img_h, theirs.img_w) == (IMG_H, IMG_W)
    assert ours.charset.itos == theirs.charset.itos
    imgs = _images(8, seed=5, widths=(40, 64, 52))
    got = ours.predict(imgs, max_length=MAX_LEN, batch_size=3, return_confidence=True)
    want = theirs.predict(imgs, max_length=MAX_LEN, batch_size=3, return_confidence=True)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=1e-5, atol=1e-5)
    assert len({t for t, _ in got}) > 1
    beam = dict(max_length=MAX_LEN, batch_size=3, beam_width=3)
    assert ours.predict(imgs, **beam) == theirs.predict(imgs, **beam)


@pytest.mark.parametrize("source", ["itos", "stoi", "charset_path", "embedded"])
def test_load_model_resolves_like_jax(checkpoints, source):
    paths, charset = checkpoints
    cs = Charset.from_tokens(TOKENS)
    kw = {"itos": dict(itos=list(cs.itos)), "stoi": dict(stoi=dict(cs.stoi)),
          "charset_path": dict(charset_path=charset), "embedded": {}}[source]
    path = paths["full" if source == "embedded" else "bare"]
    model, variables, charset_got = load_model(path, device="cpu", **kw)
    _, want_vars, want_cs = jax_load_model(path, **kw)
    assert charset_got.itos == want_cs.itos
    _assert_same_leaves(variables, want_vars)
    _assert_same_leaves(to_jax_variables(model), want_vars)
    assert not model.training and model.hidden_size == HIDDEN


def test_load_model_without_a_charset_raises_as_jax_does(checkpoints):
    paths, _ = checkpoints
    with pytest.raises(ValueError, match="charset required"):
        jax_load_model(paths["bare"])
    with pytest.raises(ValueError, match="charset required"):
        load_model(paths["bare"], device="cpu")


def test_wrong_hidden_size_raises_as_jax_does(checkpoints):
    paths, _ = checkpoints
    for importer in (jax_import, torch_import):
        with pytest.raises(ValueError, match="does not match the checkpoint"):
            importer.import_torch_checkpoint(paths["bare"], hidden_size=HIDDEN * 2)


@pytest.mark.parametrize("suffix", [".pth", ".pt"])
def test_run_training_warm_starts_from_pth(tiny, monkeypatch, suffix):  # noqa: F811
    from rcnn_ocr_tpu_torch.training import train
    from tests.test_torch_port_train_loop import HIDDEN as T_HIDDEN, TOKENS as T_TOKENS, \
        WIDTH as T_WIDTH, _cfg

    variables = _reference_variables(T_TOKENS, T_HIDDEN, T_WIDTH, seed=4)
    path = _write(tiny["tmp"] / f"warm{suffix}", variables, "full", T_TOKENS)
    want = jax_load_model(path, itos=T_TOKENS, hidden_size=T_HIDDEN)[1]
    loaded = []
    real = train.load_jax_variables

    def spy(model, tree):
        real(model, tree)
        loaded.append(to_jax_variables(model))
        return model

    monkeypatch.setattr(train, "load_jax_variables", spy)
    result = train.run_training(_cfg(tiny, f"warm{suffix}", epochs=1, resume_path=path),
                                device="cpu")
    assert len(loaded) == 1
    _assert_same_leaves(loaded[0], want)
    assert np.isfinite(result["val_loss"]) and result["global_step"] == 3
    with open(f"{result['exp_dir']}/train.log", encoding="utf-8") as f:
        assert "Warm start from torch checkpoint" in f.read()
