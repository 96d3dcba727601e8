"""Checkpoints written by the JAX package, read and decoded by the port.

* the port's pure-Python msgpack reader returns what
  ``flax.serialization.msgpack_restore`` returns;
* ``load_jax_variables`` then ``to_jax_variables`` gives back the tree
  exactly, and a missing, unexpected or mis-shaped key raises;
* end to end: a JAX-written checkpoint decodes to the same strings through
  the port's ``OCRInference.predict`` / ``predict_ctc`` and the JAX one, both
  in fp32 on the CPU (canvas-sized images, so the resize is the identity on
  both sides); confidences agree at rtol/atol 1e-4.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference
from rcnn_ocr_tpu.inference import infer_architecture as jax_infer_architecture
from rcnn_ocr_tpu.models import RCNN as JaxRCNN
from rcnn_ocr_tpu.training import checkpoint as jax_ckpt
from rcnn_ocr_tpu_torch.inference import OCRInference, infer_architecture
from rcnn_ocr_tpu_torch.interop.jax_params import load_jax_variables, to_jax_variables
from rcnn_ocr_tpu_torch.models.rcnn import RCNN
from rcnn_ocr_tpu_torch.training import checkpoint as ckpt

TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
HIDDEN, WIDTH, IMG_H, IMG_W, MAX_LEN = 32, 0.125, 32, 64, 6


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """A JAX-initialized tiny model (both heads) saved as a full checkpoint
    (charset and sizes embedded) and as bare weights."""
    model = JaxRCNN(num_classes=len(TOKENS), hidden_size=HIDDEN, width_mult=WIDTH,
                    with_ctc_head=True, dtype=jnp.float32)
    x = jnp.zeros((1, IMG_H, IMG_W, 3))
    variables = model.init({"params": jax.random.PRNGKey(4)}, x,
                           text=jnp.zeros((1, MAX_LEN + 1), jnp.int32),
                           batch_max_length=MAX_LEN, method=model.init_all)
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.3, size=a.shape).astype(np.float32),
        variables["batch_stats"])
    state = types.SimpleNamespace(params=variables["params"], batch_stats=stats, opt_state={})
    root = tmp_path_factory.mktemp("jax_ckpt")
    full, bare = str(root / "last_ckpt.msgpack"), str(root / "best_acc_weights.msgpack")
    jax_ckpt.save_checkpoint(
        full, state, {}, epoch=1, global_step=7, best_val_loss=1.25, best_val_acc=0.5,
        itos=TOKENS, stoi={s: i for i, s in enumerate(TOKENS)},
        config={"img_h": IMG_H, "img_w": IMG_W, "hidden_size": HIDDEN}, log_dir="logs",
    )
    jax_ckpt.save_weights(bare, state)
    charset = root / "charset.txt"
    charset.write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    return full, bare, str(charset)


def _assert_same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("which", [0, 1])
def test_msgpack_reader_matches_flax_on_jax_checkpoints(jax_checkpoints, which):
    path = jax_checkpoints[which]
    with open(path, "rb") as f:
        data = f.read()
    _assert_same_tree(ckpt.msgpack_restore(data), serialization.msgpack_restore(data))


def test_msgpack_reader_covers_every_type():
    blob = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -129,
                 -40000, -(2**33)],
        "floats": [0.5, -1e300, float("inf")],
        "flags": [True, False, None],
        "strs": ["", "x" * 31, "y" * 40, "z" * 300, "ünï"],
        "bin": b"\x00\x01" * 200,
        "nested": {"list": [[1, [2, {"k": "v"}]]], "big": list(range(20))},
        "arrays": {
            "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
            "i64": np.array([-5, 7], dtype=np.int64),
            "bool": np.array([True, False]),
            "empty": np.zeros((0, 3), np.float32),
        },
        "scalar": np.float32(2.5),
        "wide_map": {str(i): i for i in range(20)},
    }
    data = serialization.msgpack_serialize(blob)
    _assert_same_tree(ckpt.msgpack_restore(data), serialization.msgpack_restore(data))
    bf16 = np.asarray(jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16))
    got = ckpt.msgpack_restore(serialization.msgpack_serialize({"w": bf16}))["w"]
    np.testing.assert_array_equal(got, np.array([1.0, -2.5, 3.140625], np.float32))
    chunked = {"__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 2},
               "chunks": {"0": np.arange(3.0), "1": np.arange(1.0)}}
    got = ckpt.msgpack_restore(serialization.msgpack_serialize({"a": chunked}))["a"]
    np.testing.assert_array_equal(got, np.array([[0.0, 1.0], [2.0, 0.0]]))


def test_newer_checkpoint_format_is_refused(tmp_path):
    path = tmp_path / "future.msgpack"
    path.write_bytes(serialization.msgpack_serialize({"format_version": 2, "params": {}}))
    with pytest.raises(ValueError, match="format 2"):
        ckpt.load_checkpoint_blob(str(path))
    path.write_bytes(serialization.msgpack_serialize({"format_version": 1}))
    with pytest.raises(ValueError, match="no model parameters"):
        ckpt.load_variables(str(path))


def _port_model(**kw):
    return RCNN(num_classes=len(TOKENS), hidden_size=HIDDEN, width_mult=WIDTH,
                with_ctc_head=True, **kw).eval()


def test_round_trip_is_exact(jax_checkpoints):
    variables, blob = ckpt.load_variables(jax_checkpoints[0])
    assert blob["itos"] == TOKENS and blob["config"]["img_w"] == IMG_W
    model = load_jax_variables(_port_model(), variables)
    back = to_jax_variables(model)
    want = serialization.msgpack_restore(open(jax_checkpoints[0], "rb").read())
    _assert_same_tree(back, {"params": want["params"], "batch_stats": want["batch_stats"]})


def test_wrong_keys_raise_naming_the_key(jax_checkpoints):
    variables, _ = ckpt.load_variables(jax_checkpoints[1])
    params = variables["params"]

    renamed = dict(params, ctc_head=params["ctc_proj"])
    del renamed["ctc_proj"]
    with pytest.raises(KeyError, match="ctc_proj/bias.*ctc_head/bias"):
        load_jax_variables(_port_model(), {"params": renamed,
                                           "batch_stats": variables["batch_stats"]})
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["attn"]["w_gen"] = np.zeros((HIDDEN, 3), np.float32)
    with pytest.raises(ValueError, match="params/attn/w_gen"):
        load_jax_variables(_port_model(), {"params": bad,
                                           "batch_stats": variables["batch_stats"]})
    with pytest.raises(KeyError, match="unexpected.*quant_stats/cnn/out1/conv/act_absmax"):
        # only a static int8 model has act_absmax leaves
        load_jax_variables(_port_model(), dict(variables, quant_stats={
            "cnn": {"out1": {"conv": {"act_absmax": np.float32(1.0)}}}}))
    with pytest.raises(KeyError, match="unexpected variable collections"):
        load_jax_variables(_port_model(), dict(variables, intermediates={}))
    no_ctc = RCNN(num_classes=len(TOKENS), hidden_size=HIDDEN, width_mult=WIDTH).eval()
    with pytest.raises(KeyError, match="unexpected.*ctc_proj"):
        load_jax_variables(no_ctc, variables)


def test_infer_architecture_matches_jax(jax_checkpoints):
    variables, _ = ckpt.load_variables(jax_checkpoints[1])
    assert infer_architecture(variables["params"]) == jax_infer_architecture(variables["params"])


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(IMG_H, IMG_W, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def engines(jax_checkpoints):
    full, bare, charset = jax_checkpoints
    ours = OCRInference(full, device="cpu", dtype=torch.float32)
    theirs = JaxOCRInference(full, dtype=jnp.float32, verbose=False)
    return ours, theirs


def test_predict_strings_match_jax(engines):
    ours, theirs = engines
    imgs = _images(5)
    got = ours.predict(imgs, max_length=MAX_LEN, batch_size=2, return_confidence=True)
    want = theirs.predict(imgs, max_length=MAX_LEN, batch_size=2, return_confidence=True)
    assert [t for t, _ in got] == [t for t, _ in want]
    assert any(t for t, _ in got)
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=1e-4, atol=1e-4)
    assert ours.predict(imgs[0], max_length=MAX_LEN) == want[0][0]
    assert ours.predict([], max_length=MAX_LEN) == []


def test_predict_ctc_strings_match_jax(engines):
    ours, theirs = engines
    imgs = _images(5, seed=1)
    got = ours.predict_ctc(imgs, batch_size=2, return_confidence=True)
    want = theirs.predict_ctc(imgs, batch_size=2, return_confidence=True)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=1e-4, atol=1e-4)
    assert ours.predict_ctc(imgs, batch_size=4) == [t for t, _ in want]


def test_width_buckets_match_jax(jax_checkpoints):
    full, bare, charset = jax_checkpoints
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, size=(IMG_H, w, 3), dtype=np.uint8) for w in (20, 40, 64, 30)]
    ours = OCRInference(bare, charset, device="cpu", img_h=IMG_H, img_w=IMG_W,
                        dtype=torch.float32, width_buckets=[32, 64])
    theirs = JaxOCRInference(bare, charset, img_h=IMG_H, img_w=IMG_W, dtype=jnp.float32,
                             width_buckets=[32, 64], verbose=False)
    assert ours.predict(imgs, max_length=MAX_LEN, batch_size=2) == \
        theirs.predict(imgs, max_length=MAX_LEN, batch_size=2)
    assert ours.predict_ctc(imgs, batch_size=2) == theirs.predict_ctc(imgs, batch_size=2)


def test_variables_in_memory_and_sizes_from_the_checkpoint(jax_checkpoints, engines):
    full, bare, charset = jax_checkpoints
    ours = engines[0]
    assert (ours.img_h, ours.img_w) == (IMG_H, IMG_W)
    assert list(ours.charset.itos) == TOKENS
    variables = to_jax_variables(ours.model)
    again = OCRInference(variables, charset, device="cpu", img_h=IMG_H, img_w=IMG_W,
                         dtype=torch.float32)
    imgs = _images(3, seed=3)
    assert again.predict_ctc(imgs) == ours.predict_ctc(imgs)
    with pytest.raises(ValueError, match="charset_path required"):
        OCRInference(bare, device="cpu")


def test_device_is_cuda_unless_cpu_is_asked_for(jax_checkpoints, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kwargs in ({}, {"device": "auto"}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OCRInference(jax_checkpoints[0], **kwargs)


def test_later_slice_options_raise(engines, jax_checkpoints):
    """Beams and ``"auto:K"`` buckets arrived with the beam slice, the
    serving path and the long-line decodes with the next, int8 with a later
    one (``tests/test_torch_port_quant.py``); what is still to come
    (multi-card serving, ``mesh``) raises naming its ROADMAP item instead of
    being ignored."""
    ours = engines[0]
    img = _images(1)[0]
    assert isinstance(ours.predict(img, max_length=MAX_LEN, beam_width=4), str)
    assert isinstance(ours.predict_ctc(img, method="beam"), str)
    wide = np.concatenate(_images(3, seed=4), axis=1)  # three canvases wide
    assert isinstance(ours.predict_serving(img, max_length=MAX_LEN, canvas="auto"), str)
    assert isinstance(ours.predict_long(wide, max_length=MAX_LEN), str)
    assert isinstance(ours.predict_ctc_long(wide), str)
    assert isinstance(ours.predict_hybrid_long(wide, max_length=MAX_LEN), str)
    full = jax_checkpoints[0]
    auto = OCRInference(full, device="cpu", width_buckets="auto:4")
    assert auto._auto_bucket_k == 4 and auto.width_buckets is None
    with pytest.raises(ValueError, match="unknown spec"):
        OCRInference(full, device="cpu", width_buckets="fixed")
    with pytest.raises(ValueError, match="quantize=True"):
        ours.calibrate(img)
    assert OCRInference(full, device="cpu", quantize=True).model.quantize
    with pytest.raises(NotImplementedError, match="item 13"):
        OCRInference(full, device="cpu", mesh=True)
