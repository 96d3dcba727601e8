"""The port's ``.pth`` export vs the JAX package's, on the CPU.

``rcnn_ocr_tpu_torch.interop.torch_export`` against
``rcnn_ocr_tpu/interop/torch_export.py`` on the same variables (seeded, the
batch statistics made non-trivial), as ``tests/test_torch_export.py``
holds JAX's against the reference:

* ``export_torch_state_dict`` gives JAX's keys, shapes, dtypes and values
  bit for bit, from a variable tree and from the port's ``RCNN``;
  ``ctc_proj`` and ``quant_stats`` are skipped; a narrow stem under
  ``strict`` and one LSTM layer raise JAX's errors;
* ``save_torch_checkpoint`` writes the three layouts (``full``, ``legacy``,
  ``bare``) with JAX's tensors and fields, and the port's importer reads
  them back to the variables;
* ``python -m rcnn_ocr_tpu_torch.export_torch`` and ``tools/export_torch.py``
  write ``.pth`` files with the same tensors and fields from one msgpack,
  and refuse a narrow model alike.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from flax import serialization  # noqa: E402

from rcnn_ocr_tpu.interop import torch_export as jax_export  # noqa: E402
from rcnn_ocr_tpu_torch import export_torch  # noqa: E402
from rcnn_ocr_tpu_torch.interop import torch_export, torch_import  # noqa: E402
from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables  # noqa: E402
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_train_params  # noqa: E402
from rcnn_ocr_tpu_torch.vocab.charset import Charset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = ["<PAD>", "<SOS>", "<EOS>", "<BLANK>"] + list("abcdefghij")
HIDDEN, LAYOUTS = 16, ("full", "legacy", "bare")


def _model(width, seed=3, lstm_layers=2, with_ctc_head=True):
    cs = Charset.from_tokens(TOKENS)
    model = RCNN(num_classes=len(TOKENS), hidden_size=HIDDEN, width_mult=width,
                 lstm_layers=lstm_layers, with_ctc_head=with_ctc_head, sos_id=cs.sos_id,
                 eos_id=cs.eos_id, pad_id=cs.pad_id, blank_id=cs.blank_id).eval()
    init_train_params(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():  # batch statistics away from 0 / 1, so they carry over visibly
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.add_(torch.from_numpy(rng.uniform(0.0, 0.1, buf.shape).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def narrow():
    return _model(0.25)


@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    """A width-1.0 model (the reference's stem) as a flax msgpack."""
    model = _model(1.0, seed=4)
    path = tmp_path_factory.mktemp("pth_export") / "w_weights.msgpack"
    path.write_bytes(serialization.msgpack_serialize(to_jax_variables(model)))
    return model, str(path)


def _assert_same_state(got, want):
    assert list(got) == list(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("source", ["variables", "model"])
def test_state_dict_equals_jax(narrow, source):
    variables = to_jax_variables(narrow)
    got = torch_export.export_torch_state_dict(narrow if source == "model" else variables,
                                               strict=False)
    want = jax_export.export_torch_state_dict(variables, strict=False)
    _assert_same_state(got, want)
    assert not any(k.startswith("ctc") for k in got)
    assert not got["enc_rnn.0.rnn.bias_hh_l0"].any()  # the summed bias sits in bias_ih


def test_skips_and_refusals_match_jax(narrow):
    variables = to_jax_variables(narrow)
    with_stats = dict(variables, quant_stats={"cnn": {"out0": {"conv": {"act_absmax": 1.5}}}})
    _assert_same_state(torch_export.export_torch_state_dict(with_stats, strict=False),
                       jax_export.export_torch_state_dict(variables, strict=False))
    messages = []
    for pkg in (torch_export, jax_export):
        with pytest.raises(ValueError, match="64-channel stem") as err:
            pkg.export_torch_state_dict(variables)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    one = to_jax_variables(_model(0.25, lstm_layers=1))
    for pkg in (torch_export, jax_export):
        with pytest.raises(ValueError, match="exactly 2 encoder BiLSTMs"):
            pkg.export_torch_state_dict(one, strict=False)
    attn_free = to_jax_variables(_model(0.25, with_ctc_head=True))
    attn_free["params"] = {k: v for k, v in attn_free["params"].items() if k != "attn"}
    got = torch_export.export_torch_state_dict(attn_free, strict=False)
    assert not any(k.startswith("attn") for k in got)
    _assert_same_state(got, jax_export.export_torch_state_dict(attn_free, strict=False))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layouts_equal_jax_and_import_back(narrow, tmp_path, layout):
    variables = to_jax_variables(narrow)
    cs = Charset.from_tokens(TOKENS)
    kw = dict(layout=layout, itos=list(cs.itos), stoi=dict(cs.stoi),
              config={"img_h": 32, "img_w": 64}, strict=False)
    ours, theirs = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    torch_export.save_torch_checkpoint(ours, narrow, **kw)
    jax_export.save_torch_checkpoint(theirs, variables, **kw)
    got, want = (torch.load(p, map_location="cpu", weights_only=True) for p in (ours, theirs))
    state = {"full": "model_state", "legacy": "model_state_dict", "bare": None}[layout]
    if state:
        assert {k: v for k, v in got.items() if k != state} == \
            {k: v for k, v in want.items() if k != state}
        got, want = got[state], want[state]
    _assert_same_state({k: v.numpy() for k, v in got.items()},
                       {k: v.numpy() for k, v in want.items()})
    back = torch_import.import_torch_checkpoint(ours, num_classes=len(TOKENS),
                                                hidden_size=HIDDEN)
    flat_back, flat_want = _flat(back["variables"]), _flat(variables)
    expected = {k: v for k, v in flat_want.items() if k[1] != "ctc_proj"}
    assert sorted(flat_back) == sorted(expected)
    for key, value in expected.items():
        np.testing.assert_array_equal(flat_back[key], value, err_msg="/".join(key))
    if layout == "full":
        assert back["itos"] == list(cs.itos) and back["config"]["hidden_size"] == HIDDEN


def test_clis_write_the_same_checkpoint(full_width, tmp_path, monkeypatch, capsys):
    model, ckpt = full_width
    variables = to_jax_variables(model)
    _assert_same_state(torch_export.export_torch_state_dict(model),
                       jax_export.export_torch_state_dict(variables))
    charset = tmp_path / "cs.txt"
    charset.write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    ours, theirs = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    args = ["--ckpt", ckpt, "--charset", str(charset), "--img-h", "32", "--img-w", "128"]
    assert export_torch.main([*args, "--out", ours]) == 0
    out_ours = capsys.readouterr().out
    spec = importlib.util.spec_from_file_location("jax_export_torch",
                                                  os.path.join(REPO, "tools", "export_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["export_torch.py", *args, "--out", theirs])
    assert tool.main() == 0
    out_theirs = capsys.readouterr().out
    assert out_ours.replace(ours, "OUT") == out_theirs.replace(theirs, "OUT")
    got, want = (torch.load(p, map_location="cpu", weights_only=True) for p in (ours, theirs))
    assert {k: v for k, v in got.items() if k != "model_state"} == \
        {k: v for k, v in want.items() if k != "model_state"}
    _assert_same_state({k: v.numpy() for k, v in got["model_state"].items()},
                       {k: v.numpy() for k, v in want["model_state"].items()})
    narrow_ckpt = tmp_path / "narrow.msgpack"
    narrow_ckpt.write_bytes(serialization.msgpack_serialize(to_jax_variables(_model(0.25))))
    with pytest.raises(SystemExit, match="width_mult=0.25 has no reference counterpart"):
        export_torch.main(["--ckpt", str(narrow_ckpt), "--charset", str(charset),
                           "--out", str(tmp_path / "x.pth")])
