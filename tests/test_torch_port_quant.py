"""int8 inference in the port against the JAX package (fp32, CPU).

* the quantizers: codes equal, scales bit-equal;
* ``int8_conv_nhwc`` and ``int8_conv_nhwc_static`` on the same float input:
  outputs bit-equal, at stride 1 and 2, the out head's 2x2 shapes and a
  channel count that is not a multiple of 8;
* the cases of ``tests/test_quant.py`` and ``tests/test_quant_static.py``,
  run over both packages as parametrised cases (the int8 stem is refused by
  the port: ROADMAP item 13);
* the whole ``RCNN(quantize=True)`` (width 0.125, hidden 32), dynamic and
  static: CTC argmax ids and greedy strings equal JAX's on every row, the
  encoder states within ``ENC_ATOL`` (a code that flips at a rounding
  boundary between the packages moves a state by at most a few 1e-3);
* ``calibrate`` with a padded last chunk: ``quant_stats`` equal JAX's
  within ``STATS_RTOL`` (each is the max of a float activation, and the two
  packages' float convs sum in other orders: the worst leaf here reads
  2.4e-6, a 0.00245 abs-max ten blocks deep); ``save_calibration`` of ``.msgpack`` and ``.pth``
  sources reopens on the static path in both packages;
* ``load_jax_variables`` / ``to_jax_variables`` round-trip ``quant_stats``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference
from rcnn_ocr_tpu.models import RCNN as JaxRCNN
from rcnn_ocr_tpu.models.seresnet31 import SEResNet31 as JaxSEResNet31
from rcnn_ocr_tpu.ops import quant as jq
from rcnn_ocr_tpu.training import checkpoint as jax_ckpt
from rcnn_ocr_tpu_torch.inference import OCRInference
from rcnn_ocr_tpu_torch.interop.jax_params import (
    load_jax_variables,
    port_state_from_jax,
    to_jax_variables,
)
from rcnn_ocr_tpu_torch.models.rcnn import RCNN
from rcnn_ocr_tpu_torch.models.seresnet31 import SEResNet31, recording_act_absmax
from rcnn_ocr_tpu_torch.ops import quant as tq

TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
HIDDEN, WIDTH, IMG_H, IMG_W, MAX_LEN = 32, 0.125, 32, 64, 6
ENC_ATOL = 5e-3  # encoder states, int8 path (see the module docstring)
STATS_RTOL = 1e-5  # calibrated abs-max values (see the module docstring)
PACKAGES = ["jax", "torch"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- the ops, bit for bit ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (2, 2, 12, 20), (1, 1, 5, 3)])
def test_weight_quantizer_matches_jax(shape):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel: the scale floor
    wq, ws = jq.quantize_weight_per_cout(jnp.asarray(w))
    got_q, got_s = tq.quantize_weight_per_cout(_t(w))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ws))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_activation_quantizer_matches_jax(scale):
    x = (np.random.default_rng(2).normal(size=(2, 5, 7, 3)) * scale).astype(np.float32)
    xq, xs = jq.quantize_activation(jnp.asarray(x))
    got_q, got_s = tq.quantize_activation(_t(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(xs))


CONV_CASES = {  # kernel, cin, cout, strides, padding
    "3x3_s1": ((3, 3), 16, 24, (1, 1), ((1, 1), (1, 1))),
    "3x3_s2": ((3, 3), 16, 32, (2, 2), ((1, 1), (1, 1))),
    "out0_2x2_s21": ((2, 2), 16, 16, (2, 1), ((0, 0), (1, 1))),
    "out1_2x2_valid": ((2, 2), 16, 16, (1, 1), "VALID"),
    "cin12_cout20": ((3, 3), 12, 20, (2, 2), ((1, 1), (1, 1))),
    "1x1_cin5_cout3": ((1, 1), 5, 3, (1, 1), "VALID"),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_convs_are_bit_equal_to_jax(case):
    (kh, kw), cin, cout, strides, padding = CONV_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 12, cin)).astype(np.float32)
    w = (rng.normal(size=(kh, kw, cin, cout)) * 0.1).astype(np.float32)
    want = jq.int8_conv_nhwc(jnp.asarray(x), jnp.asarray(w), strides, padding)
    got = tq.int8_conv_nhwc(_t(x), _t(w), strides, padding)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a calibrated scale below the true range: codes clip
    scale = np.float32(np.abs(x).max() / 127.0 * 0.7)
    want_s = jq.int8_conv_nhwc_static(jnp.asarray(x), jnp.asarray(w), strides, padding,
                                      jnp.asarray(scale))
    got_s = tq.int8_conv_nhwc_static(_t(x), _t(w), strides, padding, torch.tensor(scale))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the accumulators: exact integers of the same codes
    xq, _ = tq.quantize_activation(_t(x))
    wq, _ = tq.quantize_weight_per_cout(_t(w))
    acc = tq.int8_conv_accumulate(xq, wq, strides, padding)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()), strides, padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref))


# --- tests/test_quant.py and tests/test_quant_static.py, over both packages -----------

def _quant_w(pkg, w):
    if pkg == "jax":
        q, s = jq.quantize_weight_per_cout(jnp.asarray(w))
        return np.asarray(q), np.asarray(s)
    q, s = tq.quantize_weight_per_cout(_t(w))
    return q.numpy(), s.numpy()


def _quant_x(pkg, x):
    if pkg == "jax":
        q, s = jq.quantize_activation(jnp.asarray(x))
        return np.asarray(q), float(s)
    q, s = tq.quantize_activation(_t(x))
    return q.numpy(), float(s)


def _conv(pkg, x, w, strides, padding, act_scale=None):
    if pkg == "jax":
        if act_scale is None:
            return np.asarray(jq.int8_conv_nhwc(jnp.asarray(x), jnp.asarray(w), strides, padding))
        return np.asarray(jq.int8_conv_nhwc_static(jnp.asarray(x), jnp.asarray(w), strides,
                                                   padding, jnp.asarray(act_scale, jnp.float32)))
    if act_scale is None:
        return tq.int8_conv_nhwc(_t(x), _t(w), strides, padding).numpy()
    return tq.int8_conv_nhwc_static(_t(x), _t(w), strides, padding,
                                    torch.tensor(act_scale, dtype=torch.float32)).numpy()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_weight_quant_roundtrip(pkg, rng):
    w = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    wq, s = _quant_w(pkg, w)
    assert wq.dtype == np.int8 and s.shape == (16,)
    back = wq.astype(np.float32) * s
    err = np.abs(back - w).max(axis=(0, 1, 2))
    assert (err <= s / 2 + 1e-6).all()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_activation_quant_symmetric(pkg, rng):
    x = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    xq, s = _quant_x(pkg, x)
    assert xq.dtype == np.int8 and int(np.abs(xq).max()) <= 127
    assert np.abs(xq.astype(np.float32) * s - x).max() <= s / 2 + 1e-6


@pytest.mark.parametrize("pkg", PACKAGES)
def test_int8_conv_close_to_float(pkg, rng):
    x = rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 32, 64)) * 0.1).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = _conv(pkg, x, w, (1, 1), ((1, 1), (1, 1)))
    assert np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-9) < 0.02


@pytest.mark.parametrize("pkg", PACKAGES)
def test_static_matches_dynamic_at_true_scale(pkg, rng):
    x = rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 32, 64)) * 0.1).astype(np.float32)
    scale = np.float32(np.abs(x).max() / 127.0)
    np.testing.assert_array_equal(_conv(pkg, x, w, (1, 1), ((1, 1), (1, 1))),
                                  _conv(pkg, x, w, (1, 1), ((1, 1), (1, 1)), scale))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_static_clips_out_of_range(pkg):
    x = np.zeros((1, 4, 4, 8), np.float32)
    x[0, 0, 0, 0] = 100.0
    w = np.zeros((1, 1, 8, 4), np.float32)
    w[0, 0, 0, 0] = 1.0
    out = _conv(pkg, x, w, (1, 1), "VALID", np.float32(1.0 / 127.0))
    assert float(out[0, 0, 0, 0]) == 1.0


def _jax_backbone_vars(x):
    return JaxSEResNet31(width_mult=0.25, dtype=jnp.float32, quantize=True).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)


def _port_backbone(v, **kw):
    """The port's backbone with JAX's backbone variables (RCNN-less tree)."""
    m = SEResNet31(width_mult=0.25, quantize=True, **kw).eval()
    holder = torch.nn.Module()
    holder.cnn = m
    wrapped = {col: {"cnn": tree} for col, tree in v.items()}
    if m.act_quant == "static":  # the scales start at zero, as calibration's do
        wrapped["quant_stats"] = to_jax_variables(holder)["quant_stats"]
    load_jax_variables(holder, jax.tree_util.tree_map(np.asarray, wrapped))
    return m


@pytest.mark.parametrize("pkg", PACKAGES)
def test_quantized_model_close_and_param_compatible(pkg, rng):
    common = dict(num_classes=10, hidden_size=16, width_mult=0.25, lstm_layers=1)
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    m = JaxRCNN(**common)
    v = m.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False,
               batch_max_length=4)
    if pkg == "jax":
        mq = JaxRCNN(**common, quantize=True)
        a = np.asarray(m.apply(v, jnp.asarray(x), train=False, method=m.encode))
        b = np.asarray(mq.apply(v, jnp.asarray(x), train=False, method=mq.encode))
    else:
        host = jax.tree_util.tree_map(np.asarray, v)
        tm = load_jax_variables(RCNN(**common).eval(), host)
        tmq = load_jax_variables(RCNN(**common, quantize=True).eval(), host)
        with torch.no_grad():
            a = tm.encode(_t(x)).numpy()
            b = tmq.encode(_t(x)).numpy()
    assert np.abs(a - b).mean() / (np.abs(a).mean() + 1e-9) < 0.2
    if pkg == "torch":  # training mode takes the float convs
        with torch.no_grad():
            tr = tmq.encode(_t(x), train=True, generator=torch.Generator().manual_seed(0))
            ft = tm.encode(_t(x), train=True, generator=torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(tr.numpy(), ft.numpy())


@pytest.mark.parametrize("pkg", PACKAGES)
def test_backbone_calibration_records_and_applies(pkg, rng):
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    v = _jax_backbone_vars(x)
    if pkg == "jax":
        dyn = JaxSEResNet31(width_mult=0.25, dtype=jnp.float32, quantize=True)
        sta = JaxSEResNet31(width_mult=0.25, dtype=jnp.float32, quantize=True,
                            act_quant="static")
        _, mutated = sta.apply(v, jnp.asarray(x), train=False, mutable=["quant_stats"])
        leaves = [float(a) for a in jax.tree_util.tree_leaves(mutated["quant_stats"])]
        got = np.asarray(sta.apply({**v, "quant_stats": mutated["quant_stats"]},
                                   jnp.asarray(x), train=False))
        want = np.asarray(dyn.apply(v, jnp.asarray(x), train=False))
    else:
        dyn = _port_backbone(v)
        sta = _port_backbone(v, act_quant="static")
        with torch.no_grad():
            with recording_act_absmax(sta):
                sta(_t(x))
            leaves = [float(b) for n, b in sta.named_buffers() if n.endswith("act_absmax")]
            got, want = sta(_t(x)).numpy(), dyn(_t(x)).numpy()
    assert len(leaves) == 24 and all(a > 0 for a in leaves)
    assert np.abs(got - want).mean() / (np.abs(want).mean() + 1e-9) < 0.05


@pytest.mark.parametrize("pkg", PACKAGES)
def test_quantize_stem_wiring(pkg, rng):
    """JAX quantizes the stem with quantize_stem; the port refuses it
    (ROADMAP item 13) and keeps its stem float."""
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    v = _jax_backbone_vars(x)
    if pkg == "jax":
        stem = JaxSEResNet31(width_mult=0.25, dtype=jnp.float32, quantize=True,
                             act_quant="static", quantize_stem=True)
        _, mut = stem.apply(v, jnp.asarray(x), train=False, mutable=["quant_stats"])
        assert {"stem0", "stem1"} <= set(mut["quant_stats"])
        return
    with pytest.raises(NotImplementedError, match="item 13"):
        SEResNet31(width_mult=0.25, quantize=True, quantize_stem=True)
    sta = _port_backbone(v, act_quant="static")
    assert not hasattr(sta.stem0.conv, "act_absmax") and not sta.stem0.quantize


# --- the whole model against JAX ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model_vars():
    model = JaxRCNN(num_classes=len(TOKENS), hidden_size=HIDDEN, width_mult=WIDTH,
                    with_ctc_head=True, dtype=jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(4)}, jnp.zeros((1, IMG_H, IMG_W, 3)),
                           text=jnp.zeros((1, MAX_LEN + 1), jnp.int32),
                           batch_max_length=MAX_LEN, method=model.init_all)
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.3, size=a.shape).astype(np.float32),
        variables["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": stats}


def _batch(n, seed):
    u8 = np.random.default_rng(seed).integers(0, 256, size=(n, IMG_H, IMG_W, 3), dtype=np.uint8)
    return (u8.astype(np.float32) / 127.5 - 1.0).astype(np.float32)


@pytest.mark.parametrize("act_quant", ["dynamic", "static"])
def test_quantized_rcnn_matches_jax(jax_model_vars, act_quant):
    kw = dict(num_classes=len(TOKENS), hidden_size=HIDDEN, width_mult=WIDTH, with_ctc_head=True)
    jv = dict(jax_model_vars)
    x = _batch(6, seed=7)
    if act_quant == "static":  # scales from a JAX calibration pass on other images
        cal = JaxRCNN(**kw, dtype=jnp.float32, quantize=True, act_quant="static")
        _, mut = cal.apply(jv, jnp.asarray(_batch(4, seed=8)), train=False, method=cal.encode,
                           mutable=["quant_stats"])
        jv["quant_stats"] = jax.tree_util.tree_map(np.asarray, mut["quant_stats"])
    jm = JaxRCNN(**kw, dtype=jnp.float32, quantize=True, act_quant=act_quant)
    tm = load_jax_variables(RCNN(**kw, quantize=True, act_quant=act_quant).eval(), jv)
    want_enc = np.asarray(jm.apply(jv, jnp.asarray(x), train=False, method=jm.encode))
    want_ctc = np.asarray(jm.apply(jv, jnp.asarray(x), train=False, method=jm.ctc_logits))
    want_att = np.asarray(jm.apply(jv, jnp.asarray(x), train=False, batch_max_length=MAX_LEN))
    with torch.no_grad():
        got_enc = tm.encode(_t(x)).numpy()
        got_ctc = tm.ctc_logits(_t(x)).numpy()
        got_att = tm(_t(x), batch_max_length=MAX_LEN).numpy()
    diff = np.abs(got_enc - want_enc)
    print(f"{act_quant}: encoder |diff| max {diff.max():.3e}, mean {diff.mean():.3e}")
    np.testing.assert_allclose(got_enc, want_enc, rtol=0, atol=ENC_ATOL)
    for name, got, want in (("ctc", got_ctc, want_ctc), ("attention", got_att, want_att)):
        rows = np.nonzero((got.argmax(-1) != want.argmax(-1)).any(axis=1))[0]
        if rows.size:
            top2 = np.sort(want, axis=-1)[..., -2:]
            print(f"{name}: rows {rows.tolist()} differ; their smallest top-2 logit gaps "
                  f"{[float((top2[r, :, 1] - top2[r, :, 0]).min()) for r in rows]}, "
                  f"encoder |diff| {[float(diff[r].max()) for r in rows]}")
        assert rows.size == 0, name


# --- the engine: calibration and its file ---------------------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, jax_model_vars):
    """The tiny model as a JAX full checkpoint, and a reference-layout .pth."""
    from tests.test_torch_port_torch_import import TOKENS as PTH_TOKENS
    from tests.test_torch_port_torch_import import _reference_variables, _write

    root = tmp_path_factory.mktemp("quant_ckpt")
    state = types.SimpleNamespace(params=jax_model_vars["params"],
                                  batch_stats=jax_model_vars["batch_stats"], opt_state={})
    full = str(root / "last_ckpt.msgpack")
    jax_ckpt.save_checkpoint(
        full, state, {}, epoch=1, global_step=3, best_val_loss=1.0, best_val_acc=0.5,
        itos=TOKENS, stoi={s: i for i, s in enumerate(TOKENS)},
        config={"img_h": IMG_H, "img_w": IMG_W, "hidden_size": HIDDEN}, log_dir="logs")
    pth = _write(root / "w_full.pth", _reference_variables(PTH_TOKENS, 16, 0.25, seed=3),
                 "full", PTH_TOKENS)
    return {"msgpack": full, "pth": pth, "root": root}


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(IMG_H, int(rng.integers(30, 90)), 3), dtype=np.uint8)
            for _ in range(n)]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _engine(pkg, path, **kw):
    if pkg == "jax":
        return JaxOCRInference(path, quantize=True, dtype=jnp.float32, verbose=False, **kw)
    return OCRInference(path, device="cpu", quantize=True, dtype=torch.float32, **kw)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_inference_calibrate_api(pkg, checkpoints, tmp_path):
    """tests/test_quant_static.py's engine case in each package: calibrate
    switches to the static path; the saved file reopens on it; an
    uncalibrated engine refuses to save."""
    imgs = _images(4, seed=9)
    ocr = _engine(pkg, checkpoints["msgpack"])
    before = ocr.predict(imgs, max_length=4, batch_size=4)
    ocr.calibrate(imgs, batch_size=4)
    assert ocr.model.act_quant == "static" and "quant_stats" in ocr.variables
    after = ocr.predict(imgs, max_length=4, batch_size=4)
    assert isinstance(after, list) and len(after) == 4
    assert before == after
    cal_path = str(tmp_path / "calibrated.msgpack")
    ocr.save_calibration(cal_path)
    ocr2 = _engine(pkg, cal_path)
    assert ocr2.model.act_quant == "static" and "quant_stats" in ocr2.variables
    assert ocr2.predict(imgs, max_length=4, batch_size=4) == after
    with pytest.raises(ValueError, match="calibrat"):
        _engine(pkg, checkpoints["msgpack"]).save_calibration(str(tmp_path / "x.msgpack"))


def test_calibrate_matches_jax_with_a_padded_chunk(checkpoints):
    """Six images at batch 4: the second chunk repeats its last image twice,
    and the repeats count in the max in both packages."""
    imgs = _images(6, seed=10)
    ours, theirs = _engine("torch", checkpoints["msgpack"]), _engine("jax", checkpoints["msgpack"])
    ours.calibrate(imgs, batch_size=4)
    theirs.calibrate(imgs, batch_size=4)
    got, want = _leaves(ours.variables["quant_stats"]), _leaves(theirs.variables["quant_stats"])
    assert sorted(got) == sorted(want) and len(got) == 24
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=STATS_RTOL, atol=0, err_msg=key)
    for pred in ("predict", "predict_ctc"):
        assert getattr(ours, pred)(imgs, batch_size=4) == getattr(theirs, pred)(imgs, batch_size=4)
    with pytest.raises(ValueError, match="at least one image"):
        ours.calibrate([])
    dyn = _engine("torch", checkpoints["msgpack"])
    assert dyn.predict_ctc(imgs, batch_size=4) == \
        _engine("jax", checkpoints["msgpack"]).predict_ctc(imgs, batch_size=4)


@pytest.mark.parametrize("source", ["msgpack", "pth"])
def test_save_calibration_reopens_static_in_both_packages(checkpoints, tmp_path, source):
    imgs = _images(5, seed=11)
    kw = {"img_h": IMG_H, "img_w": IMG_W}
    ocr = _engine("torch", checkpoints[source], **kw)
    ocr.calibrate(imgs, batch_size=4)
    want = ocr.predict(imgs, max_length=4, batch_size=4)
    path = str(tmp_path / f"cal_{source}.msgpack")
    ocr.save_calibration(path)
    blob = serialization.msgpack_restore(open(path, "rb").read())
    assert _leaves(blob["quant_stats"]).keys() == _leaves(ocr.variables["quant_stats"]).keys()
    if source == "pth":  # standalone: the charset and geometry ride along
        assert blob["itos"] == list(ocr.charset.itos)
        assert blob["config"] == {"img_h": IMG_H, "img_w": IMG_W, "hidden_size": 16}
    for pkg in PACKAGES:
        again = _engine(pkg, path, **kw)
        assert again.model.act_quant == "static", pkg
        assert again.predict(imgs, max_length=4, batch_size=4) == want, pkg


def test_quant_stats_round_trip(jax_model_vars):
    kw = dict(num_classes=len(TOKENS), hidden_size=HIDDEN, width_mult=WIDTH, with_ctc_head=True)
    cal = JaxRCNN(**kw, dtype=jnp.float32, quantize=True, act_quant="static")
    _, mut = cal.apply(jax_model_vars, jnp.asarray(_batch(2, seed=12)), train=False,
                       method=cal.encode, mutable=["quant_stats"])
    jv = dict(jax_model_vars, quant_stats=jax.tree_util.tree_map(np.asarray, mut["quant_stats"]))
    model = load_jax_variables(RCNN(**kw, quantize=True, act_quant="static").eval(), jv)
    back = to_jax_variables(model)
    assert _leaves(back).keys() == _leaves(jv).keys()
    for key, want in _leaves(jv).items():
        np.testing.assert_array_equal(_leaves(back)[key], want, err_msg=key)
    # the loader's model-free mapping names every tensor the model reads
    state = {k: v.numpy() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    flat = port_state_from_jax(jv)
    assert sorted(flat) == sorted(state)
    for key in state:
        np.testing.assert_array_equal(flat[key], state[key], err_msg=key)
    # a dynamic model has no act_absmax leaves to load them into
    with pytest.raises(KeyError, match="unexpected.*act_absmax"):
        load_jax_variables(RCNN(**kw, quantize=True).eval(), jv)
    with pytest.raises(KeyError, match="missing.*act_absmax"):
        load_jax_variables(RCNN(**kw, quantize=True, act_quant="static").eval(),
                           {k: v for k, v in jv.items() if k != "quant_stats"})
