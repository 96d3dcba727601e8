"""The port's training step vs the JAX package's, in fp32 on the CPU.

Small sizes (width 0.125, hidden 32, 32x64 lines, bs 4, max_len 6).  The
port's seeded weights (``init_params``: batch-norm scales and shifts off
identity) go to JAX through ``to_jax_variables``; batches come from
``numpy.random.default_rng`` through the port's ``collate_batch``.

* Kernel VJPs: ``se_scale`` / ``bilstm_scan`` gradients through the port's
  autograd Functions vs ``jax.vjp`` of the JAX package's (Pallas interpret
  forward, hand or scan backward) at rtol/atol 1e-5.
* Train step: the port's ``make_train_step(head="both")`` with dropout off
  vs a deterministic JAX composition of the same loss (``encode(train=True)``
  with ``enc_dropout_p=0``, the teacher-forced decoder, ``ctc_proj``;
  ``masked_token_ce`` + ``ctc_loss``, ``mutable=["batch_stats"]``) and JAX's
  Adam.  Tolerances: loss rtol 1e-5; every gradient leaf within rtol 1e-3 /
  atol 1e-3 x the leaf's max; batch-norm statistics rtol 1e-4 / atol 2e-4;
  Adam deltas rtol 1e-3 / atol 1e-3 x lr where the decayed gradient is
  above 1e-5 (Adam's first step is g / (|g| + 1e-8): at |g| = 1e-5 a
  gradient difference of 1e-8, the gradients' own tolerance, moves it by
  1e-3), which must be at least 95% of the elements.
* What cannot match bit for bit (dropout, DropBlock, sampling) is tested
  for its semantics; ``grad_accum`` and EMA against their definitions.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rcnn_ocr_tpu.data.loader import collate_batch as jax_collate_batch
from rcnn_ocr_tpu.models import RCNN as JaxRCNN
from rcnn_ocr_tpu.models.dropblock import dropblock_2d as jax_dropblock_2d
from rcnn_ocr_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from rcnn_ocr_tpu.ops.lstm_pallas import bilstm_scan as jax_bilstm_scan
from rcnn_ocr_tpu.ops.se_pallas import se_scale as jax_se_scale
from rcnn_ocr_tpu.training import checkpoint as jax_ckpt
from rcnn_ocr_tpu.training.optim import build_optimizer as jax_build_optimizer
from rcnn_ocr_tpu.training.train_step import masked_token_ce as jax_masked_token_ce
from rcnn_ocr_tpu.vocab.charset import Charset as JaxCharset
from rcnn_ocr_tpu_torch.data.loader import collate_batch
from rcnn_ocr_tpu_torch.interop.jax_params import load_jax_variables, to_jax_variables
from rcnn_ocr_tpu_torch.models.attention import AttentionDecoder
from rcnn_ocr_tpu_torch.models.dropblock import dropblock_2d, dropout
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_params
from rcnn_ocr_tpu_torch.ops.bilstm_scan import bilstm_scan
from rcnn_ocr_tpu_torch.ops.se_scale import se_scale
from rcnn_ocr_tpu_torch.training import checkpoint as ckpt
from rcnn_ocr_tpu_torch.training.optim import build_optimizer
from rcnn_ocr_tpu_torch.training.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from rcnn_ocr_tpu_torch.vocab.charset import Charset

TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
V, HIDDEN, WIDTH, IMG_H, IMG_W, BATCH, MAX_LEN = len(TOKENS), 32, 0.125, 32, 64, 4, 6
LR, WD = 1e-3, 2e-5
CS = Charset.from_tokens(TOKENS)
PAD, BLANK = CS.pad_id, CS.ctc_blank_id
VJP_TOL = dict(rtol=1e-5, atol=1e-5)


# --- kernels' VJPs -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 4, 6, 32), (2, 2, 3, 64), (2, 2, 4, 256), (2, 1, 2, 512)])
def test_se_scale_vjp_matches_jax(shape):
    rng = np.random.default_rng(0)
    c = shape[-1]
    s = c // 16
    x = rng.normal(size=shape).astype(np.float32)
    w1 = (rng.normal(size=(c, s)) / np.sqrt(c)).astype(np.float32)
    w2 = (rng.normal(size=(s, c)) / np.sqrt(s)).astype(np.float32)
    dout = rng.normal(size=shape).astype(np.float32)
    out_j, vjp = jax.vjp(jax_se_scale, jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    want = vjp(jnp.asarray(dout))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, w1, w2)]
    out = se_scale(*ins)
    got = torch.autograd.grad(out, ins, torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **VJP_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **VJP_TOL)


@pytest.mark.parametrize("t,b,h", [(5, 3, 8), (8, 4, 32)])
def test_bilstm_scan_vjp_matches_jax(t, b, h):
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(t, 2, b, 4 * h)).astype(np.float32)
    w_hh = (rng.normal(size=(2, h, 4 * h)) * 0.2).astype(np.float32)
    dys = rng.normal(size=(t, 2, b, h)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, w: jax_bilstm_scan(a, w, h), jnp.asarray(xs), jnp.asarray(w_hh))
    want = vjp(jnp.asarray(dys))
    ins = [torch.from_numpy(a).requires_grad_() for a in (xs, w_hh)]
    got = torch.autograd.grad(bilstm_scan(*ins, h), ins, torch.from_numpy(dys))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **VJP_TOL)


def test_kernel_backwards_give_bf16_weight_grads():
    """Rounded bf16 weights (as the layers pass them) get bf16 gradients,
    which flow on to the fp32 parameters through the cast."""
    g = torch.Generator().manual_seed(0)
    w_hh = torch.randn(2, 4, 16, generator=g).requires_grad_()
    w_bf16 = w_hh.to(torch.bfloat16)
    w_bf16.retain_grad()
    bilstm_scan(torch.randn(3, 2, 2, 16, generator=g), w_bf16, 4).square().sum().backward()
    assert w_bf16.grad.dtype == torch.bfloat16
    assert w_hh.grad.dtype == torch.float32 and w_hh.grad.abs().sum() > 0
    w1 = torch.randn(32, 2, generator=g).requires_grad_()
    w2 = torch.randn(2, 32, generator=g).requires_grad_()
    x = torch.randn(4, 3, 3, 32, generator=g).to(torch.bfloat16)
    se_scale(x, w1.to(torch.bfloat16), w2.to(torch.bfloat16)).float().square().sum().backward()
    assert w1.grad.dtype == torch.float32 and w1.grad.abs().sum() > 0
    assert w2.grad.abs().sum() > 0


# --- batches -----------------------------------------------------------------

def _items(seed, n, labels=None):
    rng = np.random.default_rng(seed)
    if labels is None:
        labels = ["".join(rng.choice(list("abcdefghij"), size=int(rng.integers(2, 6))))
                  for _ in range(n)]
    imgs = [rng.uniform(-1, 1, size=(IMG_H, IMG_W, 3)).astype(np.float32) for _ in range(n)]
    return list(zip(imgs, labels))


def test_collate_batch_matches_jax():
    items = _items(2, 3, labels=["ab c", "jjj", "abcdefghij"])
    got = collate_batch(items, CS, MAX_LEN, batch_size=5, with_ctc=True)
    want = jax_collate_batch(items, JaxCharset.from_tokens(TOKENS), MAX_LEN, batch_size=5,
                             with_ctc=True)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


# cases: all rows real and CTC-feasible; label smoothing 0.1 with a row whose
# label cannot be aligned in 8 frames (6 + 5 repeats) and a padded row
CASES = {
    "plain": dict(label_smoothing=0.0, items=_items(3, BATCH), batch_size=None),
    "smoothed_infeasible_padded": dict(label_smoothing=0.1,
                                       items=_items(4, 3, labels=["abc", "aaaaaa", "ji"]),
                                       batch_size=BATCH),
}


def _port_model():
    model = RCNN(num_classes=V, hidden_size=HIDDEN, width_mult=WIDTH, with_ctc_head=True,
                 enc_dropout_p=0.0, sos_id=CS.sos_id, eos_id=CS.eos_id, pad_id=PAD)
    init_params(model, torch.Generator().manual_seed(0))
    model.attn.dropout_p = 0.0
    return model


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _grads_tree(model):
    grads = {n: p.grad for n, p in model.named_parameters()}
    g = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in g.named_parameters():
            p.copy_(grads[n])
    return to_jax_variables(g)["params"]


_JAX_MODEL = JaxRCNN(num_classes=V, hidden_size=HIDDEN, width_mult=WIDTH, with_ctc_head=True,
                     enc_dropout_p=0.0, sos_id=CS.sos_id, eos_id=CS.eos_id, pad_id=PAD,
                     dtype=jnp.float32)


def _jax_train_outputs(model, x, text_in):
    enc = model.encode(x, train=True)
    logits = model.attn(enc, text=text_in, train=False, batch_max_length=MAX_LEN)
    return logits, model.ctc_proj(enc).astype(jnp.float32)


@jax.jit
def _jax_eval_outputs(variables, x, text_in):
    return _JAX_MODEL.apply(variables, x, text=text_in, batch_max_length=MAX_LEN, with_ctc=True,
                            method=_JAX_MODEL.eval_outputs)


def _jax_step(variables, batch, label_smoothing):
    jb = {k: jnp.asarray(batch[k]) for k in ("image", "text_in", "target_y", "valid",
                                               "ctc_labels", "ctc_paddings")}

    def loss_fn(params, stats):
        (attn, ctc), mut = _JAX_MODEL.apply(
            {"params": params, "batch_stats": stats}, jb["image"], jb["text_in"],
            method=_jax_train_outputs, mutable=["batch_stats"])
        la = jax_masked_token_ce(attn, jb["target_y"], PAD, jb["valid"],
                                 label_smoothing=label_smoothing)
        lc = jax_ctc_loss(ctc, jnp.zeros(ctc.shape[:2]), jb["ctc_labels"], jb["ctc_paddings"],
                          BLANK, valid=jb["valid"])
        return la + lc, (la, lc, mut["batch_stats"])

    @jax.jit
    def step(params, stats):
        (total, (la, lc, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats)
        tx = jax_build_optimizer("Adam", LR, weight_decay=WD)
        updates, _ = tx.update(grads, tx.init(params), params)
        return total, la, lc, new_stats, grads, optax.apply_updates(params, updates)

    out = step(variables["params"], variables["batch_stats"])
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=sorted(CASES))
def stepped(request):
    case = CASES[request.param]
    batch = collate_batch(case["items"], CS, MAX_LEN, batch_size=case["batch_size"],
                          with_ctc=True)
    model = _port_model()
    before = to_jax_variables(model)
    total, la, lc, stats, grads, new_params = _jax_step(before, batch, case["label_smoothing"])
    tx = build_optimizer("Adam", LR, weight_decay=WD)
    state = create_train_state(model, tx, device="cpu")
    step = make_train_step(model, tx, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK,
                           label_smoothing=case["label_smoothing"])
    metrics = step(state, batch, torch.Generator().manual_seed(0))
    after = to_jax_variables(model)
    return dict(case=request.param, batch=batch, model=model, state=state, metrics=metrics,
                before=before, after=after, port_grads=_grads_tree(model),
                jax=dict(total=total, attn=la, ctc=lc, stats=stats, grads=grads,
                         params=new_params))


def test_train_step_loss_matches_jax(stepped):
    m, j = stepped["metrics"], stepped["jax"]
    np.testing.assert_allclose(float(m["loss"]), j["total"], rtol=1e-5)
    np.testing.assert_allclose(float(m["attn_loss"]), j["attn"], rtol=1e-5)
    np.testing.assert_allclose(float(m["ctc_loss"]), j["ctc"], rtol=1e-5)
    assert np.isfinite(float(m["loss"]))
    assert stepped["state"].step == 1


def test_train_step_gradients_match_jax(stepped):
    got, want = _flat(stepped["port_grads"]), _flat(stepped["jax"]["grads"])
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(got[k]).all(), k
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3 * scale, err_msg=k)
    # every backbone weight gets a gradient (through both kernels' Functions)
    assert all(np.abs(got[k]).max() > 0 for k in got if k.startswith(("cnn/", "enc_rnn")))


def test_train_step_batch_stats_match_jax(stepped):
    got = _flat(stepped["after"]["batch_stats"])
    want = _flat(stepped["jax"]["stats"])
    old = _flat(stepped["before"]["batch_stats"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=2e-4, err_msg=k)
        assert not np.array_equal(got[k], old[k]), k


def test_adam_step_deltas_match_jax(stepped):
    before = _flat(stepped["before"]["params"])
    got, want = _flat(stepped["after"]["params"]), _flat(stepped["jax"]["params"])
    grads = _flat(stepped["jax"]["grads"])
    checked = total = 0
    for k in want:
        well_posed = np.abs(grads[k] + WD * before[k]) > 1e-5
        d_got, d_want = (got[k] - before[k])[well_posed], (want[k] - before[k])[well_posed]
        np.testing.assert_allclose(d_got, d_want, rtol=1e-3, atol=1e-3 * LR, err_msg=k)
        checked += int(well_posed.sum())
        total += well_posed.size
    assert checked >= 0.95 * total, (checked, total)


def test_port_weights_load_in_jax_and_evaluate_alike(stepped, tmp_path):
    """Port ``save_weights`` -> JAX ``load_variables``: the same arrays, and the
    same eval logits; the port's eval step agrees with JAX's losses."""
    path = str(tmp_path / "port_weights.msgpack")
    ckpt.save_weights(path, stepped["state"])
    variables, blob = jax_ckpt.load_variables(path)
    assert blob["format_version"] == 1 and set(blob) == {"format_version", "params",
                                                         "batch_stats"}
    got, want = _flat(variables), _flat(stepped["after"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    batch = stepped["batch"]
    outs = jax.tree_util.tree_map(np.asarray, _jax_eval_outputs(
        variables, jnp.asarray(batch["image"]), jnp.asarray(batch["text_in"])))
    model = stepped["model"]
    with torch.no_grad():
        port = model.eval_outputs(torch.from_numpy(batch["image"]),
                                  text=torch.from_numpy(batch["text_in"]),
                                  batch_max_length=MAX_LEN, with_ctc=True)
    for k in outs:
        np.testing.assert_allclose(port[k].numpy(), outs[k], rtol=1e-3, atol=5e-4, err_msg=k)

    ev = make_eval_step(model, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK)(
        stepped["state"], batch)
    valid = jnp.asarray(batch["valid"])
    want_val = jax_masked_token_ce(outs["tf_logits"], batch["target_y"], PAD, valid)
    want_ctc = jax_ctc_loss(outs["ctc_logits"], jnp.zeros(outs["ctc_logits"].shape[:2]),
                            batch["ctc_labels"], batch["ctc_paddings"], BLANK, valid=valid)
    np.testing.assert_allclose(float(ev["val_loss"]), float(want_val), rtol=1e-4)
    np.testing.assert_allclose(float(ev["ctc_val_loss"]), float(want_ctc), rtol=1e-4)
    np.testing.assert_array_equal(ev["pred_ids"].numpy(), outs["greedy_logits"].argmax(-1))
    np.testing.assert_array_equal(ev["ctc_frame_ids"].numpy(), outs["ctc_logits"].argmax(-1))


def test_jax_weights_with_trained_stats_load_in_port(stepped, tmp_path):
    """JAX ``save_weights`` of a state whose batch statistics came out of a
    train-mode step -> the port's reader and ``load_jax_variables``."""
    j = stepped["jax"]
    state = types.SimpleNamespace(params=j["params"], batch_stats=j["stats"], ema_params=None)
    path = str(tmp_path / "jax_weights.msgpack")
    jax_ckpt.save_weights(path, state)
    variables, _ = ckpt.load_variables(path)
    model = load_jax_variables(_port_model(), variables)
    got = _flat(to_jax_variables(model))
    want = _flat({"params": j["params"], "batch_stats": j["stats"]})
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- semantics that cannot match bit for bit -------------------------------

def _batch(seed=5, n=BATCH):
    return collate_batch(_items(seed, n), CS, MAX_LEN, with_ctc=True)


def test_dropout_keep_rate_scaling_and_fresh_masks():
    x = torch.ones(64, 256)
    g = torch.Generator().manual_seed(0)
    a, b = dropout(x, 0.25, g), dropout(x, 0.25, g)
    kept = (a != 0).float().mean().item()
    sd = (0.75 * 0.25 / x.numel()) ** 0.5
    assert abs(kept - 0.75) < 5 * sd
    assert set(torch.unique(a).tolist()) == {0.0, (x[0, 0] / 0.75).item()}
    assert not torch.equal(a, b)  # a fresh mask per call
    assert torch.equal(a, dropout(x, 0.25, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.25, None)


def test_dropblock_matches_jax_in_distribution():
    """All-ones NHWC input: dropped share like JAX's for the same p and
    block size, and every (sample, channel) rescaled to mean 1."""
    shape, p, bs = (8, 16, 16, 32), 0.2, 3
    got = dropblock_2d(torch.ones(shape), p, bs, True, torch.Generator().manual_seed(0))
    want = np.asarray(jax_dropblock_2d(jax.random.PRNGKey(0), jnp.ones(shape), p, bs, True))
    drop_got, drop_want = (got == 0).float().mean().item(), float((want == 0).mean())
    assert abs(drop_got - drop_want) < 0.02, (drop_got, drop_want)
    np.testing.assert_allclose(got.mean(dim=(1, 2)).numpy(), 1.0, rtol=1e-5)
    # zeros come in whole blocks: a dropped pixel has a dropped bs x bs
    # square around or beside it (the eroded zero mask is not empty)
    zero = (got == 0).permute(0, 3, 1, 2).float()
    eroded = -torch.nn.functional.max_pool2d(-zero, bs, stride=1)
    assert eroded.sum() > 0
    assert torch.equal(dropblock_2d(torch.ones(shape), p, bs, False, None), torch.ones(shape))


def test_attention_sampling_feeds_the_blank_masked_argmax():
    """sampling_prob=1: every fed-back token is the step's blank-masked
    argmax, so the train logits equal the greedy decode's."""
    v, c, h, steps, blank = 9, 12, 16, 5, 3
    dec = AttentionDecoder(v, c, h, blank_id=blank, dropout_p=0.0, sampling_prob=1.0)
    init_params(dec, torch.Generator().manual_seed(1))
    bh = torch.randn(2, 6, c, generator=torch.Generator().manual_seed(2))
    text = torch.randint(0, v, (2, steps + 1), generator=torch.Generator().manual_seed(3))
    text[:, 0] = dec.sos_id
    with torch.no_grad():
        train = dec(bh, text=text, batch_max_length=steps, train=True,
                    generator=torch.Generator().manual_seed(4))
        greedy = dec(bh, batch_max_length=steps)
        dec.sampling_prob = 1e-12  # the coin never picks the model: teacher-forced
        teacher = dec(bh, text=text, batch_max_length=steps, train=True,
                      generator=torch.Generator().manual_seed(4))
        forced = dec(bh, text=text, batch_max_length=steps)
    torch.testing.assert_close(train, greedy, rtol=1e-5, atol=1e-5)
    assert (train.argmax(-1) != blank).all()
    torch.testing.assert_close(teacher, forced, rtol=0, atol=0)


def test_train_step_is_seeded_by_its_generator():
    """Every regularizer on: the same generator seed gives the same step,
    another seed another one."""
    batch = _batch()

    def run(seed):
        model = RCNN(num_classes=V, hidden_size=HIDDEN, width_mult=WIDTH, with_ctc_head=True,
                     dropblock_p=0.2, dropblock_block_size=3, sampling_prob=0.5)
        init_params(model, torch.Generator().manual_seed(0))
        tx = build_optimizer("Adam", LR)
        state = create_train_state(model, tx, device="cpu")
        metrics = make_train_step(model, tx, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK)(
            state, batch, torch.Generator().manual_seed(seed))
        return float(metrics["loss"]), to_jax_variables(model)

    (la, va), (lb, vb), (lc, _) = run(7), run(7), run(8)
    assert la == lb and lc != la
    for k, a in _flat(va).items():
        np.testing.assert_array_equal(a, _flat(vb)[k], err_msg=k)


def test_grad_accum_is_the_mean_of_microbatch_gradients():
    """grad_accum=2 with dropout off: the update's gradient is the mean of
    the two microbatches' and the running statistics advance twice."""
    full = _batch(6, 2 * BATCH)
    micro = [{k: v[i * BATCH:(i + 1) * BATCH] for k, v in full.items() if k != "labels"}
             for i in range(2)]
    stacked = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    sgd0 = build_optimizer("SGD", 0.0, momentum=0.0)

    acc = _port_model()
    state = create_train_state(acc, sgd0, device="cpu")
    metrics = make_train_step(acc, sgd0, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK,
                              grad_accum=2)(state, stacked, None)
    one = _port_model()
    state1 = create_train_state(one, sgd0, device="cpu")
    step1 = make_train_step(one, sgd0, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK)
    grads, losses = [], []
    for m in micro:
        losses.append(float(step1(state1, m, None)["loss"]))
        grads.append(_flat(_grads_tree(one)))
    got = _flat(_grads_tree(acc))
    for k, g in got.items():
        want = (grads[0][k] + grads[1][k]) / 2
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)
    np.testing.assert_allclose(float(metrics["loss"]), np.mean(losses), rtol=1e-6)
    s_acc, s_one = _flat(to_jax_variables(acc)["batch_stats"]), _flat(
        to_jax_variables(one)["batch_stats"])
    for k in s_one:
        np.testing.assert_allclose(s_acc[k], s_one[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_ema_advances_as_specified():
    model = _port_model()
    tx = build_optimizer("Adam", LR)
    state = create_train_state(model, tx, ema=True, device="cpu")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, tx, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK,
                           ema_decay=0.9)
    step(state, _batch(), None)
    for n, p in model.named_parameters():
        torch.testing.assert_close(state.ema_params[n], 0.9 * start[n] + 0.1 * p.detach(),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="ema=True"):
        step(create_train_state(model, tx, device="cpu"), _batch(), None)


def test_save_weights_writes_the_ema_parameters(tmp_path):
    model = _port_model()
    state = create_train_state(model, build_optimizer("Adam", LR), ema=True, device="cpu")
    for t in state.ema_params.values():
        t.add_(1.0)
    path = str(tmp_path / "w.msgpack")
    ckpt.save_weights(path, state)
    variables, _ = ckpt.load_variables(path)
    loaded = load_jax_variables(_port_model(), variables)
    own = dict(model.named_parameters())
    for n, p in loaded.named_parameters():
        torch.testing.assert_close(p, own[n] + 1.0, rtol=0, atol=0)


def test_train_state_is_on_the_card_unless_the_cpu_is_asked_for():
    """``create_train_state`` moves the model to the card by default (and
    raises without one); the steps refuse a model moved off the state's
    device."""
    model, tx = _port_model(), build_optimizer("Adam", LR)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_train_state(model, tx)
    state = create_train_state(model, tx, device="cpu")
    assert state.device == torch.device("cpu")
    step = make_train_step(model, tx, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK)
    evaluate = make_eval_step(model, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK)
    model.to("meta")
    with pytest.raises(ValueError, match="its train state on cpu"):
        step(state, _batch(), None)
    with pytest.raises(ValueError, match="its train state on cpu"):
        evaluate(state, _batch())


def test_make_train_step_refuses_device_augment():
    with pytest.raises(NotImplementedError):
        make_train_step(_port_model(), build_optimizer("Adam", LR), MAX_LEN, PAD,
                        augment={"p": 1})
