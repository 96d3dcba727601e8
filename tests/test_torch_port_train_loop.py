"""The port's full checkpoints and training loop vs the JAX package's, on the CPU.

Small sizes (width 0.125, hidden 32, 32x64 lines, max_len 6), fp32.

* Cross-resume, the mapping (exact): a JAX train state (``create_train_state``
  over the port's seeded weights, then one JAX train step, or one update of
  JAX's optimizer from random gradients) written by
  JAX's ``save_checkpoint`` restores in the port (``restore_train_state``)
  to tensors equal to JAX's arrays: parameters, batch statistics, Adam
  ``mu``/``nu`` as ``exp_avg``/``exp_avg_sq`` (SGD's trace as
  ``momentum_buffer``), the counts, the learning rate and the EMA; the
  port's ``save_checkpoint`` of it gives back JAX's tree, key for key.  The
  reverse: a port state after one step, written by the port, restores
  through JAX's ``load_checkpoint_blob`` + ``restore_train_state`` to the
  same arrays.  Adam with weight decay, clipping and an EMA; plain Adam;
  AdamW; SGD with momentum.
* Cross-resume, the next step: ``head="ctc"`` with dropout off (JAX's
  attention decoder always draws α-dropout in training), a checkpoint
  written by one side, both sides restore it and take the next step on the
  same batch (Adam at lr 1e-4, where the gradients are well conditioned):
  loss rtol 1e-5, gradients rtol 1e-3 / atol 1e-3 x the leaf's max, batch
  statistics rtol 1e-4 / atol 2e-4, and the port's update equal to JAX's
  optimizer applied to the port's gradients from the restored moments
  (deltas rtol 1e-4 / atol two ulps of the leaf's largest parameter); both
  directions.
* ``run_training(device="cpu")`` on a tiny dataset written by cv2:
  artifacts, resume counters, SIGTERM, ``eval_callback``, an EMA run, width
  buckets (K and a list) with ``head="both"``, device augmentation, the
  refusals (no card, keys of later slices), the ``profile_steps`` window's
  encoder and decoder spans.
* Trajectory: JAX's ``run_training`` writes epoch 1; each package resumes its
  own copy for epoch 2 (``head="ctc"``, no dropout, augmentation
  probabilities 0, lines already 32 high so the resize is the identity):
  the epoch-2 rows of ``metrics_epoch.csv`` agree within rtol 1e-4.
"""

import csv
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from rcnn_ocr_tpu.models import RCNN as JaxRCNN
from rcnn_ocr_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from rcnn_ocr_tpu.training import checkpoint as jax_ckpt
from rcnn_ocr_tpu.training import train_step as jax_step
from rcnn_ocr_tpu.training.config import Config as JaxConfig
from rcnn_ocr_tpu.training.optim import build_optimizer as jax_build_optimizer
from rcnn_ocr_tpu.training.train import run_training as jax_run_training
from rcnn_ocr_tpu_torch.data.loader import collate_batch
from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_params
from rcnn_ocr_tpu_torch.training import checkpoint as ckpt
from rcnn_ocr_tpu_torch.training.config import Config
from rcnn_ocr_tpu_torch.training.optim import build_optimizer
from rcnn_ocr_tpu_torch.training.train import run_training
from rcnn_ocr_tpu_torch.training.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from rcnn_ocr_tpu_torch.utils.profiling import StepTimer
from rcnn_ocr_tpu_torch.vocab.charset import Charset
from tests.helpers import render_text_image

TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
V, HIDDEN, WIDTH, IMG_H, IMG_W, BATCH, MAX_LEN = len(TOKENS), 32, 0.125, 32, 64, 4, 6
LR = 1e-3
CS = Charset.from_tokens(TOKENS)
PAD, BLANK = CS.pad_id, CS.ctc_blank_id


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_model(head="both", seed=0):
    model = RCNN(num_classes=V, hidden_size=HIDDEN, width_mult=WIDTH, enc_dropout_p=0.0,
                 with_attention_head=head != "ctc", with_ctc_head=head != "attention",
                 sos_id=CS.sos_id, eos_id=CS.eos_id, pad_id=PAD)
    init_params(model, torch.Generator().manual_seed(seed))
    if model.attn is not None:
        model.attn.dropout_p = 0.0
    return model


def _jax_model(head="both"):
    return JaxRCNN(num_classes=V, hidden_size=HIDDEN, width_mult=WIDTH, enc_dropout_p=0.0,
                   with_attention_head=head != "ctc", with_ctc_head=head != "attention",
                   sos_id=CS.sos_id, eos_id=CS.eos_id, pad_id=PAD, dtype=jnp.float32)


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    labels = ["".join(rng.choice(list("abcdefghij"), size=int(rng.integers(2, 6))))
              for _ in range(n)]
    imgs = [rng.uniform(-1, 1, size=(IMG_H, IMG_W, 3)).astype(np.float32) for _ in range(n)]
    return collate_batch(list(zip(imgs, labels)), CS, MAX_LEN, with_ctc=True)


def test_msgpack_writer_is_byte_equal_to_flax():
    """The port's writer encodes a checkpoint-like tree (keys sorted, as
    flax's trees leave them) byte for byte as ``flax.serialization`` does."""
    rng = np.random.default_rng(0)
    tree = {"a": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                  "step": np.asarray(7, np.int32), "lr": np.float32(5e-4)},
            "b": [1, -3, 300, 2**40, 1.5, "text", None, True, b"raw"],
            "c": {"empty": {}, "u8": np.arange(600, dtype=np.uint8)},
            "d": float("inf")}
    assert ckpt.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    assert ckpt.msgpack_serialize(tree) == serialization.msgpack_serialize(
        ckpt.msgpack_restore(ckpt.msgpack_serialize(tree)))


# --- cross-resume: the mapping --------------------------------------------------------

OPTIMIZERS = {
    "adam_decay_clip_ema": dict(name="Adam", weight_decay=2e-5, grad_clip=1.0, ema=True),
    "adam": dict(name="Adam", weight_decay=0.0, grad_clip=0.0, ema=False),
    "adamw_clip": dict(name="AdamW", weight_decay=1e-2, grad_clip=0.5, ema=False),
    "sgd_momentum_decay": dict(name="SGD", weight_decay=1e-4, grad_clip=0.0, ema=True),
}


def _specs(case):
    kw = dict(weight_decay=case["weight_decay"], momentum=0.9, grad_clip=case["grad_clip"])
    return (jax_build_optimizer(case["name"], LR, **kw), build_optimizer(case["name"], LR, **kw))


def _jax_state_after_a_step(case, variables):
    """JAX's ``create_train_state`` and one step: a real ``make_train_step``
    step of the model (``head="both"``) for Adam with decay, clipping and an
    EMA; one update of the optimizer from random gradients for the others
    (the state's layout does not depend on where the gradients came from)."""
    jtx, _ = _specs(case)
    state = jax_step.create_train_state(_jax_model(), variables, jtx, ema=case["ema"])
    if case["name"] == "Adam" and case["ema"]:
        step = jax_step.make_train_step(_jax_model(), jtx, MAX_LEN, PAD, head="both",
                                        ctc_blank_id=BLANK, ema_decay=0.9, donate=False)
        batch = {k: jnp.asarray(v) for k, v in _batch(1).items() if isinstance(v, np.ndarray)
                 and k != "lengths"}
        return step(state, batch, jax.random.PRNGKey(0))[0]
    rng = np.random.default_rng(1)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
                                   state.params)
    updates, opt_state = jtx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    ema = None
    if case["ema"]:
        ema = jax.tree_util.tree_map(lambda e, p: 0.9 * e + 0.1 * p, state.ema_params, params)
    stats = jax.tree_util.tree_map(lambda s: s + 0.25, state.batch_stats)
    return state.replace(step=state.step + 1, params=params, batch_stats=stats,
                         opt_state=opt_state, ema_params=ema)


SNAPSHOT = {"img_h": IMG_H, "img_w": IMG_W, "val_csvs": [None, "v.csv"], "lr": LR}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_jax_checkpoint_restores_in_the_port_key_for_key(case, tmp_path):
    case = OPTIMIZERS[case]
    jstate = _jax_state_after_a_step(case, to_jax_variables(_port_model()))
    path = str(tmp_path / "jax_ckpt.msgpack")
    jax_ckpt.save_checkpoint(path, jstate, {"epoch": 1, "lr": LR}, 1, 1, 0.5, 0.25,
                             list(CS.itos), CS.stoi, SNAPSHOT, "logs")
    _, tx = _specs(case)
    state = create_train_state(_port_model(seed=3), tx, ema=case["ema"], device="cpu")
    blob = ckpt.load_checkpoint_blob(path)
    ckpt.restore_train_state(blob, state)

    want_opt = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.opt_state))
    _assert_same_tree(to_jax_variables(state.model), {"params": jstate.params,
                                                      "batch_stats": jstate.batch_stats})
    _assert_same_tree(ckpt.optimizer_state_tree(state), want_opt)
    assert state.step == 1
    assert np.float32(state.optimizer.param_groups[0]["lr"]) == np.float32(LR)
    # the torch optimizer holds JAX's moments, in the port's layout
    conv = "cnn.stem0.conv.weight"
    p = dict(state.model.named_parameters())[conv]
    inner = want_opt["inner_state"]
    if case["name"] == "SGD":
        trace = inner["1"]["trace"]["cnn"]["stem0"]["conv"]["kernel"]
        np.testing.assert_array_equal(state.optimizer.state[p]["momentum_buffer"].numpy(),
                                      trace.transpose(3, 2, 0, 1))
    else:
        adam = inner[str(len(inner) - 2)] if case["name"] == "Adam" else inner["1"]["0"]
        mu = adam["mu"]["cnn"]["stem0"]["conv"]["kernel"]
        np.testing.assert_array_equal(state.optimizer.state[p]["exp_avg"].numpy(),
                                      mu.transpose(3, 2, 0, 1))
        assert float(state.optimizer.state[p]["step"]) == float(adam["count"]) == 1
    if case["ema"]:
        _assert_same_tree(to_jax_variables(state.model, state.ema_params)["params"],
                          jstate.ema_params)

    out = str(tmp_path / "port_ckpt.msgpack")
    ckpt.save_checkpoint(out, state, {"epoch": 1, "lr": LR}, 1, 1, 0.5, 0.25, list(CS.itos),
                         CS.stoi, SNAPSHOT, "logs")
    again = jax_ckpt.load_checkpoint_blob(out)
    assert set(again) == set(jax_ckpt.load_checkpoint_blob(path))
    _assert_same_tree(again["opt_state"], want_opt)
    for key in ("params", "batch_stats") + (("ema_params",) if case["ema"] else ()):
        _assert_same_tree(again[key], jax_ckpt.load_checkpoint_blob(path)[key])
    for key in ("epoch", "global_step", "best_val_loss", "best_val_acc", "itos", "stoi",
                "config", "log_dir", "scheduler_state", "format_version"):
        assert again[key] == blob[key], key


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_port_checkpoint_restores_in_jax_key_for_key(case, tmp_path):
    case = OPTIMIZERS[case]
    jtx, tx = _specs(case)
    model = _port_model()
    state = create_train_state(model, tx, ema=case["ema"], device="cpu")
    make_train_step(model, tx, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK,
                    ema_decay=0.9 if case["ema"] else 0.0)(state, _batch(2), None)
    path = str(tmp_path / "port_ckpt.msgpack")
    ckpt.save_checkpoint(path, state, {"epoch": 2, "lr": LR}, 2, 1, 0.5, 0.25, list(CS.itos),
                         CS.stoi, SNAPSHOT, "logs")
    blob = jax_ckpt.load_checkpoint_blob(path)
    template = jax_step.create_train_state(_jax_model(), to_jax_variables(_port_model(seed=5)),
                                           jtx, ema=case["ema"])
    restored = jax_ckpt.restore_train_state(blob, template)
    assert int(restored.step) == 1
    _assert_same_tree({"params": restored.params, "batch_stats": restored.batch_stats},
                      to_jax_variables(model))
    _assert_same_tree(serialization.to_state_dict(restored.opt_state),
                      ckpt.optimizer_state_tree(state))
    if case["ema"]:
        _assert_same_tree(restored.ema_params, to_jax_variables(model, state.ema_params)["params"])
    assert float(restored.opt_state.hyperparams["learning_rate"]) == np.float32(LR)


# --- cross-resume: the next step (CTC head, no dropout) --------------------------------

# lr 1e-4: after one Adam step at lr 1e-3 from these weights the gradients
# are ill-conditioned (JAX's own move by up to 8% of a leaf's max when the
# images move by 1e-6, and the port's differ from JAX's about as much); at
# 1e-4 the same control moves them by 2e-5 and the port agrees within 5e-5
NEXT_LR = 1e-4
_CTC_MODEL = _jax_model("ctc")
_CTC_TX = jax_build_optimizer("Adam", NEXT_LR, weight_decay=2e-5)


@jax.jit
def _jax_ctc_step(params, stats, opt_state, image, labels, paddings, valid):
    def loss_fn(p):
        logits, mut = _CTC_MODEL.apply({"params": p, "batch_stats": stats}, image, train=True,
                                       mutable=["batch_stats"], method=_CTC_MODEL.ctc_logits)
        loss = jax_ctc_loss(logits, jnp.zeros(logits.shape[:2]), labels, paddings, BLANK,
                            valid=valid)
        return loss, mut["batch_stats"]

    (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, new_opt = _CTC_TX.update(grads, opt_state, params)
    return loss, grads, new_stats, optax.apply_updates(params, updates), new_opt


def _jax_next(state, batch):
    out = _jax_ctc_step(state.params, state.batch_stats, state.opt_state,
                        *(jnp.asarray(batch[k]) for k in ("image", "ctc_labels", "ctc_paddings",
                                                          "valid")))
    loss, grads, stats, params, opt = jax.tree_util.tree_map(np.asarray, out)
    return dict(loss=float(loss), grads=grads, stats=stats, params=params,
                state=state.replace(step=state.step + 1, params=params, batch_stats=stats,
                                    opt_state=opt))


def _port_next(state, batch):
    model = state.model
    metrics = make_train_step(model, state.tx, MAX_LEN, PAD, head="ctc", ctc_blank_id=BLANK)(
        state, batch, None)
    grads = {n: p.grad for n, p in model.named_parameters()}
    g = _port_model("ctc", seed=9)
    with torch.no_grad():
        for n, p in g.named_parameters():
            p.copy_(grads[n])
    after = to_jax_variables(model)
    return dict(loss=float(metrics["loss"]), grads=to_jax_variables(g)["params"],
                stats=after["batch_stats"], params=after["params"])


def _assert_steps_agree(port, jx, before, opt_state):
    np.testing.assert_allclose(port["loss"], jx["loss"], rtol=1e-5)
    got, want = _flat(port["grads"]), _flat(jx["grads"])
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3 * scale, err_msg=k)
    got, want = _flat(port["stats"]), _flat(jx["stats"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=2e-4, err_msg=k)
    # the update: JAX's optimizer, from the restored moments, applied to the
    # port's gradients gives the port's new parameters (Adam's second delta
    # divides by the new first moment, so comparing it with JAX's own step
    # would measure the gradients' conditioning, held above, twice)
    updates, _ = _CTC_TX.update(port["grads"], opt_state, before)
    want = _flat(jax.tree_util.tree_map(np.asarray, optax.apply_updates(before, updates)))
    got, old = _flat(port["params"]), _flat(before)
    for k in want:
        ulp = float(np.spacing(np.abs(old[k]).max()))  # the parameters' own rounding
        np.testing.assert_allclose(got[k] - old[k], want[k] - old[k], rtol=1e-4, atol=2 * ulp,
                                   err_msg=k)
        assert np.abs(got[k] - old[k]).max() > 0, k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_next_step_from_a_checkpoint_agrees_across_packages(writer, tmp_path):
    tx = build_optimizer("Adam", NEXT_LR, weight_decay=2e-5)
    first, second = _batch(11), _batch(12)
    path = str(tmp_path / "ckpt.msgpack")
    args = ({}, 1, 1, 1.0, 0.0, list(CS.itos), CS.stoi, {}, "logs")
    if writer == "jax":
        jstate = jax_step.create_train_state(_CTC_MODEL, to_jax_variables(_port_model("ctc")),
                                             _CTC_TX)
        jax_ckpt.save_checkpoint(path, _jax_next(jstate, first)["state"], *args)
    else:
        state = create_train_state(_port_model("ctc"), tx, device="cpu")
        _port_next(state, first)
        ckpt.save_checkpoint(path, state, *args)
    template = jax_step.create_train_state(_CTC_MODEL, to_jax_variables(_port_model("ctc", 4)),
                                           _CTC_TX)
    jstate = jax_ckpt.restore_train_state(jax_ckpt.load_checkpoint_blob(path), template)
    state = create_train_state(_port_model("ctc", seed=6), tx, device="cpu")
    ckpt.restore_train_state(ckpt.load_checkpoint_blob(path), state)
    before = to_jax_variables(state.model)["params"]
    _assert_steps_agree(_port_next(state, second), _jax_next(jstate, second), before,
                        jstate.opt_state)


# --- run_training on the CPU ----------------------------------------------------------

def _write_lines(root, labels, seed=0, height=24, width=96):
    os.makedirs(root, exist_ok=True)
    import cv2

    rng = np.random.default_rng(seed)
    csv_path = os.path.join(root, "labels.csv")
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        wr = csv.writer(f)
        for i, label in enumerate(labels):
            w = width if isinstance(width, int) else int(rng.integers(*width))
            img = render_text_image(label, h=height, w=w, rng=rng)
            cv2.imwrite(os.path.join(root, f"img_{i:04d}.png"), img[:, :, ::-1])
            wr.writerow([f"img_{i:04d}.png", label])
    return csv_path


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    (tmp / "charset.txt").write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    rng = np.random.default_rng(0)
    labels = ["".join(rng.choice(list("abcdefghij"), size=int(rng.integers(1, 5))))
              for _ in range(32)]
    csv_path = _write_lines(str(tmp / "data"), labels, width=(40, 160))
    return {"tmp": tmp, "charset": str(tmp / "charset.txt"), "csv": csv_path,
            "root": str(tmp / "data")}


def _cfg(env, name, **overrides):
    cfg = {"train_csvs": [env["csv"]], "train_roots": [env["root"]],
           "charset_path": env["charset"], "img_h": IMG_H, "img_w": IMG_W, "max_len": MAX_LEN,
           "hidden_size": HIDDEN, "width_mult": WIDTH, "batch_size": 8, "epochs": 2, "lr": LR,
           "val_size": 8, "eval_every": 1, "seed": 0, "compute_dtype": "float32",
           "exp_dir": str(env["tmp"] / name), "num_workers": 2, "progress": False}
    cfg.update(overrides)
    return Config(cfg)


def _rows(exp_dir):
    with open(os.path.join(exp_dir, "metrics_epoch.csv"), encoding="utf-8") as f:
        return list(csv.DictReader(f))


def test_profile_steps_reports_the_windows_encoder_and_decoder_spans(tiny):
    result = run_training(_cfg(tiny, "profiled", epochs=1, head="both", profile_steps=2),
                          device="cpu")
    prof = result["profile"]
    assert prof["steps"] == 2 and prof["device_busy_s"] is None and prof["spans_dropped"] == 0
    # one encode and one decode range a step (forward_both), host time only on the CPU
    for name in ("rcnn.encode", "rcnn.decode"):
        assert prof["spans"][name]["count"] == 2, name
        assert 0.0 < prof["spans"][name]["host_s"] < prof["wall_s"]
        assert prof["spans"][name]["device_s"] is None
    assert os.path.exists(os.path.join(str(tiny["tmp"] / "profiled"), "profile",
                                       "profile_summary.txt"))


def test_run_training_writes_its_artifacts_and_resumes(tiny):
    exp_dir = str(tiny["tmp"] / "e2e")
    result = run_training(_cfg(tiny, "e2e", head="both"), device="cpu")
    assert np.isfinite(result["val_loss"]) and 0.0 <= result["val_acc"] <= 1.0
    assert result["global_step"] == 6 and len(result["epochs"]) == 2
    names = {"config.json", "train.log", "metrics_epoch.csv"} | {
        f"{s}{suffix}" for s in ("last", "best_loss", "best_acc")
        for suffix in ("_ckpt.msgpack", "_weights.msgpack")}
    assert names <= set(os.listdir(exp_dir))
    assert [r["epoch"] for r in _rows(exp_dir)] == ["1", "2"]
    blob = ckpt.load_checkpoint_blob(os.path.join(exp_dir, "last_ckpt.msgpack"))
    assert (blob["epoch"], blob["global_step"]) == (2, 6)
    assert set(blob) == {"format_version", "epoch", "global_step", "params", "batch_stats",
                         "opt_state", "scheduler_state", "best_val_loss", "best_val_acc",
                         "itos", "stoi", "config", "log_dir"}
    # the weights slot loads in the JAX package
    variables, _ = jax_ckpt.load_variables(os.path.join(exp_dir, "last_weights.msgpack"))
    _assert_same_tree(variables, {"params": blob["params"], "batch_stats": blob["batch_stats"]})

    resumed = run_training(Config({"resume_path": exp_dir, "epochs": 3, "progress": False}),
                           device="cpu")
    assert resumed["start_epoch"] == 3 and resumed["global_step"] == 9
    assert [r["epoch"] for r in _rows(exp_dir)] == ["1", "2", "3"]
    assert "Resumed from" in open(os.path.join(exp_dir, "train.log"), encoding="utf-8").read()


def test_sigterm_writes_last_and_returns_preempted(tiny, monkeypatch):
    exp_dir = str(tiny["tmp"] / "preempt")
    sentinel = lambda s, f: None  # noqa: E731
    prev = signal.signal(signal.SIGTERM, sentinel)
    calls = {"n": 0}
    orig_stop = StepTimer.stop

    def stop(self, n):
        calls["n"] += 1
        if calls["n"] == 4:  # the first step of epoch 2 (3 steps per epoch)
            os.kill(os.getpid(), signal.SIGTERM)
        return orig_stop(self, n)

    monkeypatch.setattr(StepTimer, "stop", stop)
    try:
        result = run_training(_cfg(tiny, "preempt", epochs=10, async_checkpoint=False),
                              device="cpu")
    finally:
        restored = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, prev)
    assert result.get("preempted") is True and restored is sentinel and calls["n"] == 4
    blob = ckpt.load_checkpoint_blob(os.path.join(exp_dir, "last_ckpt.msgpack"))
    assert (blob["epoch"], blob["global_step"]) == (1, 4)
    monkeypatch.setattr(StepTimer, "stop", orig_stop)
    again = run_training(Config({"resume_path": exp_dir, "epochs": 2, "progress": False}),
                         device="cpu")
    assert again.get("preempted") is None and again["global_step"] == 7


def test_eval_callback_prunes(tiny):
    seen = []
    result = run_training(_cfg(tiny, "pruned", epochs=3),
                          device="cpu", eval_callback=lambda e, m: seen.append((e, m)) or True)
    assert result["pruned"] and result["epochs_run"] == 1
    assert len(seen) == 1 and set(seen[0][1]) == {"val_acc", "val_loss", "val_cer", "val_wer"}


def test_ema_run_validates_and_saves_the_ema_weights(tiny):
    exp_dir = str(tiny["tmp"] / "ema")
    run_training(_cfg(tiny, "ema", epochs=1, ema_decay=0.9), device="cpu")
    blob = ckpt.load_checkpoint_blob(os.path.join(exp_dir, "last_ckpt.msgpack"))
    weights = ckpt.load_checkpoint_blob(os.path.join(exp_dir, "last_weights.msgpack"))
    _assert_same_tree(weights["params"], blob["ema_params"])
    assert any(not np.array_equal(a, _flat(blob["params"])[k])
               for k, a in _flat(blob["ema_params"]).items())


def test_eval_step_use_ema_swaps_the_weights_in_and_back():
    model = _port_model()
    tx = build_optimizer("Adam", LR)
    state = create_train_state(model, tx, ema=True, device="cpu")
    for t in state.ema_params.values():
        t.mul_(0.5)
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    batch = _batch(3)
    got = make_eval_step(model, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK, use_ema=True)(
        state, batch)
    assert {n: p.data_ptr() for n, p in model.named_parameters()} == ptrs
    ref = _port_model()
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(state.ema_params[n])
        for (n, b), (_, rb) in zip(model.named_buffers(), ref.named_buffers()):
            rb.copy_(b)
    want = make_eval_step(ref, MAX_LEN, PAD, head="both", ctc_blank_id=BLANK)(
        create_train_state(ref, tx, device="cpu"), batch)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="ema=True"):
        make_eval_step(model, MAX_LEN, PAD, use_ema=True)(create_train_state(model, tx,
                                                                            device="cpu"), batch)


@pytest.mark.parametrize("buckets", [3, [32, 48, 64]])
def test_width_buckets_with_both_heads(tiny, buckets):
    name = f"buckets_{buckets if isinstance(buckets, int) else 'list'}"
    result = run_training(_cfg(tiny, name, epochs=1, head="both", width_buckets=buckets),
                          device="cpu")
    assert np.isfinite(result["val_loss"])
    log = open(os.path.join(result["exp_dir"], "train.log"), encoding="utf-8").read()
    assert "Width buckets" in log
    if isinstance(buckets, int):
        assert "width_buckets=auto(k=3)" in log


def test_device_augment_and_the_refusals(tiny):
    result = run_training(_cfg(tiny, "devaug", epochs=1, device_augment=True,
                               p_ShiftScaleRotate=1.0, invert_p=0.5), device="cpu")
    assert np.isfinite(result["val_loss"])
    with pytest.raises(ValueError, match="p_EdgeCrop"):
        run_training(_cfg(tiny, "edge", device_augment=True, p_EdgeCrop=0.5), device="cpu")
    # a model axis of 2 does not tile the one process, and a data axis of 2
    # neither: each falls back to it with a warning, as in JAX
    with pytest.warns(UserWarning, match="falling back"):
        run_training(_cfg(tiny, "no_mesh_shape", epochs=1, mesh_shape=[1, 2],
                          mesh_axes=["data", "model"]), device="cpu")
    with pytest.warns(UserWarning, match="falling back"):
        run_training(_cfg(tiny, "mesh_fallback", epochs=1, mesh_shape=[2]), device="cpu")
    # a bad export block fails at the start (the export itself:
    # tests/test_torch_port_artifact.py)
    with pytest.raises(ValueError, match="unknown method"):
        run_training(_cfg(tiny, "no_export", export_artifact={"method": "telepathy"}),
                     device="cpu")
    other = tiny["tmp"] / "ref.ckpt"  # .pth warm starts: tests/test_torch_port_torch_import.py
    other.write_bytes(b"")
    with pytest.raises(ValueError, match="unsupported checkpoint format"):
        run_training(_cfg(tiny, "no_ckpt", resume_path=str(other)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_training(_cfg(tiny, "no_card"))


# --- the trajectory: JAX writes epoch 1, each package runs epoch 2 ----------------------

def test_epoch_two_from_a_jax_experiment_matches_jax(tiny):
    rng = np.random.default_rng(1)
    labels = ["".join(rng.choice(list("abcdefghij"), size=int(rng.integers(1, 5))))
              for _ in range(24)]
    root = str(tiny["tmp"] / "exact")
    csv_path = _write_lines(root, labels, seed=1, height=IMG_H, width=IMG_W)
    base = str(tiny["tmp"] / "traj")
    cfg = {"train_csvs": [csv_path], "train_roots": [root], "charset_path": tiny["charset"],
           "img_h": IMG_H, "img_w": IMG_W, "max_len": MAX_LEN, "hidden_size": HIDDEN,
           "width_mult": WIDTH, "batch_size": 8, "epochs": 1, "lr": LR, "val_size": 8,
           "seed": 0, "compute_dtype": "float32", "use_pallas": False, "head": "ctc",
           "enc_dropout_p": 0.0, "p_ShiftScaleRotate": 0.0, "p_BrightnessContrast": 0.0,
           "invert_p": 0.0, "num_workers": 2, "exp_dir": base, "progress": False,
           "scheduler": "CosineAnnealingLR"}
    jax_run_training(JaxConfig(cfg))
    copies = {}
    for who in ("jax", "port"):
        copies[who] = f"{base}_{who}"
        shutil.copytree(base, copies[who])
    jax_run_training(JaxConfig({"resume_path": copies["jax"], "epochs": 2}))
    run_training(Config({"resume_path": copies["port"], "epochs": 2}), device="cpu")
    want, got = _rows(copies["jax"]), _rows(copies["port"])
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == ["1", "2"]
    assert got[0] == want[0]  # epoch 1: the same file, copied
    for key in ("train_loss", "val_loss", "val_acc", "val_cer", "lr"):
        np.testing.assert_allclose(float(got[1][key]), float(want[1][key]), rtol=1e-4, err_msg=key)
