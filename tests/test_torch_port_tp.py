"""Tensor parallelism of the port (the mesh's ``model`` axis), on the CPU over gloo.

Ranks run through ``python -m torch.distributed.run --standalone``
subprocesses (each with its own timeout; every collective inside has one
too), three launches started side by side, and are held to one process and
to JAX:

* Reports: the port's ``param_shardings`` / ``tp_report`` /
  ``tp_fallback_report`` equal JAX's on the same trees, and on the port
  model's own JAX paths: a toy model (width 0.0625, hidden 32, 16 tokens)
  and the production one (width 1.0, hidden 256, 194 tokens) on
  ``(4, 2)``, the latter with 29 sharded leaves and no fallback; ``(1, 8)``
  at 194 tokens, where the vocabulary heads fall back; a custom rule on the
  data axis.
* The step (``tests/torch_port_tp_worker.py``): 1 x 2 and 2 x 2 ranks
  against one process on the same 8-row batch (head "both", encoder and
  attention dropout, DropBlock, device augmentation, ``grad_clip``), at the
  data-parallel test's tolerances (``test_torch_port_parallel.py``): loss
  rtol 2e-5; gradients gathered whole rtol 1e-3 / atol 1e-3 x the leaf's
  max; parameters after Adam atol 2e-4 where the gradient is at least 1e-7
  (below, ``2 * lr``); statistics rtol 1e-4 / atol 1e-6; the clip factor
  within 1e-6.  Each rank draws its data index's rows of the one-process
  masks, the same as its data row's other model rank.
* The 2 x 2 step against JAX's ``make_train_step`` on
  ``make_mesh((4, 2), ("data", "model"))``, the state placed by
  ``param_shardings`` as ``rcnn_ocr_tpu/training/train.py:278-290`` places
  it (weights through ``interop/jax_params.py``; dropout off: the JAX model
  is a subclass whose ``forward_both`` runs the decoder without its
  α-dropout, which the packages draw differently; the gradient is read from
  Adam's first moment, ``0.1 * g``), at
  ``test_two_rank_step_matches_jax_mesh_step``'s tolerances.
* The model axis's autograd Functions forward and backward on known values
  over two ranks (an M-fold gradient fails them).
* The loop: a 1 x 2 ``python -m rcnn_ocr_tpu_torch.training.train --device
  cpu`` with ``grad_accum 2`` and ``ema_decay`` against one process's
  ``run_training`` (epoch 1 within 1e-5, epoch 2 within 1e-3, rank 0's files
  only), its checkpoint the whole JAX tree, which resumes in one process;
  and 1 x 2 ranks resuming one process's checkpoint.
"""

import json
import os
import shutil
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcnn_ocr_tpu.models import RCNN as JaxRCNN
from rcnn_ocr_tpu.parallel import mesh as jax_mesh
from rcnn_ocr_tpu.training.optim import build_optimizer as jax_build_optimizer
from rcnn_ocr_tpu.training.train_step import create_train_state as jax_create_train_state
from rcnn_ocr_tpu.training.train_step import make_train_step as jax_make_train_step
from rcnn_ocr_tpu_torch.interop.jax_params import (
    jax_param_shapes,
    load_jax_variables,
    to_jax_variables,
)
from rcnn_ocr_tpu_torch.models.rcnn import RCNN
from rcnn_ocr_tpu_torch.parallel import mesh
from rcnn_ocr_tpu_torch.training import checkpoint as ckpt_io
from rcnn_ocr_tpu_torch.training.config import Config
from rcnn_ocr_tpu_torch.training.train import run_training
from rcnn_ocr_tpu_torch.vocab.charset import Charset

import torch_port_dp_worker as dp
import torch_port_tp_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
CS = Charset.from_tokens(dp.TOKENS)


# --- reports ----------------------------------------------------------------------

def _jax_tree(classes, hidden, width):
    """A JAX model's params tree, shapes only, and the port model's JAX paths."""
    model = JaxRCNN(num_classes=classes, hidden_size=hidden, width_mult=width,
                    with_ctc_head=True)
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                           jnp.zeros((2, 32, 64, 3)), text=jnp.zeros((2, 5), jnp.int32),
                           batch_max_length=4, method=model.init_all))["params"]
    port = jax_param_shapes(RCNN(num_classes=classes, hidden_size=hidden, width_mult=width,
                                 with_ctc_head=True))
    return shapes, port


def _shapes(tree):
    return {path: tuple(leaf.shape) for path, leaf in mesh._iter_paths(tree)}


def _reports(params, shape, rules=None, axes=("data", "model")):
    jm = jax_mesh.make_mesh(shape, axes)
    pm = mesh.make_mesh(shape, axes, devices=range(8))
    want = (jax_mesh.tp_report(jax_mesh.param_shardings(params, jm, rules)),
            jax_mesh.tp_fallback_report(params, jm, rules))
    got = (mesh.tp_report(mesh.param_shardings(params, pm, rules)),
           mesh.tp_fallback_report(params, pm, rules))
    return got, want


@pytest.mark.parametrize("name,classes,hidden,width,sharded", [
    ("toy", 16, 32, 0.0625, 29), ("production", 194, 256, 1.0, 29)])
def test_tp_reports_match_jax_on_four_by_two(name, classes, hidden, width, sharded):
    jax_params, port_params = _jax_tree(classes, hidden, width)
    assert _shapes(port_params) == _shapes(jax_params)
    for params in (jax_params, port_params):
        (report, fallback), (want_report, want_fallback) = _reports(params, (4, 2))
        assert report == want_report
        assert fallback == want_fallback == {}
        assert len(report) == sharded
    assert report["cnn/layer3_block0/conv1/conv/kernel"] == "PartitionSpec(None, None, None, 'model')"
    assert report["enc_rnn1/proj/kernel"] == "PartitionSpec('model', None)"
    assert report["attn/b_gen"] == "PartitionSpec('model',)"
    # no model axis, or one of 1: all replicated, as in JAX
    for shape, axes in (((8,), ("data",)), ((8, 1), ("data", "model"))):
        (report, fallback), want = _reports(port_params, shape, axes=axes)
        assert (report, fallback) == want == ({}, {})


def test_tp_fallbacks_at_eight_model_ranks_match_jax():
    """194 tokens do not divide by 8: the vocabulary heads replicate."""
    jax_params, port_params = _jax_tree(194, 256, 1.0)
    for params in (jax_params, port_params):
        (report, fallback), (want_report, want_fallback) = _reports(params, (1, 8))
        assert report == want_report and fallback == want_fallback
        assert sorted(fallback) == ["attn/b_gen", "attn/w_gen", "ctc_proj/bias",
                                    "ctc_proj/kernel"]
        assert "attn/w_emb" in report and len(report) == 25


def test_custom_rule_on_another_axis_matches_jax():
    """A rule may name any axis; divisibility is checked against it."""
    jax_params, port_params = _jax_tree(194, 256, 1.0)
    rules_port = ((r"ctc_proj/kernel$", mesh.P("data", None)),
                  (r"attn/w_gen$", mesh.P(None, "data")),
                  (r"enc_rnn0/w_hh$", mesh.P(None, None, "model")))
    rules_jax = tuple((pat, jax_mesh.P(*spec)) for pat, spec in rules_port)
    jm = jax_mesh.make_mesh((4, 2), ("data", "model"))
    pm = mesh.make_mesh((4, 2), ("data", "model"), devices=range(8))
    for params in (jax_params, port_params):
        want = jax_mesh.tp_report(jax_mesh.param_shardings(params, jm, rules_jax))
        got = mesh.tp_report(mesh.param_shardings(params, pm, rules_port))
        assert got == want == {"ctc_proj/kernel": "PartitionSpec('data', None)",
                               "enc_rnn0/w_hh": "PartitionSpec(None, None, 'model')"}
        assert (mesh.tp_fallback_report(params, pm, rules_port)
                == jax_mesh.tp_fallback_report(params, jm, rules_jax))
        assert list(mesh.tp_fallback_report(params, pm, rules_port)) == ["attn/w_gen"]


# --- the launches -------------------------------------------------------------------

def _start(args, nproc, stem):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out, err = open(stem + ".out", "w"), open(stem + ".err", "w")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node", str(nproc), *args],
                            stdout=out, stderr=err, env=env, text=True)
    return proc, stem


def _finish(started, timeout):
    proc, stem = started
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(stem + ".out") as f, open(stem + ".err") as g:
        text = f.read()[-3000:] + g.read()[-5000:]
    assert proc.returncode == 0, text


class _NoAttnDropout(JaxRCNN):
    """JAX's model with the attention decoder run without its α-dropout in
    ``forward_both`` (the packages draw it differently)."""

    def forward_both(self, x, text=None, train=True, batch_max_length=25):
        enc = self.encode(x, train=train)
        return (self.attn(enc, text=text, train=False, batch_max_length=batch_max_length),
                self.ctc_proj(enc).astype(jnp.float32))


def _jax_model():
    return _NoAttnDropout(num_classes=len(dp.TOKENS), hidden_size=worker.JAX_HIDDEN,
                          width_mult=worker.JAX_WIDTH, with_ctc_head=True, enc_dropout_p=0.0,
                          sos_id=CS.sos_id, eos_id=CS.eos_id, pad_id=CS.pad_id,
                          blank_id=CS.blank_id, ctc_blank_id=CS.ctc_blank_id,
                          dtype=jnp.float32)


def _jax_init():
    model = _jax_model()
    rng = jax.random.PRNGKey(0)
    variables = model.init({"params": rng, "dropout": rng}, jnp.zeros((8, 32, 32, 3)),
                           text=jnp.zeros((8, worker.JAX_STEPS + 1), jnp.int32),
                           batch_max_length=worker.JAX_STEPS, method=model.init_all)
    return jax.tree_util.tree_map(np.asarray, variables)


def _jax_tp_step(variables):
    """JAX's ``make_train_step`` on the (4, 2) mesh, placed as train.py places it."""
    model = _jax_model()
    tx = jax_build_optimizer("Adam", LR)
    state = jax_create_train_state(model, variables, tx)
    m = jax_mesh.make_mesh((4, 2), ("data", "model"))
    rep = jax_mesh.replicated_sharding(m)
    p_shard = jax_mesh.param_shardings(state.params, m)
    assert len(jax_mesh.tp_report(p_shard)) == 29
    state = state.replace(
        step=jax.device_put(state.step, rep),
        params=jax.tree_util.tree_map(jax.device_put, state.params, p_shard),
        batch_stats=jax.device_put(state.batch_stats, rep),
        opt_state=jax.device_put(state.opt_state, rep))
    step = jax_make_train_step(model, tx, worker.JAX_STEPS, CS.pad_id, head="both",
                               ctc_blank_id=CS.ctc_blank_id, donate=False)
    batch = jax.device_put(worker.jax_tp_batch(), jax_mesh.batch_sharding(m))
    with m:
        new, metrics = step(state, batch, jax.random.PRNGKey(0))
    opt = flax.serialization.to_state_dict(new.opt_state)
    mu = opt["inner_state"]["0"]["mu"]
    return dict(loss=float(metrics["loss"]), params=jax.tree_util.tree_map(np.asarray, new.params),
                stats=jax.tree_util.tree_map(np.asarray, new.batch_stats),
                grads=jax.tree_util.tree_map(lambda a: np.asarray(a) / 0.1, mu))


def _loop_config(work, exp_dir, **kw):
    cfg = {"exp_dir": exp_dir, "train_csvs": [os.path.join(work, "data", "labels.csv")],
           "train_roots": [os.path.join(work, "data")],
           "charset_path": os.path.join(work, "charset.txt"), "img_h": 32, "img_w": 64,
           "max_len": 6, "hidden_size": 16, "width_mult": 0.125, "lstm_layers": 1,
           "batch_size": 8, "epochs": 2, "val_size": 8, "eval_every": 1, "seed": 0,
           "compute_dtype": "float32", "num_workers": 0, "progress": False,
           "device_augment": True, "grad_accum": 2, "ema_decay": 0.9, "grad_clip": 1.0,
           "head": "both"}
    cfg.update(kw)
    return cfg


def _resume_config(work, name, ckpt, epochs=3, **kw):
    """A fresh experiment dir holding a copy of ``ckpt`` (no config.json:
    the run's own keys hold), resumed to ``epochs``."""
    exp = os.path.join(work, name)
    os.makedirs(exp)
    shutil.copy(ckpt, os.path.join(exp, "last_ckpt.msgpack"))
    return _loop_config(work, exp, epochs=epochs,
                        resume_path=os.path.join(exp, "last_ckpt.msgpack"), **kw)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Launches A (1 x 2: step, units, a resume of one process's checkpoint),
    B (2 x 2: step and the JAX comparison) and C (the 1 x 2 CLI loop), side
    by side, and what they are held to."""
    from helpers import make_synthetic_dataset, tiny_labels

    tmp = tmp_path_factory.mktemp("tp")
    work = str(tmp)
    with open(os.path.join(work, "charset.txt"), "w") as f:
        f.write("\n".join(dp.TOKENS) + "\n")
    make_synthetic_dataset(os.path.join(work, "data"), tiny_labels(24))
    outs = {k: tmp / k for k in ("a", "b")}
    for d in outs.values():
        d.mkdir()
    variables = _jax_init()
    model = worker.jax_tp_model()
    load_jax_variables(model, variables)
    state_path = str(tmp / "jax_setup_state.pt")
    torch.save(model.state_dict(), state_path)
    tp_dir, sp_dir = os.path.join(work, "exp_tp"), os.path.join(work, "exp_sp")
    cfg_path = os.path.join(work, "tp.json")
    with open(cfg_path, "w") as f:
        json.dump(_loop_config(work, tp_dir, mesh_shape=[1, 2], mesh_axes=["data", "model"]), f)
    worker_py = os.path.join(REPO, "tests", "torch_port_tp_worker.py")
    b = _start([worker_py, str(outs["b"]), "2", "2", "--jax", state_path], 4, str(tmp / "b"))
    c = _start(["-m", "rcnn_ocr_tpu_torch.training.train", cfg_path, "--device", "cpu",
                "--dist-timeout", "120", "--result-json", os.path.join(work, "result.json")],
               2, str(tmp / "c"))
    one_loop = run_training(Config(_loop_config(work, sp_dir)), device="cpu")
    resume_path = os.path.join(work, "resume_tp.json")
    with open(resume_path, "w") as f:
        json.dump(_resume_config(work, "exp_tp_resume", os.path.join(sp_dir, "last_ckpt.msgpack"),
                                 mesh_shape=[1, 2], mesh_axes=["data", "model"]), f)
    a = _start([worker_py, str(outs["a"]), "1", "2", "--units", "--loop", resume_path], 2,
               str(tmp / "a"))
    jax_out = _jax_tp_step(variables)
    one = {"1x2": worker.tp_step_case()}
    one["2x2"] = one["1x2"]
    for started in (a, b, c):
        _finish(started, timeout=300)
    ranks = {"1x2": [dict(np.load(outs["a"] / f"rank{r}.npz")) for r in range(2)],
             "2x2": [dict(np.load(outs["b"] / f"rank{r}.npz")) for r in range(4)]}
    return dict(work=work, ranks=ranks, one=one, jax=jax_out, before=variables,
                one_loop=one_loop, tp_dir=tp_dir, sp_dir=sp_dir)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _rank(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


LAYOUTS = ["1x2", "2x2"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_step_loss_gradients_and_clip_match_one_process(tp, layout):
    one = tp["one"][layout]
    for out in tp["ranks"][layout]:
        got = _rank(out, "step_")
        for k in ("metric_loss", "metric_attn_loss", "metric_ctc_loss"):
            np.testing.assert_allclose(got[k], one[k], rtol=2e-5, err_msg=k)
        assert one["clip_factor"] < 1.0
        assert abs(float(got["clip_factor"]) - one["clip_factor"]) <= 1e-6
        for k in one:
            if k.startswith("grad_"):
                scale = float(np.abs(one[k]).max())
                np.testing.assert_allclose(got[k], one[k], rtol=1e-3, atol=1e-3 * scale,
                                           err_msg=k)
    # every rank steps with the same gradient, whole
    first = tp["ranks"][layout][0]
    for out in tp["ranks"][layout][1:]:
        for k in one:
            if k.startswith("grad_"):
                np.testing.assert_array_equal(out["step_" + k], first["step_" + k], err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_step_parameters_and_statistics_match_one_process(tp, layout):
    one = tp["one"][layout]
    checked = total = 0
    for out in tp["ranks"][layout]:
        got = _rank(out, "step_")
        for k in one:
            if k.startswith("param_"):
                diff = np.abs(got[k] - one[k])
                posed = np.abs(one["grad_" + k[len("param_"):]]) >= 1e-7
                assert diff[posed].max(initial=0.0) <= 2e-4, k
                assert diff.max() <= 2 * LR, k
                checked += int(posed.sum())
                total += posed.size
            elif k.startswith("stat_"):
                np.testing.assert_allclose(got[k], one[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert checked >= 0.99 * total, (checked, total)
    first = tp["ranks"][layout][0]
    for out in tp["ranks"][layout][1:]:  # the ranks hold one model
        for k in one:
            if k.startswith(("param_", "stat_")):
                np.testing.assert_array_equal(out["step_" + k], first["step_" + k], err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_ranks_draw_their_data_rows_masks(tp, layout):
    """Rank r draws rows of its data index of the one-process masks, equal
    to its data row's other model rank's, and data rows differ."""
    one = tp["one"][layout]
    masks = sorted(k for k in one if k.startswith("mask_"))
    assert len(masks) == 20  # encoder dropout, 7 alpha-dropouts, 11 DropBlocks, augmentation
    ranks = tp["ranks"][layout]
    n_data = 1 + max(int(out["data_index"]) for out in ranks)
    per = dp.GLOBAL_BATCH // n_data
    for k in masks:
        for out in ranks:
            d = int(out["data_index"])
            np.testing.assert_array_equal(out["step_" + k], one[k][d * per:(d + 1) * per],
                                          err_msg=k)
        by_row = {}
        for out in ranks:
            by_row.setdefault(int(out["data_index"]), []).append(out["step_" + k])
        for row in by_row.values():
            assert all(np.array_equal(m, row[0]) for m in row), k
        if n_data > 1:
            assert not np.array_equal(by_row[0][0], by_row[1][0]), k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_rank_holds_the_29_sharded_leaves_and_57_percent(tp, layout):
    ranks = tp["ranks"][layout]
    assert sorted((int(o["data_index"]), int(o["model_index"])) for o in ranks) == (
        [(0, 0), (0, 1)] if layout == "1x2" else [(0, 0), (0, 1), (1, 0), (1, 1)])
    model = RCNN(num_classes=len(dp.TOKENS), hidden_size=16, width_mult=0.125,
                 with_ctc_head=True)
    pm = mesh.make_mesh((int(layout[0]), 2), ("data", "model"), devices=range(len(ranks)))
    want = mesh.tp_report(mesh.param_shardings(jax_param_shapes(model), pm))
    assert len(want) == 29
    for out in ranks:
        assert json.loads(str(out["step_tp_report"])) == want
        share = int(out["step_n_local"]) / int(tp["one"][layout]["n_local"])
        assert 0.55 < share < 0.60, share


def test_tp_step_matches_jax_tp_step(tp):
    """2 x 2 ranks x 4 rows vs JAX's one program over (4, 2) devices."""
    j = tp["jax"]
    model = worker.jax_tp_model()
    for out in tp["ranks"]["2x2"]:
        got = _rank(out, "jax_")
        np.testing.assert_allclose(got["metric_loss"], j["loss"], rtol=1e-5)
        with torch.no_grad():
            for n, b in model.named_buffers():
                if "running" in n:
                    b.copy_(torch.from_numpy(got["stat_" + n]))
        trees = {}
        for prefix in ("param_", "grad_"):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(torch.from_numpy(got[prefix + n]))
            trees[prefix] = to_jax_variables(model)
        port, want = _flat(trees["grad_"]["params"]), _flat(j["grads"])
        assert set(port) == set(want)
        for k in want:
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(port[k], want[k], rtol=1e-3, atol=1e-3 * scale, err_msg=k)
        stats, want_stats = _flat(trees["param_"]["batch_stats"]), _flat(j["stats"])
        assert set(stats) == set(want_stats)
        for k in want_stats:
            np.testing.assert_allclose(stats[k], want_stats[k], rtol=1e-4, atol=2e-4, err_msg=k)
        port, want, before = (_flat(trees["param_"]["params"]), _flat(j["params"]),
                              _flat(tp["before"]["params"]))
        grads = _flat(j["grads"])
        checked = total = 0
        for k in want:
            posed = np.abs(grads[k]) > 1e-5
            np.testing.assert_allclose((port[k] - before[k])[posed], (want[k] - before[k])[posed],
                                       rtol=1e-3, atol=1e-3 * LR, err_msg=k)
            checked += int(posed.sum())
            total += posed.size
        assert checked >= 0.8 * total, (checked, total)


def test_model_axis_functions_backward_on_known_values(tp):
    """Two model ranks: gathers' backwards take the rank's slice (an
    all_gather whose backward reduce-scatters would double them), copies'
    sum the ranks', scatters' gather, reductions' pass through."""
    for out in tp["ranks"]["1x2"]:
        worker.assert_units(out, "unit_")




def _epoch_rows(exp_dir):
    import csv

    with open(os.path.join(exp_dir, "metrics_epoch.csv"), encoding="utf-8") as f:
        return list(csv.DictReader(f))


def test_tp_training_loop_matches_one_process(tp):
    work, tp_dir, sp_dir = tp["work"], tp["tp_dir"], tp["sp_dir"]
    tp_rows, sp_rows = _epoch_rows(tp_dir), _epoch_rows(sp_dir)
    assert len(tp_rows) == len(sp_rows) == 2
    for i, (a, b) in enumerate(zip(tp_rows, sp_rows)):
        tol = 1e-5 if i == 0 else 1e-3
        for k in ("train_loss", "val_loss"):
            assert abs(float(a[k]) - float(b[k])) < tol, (i, k, a[k], b[k])
        assert a["val_acc"] == b["val_acc"]
    results = []
    for r in range(2):
        with open(os.path.join(work, f"result.rank{r}.json")) as f:
            results.append(json.load(f))
    assert [res["rank"] for res in results] == [0, 1]
    for k in ("val_acc", "val_loss", "global_step", "tp_report"):
        assert results[0][k] == results[1][k], k
    assert len(results[0]["tp_report"]) == 25  # one LSTM layer: 16 convs, 4, 3 + 2 heads
    assert results[0]["global_step"] == tp["one_loop"]["global_step"]
    for e0, e1 in zip(results[0]["epochs"], results[1]["epochs"]):
        assert (e0["val_loss"], e0["val_acc"], e0["val_cer"]) == (
            e1["val_loss"], e1["val_acc"], e1["val_cer"])
        assert e0["tp_collective_s"] > 0 and e0["tp_collective_bytes"] > 0
    assert tp["one_loop"]["epochs"][0]["tp_collective_bytes"] == 0
    # the sharded state: ~57% of one process's parameters, gradients and moments
    one_bytes = tp["one_loop"]["state_bytes"]
    for res in results:
        for k in ("params", "grads", "optimizer"):
            assert 0.5 < res["state_bytes"][k] / one_bytes[k] < 0.65, (k, res["state_bytes"])
    # only rank 0 wrote: its slots, one events file, no temporaries, its log
    for slot in ("last", "best_loss", "best_acc"):
        assert os.path.exists(os.path.join(tp_dir, f"{slot}_ckpt.msgpack"))
    assert not [p for p in os.listdir(tp_dir) if p.endswith(".tmp")]
    events = [p for p in os.listdir(os.path.join(tp_dir, "logs")) if "tfevents" in p]
    assert len(events) <= 1
    log = open(os.path.join(tp_dir, "train.log"), encoding="utf-8").read()
    assert "rank 0;" in log and "rank 1;" not in log
    assert "TP-sharded params: 25 on model axis 2" in log


def _tree_shapes(tree):
    return {k: v.shape for k, v in _flat(tree).items()}


def test_tp_checkpoint_is_the_whole_tree_and_resumes_in_one_process(tp):
    work, tp_dir, sp_dir = tp["work"], tp["tp_dir"], tp["sp_dir"]
    for name in ("last_ckpt.msgpack", "last_weights.msgpack"):
        got = ckpt_io.load_checkpoint_blob(os.path.join(tp_dir, name))
        want = ckpt_io.load_checkpoint_blob(os.path.join(sp_dir, name))
        assert got.keys() == want.keys()
        for key in ("params", "batch_stats", "opt_state", "ema_params"):
            if key in want:
                assert _tree_shapes(got[key]) == _tree_shapes(want[key]), key
        # the same training: Adam moves an element at most lr a step, so
        # two runs from one start part by at most 2 * lr * steps
        bound = 2 * LR * tp["one_loop"]["global_step"]
        for k, v in _flat(want["params"]).items():
            np.testing.assert_allclose(_flat(got["params"])[k], v, rtol=0, atol=bound,
                                       err_msg=k)
    resumed = {}
    for who, exp in (("tp", tp_dir), ("sp", sp_dir)):
        cfg = _resume_config(work, f"one_resumes_{who}", os.path.join(exp, "last_ckpt.msgpack"))
        resumed[who] = run_training(Config(cfg), device="cpu")
        assert resumed[who]["start_epoch"] == 3 and len(resumed[who]["epochs"]) == 1
    # from states a loop's epochs apart: relative 1e-3, the smoke's DP bound
    a, b = resumed["tp"]["epochs"][0], resumed["sp"]["epochs"][0]
    for k in ("train_loss", "val_loss"):
        assert abs(a[k] - b[k]) <= 1e-3 * abs(b[k]), (k, a[k], b[k])
    tp["one_resumed_sp"] = resumed["sp"]


def test_tp_ranks_resume_one_process_checkpoint(tp):
    """Launch A's ranks resumed one process's 'last' slot to epoch 3; one
    process resuming it gives the same epoch."""
    work = tp["work"]
    one = tp.get("one_resumed_sp")
    if one is None:
        cfg = _resume_config(work, "one_resumes_sp_again",
                             os.path.join(tp["sp_dir"], "last_ckpt.msgpack"))
        one = run_training(Config(cfg), device="cpu")
    want = one["epochs"][0]
    for out in tp["ranks"]["1x2"]:
        epochs = json.loads(str(out["loop_epochs"]))
        assert len(epochs) == 1 and epochs[0]["epoch"] == 3
        for k in ("train_loss", "val_loss"):
            assert abs(epochs[0][k] - want[k]) <= 1e-3 * abs(want[k]), (k, epochs[0][k], want[k])
    rows = _epoch_rows(os.path.join(work, "exp_tp_resume"))
    assert [r["epoch"] for r in rows] == ["3"]
