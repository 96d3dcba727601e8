"""Data parallelism of the port across processes, on the CPU over gloo.

Two ranks run through ``python -m torch.distributed.run --standalone``
subprocesses (each with its own timeout; every collective inside has one
too) and are held to the same work in one process, and to JAX:

* The step (``tests/torch_port_dp_worker.py``): a 2-rank ``make_train_step``
  (head "both", encoder and attention dropout, DropBlock, device
  augmentation) against the 1-process step on the same 8-row batch: loss
  rtol 2e-5; gradients rtol 1e-3 / atol 1e-3 x the leaf's max (the port-vs-
  JAX tolerance of ``test_torch_port_train_step.py``; measured 5.6e-5 of
  the leaf max); parameters after Adam atol 2e-4 (JAX's
  ``tests/test_parallel.py:100-113``) wherever the gradient is at least
  1e-7.  Below that, Adam's first update ``lr * g / (|g| + 1e-8)`` turns the
  fp32 reduction-order noise of a summed gradient (~1e-8) into up to ``lr``,
  as JAX's test says of itself; those elements (0.08% here) are held to
  ``2 * lr`` and must stay under 1%.  Batch statistics rtol 1e-4 / atol 1e-6.
  Each rank's masks must equal its rows of the one-process masks, and not
  the other rank's (a draw from the step's seed alone gives both ranks the
  same masks).
* The step against JAX's 8-device mesh step (``test_parallel.py``'s
  ``test_dp_train_step_matches_single_device`` setup; weights through
  ``interop/jax_params.py``; dropout off, since the packages draw
  differently), at ``test_torch_port_train_step.py``'s tolerances: loss rtol
  1e-5, gradients rtol 1e-3 / atol 1e-3 x the leaf's max on every element,
  statistics rtol 1e-4 / atol 2e-4, and the Adam deltas rtol 1e-3 / atol
  1e-3 x lr where the gradient exceeds 1e-5.  This width-0.0625 model has
  86% of its elements there (the train-step file's wider one 95%), so at
  least 80% must be.
* The loop: a 2-rank ``python -m rcnn_ocr_tpu_torch.training.train --device
  cpu`` against the 1-process ``run_training``, as
  ``tools/multiprocess_train_probe.py`` holds JAX's: 24 lines, 2 epochs,
  epoch 1 within 1e-5 and epoch 2 within 1e-3, the same validation metrics on
  both ranks, and only rank 0's files; a SIGTERM sent to rank 1 alone stops
  both ranks after the same step, with rank 0's 'last' slot.
* Units: ``ProcessShardedBatchSampler`` against JAX's on the same global
  batches (carry included), the loader's global row seeds,
  ``global_metric_sum`` over 2 ranks, ``make_mesh``'s fallback warning and
  its ``model`` axis (tensor parallelism itself: ``test_torch_port_tp.py``).
"""

import csv
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rcnn_ocr_tpu.data.loader import BucketBatch as JaxBucketBatch
from rcnn_ocr_tpu.data.loader import ProcessShardedBatchSampler as JaxSharded
from rcnn_ocr_tpu.models import RCNN as JaxRCNN
from rcnn_ocr_tpu.parallel.mesh import batch_sharding, replicated_sharding
from rcnn_ocr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rcnn_ocr_tpu.training.optim import build_optimizer as jax_build_optimizer
from rcnn_ocr_tpu.training.train_step import masked_token_ce as jax_masked_token_ce
from rcnn_ocr_tpu_torch.data.loader import BucketBatch, DataLoader, ProcessShardedBatchSampler
from rcnn_ocr_tpu_torch.interop.jax_params import load_jax_variables, to_jax_variables
from rcnn_ocr_tpu_torch.parallel import mesh
from rcnn_ocr_tpu_torch.training.config import Config
from rcnn_ocr_tpu_torch.training.train import run_training
from rcnn_ocr_tpu_torch.vocab.charset import Charset

import torch_port_dp_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def launch(args, nproc=2, timeout=300, cwd=None):
    """``python -m torch.distributed.run --standalone`` with ``nproc`` ranks."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", str(nproc), *args],
                         capture_output=True, text=True, timeout=timeout, env=env, cwd=cwd)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


# --- the JAX package's 8-device mesh step ----------------------------------------

def _jax_mesh_step():
    """``test_dp_train_step_matches_single_device``'s model, batch and Adam,
    with the attention decoder run without dropout, on the 8-device mesh."""
    model = JaxRCNN(num_classes=worker.JAX_CLASSES, hidden_size=worker.JAX_HIDDEN,
                    width_mult=worker.JAX_WIDTH, enc_dropout_p=0.0, dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    variables = model.init({"params": rng, "dropout": rng}, jnp.zeros((8, 32, 32, 3)),
                           text=jnp.zeros((8, 4), jnp.int32),
                           batch_max_length=worker.JAX_STEPS, method=model.init_all)
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def outputs(m, x, text_in):
        return m.attn(m.encode(x, train=True), text=text_in, train=False,
                      batch_max_length=worker.JAX_STEPS)

    def loss_fn(params, stats, batch):
        logits, mut = model.apply({"params": params, "batch_stats": stats}, batch["image"],
                                  batch["text_in"], method=outputs, mutable=["batch_stats"])
        return jax_masked_token_ce(logits, batch["target_y"], 0, batch["valid"]), mut

    tx = jax_build_optimizer("Adam", LR)

    @jax.jit
    def step(params, stats, batch):
        (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, stats, batch)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, mut["batch_stats"], grads, optax.apply_updates(params, updates)

    m8 = jax_make_mesh()
    assert m8.shape == {"data": 8}
    params = jax.device_put(variables["params"], replicated_sharding(m8))
    stats = jax.device_put(variables["batch_stats"], replicated_sharding(m8))
    batch = jax.device_put(worker.jax_batch(), batch_sharding(m8))
    with m8:
        out = step(params, stats, batch)
    loss, new_stats, grads, new_params = jax.tree_util.tree_map(np.asarray, out)
    return dict(before=variables, loss=float(loss), stats=new_stats, grads=grads,
                params=new_params)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The 2-rank worker's outputs, the 1-process step and JAX's mesh step."""
    tmp = tmp_path_factory.mktemp("dp")
    jax_out = _jax_mesh_step()
    model = worker.jax_model()
    load_jax_variables(model, jax_out["before"])
    state_path = str(tmp / "jax_setup_state.pt")
    torch.save(model.state_dict(), state_path)
    launch([os.path.join(REPO, "tests", "torch_port_dp_worker.py"), str(tmp), state_path])
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return dict(ranks=ranks, one=worker.step_case(slice(None)), jax=jax_out)


def _rank(dp, r, prefix):
    return {k[len(prefix):]: v for k, v in dp["ranks"][r].items() if k.startswith(prefix)}


def test_two_rank_step_loss_and_gradients_match_one_process(dp):
    one = dp["one"]
    for r in range(2):
        got = _rank(dp, r, "step_")
        for k in ("metric_loss", "metric_attn_loss", "metric_ctc_loss"):
            np.testing.assert_allclose(got[k], one[k], rtol=2e-5, err_msg=k)
        for k in one:
            if k.startswith("grad_"):
                scale = float(np.abs(one[k]).max())
                np.testing.assert_allclose(got[k], one[k], rtol=1e-3, atol=1e-3 * scale,
                                           err_msg=k)
    # every rank steps with the same summed gradient
    for k in one:
        if k.startswith("grad_"):
            np.testing.assert_array_equal(dp["ranks"][0]["step_" + k],
                                          dp["ranks"][1]["step_" + k], err_msg=k)


def test_two_rank_step_parameters_and_statistics_match_one_process(dp):
    one = dp["one"]
    checked = total = 0
    for r in range(2):
        got = _rank(dp, r, "step_")
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
    for k in one:  # the ranks hold one model
        if k.startswith(("param_", "stat_")):
            np.testing.assert_array_equal(dp["ranks"][0]["step_" + k],
                                          dp["ranks"][1]["step_" + k], err_msg=k)


def test_each_rank_draws_its_rows_of_the_one_process_masks(dp):
    """Dropout, DropBlock and device augmentation draw for the global batch:
    rank r's masks are rows [4r, 4r + 4) of the one-process masks, and the
    two ranks' masks differ (drawn from the step's seed alone, both ranks
    would take the same masks)."""
    one = dp["one"]
    masks = sorted(k for k in one if k.startswith("mask_"))
    # encoder dropout, 7 alpha-dropouts, 11 DropBlocks, 1 augmentation
    assert len(masks) == 20
    for k in masks:
        halves = [dp["ranks"][r]["step_" + k] for r in range(2)]
        for r, half in enumerate(halves):
            np.testing.assert_array_equal(half, one[k][4 * r:4 * r + 4], err_msg=k)
        assert not np.array_equal(halves[0], halves[1]), k


def test_two_rank_step_matches_jax_mesh_step(dp):
    """2 ranks x 4 rows vs JAX's one program over 8 devices x 1 row."""
    j = dp["jax"]
    model = worker.jax_model()
    for r in range(2):
        got = _rank(dp, r, "jax_")
        np.testing.assert_allclose(got["metric_loss"], j["loss"], rtol=1e-5)
        for prefix, cols in (("param_", None), ("grad_", None)):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(torch.from_numpy(got[prefix + n]))
                for n, b in model.named_buffers():
                    if "running" in n:
                        b.copy_(torch.from_numpy(got["stat_" + n]))
            tree = to_jax_variables(model)
            if prefix == "grad_":
                port, want = _flat(tree["params"]), _flat(j["grads"])
                assert set(port) == set(want)
                for k in want:
                    scale = float(np.abs(want[k]).max())
                    np.testing.assert_allclose(port[k], want[k], rtol=1e-3, atol=1e-3 * scale,
                                               err_msg=k)
            else:
                stats, want_stats = _flat(tree["batch_stats"]), _flat(j["stats"])
                assert set(stats) == set(want_stats)
                for k in want_stats:
                    np.testing.assert_allclose(stats[k], want_stats[k], rtol=1e-4, atol=2e-4,
                                               err_msg=k)
                port, want, before = (_flat(tree["params"]), _flat(j["params"]),
                                      _flat(j["before"]["params"]))
                grads = _flat(j["grads"])
                checked = total = 0
                for k in want:
                    posed = np.abs(grads[k]) > 1e-5
                    np.testing.assert_allclose((port[k] - before[k])[posed],
                                               (want[k] - before[k])[posed], rtol=1e-3,
                                               atol=1e-3 * LR, err_msg=k)
                    checked += int(posed.sum())
                    total += posed.size
                assert checked >= 0.8 * total, (checked, total)  # 86% in this setup


def test_global_metric_sum_over_two_ranks(dp):
    want = [2.0, 2.0, 3 * 2.0 ** -40]
    for r in range(2):
        np.testing.assert_array_equal(dp["ranks"][r]["metric_sum"], want)
    assert mesh.global_metric_sum([1.5, 2.0]).tolist() == [1.5, 2.0]  # identity, one process


# --- the loop ------------------------------------------------------------------

TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")


def _loop_config(work, exp_dir, **kw):
    cfg = {"exp_dir": exp_dir, "train_csvs": [os.path.join(work, "data", "labels.csv")],
           "train_roots": [os.path.join(work, "data")],
           "charset_path": os.path.join(work, "charset.txt"), "img_h": 32, "img_w": 64,
           "max_len": 6, "hidden_size": 16, "width_mult": 0.125, "lstm_layers": 1,
           "batch_size": 8, "epochs": 2, "val_size": 8, "eval_every": 1, "seed": 0,
           "compute_dtype": "float32", "num_workers": 0, "progress": False,
           "device_augment": True}
    cfg.update(kw)
    return cfg


def _epoch_rows(exp_dir):
    with open(os.path.join(exp_dir, "metrics_epoch.csv"), encoding="utf-8") as f:
        return list(csv.DictReader(f))


def test_two_rank_training_loop_matches_one_process(tmp_path):
    from helpers import make_synthetic_dataset, tiny_labels

    work = str(tmp_path)
    with open(os.path.join(work, "charset.txt"), "w") as f:
        f.write("\n".join(TOKENS) + "\n")
    make_synthetic_dataset(os.path.join(work, "data"), tiny_labels(24))
    mp_dir, sp_dir = os.path.join(work, "exp_mp"), os.path.join(work, "exp_sp")
    cfg_path = os.path.join(work, "mp.json")
    with open(cfg_path, "w") as f:
        json.dump(_loop_config(work, mp_dir), f)
    launch(["-m", "rcnn_ocr_tpu_torch.training.train", cfg_path, "--device", "cpu",
            "--dist-timeout", "120", "--result-json", os.path.join(work, "result.json")])
    one = run_training(Config(_loop_config(work, sp_dir)), device="cpu")

    mp_rows, sp_rows = _epoch_rows(mp_dir), _epoch_rows(sp_dir)
    assert len(mp_rows) == len(sp_rows) == 2
    for i, (a, b) in enumerate(zip(mp_rows, sp_rows)):
        tol = 1e-5 if i == 0 else 1e-3
        for k in ("train_loss", "val_loss"):
            assert abs(float(a[k]) - float(b[k])) < tol, (i, k, a[k], b[k])
        assert a["val_acc"] == b["val_acc"]
    results = []
    for r in range(2):
        with open(os.path.join(work, f"result.rank{r}.json")) as f:
            results.append(json.load(f))
    assert [res["rank"] for res in results] == [0, 1]
    for k in ("val_acc", "val_loss", "global_step"):
        assert results[0][k] == results[1][k], k
    assert results[0]["global_step"] == one["global_step"]
    for e0, e1 in zip(results[0]["epochs"], results[1]["epochs"]):
        assert (e0["val_loss"], e0["val_acc"], e0["val_cer"]) == (
            e1["val_loss"], e1["val_acc"], e1["val_cer"])
    # only rank 0 wrote: its slots, one events file, no temporaries, its log
    for slot in ("last", "best_loss", "best_acc"):
        assert os.path.exists(os.path.join(mp_dir, f"{slot}_ckpt.msgpack"))
    assert not [p for p in os.listdir(mp_dir) if p.endswith(".tmp")]
    events = [p for p in os.listdir(os.path.join(mp_dir, "logs")) if "tfevents" in p]
    assert len(events) <= 1
    log = open(os.path.join(mp_dir, "train.log"), encoding="utf-8").read()
    assert "rank 0;" in log and "rank 1;" not in log


def _rank_pids(launcher_pid):
    """{rank: pid} of the launcher's worker processes."""
    out = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != launcher_pid:
                continue
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
        except (OSError, ValueError, IndexError):
            continue
        if b"RANK" in env:
            out[int(env[b"RANK"])] = int(pid)
    return out


def test_sigterm_to_one_rank_stops_both_after_the_same_step(tmp_path):
    """A SIGTERM that reaches rank 1 alone stops both ranks after the same
    step; rank 0 writes the 'last' slot and both return ``preempted``."""
    import signal
    import time

    from helpers import make_synthetic_dataset, tiny_labels

    work = str(tmp_path)
    with open(os.path.join(work, "charset.txt"), "w") as f:
        f.write("\n".join(TOKENS) + "\n")
    make_synthetic_dataset(os.path.join(work, "data"), tiny_labels(24))
    exp_dir = os.path.join(work, "exp")
    cfg_path = os.path.join(work, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(_loop_config(work, exp_dir, epochs=200, async_checkpoint=False), f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "rcnn_ocr_tpu_torch.training.train", cfg_path, "--device", "cpu",
         "--dist-timeout", "120", "--result-json", os.path.join(work, "result.json")],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 180
        while not os.path.exists(os.path.join(exp_dir, "last_ckpt.msgpack")):
            assert launcher.poll() is None, launcher.stderr.read()[-3000:]
            assert time.monotonic() < deadline, "no epoch finished"
            time.sleep(0.2)
        pids = _rank_pids(launcher.pid)
        assert sorted(pids) == [0, 1], pids
        os.kill(pids[1], signal.SIGTERM)
        _, err = launcher.communicate(timeout=180)
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait(timeout=30)
    assert launcher.returncode == 0, err[-3000:]
    results = []
    for r in range(2):
        with open(os.path.join(work, f"result.rank{r}.json")) as f:
            results.append(json.load(f))
    assert all(res.get("preempted") for res in results)
    assert results[0]["global_step"] == results[1]["global_step"]
    assert len(results[0]["epochs"]) == len(results[1]["epochs"]) < 200
    from rcnn_ocr_tpu_torch.training import checkpoint as ckpt

    blob = ckpt.load_checkpoint_blob(os.path.join(exp_dir, "last_ckpt.msgpack"))
    assert blob["global_step"] == results[0]["global_step"]


# --- units ---------------------------------------------------------------------

GLOBAL_BATCHES = {
    "lists": [list(range(8)), list(range(8, 15)), list(range(15, 20)), [20]],
    "buckets": [("b", 64, list(range(6))), ("b", 128, list(range(6, 9))),
                ("b", 64, list(range(9, 12))), ("b", 128, [12, 13, 14, 15, 16])],
}


@pytest.mark.parametrize("kind", sorted(GLOBAL_BATCHES))
@pytest.mark.parametrize("count", [2, 3, 4])
def test_process_sharded_sampler_matches_jax(kind, count):
    def batches(bucket_cls):
        return [bucket_cls(b[1], b[2]) if isinstance(b, tuple) else list(b)
                for b in GLOBAL_BATCHES[kind]]

    seen = []
    for p in range(count):
        got = list(ProcessShardedBatchSampler(batches(BucketBatch), p, count))
        want = list(JaxSharded(batches(JaxBucketBatch), p, count))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            assert isinstance(g, BucketBatch) == isinstance(w, JaxBucketBatch)
            if isinstance(w, JaxBucketBatch):
                assert g.width == w.width
        seen.append([list(g) for g in got])
        assert len(ProcessShardedBatchSampler(batches(BucketBatch), p, count)) == len(
            GLOBAL_BATCHES[kind])
    # the ranks' blocks are disjoint and of one size per batch
    for blocks in zip(*seen):
        assert len({len(b) for b in blocks}) == 1
        flat = [i for b in blocks for i in b]
        assert len(flat) == len(set(flat))
    with pytest.raises(ValueError):
        ProcessShardedBatchSampler([], count, count)


class _Rows:
    """A dataset whose samples are their transform's first random draw."""

    def __len__(self):
        return 8

    def fetch(self, idx, transform=None, rng=None):
        return np.full((2, 2, 3), rng.random(), np.float32), "ab"


def test_loader_seeds_each_row_by_its_global_row():
    """Rank r of P holding block r of each batch draws what one process
    draws for those rows (host augmentation seeds)."""
    cs = Charset.from_tokens(TOKENS)
    one = [b["image"][:, 0, 0, 0] for b in DataLoader(_Rows(), [list(range(8))], cs, 4, seed=7)]
    for count in (2, 4):
        per = 8 // count
        for r in range(count):
            sampler = ProcessShardedBatchSampler([list(range(8))], r, count)
            got = [b["image"][:, 0, 0, 0] for b in DataLoader(_Rows(), sampler, cs, 4, seed=7,
                                                               shard_index=r)]
            np.testing.assert_array_equal(got[0], one[0][r * per:(r + 1) * per])


def test_make_mesh_falls_back_and_refuses_a_model_axis():
    m = mesh.make_mesh()
    assert m.shape == {"data": 1} and m.devices == [0]
    assert mesh.make_mesh((4,), devices=range(4)).shape == {"data": 4}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m = mesh.make_mesh((3,), devices=range(4))
    assert m.shape == {"data": 4}
    assert any("falling back" in str(w.message) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m = mesh.make_mesh((4, 1), ("data", "model"), devices=range(4))
    assert m.shape == {"data": 4, "model": 1} and not caught
    # a model axis builds, as JAX's make_mesh does; (3, 2) does not tile 4
    # ranks and falls back to pure data parallelism with JAX's warning
    for shape in ((2, 2), (1, 4)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m = mesh.make_mesh(shape, ("data", "model"), devices=range(4))
        assert m.shape == dict(zip(("data", "model"), shape)) and not caught
        assert (m.n_data, m.n_model) == shape
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m = mesh.make_mesh((3, 2), ("data", "model"), devices=range(4))
    assert m.shape == {"data": 4, "model": 1}
    assert any("falling back" in str(w.message) for w in caught)
    m = mesh.make_mesh((1, 2), ("data", "model"), devices=range(2))
    assert (m.n_data, m.n_model) == (1, 2)


def test_config_docstring_says_what_mesh_shape_does():
    """``training/config.py`` said a ``mesh_shape`` over more than one device
    raises; since data parallelism was ported it runs over the ranks, and
    since tensor parallelism was ported a ``model`` axis over 1 shards the
    weights."""
    from rcnn_ocr_tpu_torch.training import config

    doc = " ".join(config.__doc__.split())
    assert "raises there" not in doc
    assert "``mesh_shape`` over more than one device runs data parallelism" in doc
    assert "a ``model`` axis over 1 raises" not in doc
    assert ("a ``model`` axis over 1 also shards the big weights over the ranks of each "
            "data row") in doc


def test_no_group_is_one_process():
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    with mesh.batch_shard() as shard:
        assert shard is None and mesh.current_shard() is None
        t = torch.ones(3, requires_grad=True)
        assert mesh.global_sum(t) is t
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE") if k in os.environ}
        try:
            mesh.init_distributed(device="cpu")
        finally:
            os.environ.update(env)
    with mesh.device_scope(["cpu"]):
        assert mesh.scoped_devices() == ["cpu"]
    assert mesh.scoped_devices() is None
    rows, ids = mesh.local_batch_rows(torch.arange(3.0), np.arange(2))
    assert rows.tolist() == [0.0, 1.0, 2.0] and ids.tolist() == [0, 1]
