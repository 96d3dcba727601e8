"""The port's HPO driver against the JAX package's, on the CPU.

* On one seed and a deterministic toy objective: the same trial parameters
  in order (perturbation on), the same ``SuccessiveHalvingPruner``
  decisions, and results JSON with the same keys and values (wall seconds
  aside); the Optuna branch through the fake ``optuna`` of
  ``tests/test_training_extras.py:311``, in both packages.
* ``_device_groups`` on fake device lists, partitioned as JAX partitions
  its 8 virtual devices (warnings included).
* A real 2-trial study over the port's ``run_training``, in one process and
  as a 2-rank gloo job (``python -m torch.distributed.run`` over a script
  that calls ``run_hpo``): the same parameters and values, and rank 0 alone
  writes the results; both report tools read them alike.
* ``python -m rcnn_ocr_tpu_torch.hpo_search``'s ``main`` with
  ``DEFAULT_SPACE`` on the CPU.
* ``parallel_trials > 1`` caps at the devices with JAX's warning, and raises
  in a job of several ranks.
"""

import json
import math
import os
import subprocess
import sys
import types
import warnings

import jax
import numpy as np
import pytest

import rcnn_ocr_tpu.hpo.driver as jax_driver
import rcnn_ocr_tpu_torch.hpo.driver as port_driver
from rcnn_ocr_tpu_torch.hpo import report as port_report
from rcnn_ocr_tpu_torch.parallel.mesh import device_scope

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import hpo_report as jax_report  # noqa: E402

SPACE = {
    "lr": ("log", 1e-5, 1e-2),
    "momentum": ("float", 0.8, 0.99),
    "rotate_limit": ("int", 0, 8),
    "optimizer": ("cat", ("Adam", "AdamW", "SGD")),
}
MAX_EPOCHS = 9


def _toy(base, params, trial_dir, report=None, pruned_cls=None):
    """A smooth bowl over the space, reported per epoch like a training run."""
    v = -10.0 * ((math.log10(params["lr"]) + 3.52) ** 2)
    v -= 400.0 * (params["momentum"] - 0.9) ** 2
    v -= 0.05 * (params["rotate_limit"] - 3) ** 2
    v -= 0.0 if params["optimizer"] == "Adam" else 0.3
    value = 0.0
    for epoch in range(1, MAX_EPOCHS + 1):
        value = v * epoch / MAX_EPOCHS
        if report is not None and report(epoch, value):
            raise pruned_cls(value, epoch)
    return value


def _objective(driver):
    def objective(base, params, trial_dir, report=None):
        return _toy(base, params, trial_dir, report, driver.PrunedTrial)

    return objective


def _strip(out):
    return {**out, "trials": [{k: v for k, v in t.items() if k != "seconds"}
                              for t in out["trials"]]}


@pytest.mark.parametrize("prune", [True, False])
def test_builtin_study_matches_jax(tmp_path, prune):
    runs = {}
    for name, driver in (("jax", jax_driver), ("port", port_driver)):
        storage = str(tmp_path / name)
        out = driver.run_hpo({}, n_trials=16, study_name="toy", storage_dir=storage,
                             space=SPACE, objective=_objective(driver), seed=7,
                             prune=prune, perturb=True)
        with open(os.path.join(storage, "toy_results.json"), encoding="utf-8") as f:
            runs[name] = (out, json.load(f))
    (jo, jf), (po, pf) = runs["jax"], runs["port"]
    assert _strip(po) == _strip(jo)
    assert _strip(pf) == _strip(jf) and list(pf) == list(jf)
    assert [list(t) for t in pf["trials"]] == [list(t) for t in jf["trials"]]
    assert sum(t["sampler"] == "perturb" for t in po["trials"]) >= 4
    assert any(t["pruned"] for t in po["trials"]) == prune


def test_successive_halving_decisions_match_jax():
    rng = np.random.default_rng(0)
    reports = [(int(rng.choice([1, 2, 3, 9, 27])), float(rng.random())) for _ in range(200)]
    for eta, r0 in ((3, 1), (2, 1), (4, 2)):
        a = jax_driver.SuccessiveHalvingPruner(min_resource=r0, eta=eta)
        b = port_driver.SuccessiveHalvingPruner(min_resource=r0, eta=eta)
        assert [b.report(e, v) for e, v in reports] == [a.report(e, v) for e, v in reports]
        assert b.rungs == a.rungs


def test_sample_and_perturb_params_match_jax():
    from rcnn_ocr_tpu_torch.hpo import DEFAULT_SPACE

    assert DEFAULT_SPACE == jax_driver.DEFAULT_SPACE
    for seed in range(5):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        pa = jax_driver.sample_params(jax_driver._BuiltinTrial(0, ra), DEFAULT_SPACE)
        pb = port_driver.sample_params(port_driver._BuiltinTrial(0, rb), DEFAULT_SPACE)
        assert pa == pb
        assert (jax_driver.perturb_params(pa, DEFAULT_SPACE, ra)
                == port_driver.perturb_params(pb, DEFAULT_SPACE, rb))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9])
def test_device_groups_partition_as_jax(k):
    jax_ids = [d.id for d in jax.devices()]
    assert len(jax_ids) == 8
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = [[d.id for d in g] for g in jax_driver._device_groups(k)]
    with warnings.catch_warnings(record=True) as wp:
        warnings.simplefilter("always")
        got = port_driver._device_groups(k, jax_ids)
    assert got == want
    assert [str(w.message) for w in wp] == [str(w.message) for w in wj]
    with device_scope(jax_ids):  # the thread's scope is the default list
        assert port_driver._device_groups(k) == want


def test_parallel_trials_cap_at_the_devices_and_refuse_several_ranks(tmp_path, monkeypatch):
    def objective(base, params, trial_dir):
        return float(params["lr"])

    space = {"lr": ("float", 0.0, 1.0)}
    with device_scope(["cpu"]), pytest.warns(UserWarning, match="running 1 concurrent"):
        out = port_driver.run_hpo({}, n_trials=3, study_name="cap", space=space,
                                  storage_dir=str(tmp_path / "cap"), objective=objective,
                                  parallel_trials=2, prune=False)
    assert [t["number"] for t in out["trials"]] == [0, 1, 2]
    monkeypatch.setattr(port_driver, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError,
                       match="queue 3 deliberate divergence: HPO's concurrent trials across ranks"):
        port_driver.run_hpo({}, n_trials=2, study_name="dp", space=space,
                            storage_dir=str(tmp_path / "dp"), objective=objective,
                            parallel_trials=2, prune=False)


def _fake_optuna():
    """The stub of ``tests/test_training_extras.py:311``."""

    class TrialPruned(Exception):
        pass

    class _TrialState:
        def __init__(self, name):
            self.name = name

        def is_finished(self):
            return True

    class _State:
        PRUNED, COMPLETE = _TrialState("PRUNED"), _TrialState("COMPLETE")

    class _Trial:
        def __init__(self, number):
            self.number = number
            self.params = {}
            self.user_attrs = {}
            self.value = None
            self.state = _State.COMPLETE
            self.reports = []

        def suggest_float(self, name, low, high, log=False):
            v = low + (high - low) * ((self.number * 37 % 10) / 10.0)
            self.params[name] = v
            return v

        def suggest_int(self, name, low, high):
            self.params[name] = low
            return low

        def suggest_categorical(self, name, choices):
            self.params[name] = choices[0]
            return choices[0]

        def report(self, value, step):
            self.reports.append((step, value))

        def should_prune(self):
            return self.number % 2 == 1 and len(self.reports) >= 2

        def set_user_attr(self, k, v):
            self.user_attrs[k] = v

    class _Study:
        def __init__(self):
            self.trials = []

        def optimize(self, fn, n_trials, n_jobs, catch=(), callbacks=()):
            for i in range(n_trials):
                t = _Trial(i)
                self.trials.append(t)
                try:
                    t.value = fn(t)
                except TrialPruned:
                    t.state = _State.PRUNED
                for cb in callbacks or ():
                    cb(self, t)

        @property
        def best_value(self):
            vals = [t.value for t in self.trials if t.state == _State.COMPLETE]
            if not vals:
                raise ValueError("no completed trials")
            return max(vals)

        @property
        def best_params(self):
            return max((t for t in self.trials if t.state == _State.COMPLETE),
                       key=lambda t: t.value).params

    stub = types.ModuleType("optuna")
    stub.TrialPruned = TrialPruned
    stub.create_study = lambda **kw: _Study()
    stub.samplers = types.SimpleNamespace(TPESampler=lambda seed: None)
    stub.pruners = types.SimpleNamespace(MedianPruner=lambda **kw: None, NopPruner=lambda: None)
    stub.trial = types.SimpleNamespace(TrialState=_State)
    return stub


def test_optuna_backend_matches_jax(tmp_path, monkeypatch):
    outs = {}
    for name, driver in (("jax", jax_driver), ("port", port_driver)):
        monkeypatch.setitem(sys.modules, "optuna", _fake_optuna())

        def objective(base, params, trial_dir, report=None, driver=driver):
            value = 0.0
            for epoch in range(1, 5):
                value = params["lr"] * epoch
                if report is not None and report(epoch, value):
                    raise driver.PrunedTrial(value, epoch)
            return value

        storage = str(tmp_path / name)
        out = driver.run_hpo({}, n_trials=4, study_name="s", storage_dir=storage,
                             space={"lr": ("float", 0.1, 0.9)}, objective=objective, seed=0,
                             prune=True)
        with open(os.path.join(storage, "s_results.json"), encoding="utf-8") as f:
            outs[name] = (out, json.load(f))
    (jo, jf), (po, pf) = outs["jax"], outs["port"]
    assert _strip(po) == _strip(jo) and _strip(pf) == _strip(jf)
    assert [t["number"] for t in po["trials"] if t["pruned"]] == [1, 3]


# --- a real study over the port's run_training ---------------------------------

TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
TRIAL_SPACE = {"lr": ("log", 1e-4, 1e-2), "hidden_size": ("cat", (16,)),
               "lstm_layers": ("cat", (1, 2)), "optimizer": ("cat", ("Adam", "AdamW"))}


@pytest.fixture(scope="module")
def trial_data(tmp_path_factory):
    from helpers import make_synthetic_dataset, tiny_labels

    root = tmp_path_factory.mktemp("hpo_data")
    charset = str(root / "charset.txt")
    with open(charset, "w") as f:
        f.write("\n".join(TOKENS) + "\n")
    csv_path, img_root = make_synthetic_dataset(str(root / "data"), tiny_labels(24))
    base = {"train_csvs": [csv_path], "train_roots": [img_root], "charset_path": charset,
            "img_h": 32, "img_w": 64, "max_len": 6, "width_mult": 0.125, "batch_size": 8,
            "epochs": 1, "val_size": 8, "seed": 0, "compute_dtype": "float32",
            "num_workers": 0, "progress": False}
    return root, base


def test_real_study_in_one_process_and_over_two_ranks(trial_data, tmp_path, capsys):
    root, base = trial_data
    with device_scope(["cpu"]):
        one = port_driver.run_hpo(base, n_trials=2, study_name="mini",
                                  storage_dir=str(tmp_path / "one"), space=TRIAL_SPACE, seed=0)
    assert len(one["trials"]) == 2 and one["best_params"] is not None
    assert all(np.isfinite(t["value"]) and t["epochs_run"] == 1 for t in one["trials"])
    for i in range(2):
        assert os.path.exists(tmp_path / "one" / f"mini_trial{i}" / "last_ckpt.msgpack")

    # the same study as a 2-rank job, each trial data-parallel over the
    # ranks (a short script: hpo_search's space is DEFAULT_SPACE)
    cfg_path = str(tmp_path / "base.json")
    with open(cfg_path, "w") as f:
        json.dump(base, f)
    script = tmp_path / "study.py"
    script.write_text(
        "import json, sys\n"
        "from rcnn_ocr_tpu_torch.hpo.driver import run_hpo\n"
        "from rcnn_ocr_tpu_torch.parallel.mesh import device_scope, init_distributed\n"
        "dev = init_distributed(device='cpu', timeout_s=120)\n"
        f"space = {TRIAL_SPACE!r}\n"
        "with device_scope([str(dev)]):\n"
        f"    run_hpo(json.load(open({cfg_path!r})), n_trials=2, study_name='mini',\n"
        f"            storage_dir={str(tmp_path / 'two')!r}, space=space, seed=0)\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", str(script)], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    with open(tmp_path / "two" / "mini_results.json", encoding="utf-8") as f:
        two = json.load(f)
    assert [t["params"] for t in two["trials"]] == [t["params"] for t in one["trials"]]
    for a, b in zip(two["trials"], one["trials"]):
        assert abs(a["value"] - b["value"]) < 1e-6 and a["epochs_run"] == b["epochs_run"]
    assert not [p for p in os.listdir(tmp_path / "two") if p.endswith(".tmp")]

    # both report tools read the port's results alike
    path = str(tmp_path / "one" / "mini_results.json")
    assert port_report.main([path]) == 0
    ours = capsys.readouterr().out
    assert jax_report.main([path]) == 0
    assert capsys.readouterr().out == ours and "best params" in ours
    assert port_report.main([str(tmp_path / "one")]) == 0
    assert capsys.readouterr().out == ours
    assert port_report.main([str(tmp_path / "nope.json")]) == 1


def test_hpo_search_cli_caps_parallel_trials(trial_data, tmp_path, capsys):
    from rcnn_ocr_tpu_torch import hpo_search

    root, base = trial_data
    cfg_path = str(tmp_path / "base.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(base, exp_dir="ignored", epochs=3), f)
    with pytest.warns(UserWarning, match="running 1 concurrent"):
        assert hpo_search.main(["--config", cfg_path, "--trials", "1", "--epochs-per-trial",
                                "1", "--parallel-trials", "2", "--storage-dir",
                                str(tmp_path / "cli"), "--study", "cli", "--device",
                                "cpu"]) == 0
    assert "best value" in capsys.readouterr().out
    with open(tmp_path / "cli" / "cli_results.json", encoding="utf-8") as f:
        blob = json.load(f)
    assert len(blob["trials"]) == 1 and blob["trials"][0]["epochs_run"] == 1
    assert set(blob["trials"][0]["params"]) == set(port_driver.DEFAULT_SPACE)
