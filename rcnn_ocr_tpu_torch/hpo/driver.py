"""Hyperparameter-optimization driver of the port.

A copy of ``rcnn_ocr_tpu/hpo/driver.py`` (the study the reference's README
documents: ``optuna_ocr.db`` and its "LSTM 2 512" variant) over the port's
``run_training``:

* **Search space** ``DEFAULT_SPACE``: lr, weight decay, momentum, the
  augmentation magnitudes, the encoder LSTM's width and depth, optimizer and
  scheduler.
* **Backend**: Optuna with sqlite storage when ``optuna`` imports;
  otherwise a built-in seeded searcher with the same API
  (:class:`_BuiltinTrial`), incumbent perturbation (:func:`perturb_params`)
  and successive-halving pruning (:class:`SuccessiveHalvingPruner`).  The
  results JSON has JAX's format, which ``python -m
  rcnn_ocr_tpu_torch.hpo.report`` reads (and JAX's ``tools/hpo_report.py``).
* **Devices**: trials run one after another, each over the whole job.  In
  a job of N ranks (``python -m torch.distributed.run``) every rank runs the
  same seeded study in lockstep, each trial is data-parallel over the N
  ranks, the validation metrics the pruner sees are global, and rank 0
  writes the results: JAX's "each trial over the full mesh".
  ``parallel_trials=K`` runs K trials at once in threads of a one-rank
  process, each pinned (:func:`rcnn_ocr_tpu_torch.parallel.mesh.device_scope`)
  to its group of the cards (:func:`_device_groups`), and trains on its
  group's first card; under several ranks it raises (ROADMAP.md queue 3's
  deliberate divergence: HPO's concurrent trials across ranks).

Usage::

    from rcnn_ocr_tpu_torch.hpo import run_hpo
    run_hpo(base_config, n_trials=20, study_name="ocr")
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from rcnn_ocr_tpu_torch.parallel.mesh import (
    UNPORTED,
    device_scope,
    process_count,
    process_index,
    scoped_devices,
)

SearchSpace = Dict[str, Tuple]  # name -> ("float"|"log"|"int"|"cat", ...)

DEFAULT_SPACE: SearchSpace = {
    "lr": ("log", 1e-5, 1e-2),
    "weight_decay": ("log", 1e-7, 1e-3),
    "momentum": ("float", 0.8, 0.99),
    "hidden_size": ("cat", (256, 512)),
    "lstm_layers": ("cat", (1, 2, 3)),
    "optimizer": ("cat", ("Adam", "AdamW", "SGD")),
    "scheduler": ("cat", ("ReduceLROnPlateau", "CosineAnnealingLR")),
    "shift_limit": ("float", 0.0, 0.1),
    "scale_limit": ("float", 0.0, 0.15),
    "rotate_limit": ("int", 0, 8),
    "p_ShiftScaleRotate": ("float", 0.0, 0.7),
    "brightness_limit": ("float", 0.0, 0.4),
    "contrast_limit": ("float", 0.0, 0.4),
    "p_BrightnessContrast": ("float", 0.0, 0.7),
    "invert_p": ("float", 0.0, 0.05),
}


class _BuiltinTrial:
    """Optuna-compatible trial facade over a seeded RNG."""

    def __init__(self, number: int, rng):
        self.number = number
        self._rng = rng
        self.params: Dict[str, Any] = {}

    def suggest_float(self, name, low, high, log=False):
        if log:
            v = float(math.exp(self._rng.uniform(math.log(low), math.log(high))))
        else:
            v = float(self._rng.uniform(low, high))
        self.params[name] = v
        return v

    def suggest_int(self, name, low, high):
        v = int(self._rng.integers(low, high + 1))
        self.params[name] = v
        return v

    def suggest_categorical(self, name, choices):
        v = choices[int(self._rng.integers(0, len(choices)))]
        self.params[name] = v
        return v


def sample_params(trial, space: SearchSpace) -> Dict[str, Any]:
    out = {}
    for name, spec in space.items():
        kind = spec[0]
        if kind == "float":
            out[name] = trial.suggest_float(name, spec[1], spec[2])
        elif kind == "log":
            out[name] = trial.suggest_float(name, spec[1], spec[2], log=True)
        elif kind == "int":
            out[name] = trial.suggest_int(name, spec[1], spec[2])
        elif kind == "cat":
            out[name] = trial.suggest_categorical(name, list(spec[1]))
        else:
            raise ValueError(f"unknown space kind: {kind}")
    return out


def perturb_params(
    incumbent: Dict[str, Any],
    space: SearchSpace,
    rng,
    scale: float = 0.15,
) -> Dict[str, Any]:
    """Local perturbation of the incumbent (builtin searcher exploitation).

    The quasi-random builtin sampler never adapts — after N trials it is
    still sampling blind, while Optuna's TPE concentrates near the best
    region.  This is the cheap adaptive step:
    floats move by ``N(0, scale * range)`` (log floats in log space),
    ints by ±1, categoricals resample with probability 0.3 — clipped to
    the space.  Deterministic given ``rng``.
    """
    out: Dict[str, Any] = {}
    for name, spec in space.items():
        kind = spec[0]
        cur = incumbent.get(name)
        if cur is None:
            kind = "missing"
        if kind == "float":
            lo, hi = spec[1], spec[2]
            v = float(cur) + float(rng.normal(0.0, scale * (hi - lo)))
            out[name] = float(min(max(v, lo), hi))
        elif kind == "log":
            lo, hi = math.log(spec[1]), math.log(spec[2])
            v = math.log(float(cur)) + float(rng.normal(0.0, scale * (hi - lo)))
            out[name] = float(math.exp(min(max(v, lo), hi)))
        elif kind == "int":
            lo, hi = spec[1], spec[2]
            v = int(cur) + int(rng.integers(-1, 2))
            out[name] = int(min(max(v, lo), hi))
        elif kind == "cat":
            choices = list(spec[1])
            if rng.random() < 0.3:
                out[name] = choices[int(rng.integers(0, len(choices)))]
            else:
                out[name] = cur
        else:  # param absent from the incumbent: sample fresh
            out[name] = sample_params(
                _BuiltinTrial(-1, rng), {name: spec}
            )[name]
    return out


class PrunedTrial(Exception):
    """A trial stopped early by the pruner; carries its best value so far.

    Raised by the default objective AFTER ``run_training`` returned
    cleanly (checkpoints drained, signal handlers restored) — pruning is
    cooperative, never an exception thrown through the training loop.
    """

    def __init__(self, value: float, epochs_run: int):
        super().__init__(f"pruned at epoch {epochs_run} (value {value})")
        self.value = float(value)
        self.epochs_run = int(epochs_run)


def _default_objective(
    base_config: Dict[str, Any],
    params: Dict[str, Any],
    trial_dir: str,
    report: Optional[Callable[[int, float], bool]] = None,
):
    """Train one trial on the first card of the thread's device scope (the
    card of this rank, or ``"cuda"``); ``report(epoch, val_acc) ->
    should_prune`` wires the backend's pruner into ``run_training``'s eval
    cadence."""
    from rcnn_ocr_tpu_torch.training.config import Config
    from rcnn_ocr_tpu_torch.training.train import run_training

    cfg_dict = dict(base_config)
    cfg_dict.update(params)
    cfg_dict["exp_dir"] = trial_dir

    eval_callback = None
    if report is not None:

        def eval_callback(epoch, metrics):
            return bool(report(epoch, float(metrics["val_acc"])))

    device = (scoped_devices() or ["cuda"])[0]
    result = run_training(Config(cfg_dict), device=device, eval_callback=eval_callback)
    value = float(result["val_acc"])
    if result.get("pruned"):
        raise PrunedTrial(value, int(result.get("epochs_run", 0)))
    return value


def _accepts_report(objective) -> bool:
    """Whether an objective takes the 4th ``report`` pruning callback."""
    import inspect

    try:
        return len(inspect.signature(objective).parameters) >= 4
    except (TypeError, ValueError):
        return False


def _call_objective(objective, base_config, params, trial_dir, report):
    """Invoke an objective, passing ``report`` only if it accepts it
    (user objectives keep the documented 3-arg signature)."""
    if _accepts_report(objective):
        return objective(base_config, params, trial_dir, report)
    return objective(base_config, params, trial_dir)


class SuccessiveHalvingPruner:
    """ASHA-style pruner for the builtin backend (no Optuna needed).

    Rungs sit at epochs ``min_resource * eta^k``.  A trial reaching a rung
    is pruned when its value falls below the top ``1/eta`` quantile of
    every value reported at that rung so far (asynchronous successive
    halving: early trials see thin history and run long; later trials are
    culled against it).  Thread-safe — parallel trials share the rungs.
    """

    def __init__(self, min_resource: int = 1, eta: int = 3, max_rung_epoch: int = 10_000):
        import threading

        self.eta = int(eta)
        self.rungs: Dict[int, List[float]] = {}
        r = int(min_resource)
        self._rung_epochs = set()
        while r <= max_rung_epoch:
            self._rung_epochs.add(r)
            r *= self.eta
        self._lock = threading.Lock()

    def report(self, epoch: int, value: float) -> bool:
        if epoch not in self._rung_epochs:
            return False
        with self._lock:
            hist = self.rungs.setdefault(epoch, [])
            hist.append(float(value))
            if len(hist) < self.eta:
                return False  # not enough rung history to judge
            srt = sorted(hist)
            # keep the top 1/eta: prune below that quantile's threshold
            threshold = srt[max(0, len(srt) - max(1, len(srt) // self.eta))]
            return float(value) < threshold


def all_devices() -> List[str]:
    """The cards of this process (``cuda:0`` ...), or ``["cpu"]`` without one."""
    import torch

    return [f"cuda:{i}" for i in range(torch.cuda.device_count())] or ["cpu"]


def _device_groups(parallel_trials: int, devices: Optional[Sequence[Any]] = None) -> List[list]:
    """Partition ``devices`` (the thread's device scope, else
    :func:`all_devices`) into equal contiguous groups, one per trial.

    Caps at the device count; leftover devices (when the count is not
    divisible) idle for the study's duration, with a warning."""
    import warnings

    if devices is None:
        devices = scoped_devices() or all_devices()
    devs = list(devices)
    k = max(1, min(int(parallel_trials), len(devs)))
    if k < parallel_trials:
        warnings.warn(
            f"parallel_trials={parallel_trials} > {len(devs)} devices; "
            f"running {k} concurrent trials",
            stacklevel=3,
        )
    per = len(devs) // k
    if per * k < len(devs):
        warnings.warn(
            f"{len(devs)} devices do not split into {k} equal submeshes; "
            f"{len(devs) - per * k} device(s) will idle",
            stacklevel=3,
        )
    return [devs[i * per : (i + 1) * per] for i in range(k)]


def run_hpo(
    base_config: Dict[str, Any],
    n_trials: int = 20,
    study_name: str = "ocr_hpo",
    storage_dir: str = "hpo",
    space: Optional[SearchSpace] = None,
    objective: Optional[Callable[[Dict[str, Any], Dict[str, Any], str], float]] = None,
    seed: int = 0,
    parallel_trials: int = 1,
    prune: bool = True,
    pruner: Any = None,
    perturb: bool = True,
) -> Dict[str, Any]:
    """Run the study; returns {"best_value", "best_params", "trials"}.

    ``parallel_trials=K > 1`` runs K trials concurrently, each pinned to
    its own ``len(devices)/K``-card group (see module docstring); it raises
    ``NotImplementedError`` in a job of several ranks.

    ``prune=True`` (default) stops unpromising trials at epoch level
    through ``run_training``'s eval cadence — Optuna's MedianPruner in
    the Optuna backend, :class:`SuccessiveHalvingPruner` in the builtin
    one (pass ``pruner=`` to override either): pruning is what makes a
    big study cheap.
    Trials log entries carry ``pruned`` and ``epochs_run``.

    ``perturb=True`` (default; builtin backend only) makes the quasi-
    random searcher adaptive: after a ``max(4, n_trials // 4)``-trial
    warmup, every second trial perturbs the incumbent's params locally
    (:func:`perturb_params`) instead of sampling blind — measured to beat
    pure quasi-random on a deterministic toy objective (the JAX package's
    ``tests/test_hpo_perturb.py``).  Optuna's TPE already adapts; the flag
    is ignored there.  With ``parallel_trials > 1`` the incumbent a
    perturbation sees depends on completion order (still seeded, but not
    schedule-deterministic — the price of adapting mid-flight).
    """
    space = space or DEFAULT_SPACE
    objective = objective or _default_objective
    if parallel_trials > 1 and process_count() > 1:
        raise NotImplementedError(
            f"parallel_trials={parallel_trials} in a job of {process_count()} ranks: "
            f"concurrent trials inside a job of several ranks are not ported ({UNPORTED}); "
            "run one trial at a time over the ranks, or parallel trials in a one-rank process")
    is_lead = process_index() == 0
    if prune and not _accepts_report(objective):
        # a 3-arg custom objective can't receive the pruning callback —
        # say so up front instead of silently running every trial to
        # completion with prune=True
        import warnings

        warnings.warn(
            "prune=True but the objective does not accept a 4th 'report' "
            "argument — trials will run to completion; add "
            "report: Callable[[int, float], bool] and honor its return "
            "value to enable epoch-level pruning",
            stacklevel=2,
        )
    if is_lead:
        os.makedirs(storage_dir, exist_ok=True)
    results_path = os.path.join(storage_dir, f"{study_name}_results.json")

    def run_objective(base, params, trial_dir, report=None):
        return _call_objective(objective, base, params, trial_dir, report)

    if parallel_trials > 1:
        import queue as queue_mod

        groups = _device_groups(parallel_trials)
        parallel_trials = len(groups)
        if any(len(g) > 1 for g in groups):
            import warnings

            warnings.warn(
                f"groups of {len(groups[0])} devices: a trial in one process trains on "
                "its group's first card (data parallelism is across ranks)",
                stacklevel=2,
            )
        group_pool: "queue_mod.Queue" = queue_mod.Queue()
        for g in groups:
            group_pool.put(g)

        def run_objective(base, params, trial_dir, report=None):  # noqa: F811
            group = group_pool.get()
            try:
                with device_scope(group):
                    return _call_objective(
                        objective, base, params, trial_dir, report
                    )
            finally:
                group_pool.put(group)

    try:
        import optuna  # optional

        have_optuna = True
    except ImportError:
        have_optuna = False

    trials_log: List[Dict[str, Any]] = []

    def _dump_results(payload: Dict[str, Any]) -> None:
        # atomic: hpo.report reads this file while the study is RUNNING;
        # the lead rank alone writes it
        if not is_lead:
            return
        tmp = results_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, results_path)

    if have_optuna:
        # the lead rank keeps the study on disk; the others follow in memory
        # (the same seed and global metrics give them the same suggestions)
        storage = (f"sqlite:///{os.path.join(storage_dir, 'optuna_ocr.db')}" if is_lead
                   else None)
        study = optuna.create_study(
            study_name=study_name,
            storage=storage,
            direction="maximize",
            load_if_exists=True,
            sampler=optuna.samplers.TPESampler(seed=seed),
            pruner=(
                pruner
                if pruner is not None
                else optuna.pruners.MedianPruner(n_startup_trials=4)
                if prune
                else optuna.pruners.NopPruner()
            ),
        )

        def opt_objective(trial):
            params = sample_params(trial, space)
            trial_dir = os.path.join(storage_dir, f"{study_name}_trial{trial.number}")
            epochs_seen = {"n": 0}
            t0 = time.time()

            def report(epoch, value):
                epochs_seen["n"] = epoch
                if not prune:
                    return False
                trial.report(value, step=epoch)
                return trial.should_prune()

            try:
                value = run_objective(base_config, params, trial_dir, report)
            except PrunedTrial as p:
                trial.set_user_attr("epochs_run", p.epochs_run)
                trial.set_user_attr("seconds", round(time.time() - t0, 1))
                raise optuna.TrialPruned() from p
            trial.set_user_attr("epochs_run", epochs_seen["n"])
            trial.set_user_attr("seconds", round(time.time() - t0, 1))
            return value

        def _optuna_trials_log(st) -> List[Dict[str, Any]]:
            return [
                {
                    "number": t.number,
                    "value": t.value,
                    "params": t.params,
                    "seconds": t.user_attrs.get("seconds"),
                    "pruned": t.state == optuna.trial.TrialState.PRUNED,
                    "epochs_run": t.user_attrs.get("epochs_run"),
                }
                for t in st.trials
                if t.state.is_finished()
            ]

        def _optuna_best(st) -> Dict[str, Any]:
            try:
                return {"best_value": st.best_value, "best_params": st.best_params}
            except ValueError:  # every trial pruned before its first report
                return {"best_value": -math.inf, "best_params": None}

        def _write_progress(st, _trial) -> None:
            # per-trial snapshot so hpo.report works mid-study on this
            # backend too (the builtin path writes per trial below)
            _dump_results(
                {"best": _optuna_best(st), "trials": _optuna_trials_log(st)}
            )

        study.optimize(
            opt_objective,
            n_trials=n_trials,
            n_jobs=parallel_trials,
            catch=(),
            callbacks=[_write_progress],
        )
        best = _optuna_best(study)
        trials_log = _optuna_trials_log(study)
    else:
        import numpy as np

        rng = np.random.default_rng(seed)
        # params sampled up-front on one thread: the schedule is
        # deterministic in `seed` regardless of parallel completion order
        sampled = []
        for i in range(n_trials):
            trial = _BuiltinTrial(i, rng)
            sampled.append(sample_params(trial, space))

        best = {"best_value": -math.inf, "best_params": None}
        log_lock = __import__("threading").Lock()
        builtin_pruner = (
            pruner
            if pruner is not None
            else SuccessiveHalvingPruner()
            if prune
            else None
        )

        warmup = max(4, n_trials // 4)

        def run_one(i: int) -> None:
            nonlocal best
            params = sampled[i]
            sampler = "quasi-random"
            if (
                perturb
                and i >= warmup
                and i % 2 == 1
                and best["best_params"] is not None
            ):
                # exploitation step: refine the incumbent locally; the
                # even-index trials keep exploring the full space
                params = perturb_params(
                    best["best_params"], space, np.random.default_rng([seed, i])
                )
                sampler = "perturb"
            trial_dir = os.path.join(storage_dir, f"{study_name}_trial{i}")
            t0 = time.time()
            epochs_seen = {"n": 0}

            def report(epoch, value):
                epochs_seen["n"] = epoch
                if builtin_pruner is None:
                    return False
                return bool(builtin_pruner.report(epoch, value))

            pruned = False
            try:
                value = run_objective(base_config, params, trial_dir, report)
            except PrunedTrial as p:
                # a pruned trial still reports its best value: the study's
                # best must not regress just because a trial stopped early
                value, pruned = p.value, True
                epochs_seen["n"] = p.epochs_run
                print(f"[hpo] trial {i} pruned at epoch {p.epochs_run}")
            except Exception as e:  # a diverged trial must not kill the study
                print(f"[hpo] trial {i} failed: {e}")
                value = -math.inf
            with log_lock:
                trials_log.append(
                    {
                        "number": i,
                        "value": value,
                        "params": params,
                        "seconds": round(time.time() - t0, 1),
                        "pruned": pruned,
                        "epochs_run": epochs_seen["n"],
                        "sampler": sampler,
                    }
                )
                if value > best["best_value"]:
                    best = {"best_value": value, "best_params": params}
                _dump_results({"best": best, "trials": trials_log})

        if parallel_trials > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=parallel_trials) as ex:
                list(ex.map(run_one, range(n_trials)))
            trials_log.sort(key=lambda t: t["number"])
        else:
            for i in range(n_trials):
                run_one(i)

    out = {**best, "trials": trials_log}
    _dump_results(out)
    return out
