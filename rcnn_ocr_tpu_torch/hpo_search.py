"""Hyperparameter search over the port's ``run_training``.

The port's copy of the root ``hpo_search.py`` (the same flags), over
:func:`rcnn_ocr_tpu_torch.hpo.driver.run_hpo`::

    python -m rcnn_ocr_tpu_torch.hpo_search --config configs/config.json --trials 20 \\
        [--study ocr_hpo] [--storage-dir hpo] [--epochs-per-trial 5] [--device cpu]

Trials run one after another on the card (``--device``), or, with
``--parallel-trials N``, N at a time, each on its own group of the cards (N
is capped at the card count, with a warning).  Under ``python -m
torch.distributed.run`` every rank runs the same study and each trial is
data-parallel over the ranks (``--backend``, ``--dist-timeout`` as for the
training CLI); rank 0 writes ``<storage-dir>/<study>_results.json``.  Uses
Optuna when it imports, else the built-in searcher.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from rcnn_ocr_tpu_torch.hpo.driver import DEFAULT_SPACE, all_devices, run_hpo
from rcnn_ocr_tpu_torch.parallel.mesh import device_scope, init_distributed, process_index


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Hyperparameter search over run_training")
    ap.add_argument("--config", required=True, help="base training config JSON")
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--study", default="ocr_hpo")
    ap.add_argument("--storage-dir", default="hpo")
    ap.add_argument("--epochs-per-trial", type=int, default=None,
                    help="override epochs for each trial (default: config value)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parallel-trials", type=int, default=1,
                    help="run N trials concurrently, each on its own group of the cards "
                         "(default 1: trials one after another)")
    ap.add_argument("--no-prune", action="store_true",
                    help="disable epoch-level trial pruning (MedianPruner with Optuna, "
                         "successive halving in the builtin backend)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; cuda:<LOCAL_RANK> under torch.distributed.run), "
                         "cuda:N or cpu")
    ap.add_argument("--backend", default=None,
                    help="process-group backend under torch.distributed.run (default: nccl "
                         "on a card, gloo on the CPU)")
    ap.add_argument("--dist-timeout", type=float, default=None,
                    help="seconds any collective may wait for the other ranks")
    args = ap.parse_args(argv)

    with open(args.config, "r", encoding="utf-8") as f:
        base = json.load(f)
    base.pop("exp_dir", None)  # each trial gets its own
    base.pop("resume_path", None)
    if args.epochs_per_trial is not None:
        base["epochs"] = args.epochs_per_trial

    device = args.device
    if "WORLD_SIZE" in os.environ:  # under the launcher: join its group
        device = str(init_distributed(args.backend, args.device, args.dist_timeout))
    lead = process_index() == 0
    devices = [device]
    if args.parallel_trials > 1 and device == "cuda":
        devices = all_devices()
    try:
        with device_scope(devices):
            out = run_hpo(base, n_trials=args.trials, study_name=args.study,
                          storage_dir=args.storage_dir, space=DEFAULT_SPACE, seed=args.seed,
                          parallel_trials=args.parallel_trials, prune=not args.no_prune)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if lead:
        n_pruned = sum(1 for t in out["trials"] if t.get("pruned"))
        if n_pruned:
            total_ep = sum(t.get("epochs_run") or 0 for t in out["trials"])
            print(f"pruned {n_pruned}/{len(out['trials'])} trials "
                  f"({total_ep} total epochs run)")
        print(f"best value: {out['best_value']}")
        print(f"best params: {json.dumps(out['best_params'], indent=2)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
