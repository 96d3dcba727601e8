"""Summarize an HPO study's results file.

A copy of the JAX package's ``tools/hpo_report.py``.  ``run_hpo``
(:mod:`rcnn_ocr_tpu_torch.hpo.driver`) writes
``<storage_dir>/<study>_results.json`` after every finished trial, so this
works on a running study as well as a finished one:

    python -m rcnn_ocr_tpu_torch.hpo.report hpo_runs/ocr_results.json
    python -m rcnn_ocr_tpu_torch.hpo.report hpo_runs --study ocr     # same file

Prints the trials ranked by value (pruned/failed flagged, epochs and
wall-seconds per trial), the best parameters, and what pruning saved.
Exit 1 when the file is missing or empty.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any, Dict, List


def load_results(path: str) -> Dict[str, Any]:
    """Read a results file in either shape the driver writes:
    mid-run ``{"best": {...}, "trials": [...]}`` or final
    ``{"best_value": ..., "best_params": ..., "trials": [...]}``.
    Raises ValueError on unparseable JSON (main turns it into exit 1 —
    the driver writes atomically, so this means a foreign/corrupt file,
    not a mid-write snapshot)."""
    with open(path, encoding="utf-8") as f:
        try:
            blob = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"not a results JSON file: {e}") from e
    if "best" in blob:  # mid-run shape
        best = blob["best"]
    else:
        best = {
            "best_value": blob.get("best_value"),
            "best_params": blob.get("best_params"),
        }
    return {"best": best, "trials": blob.get("trials") or []}


def _fmt_value(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float) and not math.isfinite(v):
        return "failed"
    return f"{v:.4f}"


def _fmt_params(params: Dict[str, Any]) -> str:
    return ", ".join(
        f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in sorted(params.items())
    )


def render_report(results: Dict[str, Any]) -> str:
    trials: List[Dict] = results["trials"]
    lines: List[str] = []
    ranked = sorted(
        trials,
        key=lambda t: (
            t["value"]
            if isinstance(t.get("value"), (int, float))
            and math.isfinite(t["value"])
            else -math.inf
        ),
        reverse=True,
    )
    lines.append(f"{'rank':>4} {'trial':>5} {'value':>10} {'epochs':>6} "
                 f"{'sec':>7} {'state':>7}  params")
    for rank, t in enumerate(ranked, 1):
        state = "pruned" if t.get("pruned") else (
            "failed" if isinstance(t.get("value"), float)
            and not math.isfinite(t["value"]) else "done"
        )
        lines.append(
            f"{rank:>4} {t['number']:>5} {_fmt_value(t.get('value')):>10} "
            f"{t.get('epochs_run', '-') if t.get('epochs_run') is not None else '-':>6} "
            f"{t.get('seconds', '-'):>7} {state:>7}  "
            f"{_fmt_params(t.get('params') or {})}"
        )

    n_pruned = sum(1 for t in trials if t.get("pruned"))
    n_failed = sum(
        1 for t in trials
        if isinstance(t.get("value"), float) and not math.isfinite(t["value"])
    )
    lines.append("")
    lines.append(
        f"trials: {len(trials)}  pruned: {n_pruned}  failed: {n_failed}"
    )
    epochs = [
        t["epochs_run"] for t in trials if t.get("epochs_run") is not None
    ]
    if epochs and n_pruned:
        # only trials whose epoch count is KNOWN enter both sides of the
        # comparison, and the per-trial budget is taken from completed
        # (unpruned) trials — counting unknown trials in the denominator
        # (or budgeting from an all-pruned max) would overstate savings
        completed = [
            t["epochs_run"] for t in trials
            if t.get("epochs_run") is not None and not t.get("pruned")
        ]
        full = max(completed) if completed else max(epochs)
        spent = sum(epochs)
        budget = full * len(epochs)
        lines.append(
            f"epochs spent: {spent} of {budget} a prune-less study would "
            f"have run ({budget - spent} saved"
            + ("" if completed else "; lower bound — every trial pruned")
            + ")"
        )
    best = results["best"]
    if best.get("best_params") is not None:
        lines.append(f"best value: {_fmt_value(best.get('best_value'))}")
        lines.append(f"best params: {_fmt_params(best['best_params'])}")
    else:
        lines.append("no successful trials yet")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "path", help="results JSON file, or the study's storage_dir"
    )
    p.add_argument(
        "--study", default=None,
        help="study name (with a storage_dir path): reads "
        "<path>/<study>_results.json",
    )
    args = p.parse_args(argv)
    path = args.path
    if os.path.isdir(path):
        if not args.study:
            cands = [f for f in os.listdir(path) if f.endswith("_results.json")]
            if len(cands) != 1:
                print(
                    f"{path} holds {len(cands)} studies — pass --study "
                    f"(found: {', '.join(sorted(cands)) or 'none'})"
                )
                return 1
            path = os.path.join(path, cands[0])
        else:
            path = os.path.join(path, f"{args.study}_results.json")
    if not os.path.exists(path):
        print(f"results file not found: {path}")
        return 1
    try:
        results = load_results(path)
    except ValueError as e:
        print(str(e))
        return 1
    if not results["trials"]:
        print(f"no trials recorded yet in {path}")
        return 1
    print(render_report(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
