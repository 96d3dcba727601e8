"""Run one benchmark cell once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/workloads/<traffic>.json``).  Set-up makes the lines and the
weights from the seed, builds the program's engine (``rcnn_ocr_tpu_torch``)
and warms the mix's one batch shape; the window then drives the mix's entry
for ``--seconds``: back-to-back ``OCRInference.predict_serving`` calls over
every line (a closed loop, one client).  After the window the program is
freed and the plain float32 reference (``benchmark/reference/``) judges a
seeded sample of the served strings.

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, each read from the profiler's trace of the
window by the reader of its quantity, ``benchmark/metrics/<the name up to its
first dot>.py``.  The last line of standard output is the result as one JSON
object; the numbers compared for ``correct`` also end standard error.  Exits 2 without a card,
3 if JAX or the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import flops, trace, traffic
from benchmark.reference import judge, lowp, preprocess, rcnn
from benchmark.weights import as_tree, calibrate_batch_norm, make_weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rcnn_ocr_tpu")
JUDGE_BLOCK = 256
CALIBRATION = 1 << 40  # the batch-norm calibration lines' seed is the run's plus this


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat", encoding="ascii") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime", encoding="ascii") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text(encoding="utf-8"))


def load_cell(name: str, bench: dict, root: Path = HERE) -> Tuple[dict, dict, dict]:
    """(cell, configuration, mix) by the cell's name in ``bench``: the files
    ``<root>/configs/<config>.json`` and ``<root>/workloads/<traffic>.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    return cell, load_json(root / "configs" / f"{cell['config']}.json"), \
        load_json(root / "workloads" / f"{cell['traffic']}.json")


def cell_metrics(bench: dict, cell: str, traced: bool) -> List[dict]:
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader_path(name: str) -> Path:
    """The per-layer metric's reader, that of its quantity: ``idle_share.py``
    for ``idle_share.ctc64``; cells that report different end-to-end metrics
    share it."""
    return HERE / "metrics" / f"{name.split('.')[0]}.py"


def read_metric(name: str, ctx: dict) -> Optional[float]:
    """The metric's reader's ``read(ctx)``."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", reader_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def head_of(call: dict) -> str:
    return "ctc" if call["method"].startswith("ctc") else "attention"


# -- how a mix drives the program ---------------------------------------------


class Bulk:
    """Back-to-back ``predict_serving`` calls over all lines, one client."""

    def __init__(self, engine, lines, mix):
        self.engine, self.lines, self.call = engine, lines, mix["call"]

    def _predict(self, lines):
        c = self.call
        return self.engine.predict_serving(lines, method=c["method"],
                                           max_length=c["max_length"],
                                           batch_size=c["batch_size"],
                                           canvas=tuple(c["canvas"]))

    def warm_up(self) -> None:
        # one call of two batches: both letterbox buffers, the one shape
        self._predict(self.lines[:2 * self.call["batch_size"]])

    def window(self, seconds: float, seed: int) -> dict:
        outs = []
        t0 = time.perf_counter()
        while True:
            with trace.span("predict_serving"):
                outs.append(self._predict(self.lines))
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        n = len(self.lines)
        batch = self.call["batch_size"]
        return {"metrics": {"lines_per_s": len(outs) * n / elapsed},
                "attempted": len(outs) * n, "failed": 0, "outs": outs,
                "encodes": {batch: len(outs) * math.ceil(n / batch)},
                "lines": len(outs) * n}

    def served(self, result: dict, rng: np.random.Generator, mix: dict):
        """(line index, string) pairs to judge: a seeded sample over every
        call and line, with the lines whose strings are longest."""
        outs = result["outs"]
        check = mix["check"]
        n = len(self.lines)
        picks = {(int(c), int(i)) for c, i in zip(rng.integers(0, len(outs), check["sample_lines"]),
                                                  rng.integers(0, n, check["sample_lines"]))}
        lengths = np.array([len(t) for t in outs[0]])
        for i in np.argsort(-lengths, kind="stable")[:check["longest"]]:
            picks.add((0, int(i)))
        return [(i, outs[c][i]) for c, i in sorted(picks)]



# -- the comparison that decides `correct` ------------------------------------


# the numbers a mix may limit, each over the judged lines' gaps (a line's gap: its widest)
NUMBERS = {"widest_gap": np.max, "mean_gap": np.mean}


def line_gaps(cfg: dict, mix: dict, W: Dict[str, torch.Tensor], itos: List[str], lines,
              pairs, device) -> Tuple[np.ndarray, int]:
    """Each served string's gap (``pairs``: line index, string), judged by the
    float32 reference in blocks; and the tokens judged."""
    stoi = {t: i for i, t in enumerate(itos) if len(t) == 1}
    head = head_of(mix["call"])
    steps = mix["call"]["max_length"] + 1
    hid = cfg["hidden_size"]
    invisible = [itos.index(t) for t in cfg["invisible_tokens"]]
    all_gaps, tokens = [], 0
    with rcnn.plain_fp32(), torch.no_grad():
        for lo in range(0, len(pairs), JUDGE_BLOCK):
            block = pairs[lo:lo + JUDGE_BLOCK]
            x = preprocess.model_input([lines[i] for i, _ in block], cfg["img_h"], cfg["img_w"])
            enc = rcnn.encode(W, torch.from_numpy(x).to(device), cfg)
            texts = [t for _, t in block]
            if head == "ctc":
                gaps = judge.ctc_gaps(rcnn.ctc_logits(W, enc).cpu().numpy(), texts, stoi,
                                      invisible)
            else:
                gaps = judge.attention_gaps(
                    lambda rows, inputs: rcnn.attention_logits(W, enc[rows], inputs, hid),
                    texts, stoi, itos.index("<SOS>"), itos.index("<EOS>"), steps, device)
            all_gaps.append(gaps)
            tokens += sum(len(t) for t in texts)
    gaps = np.concatenate(all_gaps) if all_gaps else np.zeros(0)
    if len(gaps):
        sys.stderr.write(f"line gaps: mean {gaps.mean()!r}, median {np.median(gaps)!r}, "
                         f"p99 {np.percentile(gaps, 99)!r}, "
                         f"five widest {np.sort(gaps)[-5:].tolist()!r}, "
                         f"nonzero {int((gaps > 0).sum())} of {len(gaps)}\n")
    return gaps, tokens


def float8_strings(cfg, mix, W, itos, lines, pairs, device):
    """The pairs with the float8 reference's strings in the program's place."""
    out = []
    with torch.no_grad():
        for lo in range(0, len(pairs), JUDGE_BLOCK):
            block = pairs[lo:lo + JUDGE_BLOCK]
            x = preprocess.model_input([lines[i] for i, _ in block], cfg["img_h"], cfg["img_w"])
            texts = lowp.greedy_strings(W, cfg, torch.from_numpy(x).to(device),
                                        head_of(mix["call"]), mix["call"]["max_length"] + 1, itos)
            out += [(i, t) for (i, _), t in zip(block, texts)]
    return out


# -- one run ------------------------------------------------------------------


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def check_counts(cfg: dict) -> None:
    """The operation counts the configuration file states must be the
    yardstick's own (``benchmark/flops.py``)."""
    steps = cfg["max_len"] + 1
    want = {"frames": rcnn.frames(cfg), "encode_flops_per_line": flops.encode_flops(cfg),
            "ctc_head_flops_per_line": flops.head_flops(cfg, "ctc", 0),
            "attention_head_flops_per_line": flops.head_flops(cfg, "attention", steps)}
    bad = {k: (cfg["counts"][k], v) for k, v in want.items() if cfg["counts"][k] != v}
    if bad:
        raise ValueError(f"{cfg['name']}: counts (stated, computed) disagree: {bad}")


def prepare(cfg: dict, mix: dict, seed: int, dev: torch.device, marks: list,
            dtype: torch.dtype):
    """Set-up from the seed: ``(itos, lines, weights, engine, calibration
    seconds)``.  The lines and weights are made here; the engine is the
    program's ``OCRInference`` over them.  Appends ``(step, process age)`` to
    ``marks``."""
    from rcnn_ocr_tpu_torch.inference import OCRInference

    charset = HERE / "configs" / cfg["charset"]
    itos = [t for t in charset.read_text(encoding="utf-8").split("\n") if t]
    lines = traffic.make_lines(mix["lines"], seed)
    marks.append(("lines", process_age_s()))
    W = make_weights(cfg, itos, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("weights", process_age_s()))
    calibrate_batch_norm(W, cfg, traffic.make_lines(
        dict(mix["lines"], n_lines=cfg["weights"]["calibration_lines"]), seed + CALIBRATION), dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("calibration", process_age_s()))
    engine = OCRInference(as_tree(W), str(charset), device=dev, img_h=cfg["img_h"],
                          img_w=cfg["img_w"], dtype=dtype)
    return itos, lines, W, engine, marks[-1][1] - marks[-2][1]


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", control: bool = False,
             dtype: Optional[torch.dtype] = None,
             overrides: Optional[dict] = None) -> Tuple[dict, List[str]]:
    """One run of cell ``name``: ``(result, the numbers compared as lines)``.
    ``control`` judges the float8 reference's strings of the same lines in
    place of the program's (the control, for the card test); ``dtype``
    overrides the configuration's and ``overrides`` parts of the mix (the CPU
    tests' float32 and small sizes)."""
    _, cfg, mix = load_cell(name, bench)
    check_counts(cfg)
    mix = merged(mix, overrides or {})
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    marks = [("imports", process_age_s())]
    itos, lines, W, engine, calibration_s = prepare(
        cfg, mix, seed, dev, marks, dtype or getattr(torch, cfg["compute_dtype"]))
    driver = Bulk(engine, lines, mix)
    marks.append(("engine", process_age_s()))
    driver.warm_up()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warm-up", process_age_s()))
    # the reference's batch-norm calibration makes weights, not the program's set-up
    setup_s = marks[-1][1] - calibration_s
    sys.stderr.write("set-up s: " + ", ".join(
        f"{name} {t - (marks[i - 1][1] if i else 0.0):.2f}" for i, (name, t) in enumerate(marks))
        + f"; setup_s {setup_s:.2f} (calibration not counted)\n")
    with trace.window(traced) as captured:
        result = driver.window(seconds, seed)
    if cuda:
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)

    pairs = driver.served(result, np.random.default_rng(seed), mix)
    del driver, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if control:
        pairs = float8_strings(cfg, mix, W, itos, lines, pairs, dev)
    gaps, tokens = line_gaps(cfg, mix, W, itos, lines, pairs, dev)
    sys.stderr.write(f"judged {len(pairs)} lines, {tokens} tokens\n")
    checks = {k: {"value": float(NUMBERS[k](gaps)) if len(gaps) else 0.0, "limit": limit}
              for k, limit in mix["check"]["limits"].items()}
    checks["failed"] = {"value": result["failed"], "limit": 0}
    correct = bool(pairs) and all(c["value"] <= c["limit"] for c in checks.values())

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    metrics, extra = {}, {}
    wanted = cell_metrics(bench, name, traced)
    if traced:
        reduced = trace.reduce(captured["events"])
        ctx = dict(reduced, config=cfg, head=head_of(mix["call"]),
                   steps=mix["call"]["max_length"] + 1, peaks=peaks_for(device_info["kind"]),
                   encodes=result["encodes"], lines=result["lines"])
        device_info.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        for m in wanted:
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = reduced["breakdown"]
    else:
        # a cell's metric is its quantity's value (``lines_per_s`` for ``lines_per_s.ctc64``)
        values = dict(result["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in wanted}
    out = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
           "metrics": metrics, "device": device_info, **extra, "checks": checks}
    lines_out = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return out, lines_out


def peaks_for(kind: str) -> Optional[dict]:
    """The published peaks of the card named ``kind`` (None: not in the table)."""
    for prefix, peaks in load_json(HERE / "peaks.json").items():
        if prefix in kind:
            return peaks
    return None


class ForbiddenImport(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__(f"JAX or the JAX package is loaded: {found}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        out, checks = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    except ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    sys.stderr.write("\n".join(checks) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
