"""BENCHMARK.json against the contract's shape, and the harness finding
every piece of a cell by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all("/" not in w or w.startswith("benchmark") for w in BENCH["command"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(group):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[group]
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e_names
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(BENCH, cell["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(BENCH, cell["name"], True)
        assert cell["chips"] == 1
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e_names
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in run.cell_metrics(BENCH, cell, False)}
        assert run.reader_path(m["name"]).exists()


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_and_its_config_counts_are_the_yardsticks(cell):
    _, cfg, mix = run.load_cell(cell, BENCH)
    run.check_counts(cfg)
    limits = mix["check"]["limits"]
    assert "widest_gap" in limits and set(limits) <= set(run.NUMBERS)
    assert all(v > 0 for v in limits.values())
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert (ROOT / entry["file"]).exists() and entry["reduced"] == []


def test_a_new_cell_is_found_by_name_with_no_code_edit(tmp_path):
    for sub in ("configs", "workloads"):
        shutil.copytree(ROOT / "benchmark" / sub, tmp_path / sub)
    mix = json.loads((tmp_path / "workloads" / "bulk_ctc.default64.json").read_text())
    mix["call"]["batch_size"] = 123
    (tmp_path / "workloads" / "bulk_ctc123.shipped32.json").write_text(json.dumps(mix))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "bulk_ctc123.shipped32", "config": "rcnn_shipped_32x128",
         "traffic": "bulk_ctc123.shipped32", "chips": 1, "why": "a test cell"}])
    _, cfg, got = run.load_cell("bulk_ctc123.shipped32", bench, root=tmp_path)
    assert cfg["img_h"] == 32 and got["call"]["batch_size"] == 123
    assert {m["name"] for m in run.cell_metrics(bench, "bulk_ctc123.shipped32", False)} == \
        {"setup_s"}
    with pytest.raises(KeyError):
        run.load_cell("no_such.cell", bench, root=tmp_path)


def test_a_metric_of_a_cell_is_read_by_its_quantitys_reader():
    assert run.reader_path("idle_share.ctc64") == ROOT / "benchmark" / "metrics" / "idle_share.py"
    assert run.reader_path("mfu") == ROOT / "benchmark" / "metrics" / "mfu.py"
    ctx = {"window_s": 2.0, "busy_s": 1.5}
    assert run.read_metric("idle_share.attn32", ctx) == pytest.approx(25.0)


def test_a_stated_count_that_is_not_the_yardsticks_is_refused():
    _, cfg, _ = run.load_cell("bulk_ctc.default64", BENCH)
    cfg["counts"]["encode_flops_per_line"] += 1
    with pytest.raises(ValueError, match="encode_flops_per_line"):
        run.check_counts(cfg)


def test_setup_s_leaves_out_the_reference_s_batch_norm_calibration(monkeypatch, capsys):
    import time

    import torch

    real = run.calibrate_batch_norm

    def slow(*a, **k):
        real(*a, **k)
        time.sleep(2.0)

    monkeypatch.setattr(run, "calibrate_batch_norm", slow)
    out, _ = run.run_cell(BENCH, "bulk_ctc.default64", 2**31 + 3, 0.01, False, device="cpu",
                          dtype=torch.float32,
                          overrides={"lines": {"n_lines": 4}, "call": {"batch_size": 4},
                                     "check": {"sample_lines": 2, "longest": 1}})
    line = next(x for x in capsys.readouterr().err.splitlines() if x.startswith("set-up s:"))
    steps = dict(part.rsplit(" ", 1) for part in line[len("set-up s: "):].split(";")[0]
                 .split(", "))
    assert float(steps["calibration"]) >= 2.0
    age_at_window = sum(float(v) for v in steps.values())
    setup_s = out["metrics"]["setup_s"]["value"]
    assert setup_s == pytest.approx(age_at_window - float(steps["calibration"]), abs=0.05)
