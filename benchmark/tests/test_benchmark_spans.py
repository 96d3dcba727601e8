"""The readers of the program's spans (``benchmark/metrics/*_share.py`` over
``benchmark/spans.py``): each on a hand-filled store, on a program without
the store, and in a traced CPU run of each cell."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import run
from rcnn_ocr_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WINDOW_S = 4.0
# quantity -> (span name, from the device's events)
READS = {"strings_share": ("serving.strings", False),
         "input_wait_share": ("serving.input_wait", False),
         "letterbox_share": ("serving.letterbox", False),
         "encoder_share": ("rcnn.encode", True),
         "decoder_share": ("rcnn.decode", True)}
HOST = [q for q, (_, device) in READS.items() if not device]
DEVICE = [q for q, (_, device) in READS.items() if device]


def _record(i, name, start_s, host_s, device_s=None):
    return {"id": i, "name": name, "thread": 1, "parent": None, "start_ns": int(start_s * 1e9),
            "end_ns": int((start_s + host_s) * 1e9), "counts": {}, "device_s": device_s}


@pytest.fixture
def store(monkeypatch):
    """Each span name twice: 0.3 + 0.5 host seconds, device ranges 0.25 + 0.75."""
    records = []
    for name, device in READS.values():
        for host_s, device_s in ((0.3, 0.25), (0.5, 0.75)):
            records.append(_record(len(records), name, len(records), host_s,
                                   device_s if device else None))
    records.append(_record(len(records), "serving.fetch", 99.0, 1.0))  # read by no metric
    monkeypatch.setattr(profiling, "spans", lambda: records)
    return records


@pytest.mark.parametrize("cell", ["attn32", "ctc64"])
@pytest.mark.parametrize("quantity", list(READS))
def test_each_reader_gives_its_spans_seconds_over_the_window(store, quantity, cell):
    want = 100.0 * (1.0 if READS[quantity][1] else 0.8) / WINDOW_S
    got = run.read_metric(f"{quantity}.{cell}", {"window_s": WINDOW_S})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("quantity", list(READS))
def test_a_reader_finds_nothing_to_read_without_its_spans(monkeypatch, quantity):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert run.read_metric(quantity, {"window_s": WINDOW_S}) is None
    assert run.read_metric(quantity, {"window_s": 0.0}) is None


@pytest.mark.parametrize("quantity", list(READS))
def test_a_reader_reads_none_from_a_program_without_the_store(monkeypatch, quantity):
    """The parent commit's ``profiling`` has neither total: no number, no raise."""
    monkeypatch.delattr(profiling, "host_seconds")
    monkeypatch.delattr(profiling, "device_seconds")
    assert run.read_metric(quantity, {"window_s": WINDOW_S}) is None


def test_the_ten_entries_name_their_cell_layer_and_end_to_end_metric():
    entries = {m["name"]: m for m in BENCH["per_layer"] if m["name"].split(".")[0] in READS}
    assert len(entries) == 10
    cells = {"attn32": "bulk_attn.shipped32", "ctc64": "bulk_ctc.default64"}
    for name, m in entries.items():
        suffix = name.split(".")[1]
        assert m["workloads"] == [cells[suffix]] and m["moves"] == f"lines_per_s.{suffix}"
        assert (m["unit"], m["better"], m["source"]) == ("%", "lower", "device_trace")


@pytest.mark.parametrize("cell", ["bulk_attn.shipped32", "bulk_ctc.default64"])
def test_a_traced_cpu_run_reads_every_host_share_and_no_device_share(monkeypatch, cell):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    profiling.clear()
    out, _ = run.run_cell(BENCH, cell, 2**31 + 11, 0.01, True, device="cpu",
                          dtype=torch.float32,
                          overrides={"lines": {"n_lines": 6}, "call": {"batch_size": 2},
                                     "check": {"sample_lines": 2, "longest": 1}})
    suffix = {"bulk_attn.shipped32": "attn32", "bulk_ctc.default64": "ctc64"}[cell]
    metrics = out["metrics"]
    for q in HOST:
        assert 0.0 < metrics[f"{q}.{suffix}"]["value"] < 100.0, q
    for q in DEVICE:
        assert f"{q}.{suffix}" not in metrics, q
    # the store holds the window alone: the warm-up's call, of 4 lines, ran untraced
    calls = [r for r in profiling.spans() if r["name"] == "serving.predict"]
    assert calls and all(r["counts"]["rows"] == 6 for r in calls)
    profiling.clear()
