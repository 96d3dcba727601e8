"""The port's span store (``rcnn_ocr_tpu_torch/utils/profiling.py``) on the
CPU: the gate, the spans of ``predict_serving``'s chunks on both threads,
their clock against the profiler's capture, and ``trace()``'s busy time.

The engine is the serving tests' tiny one (seeded weights, both heads, fp32,
32x64); 13 lines at batch 3 make five chunks, the last padded.
"""

import threading
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from rcnn_ocr_tpu_torch.inference import OCRInference
from rcnn_ocr_tpu_torch.utils import profiling
from rcnn_ocr_tpu_torch.utils.profiling import span
from tests.test_torch_port_beam_engine import IMG_H, IMG_W, MAX_LEN, files  # noqa: F401
from tests.test_torch_port_serving import CANVAS, lines

IMAGES = lines(13, seed=22)
BATCH = 3
CALLER = ("serving.input_wait", "serving.dispatch", "serving.fetch", "serving.strings")


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def engine(files):
    ckpt, charset, _ = files
    return OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, img_h=IMG_H,
                        img_w=IMG_W)


def _serve_traced(engine, method):
    """One traced ``predict_serving``: (strings, stored spans, capture events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = engine.predict_serving(IMAGES, max_length=MAX_LEN, batch_size=BATCH,
                                     canvas=CANVAS, method=method)
    return got, profiling.spans(), list(prof.profiler.kineto_results.events())


@pytest.fixture(scope="module", params=["attention", "ctc_greedy"])
def served(request, engine):
    profiling.clear()
    out = _serve_traced(engine, request.param)
    profiling.clear()
    return request.param, out


# -- the gate ------------------------------------------------------------------


def test_without_a_profiler_a_span_records_nothing_and_never_opens_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) reached with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("off", rows=3):
        with span("off.inner", device=torch.device("cpu")):
            pass
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_the_gate_global_is_true_inside_a_capture_on_every_thread_and_false_after():
    assert autograd_profiler._is_profiler_enabled is False
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        seen.append(autograd_profiler._is_profiler_enabled)
        worker = threading.Thread(target=lambda: seen.append(
            autograd_profiler._is_profiler_enabled))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    assert seen == [True, True]
    assert autograd_profiler._is_profiler_enabled is False


def test_a_predict_serving_untraced_stores_nothing(engine):
    engine.predict_serving(IMAGES[:2], max_length=MAX_LEN, batch_size=BATCH, canvas=CANVAS)
    assert profiling.spans() == []


# -- the store -----------------------------------------------------------------


def test_spans_nest_by_thread_and_keep_their_counts_and_host_time():
    with profile(activities=[ProfilerActivity.CPU]):
        with span("outer", call=7):
            time.sleep(0.002)
            with span("inner", rows=3):
                time.sleep(0.001)
        other = threading.Thread(target=lambda: span("apart").__enter__().__exit__(None, None,
                                                                                   None))
        other.start()
        other.join(timeout=10)
    got = {r["name"]: r for r in profiling.spans()}
    assert got["outer"]["parent"] is None and got["outer"]["counts"] == {"call": 7}
    assert got["inner"]["parent"] == got["outer"]["id"] and got["inner"]["counts"] == {"rows": 3}
    assert got["apart"]["parent"] is None and got["apart"]["thread"] != got["outer"]["thread"]
    assert profiling.host_seconds("outer") >= profiling.host_seconds("inner") >= 0.001
    assert profiling.host_seconds("missing") is None
    # a range on the CPU is host time only
    assert profiling.device_seconds("outer") is None
    assert profiling.span_totals()["inner"] == {
        "count": 1, "host_s": profiling.host_seconds("inner"), "device_s": None}


def test_the_store_is_capped_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with span("s", i=i):
                pass
    assert [r["counts"]["i"] for r in profiling.spans()] == [0, 1, 2]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_totals_read_a_hand_filled_store(monkeypatch):
    records = [
        {"id": 0, "name": "rcnn.encode", "thread": 1, "parent": None, "start_ns": 0,
         "end_ns": 2_000_000, "counts": {}, "device_s": 0.25},
        {"id": 1, "name": "rcnn.encode", "thread": 1, "parent": None, "start_ns": 5_000_000,
         "end_ns": 6_000_000, "counts": {}, "device_s": 0.5},
        {"id": 2, "name": "rcnn.encode", "thread": 1, "parent": None, "start_ns": 7_000_000,
         "end_ns": None, "counts": {}, "device_s": None},  # still open
    ]
    monkeypatch.setattr(profiling, "spans", lambda: records)
    assert profiling.host_seconds("rcnn.encode") == pytest.approx(0.003)
    assert profiling.device_seconds("rcnn.encode") == pytest.approx(0.75)


# -- predict_serving's chunk spans ---------------------------------------------


def test_each_chunk_has_the_four_caller_spans_and_the_workers_letterbox(served):
    method, (got, records, _) = served
    assert len(got) == len(IMAGES)
    roots = [r for r in records if r["name"] == "serving.predict"]
    assert len(roots) == 1
    root = roots[0]
    call = root["counts"]["call"]
    assert root["counts"]["rows"] == len(IMAGES)
    n_chunks = -(-len(IMAGES) // BATCH)
    for k in range(n_chunks):
        chunk = [r for r in records if r["counts"].get("chunk") == k]
        assert all(r["counts"]["call"] == call for r in chunk)
        by_name = {}
        for r in chunk:
            by_name.setdefault(r["name"], []).append(r)
        for name in CALLER:
            (r,) = by_name[name]
            assert r["thread"] == root["thread"], name
            assert r["parent"] == root["id"], name
        (box,) = by_name["serving.letterbox"]
        assert box["thread"] != root["thread"] and box["parent"] is None
        real = min(BATCH, len(IMAGES) - k * BATCH)
        dispatch = by_name["serving.dispatch"][0]["counts"]
        assert dispatch == {"call": call, "chunk": k, "rows": BATCH}
        assert box["counts"]["rows"] == real
        assert by_name["serving.strings"][0]["counts"]["rows"] == real


def test_the_model_ranges_sit_in_dispatch_and_do_not_nest(served):
    method, (_, records, _) = served
    by_id = {r["id"]: r for r in records}
    n_chunks = -(-len(IMAGES) // BATCH)
    encodes = [r for r in records if r["name"] == "rcnn.encode"]
    decodes = [r for r in records if r["name"] == "rcnn.decode"]
    assert len(encodes) == n_chunks
    # the model's decode range and its extension over argmax / the greedy collapse
    assert len(decodes) == 2 * n_chunks
    for r in encodes + decodes:
        assert by_id[r["parent"]]["name"] == "serving.dispatch"
        assert r["device_s"] is None  # CPU: host time only
    for enc in encodes:
        after = [d for d in decodes if d["start_ns"] >= enc["end_ns"]
                 and d["parent"] == enc["parent"]]
        assert len(after) == 2, method


def test_the_caller_spans_cover_nine_tenths_of_the_call(served):
    _, (_, records, _) = served
    (root,) = [r for r in records if r["name"] == "serving.predict"]
    covered = sum(r["end_ns"] - r["start_ns"] for r in records if r["name"] in CALLER)
    assert covered >= 0.9 * (root["end_ns"] - root["start_ns"])


def test_each_caller_span_is_in_the_capture_within_a_millisecond_of_its_stored_start(served):
    """The store's clock is the capture's: the median offset between a stored
    start and its ``user_annotation``'s is under 1 ms, and each annotation
    starts while its stored span is open (give or take 1 ms; a thread may be
    switched out between the two readings, so no single offset is bounded)."""
    _, (_, records, events) = served
    offsets = []
    for name in CALLER + ("serving.predict",):
        stored = sorted((r["start_ns"], r["end_ns"]) for r in records if r["name"] == name)
        captured = sorted(e.start_ns() for e in events
                          if e.name() == name and profiling._activity(e) == "user_annotation")
        assert len(captured) == len(stored) > 0, name
        for (start, end), got in zip(stored, captured):
            assert start - 1_000_000 <= got <= end, name
            offsets.append(got - start)
    assert abs(float(np.median(offsets))) < 1_000_000


def test_the_worker_spans_are_stored_but_not_in_the_capture(served):
    _, (_, records, events) = served
    assert [r for r in records if r["name"] == "serving.letterbox"]
    assert not [e for e in events if e.name() == "serving.letterbox"]


# -- trace() -------------------------------------------------------------------


@pytest.mark.parametrize("intervals,want_ns", [
    ([("kernel", 0, 10), ("kernel", 5, 15)], 15),  # overlapping kernels once
    ([("kernel", 0, 10), ("gpu_memcpy", 20, 30), ("gpu_memset", 30, 31)], 21),  # copies count
    ([("kernel", 0, 100), ("kernel", 10, 20), ("gpu_memcpy", 50, 120)], 120),  # nested
    ([("kernel", 0, 10), ("gpu_user_annotation", 0, 500), ("cpu_op", 0, 900)], 10),  # not work
    ([("kernel", 40, 50), ("kernel", 0, 10), ("kernel", 8, 12)], 22),  # out of order
    ([], 0),
])
def test_busy_time_is_the_union_of_kernel_copy_and_memset_intervals(intervals, want_ns):
    assert profiling.busy_seconds(intervals) == pytest.approx(want_ns / 1e9)


def test_busy_time_matches_a_bitmap_of_random_intervals():
    rng = np.random.default_rng(24)
    kinds = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
    for _ in range(20):
        n = int(rng.integers(1, 40))
        starts = rng.integers(0, 1000, n)
        ivs = [(kinds[int(rng.integers(0, 4))], int(s), int(s + rng.integers(0, 200)))
               for s in starts]
        covered = np.zeros(1200, bool)
        for kind, s, e in ivs:
            if kind in profiling.DEVICE_ACTIVITIES:
                covered[s:e] = True
        assert profiling.busy_seconds(ivs) == pytest.approx(covered.sum() / 1e9)


class _Event:
    """A kineto event: its name, device and annotation flag, and no
    ``activity_type()``, which ``_activity`` does not read."""

    def __init__(self, name, cuda, annotation):
        self._name, self._cuda, self._annotation = name, cuda, annotation

    def name(self):
        return self._name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._annotation


@pytest.mark.parametrize("event,want", [
    (_Event("void se_scale_kernel<...>", True, False), "kernel"),
    (_Event("Memcpy HtoD (Pinned -> Device)", True, False), "gpu_memcpy"),
    (_Event("Memset (Device)", True, False), "gpu_memset"),
    (_Event("rcnn.encode", True, True), "gpu_user_annotation"),
    (_Event("rcnn.encode", False, True), "user_annotation"),
    (_Event("aten::conv2d", False, False), "cpu_op"),
    (_Event("Memcpy DtoH (Device -> Pinned)", True, False), "gpu_memcpy"),
    (_Event("serving.fetch", False, True), "user_annotation"),
])
def test_an_events_activity_with_and_without_activity_type(event, want):
    assert profiling._activity(event) == want


def test_the_installed_torchs_events_give_what_activity_reads():
    """A torch whose kineto events lose ``name``, ``device_type`` or
    ``is_user_annotation`` fails here, not silently in ``trace()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.span"):
            torch.ones(3).add_(1)
    kinds = {e.name(): profiling._activity(e) for e in prof.profiler.kineto_results.events()}
    assert kinds["test.span"] == "user_annotation" and kinds["aten::add_"] == "cpu_op"


def test_trace_empties_the_store_and_sums_its_spans(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with span("before"):
            pass
    with profiling.trace(str(tmp_path)) as summary:
        with span("inside", rows=2):
            time.sleep(0.001)
    assert [r["name"] for r in profiling.spans()] == ["inside"]
    got = summary.as_dict()
    assert got["spans"]["inside"]["count"] == 1 and got["spans"]["inside"]["host_s"] >= 0.001
    assert got["spans_dropped"] == 0 and got["device_busy_s"] is None
    assert (tmp_path / "profile_summary.txt").exists()
