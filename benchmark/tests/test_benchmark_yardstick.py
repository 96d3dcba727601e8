"""The yardstick: operations and bytes from shapes against the reference at
a small size, and the device's busy time as a union of intervals."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, trace
from benchmark.reference import rcnn
from benchmark.weights import make_weights

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def _itos(cfg):
    return [t for t in (CONFIGS / cfg["charset"]).read_text(encoding="utf-8").split("\n") if t]


@pytest.mark.parametrize("name", ["rcnn_shipped_32x128", "rcnn_default_64x256"])
def test_operations_match_the_flop_counter_on_the_reference(name):
    cfg = _cfg(name)
    W = make_weights(cfg, _itos(cfg), 3, "cpu")
    x = torch.rand(2, cfg["img_h"], cfg["img_w"], 3) * 2 - 1
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        enc = rcnn.encode(W, x, cfg)
    assert fc.get_total_flops() == 2 * flops.encode_flops(cfg)
    assert enc.shape == (2, rcnn.frames(cfg), cfg["hidden_size"])
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        rcnn.ctc_logits(W, enc)
    assert fc.get_total_flops() == 2 * flops.head_flops(cfg, "ctc", 0)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        rcnn.attention_logits(W, enc, torch.ones(2, 7, dtype=torch.long), cfg["hidden_size"])
    assert fc.get_total_flops() == 2 * flops.head_flops(cfg, "attention", 7)


def test_conv_bytes_are_the_reference_convs_inputs_weights_and_outputs():
    cfg = _cfg("rcnn_shipped_32x128")
    W = make_weights(cfg, _itos(cfg), 3, "cpu")
    seen = []
    real_conv = torch.nn.functional.conv2d

    def conv(x, w, b, stride, padding):
        y = real_conv(x, w, b, stride, padding)
        seen.append(flops.BF16 * (x.numel() + w.numel() + y.numel()))
        return y

    torch.nn.functional.conv2d = conv
    try:
        with torch.no_grad():
            rcnn.backbone(W, torch.zeros(3, 32, 128, 3))
    finally:
        torch.nn.functional.conv2d = real_conv
    assert seen == [b for _, b in flops.conv_calls(cfg, 3)]


def test_least_time_takes_the_longer_of_operations_and_bytes():
    peaks = {"flops": 100.0, "bytes_per_s": 10.0}
    assert flops.least_seconds([(200, 10), (100, 50)], peaks) == 2.0 + 5.0


def test_a_roofline_of_the_least_time_reads_100_percent():
    cfg = _cfg("rcnn_default_64x256")
    peaks = {"flops": {"bfloat16": 1e15}, "bytes_per_s": 3e12}
    least = 4 * flops.least_seconds(flops.se_calls(cfg, 512), {"flops": 1e15, "bytes_per_s": 3e12})
    ctx = {"peaks": peaks, "config": cfg, "class_seconds": {"k1": least}, "encodes": {512: 4}}
    assert flops.roofline_share(ctx, "k1") == pytest.approx(100.0)
    assert flops.roofline_share(dict(ctx, class_seconds={"k1": 0.0}), "k1") is None
    assert flops.roofline_share(dict(ctx, peaks=None), "k1") is None


class Event:
    def __init__(self, name, kind, start, end):
        self._n, self._k, self._s, self._e = name, kind, start, end

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def device_type(self):
        return torch.autograd.DeviceType.CPU if self._k in ("cpu_op", "user_annotation") \
            else torch.autograd.DeviceType.CUDA

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s


def test_busy_time_is_the_union_of_device_intervals():
    events = [Event(trace.WINDOW, "user_annotation", 0, 1000),
              Event("predict_serving", "user_annotation", 0, 1000),
              Event("aten::item", "cpu_op", 640, 900),
              # two overlapping kernels on two streams count once; a copy counts
              Event("void se_cluster_kernel<bf16>", "kernel", 100, 300),
              Event("sm90_xmma_fprop_implicit_gemm_bf16", "kernel", 200, 400),
              Event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 500, 600),
              # clipped to the window
              Event("bilstm_resident_kernel", "kernel", 950, 1200)]
    got = trace.reduce(events)
    assert got["window_s"] == pytest.approx(1e-6)
    assert got["busy_s"] == pytest.approx((300 + 100 + 50) * 1e-9)
    assert got["class_seconds"] == pytest.approx({"conv": 200e-9, "k1": 200e-9, "k2": 50e-9})
    gaps = got["breakdown"]["idle_gaps"]
    assert gaps[0] == ["aten::item", pytest.approx(350e-9)]
    assert [g[1] for g in gaps] == pytest.approx([350e-9, 100e-9, 100e-9])
    assert got["breakdown"]["device_ops"][0][1] == pytest.approx(200e-9)


def test_union_merges_nested_and_touching_intervals():
    busy, merged = trace.union_seconds(np.array([[0, 10], [2, 3], [10, 12], [20, 25]]))
    assert busy == pytest.approx(17e-9)
    assert merged.tolist() == [[0, 12], [20, 25]]


class OldEvent(Event):
    """An event as older PyTorch gives it: no ``activity_type``; spans and
    their mirror on the device tell themselves by ``is_user_annotation``."""

    activity_type = property(lambda self: (_ for _ in ()).throw(AttributeError))

    def __init__(self, name, kind, start, end):
        super().__init__(name, kind, start, end)

    def is_user_annotation(self):
        return self._k in ("user_annotation", "gpu_user_annotation")

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._k in ("kernel", "gpu_memcpy",
                                                            "gpu_user_annotation") \
            else torch.autograd.DeviceType.CPU


def test_events_without_an_activity_type_reduce_alike():
    events = [OldEvent(trace.WINDOW, "user_annotation", 0, 1000),
              OldEvent("predict_serving", "gpu_user_annotation", 0, 1000),
              OldEvent("aten::item", "cpu_op", 640, 900),
              OldEvent("void se_cluster_kernel<bf16>", "kernel", 100, 300),
              OldEvent("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 500, 600)]
    assert not hasattr(events[0], "activity_type")
    got = trace.reduce(events)
    assert got["busy_s"] == pytest.approx(300e-9)
    assert got["breakdown"]["idle_gaps"][0] == ["aten::item", pytest.approx(400e-9)]


def test_batch_norm_calibration_normalizes_each_conv_on_its_lines():
    from benchmark import traffic
    from benchmark.weights import calibrate_batch_norm

    cfg = _cfg("rcnn_shipped_32x128")
    W = make_weights(cfg, _itos(cfg), 3, "cpu")
    spec = json.loads((CONFIGS.parent / "workloads" / "bulk_attn.shipped32.json").read_text())
    lines = traffic.make_lines(dict(spec["lines"], n_lines=6), 9)
    calibrate_batch_norm(W, cfg, lines, "cpu")
    from benchmark.reference import preprocess
    x = torch.from_numpy(preprocess.model_input(lines, 32, 128)).permute(0, 3, 1, 2)
    y = rcnn._conv_bn(W, "stem0", x, 1, 1, False)
    assert y.mean(dim=(0, 2, 3)).abs().max() < 1e-4
    assert (y.var(dim=(0, 2, 3), unbiased=False) - 1).abs().max() < 1e-2
    assert W["batch_stats/cnn/out1/bn/var"].shape == (512,)
