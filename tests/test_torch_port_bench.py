"""The port's throughput benchmark (``rcnn_ocr_tpu_torch/bench.py``) vs the
repository's ``bench.py``, on the CPU.

* Its JSON keys are ``bench.py``'s, read from that file's ``json.dumps``
  call with ``ast`` (``bench.py`` is not imported).
* Its rows on a tiny model (width 0.125, hidden 32, fp32) with JAX's
  weights carried by ``interop/jax_params.py``: CTC greedy (float, dynamic
  and static int8), attention greedy and the device CTC beam (W 16 over
  the top 16) give JAX's compositions' tokens, valid counts, labels and
  lengths exactly on one numpy batch; the static scales the bench records
  on rendered lines equal JAX's ``quant_stats`` on the same lines (rtol
  1e-5).
* Its entry point at the tiny model (2 timed calls after 1 warm-up) prints
  one JSON line of every key with finite, positive rates and
  ``platform == "cpu"``; without ``--device`` and without a card it raises.
"""

import ast
import functools
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rcnn_ocr_tpu.models import RCNN as JaxRCNN  # noqa: E402
from rcnn_ocr_tpu.ops.ctc import ctc_beam_search_jax, ctc_greedy_decode_jnp  # noqa: E402
from rcnn_ocr_tpu_torch import bench  # noqa: E402
from rcnn_ocr_tpu_torch.interop.jax_params import (  # noqa: E402
    load_jax_variables, to_jax_variables)
from rcnn_ocr_tpu_torch.models.rcnn import RCNN  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(num_classes=194, hidden_size=32, sos_id=1, eos_id=2, pad_id=0, blank_id=None,
            with_ctc_head=True, width_mult=0.125)


def _bench_py_keys():
    """The keys of the dict literal passed to ``json.dumps`` in ``bench.py``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return tuple(k.value for k in node.args[0].keys)
    raise AssertionError("bench.py has no json.dumps of a dict literal")


def test_json_keys_are_bench_pys():
    keys = _bench_py_keys()
    assert len(keys) == 19 and keys == bench.JSON_KEYS


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """JAX's tiny float, dynamic and static int8 models on one set of
    variables, the static scales calibrated on rendered lines, and the
    images the rows run on."""
    x = np.random.default_rng(0).normal(size=(8, bench.IMG_H, bench.IMG_W, 3)).astype(np.float32)
    calib, kind = bench.render_calibration_batch(8, bench.IMG_H, bench.IMG_W)
    assert kind == "rendered"
    common = dict(TINY, ctc_blank_id=0, dtype=jnp.float32)
    model, model_q = JaxRCNN(**common), JaxRCNN(**common, quantize=True)
    model_qs = JaxRCNN(**common, quantize=True, act_quant="static")
    v = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 32, 128, 3)),
                   text=jnp.zeros((2, bench.MAX_LEN + 1), jnp.int32),
                   batch_max_length=bench.MAX_LEN, method=model.init_all)
    _, mut = model_qs.apply(v, jnp.asarray(calib), train=False, method=model_qs.encode,
                            mutable=["quant_stats"])
    v_qs = {**v, "quant_stats": mut["quant_stats"]}
    return x, calib, (model, model_q, model_qs), v, v_qs


def _jax_rows():
    x, _, (model, model_q, model_qs), v, v_qs = _jax_setup()
    xj = jnp.asarray(x)

    def greedy(m, var):
        return ctc_greedy_decode_jnp(m.apply(var, xj, train=False, method=m.ctc_logits), 0)

    logits = model_qs.apply(v_qs, xj, train=False, method=model_qs.ctc_logits)
    vals, idx = jax.lax.top_k(jax.nn.log_softmax(logits, axis=-1), 16)
    labels, lens, _ = ctc_beam_search_jax(vals, idx.astype(jnp.int32), blank_id=0, beam_width=16)
    return {
        "ctc_greedy_bf16": greedy(model, v),
        "ctc_greedy_int8": greedy(model_q, v),
        "ctc_greedy_int8_static": greedy(model_qs, v_qs),
        "attn_greedy": jnp.argmax(model.apply(v, xj, train=False,
                                              batch_max_length=bench.MAX_LEN), -1),
        "attn_greedy_int8_static": jnp.argmax(model_qs.apply(
            v_qs, xj, train=False, batch_max_length=bench.MAX_LEN), -1),
        "ctc_beam16_int8_static": (labels, lens),
    }


def _port_models(v, v_qs):
    host = jax.tree_util.tree_map(np.asarray, v)
    model = load_jax_variables(RCNN(**TINY).eval(), host)
    model_q = load_jax_variables(RCNN(**TINY, quantize=True).eval(), host)
    model_qs = load_jax_variables(RCNN(**TINY, quantize=True, act_quant="static").eval(),
                                  jax.tree_util.tree_map(np.asarray, v_qs))
    return model, model_q, model_qs


def test_rows_give_jaxs_compositions_exactly():
    x, _, _, v, v_qs = _jax_setup()
    model, model_q, model_qs = _port_models(v, v_qs)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        port = {
            "ctc_greedy_bf16": bench.ctc_greedy(model, xt),
            "ctc_greedy_int8": bench.ctc_greedy(model_q, xt),
            "ctc_greedy_int8_static": bench.ctc_greedy(model_qs, xt),
            "attn_greedy": bench.attn_greedy(model, xt),
            "attn_greedy_int8_static": bench.attn_greedy(model_qs, xt),
            "ctc_beam16_int8_static": bench.ctc_beam16(model_qs, xt),
            "scalar": bench.ctc_greedy_scalar(model_qs, xt),
        }
    want = _jax_rows()
    for name, ref in want.items():
        got = port[name]
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    tokens, valid = want["ctc_greedy_int8_static"]
    assert int(port["scalar"]) == int(np.asarray(tokens).sum() + np.asarray(valid).sum())
    assert int(np.asarray(valid).sum()) > 0


def test_static_scales_on_rendered_lines_are_jaxs():
    _, calib, _, v, v_qs = _jax_setup()
    model_qs = _port_models(v, v_qs)[2]
    with torch.no_grad():
        for name, buf in model_qs.named_buffers():
            if name.endswith("act_absmax"):
                buf.zero_()
    bench.calibrate(model_qs, torch.from_numpy(calib))
    got = jax.tree_util.tree_leaves(to_jax_variables(model_qs)["quant_stats"])
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, v_qs["quant_stats"]))
    assert len(got) == len(want) == 24 and all(float(w) > 0 for w in want)
    np.testing.assert_allclose(np.array(got, np.float64), np.array(want, np.float64), rtol=1e-5)


def test_models_share_the_seeded_weights():
    model, model_q, model_qs = bench.build_models(torch.device("cpu"), width_mult=0.125,
                                                  hidden_size=32, dtype=torch.float32)
    ref = model.state_dict()
    for m in (model_q, model_qs):
        for k, t in m.state_dict().items():
            if k.endswith("act_absmax"):
                assert float(t) == 0.0
            else:
                assert torch.equal(t, ref[k]), k
    assert model_qs.cnn.layer1_block0.conv1.conv.act_absmax is not None


def test_entry_prints_one_json_line_of_every_key(monkeypatch, capsys):
    monkeypatch.setattr(bench, "SHIPPED", dict(bench.SHIPPED, width_mult=0.125, hidden_size=32,
                                               dtype=torch.float32))
    monkeypatch.setattr(bench, "run", functools.partial(bench.run, iters=2, warmup=1))
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert tuple(line) == bench.JSON_KEYS
    assert line["platform"] == "cpu" and line["unit"] == "img/s"
    assert line["calibration_input"] == "rendered" and line["batch_64x256"] == 4
    rates = [k for k in bench.JSON_KEYS if k.endswith("img_s") or k.startswith("img_s")]
    assert len(rates) == 8
    for k in rates + ["value"]:
        assert math.isfinite(line[k]) and line[k] > 0, k
    for k in ("latency_bs1_ms", "latency_bs8_ms", "latency_bs64_ms", "dispatch_floor_ms"):
        assert math.isfinite(line[k]) and line[k] >= 0, k
    assert "bs8" in line["metric"] and line["value"] == max(
        line["ctc_greedy_bf16_img_s"], line["ctc_greedy_int8_img_s"],
        line["ctc_greedy_int8_static_img_s"])
    assert "[bench] platform=cpu batch=8" in err


def test_without_a_card_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])


def test_the_card_smoke_holds_each_kernel_at_every_shape_the_bench_gives_it(monkeypatch):
    """The shapes and dtypes one encode of the shipped model gives K1 and
    K2 at each geometry (recorded on the CPU at batch 1), at each batch the
    bench runs on the card, are all among those the smoke's kernel phase
    holds against the plain versions."""
    import chip_smoke
    from rcnn_ocr_tpu_torch.models import seresnet31
    from rcnn_ocr_tpu_torch.ops import bilstm_scan

    seen = set()
    se, scan = seresnet31.se_scale, bilstm_scan.bilstm_scan
    monkeypatch.setattr(seresnet31, "se_scale", lambda x, w1, w2: (
        seen.add(("se", tuple(x.shape[1:]), x.dtype)), se(x, w1, w2))[1])
    monkeypatch.setattr(bilstm_scan, "bilstm_scan", lambda xs, w, h: (
        seen.add(("scan", xs.shape[0], xs.shape[3], w.dtype)), scan(xs, w, h))[1])
    model, model_q, model_qs = bench.build_models(torch.device("cpu"))
    big, big_batch = (bench.BIG_H, bench.BIG_W), bench.BATCHES["cuda"][1]
    given = set()
    for (h, w), batches in (((bench.IMG_H, bench.IMG_W), (bench.BATCHES["cuda"][0], 1, 8, 64)),
                            (big, (big_batch,))):
        seen.clear()
        with torch.inference_mode():
            for m in (model, model_q):
                bench.ctc_greedy(m, torch.zeros(1, h, w, 3))
        assert len(seen) == 3, seen
        given |= {(b, *key) for b in batches for key in seen}
    held = {(b, "se", hwc, torch.bfloat16) for _, hwc in chip_smoke.SE_SHAPES
            for b in (chip_smoke.TRAIN_BATCH, chip_smoke.BATCH, chip_smoke.BIG_BATCH)}
    held |= {(b, "se", tuple(hwc), torch.bfloat16) for (b, *hwc), _ in chip_smoke.BENCH_SE}
    held |= {(b, "scan", chip_smoke.LSTM_T, 4 * chip_smoke.HIDDEN, torch.bfloat16)
             for b in (chip_smoke.TRAIN_BATCH, chip_smoke.BATCH, chip_smoke.BIG_BATCH)}
    held |= {(b, "scan", t, 4 * chip_smoke.HIDDEN, torch.bfloat16)
             for t, b in chip_smoke.BENCH_LSTM}
    assert given <= held, sorted(map(str, given - held))
