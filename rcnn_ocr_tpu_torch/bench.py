"""Throughput benchmark of the port: batched greedy decodes on one card.

    python -m rcnn_ocr_tpu_torch.bench [--device cpu]

The port of the repository's ``bench.py``: the same rows, timed the same
way, printed as one JSON line with the same keys (:data:`JSON_KEYS`) and
the same ``[bench] ...`` summary on stderr.  It runs the shipped model
(32x128 lines, 194 classes, hidden 256, ``max_len`` 25 decoder steps,
both heads, bf16) with seeded random weights at batch 2048 (64x256 at
512):

* CTC greedy (logits, then :func:`~rcnn_ocr_tpu_torch.ops.ctc.ctc_greedy_decode`)
  in bf16, in int8 with per-call activation scales and in int8 with
  static scales calibrated on rendered text lines;
* attention greedy (logits, then argmax) in bf16 and static int8;
* the device CTC beam (W 16 over the top-16 classes of each frame), int8
  static;
* latency at batch 1 / 8 / 64 (static int8 CTC greedy reduced to one
  scalar, 50 calls after 5 warm-up calls) less the dispatch floor (50
  calls of ``x + 1`` on a 0-d tensor);
* the 64x256 geometry at batch 512, static int8 and bf16.

A row's time is ``bench.py``'s: 3 warm-up calls, then 20 calls back to back
under ``time.perf_counter``, ended by one copy of the last output to the
host (after ``torch.cuda.synchronize``).  On the card every encode
launches the hand-written squeeze-excite (11) and BiLSTM (2) kernels:
unlike ``bench.py``, which turns its Pallas kernels off for XLA's fusion
(``use_pallas=False``), the port has no such switch and measures the path
its users run.  No row is skipped: a failed build or launch fails the run.

The static scales come from rendered lines as ``bench.py`` takes them: the
port's synthetic generator (``discover_fonts``, else the DejaVuSans font
the tests carry, which only a checkout of the repository holds, else
Gaussian noise, named in ``calibration_input``).

The card is the default device and it raises without one; ``--device cpu``
(batch 8, 64x256 at 4) is for tests.  :func:`run` returns the JSON fields
and the launch counts of each row, for ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rcnn_ocr_tpu_torch.inference import resolve_device
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_params
from rcnn_ocr_tpu_torch.models.seresnet31 import recording_act_absmax
from rcnn_ocr_tpu_torch.ops import kernels
from rcnn_ocr_tpu_torch.ops.ctc import ctc_beam_search_device, ctc_greedy_decode, ctc_top_frames

BASELINE_IMGS_PER_SEC = 20_000.0
# the keys of bench.py's JSON line, in its order (a test holds them to its source)
JSON_KEYS = ("metric", "value", "unit", "vs_baseline", "ctc_greedy_bf16_img_s",
             "ctc_greedy_int8_img_s", "ctc_greedy_int8_static_img_s", "attn_greedy_img_s",
             "attn_greedy_int8_static_img_s", "ctc_beam16_int8_static_img_s", "latency_bs1_ms",
             "latency_bs8_ms", "latency_bs64_ms", "dispatch_floor_ms", "img_s_64x256",
             "img_s_64x256_bf16", "batch_64x256", "calibration_input", "platform")
IMG_H, IMG_W, BIG_H, BIG_W = 32, 128, 64, 256
MAX_LEN, BLANK, BEAM, CALIB_LINES = 25, 0, 16, 256
# device type -> (batch at 32x128, batch at 64x256)
BATCHES = {"cuda": (2048, 512), "cpu": (8, 4)}
SHIPPED = dict(num_classes=194, hidden_size=256, sos_id=1, eos_id=2, pad_id=0, blank_id=None,
               with_ctc_head=True, dtype=torch.bfloat16)
# found only in a checkout of the repository; without it an installed package
# falls back to noise calibration (``calibration_input`` says which)
CARRIED_FONT = (Path(__file__).resolve().parents[1] / "tests" / "torch_port_data" / "fonts"
                / "DejaVuSans.ttf")


# --- the rows: bench.py's jitted functions --------------------------------------------------

def ctc_greedy(model: RCNN, images: torch.Tensor):
    """CTC logits, then the greedy collapse: ``(tokens [B, T], valid [B])``."""
    return ctc_greedy_decode(model.ctc_logits(images), BLANK)


def attn_greedy(model: RCNN, images: torch.Tensor) -> torch.Tensor:
    """Attention greedy decoding: the argmax of its logits ``[B, MAX_LEN + 1]``."""
    return torch.argmax(model(images, batch_max_length=MAX_LEN), dim=-1)


def ctc_beam16(model: RCNN, images: torch.Tensor):
    """log-softmax, the top 16 classes of each frame, the device prefix beam
    of width 16: ``(labels [B, T], lengths [B])``."""
    vals, idx = ctc_top_frames(model.ctc_logits(images), BEAM)
    labels, lengths, _ = ctc_beam_search_device(vals, idx, blank_id=BLANK, beam_width=BEAM)
    return labels, lengths


def ctc_greedy_scalar(model: RCNN, images: torch.Tensor) -> torch.Tensor:
    """CTC greedy reduced to one scalar: the compute stays, the fetch is one int."""
    tokens, valid = ctc_greedy(model, images)
    return tokens.sum() + valid.sum()


def null_op(x: torch.Tensor) -> torch.Tensor:
    return x + 1


# --- timing -------------------------------------------------------------------------------

def _fetch(out):
    """One copy of ``out`` to the host, after the card has finished."""
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    if leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)
    return [t.cpu() for t in leaves]


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> float:
    """Seconds a call: ``bench.py:_time_fn`` (wall clock over back-to-back calls)."""
    with torch.inference_mode():
        for _ in range(warmup):
            out = fn(*args)
        _fetch(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _fetch(out)
    return (time.perf_counter() - t0) / iters


# --- models and inputs --------------------------------------------------------------------

def build_models(device: torch.device, seed: int = 0, **overrides) -> Tuple[RCNN, RCNN, RCNN]:
    """bf16, dynamic int8 and static int8 models over one set of seeded
    weights (the int8 convs quantize the same fp32 weights per call)."""
    common = {**SHIPPED, **overrides}
    model = RCNN(**common)
    init_params(model, torch.Generator().manual_seed(seed))
    model_q = RCNN(**common, quantize=True)
    model_q.load_state_dict(model.state_dict())
    model_qs = RCNN(**common, quantize=True, act_quant="static")
    missing, unexpected = model_qs.load_state_dict(model.state_dict(), strict=False)
    if unexpected or any(not k.endswith("act_absmax") for k in missing):
        raise RuntimeError(f"static int8 model does not fit: {missing}, {unexpected}")
    return tuple(m.to(device).eval() for m in (model, model_q, model_qs))


def render_calibration_batch(batch: int, img_h: int, img_w: int,
                             seed: int = 0) -> Tuple[np.ndarray, str]:
    """Rendered text lines ``[batch, img_h, img_w, 3]`` in [-1, 1] for the
    static scales (``bench.py:_render_calibration_batch``): the system's
    fonts, else the carried DejaVuSans, else Gaussian noise."""
    from rcnn_ocr_tpu_torch.data.synthetic import discover_fonts, render_line, sample_texts
    from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad, normalize_unit

    fonts = discover_fonts() or ([str(CARRIED_FONT)] if CARRIED_FONT.is_file() else [])
    if not fonts:
        print("[bench] calibration render unavailable (no fonts); using noise", file=sys.stderr)
        rng = np.random.default_rng(seed)
        return rng.normal(size=(batch, img_h, img_w, 3)).astype(np.float32), "noise"
    rng = np.random.default_rng(seed)
    texts = sample_texts(batch, rng, max_len=18)
    pad = ResizeAndPad(img_h=img_h, img_w=img_w)
    rows = [normalize_unit(pad(render_line(t, fonts[i % len(fonts)], img_h=img_h,
                                           rng=np.random.default_rng([seed, i]),
                                           difficulty="medium")))
            for i, t in enumerate(texts)]
    return np.stack(rows).astype(np.float32), "rendered"


def calibrate(model_qs: RCNN, images: torch.Tensor) -> None:
    """Record the static int8 model's activation abs-maxes on ``images``
    (JAX's ``mutable=["quant_stats"]`` pass over ``encode``)."""
    with torch.inference_mode(), recording_act_absmax(model_qs):
        model_qs.encode(images)


def _noise(shape, seed: int, device: torch.device) -> torch.Tensor:
    arr = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(arr).to(device)


# --- the run ------------------------------------------------------------------------------

def run(device="cuda", *, iters: int = 20, warmup: int = 3) -> Tuple[dict, dict]:
    """Every row of the benchmark.  Returns ``(line, details)``: ``line`` the
    JSON line's fields, ``details`` per row the encodes it ran and the
    kernel launches they made (``kernels.launch_counts()`` before and
    after), the peak device memory and the seconds of each step."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    platform = "gpu" if on_card else dev.type
    batch, big_batch = BATCHES[dev.type]
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    rows: Dict[str, dict] = {}
    t_start = time.perf_counter()

    def counted(name: str, encodes: int, rows_in: int, call: Callable):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        result = call()
        after = kernels.launch_counts()
        rows[name] = {"encodes": encodes, "batch": rows_in, "seconds": time.perf_counter() - t0,
                      "launches": {k: after[k] - before.get(k, 0) for k in after}}
        return result

    def timed(name: str, fn: Callable, model: RCNN, images: torch.Tensor, n_iters: int = iters,
              n_warm: int = warmup) -> float:
        return counted(name, n_iters + n_warm, int(images.shape[0]),
                       lambda: time_fn(fn, model, images, iters=n_iters, warmup=n_warm))

    model, model_q, model_qs = build_models(dev)
    images = _noise((batch, IMG_H, IMG_W, 3), 0, dev)
    ctc_ips = batch / timed("ctc_greedy_bf16", ctc_greedy, model, images)
    q_ips = batch / timed("ctc_greedy_int8", ctc_greedy, model_q, images)
    t0 = time.perf_counter()
    calib_np, calib_kind = render_calibration_batch(min(batch, CALIB_LINES), IMG_H, IMG_W)
    render_s = time.perf_counter() - t0
    calib = torch.from_numpy(np.resize(calib_np, (batch, IMG_H, IMG_W, 3))).to(dev)
    counted("calibration", 1, batch, lambda: calibrate(model_qs, calib))
    rows["calibration"]["render_s"] = render_s
    del calib
    qs_ips = batch / timed("ctc_greedy_int8_static", ctc_greedy, model_qs, images)
    attn_ips = batch / timed("attn_greedy", attn_greedy, model, images)
    attn_qs_ips = batch / timed("attn_greedy_int8_static", attn_greedy, model_qs, images)
    beam_ips = batch / timed("ctc_beam16_int8_static", ctc_beam16, model_qs, images)
    del images

    one = torch.zeros((), dtype=torch.int32, device=dev)
    floor_s = time_fn(null_op, one, iters=50, warmup=5)
    lat_ms = {}
    for lb in (1, 8, 64):
        x_small = _noise((lb, IMG_H, IMG_W, 3), lb, dev)
        dt = timed(f"latency_bs{lb}", ctc_greedy_scalar, model_qs, x_small, 50, 5)
        lat_ms[lb] = max(dt - floor_s, 0.0) * 1e3

    images_big = _noise((big_batch, BIG_H, BIG_W, 3), 3, dev)
    big_qs_ips = big_batch / timed("64x256_int8_static", ctc_greedy, model_qs, images_big)
    big_bf16_ips = big_batch / timed("64x256_bf16", ctc_greedy, model, images_big)
    del images_big

    best_ips, best_path = max((ctc_ips, "bf16"), (q_ips, "int8 serving path"),
                              (qs_ips, "int8-static serving path"))
    print(f"[bench] platform={platform} batch={batch} "
          f"ctc_greedy_int8_static={qs_ips:,.0f} img/s  "
          f"ctc_greedy_int8={q_ips:,.0f} img/s  ctc_greedy_bf16={ctc_ips:,.0f} img/s  "
          f"attn_greedy={attn_ips:,.0f} img/s  "
          f"attn_greedy_int8_static={attn_qs_ips:,.0f} img/s  "
          f"ctc_beam16_int8_static={beam_ips:,.0f} img/s  "
          f"latency(bs1/8/64)={lat_ms[1]:.2f}/{lat_ms[8]:.2f}/{lat_ms[64]:.2f} ms "
          f"(floor {floor_s * 1e3:.2f} ms)  "
          f"64x256 bs{big_batch}: int8-static={big_qs_ips:,.0f} "
          f"bf16={big_bf16_ips:,.0f} img/s  calib={calib_kind}", file=sys.stderr)
    line = {
        "metric": "line-images/sec/chip (greedy CTC decode, 32x128, bs%d, %s)"
                  % (batch, best_path),
        "value": round(best_ips, 1),
        "unit": "img/s",
        "vs_baseline": round(best_ips / BASELINE_IMGS_PER_SEC, 4),
        "ctc_greedy_bf16_img_s": round(ctc_ips, 1),
        "ctc_greedy_int8_img_s": round(q_ips, 1),
        "ctc_greedy_int8_static_img_s": round(qs_ips, 1),
        "attn_greedy_img_s": round(attn_ips, 1),
        "attn_greedy_int8_static_img_s": round(attn_qs_ips, 1),
        "ctc_beam16_int8_static_img_s": round(beam_ips, 1),
        "latency_bs1_ms": round(lat_ms[1], 3),
        "latency_bs8_ms": round(lat_ms[8], 3),
        "latency_bs64_ms": round(lat_ms[64], 3),
        "dispatch_floor_ms": round(floor_s * 1e3, 3),
        "img_s_64x256": round(big_qs_ips, 1),
        "img_s_64x256_bf16": round(big_bf16_ips, 1),
        "batch_64x256": big_batch,
        "calibration_input": calib_kind,
        "platform": platform,
    }
    details = {"rows": rows, "seconds": time.perf_counter() - t_start,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if on_card else None}
    return line, details


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0",
                    help="the card (default) or 'cpu', for tests (batch 8)")
    args = ap.parse_args(argv)
    line, details = run(args.device)
    peak = details["peak_memory_bytes"]
    if peak is not None:
        print(f"[bench] peak device memory {peak / 2**30:.2f} GiB "
              "(torch.cuda.max_memory_allocated)", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
