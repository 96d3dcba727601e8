"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py [--json-out PATH]

1. Prints the card (name and power limit from nvidia-smi, torch's device name
   and count) and turns TF32 off for matmuls and convolutions, so that the
   fp32 comparisons below compare fp32 arithmetic.
2. Builds every CUDA kernel of the port from ``rcnn_ocr_tpu_torch/csrc``
   (one nvcc per source, in parallel) and prints build times and ptxas
   register / shared-memory lines.
3. Kernel phase: each kernel against its plain PyTorch version at the
   shapes of the main path (32x128 lines, width 1.0, hidden 256), in fp32
   and bf16 at batch 256, then CUDA-event times of kernel, plain version and
   library yardstick at batch 256 and 2048.
4. Main path: a seeded full-width model (width 1.0, hidden 256, 194 classes
   from configs/charset.txt, both heads) handed through ``to_jax_variables``
   to the public ``OCRInference``, which decodes 512 seeded uint8 line
   images of mixed sizes with ``predict`` (attention greedy) and
   ``predict_ctc`` (CTC greedy) at batch 256 in bf16.  The launch counters,
   zeroed just before and read just after, must show 11 squeeze-excite and
   2 BiLSTM launches per encoded batch.  Then the same batches run in fp32
   through the kernels and through the plain versions: encoder states and
   CTC logits must agree within tolerance, CTC tokens on every row and
   attention greedy tokens on at least 99% of rows.

Prints one ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``.  Any failed check raises and exits non-zero
before the last line.  Exits non-zero without a result when no CUDA device
is present or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM published peaks (dense): HBM bytes/s, fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

IMG_H, IMG_W, HIDDEN, WIDTH = 32, 128, 256, 1.0
SE_SHAPES = ((3, (8, 32, 256)), (8, (4, 16, 512)))  # (calls per encode, per-sample H, W, C)
LSTM_T, LSTM_D = IMG_W // 8, 512
BATCH, BIG_BATCH, N_IMAGES, MAX_LENGTH = 256, 2048, 512, 25

TOL = {
    # kernel vs plain, same inputs; fp32: summation order only
    "fp32": dict(rtol=1e-5, atol=1e-5),
    # bf16 outputs: one bf16 ulp relative, from a gate that rounds the other way
    "bf16": dict(rtol=8e-3, atol=1e-6),
    # main path, fp32 with kernels vs plain versions: the CPU parity
    # tolerances for encoder states and logits (tests/test_torch_port_model.py)
    "enc": dict(rtol=1e-4, atol=2e-4),
    "logits": dict(rtol=1e-3, atol=5e-4),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def held(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str) -> float:
    """Max abs error of ``got`` vs ``want``; raises beyond ``atol + rtol*|want|``."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - want).abs()
    excess = (err - (atol + rtol * want.abs())).max().item()
    max_abs = err.max().item()
    print(f"  {what}: max abs err {max_abs:.3e} (rtol {rtol}, atol {atol})")
    check(excess <= 0, f"{what}: outside rtol {rtol} / atol {atol} (max abs err {max_abs:.3e})")
    return max_abs


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build(kernels) -> None:
    t0 = time.perf_counter()
    kernels.build_all(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {len(kernels.KERNELS)} kernels")
    for k in kernels.KERNELS.values():
        print(f"  {k.name}: nvcc {k.build_seconds:.1f} s -> {k.library.name}")
        for line in k.build_log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"    {line.strip()}")


def kernel_phase(gen: torch.Generator):
    from rcnn_ocr_tpu_torch.ops.bilstm_scan import bilstm_scan, scan_reference
    from rcnn_ocr_tpu_torch.ops.se_scale import se_scale, se_scale_reference

    dev = "cuda"
    rows = []

    # --- K1: squeeze-excite at both main-path shapes
    se = dict(name="se_scale", route="cuda", source="rcnn_ocr_tpu_torch/csrc/se_scale.cu",
              replaces="rcnn_ocr_tpu/ops/se_pallas.py:61", launches_per_encode=11,
              dtype="bfloat16", batch=BATCH, bound_by="bytes", library_ms=None,
              library_call="none (no single PyTorch call computes it)", calls=[])
    errs, ms, plain_ms, bound_ms = [], 0.0, 0.0, 0.0
    for n_calls, (h, w, c) in SE_SHAPES:
        s = c // 16
        w1 = torch.randn(c, s, device=dev, generator=gen) / c ** 0.5
        w2 = torch.randn(s, c, device=dev, generator=gen) / s ** 0.5
        for dt, tol in ((torch.float32, TOL["fp32"]), (torch.bfloat16, TOL["bf16"])):
            name = "fp32" if dt == torch.float32 else "bf16"
            x = torch.randn(BATCH, h, w, c, device=dev, generator=gen).to(dt)
            err = held(se_scale(x, w1, w2), se_scale_reference(x, w1, w2), what=
                       f"se_scale [{BATCH},{h},{w},{c}] {name} vs plain", **tol)
            errs.append(err)
            for b in (BATCH, BIG_BATCH):
                xb = x if b == BATCH else torch.randn(b, h, w, c, device=dev, generator=gen).to(dt)
                nbytes = 2 * xb.numel() * xb.element_size() + 2 * c * s * 4
                call = dict(shape=[b, h, w, c], dtype=name, per_encode=n_calls,
                            ms=time_ms(lambda: se_scale(xb, w1, w2)),
                            plain_ms=time_ms(lambda: se_scale_reference(xb, w1, w2)),
                            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err)
                se["calls"].append(call)
                if b == BATCH and dt == torch.bfloat16:
                    ms += n_calls * call["ms"]
                    plain_ms += n_calls * call["plain_ms"]
                    bound_ms += n_calls * call["bound_ms"]
    se.update(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_us=bound_ms * 1e3)
    rows.append(se)

    # --- K2: the BiLSTM recurrence, T=16, H=256, once per encoder layer
    H, T = HIDDEN, LSTM_T
    lstm = dict(name="bilstm_scan", route="cuda", source="rcnn_ocr_tpu_torch/csrc/bilstm_scan.cu",
                replaces="rcnn_ocr_tpu/ops/lstm_pallas.py:92", launches_per_encode=2,
                dtype="w_hh bfloat16, xs/ys float32", batch=BATCH, calls=[],
                library_call=f"torch.nn.LSTM({LSTM_D}->{H}, bidirectional) on cuDNN, fp32, "
                             "includes the input projection")
    errs = []
    for wdt in (torch.float32, torch.bfloat16):
        name = "fp32" if wdt == torch.float32 else "bf16"
        w_hh = (torch.randn(2, H, 4 * H, device=dev, generator=gen) / H ** 0.5).to(wdt)
        for b in (BATCH, BIG_BATCH):
            xs = torch.randn(T, 2, b, 4 * H, device=dev, generator=gen)
            if b == BATCH:
                errs.append(held(bilstm_scan(xs, w_hh, H), scan_reference(xs, w_hh, H),
                                 what=f"bilstm_scan [{T},2,{b},{4 * H}] w_hh {name} vs plain",
                                 **TOL["fp32"]))
            flop = 2 * T * 2 * b * H * 4 * H
            nbytes = xs.numel() * 4 + T * 2 * b * H * 4 + w_hh.numel() * w_hh.element_size()
            bound = max(flop / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            call = dict(shape=[T, 2, b, 4 * H], w_dtype=name, per_encode=2,
                        ms=time_ms(lambda: bilstm_scan(xs, w_hh, H)),
                        plain_ms=time_ms(lambda: scan_reference(xs, w_hh, H)),
                        bound_ms=bound, flop=flop, bytes=nbytes,
                        bound_by="operations" if flop / FP32_FLOP_PER_S > nbytes / HBM_BYTES_PER_S
                        else "bytes")
            ref = torch.nn.LSTM(LSTM_D, H, bidirectional=True).to(dev).eval()
            seq = torch.randn(T, b, LSTM_D, device=dev, generator=gen)
            with torch.inference_mode():
                call["library_ms"] = time_ms(lambda: ref(seq))
            lstm["calls"].append(call)
    main = next(c for c in lstm["calls"] if c["shape"][2] == BATCH and c["w_dtype"] == "bf16")
    lstm.update(max_abs_err=max(errs), ms=2 * main["ms"], plain_ms=2 * main["plain_ms"],
                bound_ms=2 * main["bound_ms"], bound_us=2 * main["bound_ms"] * 1e3,
                bound_by=main["bound_by"], library_ms=2 * main["library_ms"])
    rows.append(lstm)
    return rows


def line_images(n: int, seed: int):
    """Seeded uint8 RGB line images of mixed sizes: about half shrink onto
    the 32x128 canvas, the rest grow or fit."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h = int(rng.integers(12, 30)) if i % 2 else int(rng.integers(33, 80))
        w = int(h * rng.uniform(1.5, 8.0))
        img = np.full((h, w, 3), 255, np.uint8)
        for _ in range(int(rng.integers(2, 9))):  # dark glyph-like blobs
            y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
            img[y0 : y0 + int(rng.integers(2, h // 2 + 3)),
                x0 : x0 + int(rng.integers(1, 6))] = rng.integers(0, 90)
        noise = rng.integers(-20, 20, img.shape)
        out.append(np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    return out


def main_path(kernels, power: str):
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_params
    from rcnn_ocr_tpu_torch.ops.ctc import ctc_greedy_decode
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    charset_path = os.path.join(REPO, "configs", "charset.txt")
    cs = Charset.from_file(charset_path)
    check(cs.num_classes == 194, f"charset has {cs.num_classes} classes, expected 194")
    model = RCNN(num_classes=cs.num_classes, hidden_size=HIDDEN, sos_id=cs.sos_id,
                 eos_id=cs.eos_id, pad_id=cs.pad_id, blank_id=cs.blank_id,
                 with_ctc_head=True, width_mult=WIDTH)
    init_params(model, torch.Generator().manual_seed(0))
    variables = to_jax_variables(model)
    images = line_images(N_IMAGES, seed=1)
    n_batches = -(-N_IMAGES // BATCH)

    engine = OCRInference(variables, charset_path=charset_path, device="cuda",
                          img_h=IMG_H, img_w=IMG_W, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"model: {n_params} parameters, width {WIDTH}, hidden {HIDDEN}, "
          f"{cs.num_classes} classes, {IMG_H}x{IMG_W}, bf16")
    engine.predict(images[:BATCH], max_length=MAX_LENGTH, batch_size=BATCH)  # warm-up
    engine.predict_ctc(images[:BATCH], batch_size=BATCH)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    texts_attn = engine.predict(images, max_length=MAX_LENGTH, batch_size=BATCH)
    t_attn = time.perf_counter() - t0
    after_attn = kernels.launch_counts()
    t0 = time.perf_counter()
    texts_ctc = engine.predict_ctc(images, batch_size=BATCH)
    t_ctc = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"launch counts over the main path (predict + predict_ctc, {n_batches} batches "
          f"each): {counts}")
    for name, per_encode in (("se_scale", 11), ("bilstm_scan", 2)):
        check(after_attn[name] == per_encode * n_batches,
              f"predict launched {name} {after_attn[name]}x, expected {per_encode * n_batches}")
        check(counts[name] == 2 * per_encode * n_batches,
              f"main path launched {name} {counts[name]}x, expected {2 * per_encode * n_batches}")
    check(len(texts_attn) == N_IMAGES and all(isinstance(t, str) for t in texts_attn),
          "predict returned no string per image")
    check(len(texts_ctc) == N_IMAGES and all(isinstance(t, str) for t in texts_ctc),
          "predict_ctc returned no string per image")
    throughput = {
        "attention_greedy_img_s": N_IMAGES / t_attn,
        "ctc_greedy_img_s": N_IMAGES / t_ctc,
    }
    for key, val in throughput.items():
        print(f"{key}: {val:.1f} img/s ({N_IMAGES} images, bs {BATCH}, bf16, host resize "
              f"included) on {power}")

    # --- where one bs-256 batch's time goes: host resize-pad vs device work
    t0 = time.perf_counter()
    np.stack([engine._preprocess(img, None) for img in images[:BATCH]])
    host_ms = (time.perf_counter() - t0) * 1e3
    _, _, x = next(engine._batches(images[:BATCH], BATCH))
    with torch.inference_mode():
        breakdown = {
            "host_resize_pad_ms": host_ms,
            "device_encode_ms": time_ms(lambda: engine.model.encode(x), iters=5),
            "device_attention_greedy_ms": time_ms(
                lambda: engine.model(x, batch_max_length=MAX_LENGTH), iters=5),
            "device_ctc_greedy_ms": time_ms(
                lambda: ctc_greedy_decode(engine.model.ctc_logits(x), cs.ctc_blank_id), iters=5),
        }
    calls = {
        "attention_greedy": lambda: engine.predict(images[:BATCH], max_length=MAX_LENGTH,
                                                   batch_size=BATCH),
        "ctc_greedy": lambda: engine.predict_ctc(images[:BATCH], batch_size=BATCH),
    }
    for decode, call in calls.items():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = sorted(walls)[1]
        breakdown[f"{decode}_wall_ms_per_batch"] = wall_ms
        breakdown[f"{decode}_device_idle_share"] = 1 - breakdown[f"device_{decode}_ms"] / wall_ms
    print("per bs-256 batch (bf16): " + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()))
    print(f"  sample strings: attention {texts_attn[:3]!r}, ctc {texts_ctc[:3]!r}")

    # --- fp32 through the kernels vs through the plain versions
    ref = OCRInference(variables, charset_path=charset_path, device="cuda",
                       img_h=IMG_H, img_w=IMG_W, dtype=torch.float32)
    enc_err = logit_err = 0.0
    attn_rows = attn_same = ctc_same = 0
    with torch.inference_mode():
        for _, n_real, x in ref._batches(images, BATCH):
            m = ref.model
            enc_k = m.encode(x)
            ctc_k = m._ctc_head(enc_k)
            greedy_k = m.attn(enc_k, batch_max_length=MAX_LENGTH)
            with kernels.plain_only():
                enc_p = m.encode(x)
                ctc_p = m._ctc_head(enc_p)
                greedy_p = m.attn(enc_p, batch_max_length=MAX_LENGTH)
            check(tuple(enc_k.shape) == (BATCH, IMG_W // 8, HIDDEN), f"encoder shape {enc_k.shape}")
            check(tuple(ctc_k.shape) == (BATCH, IMG_W // 8, cs.num_classes), "ctc logits shape")
            check(tuple(greedy_k.shape) == (BATCH, MAX_LENGTH + 1, cs.num_classes), "greedy shape")
            enc_err = max(enc_err, held(enc_k, enc_p, what="encoder states fp32, kernels vs plain",
                                        **TOL["enc"]))
            logit_err = max(logit_err, held(ctc_k, ctc_p, what="ctc logits fp32, kernels vs plain",
                                            **TOL["logits"]))
            tk, vk = ctc_greedy_decode(ctc_k, cs.ctc_blank_id)
            tp, vp = ctc_greedy_decode(ctc_p, cs.ctc_blank_id)
            ctc_same += int(((tk == tp).all(dim=1) & (vk == vp))[:n_real].sum())
            attn_same += int((greedy_k.argmax(-1) == greedy_p.argmax(-1)).all(dim=1)[:n_real].sum())
            attn_rows += n_real
    print(f"fp32 kernels vs plain: CTC greedy tokens equal on {ctc_same}/{attn_rows} rows, "
          f"attention greedy tokens equal on {attn_same}/{attn_rows} rows")
    check(ctc_same == attn_rows, "CTC greedy tokens differ between kernels and plain versions")
    check(attn_same >= 0.99 * attn_rows, "attention greedy tokens agree on fewer than 99% of rows")
    fp32_attn = ref.predict(images, max_length=MAX_LENGTH, batch_size=BATCH)
    agree = sum(a == b for a, b in zip(fp32_attn, texts_attn))
    print(f"bf16 vs fp32 attention strings equal on {agree}/{N_IMAGES} images (not held)")
    return dict(throughput, launch_counts=counts, n_batches=n_batches, enc_max_abs_err=enc_err,
                ctc_logits_max_abs_err=logit_err, ctc_rows_equal=ctc_same,
                attn_rows_equal=attn_same, rows=attn_rows, breakdown=breakdown)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", help="also write every measurement to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    from rcnn_ocr_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    power = card()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}")
    print(f"TF32 was: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; both set to False for this run")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build(kernels)
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernel phase")
    rows = kernel_phase(gen)
    for row in rows:
        for call in row["calls"]:
            print(f"  {row['name']} " + ", ".join(f"{k} {v}" for k, v in call.items()))
    print("main path phase")
    path = main_path(kernels, power)
    for row in rows:
        row["launches"] = path["launch_counts"][row["name"]]
        row["max_err"] = row["max_abs_err"]
        check(row["launches"] > 0, f"{row['name']} never launched on the main path")
    result = {"card": power, "kernels": rows, "main_path": path,
              "seconds": time.perf_counter() - t_start}
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "max_err", "bound_us", "launches_per_encode",
            "dtype", "batch", "library_call")
    print(f"total {result['seconds']:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
