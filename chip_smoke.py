"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py [--json-out PATH]

1. Prints the card (name and power limit from nvidia-smi, torch's device name
   and count) and turns TF32 off for matmuls and convolutions, so that the
   fp32 comparisons below compare fp32 arithmetic.
2. Builds every CUDA kernel of the port from ``rcnn_ocr_tpu_torch/csrc``
   (one nvcc per source, in parallel) and prints build times and ptxas
   register / shared-memory lines.
3. Kernel phase: each kernel against its plain PyTorch version at the
   shapes of the main paths (32x128 lines, width 1.0, hidden 256), in fp32
   and bf16 at batch 128 (the train step's), 256 (inference's) and 2048,
   with CUDA-event times of kernel, plain version and library yardstick at
   each: warm (the same inputs back to back) and, for the kernel, cold
   (inputs rotated over enough distinct buffers to exceed 100 MB, twice the
   50 MB L2).  Prints the route each shape takes (K1: cluster split; K2:
   w_hh resident in a cluster's shared memory, or streamed) and checks that
   every one takes the cluster and resident routes.
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
5. Training phase.  (a) Gradient check: the same full-width model in fp32
   at batch 32, train mode, head "both" with dropout, DropBlock and
   sampling off, one ``make_train_step`` (SGD at lr 0, so the weights stay)
   through the kernels and once more under ``kernels.plain_only()`` from
   the same batch-norm statistics: loss and updated running statistics
   must agree, every backbone weight must get a gradient, and every
   parameter's gradient must lie within a relative L2 error of 2e-2 of the
   plain one (printed beside two controls on the plain path alone: a rerun,
   and the images nudged by 1e-6).  (b) 30 ``make_train_step`` steps of the shipped
   configuration (configs/config.json: width 1.0, hidden 256, 32x128,
   max_len 40, batch 128, bf16 compute with fp32 weights, Adam lr 5e-4 and
   weight decay 2e-5, head "both" with CTC weight 1 and blank <PAD>, encoder
   and attention dropout 0.1) on one seeded batch: finite losses, the mean
   of the last 5 below the first, 11 squeeze-excite and 2 BiLSTM launches
   per step; prints step ms, img/s, peak
   memory and each kernel's forward and backward ms per step (CUDA events
   around its autograd Function), then profiles 3 more steps
   (torch.profiler: device busy time by kernel name, idle share).
   (c) Round trip: ``make_eval_step`` on the trained state,
   ``save_weights`` into build/chip_smoke/, and the file loaded by
   ``OCRInference`` on the card for ``predict`` and ``predict_ctc``.
6. Training-loop phase: writes seeded line images (30 characters of
   configs/charset.txt with fixed 12x8 glyph bitmaps, labels of 4-12, lines
   32-48 high, 8-bit RGB PNGs whose rows cycle through all five filter
   types) in the shipped layout into build/chip_smoke/data/, and runs
   ``run_training`` on the card with configs/config.json, overriding only
   the data paths, exp_dir, epochs, eval_every 1, val_size, num_workers 8,
   head "both" and, for run 1, profile_steps (a torch.profiler window of 8
   steps in epoch 1 gives the card's idle share).  Run 1 trains 3 epochs of
   2 x 1,024 lines and is cut by SIGTERM 10 steps into epoch 4: losses must
   be finite and fall (last epoch's mean train loss and last validation loss
   below the first), all three slots and metrics_epoch.csv must exist, the
   preempted slot must restore bit for bit (parameters, statistics, Adam
   moments, learning rate).  Run 2 resumes from the experiment dir and
   finishes epoch 4 with global_step counting on.  Every run must launch
   11 se_scale and 2 bilstm_scan per train step and per validation batch.
   A short run with device_augment must call device_train_augment once per
   step.  Finally ``OCRInference`` loads last_weights.msgpack and reads set
   B's validation PNGs by path: the batches it builds must equal, bit for
   bit, the resize-padded batches given to make_eval_step, its model's
   greedy and CTC logits on them the eval step's model's (rows must differ
   from one another by far more than the tolerance), and ``predict`` and
   ``predict_ctc`` must give make_eval_step's strings on >= 99% of rows
   (bf16 both; the distinct strings are printed: a model this short of
   training gives few).  Prints the loop's img/s, step ms, loader wait per
   step, validation and checkpoint ms per epoch, PNG decode (with the
   images' size) and host augment ms per image and the profiled idle share
   beside the bare train step's img/s.

Prints one ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``.  Any failed check raises and exits non-zero
before the last line.  Exits non-zero without a result when no CUDA device
is present or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
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
COLD_BYTES = 100_000_000  # twice the H100's 50 MB L2
# training phase: configs/config.json's shape and optimizer
TRAIN_BATCH, TRAIN_MAX_LEN, TRAIN_STEPS, GRAD_BATCH = 128, 40, 30, 32
TRAIN_LR, TRAIN_WD = 5e-4, 2e-5
# training-loop phase: two sets of LOOP_TRAIN lines (16 steps per epoch at
# quota 64 each), LOOP_VAL validation rows per set, LOOP_EPOCHS full epochs
# and a fourth cut by SIGTERM; LOOP_SMALL rows per set for the short
# device-augmentation run (LOOP_SMALL_TRAIN of set A's to train)
LOOP_CHARS, LOOP_TRAIN, LOOP_VAL, LOOP_EPOCHS = 30, 1024, 256, 3
LOOP_SMALL, LOOP_SMALL_TRAIN, LOOP_PROFILE_STEPS = 640, 512, 8

TOL = {
    # kernel vs plain, same inputs; fp32: summation order only
    "fp32": dict(rtol=1e-5, atol=1e-5),
    # bf16 outputs: both versions round the fp32 gate to bf16, then x * gate
    # to bf16.  A gate within ~1e-7 of a rounding boundary (the fp32 means
    # summed in another order) rounds the other way: one gate ulp, at most
    # 2^-7 relative, and the product's own rounding adds at most one output
    # ulp, 2^-7 relative again (seen at bs 2048: two ulps, 7.8e-3 at 0.6)
    "bf16": dict(rtol=2 ** -6, atol=1e-6),
    # main path, fp32 with kernels vs plain versions: the CPU parity
    # tolerances for encoder states and logits (tests/test_torch_port_model.py)
    "enc": dict(rtol=1e-4, atol=2e-4),
    "logits": dict(rtol=1e-3, atol=5e-4),
    # gradient check, fp32 kernels vs plain versions, per leaf: the relative
    # L2 error.  Not elementwise: the kernels' ~5e-7 forward differences flip
    # a few ReLUs that sit within ~1e-6 of their kink, and each flip moves
    # single gradient entries by up to a few percent of the leaf's max; the
    # same spread comes from nudging the images by 1e-6 in the plain path
    # alone (the control printed beside it).  A missing gradient is 1.0.
    "grad_rel_l2": 2e-2,
    "stats": dict(rtol=1e-4, atol=1e-6),
    # OCRInference's model vs the eval step's on the same batch: the same
    # weights from the same file, so only another convolution algorithm
    # could move a logit
    "served": dict(rtol=1e-3, atol=1e-3),
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
    print(f"  {what}: max abs err {max_abs:.3e}, {int((err > 0).sum())} of {err.numel()} "
          f"differ (rtol {rtol}, atol {atol})")
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


def time_cold_ms(fn, sets, iters: int = 20) -> float:
    """``fn(*sets[i % len(sets)])`` per launch: each set was last touched
    ``len(sets) - 1`` launches earlier, with at least 100 MB in between."""
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_sets(make, nbytes: int):
    """Distinct input sets from ``make()`` totalling more than 100 MB (two at least)."""
    return [make() for _ in range(max(2, -(-COLD_BYTES // nbytes)))]


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
    from rcnn_ocr_tpu_torch.ops.bilstm_scan import route as lstm_route
    from rcnn_ocr_tpu_torch.ops.se_scale import route as se_route
    from rcnn_ocr_tpu_torch.ops.se_scale import se_scale, se_scale_reference

    dev = "cuda"
    rows = []

    # --- K1: squeeze-excite at both main-path shapes
    se = dict(name="se_scale", route="cuda", source="rcnn_ocr_tpu_torch/csrc/se_scale.cu",
              replaces="rcnn_ocr_tpu/ops/se_pallas.py:61", launches_per_encode=11,
              dtype="bfloat16", batch=BATCH, bound_by="bytes", library_ms=None,
              library_call="none (no single PyTorch call computes it)", calls=[])
    errs, ms, cold_ms, plain_ms, bound_ms = [], 0.0, 0.0, 0.0, 0.0
    for n_calls, (h, w, c) in SE_SHAPES:
        s = c // 16
        w1 = torch.randn(c, s, device=dev, generator=gen) / c ** 0.5
        w2 = torch.randn(s, c, device=dev, generator=gen) / s ** 0.5
        for dt, tol in ((torch.float32, TOL["fp32"]), (torch.bfloat16, TOL["bf16"])):
            name = "fp32" if dt == torch.float32 else "bf16"
            for b in (TRAIN_BATCH, BATCH, BIG_BATCH):
                plan = se_route((b, h, w, c), s, dt)
                check(plan["route"] == "cluster",
                      f"se_scale [{b},{h},{w},{c}] {name} took the {plan['route']} route")
                xb = torch.randn(b, h, w, c, device=dev, generator=gen).to(dt)
                err = held(se_scale(xb, w1, w2), se_scale_reference(xb, w1, w2), what=
                           f"se_scale [{b},{h},{w},{c}] {name} vs plain", **tol)
                errs.append(err)
                nbytes = 2 * xb.numel() * xb.element_size() + 2 * c * s * 4
                sets = cold_sets(lambda: (torch.randn(b, h, w, c, device=dev, generator=gen)
                                          .to(dt), w1, w2), xb.numel() * xb.element_size())
                call = dict(shape=[b, h, w, c], dtype=name, per_encode=n_calls,
                            route=plan,
                            ms=time_ms(lambda: se_scale(xb, w1, w2)),
                            cold_ms=time_cold_ms(se_scale, sets),
                            plain_ms=time_ms(lambda: se_scale_reference(xb, w1, w2)),
                            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err)
                del sets
                call["bound_share_cold"] = call["bound_ms"] / call["cold_ms"]
                se["calls"].append(call)
                if b == BATCH and dt == torch.bfloat16:
                    ms += n_calls * call["ms"]
                    cold_ms += n_calls * call["cold_ms"]
                    plain_ms += n_calls * call["plain_ms"]
                    bound_ms += n_calls * call["bound_ms"]
    se.update(max_abs_err=max(errs), ms=ms, cold_ms=cold_ms, plain_ms=plain_ms,
              bound_ms=bound_ms, bound_us=bound_ms * 1e3)
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
        for b in (TRAIN_BATCH, BATCH, BIG_BATCH):
            plan = lstm_route(b, H, wdt)
            check(plan["route"] == "resident",
                  f"bilstm_scan B={b} H={H} w_hh {name} took the {plan['route']} route")
            xs = torch.randn(T, 2, b, 4 * H, device=dev, generator=gen)
            err = held(bilstm_scan(xs, w_hh, H), scan_reference(xs, w_hh, H),
                       what=f"bilstm_scan [{T},2,{b},{4 * H}] w_hh {name} vs plain",
                       **TOL["fp32"])
            errs.append(err)
            flop = 2 * T * 2 * b * H * 4 * H
            nbytes = xs.numel() * 4 + T * 2 * b * H * 4 + w_hh.numel() * w_hh.element_size()
            bound = max(flop / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            sets = cold_sets(lambda: (torch.randn(T, 2, b, 4 * H, device=dev, generator=gen),
                                      w_hh.clone(), H), xs.numel() * 4)
            call = dict(shape=[T, 2, b, 4 * H], w_dtype=name, per_encode=2, route=plan,
                        max_abs_err=err,
                        ms=time_ms(lambda: bilstm_scan(xs, w_hh, H)),
                        cold_ms=time_cold_ms(bilstm_scan, sets),
                        plain_ms=time_ms(lambda: scan_reference(xs, w_hh, H)),
                        bound_ms=bound, flop=flop, bytes=nbytes,
                        bound_by="operations" if flop / FP32_FLOP_PER_S > nbytes / HBM_BYTES_PER_S
                        else "bytes")
            del sets
            call["bound_share_cold"] = call["bound_ms"] / call["cold_ms"]
            ref = torch.nn.LSTM(LSTM_D, H, bidirectional=True).to(dev).eval()
            seq = torch.randn(T, b, LSTM_D, device=dev, generator=gen)
            with torch.inference_mode():
                call["library_ms"] = time_ms(lambda: ref(seq))
            call["vs_library"] = call["ms"] / call["library_ms"]
            lstm["calls"].append(call)
    main = next(c for c in lstm["calls"] if c["shape"][2] == BATCH and c["w_dtype"] == "bf16")
    lstm.update(max_abs_err=max(errs), ms=2 * main["ms"], cold_ms=2 * main["cold_ms"],
                plain_ms=2 * main["plain_ms"], bound_ms=2 * main["bound_ms"],
                bound_us=2 * main["bound_ms"] * 1e3, bound_by=main["bound_by"],
                library_ms=2 * main["library_ms"])
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


def train_batch(cs, n: int, seed: int, dev: str):
    """A seeded training batch as the JAX step takes it: uint8 noise images
    normalized on the card, labels of 4-10 characters of the charset (every
    row CTC-feasible at T = 16 frames)."""
    from rcnn_ocr_tpu_torch.data.loader import collate_batch
    from rcnn_ocr_tpu_torch.ops.augment import device_normalize

    rng = np.random.default_rng(seed)
    chars = [t for t in cs.itos if len(t) == 1]
    labels = ["".join(rng.choice(chars, size=int(rng.integers(4, 11)))) for _ in range(n)]
    images = rng.integers(0, 256, size=(n, IMG_H, IMG_W, 3), dtype=np.uint8)
    batch = collate_batch(list(zip(images, labels)), cs, TRAIN_MAX_LEN, with_ctc=True)
    lab = batch["ctc_labels"]
    need = (1 - batch["ctc_paddings"]).sum(1) + ((lab[:, 1:] == lab[:, :-1])
                                                  & (batch["ctc_paddings"][:, 1:] == 0)).sum(1)
    check(bool((need <= IMG_W // 8).all()), "a training label is not CTC-feasible")
    out = {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if isinstance(v, np.ndarray)}
    out["image_u8"] = out["image"]
    out["image"] = device_normalize(out["image"])
    return out


def train_model(cs, dtype: torch.dtype, **kw):
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_params

    model = RCNN(num_classes=cs.num_classes, hidden_size=HIDDEN, sos_id=cs.sos_id,
                 eos_id=cs.eos_id, pad_id=cs.pad_id, blank_id=cs.blank_id, with_ctc_head=True,
                 width_mult=WIDTH, dtype=dtype, **kw)
    init_params(model, torch.Generator().manual_seed(0))
    return model.to("cuda")


class FunctionTimer:
    """CUDA events around the forward and backward of the kernels' autograd
    Functions (the forward launches the kernel, the backward is plain
    PyTorch); ``ms()`` sums each over the calls since ``reset()``."""

    def __init__(self):
        from rcnn_ocr_tpu_torch.ops import bilstm_scan, se_scale

        self.fns = {"se_scale": se_scale._SEScale, "bilstm_scan": bilstm_scan._BiLSTMScan}
        self.saved = {}
        self.events = {}

    def _wrap(self, key, fn):
        def timed(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.events.setdefault(key, []).append((start, end))
            return out
        return staticmethod(timed)

    def __enter__(self):
        for name, cls in self.fns.items():
            for phase in ("forward", "backward"):
                self.saved[(name, phase)] = cls.__dict__[phase]
                setattr(cls, phase, self._wrap((name, phase), getattr(cls, phase)))
        return self

    def __exit__(self, *exc):
        for (name, phase), orig in self.saved.items():
            setattr(self.fns[name], phase, orig)

    def reset(self):
        self.events = {}

    def ms(self):
        torch.cuda.synchronize()
        return {f"{name}_{phase}_ms": sum(a.elapsed_time(b) for a, b in ev)
                for (name, phase), ev in self.events.items()}


KERNEL_GROUPS = (  # by kernel name, first match wins
    ("K1 se_scale", ("se_cluster_kernel", "se_stream_kernel")), ("K2 bilstm_scan", ("bilstm",)),
    ("convolution (cuDNN)", ("conv", "xmma", "dgrad", "wgrad", "implicit", "cudnn")),
    ("matmul", ("gemm", "cutlass", "gemv", "splitk")),
    ("reduction", ("reduce",)), ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_steps(step, state, batch, gen, n: int = 3) -> dict:
    """Device busy time per step (kernel durations from torch.profiler,
    grouped by kernel name) against the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels_us = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]  # ranges span kernels
    busy = sum(us for _, us, _ in kernels_us) / 1e3 / n
    groups = {}
    for key, us, _ in kernels_us:
        name = next((g for g, subs in KERNEL_GROUPS if any(x in key.lower() for x in subs)),
                    "other")
        groups[name] = groups.get(name, 0.0) + us / 1e3 / n
    top = sorted(kernels_us, key=lambda k: -k[1])[:8]
    return dict(wall_ms=wall, device_busy_ms=busy,
                device_idle_share=1 - busy / wall if busy else None,
                kernels_per_step=sum(c for _, _, c in kernels_us) / n,
                by_group_ms=groups,
                top=[dict(kernel=k[:90], ms=us / 1e3 / n, calls=c / n) for k, us, c in top])


def gradient_check(kernels, cs):
    """One fp32 train step through the kernels and one under plain_only()."""
    from rcnn_ocr_tpu_torch.training.optim import build_optimizer
    from rcnn_ocr_tpu_torch.training.train_step import create_train_state, make_train_step

    model = train_model(cs, torch.float32, enc_dropout_p=0.0)
    model.attn.dropout_p = 0.0
    batch = train_batch(cs, GRAD_BATCH, seed=2, dev="cuda")
    sgd0 = build_optimizer("SGD", 0.0, momentum=0.0)  # lr 0: the weights stay
    step = make_train_step(model, sgd0, TRAIN_MAX_LEN, cs.pad_id, head="both",
                           ctc_blank_id=cs.ctc_blank_id)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}

    def run(b):
        with torch.no_grad():
            for n, buf in model.named_buffers():
                buf.copy_(stats0[n])
        loss = float(step(create_train_state(model, sgd0), b)["loss"])
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                 for n, p in model.named_parameters()}
        return loss, grads, {n: buf.clone() for n, buf in model.named_buffers()}

    def compare(grads, ref):
        rows = []
        for n, gp in ref.items():
            err = (grads[n] - gp).abs()
            rows.append(dict(leaf=n, rel_l2=(err.norm() / gp.norm()).item(),
                             max_share=(err.max() / gp.abs().max()).item()))
        return sorted(rows, key=lambda r: -r["rel_l2"])

    kernels.reset_launch_counts()
    loss_k, grads_k, stats_k = run(batch)
    counts = kernels.launch_counts()
    nudged = dict(batch, image=batch["image"] * (1 + 1e-6))
    with kernels.plain_only():
        loss_p, grads_p, stats_p = run(batch)
        controls = {"plain rerun": compare(run(batch)[1], grads_p),
                    "plain, images x (1 + 1e-6)": compare(run(nudged)[1], grads_p)}
    check(counts == {"se_scale": 11, "bilstm_scan": 2}, f"gradient check launched {counts}")
    missing = [n for n, g in grads_k.items()
               if n.startswith(("cnn.", "enc_rnn")) and not bool(g.abs().max() > 0)]
    check(not missing, f"no gradient through the kernels for {missing[:5]} ({len(missing)} leaves)")
    rows = compare(grads_k, grads_p)
    print(f"  loss fp32: kernels {loss_k:.7f}, plain {loss_p:.7f}")
    for what, rs in (("kernels vs plain", rows), *controls.items()):
        print(f"  {what}: per-leaf gradient rel L2 worst {rs[0]['rel_l2']:.3e} "
              f"({rs[0]['leaf']}), median {rs[len(rs) // 2]['rel_l2']:.3e}; max-abs-err share "
              f"of the leaf's max worst {max(r['max_share'] for r in rs):.3e}")
    floats = [n for n in stats_p if stats_p[n].is_floating_point()]
    stat_err = max((stats_k[n] - stats_p[n]).abs().max().item() for n in floats)
    stat_excess = max(((stats_k[n] - stats_p[n]).abs() - TOL["stats"]["atol"]
                       - TOL["stats"]["rtol"] * stats_p[n].abs()).max().item() for n in floats)
    print(f"  running statistics ({len(floats)} buffers): max abs err {stat_err:.3e}")
    check(stat_excess <= 0, f"running statistics outside {TOL['stats']}")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "fp32 loss differs between kernels and plain")
    bad = [r["leaf"] for r in rows if r["rel_l2"] > TOL["grad_rel_l2"]]
    check(not bad, f"gradients beyond rel L2 {TOL['grad_rel_l2']}: {bad[:5]} ({len(bad)} leaves)")
    return dict(loss_kernels=loss_k, loss_plain=loss_p, leaves=len(rows),
                worst_rel_l2=rows[0]["rel_l2"], worst_leaf=rows[0]["leaf"],
                worst_max_share=max(r["max_share"] for r in rows), stats_max_abs_err=stat_err,
                controls={k: dict(worst_rel_l2=v[0]["rel_l2"],
                                  worst_max_share=max(r["max_share"] for r in v))
                          for k, v in controls.items()},
                launches=counts)


def training_phase(kernels, cs, charset_path: str, power: str):
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables
    from rcnn_ocr_tpu_torch.training.checkpoint import save_weights
    from rcnn_ocr_tpu_torch.training.optim import build_optimizer
    from rcnn_ocr_tpu_torch.training.train_step import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    print("  gradient check (fp32, bs 32)")
    grad = gradient_check(kernels, cs)

    model = train_model(cs, torch.bfloat16)
    tx = build_optimizer("Adam", TRAIN_LR, weight_decay=TRAIN_WD)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, TRAIN_MAX_LEN, cs.pad_id, head="both",
                           ctc_blank_id=cs.ctc_blank_id, ctc_loss_weight=1.0)
    batch = train_batch(cs, TRAIN_BATCH, seed=3, dev="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses, step_ms = [], []
    with FunctionTimer() as timer:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(state, batch, gen)["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        per_step = {k: v / TRAIN_STEPS for k, v in timer.ms().items()}
    print(f"  losses: first {losses[0]:.4f}, last {losses[-1]:.4f}, "
          f"mean of last 5 {np.mean(losses[-5:]):.4f}")
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(np.mean(losses[-5:]) < losses[0], "the training loss did not fall")
    check(counts == {"se_scale": 11 * TRAIN_STEPS, "bilstm_scan": 2 * TRAIN_STEPS},
          f"{TRAIN_STEPS} train steps launched {counts}")
    median = float(np.median(step_ms))
    train = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, losses=losses, step_ms=step_ms,
                 median_step_ms=median, img_s=TRAIN_BATCH / median * 1e3, peak_bytes=peak,
                 launch_counts=counts, **per_step)
    print(f"  train step, bs {TRAIN_BATCH} bf16, head both, Adam: median {median:.2f} ms "
          f"({train['img_s']:.1f} img/s), peak memory {peak / 2**30:.2f} GiB on {power}")
    print("  per step (CUDA events around the Functions): " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_step.items()))
    train["profile"] = prof = profile_steps(step, state, batch, gen)
    if prof["device_busy_ms"]:
        print(f"  profiled ({prof['kernels_per_step']:.0f} kernels per step): wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']:.2f} ms, idle share "
              f"{prof['device_idle_share']:.3f}; by kernel name: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(prof["by_group_ms"].items(),
                                                    key=lambda kv: -kv[1])))
        for t in prof["top"]:
            print(f"    {t['ms']:8.3f} ms  {t['calls']:6.1f} calls  {t['kernel']}")
    else:
        print("  torch.profiler saw no device time on this machine")

    ev = make_eval_step(model, TRAIN_MAX_LEN, cs.pad_id, head="both",
                        ctc_blank_id=cs.ctc_blank_id)(state, dict(batch, image=batch["image_u8"]))
    check(bool(torch.isfinite(ev["val_loss"])) and bool(torch.isfinite(ev["ctc_val_loss"])),
          "eval losses are not finite")
    check(tuple(ev["pred_ids"].shape) == (TRAIN_BATCH, TRAIN_MAX_LEN + 1), "pred_ids shape")
    check(tuple(ev["ctc_frame_ids"].shape) == (TRAIN_BATCH, IMG_W // 8), "ctc_frame_ids shape")
    path = os.path.join(REPO, "build", "chip_smoke", "trained_weights.msgpack")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_weights(path, state)
    engine = OCRInference(path, charset_path=charset_path, device="cuda", img_h=IMG_H,
                          img_w=IMG_W, dtype=torch.bfloat16)
    saved, loaded = to_jax_variables(model), to_jax_variables(engine.model)
    for col in saved:
        for a, b in zip(json_leaves(saved[col]), json_leaves(loaded[col])):
            check(np.array_equal(a, b), "weights changed on the way through save_weights")
    images = line_images(8, seed=5)
    texts = engine.predict(images, max_length=TRAIN_MAX_LEN, batch_size=8)
    ctc = engine.predict_ctc(images, batch_size=8)
    check(len(texts) == len(ctc) == 8 and all(isinstance(t, str) for t in texts + ctc),
          "the reloaded weights gave no strings")
    print(f"  eval: val_loss {float(ev['val_loss']):.4f}, ctc_val_loss "
          f"{float(ev['ctc_val_loss']):.4f}; reloaded from {os.path.relpath(path, REPO)}: "
          f"{texts[:2]!r}, {ctc[:2]!r}")
    return dict(grad_check=grad, train=train, eval_val_loss=float(ev["val_loss"]),
                eval_ctc_val_loss=float(ev["ctc_val_loss"]))


def json_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from json_leaves(tree[k])
    else:
        yield tree


# --- the training loop --------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit gray ``[H, W]`` or RGB ``[H, W, 3]`` PNG whose rows cycle
    through the five filter types."""
    import struct
    import zlib

    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * c).astype(np.int32)
    left = np.pad(x, ((0, 0), (c, 0)))[:, :-c]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (c, 0)))[:, :-c]
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, upleft)])
    kind = np.arange(h) % 5
    rows = np.concatenate([kind[:, None], (x - pred[kind, np.arange(h)]) & 255], axis=1)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes()))
            + chunk(b"IEND", b""))


def write_line_dataset(root: str, itos, seed: int = 0) -> dict:
    """Seeded, learnable line images in the shipped layout (configs/config.json):
    30 characters of the charset each get a fixed 12x8 glyph bitmap;
    labels of 4-12 of them are pasted with jitter of a pixel or two around a
    baseline onto lines 32-48 high (so that ResizeAndPad both shrinks and
    grows them) and written as 8-bit RGB PNGs, gray ink on a light ground as
    the JAX package's ``render_line`` gives.  Set A (handwritten) is split for
    validation, set B (printed) has its own val CSV; ``*_small.csv`` are the
    first rows of each, for a short run."""
    import csv

    rng = np.random.default_rng(seed)
    chars = [t for t in itos if len(t) == 1 and t.isalnum()]
    chars = [chars[i] for i in rng.choice(len(chars), size=LOOP_CHARS, replace=False)]
    glyphs = {c: (rng.random((12, 8)) < 0.45) for c in chars}
    paths = {}
    for name, n in (("handwritten/train", LOOP_TRAIN + LOOP_VAL), ("printed/train", LOOP_TRAIN),
                    ("printed/val", LOOP_VAL)):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        rows = []
        for i in range(n):
            label = "".join(rng.choice(chars, size=int(rng.integers(4, 13))))
            h = int(rng.integers(32, 49))
            x = int(rng.integers(2, 10))
            base = int(rng.integers(2, h - 15))
            img = np.full((h, x + 11 * len(label) + int(rng.integers(2, 40))),
                          int(rng.integers(215, 256)), np.int16)
            for c in label:
                y = base + int(rng.integers(-1, 2))
                img[y : y + 12, x : x + 8][glyphs[c]] = int(rng.integers(0, 90))
                x += 8 + int(rng.integers(1, 5))
            img = np.clip(img + rng.integers(-12, 13, img.shape), 0, 255).astype(np.uint8)
            with open(os.path.join(d, f"{i:05d}.png"), "wb") as f:
                f.write(png_bytes(np.repeat(img[:, :, None], 3, axis=2)))
            rows.append((f"{i:05d}.png", label))
        for csv_name, part in (("labels.csv", rows), ("labels_small.csv", rows[:LOOP_SMALL])):
            with open(os.path.join(d, csv_name), "w", newline="", encoding="utf-8") as f:
                csv.writer(f).writerows(part)
        paths[name] = d
    return paths


def loop_config(paths: dict, exp_dir: str, **overrides) -> dict:
    """configs/config.json with only the data paths, exp_dir, epochs,
    eval_every, val_size, num_workers and head overridden (plus what a run
    names in ``overrides``)."""
    with open(os.path.join(REPO, "configs", "config.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    cfg.update(
        train_csvs=[os.path.join(paths["handwritten/train"], "labels.csv"),
                    os.path.join(paths["printed/train"], "labels.csv")],
        train_roots=[paths["handwritten/train"], paths["printed/train"]],
        val_csvs=[None, os.path.join(paths["printed/val"], "labels.csv")],
        val_roots=[None, paths["printed/val"]],
        charset_path=os.path.join(REPO, "configs", "charset.txt"), exp_dir=exp_dir,
        epochs=LOOP_EPOCHS + 1, eval_every=1, val_size=LOOP_VAL, num_workers=8, head="both")
    cfg.update(overrides)
    return cfg


def loop_counts_check(kernels, result, what: str) -> dict:
    """11 se_scale and 2 bilstm_scan launches per train step and per
    validation batch of a run_training call."""
    counts = kernels.launch_counts()
    steps = sum(e["steps"] for e in result["epochs"])
    val_batches = sum(e["val_batches"] for e in result["epochs"])
    want = {"se_scale": 11 * (steps + val_batches), "bilstm_scan": 2 * (steps + val_batches)}
    print(f"  {what}: {steps} train steps, {val_batches} validation batches, launches {counts}")
    check(counts == want, f"{what} launched {counts}, expected {want}")
    return dict(counts, steps=steps, val_batches=val_batches)


def training_loop_phase(kernels, cs, train_img_s: float, power: str):
    """run_training on the card with the shipped configuration; SIGTERM and
    resume; a device-augmentation run; OCRInference vs make_eval_step."""
    import signal
    import threading

    from rcnn_ocr_tpu_torch.data.image_io import imread
    from rcnn_ocr_tpu_torch.data.loader import collate_batch
    from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad, get_train_transform
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.interop.jax_params import load_jax_variables, to_jax_variables
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN
    from rcnn_ocr_tpu_torch.ops import augment
    from rcnn_ocr_tpu_torch.ops.augment import device_normalize
    from rcnn_ocr_tpu_torch.ops.ctc import ctc_greedy_collapse_np, ids_to_text
    from rcnn_ocr_tpu_torch.postprocess import ctc_skip_ids
    from rcnn_ocr_tpu_torch.training import checkpoint as ckpt
    from rcnn_ocr_tpu_torch.training.config import Config
    from rcnn_ocr_tpu_torch.training.optim import build_optimizer
    from rcnn_ocr_tpu_torch.training.train import run_training
    from rcnn_ocr_tpu_torch.training.train_step import create_train_state, make_eval_step
    from rcnn_ocr_tpu_torch.vocab.charset import decode_tokens

    base = os.path.join(REPO, "build", "chip_smoke")
    for sub in ("data", "exp_loop", "exp_devaug"):
        shutil.rmtree(os.path.join(base, sub), ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_line_dataset(os.path.join(base, "data"), cs.itos)
    write_s = time.perf_counter() - t0
    out = {"dataset_write_s": write_s}
    print(f"  wrote {2 * LOOP_TRAIN + 2 * LOOP_VAL} line PNGs in {write_s:.1f} s")

    # host costs per image, one thread: PNG decode, then the shipped augmentation
    files = [os.path.join(paths["printed/train"], f"{i:05d}.png")
             for i in range(min(256, LOOP_TRAIN))]
    t0 = time.perf_counter()
    decoded = [imread(p) for p in files]
    out["png_decode_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / len(files)
    hw = np.array([img.shape[:2] for img in decoded])
    out["png_decoded"] = (f"8-bit RGB, mean {hw[:, 0].mean():.1f} x {hw[:, 1].mean():.1f} px "
                          f"(h {hw[:, 0].min()}-{hw[:, 0].max()}, w {hw[:, 1].min()}-"
                          f"{hw[:, 1].max()}), rows filtered 0-4 in turn")
    shipped = loop_config(paths, "")
    transform = get_train_transform(shipped, shipped["img_h"], shipped["img_w"])
    t0 = time.perf_counter()
    for i, img in enumerate(decoded):
        transform(img, np.random.default_rng(i))
    out["host_augment_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / len(decoded)

    # run 1: epochs 1-3, then SIGTERM 10 steps into epoch 4
    exp_dir = os.path.join(base, "exp_loop")
    steps_per_epoch = LOOP_TRAIN // 64  # quota 64 per set at bs 128
    val_per_epoch = 2 * -(-LOOP_VAL // TRAIN_BATCH)
    fire_at = 11 * (LOOP_EPOCHS * (steps_per_epoch + val_per_epoch) + min(10, steps_per_epoch - 1))
    fired = threading.Event()

    def send_sigterm():
        while not fired.is_set():
            if kernels.SE_SCALE.launches >= fire_at:
                os.kill(os.getpid(), signal.SIGTERM)
                fired.set()
            time.sleep(0.002)

    killer = threading.Thread(target=send_sigterm, daemon=True)
    kernels.reset_launch_counts()
    killer.start()
    t0 = time.perf_counter()
    first = run_training(Config(loop_config(paths, exp_dir, profile_steps=LOOP_PROFILE_STEPS)))
    run1_s = time.perf_counter() - t0
    fired.set()
    killer.join(timeout=5)
    out["run1"] = loop_counts_check(kernels, first, "run 1 (epochs 1-3, SIGTERM in epoch 4)")
    check(first.get("preempted") is True, "run_training did not return preempted on SIGTERM")
    epochs = first["epochs"]
    check(len(epochs) == LOOP_EPOCHS + 1, f"run 1 ran {len(epochs)} epochs")
    losses = [e["train_loss"] for e in epochs[:LOOP_EPOCHS]]
    val_losses = [e["val_loss"] for e in epochs[:LOOP_EPOCHS]]
    print(f"  train loss per epoch {losses}, val loss {val_losses}, "
          f"val acc {[e['val_acc'] for e in epochs[:LOOP_EPOCHS]]}")
    check(all(np.isfinite(losses + val_losses)), "a loss is not finite")
    check(losses[-1] < losses[0], "the mean train loss of the last epoch is not below the first's")
    check(val_losses[-1] < val_losses[0], "the last validation loss is not below the first")
    for slot in ("last", "best_loss", "best_acc"):
        for suffix in (ckpt.CKPT_SUFFIX, ckpt.WEIGHTS_SUFFIX):
            check(os.path.exists(os.path.join(exp_dir, slot + suffix)), f"no {slot}{suffix}")
    check(os.path.exists(os.path.join(exp_dir, "metrics_epoch.csv")), "no metrics_epoch.csv")
    blob = ckpt.load_checkpoint_blob(os.path.join(exp_dir, "last_ckpt.msgpack"))
    preempted_steps = epochs[-1]["steps"]
    check(blob["epoch"] == LOOP_EPOCHS
          and blob["global_step"] == LOOP_EPOCHS * steps_per_epoch + preempted_steps,
          f"the preempted slot holds epoch {blob['epoch']}, step {blob['global_step']}")

    # the restore is bit-equal: parameters, statistics, Adam moments, lr
    model = RCNN(num_classes=cs.num_classes, hidden_size=HIDDEN, sos_id=cs.sos_id,
                 eos_id=cs.eos_id, pad_id=cs.pad_id, blank_id=cs.blank_id, with_ctc_head=True,
                 width_mult=WIDTH, dtype=torch.bfloat16)
    tx = build_optimizer("Adam", TRAIN_LR, weight_decay=TRAIN_WD)
    state = ckpt.restore_train_state(blob, create_train_state(model, tx))
    restored = to_jax_variables(model)
    for got, want, what in ((restored, {"params": blob["params"],
                                         "batch_stats": blob["batch_stats"]}, "variables"),
                            (ckpt.optimizer_state_tree(state), blob["opt_state"], "Adam state")):
        got, want = list(json_leaves(got)), list(json_leaves(want))
        check(len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want)),
              f"the restored {what} differ from the saved slot")
    check(np.float32(state.optimizer.param_groups[0]["lr"])
          == blob["opt_state"]["hyperparams"]["learning_rate"], "the restored lr differs")
    del model, state

    # run 2: resume, finish epoch 4
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    second = run_training(Config(dict(loop_config(paths, exp_dir, profile_steps=0),
                                      resume_path=exp_dir)))
    run2_s = time.perf_counter() - t0
    out["run2"] = loop_counts_check(kernels, second, "run 2 (resumed, epoch 4)")
    check(second["start_epoch"] == LOOP_EPOCHS + 1, f"resumed at epoch {second['start_epoch']}")
    check(second["global_step"] == blob["global_step"] + steps_per_epoch,
          f"global_step {second['global_step']} after the resume")
    check(second["epochs"][0]["train_loss"] < losses[0],
          "the resumed epoch trains from scratch, not from the slot")
    loop_launches = {k: out["run1"][k] + out["run2"][k] for k in ("se_scale", "bilstm_scan")}

    # a short run with device augmentation: the step augments on the card
    calls = {"n": 0}
    orig = augment.device_train_augment

    def counted(*args, **kwargs):
        calls["n"] += 1
        return orig(*args, **kwargs)

    augment.device_train_augment = counted
    kernels.reset_launch_counts()
    try:
        small = dict(loop_config(paths, os.path.join(base, "exp_devaug"), epochs=1,
                                 device_augment=True, val_size=LOOP_SMALL - LOOP_SMALL_TRAIN))
        small["train_csvs"] = [c.replace("labels.csv", "labels_small.csv")
                               for c in small["train_csvs"]]
        devaug = run_training(Config(small))
    finally:
        augment.device_train_augment = orig
    out["device_augment"] = loop_counts_check(kernels, devaug, "device_augment run")
    check(calls["n"] == out["device_augment"]["steps"] > 0,
          f"device_train_augment ran {calls['n']} times")
    check(np.isfinite(devaug["epochs"][0]["train_loss"]), "device_augment loss not finite")

    # OCRInference on the last weights (paths in, its own read, resize and
    # normalize) vs make_eval_step's decodes of the same images, both heads
    weights = os.path.join(exp_dir, "last_weights.msgpack")
    charset_path = os.path.join(REPO, "configs", "charset.txt")
    engine = OCRInference(weights, charset_path=charset_path, device="cuda", img_h=IMG_H,
                          img_w=IMG_W, dtype=torch.bfloat16)
    val_dir = paths["printed/val"]
    import csv

    with open(os.path.join(val_dir, "labels.csv"), encoding="utf-8") as f:
        rows = list(csv.reader(f))
    val_paths = [os.path.join(val_dir, r[0]) for r in rows]
    served = {"attention": engine.predict(val_paths, max_length=TRAIN_MAX_LEN,
                                          batch_size=TRAIN_BATCH),
              "CTC": engine.predict_ctc(val_paths, batch_size=TRAIN_BATCH)}
    model = RCNN(num_classes=cs.num_classes, hidden_size=HIDDEN, sos_id=cs.sos_id,
                 eos_id=cs.eos_id, pad_id=cs.pad_id, blank_id=cs.blank_id, with_ctc_head=True,
                 width_mult=WIDTH, dtype=torch.bfloat16)
    variables, _ = ckpt.load_variables(weights)
    load_jax_variables(model, variables)
    state = create_train_state(model, tx)
    evaluate = make_eval_step(model, TRAIN_MAX_LEN, cs.pad_id, head="both",
                              ctc_blank_id=cs.ctc_blank_id)
    resize = ResizeAndPad(IMG_H, IMG_W)
    itos = list(cs.itos)
    skip = ctc_skip_ids(cs.pad_id, cs.sos_id, cs.eos_id, cs.ctc_blank_id)
    looped = {"attention": [], "CTC": []}
    # predict's own batches from the paths (its read, resize and normalize)
    served_batches = list(engine._batches(val_paths, TRAIN_BATCH))
    logit_diff = row_spread = 0.0
    for s, (chunk, n_real, x) in zip(range(0, len(rows), TRAIN_BATCH), served_batches):
        part = rows[s : s + TRAIN_BATCH]
        items = [(resize(imread(os.path.join(val_dir, r[0]))), r[1]) for r in part]
        batch = collate_batch(items, cs, TRAIN_MAX_LEN, batch_size=TRAIN_BATCH, with_ctc=True)
        check(chunk == list(range(s, s + len(part))) and n_real == len(part)
              and torch.equal(x, device_normalize(torch.from_numpy(batch["image"]).cuda())),
              f"OCRInference's batch of rows {s}-{s + len(part) - 1} is not the eval step's")
        with torch.inference_mode():
            served_logits = engine.model.forward_both(x, batch_max_length=TRAIN_MAX_LEN)
            eval_logits = model.eval_outputs(x, batch_max_length=TRAIN_MAX_LEN, with_ctc=True)
        for a, (name, b) in zip(served_logits, (("greedy", eval_logits["greedy_logits"]),
                                               ("CTC", eval_logits["ctc_logits"]))):
            a, b = a[: len(part)], b[: len(part)].float()
            logit_diff = max(logit_diff, held(a, b, what=f"served {name} logits, rows {s}+",
                                              **TOL["served"]))
            row_spread = max(row_spread, float((b - b[:1]).abs().max()))
        pred = evaluate(state, {k: v for k, v in batch.items() if isinstance(v, np.ndarray)})
        for row in pred["pred_ids"].cpu().numpy()[: len(part)]:
            looped["attention"].append(decode_tokens(row, itos, cs.pad_id, cs.eos_id,
                                                     cs.blank_id))
        frames = pred["ctc_frame_ids"].cpu().numpy()[: len(part)]
        looped["CTC"] += ids_to_text(ctc_greedy_collapse_np(frames, cs.ctc_blank_id), itos,
                                     skip_ids=skip)
    print(f"  OCRInference's batches equal the eval step's bit for bit; logits of its model "
          f"vs the eval step's: max abs diff {logit_diff:.3g}, while rows differ from the "
          f"first row by up to {row_spread:.3g}")
    # the logit comparison must tell rows apart, or it holds nothing per image
    check(row_spread > 10 * TOL["served"]["atol"], f"logits barely depend on the image "
          f"({row_spread:.3g})")
    consistency = {"logit_max_abs_diff": logit_diff, "logit_row_spread": row_spread}
    for head, texts in served.items():
        agree = sum(a == b for a, b in zip(texts, looped[head]))
        distinct = len(set(texts))
        correct = sum(t == r[1] for t, r in zip(texts, rows))
        consistency[head] = dict(agree=agree, distinct=distinct, exactly_right=correct,
                                 examples=list(zip(texts[:4], [r[1] for r in rows[:4]])))
        print(f"  OCRInference {head} vs make_eval_step on set B's {len(rows)} validation "
              f"images (bf16): {agree} equal, {distinct} distinct strings, {correct} exactly "
              f"right; e.g. {consistency[head]['examples']}")
        check(agree >= 0.99 * len(rows),
              f"{head}: predict and make_eval_step agree on {agree}/{len(rows)}")

    # where the loop's time goes (epochs 2-3: epoch 1 carries the profile window)
    steady = epochs[1:LOOP_EPOCHS]
    steps = sum(e["steps"] for e in steady)
    timing = {
        "loop_img_s": sum(e["images"] for e in steady) / sum(e["train_s"] for e in steady),
        "loop_step_ms": sum(e["train_s"] for e in steady) * 1e3 / steps,
        "loader_wait_ms_per_step": sum(e["loader_wait_s"] for e in steady) * 1e3 / steps,
        "validation_ms_per_epoch": float(np.mean([e["val_s"] * 1e3 for e in steady])),
        "png_decode_ms_per_image": out["png_decode_ms_per_image"],
        "png_decoded": out["png_decoded"],
        "host_augment_ms_per_image": out["host_augment_ms_per_image"],
        "bare_train_step_img_s": train_img_s,
    }
    prof = first.get("profile") or {}
    timing["device_idle_share_profiled"] = prof.get("device_idle_share")
    timing["profiled_steps"] = prof.get("steps")
    timing["profiled_window_s"] = prof.get("wall_s")
    timing["profiler_processing_s"] = prof.get("processing_s")
    timing["checkpoint_s_per_eval_epoch"] = float(np.mean([e["checkpoint_s"] for e in steady]))
    writer = first.get("checkpoint_writer") or {}
    timing["checkpoint_writer_mb_per_s"] = (writer["bytes"] / writer["write_s"] / 1e6
                                            if writer.get("write_s") else None)
    print(f"  loop on {power}: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in timing.items()))
    out.update(timing=timing, run1_s=run1_s, run2_s=run2_s, consistency=consistency,
               rows=len(rows), train_losses=losses, val_losses=val_losses,
               epochs=first["epochs"] + second["epochs"], launches=loop_launches,
               resumed_global_step=second["global_step"], preempted_slot_step=blob["global_step"])
    return out


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
    print("training phase")
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    charset_path = os.path.join(REPO, "configs", "charset.txt")
    cs = Charset.from_file(charset_path)
    training = training_phase(kernels, cs, charset_path, power)
    print("training-loop phase")
    loop = training_loop_phase(kernels, cs, training["train"]["img_s"], power)
    backward = {"se_scale": "autograd: plain torch (the hand VJP of se_pallas.py:_se_bwd)",
                "bilstm_scan": "autograd: plain torch (recompute through scan_reference)"}
    train = training["train"]
    for row in rows:
        name = row["name"]
        by_path = {"inference": path["launch_counts"][name],
                   "train": train["launch_counts"][name],
                   "train_loop": loop["launches"][name]}
        row.update(launches=by_path["inference"], launches_by_path=by_path,
                   max_err=row["max_abs_err"], backward_route=backward[name],
                   launches_per_train_step=train["launch_counts"][name] // TRAIN_STEPS,
                   train_fwd_ms_per_step=train[f"{name}_forward_ms"],
                   train_bwd_ms_per_step=train[f"{name}_backward_ms"])
        for p, n in by_path.items():
            check(n > 0, f"{name} never launched on the {p} path")
    result = {"card": power, "kernels": rows, "main_path": path, "training": training,
              "training_loop": loop, "seconds": time.perf_counter() - t_start}
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "cold_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "max_err", "bound_us",
            "launches_per_encode", "dtype", "batch", "library_call", "launches_by_path",
            "backward_route", "launches_per_train_step", "train_fwd_ms_per_step",
            "train_bwd_ms_per_step")
    print(f"total {result['seconds']:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
