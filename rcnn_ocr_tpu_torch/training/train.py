"""The training loop: ``run_training(cfg)``, on one card.

Counterpart of ``rcnn_ocr_tpu/training/train.py:run_training``, section by
section: seed, experiment dir, logger and config save; hyperparameters with
the same defaults and checks; the ``p_EdgeCrop`` x ``device_augment``
refusal; charset and ``RCNN``; optimizer, scheduler and state; datasets
(a separate validation set, or a random split); proportional or shuffled
sampling and width buckets (a list, or an int K for the waste-minimizing
DP) with CTC lifting; threaded loaders with the disk transform cache;
resume from a ``.msgpack`` slot (scheduler and learning rate included),
or a weights-only warm start from the reference's ``.pth`` / ``.pt``
layouts (fresh optimizer, scheduler and counters, as JAX does);
graceful SIGTERM (finish the step, write ``last``, return ``preempted``);
the epoch loop (no host sync per step except every ``log_every``, a
``StepTimer``, a ``torch.profiler`` window for ``profile_steps``);
validation per set and in total (loss, accuracy, CER, WER; CTC greedy
collapse for a CTC head); ``MetricsCSV``, TensorBoard scalars, the log
line, the three slots on eval epochs, ``eval_callback`` pruning and the
scheduler (plateau on eval epochs only); the checkpoint writer drained at
the end.

It runs on the card unless ``device="cpu"`` is passed (and raises without
one).  Randomness is explicit: the train step's ``torch.Generator`` on the
model's device is reseeded from ``(seed, global_step)`` before each step,
as JAX folds the step into its key, so a resumed run draws what an
uninterrupted one would; host augmentation draws from numpy Generators
seeded from ``(seed, epoch, batch, row)`` by the loader.  The starting
weights are drawn as flax's initializers draw them (``init_train_params``).

``export_artifact`` (validated at the start) exports a serving artifact
from the requested slot after training (:mod:`rcnn_ocr_tpu_torch.export`),
calibrating static int8 scales on validation images when asked.  Not
served here, and refused when asked for: a mesh over more than one device
and multi-process feeding (ROADMAP queue 1, item 13).  ``use_pallas`` and
``compile_cache_dir`` mean nothing on the card and are only logged.

    python -m rcnn_ocr_tpu_torch.training.train config.json [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import random
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rcnn_ocr_tpu_torch.data.dataset import (
    ConcatDataset,
    MultiDataset,
    OCRDataset,
    ProportionalBatchSampler,
    ShuffleBatchSampler,
    random_split,
)
from rcnn_ocr_tpu_torch.data.loader import (
    BucketedBatchSampler,
    BucketedProportionalBatchSampler,
    DataLoader,
    bucket_for_width,
    lift_buckets_for_ctc,
    optimal_width_buckets,
    probe_dataset_buckets,
    probe_scaled_widths,
)
from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad, get_train_transform
from rcnn_ocr_tpu_torch.export import (
    LONG_METHODS,
    export_serving_artifact,
    validate_export_request,
)
from rcnn_ocr_tpu_torch.inference import OCRInference, resolve_device
from rcnn_ocr_tpu_torch.interop.jax_params import load_jax_variables
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, TIME_DOWNSAMPLE, init_train_params
from rcnn_ocr_tpu_torch.ops.ctc import ctc_greedy_collapse_np
from rcnn_ocr_tpu_torch.training import checkpoint as ckpt_io
from rcnn_ocr_tpu_torch.training.config import Config
from rcnn_ocr_tpu_torch.training.loggers import MetricsCSV, SummaryWriter, setup_logger
from rcnn_ocr_tpu_torch.training.metrics import character_error_rate, word_error_rate
from rcnn_ocr_tpu_torch.training.optim import (
    ReduceLROnPlateau,
    build_optimizer,
    build_scheduler,
    get_lr,
    set_lr,
)
from rcnn_ocr_tpu_torch.training.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from rcnn_ocr_tpu_torch.utils.common import load_model
from rcnn_ocr_tpu_torch.utils.profiling import StepTimer, trace
from rcnn_ocr_tpu_torch.utils.progress import has_tqdm, progress
from rcnn_ocr_tpu_torch.vocab.charset import Charset, decode_tokens

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
AUGMENT_KEYS = ("p_ShiftScaleRotate", "shift_limit", "scale_limit", "rotate_limit",
                "p_BrightnessContrast", "brightness_limit", "contrast_limit", "invert_p")
PROFILE_WARMUP = 5  # steps skipped before a profile window (first-call costs)


def set_seed(seed: int = 42) -> None:
    """Seed the host's global generators (the loop itself draws from its
    own explicit generators)."""
    random.seed(seed)
    np.random.seed(seed)


def step_seed(seed: int, global_step: int) -> int:
    """The train step generator's seed for one step."""
    return int(np.random.SeedSequence([seed, global_step]).generate_state(1, np.uint64)[0] >> 1)


def _check_unserved(cfg: Config, logger) -> None:
    """Refuse what this slice does not serve; log what means nothing here."""
    mesh_shape = cfg.get("mesh_shape")
    if mesh_shape is not None and math.prod(int(d) for d in mesh_shape) > 1:
        raise NotImplementedError(
            f"mesh_shape {mesh_shape} asks for more than one device: data and tensor "
            "parallelism are still to be ported (ROADMAP queue 1, item 13)")
    if cfg.get("use_pallas"):
        logger.info("use_pallas: ignored (on the card the CUDA kernels are always the path)")
    if cfg.get("compile_cache_dir"):
        logger.info("compile_cache_dir: ignored (no XLA compile cache on the card)")


def run_training(cfg: Config, device: str = "cuda", eval_callback=None) -> Dict:
    """Train per ``cfg``; returns ``{"val_acc", "val_loss", "exp_dir", ...}``
    plus ``global_step``, ``start_epoch``, per-epoch timings (``epochs``:
    steps, images, train, loader-wait, validation and checkpoint seconds),
    the checkpoint writer's bytes and seconds (``checkpoint_writer``) and,
    with ``profile_steps``, the profile window's summary (``profile``).

    ``eval_callback(epoch, metrics) -> bool`` fires after every evaluated
    epoch with ``{"val_acc", "val_loss", "val_cer", "val_wer"}``; True stops
    the run cleanly with ``result["pruned"] = True``.
    """
    dev = resolve_device(device)
    seed = cfg.get("seed", 42)
    set_seed(seed)
    if bool(cfg.get("device_augment", False)) and float(cfg.get("p_EdgeCrop", 0.0) or 0.0) > 0:
        raise ValueError("p_EdgeCrop requires host augmentation (device_augment=false): "
                         "the crop applies to the raw image before ResizeAndPad")

    exp_dir = cfg.get("exp_dir")
    os.makedirs(exp_dir, exist_ok=True)
    logger = setup_logger(exp_dir)
    logger.info("Start training")
    logger.info(f"Experiment dir: {exp_dir}")
    logger.info(f"Seed: {seed}")
    _check_unserved(cfg, logger)
    cfg.save()
    logger.info("Saved config to exp_dir/config.json")

    # --- hyperparameters (JAX's defaults and checks) ---
    train_csvs, train_roots = cfg.get("train_csvs"), cfg.get("train_roots")
    val_csvs, val_roots = cfg.get("val_csvs"), cfg.get("val_roots")
    charset_path = cfg.get("charset_path")
    encoding = cfg.get("encoding", "utf-8")
    img_h, img_w = cfg.get("img_h", 64), cfg.get("img_w", 256)
    max_len = cfg.get("max_len", 25)
    hidden_size = cfg.get("hidden_size", 256)
    batch_size = cfg.get("batch_size", 32)
    epochs = cfg.get("epochs", 20)
    lr = cfg.get("lr", 1e-3)
    optimizer_name = cfg.get("optimizer", "Adam")
    scheduler_name = cfg.get("scheduler", "ReduceLROnPlateau")
    weight_decay = cfg.get("weight_decay", 0.0)
    momentum = cfg.get("momentum", 0.9)
    resume_path = cfg.get("resume_path")
    eval_every = int(cfg.get("eval_every", cfg.get("save_every", 1)))
    if eval_every < 1:
        raise ValueError("eval_every must be >= 1")
    train_proportions = cfg.get("train_proportions")
    val_size = cfg.get("val_size", 3000)
    if val_size is not None and int(val_size) < 1:
        raise ValueError(f"val_size must be >= 1 (got {val_size}); for no random-split "
                         "holdout provide explicit val_csvs/val_roots")
    num_workers = cfg.get("num_workers", 0)
    head = cfg.get("head", "attention")
    # the train-to-deploy handoff, validated now: a typo'd export block
    # fails in seconds, not after the last epoch
    export_req = cfg.get("export_artifact")
    if export_req:
        export_req = validate_export_request(export_req, head=head)
    compute_dtype = DTYPES[cfg.get("compute_dtype", "bfloat16")]
    log_every = max(1, int(cfg.get("log_every", 50)))
    grad_accum = max(1, int(cfg.get("grad_accum", 1)))
    ema_decay = float(cfg.get("ema_decay", 0.0))
    if not 0.0 <= ema_decay < 1.0:
        raise ValueError("ema_decay must be in [0, 1)")
    profile_steps = int(cfg.get("profile_steps", 0))
    profile_dir = cfg.get("profile_dir") or os.path.join(exp_dir, "profile")
    device_augment = bool(cfg.get("device_augment", False))
    # static per-step batch: a multiple of grad_accum (one card)
    static_bs = -(-batch_size // grad_accum) * grad_accum
    logger.info(f"Device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                    if dev.type == "cuda" else "")
                + f"; static_batch={static_bs}")

    log_dir = os.path.join(exp_dir, "logs")
    writer = SummaryWriter(log_dir)
    metrics_csv = MetricsCSV(os.path.join(exp_dir, "metrics_epoch.csv"))
    slots = ("last", "best_loss", "best_acc")
    ckpt_paths = {s: os.path.join(exp_dir, f"{s}{ckpt_io.CKPT_SUFFIX}") for s in slots}
    weight_paths = {s: os.path.join(exp_dir, f"{s}{ckpt_io.WEIGHTS_SUFFIX}") for s in slots}

    # --- charset / model ---
    charset = Charset.from_file(charset_path)
    logger.info(f"Charset loaded: {charset.num_classes} tokens")
    with_ctc = head in ("ctc", "both")
    model = RCNN(
        num_classes=charset.num_classes, hidden_size=hidden_size, sos_id=charset.sos_id,
        eos_id=charset.eos_id, pad_id=charset.pad_id, blank_id=charset.blank_id,
        enc_dropout_p=cfg.get("enc_dropout_p", 0.1), dropblock_p=cfg.get("dropblock_p", 0.0),
        dropblock_block_size=cfg.get("dropblock_block_size", 5),
        sampling_prob=cfg.get("sampling_prob", 0.0),
        with_attention_head=head in ("attention", "both"), with_ctc_head=with_ctc,
        lstm_layers=cfg.get("lstm_layers", 2), width_mult=cfg.get("width_mult", 1.0),
        dtype=compute_dtype)
    init_train_params(model, torch.Generator().manual_seed(seed))
    logger.info(f"Model parameters: {sum(p.numel() for p in model.parameters()):,}")

    # --- optimizer / scheduler / state ---
    tx = build_optimizer(optimizer_name, lr, weight_decay, momentum,
                         grad_clip=float(cfg.get("grad_clip", 0.0)))
    scheduler = build_scheduler(scheduler_name, lr, epochs)
    state = create_train_state(model, tx, ema=ema_decay > 0, device=dev)
    train_step = make_train_step(
        model, tx, max_len, charset.pad_id, head=head, ctc_blank_id=charset.ctc_blank_id,
        ctc_loss_weight=cfg.get("ctc_loss_weight", 1.0), grad_accum=grad_accum,
        ema_decay=ema_decay, label_smoothing=float(cfg.get("label_smoothing", 0.0)),
        augment={k: cfg.get(k) for k in AUGMENT_KEYS} if device_augment else None)
    eval_step = make_eval_step(model, max_len, charset.pad_id, head=head,
                               ctc_blank_id=charset.ctc_blank_id, use_ema=ema_decay > 0)
    generator = torch.Generator(device=dev)

    # --- transforms / datasets ---
    width_buckets = cfg.get("width_buckets")
    auto_bucket_k = None
    if isinstance(width_buckets, int):
        auto_bucket_k = max(1, int(width_buckets))
    elif width_buckets:
        width_buckets = sorted({int(b) for b in width_buckets})
    cfg_dict = cfg.to_dict()

    def train_transform_for(w: int):
        if device_augment:  # the host only resize-pads; the step augments
            return ResizeAndPad(img_h=img_h, img_w=w)
        return get_train_transform(cfg_dict, img_h=img_h, img_w=w)

    train_transform = train_transform_for(img_w)
    val_transform = ResizeAndPad(img_h=img_h, img_w=img_w)  # uint8; normalized in eval_step
    if device_augment:
        logger.info("Augmentation: on-device (batched affine/B-C/invert in the train step)")

    def make_ds(csv_path, root, transform):
        return OCRDataset(csv_path, root, charset.stoi, img_height=img_h, img_max_width=img_w,
                          transform=transform, encoding=encoding, max_len=max_len,
                          strict_max_len=True, num_workers=num_workers if num_workers else 4)

    train_sets: List = []
    val_sets: List = []
    for i, (train_csv, train_root) in enumerate(zip(train_csvs, train_roots)):
        has_separate_val = bool(val_csvs and val_roots and i < len(val_csvs)
                                and i < len(val_roots) and val_csvs[i] is not None
                                and val_roots[i] is not None)
        ds_train_tf = None if width_buckets else train_transform
        ds_val_tf = None if width_buckets else val_transform
        if has_separate_val:
            train_sets.append(make_ds(train_csv, train_root, ds_train_tf))
            val_sets.append(make_ds(val_csvs[i], val_roots[i], ds_val_tf))
            logger.info(f"  Dataset {i}: separate validation set from {val_roots[i]}")
        else:
            full = make_ds(train_csv, train_root, None)
            n_val = min(val_size if val_size is not None else 3000, len(full))
            n_train = len(full) - n_val
            if n_train <= 0:
                raise ValueError(
                    f"Dataset {train_csv} has only {len(full)} samples, fewer than {n_val}")
            tr, va = random_split(full, n_train, n_val, seed=seed)
            tr.transform, va.transform = ds_train_tf, ds_val_tf
            train_sets.append(tr)
            val_sets.append(va)
            logger.info(f"  Dataset {i}: random split (val_size={n_val})")

    loader_workers = num_workers if num_workers and num_workers > 0 else 2
    if train_proportions is not None:
        total = sum(train_proportions)
        proportions = [p / total for p in train_proportions]
        if len(proportions) != len(train_sets):
            raise ValueError("train_proportions != num train_sets")
        train_dataset = MultiDataset(train_sets)
        train_sampler = ProportionalBatchSampler(train_sets, batch_size, proportions, seed=seed)
    else:
        train_dataset = ConcatDataset(train_sets)
        train_sampler = ShuffleBatchSampler(train_dataset, batch_size, seed=seed)

    train_bucket_of = None
    val_bucket_ofs = [None] * len(val_sets)
    if auto_bucket_k or width_buckets:
        per_ds_scaled = [probe_scaled_widths(ds, img_h, num_workers=loader_workers * 4)
                         for ds in train_sets]
        all_scaled = [w for ws in per_ds_scaled for w in ws]
        if auto_bucket_k:
            width_buckets = optimal_width_buckets(all_scaled, auto_bucket_k, multiple=8,
                                                  max_width=img_w)
            waste = sum(max(0, bucket_for_width(min(w, img_w), width_buckets) - min(w, img_w))
                        for w in all_scaled)
            logger.info(f"width_buckets=auto(k={auto_bucket_k}) -> {width_buckets} "
                        f"(right-pad waste {waste / max(sum(all_scaled), 1):.1%} of content "
                        f"pixels over {len(all_scaled)} samples)")
        per_ds_bucket_of = [[bucket_for_width(w, width_buckets) for w in ws]
                            for ws in per_ds_scaled]
        if with_ctc:
            lifted = [lift_buckets_for_ctc(ds, bo, charset, max_len, width_buckets,
                                           time_downsample=TIME_DOWNSAMPLE)
                      for ds, bo in zip(train_sets, per_ds_bucket_of)]
            n_lifted = sum(a != b for la, lb in zip(lifted, per_ds_bucket_of)
                           for a, b in zip(la, lb))
            if n_lifted:
                logger.info(f"CTC-aware bucketing: {n_lifted} samples lifted to a wider "
                            "bucket (label needs more time steps)")
            per_ds_bucket_of = lifted
        if train_proportions is not None:
            quota_mode = str(cfg.get("proportional_quotas", "expected"))
            train_sampler = BucketedProportionalBatchSampler(
                train_sets, batch_size, proportions, per_ds_bucket_of, seed=seed,
                quota_mode=quota_mode)
            logger.info(f"Proportional bucketing quota mode: {quota_mode}")
            train_bucket_of = train_sampler.bucket_of
            flat_buckets = [b for bo in per_ds_bucket_of for b in bo]
        else:
            train_bucket_of = [b for bo in per_ds_bucket_of for b in bo]
            train_sampler = BucketedBatchSampler(train_bucket_of, batch_size, shuffle=True,
                                                 seed=seed)
            flat_buckets = list(train_bucket_of)
        val_bucket_ofs = [probe_dataset_buckets(vs, img_h, width_buckets,
                                                num_workers=loader_workers * 4)
                          for vs in val_sets]
        if with_ctc:
            val_bucket_ofs = [lift_buckets_for_ctc(vs, vb, charset, max_len, width_buckets,
                                                   time_downsample=TIME_DOWNSAMPLE)
                              for vs, vb in zip(val_sets, val_bucket_ofs)]
        hist = {w: flat_buckets.count(w) for w in sorted(set(flat_buckets))}
        logger.info(f"Width buckets {width_buckets}: train histogram {hist}")

    def val_sampler(vs, vb):
        if vb is not None:
            return BucketedBatchSampler(vb, batch_size, shuffle=False)
        return ShuffleBatchSampler(vs, batch_size, shuffle=False)

    cache_dir = cfg.get("cache_dir")
    train_loader = DataLoader(
        train_dataset, train_sampler, charset, max_len, num_workers=loader_workers,
        static_batch_size=static_bs, with_ctc=with_ctc, bucket_of=train_bucket_of,
        transform_for_width=train_transform_for if width_buckets else None,
        cache_dir=cache_dir, seed=seed)
    val_loaders = [
        DataLoader(vs, val_sampler(vs, vb), charset, max_len, num_workers=loader_workers,
                   static_batch_size=static_bs, with_ctc=with_ctc, bucket_of=vb,
                   transform_for_width=((lambda w: ResizeAndPad(img_h=img_h, img_w=w))
                                        if vb is not None else None),
                   cache_dir=cache_dir, seed=seed)
        for vs, vb in zip(val_sets, val_bucket_ofs)]
    logger.info(f"Datasets: train={sum(len(ds) for ds in train_sets)} samples across "
                f"{len(train_sets)} set(s); val={sum(len(ds) for ds in val_sets)} samples "
                f"across {len(val_sets)} set(s)")
    logger.info(f"Loaders: train_batches/epoch={len(train_loader)}; "
                f"val_batches={sum(len(v) for v in val_loaders)}; batch_size={batch_size}")

    config_snapshot = {
        "batch_size": batch_size, "epochs": epochs, "lr": lr, "optimizer": optimizer_name,
        "scheduler": scheduler_name, "weight_decay": weight_decay, "momentum": momentum,
        "img_h": img_h, "img_w": img_w, "encoding": encoding, "max_len": max_len,
        "hidden_size": hidden_size, "lstm_layers": cfg.get("lstm_layers", 2),
        "width_mult": cfg.get("width_mult", 1.0), "head": head, "charset_path": charset_path,
        "train_csvs": train_csvs, "train_roots": train_roots, "val_csvs": val_csvs,
        "val_roots": val_roots,
    }

    # --- resume ---
    start_epoch, global_step = 1, 0
    best_val_loss, best_val_acc = float("inf"), -1.0
    if resume_path and os.path.isfile(resume_path) and resume_path.endswith((".pth", ".pt")):
        # a reference checkpoint carries weights only: warm-start from it
        # rather than train from scratch inside the resumed experiment dir
        _, imported, _ = load_model(resume_path, itos=list(charset.itos),
                                    hidden_size=hidden_size, device="cpu")
        load_jax_variables(model, {"params": imported["params"],
                                   "batch_stats": imported.get("batch_stats", {})})
        logger.info(f"Warm start from torch checkpoint: {resume_path} (weights only — "
                    "optimizer/scheduler/epoch counters start fresh)")
    elif resume_path and os.path.isfile(resume_path) and not resume_path.endswith(".msgpack"):
        raise ValueError(f"resume_path points at an unsupported checkpoint format: "
                         f"{resume_path} (expected .msgpack, or .pth/.pt for a weights-only "
                         "warm start)")
    if resume_path and os.path.isfile(resume_path) and resume_path.endswith(".msgpack"):
        blob = ckpt_io.load_checkpoint_blob(resume_path)
        ckpt_io.restore_train_state(blob, state)
        if scheduler is not None and blob.get("scheduler_state"):
            scheduler.load_state_dict(blob["scheduler_state"])
            set_lr(state.optimizer, scheduler.lr)
        start_epoch = int(blob.get("epoch", 0)) + 1
        global_step = int(blob.get("global_step", 0))
        best_val_loss = float(blob.get("best_val_loss", best_val_loss))
        best_val_acc = float(blob.get("best_val_acc", best_val_acc))
        logger.info(f"Resumed from: {resume_path} (epoch={start_epoch - 1}, step={global_step})")

    def step_batch(batch):
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray) and k != "lengths"}
        if grad_accum > 1:  # [A, B/A, ...], as the step's microbatch loop takes it
            arrays = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
                      for k, v in arrays.items()}
        return arrays

    saver = ckpt_io.AsyncCheckpointer() if cfg.get("async_checkpoint", True) else None

    def save_slot(slot: str, epoch: int, val_loss, val_acc):
        t_save = time.perf_counter()
        args = (state, scheduler.state_dict() if scheduler is not None else None, epoch,
                global_step, val_loss, val_acc, list(charset.itos), charset.stoi,
                config_snapshot, log_dir)
        if saver is not None:
            saver.save_checkpoint(ckpt_paths[slot], *args)
            saver.save_weights(weight_paths[slot], state)
        else:
            ckpt_io.save_checkpoint(ckpt_paths[slot], *args)
            ckpt_io.save_weights(weight_paths[slot], state)
        if result["epochs"]:
            result["epochs"][-1]["checkpoint_s"] += time.perf_counter() - t_save

    # --- preemption: finish the step, write "last", stop ---
    preempt: Dict[str, Optional[int]] = {"signum": None}
    prev_sigterm = None
    if (cfg.get("graceful_shutdown", True)
            and threading.current_thread() is threading.main_thread()):

        def _on_term(signum, frame):  # noqa: ARG001 - signal handler ABI
            preempt["signum"] = signum

        prev_sigterm = signal.signal(signal.SIGTERM, _on_term)

    result = {"val_acc": best_val_acc, "val_loss": best_val_loss, "exp_dir": exp_dir,
              "start_epoch": start_epoch, "epochs": []}
    show_progress = bool(cfg.get("progress", True))
    plain_progress = show_progress and not has_tqdm()
    step_timer = StepTimer()
    try:
        for epoch in range(start_epoch, epochs + 1):
            t0 = time.perf_counter()
            loss_accum = None  # on the device: no sync per step
            n_batches = imgs_seen = 0
            profiling = profile_steps > 0 and epoch == start_epoch
            window = None
            warmup = min(PROFILE_WARMUP, max(0, len(train_loader) - profile_steps))
            profile_scope = contextlib.ExitStack()
            train_loader.set_epoch(epoch)
            bar = progress(enabled=show_progress, total=len(train_loader),
                           desc=f"epoch {epoch:03d}", unit="batch", leave=False)
            with profile_scope, bar:
                for batch in train_loader:
                    if profiling and n_batches == warmup:
                        window = profile_scope.enter_context(trace(profile_dir))
                    step_timer.start()
                    generator.manual_seed(step_seed(seed, global_step))
                    metrics = train_step(state, step_batch(batch), generator)
                    loss_accum = metrics["loss"] if loss_accum is None else (
                        loss_accum + metrics["loss"])
                    global_step += 1
                    n_batches += 1
                    n_valid = int(batch["valid"].sum())
                    imgs_seen += n_valid
                    step_timer.stop(n_valid)
                    if profiling and n_batches == warmup + profile_steps:
                        profile_scope.close()
                        logger.info(f"torch.profiler window ({profile_steps} steps) -> "
                                    f"{profile_dir}: {window.as_dict()}")
                    if n_batches % log_every == 0:
                        loss_val = float(metrics["loss"])  # one sync per log window
                        writer.add_scalar("Loss/train_step", loss_val, global_step)
                        writer.add_scalar("LR", get_lr(state.optimizer), global_step)
                        bar.set_postfix(loss=f"{loss_val:.4f}", refresh=False)
                        if plain_progress:
                            logger.info(f"epoch {epoch:03d} step {n_batches}/"
                                        f"{len(train_loader)} loss {loss_val:.4f}")
                    bar.update(1)
                    if preempt["signum"] is not None:
                        break
            if window is not None:
                result["profile"] = dict(window.as_dict(), steps=n_batches - warmup
                                         if n_batches < warmup + profile_steps else profile_steps)
            # the fetch waits for every queued step, so the wall time below
            # holds all the device work
            avg_train_loss = float(loss_accum) / n_batches if loss_accum is not None else 0.0
            train_time = time.perf_counter() - t0
            timing = {"epoch": epoch, "steps": n_batches, "images": imgs_seen,
                      "train_s": train_time, "loader_wait_s": train_loader.wait_seconds,
                      "val_batches": 0, "checkpoint_s": 0.0,
                      "train_loss": avg_train_loss, "step_timer": step_timer.summary()}
            result["epochs"].append(timing)
            writer.add_scalar("Loss/train_epoch", avg_train_loss, epoch)
            writer.add_scalar("Throughput/images_per_sec", imgs_seen / max(train_time, 1e-9),
                              epoch)
            if timing["step_timer"].get("steps"):
                writer.add_scalar("Throughput/step_ms_p95", timing["step_timer"]["p95_ms"], epoch)

            if preempt["signum"] is not None:
                logger.warning(f"Signal {preempt['signum']} caught mid-epoch {epoch} "
                               f"({n_batches} steps in): writing the 'last' slot and stopping "
                               f"- resume with resume_path='{exp_dir}' (the interrupted epoch "
                               "re-runs)")
                save_slot("last", epoch - 1, best_val_loss, best_val_acc)
                result["preempted"] = True
                break

            should_eval = ((epoch - start_epoch) % eval_every == 0) or (epoch == epochs)
            avg_val_loss = val_acc = val_cer = val_wer = None
            if should_eval:
                t_val = time.perf_counter()
                avg_val_loss, val_acc, val_cer, val_wer, timing["val_batches"] = _validate(
                    val_loaders, eval_step, state, charset, max_len, writer, epoch,
                    show_progress)
                timing["val_s"] = time.perf_counter() - t_val
                for name, tag in ((avg_val_loss, "Loss/val_epoch"), (val_acc, "Accuracy/val"),
                                  (val_cer, "CER/val"), (val_wer, "WER/val")):
                    writer.add_scalar(tag, name, epoch)
            else:
                logger.info(f"Epoch {epoch:03d}: skipping validation (eval_every={eval_every})")
            current_lr = get_lr(state.optimizer)
            timing.update(val_loss=avg_val_loss, val_acc=val_acc, val_cer=val_cer,
                          val_wer=val_wer, lr=current_lr)
            metrics_csv.write_row(epoch, avg_train_loss, current_lr, avg_val_loss, val_acc,
                                  val_cer, val_wer)
            parts = [f"Epoch {epoch:03d}/{epochs}", f"train_loss={avg_train_loss:.4f}"]
            if should_eval:
                parts += [f"val_loss={avg_val_loss:.4f}", f"acc={val_acc:.4f}",
                          f"CER={val_cer:.4f}", f"WER={val_wer:.4f}"]
            else:
                parts.append(f"val=skipped (eval_every={eval_every})")
            parts += [f"lr={current_lr:.2e}", f"imgs/s={imgs_seen / max(train_time, 1e-9):.0f}"]
            logger.info(" | ".join(parts))

            if should_eval:
                save_slot("last", epoch, avg_val_loss, val_acc)
                if avg_val_loss < best_val_loss:
                    best_val_loss = avg_val_loss
                    save_slot("best_loss", epoch, best_val_loss, val_acc)
                    logger.info(f"New best val_loss: {best_val_loss:.4f} (epoch {epoch})")
                if val_acc >= best_val_acc:
                    best_val_acc = val_acc
                    save_slot("best_acc", epoch, best_val_loss, best_val_acc)
                    logger.info(f"New best acc: {best_val_acc:.4f} (epoch {epoch})")
                if eval_callback is not None and bool(eval_callback(epoch, {
                        "val_acc": val_acc, "val_loss": avg_val_loss, "val_cer": val_cer,
                        "val_wer": val_wer})):
                    logger.info(f"Eval callback requested stop at epoch {epoch} (pruned)")
                    result["pruned"] = True
                    result["epochs_run"] = epoch
                    break

            if scheduler is not None:
                if isinstance(scheduler, ReduceLROnPlateau):
                    if should_eval and avg_val_loss is not None:
                        set_lr(state.optimizer, scheduler.step(avg_val_loss))
                else:
                    set_lr(state.optimizer, scheduler.step())
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        if saver is not None:
            t_drain = time.perf_counter()
            saver.close()  # drain the pending checkpoint writes
            result["checkpoint_writer"] = {"bytes": saver.bytes_written,
                                           "write_s": saver.write_seconds,
                                           "drain_s": time.perf_counter() - t_drain}
        writer.close()
    logger.info("Training finished.")
    result.update({"val_acc": best_val_acc, "val_loss": best_val_loss, "exp_dir": exp_dir,
                   "global_step": global_step})
    # export the serving artifact from the requested slot (a preempted run
    # exports when it resumes; a pruned trial is thrown away)
    if export_req and not result.get("preempted") and not result.get("pruned"):
        artifact_dir = _export_artifact(
            export_req, weight_paths[export_req["slot"]], charset_path, exp_dir, dev,
            img_h=img_h, img_w=img_w, hidden_size=hidden_size, batch_size=batch_size,
            width_buckets=width_buckets, val_sets=val_sets, logger=logger)
        if artifact_dir is not None:
            result["artifact_dir"] = artifact_dir
    return result


def _export_artifact(req: Dict, slot_path: str, charset_path: str, exp_dir: str, dev,
                     *, img_h: int, img_w: int, hidden_size: int, batch_size: int,
                     width_buckets, val_sets: List, logger) -> Optional[str]:
    """``export_serving_artifact`` from a weights slot, as JAX's loop does:
    the weights slot (an EMA run deploys its EMA weights), geometry and
    charset from the training config, ``quantize`` / ``lm`` / ``confidence``
    for the engine, ``calibrate`` on up to that many (256 for ``true``)
    validation images, and the run's width buckets for the fixed-width
    methods unless the request names its own."""
    if not os.path.exists(slot_path):
        logger.info(f"Artifact export skipped: checkpoint slot not found ({slot_path}); "
                    "no eval epoch wrote it")
        return None
    knobs = {k: v for k, v in req.items()
             if k not in ("slot", "out_dir", "quantize", "lm", "calibrate", "confidence")}
    if req.get("confidence"):
        knobs["with_confidence"] = True
    out_dir = req.get("out_dir") or os.path.join(exp_dir, "artifact")
    ocr = OCRInference(slot_path, charset_path, device=dev, img_h=img_h, img_w=img_w,
                       hidden_size=hidden_size, quantize=bool(req.get("quantize", False)),
                       lm=req.get("lm"))
    if width_buckets and "width_buckets" not in req and req["method"] not in LONG_METHODS:
        knobs["width_buckets"] = list(width_buckets)
    calibrate = req.get("calibrate")
    if calibrate:
        n_cal = 256 if calibrate is True else int(calibrate)
        cal_paths: List[str] = []
        for ds in val_sets:
            cal_paths.extend(ds.sample_path(i) for i in range(min(len(ds), n_cal - len(cal_paths))))
        ocr.calibrate(cal_paths, batch_size=batch_size)
        logger.info(f"Calibrated static int8 scales on {len(cal_paths)} validation images")
    export_serving_artifact(ocr, out_dir, **knobs)
    logger.info(f"Exported serving artifact: {out_dir} (method={req['method']}, "
                f"slot={req['slot']})")
    return out_dir


def _validate(val_loaders, eval_step, state, charset: Charset, max_len: int, writer,
              epoch: int, show_progress: bool):
    """Loss, accuracy, CER and WER per validation set (TensorBoard) and in
    total (returned, with the number of batches): teacher-forced loss,
    greedy attention decodes, or the collapsed CTC frame argmaxes for a CTC
    head."""
    itos = list(charset.itos)
    total_loss = 0.0
    total_batches = total_n = total_correct = 0
    total_cer = total_wer = 0.0
    for i, loader in enumerate(val_loaders):
        set_loss, set_batches = 0.0, 0
        refs: List[str] = []
        hyps: List[str] = []
        for batch in progress(loader, enabled=show_progress, total=len(loader),
                              desc=f"val[{i}]", unit="batch", leave=False):
            out = eval_step(state, {k: v for k, v in batch.items()
                                    if isinstance(v, np.ndarray) and k != "lengths"})
            set_loss += float(out["val_loss"])
            set_batches += 1
            n_real = int(batch["valid"].sum())
            tgt_ids = np.asarray(batch["target_y"])[:n_real]
            if "pred_ids" in out:
                pred_ids = out["pred_ids"].cpu().numpy()[:n_real]
            else:
                rows = ctc_greedy_collapse_np(out["ctc_frame_ids"].cpu().numpy()[:n_real],
                                              charset.ctc_blank_id)
                pred_ids = np.full((len(rows), max_len + 1), charset.pad_id)
                specials = (charset.sos_id, charset.eos_id, charset.pad_id)
                for r, row in enumerate(rows):
                    row = [t for t in row if t not in specials][: max_len + 1]
                    pred_ids[r, : len(row)] = row
            for p_row, t_row in zip(pred_ids, tgt_ids):
                hyps.append(decode_tokens(p_row, itos, charset.pad_id, charset.eos_id,
                                          charset.blank_id))
                refs.append(decode_tokens(t_row, itos, charset.pad_id, charset.eos_id,
                                          charset.blank_id))
        n_set = len(refs)
        n_correct = sum(1 for r, h in zip(refs, hyps) if r == h)
        cer_sum = sum(character_error_rate(r, h) for r, h in zip(refs, hyps))
        wer_sum = sum(word_error_rate(r, h) for r, h in zip(refs, hyps))
        writer.add_scalar(f"Loss/val_set_{i}", set_loss / max(1, set_batches), epoch)
        writer.add_scalar(f"Accuracy/val_set_{i}", n_correct / max(1, n_set), epoch)
        writer.add_scalar(f"CER/val_set_{i}", cer_sum / max(1, n_set), epoch)
        writer.add_scalar(f"WER/val_set_{i}", wer_sum / max(1, n_set), epoch)
        total_loss += set_loss
        total_batches += set_batches
        total_n += n_set
        total_correct += n_correct
        total_cer += cer_sum
        total_wer += wer_sum
    return (total_loss / max(1, total_batches), total_correct / max(1, total_n),
            total_cer / max(1, total_n), total_wer / max(1, total_n), total_batches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train the recognizer from a JSON config.")
    ap.add_argument("config", nargs="?", default="configs/config.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run_training(Config(args.config), device=args.device)
    print(f"val_acc={result['val_acc']:.4f} val_loss={result['val_loss']:.4f} "
          f"exp_dir={result['exp_dir']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
