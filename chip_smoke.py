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
   every one takes the cluster and resident routes.  K2 also at hidden 512
   (the HPO study's width) at batch 128 and 256: w_hh fp32 must take the
   streaming route and bf16 the resident one in clusters of 16, each held
   against the plain version and timed warm and cold beside its bound and
   cuDNN's ``nn.LSTM(512->512)`` and ``nn.LSTM(1024->512)``, bidirectional.
   Both kernels also at every other shape the bench phase gives them, in
   bf16, held and route-checked but not timed (``BENCH_SE``, ``BENCH_LSTM``):
   batch 1, 8 and 64 at 32x128, and 64x256 lines at batch 512, where K1's
   16x64x256 layers must take the streaming route and K2 runs T=32.
   A check that fails here names the worst value's index, launches the
   kernel once more and says whether it is bit-equal, and gives the kernel's
   and the plain version's distance from the function in fp64.
3b. Bench phase, alone on the card: ``rcnn_ocr_tpu_torch.bench.run`` (the
   module ``python -m rcnn_ocr_tpu_torch.bench`` runs) in this process:
   ``bench.py``'s rows at batch 2048 (64x256 at 512) on the shipped model
   with seeded weights, the static scales calibrated on 256 rendered lines.
   Its JSON line is printed as the module prints it; its keys must be
   ``bench.py``'s, every rate finite and > 0, every latency >= 0, the
   calibration input "rendered", and every row (and the calibration pass)
   must launch 11 squeeze-excite and 2 BiLSTM kernels an encode.  Prints
   each row's encodes, launches and seconds and the peak device memory.
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
5. Beam phase: the same model and images with a seeded bigram table
   (``train_bigram_lm`` over 4,000 seeded strings of the charset) through
   ``OCRInference`` in bf16 at batch 256: ``predict(beam_width=5)`` plain,
   with ``lm_weight`` 0 and 0.5 and with ``length_penalty=0.6``, and
   ``predict_ctc(method="beam")`` on the device beam (width 16, prune_k 16)
   plain, with ``lm_weight`` 0 and 0.5, and on the host C++ beam
   (``device_beam=False``).  Each call, counted from 0, must launch 11
   squeeze-excite and 2 BiLSTM kernels per encoded batch and return one
   string per image; fusion at weight 0 must equal the unfused beam exactly
   (strings and confidences, both heads).  Prints img/s per mode (host
   resize included), the device ms of one batch's encoder and of each
   search alone (CUDA events), the host beam's ms, and per mode the wall,
   device busy time, kernel count and idle share of one profiled batch.
   In fp32: beam width 1 must equal greedy through the first EOS on >= 99%
   of rows, and where it does not, greedy's logits of its token and the
   beam's at the first differing step must be within 1e-4 (a near-tie the
   beam breaks to the lower class id; each such row is printed with its
   tokens and gap); the device CTC beam at prune_k = W + 1 the host C++ beam
   on the same pruned frames on >= 99% of rows; the card's CTC beam (plain
   and fused) the same function on the CPU on the same frames on every row,
   log-probs and posteriors within 1e-5; the card's fused attention beam
   the CPU's on the same encoder states on >= 99% of rows.
6. Serving phase: ``predict_serving`` (the C++ letterbox into pinned
   buffers, resize-pad on the card) with ``canvas="auto"`` on the same
   model and 512 images in bf16 at batch 256, for attention, attention
   beam (K 5), CTC greedy and the CTC device beam (W 16, prune_k 16).  The
   device resize-pad of every image must be within one uint8 step of the
   host ``ResizeAndPad`` (differing pixels and bit-equal rows printed) and
   equal with TF32 on and off; each call, counted from 0, must launch 11
   squeeze-excite and 2 BiLSTM kernels per batch and give one string per
   image, equal to ``predict`` / ``predict_ctc``'s on every image whose row
   is bit-equal.  Prints img/s per method beside the host-resize path's in
   the same call; per batch the host ``_to_rgb`` and letterbox ms, the H2D
   ms and MB, the device resize, encoder and per-method kernel ms (CUDA
   events), and per method the wall, device busy time, kernels and idle
   share of one profiled batch.
   Daemon phase: the host C++ JPEG decoder against cv2's pixels of the
   committed fixtures (tests/torch_port_data/jpeg/: baseline, progressive
   whole and cut short, arithmetic-coded, CMYK and YCCK, lossless; the
   files cv2 gives None on, lossless gray and YCbCr, SOF11, hierarchical,
   12-bit and DNL frames, raise ValueError naming them), the TIFF decoder
   against those of tests/torch_port_data/tiff/ (CCITT, JPEG-in-TIFF,
   YCbCr, BigTIFF, signed samples, old-style LZW, planar YCbCr JPEG, CIELab
   and SGI LogL among them; the files cv2 gives None on, ZSTD, LZMA, WebP,
   LERC, PixarLog and old-style JPEG compression, float, untyped and 32-bit
   samples, ICCLab, ITULab and ThunderScan, raise ValueError naming them)
   and of tests/torch_port_data/tiff_variants/ (SGI LogLuv32 and LogLuv24,
   subsampled YCbCr with the predictor), the PNG decoder against those of
   tests/torch_port_data/png/ (EXIF orientations 1-8 in both byte orders
   before and after the image data, the chunk rules libpng forgives; the
   files cv2 gives None on raise ValueError naming the cause) and the BMP
   decoder against
   those of tests/torch_port_data/bmp/ (1/4/8/16/24/32-bit, RLE8, RLE4, OS/2
   to V5 headers), and the WebP, GIF and Netpbm decoders against those of
   tests/torch_port_data/{webp,gif,pnm}/, the JPEG 2000 decoder (host
   C++) against those of tests/torch_port_data/jp2/ (PIL's, cv2's and
   OpenJPEG's writers: every code-block style, POC, ROI, PPM/PPT, tiles
   and tile-parts, palettes; HTJ2K code-blocks from the fixture script's
   own HT encoder; a Part 1 stream flagged HT raising ValueError as cv2
   gives None) and
   the Sun raster, PFM and Radiance HDR decoders against those of
   tests/torch_port_data/raster/ (each also: a line cut short and a header
   past OpenCV's size limit raise ValueError, an AVIF header is refused
   naming it);
   then the port's ``OCRServer`` on 127.0.0.1
   over the same weights (bf16, batch 256, 5 ms window, canvas 80x640) for
   ctc_greedy and then attention: the port's client, in a process of its
   own, sends the 512 lines as PNG, 64 JPEG lines and 46 lines as
   progressive, arithmetic, YCCK and lossless JPEG, TIFF, BigTIFF, CIELab
   TIFF, LogLuv32 and LogLuv24 TIFF, PNG and WebP of EXIF orientation 6,
   G4 and G3 TIFF,
   JPEG-in-TIFF (YCbCr 2x2), YCbCr TIFF (LZW), 1-bit and RLE8 BMP, lossy
   WebP, lossless WebP with alpha, interlaced GIF with a transparent index,
   binary PGM, lossless JP2, an irreversible J2K codestream, an HTJ2K JP2,
   a colormapped Sun raster, a PF PFM and a run-length encoded HDR, each
   beside a PNG of its pixels, raw and in 8-image JSON batches, from 1
   (16 + 16 lines and the 46 pairs), 16 and 64 threads; strings must equal in-process
   ``predict_serving`` on >= 99% of rows, every variant line's strings its
   PNG twin's, and each dispatch launch 11 + 2 kernels.  The host decode
   time per line of each format is printed beside the card's name and
   power limit.  A ZSTD TIFF (cv2 gives None: its libtiff lacks ZSTD) gets
   the daemon's status and body for other bytes cv2 cannot read (a text
   file): 400 and the decoder's ValueError.  Two SIGHUP reloads
   with 16 clients in flight must drop nothing, and the old engine must be
   released (a second reload adds no memory to the first; with the cuBLAS
   workspaces cleared, memory returns to where it was); a drain with 64
   requests queued answers all 64, and 503 to those sent while draining.
   Prints req/s, img/s and p50/p95/p99 per level, the dispatch split and
   one profiled dispatch.
7. Long-line phase: 128 seeded lines 24-48 high of 2-15 tiles (tile 128,
   overlap 64) and 32 lines that fit one tile, through ``predict_long`` in
   bf16 at batch 256 for ctc_greedy, ctc_beam, attention (``align`` and
   ``text`` merges), attention_beam, hybrid and hybrid_beam: 11 + 2
   launches per encoded tile (or crop) batch, one string per line; the
   one-tile lines equal ``predict`` / ``predict_ctc`` exactly; the ids fast
   path equals the top-k path on every line; in fp32 the stitched CTC
   strings through the kernels equal those under ``plain_only()`` on every
   line and the attention ones on >= 99%.  Prints lines/s and tiles/s per
   method, and the host plan, stitch and extraction ms against the ids
   kernel's device ms.
7b. int8 + artifacts phase, on the main path's model and 512 lines, bf16
   at batch 256.  (1) The first conv of each stage and ``out1``, their
   inputs captured from an int8 batch: the int32 accumulators of the same
   codes on the card and on the CPU must be equal; each int8 conv
   (quantize, im2col, ``torch._int_mm``, dequantize) is timed beside the
   bf16 cuDNN conv of its shape.  (2) ``OCRInference(quantize=True)``
   dynamic, and static after ``calibrate`` on 256 lines: ``predict`` and
   ``predict_ctc`` with 11 + 2 launches per batch, img/s beside bf16's in
   the same call and the int8-vs-bf16 string agreement (random weights:
   printed, not held); every K1 and K2 launch of a batch on the int8 path
   within tolerance of its plain version on the same inputs, two runs
   through the kernels (and two under ``plain_only()``) giving the same
   strings, and the kernels-vs-plain string agreement printed (a kernel's
   one-ulp difference moves these random weights' strings; TOL says how).
   (3) ``save_calibration`` reopens on the static path
   with the same strings.  (4) Artifacts of ``ctc_greedy`` int8-static,
   ``attention`` bf16 and ``hybrid_long`` bf16, each loaded fresh, give the
   live ``predict_serving`` (``predict_hybrid_long``) strings on every row,
   their programs launching 11 + 2 per batch; one exported on the CPU with
   ``platforms=("cuda", "cpu")`` runs on the card as well.  Prints export
   seconds, the cold start (load + first batch), img/s against the live
   engine and every file's size.  (5) ``python -m rcnn_ocr_tpu_torch.serve
   --artifact`` in a process of its own (started beside the CPU export)
   answers 64 lines from 16 client threads with the in-process strings; a
   SIGHUP after a re-export at batch 128, with clients in flight, drops no
   request.
7c. Model-options phase, on the main path's model and 512 lines at
   bs 256, 32x128: (1) ``RCNN(stem_s2d=True)`` (the exact space-to-depth
   rewrite of stem0) against the default stem in fp32: encoder states
   within ``TOL["enc"]``, CTC tokens equal on every row, attention tokens
   on >= 99% (bf16 agreement printed).  (2) The stem0 conv alone in bf16:
   cuDNN's 3x3 against the rewrite (and its 2x2 conv alone), held to each
   other at ``TOL["bf16"]`` and timed beside the bytes bound.  (3) A static
   int8 model with an int8 stem (``quantize_stem``, calibrated by
   ``calibrate`` on 256 lines: stem0 / stem1 ``act_absmax`` finite and
   > 0) against the static int8 model with a float stem: strings agreement
   and both img/s printed.  (4) ``resize_pad_normalize(method="linear")``
   on the serving phase's canvas, card against its CPU twin within 1e-5,
   then encoded and decoded beside the area resize (agreement printed).
   Every encode launches 11 + 2 (the ``model_options`` path).
7d. Mesh phase (serving across replicas), on the main path's model and 512
   lines, bf16 at batch 256.  (1) ``OCRInference(mesh=True)`` on the visible
   cards; with one card its ``predict`` and ``predict_ctc`` strings,
   confidences and launch counts must equal ``mesh=None``'s bit for bit.
   (2) ``mesh=["cuda:0", "cuda:0"]`` (two replicas, each a thread and a
   stream, one 128-row block of every batch), and ``["cuda:0", "cuda:1"]``
   where there are two cards: ``predict`` and ``predict_ctc`` in bf16 and in
   fp32 and ``predict_serving`` (CTC greedy and attention) launch 11 + 2
   per block, two blocks a batch; fp32 CTC strings equal the engine without
   a mesh on every row, fp32 attention and every bf16 decode on >= 99%
   (differing rows printed).  With two cards, K1 and K2 also run on cuda:1
   from a thread whose current card is cuda:0, held against their plain
   versions.  (3) A ``ctc_greedy`` artifact loaded with the mesh equals the
   same artifact without one on every row.  (4) ``python -m
   rcnn_ocr_tpu_torch.serve --mesh`` and the same daemon without ``--mesh``,
   each in a process of its own (the two started and warmed up side by
   side), under
   ``python -m rcnn_ocr_tpu_torch.serve_loadtest`` at 1, 16 and 64 clients
   (32, 128 and 256 requests, every one answered); their JSON lines are printed beside the daemon
   phase's readings.  (5) The model exported as a full-layout ``.pth`` and
   read back by ``OCRInference``: the same attention strings.  Prints img/s
   of every engine measured in this call and says whether a run across
   cards happened.
7e. CLI phase: the main path's weights written as a msgpack checkpoint;
   ``python -m rcnn_ocr_tpu_torch.minimal_inference MODEL CHARSET LINE.png``
   once as a subprocess, as a user runs it (its wall from process start to
   exit is the cold start), then its flag matrix in-process (greedy,
   ``--serving``, ``--beam-width 5 --lm --lm-weight 0.5 --length-penalty
   0.6`` plain and under ``--serving``, ``--width-buckets 64,128``, the
   default size, ``--quantize``, and the mesh phase's ``.pth``) over a PNG
   line and the lossless JPEG, BigTIFF and CIELab TIFF lines: each run,
   counted from 0, launches 11 + 2 for its one image (the ``cli`` path) and
   prints the string the engine it built gives through ``predict`` /
   ``predict_serving`` at batch 1; the subprocess prints the in-process
   greedy string, and ``--lm-weight`` without a beam raises ValueError.
7f. Synthetic phase (files under build/chip_smoke/synthetic/): the port's
   line generator (``data/synthetic.py``: the hand-written TrueType reader
   and rasterizer, the effects, the JPEG encoder; host C++ built from the
   repo's sources at first use) with the carried font
   tests/torch_port_data/fonts/DejaVuSans.ttf.  A seeded set a difficulty
   must give tests/torch_port_data/synthetic/expected.json's sha256 of its
   CSV and of every image's pixels (this host's bytes are the CPU's).  The
   CLI's default dataset (512 train + 128 val medium lines at img_h 48,
   charset.txt, config.json with one epoch) and 128 hard lines are written
   through ``generate_dataset``, printing lines/s and host ms per line per
   stage (glyphs, warp, blur, noise, JPEG, resize, PNG write); ``python -m
   rcnn_ocr_tpu_torch.make_synthetic_dataset`` runs as a subprocess on 64
   + 16 lines where the host has fonts (else a line says it has none);
   ``python -m rcnn_ocr_tpu_torch.training.train`` trains the written
   config.json (the shipped model, batch 128, one epoch): finite losses,
   11 + 2 launches per train step and validation batch (the ``synthetic``
   path); ``python -m rcnn_ocr_tpu_torch.evaluate`` on val/eval.csv reads
   all 128 rows and prints the accuracy (not held).  The phase must end
   within 120 s.
8. Training phase.  (a) Gradient check: the same full-width model in fp32
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
9. Training-loop phase: writes seeded line images (30 characters of
   configs/charset.txt with fixed 12x8 glyph bitmaps, labels of 4-12, lines
   32-48 high, 8-bit RGB PNGs whose rows cycle through all five filter
   types) in the shipped layout into build/chip_smoke/data/, and runs
   ``run_training`` on the card with configs/config.json, overriding only
   the data paths, exp_dir, epochs, eval_every 1, val_size, num_workers 8,
   head "both" and, for run 1, profile_steps (a torch.profiler window of 4
   steps in epoch 1 gives the card's idle share).  Run 1 trains 2 epochs of
   2 x 256 lines and is cut by SIGTERM 3 steps into epoch 3: losses must
   be finite and fall (last epoch's mean train loss and last validation loss
   below the first), all three slots and metrics_epoch.csv must exist, the
   preempted slot must restore bit for bit (parameters, statistics, Adam
   moments, learning rate).  Run 2 resumes from the experiment dir and
   finishes epoch 3 with global_step counting on.  Every run must launch
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
   beside the bare train step's img/s.  Then the checkpoint tools on the
   three slots (files under build/chip_smoke/ckpt_tools/), as
   subprocesses where flax does not import: ``python -m
   rcnn_ocr_tpu_torch.average_checkpoints`` uniform and with ``--weights
   0.5,0.3,0.2`` must exit 0 with every leaf bit-equal to numpy's float64
   mix of the slots; ``python -m rcnn_ocr_tpu_torch.ckpt_info --json`` on
   each slot and average must exit 0 and describe the blob, on a copy
   stamped format 2 exit 2, on a missing path exit 1; ``OCRInference`` on
   the uniform average reads set B's validation lines with 11 + 2 launches
   a batch (the ``checkpoint_average`` path), its exactly-right count
   printed beside last_weights' and each tool's wall time.  Started once
   the resumed run has written last_weights.msgpack and finished last (beside
   the device-augmentation run, the ``OCRInference`` checks and the
   checkpoint tools), ``python -m
   rcnn_ocr_tpu_torch.evaluate`` runs as a subprocess on last_weights.msgpack
   over set B's validation PNGs, ``--decode ctc_beam`` and
   ``--decode attention_beam`` with a bigram table of the training labels
   and ``--lm-weight 0,0.5``: each must exit 0 and write a report of all 128
   rows and a per-sample CSV of 128 rows; their wall times are printed.
   Beside them (four processes on the card at once), ``--decode
   ctc_greedy`` over a CSV of the 38 lines of the newest
   formats (G4 and G3 TIFF, JPEG-in-TIFF, YCbCr TIFF, 1-bit and RLE8 BMP,
   lossy WebP, lossless WebP with alpha, interlaced GIF, binary PGM, JPEG
   2000, Sun raster, PFM, HDR, lossless JPEG, BigTIFF, CIELab TIFF, PNG and
   WebP of EXIF orientation 6, LogLuv32 and LogLuv24 TIFF, HTJ2K) and over
   one of PNG twins of their pixels: both exit 0 with all 38 rows read and
   the same string for every line as for its twin.
10. Scale-out phase, on half of the loop phase's set A (its first 384
   lines: 256 to train, 128 to validate) with configs/config.json in fp32
   at the global batch of 128 for one epoch, each run a subprocess of
   ``python -m rcnn_ocr_tpu_torch.training.train --deterministic`` with
   TF32 off and every collective bounded by a timeout, the first three
   jobs side by side on the card and then the last two, with (3) and (4)
   beside them (their numbers do not move; their times are under
   contention): (1) under ``python -m
   torch.distributed.run --nproc-per-node 1`` (NCCL) its losses must equal
   the run with no group exactly; (2) two ranks over gloo on cuda:0 must
   match the run with no group within rtol 1e-3 per epoch (train and val
   loss), report the same validation metrics, and leave only rank 0's files
   (slots, CSV, one events file, a log without rank 1); each rank launches
   11 + 2 kernels per batch.  Prints step, all-reduce and loader-wait ms per
   step of each.  (2b) ``tp2``: both heads (so that every leaf a model
   axis shards trains; without ``--deterministic``, since the CTC loss's
   backward has no deterministic CUDA kernel) and ``mesh_shape [1, 2]``
   over ``("data", "model")``, two gloo ranks on cuda:0 holding the 29
   leaves JAX's
   ``param_shardings`` shards on a model axis of 2 (each rank's
   ``tp_report`` must equal that list), K1 on the gathered channels and K2
   with ``w_hh`` gathered, 11 + 2 launches per batch on each rank, against
   ``alone_both``, the run with no group of the same configuration: losses
   within rtol 1e-3, the same validation metrics on both ranks, only rank
   0's files, and a 'last' checkpoint of the whole JAX tree (every leaf's
   shape as ``alone_both``'s) that ``OCRInference`` loads in fp32 and reads
   the validation lines with: CTC strings equal to ``alone_both``'s on
   every line and attention strings on at least 90% (two trainings that
   differ only in reduction order flip 1-4 of 128 greedy decodes of these
   two-step weights at near-tied tokens; the data axis's gloo2-vs-alone
   pair is printed beside), its weights within 2 * lr * steps of
   ``alone_both``'s on every element.  Prints per rank step ms, the model axis's collective
   seconds and bytes per step, the all-reduce's, parameter, gradient and
   Adam bytes against the run with no group's, and peak CUDA memory.  (3) ``run_hpo`` over the shipped configuration in bf16:
   2 trials x 2 epochs with ``hidden_size`` 512 and ``lstm_layers`` 2 pinned
   ("LSTM 2 512") and the rest of ``DEFAULT_SPACE`` sampled; every trial
   finite, launching 11 + 2 per batch (K2 at H=512); prints each trial's
   params, value, epochs, pruning, seconds and launches.  (4) ``python -m
   rcnn_ocr_tpu_torch.hpo_search --trials 2 --epochs-per-trial 1
   --parallel-trials 2``, run beside the study and (2b), must warn and run one trial
   at a time on the one card.  (5) ``python -m rcnn_ocr_tpu_torch.hpo.report`` and the JAX
   package's stdlib ``tools/hpo_report.py``, run as subprocesses, must print
   the same report of the study.

Prints each phase's seconds, one ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``.  Any failed check raises and exits non-zero
before the last line.  Exits non-zero without a result when no CUDA device
is present or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import collections
import functools
import gc
import json
import math
import multiprocessing
import os
import shutil
import signal
import struct
import subprocess
import sys
import threading
import time
import warnings

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
# the kernels at the bench phase's other shapes (bf16 x and w_hh, as its
# models run): its latency rows (bs 1, 8, 64 at 32x128) and its 64x256 rows
# (bs 512), whose 16x64x256 squeeze-excite holds more than a CTA's 48 KiB
# run and takes the streaming route.  ((B, H, W, C), route); (T, B)
BENCH_SE = tuple(((b, *hwc), "cluster") for b in (1, 8, 64) for _, hwc in SE_SHAPES) + (
    ((512, 16, 64, 256), "streaming"), ((512, 8, 32, 512), "cluster"))
BENCH_LSTM = tuple((LSTM_T, b) for b in (1, 8, 64)) + ((2 * LSTM_T, 512),)
BATCH, BIG_BATCH, N_IMAGES, MAX_LENGTH = 256, 2048, 512, 25
# beam phase: attention beam width, CTC beam width (= prune_k), fusion weight
BEAM_WIDTH, CTC_BEAM, LM_WEIGHT = 5, 16, 0.5
# long-line phase: tile width and overlap, long lines and one-tile lines
LONG_TILE_W, LONG_OVERLAP, N_LONG, N_SHORT = 128, 64, 128, 32
COLD_BYTES = 100_000_000  # twice the H100's 50 MB L2
# daemon phase: a canvas covering every line (512 up to 79x632, JPEG lines up
# to 40x240), the daemon's batch and coalescing window, client threads
DAEMON_CANVAS, DAEMON_BATCH, DAEMON_WAIT_MS = (80, 640), 256, 5.0
DAEMON_CONCURRENCY = (1, 16, 64)
# mesh phase: the load tool's (concurrency, requests) levels
MESH_LOAD = ((1, 32), (16, 128), (64, 256))
RELOAD_MEM_MIB = 8
JPEG_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "jpeg")
TIFF_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "tiff")
BMP_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "bmp")
WEBP_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "webp")
GIF_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "gif")
PNM_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "pnm")
JP2_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "jp2")
RASTER_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "raster")
TIFF_VARIANT_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "tiff_variants")
# lines in the formats the port's decoders read beside baseline JPEG and PNG:
# (file, content type, variant), each sent to the daemon beside a PNG of its pixels
VARIANT_LINES = [(f"{stem}_line_{k}.{ext}", ctype, variant)
                 for stem, ext, ctype, variant in (
                     ("prog", "jpg", "image/jpeg", "progressive JPEG"),
                     ("arith", "jpg", "image/jpeg", "arithmetic JPEG"),
                     ("cmyk", "jpg", "image/jpeg", "YCCK JPEG"),
                     ("tiff", "tif", "image/tiff", "TIFF"),
                     ("g4", "tif", "image/tiff", "G4 TIFF"),
                     ("g3", "tif", "image/tiff", "G3 TIFF"),
                     ("jpeg", "tif", "image/tiff", "JPEG-in-TIFF"),
                     ("ycbcr", "tif", "image/tiff", "YCbCr TIFF"),
                     ("bmp1", "bmp", "image/bmp", "1-bit BMP"),
                     ("rle8", "bmp", "image/bmp", "RLE8 BMP"),
                     ("webp", "webp", "image/webp", "lossy WebP"),
                     ("webpa", "webp", "image/webp", "lossless WebP with alpha"),
                     ("gif", "gif", "image/gif", "interlaced GIF"),
                     ("pgm", "pgm", "image/x-portable-graymap", "binary PGM"),
                     ("jp2", "jp2", "image/jp2", "lossless JP2"),
                     ("j2k", "j2k", "image/jp2", "irreversible J2K codestream"),
                     ("ras", "ras", "image/x-sun-raster", "colormapped Sun raster"),
                     ("pfm", "pfm", "application/octet-stream", "PF PFM"),
                     ("hdr", "hdr", "image/vnd.radiance", "RLE HDR"))
                 for k in range(2)] + [
    ("lossless_line_0.jpg", "image/jpeg", "lossless JPEG"),
    ("bigtiff_line_0.tif", "image/tiff", "BigTIFF"),
    ("cielab_line_0.tif", "image/tiff", "CIELab TIFF"),
    ("pngo_line_0.png", "image/png", "PNG of EXIF orientation 6"),
    ("webpo_line_0.webp", "image/webp", "WebP of EXIF orientation 6"),
    ("luv32_line_0.tif", "image/tiff", "LogLuv32 TIFF"),
    ("luv24_line_0.tif", "image/tiff", "LogLuv24 TIFF"),
    ("htj2k_line_0.jp2", "image/jp2", "HTJ2K JP2")]
# the fax, JPEG-in-TIFF, YCbCr, BMP, WebP, GIF and PGM variants (the eval CLI
# reads them beside their PNG twins)
NEW_VARIANTS = ("G4 TIFF", "G3 TIFF", "JPEG-in-TIFF", "YCbCr TIFF", "1-bit BMP", "RLE8 BMP",
                "lossy WebP", "lossless WebP with alpha", "interlaced GIF", "binary PGM",
                "lossless JP2", "irreversible J2K codestream", "colormapped Sun raster", "PF PFM",
                "RLE HDR", "lossless JPEG", "BigTIFF", "CIELab TIFF", "PNG of EXIF orientation 6",
                "WebP of EXIF orientation 6", "LogLuv32 TIFF", "LogLuv24 TIFF", "HTJ2K JP2")
PNG_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "png")
# tests/torch_port_data/make_png_fixtures.py's CV2_NONE
PNG_CV2_NONE = {"none_no_iend_7x11.png": "truncated",
                "none_crc_idat_7x11.png": "b'IDAT' fails its CRC",
                "none_crc_ihdr_7x11.png": "b'IHDR' fails its CRC",
                "none_plte_after_idat_7x11.png": "without a PLTE before its IDAT",
                "none_idat_broken_7x11.png": "before its zlib stream ends",
                "none_second_ihdr_7x11.png": "b'IHDR' after the image data",
                "none_unknown_critical_7x11.png": "critical chunk b'ABCD' is unknown",
                "none_zlib_short_7x11.png": "ends before the image is whole",
                "none_adler_in_rows_7x11.png": "incorrect data check",
                "none_reserved_bit_7x11.png": "reserved bit",
                "none_actl_no_frames_7x11.png": "acTL"}
APNG_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "apng")
# tests/torch_port_data/make_apng_fixtures.py's CV2_NONE
APNG_CV2_NONE = {"none_fdat_stream_cut.png": "ends before its zlib stream does",
                 "none_fdat_no_data.png": "ends before its zlib stream does",
                 "none_fctl_dispose_3.png": "dispose op 3",
                 "none_fctl_outside.png": "outside the image",
                 "none_fctl_empty.png": "0x5 pixels",
                 "none_no_frame_after_idat.png": "truncated",
                 "none_two_fctl_no_data.png": "without image data"}
TIFF_GRAY_ALPHA_FIXTURES = os.path.join(REPO, "tests", "torch_port_data", "tiff_gray_alpha")
# the fixtures cv2 gives None on (tests/torch_port_data/make_*_fixtures.py's
# CV2_NONE), and the words the port's ValueError must name
TIFF_CV2_NONE = {"none_zstd.tif": "ZSTD TIFF compression (50000)",
                 "none_old_jpeg.tif": "old-style JPEG TIFF compression (6)",
                 "none_lzma.tif": "LZMA TIFF compression (34925)",
                 "none_webp.tif": "WebP TIFF compression (50001)",
                 "none_lerc.tif": "LERC TIFF compression (34887)",
                 "none_pixarlog.tif": "PixarLog TIFF compression (32909)",
                 "none_float.tif": "floating-point TIFF samples",
                 "none_float16.tif": "floating-point TIFF samples",
                 "none_untyped.tif": "untyped TIFF samples",
                 "none_signed32.tif": "32-bit TIFF samples",
                 "none_icclab.tif": "ICCLab TIFF",
                 "none_itulab.tif": "ITULab TIFF",
                 "none_thunderscan4.tif": "4-bit TIFF samples",
                 "none_bigtiff_no_directory.tif": "directory"}
JPEG_CV2_NONE = {"none_lossless_gray.jpg": "lossless gray",
                 "none_lossless_ycbcr_jfif.jpg": "lossless YCbCr",
                 "none_lossless_12bit.jpg": "12-bit lossless",
                 "none_lossless_arith_sof11.jpg": "SOF11",
                 "none_lossless_restart_not_a_row.jpg": "restart interval",
                 "none_hierarchical_sof5.jpg": "hierarchical",
                 "none_12bit_sof1.jpg": "12-bit",
                 "none_dnl_height.jpg": "DNL"}


def cv2_none_check(folder: str, cases: dict) -> int:
    """Each file of ``cases`` raises ValueError naming its cause (cv2 gives
    None on it, so the datasets quarantine the row), never
    UnsupportedImageFormat."""
    from rcnn_ocr_tpu_torch.data.image_io import UnsupportedImageFormat, imread

    for name, words in sorted(cases.items()):
        try:
            imread(os.path.join(folder, name))
            check(False, f"{name} decoded (cv2 gives None: it must raise ValueError)")
        except UnsupportedImageFormat as err:
            check(False, f"{name} raised UnsupportedImageFormat, not ValueError: {err}")
        except ValueError as err:
            check(words in str(err), f"{name}: the ValueError names otherwise: {err}")
    return len(cases)


def fixture_path(name: str) -> str:
    """A variant line's file among the committed fixtures."""
    if name.startswith("luv"):
        return os.path.join(TIFF_VARIANT_FIXTURES, name)
    folder = {".tif": TIFF_FIXTURES, ".png": PNG_FIXTURES, ".bmp": BMP_FIXTURES,
              ".webp": WEBP_FIXTURES,
              ".gif": GIF_FIXTURES, ".pgm": PNM_FIXTURES, ".jp2": JP2_FIXTURES,
              ".j2k": JP2_FIXTURES, ".ras": RASTER_FIXTURES, ".pfm": RASTER_FIXTURES,
              ".hdr": RASTER_FIXTURES}.get(os.path.splitext(name)[1], JPEG_FIXTURES)
    return os.path.join(folder, name)
# training phase: configs/config.json's shape and optimizer
TRAIN_BATCH, TRAIN_MAX_LEN, TRAIN_STEPS, GRAD_BATCH = 128, 40, 30, 32
TRAIN_LR, TRAIN_WD = 5e-4, 2e-5
# training-loop phase: two sets of LOOP_TRAIN lines (4 steps per epoch at
# quota 64 each), LOOP_VAL validation rows per set, LOOP_EPOCHS full epochs
# and one more cut by SIGTERM; LOOP_SMALL rows per set for the short
# device-augmentation run (LOOP_SMALL_TRAIN of set A's to train)
LOOP_CHARS, LOOP_TRAIN, LOOP_VAL, LOOP_EPOCHS = 30, 256, 128, 2
LOOP_SMALL, LOOP_SMALL_TRAIN, LOOP_PROFILE_STEPS = 384, 256, 4
# scale-out phase: the collectives' timeout, a training subprocess's, and the
# HPO study ("LSTM 2 512") in trials and epochs; its runs train on the first
# DP_TRAIN + DP_VAL rows of set A (labels_half.csv), DP_VAL of them split off
# to validate
DP_TIMEOUT_S, DP_RUN_TIMEOUT_S, HPO_TRIALS, HPO_EPOCHS = 120, 400, 2, 2
DP_TRAIN, DP_VAL = 256, 128
# synthetic phase: the generator CLI's defaults (512 + 128 medium lines at
# img_h 48, seed 0) and SYNTH_HARD hard lines for the JPEG stage, from the
# carried font; the written config trains one epoch; the CLI itself runs on
# SYNTH_CLI_TRAIN + SYNTH_CLI_VAL lines where the host has fonts
SYNTH_TRAIN, SYNTH_VAL, SYNTH_HARD, SYNTH_CLI_TRAIN, SYNTH_CLI_VAL = 512, 128, 128, 64, 16
SYNTH_FONT = os.path.join(REPO, "tests", "torch_port_data", "fonts", "DejaVuSans.ttf")
SYNTH_EXPECTED = os.path.join(REPO, "tests", "torch_port_data", "synthetic", "expected.json")
SYNTH_PHASE_S = 120.0

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
    # fp32, beam width 1 vs greedy: a row may differ only where greedy's two
    # candidate logits are within rounding of each other.  The beam compares
    # cum + log_softmax sums whose fp32 ulp is 7.6e-6 at |sum| < 128, so
    # a gap under 1e-4 is a tie the beam broke to the lower class id
    "beam1_tie_gap": 1e-4,
    # The int8 engines are held per launch (each K1 / K2 launch of a batch
    # against its plain version, "bf16" / "fp32" above) and for determinism,
    # not by strings kernels vs plain, which these random weights make a
    # measure of their own sensitivity (bf16 vs fp32 attention strings agree
    # on 287/512 on the main path).  My chip runs 1-3 (PR 8): in fp32 K1's
    # one-ulp differences (~3% of its outputs) flip int8 codes: CTC 496/512,
    # attention 489/512; in bf16 K1 is bit-equal on the int8 path and K2's
    # fp32 summation order (<= 3.3e-7 on 81% of its outputs) flips bf16
    # roundings of the LSTM output: CTC 504-507/512, attention 457/512
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def held(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str,
         again=None, exact=None) -> float:
    """Max abs error of ``got`` vs ``want``; raises beyond ``atol + rtol*|want|``.

    Where the kernel's output ``got`` is held, ``again()`` launches it once
    more on the same inputs and ``exact()`` computes the function in fp64.
    They are called only when the check fails, and the check fails all the
    same: the message then says where the worst value lies, whether the
    second launch is bit-equal to the first, and how far the kernel and
    the plain version each lie from fp64, which tells a kernel that is
    wrong or not deterministic from a plain version that rounds worse."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - want).abs()
    excess = (err - (atol + rtol * want.abs())).max().item()
    max_abs = err.max().item()
    print(f"  {what}: max abs err {max_abs:.3e}, {int((err > 0).sum())} of {err.numel()} "
          f"differ (rtol {rtol}, atol {atol})")
    if excess > 0:
        worst = np.unravel_index(int(err.argmax()), tuple(err.shape))
        msg = (f"{what}: outside rtol {rtol} / atol {atol} (max abs err {max_abs:.3e} at "
               f"index {tuple(int(i) for i in worst)}: kernel {got[worst].item():.9g}, "
               f"plain {want[worst].item():.9g})")
        if again is not None:
            second = again().float()
            moved = (second != got).sum().item()
            msg += (f"; a second launch is bit-equal to the first" if moved == 0 else
                    f"; a second launch differs from the first in {moved} values (max "
                    f"{(second - got).abs().max().item():.3e})")
        if exact is not None:
            ref = exact().double()
            msg += (f"; max abs err vs fp64: kernel {(got.double() - ref).abs().max().item():.3e}"
                    f", plain {(want.double() - ref).abs().max().item():.3e}")
        check(False, msg)
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
    """Every CUDA kernel (one nvcc per source) and every host C++ library
    (one g++ per source, missing ones only), all started together, so no
    later phase pays a build."""
    from concurrent.futures import ThreadPoolExecutor

    from rcnn_ocr_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.build_all)
        kernels.build_all(force=True)
        host_s = host.result()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {len(kernels.KERNELS)} kernels and "
          f"{len(host_s)} host libraries (g++ " + ", ".join(
              f"{n} {v:.1f} s" if v else f"{n} built" for n, v in host_s.items()) + ")")
    for k in kernels.KERNELS.values():
        print(f"  {k.name}: nvcc {k.build_seconds:.1f} s -> {k.library.name}")
        for line in k.build_log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"    {line.strip()}")


def se_scale_fp64(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """K1's function in fp64 (for the message of a failed check)."""
    x = x.double()
    g = torch.sigmoid(torch.relu(x.mean(dim=(1, 2)) @ w1.double()) @ w2.double())
    return x * g[:, None, None, :]


def scan_fp64(xs: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    """K2's recurrence in fp64 (for the message of a failed check)."""
    from rcnn_ocr_tpu_torch.models.lstm import lstm_cell_gates

    h = xs.new_zeros((2, xs.shape[2], hidden), dtype=torch.float64)
    c, w, ys = torch.zeros_like(h), w_hh.double(), []
    for x in xs:
        h, c = lstm_cell_gates(x.double() + torch.bmm(h, w), c, hidden)
        ys.append(h)
    return torch.stack(ys)


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
                           f"se_scale [{b},{h},{w},{c}] {name} vs plain",
                           again=lambda: se_scale(xb, w1, w2),
                           exact=lambda: se_scale_fp64(xb, w1, w2), **tol)
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
                       again=lambda: bilstm_scan(xs, w_hh, H),
                       exact=lambda: scan_fp64(xs, w_hh, H), **TOL["fp32"])
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
    # K2 at H=512 (the HPO space's width, trained by the scale-out phase's
    # study): w_hh fp32 takes the streaming route, bf16 the resident one in
    # clusters of 16 CTAs (the non-portable size)
    H2 = 2 * HIDDEN
    for wdt, want in ((torch.float32, "streaming"), (torch.bfloat16, "resident")):
        name = "fp32" if wdt == torch.float32 else "bf16"
        w_hh = (torch.randn(2, H2, 4 * H2, device=dev, generator=gen) / H2 ** 0.5).to(wdt)
        for b in (TRAIN_BATCH, BATCH):
            plan = lstm_route(b, H2, wdt)
            check(plan["route"] == want and (want == "streaming" or plan["cluster"] == 16),
                  f"bilstm_scan B={b} H={H2} w_hh {name} took {plan}")
            xs = torch.randn(T, 2, b, 4 * H2, device=dev, generator=gen)
            err = held(bilstm_scan(xs, w_hh, H2), scan_reference(xs, w_hh, H2),
                       what=f"bilstm_scan [{T},2,{b},{4 * H2}] w_hh {name} vs plain",
                       again=lambda: bilstm_scan(xs, w_hh, H2),
                       exact=lambda: scan_fp64(xs, w_hh, H2), **TOL["fp32"])
            errs.append(err)
            flop = 2 * T * 2 * b * H2 * 4 * H2
            nbytes = xs.numel() * 4 + T * 2 * b * H2 * 4 + w_hh.numel() * w_hh.element_size()
            bound = max(flop / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            sets = cold_sets(lambda: (torch.randn(T, 2, b, 4 * H2, device=dev, generator=gen),
                                      w_hh.clone(), H2), xs.numel() * 4)
            call = dict(shape=[T, 2, b, 4 * H2], hidden=H2, w_dtype=name, per_encode=2,
                        route=plan, max_abs_err=err,
                        ms=time_ms(lambda: bilstm_scan(xs, w_hh, H2)),
                        cold_ms=time_cold_ms(bilstm_scan, sets),
                        plain_ms=time_ms(lambda: scan_reference(xs, w_hh, H2)),
                        bound_ms=bound, flop=flop, bytes=nbytes,
                        bound_by="operations" if flop / FP32_FLOP_PER_S > nbytes / HBM_BYTES_PER_S
                        else "bytes")
            del sets
            call["bound_share_cold"] = call["bound_ms"] / call["cold_ms"]
            for d_in in (LSTM_D, 2 * H2):  # the encoder's first layer, and a 2H input
                ref = torch.nn.LSTM(d_in, H2, bidirectional=True).to(dev).eval()
                seq = torch.randn(T, b, d_in, device=dev, generator=gen)
                with torch.inference_mode():
                    call[f"library_ms_lstm_{d_in}_{H2}"] = time_ms(lambda: ref(seq))
            call["library_ms"] = call[f"library_ms_lstm_{LSTM_D}_{H2}"]
            lstm["calls"].append(call)
    main = next(c for c in lstm["calls"] if c["shape"][2] == BATCH and c["w_dtype"] == "bf16"
                and c["shape"][3] == 4 * H)

    # --- both kernels at the bench phase's other shapes: held and routed, not timed
    se["bench_shapes"], lstm["bench_shapes"] = [], []
    for (b, h, w, c), want in BENCH_SE:
        s = c // 16
        w1 = torch.randn(c, s, device=dev, generator=gen) / c ** 0.5
        w2 = torch.randn(s, c, device=dev, generator=gen) / s ** 0.5
        plan = se_route((b, h, w, c), s, torch.bfloat16)
        check(plan["route"] == want,
              f"se_scale [{b},{h},{w},{c}] bf16 took the {plan['route']} route, not {want}")
        xb = torch.randn(b, h, w, c, device=dev, generator=gen).to(torch.bfloat16)
        err = held(se_scale(xb, w1, w2), se_scale_reference(xb, w1, w2),
                   what=f"se_scale [{b},{h},{w},{c}] bf16 vs plain (bench)",
                   again=lambda: se_scale(xb, w1, w2),
                   exact=lambda: se_scale_fp64(xb, w1, w2), **TOL["bf16"])
        se["bench_shapes"].append(dict(shape=[b, h, w, c], route=plan, max_abs_err=err))
        se["max_abs_err"] = max(se["max_abs_err"], err)
    w_hh = (torch.randn(2, H, 4 * H, device=dev, generator=gen) / H ** 0.5).to(torch.bfloat16)
    for t, b in BENCH_LSTM:
        plan = lstm_route(b, H, torch.bfloat16)
        check(plan["route"] == "resident",
              f"bilstm_scan B={b} H={H} w_hh bf16 took the {plan['route']} route")
        xs = torch.randn(t, 2, b, 4 * H, device=dev, generator=gen)
        err = held(bilstm_scan(xs, w_hh, H), scan_reference(xs, w_hh, H),
                   what=f"bilstm_scan [{t},2,{b},{4 * H}] w_hh bf16 vs plain (bench)",
                   again=lambda: bilstm_scan(xs, w_hh, H),
                   exact=lambda: scan_fp64(xs, w_hh, H), **TOL["fp32"])
        lstm["bench_shapes"].append(dict(shape=[t, 2, b, 4 * H], route=plan, max_abs_err=err))
        errs.append(err)
    lstm.update(max_abs_err=max(errs), ms=2 * main["ms"], cold_ms=2 * main["cold_ms"],
                plain_ms=2 * main["plain_ms"], bound_ms=2 * main["bound_ms"],
                bound_us=2 * main["bound_ms"] * 1e3, bound_by=main["bound_by"],
                library_ms=2 * main["library_ms"])
    rows.append(lstm)
    return rows


def bench_phase(kernels, power: str) -> dict:
    """The port's ``python -m rcnn_ocr_tpu_torch.bench`` in this process,
    alone on the card: its JSON line (printed as the module prints it), its
    keys, finite rates, the rendered calibration input, and per row 11
    squeeze-excite and 2 BiLSTM launches an encode."""
    from rcnn_ocr_tpu_torch import bench

    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    line, details = bench.run("cuda:0")
    launches = kernels.launch_counts()
    print(json.dumps(line))
    check(tuple(line) == bench.JSON_KEYS, f"bench keys {tuple(line)}")
    rates = [k for k in bench.JSON_KEYS if k.endswith("img_s") or k.startswith("img_s")]
    check(all(math.isfinite(line[k]) and line[k] > 0 for k in rates + ["value"]),
          "a bench rate is not finite and positive")
    lat = ("latency_bs1_ms", "latency_bs8_ms", "latency_bs64_ms", "dispatch_floor_ms")
    check(all(math.isfinite(line[k]) and line[k] >= 0 for k in lat),
          "a bench latency is not finite and >= 0")
    check(line["calibration_input"] == "rendered", f"calibration on {line['calibration_input']}")
    check(line["platform"] == "gpu" and line["batch_64x256"] == 512, "bench platform or batch")
    print(f"  keys = bench.py's ({len(line)}), {len(rates)} rates finite and > 0, latencies "
          f">= 0, calibration_input {line['calibration_input']!r}")
    encodes = 0
    for name, row in details["rows"].items():
        n, got = row["encodes"], row["launches"]
        encodes += n
        print(f"  {name}: batch {row['batch']}, {n} encodes, se_scale {got['se_scale']}, "
              f"bilstm_scan {got['bilstm_scan']}, {row['seconds']:.1f} s")
        check(got == {"se_scale": 11 * n, "bilstm_scan": 2 * n},
              f"bench row {name}: {got} launches for {n} encodes")
    check(launches == {"se_scale": 11 * encodes, "bilstm_scan": 2 * encodes},
          f"bench launches {launches} for {encodes} encodes")
    peak = details["peak_memory_bytes"]
    print(f"  11 + 2 launches an encode on every row ({encodes} encodes); peak device memory "
          f"{peak / 2**30:.2f} GiB; {details['seconds']:.1f} s; {power}")
    return {"line": line, "rows": details["rows"], "peak_memory_bytes": peak,
            "seconds": details["seconds"], "launches": launches}


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


def device_batches(engine, images, batch: int):
    """``(chunk, real rows, normalized batch on the card)`` per batch the
    engine's ``predict`` builds from ``images``."""
    from rcnn_ocr_tpu_torch.ops.augment import device_normalize

    for chunk, n_real, x in engine._batches(images, batch):
        yield chunk, n_real, device_normalize(engine._device_batch(x))


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
    _, _, x = next(device_batches(engine, images[:BATCH], BATCH))
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
        for _, n_real, x in device_batches(ref, images, BATCH):
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
                attn_rows_equal=attn_same, rows=attn_rows, breakdown=breakdown), variables, images


def seeded_lm(cs, seed: int = 7):
    """A bigram table from train_bigram_lm over 4,000 seeded strings of 4-12
    single-character tokens of the charset."""
    from rcnn_ocr_tpu_torch.lm import train_bigram_lm

    rng = np.random.default_rng(seed)
    chars = [t for t in cs.itos if len(t) == 1]
    texts = ["".join(rng.choice(chars, size=int(rng.integers(4, 13)))) for _ in range(4000)]
    return train_bigram_lm(texts, cs)


def beam_phase(kernels, variables, images, power: str):
    """The beam decodes through OCRInference on the main path's model and
    images, then fp32 checks of both searches against greedy, the host beam
    and the same functions on the CPU."""
    import copy

    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.ops.ctc import (
        ctc_beam_from_logits,
        ctc_beam_search,
        ctc_beam_search_device,
        ctc_top_frames,
    )
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    charset_path = os.path.join(REPO, "configs", "charset.txt")
    cs = Charset.from_file(charset_path)
    lm = seeded_lm(cs)
    engine = OCRInference(variables, charset_path=charset_path, device="cuda", img_h=IMG_H,
                          img_w=IMG_W, dtype=torch.bfloat16, lm=lm)
    n_batches = -(-N_IMAGES // BATCH)
    attn = dict(max_length=MAX_LENGTH, batch_size=BATCH, beam_width=BEAM_WIDTH)
    ctc = dict(batch_size=BATCH, method="beam", beam_width=CTC_BEAM, prune_k=CTC_BEAM)
    modes = {
        "attention_beam": lambda imgs: engine.predict(imgs, return_confidence=True, **attn),
        "attention_beam_lm0": lambda imgs: engine.predict(imgs, return_confidence=True,
                                                          lm_weight=0.0, **attn),
        "attention_beam_lm": lambda imgs: engine.predict(imgs, lm_weight=LM_WEIGHT, **attn),
        "attention_beam_lp": lambda imgs: engine.predict(imgs, length_penalty=0.6, **attn),
        "ctc_beam": lambda imgs: engine.predict_ctc(imgs, return_confidence=True, **ctc),
        "ctc_beam_lm0": lambda imgs: engine.predict_ctc(imgs, return_confidence=True,
                                                        lm_weight=0.0, **ctc),
        "ctc_beam_lm": lambda imgs: engine.predict_ctc(imgs, lm_weight=LM_WEIGHT, **ctc),
        "ctc_host_beam": lambda imgs: engine.predict_ctc(imgs, device_beam=False, **ctc),
    }
    out, texts, launches = {"img_s": {}, "launches": {}}, {}, {"se_scale": 0, "bilstm_scan": 0}
    for mode, call in modes.items():
        call(images[:BATCH])  # warm-up
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        texts[mode] = call(images)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        out["launches"][mode] = counts
        for name, per in (("se_scale", 11), ("bilstm_scan", 2)):
            check(counts[name] == per * n_batches,
                  f"{mode} launched {name} {counts[name]}x, expected {per * n_batches}")
            launches[name] += counts[name]
        strings = [t[0] if isinstance(t, tuple) else t for t in texts[mode]]
        check(len(strings) == N_IMAGES and all(isinstance(t, str) for t in strings),
              f"{mode} returned no string per image")
        out["img_s"][mode] = N_IMAGES / wall
        print(f"  {mode}: {N_IMAGES / wall:.1f} img/s ({N_IMAGES} images, bs {BATCH}, bf16, "
              f"host resize included), {len(set(strings))} distinct strings, e.g. "
              f"{strings[:2]!r}; launches {counts}")
    for head in ("attention_beam", "ctc_beam"):
        check(texts[f"{head}_lm0"] == texts[head],
              f"{head}: lm_weight 0 differs from the unfused beam (strings or confidences)")
    print("  lm_weight 0 equals the unfused beam exactly (strings and confidences), both heads")

    # where one bs-256 batch's time goes (bf16): device time of the encoder and
    # of each search alone (CUDA events), the host beam, the profiled idle share
    _, _, x = next(device_batches(engine, images[:BATCH], BATCH))
    m = engine.model
    with torch.inference_mode():
        enc = m.encode(x)
        logits = m._ctc_head(enc)
        vals, idx = ctc_top_frames(logits, CTC_BEAM)
        dense = np.full((BATCH, vals.shape[1], cs.num_classes), -1e30, np.float32)
        np.put_along_axis(dense, idx.cpu().numpy(), vals.cpu().numpy(), -1)
        t0 = time.perf_counter()
        for _ in range(3):
            ctc_beam_search(dense, cs.ctc_blank_id, CTC_BEAM, already_log_probs=True)
        host_ms = (time.perf_counter() - t0) * 1e3 / 3
        breakdown = {
            "device_encode_ms": time_ms(lambda: m.encode(x), iters=5),
            "device_attention_beam_search_ms": time_ms(
                lambda: m.attn.beam_search(enc, BEAM_WIDTH, MAX_LENGTH), iters=3),
            "device_attention_beam_search_lm_ms": time_ms(
                lambda: m.attn.beam_search(enc, BEAM_WIDTH, MAX_LENGTH, lm_logp=engine._lms[0],
                                           lm_weight=LM_WEIGHT), iters=3),
            "device_ctc_beam_search_ms": time_ms(
                lambda: ctc_beam_from_logits(logits, blank_id=cs.ctc_blank_id,
                                             beam_width=CTC_BEAM, prune_k=CTC_BEAM), iters=3),
            "device_ctc_beam_search_lm_ms": time_ms(
                lambda: ctc_beam_from_logits(logits, blank_id=cs.ctc_blank_id,
                                             beam_width=CTC_BEAM, prune_k=CTC_BEAM,
                                             lm_logp=engine._lms[0], lm_weight=LM_WEIGHT), iters=3),
            "host_ctc_beam_ms": host_ms,
        }
    for mode in ("attention_beam", "attention_beam_lm", "ctc_beam", "ctc_beam_lm",
                 "ctc_host_beam"):
        for key, val in profiled(lambda: modes[mode](images[:BATCH]), mode).items():
            breakdown[f"{mode}_{key}_per_batch"] = val
    print(f"  per bs-256 batch (bf16) on {power}: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in breakdown.items()))
    out["breakdown"] = breakdown

    # fp32 checks on the main path's batches
    ref = OCRInference(variables, charset_path=charset_path, device="cuda", img_h=IMG_H,
                       img_w=IMG_W, dtype=torch.float32, lm=lm)
    m = ref.model
    cpu_attn = copy.deepcopy(m.attn).cpu()
    lm_t = ref._lms[0]
    rows = beam1 = host_same = 0
    attn_cpu_same, ctc_lp_err = 0, 0.0
    ties = []
    with torch.inference_mode():
        for chunk, n_real, x in device_batches(ref, images, BATCH):
            enc = m.encode(x)
            # beam width 1 is greedy through the first EOS, but for near-ties:
            # the beam ranks cum + log_softmax(logits), and where the greedy
            # top-2 logits differ by less than an fp32 ulp of that sum, both
            # round to one value and the beam takes the lower class id
            greedy_logits = m.attn(enc, batch_max_length=MAX_LENGTH)
            greedy = greedy_logits.argmax(-1).cpu().numpy()
            one = m.attn.beam_search(enc, 1, MAX_LENGTH)[0].cpu().numpy()
            for r, (g, b) in enumerate(zip(greedy[:n_real], one[:n_real])):
                n = int(np.argmax(g == cs.eos_id)) + 1 if cs.eos_id in g else len(g)
                if np.array_equal(g[:n], b[:n]):
                    beam1 += 1
                    continue
                t = int(np.argmax(g[:n] != b[:n]))
                top2 = torch.topk(greedy_logits[r, t].float(), 2).values
                ties.append(dict(row=chunk[r], step=t, greedy=g[:n].tolist(), beam=b[:n].tolist(),
                                 top2_gap=float(top2[0] - top2[1]),
                                 greedy_minus_beam_token=float(greedy_logits[r, t, g[t]]
                                                               - greedy_logits[r, t, b[t]])))
            # the device CTC beam at prune_k = W + 1 vs the host C++ beam on the
            # same pruned frames
            logits = m._ctc_head(enc)
            vals, idx = ctc_top_frames(logits, CTC_BEAM + 1)
            dev_labels, dev_lens, _ = ctc_beam_search_device(vals, idx, cs.ctc_blank_id,
                                                             CTC_BEAM)
            dense = np.full((BATCH, vals.shape[1], cs.num_classes), -1e30, np.float32)
            np.put_along_axis(dense, idx.cpu().numpy(), vals.cpu().numpy(), -1)
            host_labels, _ = ctc_beam_search(dense[:n_real], cs.ctc_blank_id, CTC_BEAM,
                                             already_log_probs=True)
            dl, dn = dev_labels.cpu().numpy(), dev_lens.cpu().numpy()
            host_same += sum(dl[b, : dn[b]].tolist() == host_labels[b] for b in range(n_real))
            # the card's searches vs the same functions on the CPU, same fp32 inputs
            for lm_kw in ({}, dict(lm_logp=lm_t, lm_weight=LM_WEIGHT, sos_id=cs.sos_id)):
                v16, i16 = vals[..., :CTC_BEAM], idx[..., :CTC_BEAM]
                got = ctc_beam_search_device(v16, i16, cs.ctc_blank_id, CTC_BEAM,
                                             return_posterior=True, **lm_kw)
                cpu_kw = dict(lm_kw, lm_logp=lm_t.cpu()) if lm_kw else {}
                want = ctc_beam_search_device(v16.cpu(), i16.cpu(), cs.ctc_blank_id, CTC_BEAM,
                                              return_posterior=True, **cpu_kw)
                check(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
                      "the card's CTC beam differs from the CPU's on the same frames")
                # log-probs are sums over the frames (|x| up to ~50): the card's
                # and the CPU's logaddexp differ in the last bits, a few fp32 ulps
                ctc_lp_err = max(ctc_lp_err, held(got[2].cpu(), want[2], rtol=1e-5, atol=1e-5,
                                                  what="CTC beam log-probs, card vs CPU"))
                held(got[3].cpu(), want[3], rtol=1e-5, atol=1e-5,
                     what="CTC beam posteriors, card vs CPU")
            got = m.attn.beam_search(enc, BEAM_WIDTH, MAX_LENGTH, lm_logp=lm_t,
                                     lm_weight=LM_WEIGHT)[0].cpu()
            want = cpu_attn.beam_search(enc.cpu(), BEAM_WIDTH, MAX_LENGTH, lm_logp=lm_t.cpu(),
                                        lm_weight=LM_WEIGHT)[0]
            attn_cpu_same += int((got == want).all(dim=1)[:n_real].sum())
            rows += n_real
    print(f"  fp32: beam width 1 = greedy through the first EOS on {beam1}/{rows} rows; device "
          f"CTC beam (prune_k {CTC_BEAM + 1}) = host C++ beam on {host_same}/{rows} rows; the "
          f"card's CTC beam = the CPU's on every row (log-probs within {ctc_lp_err:.2e}, "
          f"rtol 1e-5); "
          f"attention beam (K {BEAM_WIDTH}, fused) card = CPU on {attn_cpu_same}/{rows} rows")
    for tie in ties:
        print(f"  beam width 1 != greedy on row {tie['row']}: first at step {tie['step']}, greedy "
              f"{tie['greedy']}, beam {tie['beam']}; greedy logits there: top-2 gap "
              f"{tie['top2_gap']:.3e}, greedy token minus beam token {tie['greedy_minus_beam_token']:.3e}")
    check(beam1 >= 0.99 * rows, f"beam width 1 equals greedy on only {beam1}/{rows} rows")
    check(all(t["greedy_minus_beam_token"] <= TOL["beam1_tie_gap"] for t in ties),
          f"beam width 1 differs from greedy beyond a near-tie: {ties}")
    check(host_same >= 0.99 * rows, f"device and host CTC beams agree on {host_same}/{rows}")
    check(attn_cpu_same >= 0.99 * rows,
          f"the card's attention beam equals the CPU's on {attn_cpu_same}/{rows} rows")
    out.update(rows=rows, beam1_equals_greedy=beam1, beam1_ties=ties,
               device_ctc_equals_host=host_same,
               attention_card_equals_cpu=attn_cpu_same, ctc_card_vs_cpu_lp_max_abs_err=ctc_lp_err,
               launch_counts=launches)
    return out


def profiled(call, name: str) -> dict:
    """Wall, device busy time, kernel count and idle share of one call."""
    from rcnn_ocr_tpu_torch.utils.profiling import trace

    with trace(os.path.join(REPO, "build", "chip_smoke", f"profile_{name}")) as prof:
        call()
    return dict(wall_ms=prof.wall_s * 1e3, kernels=prof.kernels,
                device_busy_ms=prof.device_busy_s * 1e3 if prof.device_busy_s is not None else None,
                device_idle_share=prof.device_idle_share)


def serving_phase(kernels, variables, images, power: str):
    """predict_serving (resize-pad on the card) for the four decodes on the
    main path's model and images, against the host resize-pad path."""
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.ops.augment import device_normalize
    from rcnn_ocr_tpu_torch.ops.preprocess import host_letterbox, host_resize_geometry, resize_pad_u8

    charset_path = os.path.join(REPO, "configs", "charset.txt")
    engine = OCRInference(variables, charset_path=charset_path, device="cuda", img_h=IMG_H,
                          img_w=IMG_W, dtype=torch.bfloat16)
    n_batches = -(-N_IMAGES // BATCH)
    canvas = (max(im.shape[0] for im in images), max(im.shape[1] for im in images))
    print(f"  canvas {canvas[0]}x{canvas[1]} (\"auto\": the largest height and width of the "
          f"{N_IMAGES} images), {BATCH * canvas[0] * canvas[1] * 3 / 1e6:.1f} MB of uint8 a batch")

    # the device resize-pad of every image vs the host ResizeAndPad, and TF32
    rows_equal = np.zeros(N_IMAGES, bool)
    differing = 0
    tf32_equal = True
    for s in range(0, N_IMAGES, BATCH):
        chunk = images[s : s + BATCH]
        raw, sizes = host_letterbox(chunk, *canvas)
        sizes = np.concatenate([sizes, host_resize_geometry(sizes, IMG_H, IMG_W)], axis=1)
        raw_d, sizes_d = torch.from_numpy(raw).cuda(), torch.from_numpy(sizes).cuda()
        dev = resize_pad_u8(raw_d, sizes_d, IMG_H, IMG_W)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            tf32_equal &= torch.equal(resize_pad_u8(raw_d, sizes_d, IMG_H, IMG_W), dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        host = torch.from_numpy(np.stack([engine._preprocess(im, None) for im in chunk]))
        diff = (dev.cpu().int() - host.int()).abs()
        check(int(diff.max()) <= 1, f"device resize-pad {int(diff.max())} uint8 steps off the host")
        differing += int((diff > 0).sum())
        rows_equal[s : s + len(chunk)] = (diff == 0).flatten(1).all(dim=1).numpy()
    check(tf32_equal, "the device resize-pad changes with TF32 on")
    n_equal = int(rows_equal.sum())
    print(f"  device resize-pad vs host ResizeAndPad: {differing} of {N_IMAGES * IMG_H * IMG_W * 3}"
          f" pixels differ (each by one uint8 step), {n_equal}/{N_IMAGES} rows bit-equal; "
          f"TF32 on = TF32 off")

    attn = dict(max_length=MAX_LENGTH, batch_size=BATCH)
    ctc_beam = dict(beam_width=CTC_BEAM, prune_k=CTC_BEAM)
    methods = {  # method: (predict_serving knobs, the host-resize call it is held to)
        "attention": ({}, lambda imgs: engine.predict(imgs, **attn)),
        "attention_beam": (dict(beam_width=BEAM_WIDTH),
                           lambda imgs: engine.predict(imgs, beam_width=BEAM_WIDTH, **attn)),
        "ctc_greedy": ({}, lambda imgs: engine.predict_ctc(imgs, batch_size=BATCH)),
        "ctc_beam": (ctc_beam, lambda imgs: engine.predict_ctc(imgs, batch_size=BATCH,
                                                               method="beam", **ctc_beam)),
    }
    out = {"canvas": list(canvas), "differing_pixels": differing, "rows_bit_equal": n_equal,
           "tf32_equal": True, "img_s": {}, "predict_img_s": {}, "launches": {}}
    launches = {"se_scale": 0, "bilstm_scan": 0}
    serve = {}
    for method, (knobs, host_call) in methods.items():
        serve[method] = functools.partial(engine.predict_serving, canvas="auto", method=method,
                                          **attn, **knobs)
        serve[method](images[:BATCH])  # warm-up
        host_call(images[:BATCH])
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        served = serve[method](images)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for name, per in (("se_scale", 11), ("bilstm_scan", 2)):
            check(counts[name] == per * n_batches,
                  f"serving {method} launched {name} {counts[name]}x, expected {per * n_batches}")
            launches[name] += counts[name]
        check(len(served) == N_IMAGES and all(isinstance(t, str) for t in served),
              f"serving {method} returned no string per image")
        t0 = time.perf_counter()
        hosted = host_call(images)
        host_wall = time.perf_counter() - t0
        same = sum(a == b for a, b, eq in zip(served, hosted, rows_equal) if eq)
        rest_same = sum(a == b for a, b, eq in zip(served, hosted, rows_equal) if not eq)
        check(same == n_equal, f"serving {method}: {n_equal - same} strings differ from the host "
                               f"path on rows whose pixels are bit-equal")
        out["img_s"][method], out["predict_img_s"][method] = N_IMAGES / wall, N_IMAGES / host_wall
        out["launches"][method] = counts
        print(f"  {method}: predict_serving {N_IMAGES / wall:.1f} img/s, host-resize path "
              f"{N_IMAGES / host_wall:.1f} img/s in the same call ({N_IMAGES} images, bs {BATCH}, "
              f"bf16) on {power}; launches {counts}; strings equal on {same}/{n_equal} bit-equal "
              f"rows, and on {rest_same}/{N_IMAGES - n_equal} others (not held)")

    # where one served bs-256 batch's time goes
    rgb = [engine._to_rgb(im) for im in images[:BATCH]]
    buf = torch.empty((BATCH, *canvas, 3), dtype=torch.uint8, pin_memory=True)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, sizes = host_letterbox(rgb, *canvas, out=buf.numpy())
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for im in images[:BATCH]:
        engine._to_rgb(im)
    to_rgb_ms = (time.perf_counter() - t0) * 1e3
    sizes = np.concatenate([sizes, host_resize_geometry(sizes, IMG_H, IMG_W)], axis=1)
    raw_d, sizes_d = buf.cuda(), torch.from_numpy(sizes).cuda()
    breakdown = {
        "host_to_rgb_ms": to_rgb_ms,
        "host_letterbox_ms": sorted(walls)[1],
        "h2d_ms": time_ms(lambda: buf.to("cuda", non_blocking=True), iters=10),
        "h2d_mb": buf.numel() / 1e6,
        "device_resize_ms": time_ms(lambda: resize_pad_u8(raw_d, sizes_d, IMG_H, IMG_W), iters=10),
    }
    with torch.inference_mode():
        x = device_normalize(resize_pad_u8(raw_d, sizes_d, IMG_H, IMG_W))
        breakdown["device_encode_ms"] = time_ms(lambda: engine.model.encode(x), iters=5)
        for method, (knobs, _) in methods.items():
            kernel = engine.serving_kernel(method, max_length=MAX_LENGTH, **knobs)
            total = time_ms(lambda: kernel(raw_d, sizes_d), iters=3)
            breakdown[f"device_{method}_kernel_ms"] = total
            breakdown[f"device_{method}_decode_ms"] = (total - breakdown["device_resize_ms"]
                                                       - breakdown["device_encode_ms"])
    for method in methods:
        prof = profiled(lambda: serve[method](images[:BATCH]), f"serving_{method}")
        for key, val in prof.items():
            breakdown[f"{method}_{key}_per_batch"] = val
    print(f"  per served bs-256 batch (bf16) on {power}: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in breakdown.items()))
    out.update(breakdown=breakdown, launch_counts=launches)
    return out


# --- the HTTP daemon ----------------------------------------------------------------

def jpeg_decoder_check() -> dict:
    """The host C++ JPEG decoder against cv2's pixels of the committed
    fixtures (tests/torch_port_data/jpeg/expected.npz: baseline, progressive
    whole and cut short, arithmetic-coded, CMYK and YCCK, lossless), read
    without cv2; the fixtures cv2 gives None on (lossless gray and YCbCr,
    SOF11, hierarchical, 12-bit, DNL) and a truncated stream raise
    ValueError."""
    from rcnn_ocr_tpu_torch.native import jpeg_decode_u8

    with np.load(os.path.join(JPEG_FIXTURES, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    differing = []
    for name, want in sorted(expected.items()):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            got = jpeg_decode_u8(f.read())
        if got.shape != want.shape or not np.array_equal(got, want):
            differing.append(name)
    check(not differing, f"jpeg_decode_u8 differs from cv2's pixels on {differing}")
    variants = {v: sum(v in name for name in expected)
                for v in ("progressive", "cut_", "arith", "cmyk", "ycck", "lossless")}
    check(all(variants.values()), f"a variant has no fixture: {variants}")
    none = cv2_none_check(JPEG_FIXTURES, JPEG_CV2_NONE)
    with open(os.path.join(JPEG_FIXTURES, "line_00.jpg"), "rb") as f:
        line = f.read()
    try:
        jpeg_decode_u8(line[: len(line) // 2])
        check(False, "a JPEG cut in half decoded (it must raise ValueError)")
    except ValueError:
        pass
    print(f"  jpeg_decode_u8: {len(expected)} fixtures bit-equal to cv2's pixels "
          f"(subsamplings 4:4:4/4:2:2/4:2:0/4:4:0/4:1:1, gray, restarts, EXIF 3/6/8, "
          f"no DHT, damaged, 64 lines; {variants['progressive']} progressive, "
          f"{variants['cut_']} cut short, {variants['arith']} arithmetic, "
          f"{variants['cmyk'] + variants['ycck']} CMYK / YCCK, {variants['lossless']} "
          f"lossless); {none} that cv2 gives None on and a truncated one raise ValueError")
    return {"fixtures_bit_equal": len(expected), "variants": variants, "cv2_none": none}


def tiff_decoder_check() -> dict:
    """The port's TIFF decoder (data/tiff.py; LZW, CCITT fax and SGI LogL
    in host C++, JPEG through the host JPEG decoder) against cv2's pixels of
    the committed fixtures (tests/torch_port_data/tiff/expected.npz: Group 4,
    JPEG-in-TIFF, BigTIFF, signed samples, old-style LZW, planar YCbCr JPEG,
    CIELab and LogL among them), read without cv2; the files cv2 gives None
    on (ZSTD, LZMA, WebP, LERC, PixarLog, old-style JPEG, floats, untyped
    and 32-bit samples, ICCLab, ITULab, ThunderScan) raise ValueError naming
    the cause, a truncated file raises ValueError; and those of
    tests/torch_port_data/tiff_variants/ (SGI LogLuv32 and LogLuv24 at 8
    and 16 bits, strips and tiles, subsampled YCbCr with the horizontal
    predictor where libtiff undoes it and where it refuses to)."""
    from rcnn_ocr_tpu_torch.data.image_io import imread

    with np.load(os.path.join(TIFF_FIXTURES, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    differing = [name for name, want in sorted(expected.items())
                 if not np.array_equal(imread(os.path.join(TIFF_FIXTURES, name)), want)]
    check(not differing, f"the TIFF decoder differs from cv2's pixels on {differing}")
    kinds = {k: sum(n.startswith(k) for n in expected)
             for k in ("g4", "g3", "mh", "ccitt_rlew", "jpeg_", "ycbcr", "pil_1_group4",
                       "pil_l_jpeg", "bigtiff", "signed", "lzw_old", "jpeg_ycbcr_planar",
                       "cielab", "pil_lab", "sgilog")}
    check(all(kinds.values()), f"a TIFF kind has no fixture: {kinds}")
    none = cv2_none_check(TIFF_FIXTURES, TIFF_CV2_NONE)
    unread = sorted(set(f for f in os.listdir(TIFF_FIXTURES) if f.endswith(".tif"))
                    - set(expected) - set(TIFF_CV2_NONE))
    check(not unread, f"TIFF fixtures without cv2's pixels: {unread}")
    with np.load(os.path.join(TIFF_VARIANT_FIXTURES, "expected.npz")) as z:
        variants = {k: z[k] for k in z.files}
    differing = [name for name, want in sorted(variants.items())
                 if not np.array_equal(imread(os.path.join(TIFF_VARIANT_FIXTURES, name)), want)]
    check(not differing, f"the TIFF decoder differs from cv2's pixels on {differing}")
    for k in ("logluv32", "logluv24", "pred2", "luv32_line", "luv24_line"):
        kinds[k] = sum(n.startswith(k) or f"_{k}" in n for n in variants)
    with np.load(os.path.join(TIFF_GRAY_ALPHA_FIXTURES, "expected.npz")) as z:
        gray_alpha = {k: z[k] for k in z.files}
    differing = [name for name, want in sorted(gray_alpha.items())
                 if not np.array_equal(imread(os.path.join(TIFF_GRAY_ALPHA_FIXTURES, name)), want)]
    check(not differing, f"the TIFF decoder differs from cv2's pixels on {differing}")
    kinds["la_jpeg"] = len(gray_alpha)
    check(all(kinds.values()), f"a TIFF kind has no fixture: {kinds}")
    with open(os.path.join(TIFF_FIXTURES, "tiff_line_0.tif"), "rb") as f:
        line = f.read()
    try:
        from rcnn_ocr_tpu_torch.data.image_io import imdecode

        imdecode(line[: len(line) // 2])
        check(False, "a TIFF cut in half decoded (it must raise ValueError)")
    except ValueError:
        pass
    print(f"  TIFF decoder: {len(expected)} fixtures bit-equal to cv2's pixels (none, "
          f"PackBits, LZW, Deflate, predictor 2; gray 1/8/16, palette 1/4/8, RGB(A) 8/16, "
          f"CMYK; strips, tiles, planar, II and MM, orientations 1-8; CCITT "
          f"{kinds['g4'] + kinds['g3'] + kinds['mh'] + kinds['ccitt_rlew']}, JPEG-in-TIFF "
          f"{kinds['jpeg_']}, YCbCr {kinds['ycbcr']}, BigTIFF {kinds['bigtiff']}, signed "
          f"{kinds['signed']}, old-style LZW {kinds['lzw_old']}, planar YCbCr JPEG "
          f"{kinds['jpeg_ycbcr_planar']}, CIELab {kinds['cielab'] + kinds['pil_lab']}, LogL "
          f"{kinds['sgilog']}) and {len(variants)} more (LogLuv32 {kinds['logluv32']}, "
          f"LogLuv24 {kinds['logluv24']}, YCbCr with the predictor {kinds['pred2']}, LogLuv "
          f"lines) and {len(gray_alpha)} JPEG-compressed gray + alpha (two-component frames: "
          f"strips, tiles, quality 20, partial MCUs, planar); {none} that cv2 gives None on "
          "and a truncated one raise ValueError")
    return {"fixtures_bit_equal": len(expected) + len(variants) + len(gray_alpha), "kinds": kinds,
            "cv2_none": none}


def bmp_decoder_check() -> dict:
    """The port's BMP decoder (data/bmp.py) against cv2's pixels of the
    committed fixtures (tests/torch_port_data/bmp/expected.npz: 1/4/8-bit,
    16/24/32-bit, RLE8 and RLE4, OS/2 to V5 headers), read without cv2; a
    2-bit BMP and a truncated one raise ValueError as cv2 fails on them."""
    from rcnn_ocr_tpu_torch.data.image_io import UnsupportedImageFormat, imdecode, imread

    with np.load(os.path.join(BMP_FIXTURES, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    differing = [name for name, want in sorted(expected.items())
                 if not np.array_equal(imread(os.path.join(BMP_FIXTURES, name)), want)]
    check(not differing, f"the BMP decoder differs from cv2's pixels on {differing}")
    kinds = {k: sum(k in n for n in expected)
             for k in ("pal1", "pal4", "pal8", "rgb555", "rgb565", "rgb24", "rgb32", "rle8",
                       "rle4", "core", "_v5", "pil_1_")}
    check(all(kinds.values()), f"a BMP kind has no fixture: {kinds}")
    with open(os.path.join(BMP_FIXTURES, "pal4_11x19.bmp"), "rb") as f:
        pal4 = f.read()
    two_bit = pal4[:28] + b"\x02" + pal4[29:]
    for what, data in (("a 2-bit BMP", two_bit), ("a BMP cut in half", pal4[: len(pal4) // 2])):
        try:
            imdecode(data)
            check(False, f"{what} decoded (it must raise ValueError)")
        except UnsupportedImageFormat as err:
            check(False, f"{what} raised UnsupportedImageFormat, not ValueError: {err}")
        except ValueError:
            pass
    print(f"  BMP decoder: {len(expected)} fixtures bit-equal to cv2's pixels (palettes "
          f"1/4/8, 16-bit 5-5-5 / 5-6-5, 24 and 32-bit, RLE8 {kinds['rle8']} and RLE4 "
          f"{kinds['rle4']}, OS/2 core to V5 headers, PIL's 1-bit); a 2-bit and a truncated "
          f"BMP raise ValueError")
    return {"fixtures_bit_equal": len(expected), "kinds": kinds}


# headers of formats the port still refuses, and the name each refusal gives
# (JPEG 2000 decodes now: only AVIF is refused by its magic)
REFUSED_HEADERS = {"AVIF": b"\x00\x00\x00\x1cftypavif\x00\x00\x00\x00avifmif1miaf" + bytes(32)}


def web_decoder_check(folder: str, ext: str, kinds, line: str, oversized: bytes,
                      suffix: str = "") -> dict:
    """One of the port's WebP, GIF and Netpbm decoders against cv2's pixels
    of the committed fixtures in ``folder`` (``expected.npz``), read
    without cv2: every file bit-equal, every kind named in ``kinds``
    present, the line ``line`` cut in half and missing its last byte
    raising ValueError, ``oversized`` (a few bytes declaring an image past
    OpenCV's size limit, which cv2 refuses) raising ValueError, and an AVIF
    header refused naming the format.  With ``suffix``, the fixtures whose
    names end with it."""
    from rcnn_ocr_tpu_torch.data.image_io import UnsupportedImageFormat, imdecode, imread

    with np.load(os.path.join(folder, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files if k.endswith(suffix)}
    differing = [name for name, want in sorted(expected.items())
                 if not np.array_equal(imread(os.path.join(folder, name)), want)]
    check(not differing, f"the {ext} decoder differs from cv2's pixels on {differing}")
    found = {k: sum(k in n for n in expected) for k in kinds}
    check(all(found.values()), f"a {ext} kind has no fixture: {found}")
    with open(os.path.join(folder, line), "rb") as f:
        data = f.read()
    for what, cut in (("cut in half", data[: len(data) // 2]), ("missing its last byte", data[:-1]),
                      ("past OpenCV's size limit", oversized)):
        try:
            imdecode(cut)
            check(False, f"{line} {what} decoded (it must raise ValueError)")
        except UnsupportedImageFormat as err:
            check(False, f"{line} {what} raised UnsupportedImageFormat, not ValueError: {err}")
        except ValueError:
            pass
    for name, header in REFUSED_HEADERS.items():
        try:
            imdecode(header)
            check(False, f"a {name} header decoded (it must be refused)")
        except UnsupportedImageFormat as err:
            check(f"cannot decode {name}:" in str(err), f"the {name} refusal says: {err}")
    print(f"  {ext} decoder: {len(expected)} fixtures bit-equal to cv2's pixels ("
          + ", ".join(f"{k.strip('_')} {v}" for k, v in found.items())
          + f"); {line} cut short and a file past OpenCV's size limit raise ValueError; "
          "AVIF refused naming it")
    return {"fixtures_bit_equal": len(expected), "kinds": found}


def webp_decoder_check() -> dict:
    """The port's WebP decoder (data/webp.py, VP8 and VP8L in host C++)."""
    return web_decoder_check(WEBP_FIXTURES, "WebP", (
        "cv2_lossy", "lossless", "alpha_lossy", "alpha_lossless", "anim_", "segments",
        "simple", "lfdelta", "8parts", "bigcoeffs", "all_transforms", "16_modes", "meta",
        "bundle", "alph_raw", "alph_vp8l", "exif6_ii_vp8l", "exif5_mm_before_vp8", "exif6_anim",
        "exif6_no_flag", "exif6_prefixed", "exif6_after_junk", "webpo_line"), "webp_line_0.webp",
        # an animation's VP8X canvas of 2^24 x 2^24
        b"RIFF\x16\x00\x00\x00WEBPVP8X\x0a\x00\x00\x00\x02\x00\x00\x00" + b"\xff" * 6)


def png_ihdr(width: int, height: int) -> bytes:
    """A PNG's signature and an 8-bit RGB IHDR of ``width`` x ``height``."""
    import zlib

    body = b"IHDR" + struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + body
            + struct.pack(">I", zlib.crc32(body)))


def png_decoder_check() -> dict:
    """The port's PNG decoder (data/png.py, data/exif.py): the eXIf
    orientations, the chunk rules libpng under OpenCV forgives, the files
    cv2 gives None on raising ValueError naming the cause."""
    out = web_decoder_check(PNG_FIXTURES, "PNG", (
        "exif1_", "exif6_mm_pre", "exif6_ii_post", "exif8_", "crc_text", "crc_iend",
        "crc_exif6", "exif6_then_exif3", "exif6_prefixed", "exif6_cut_entry", "exif6_long",
        "plte_", "idat_split", "idat_extra", "zlib_past", "zlib_trailing", "after_iend",
        "adler_after_rows", "palette_index_past", "pngo_line"), "pngo_line_0.png",
        png_ihdr(1000001, 1))  # one pixel wider than libpng's 1,000,000
    out["cv2_none"] = cv2_none_check(PNG_FIXTURES, PNG_CV2_NONE)
    print(f"  PNG: {out['cv2_none']} files cv2 gives None on raise ValueError naming the cause")
    out["apng"] = apng_check()
    out["apng_cv2_none"] = cv2_none_check(APNG_FIXTURES, APNG_CV2_NONE)
    print(f"  APNG: the first frame where the IDAT image is hidden; {out['apng_cv2_none']} "
          "files cv2 gives None on raise ValueError naming the cause")
    return out


def apng_check() -> dict:
    """APNGs (tests/torch_port_data/apng/): the first frame as OpenCV 5's
    APNG path reads it, bit-equal to cv2's pixels, where the IDAT image is
    hidden (every colour type and depth, sub-rectangles, each blend and
    dispose op, split fdAT runs, PIL's writer, damage libpng forgives) and
    where it is the first frame; a file cut inside its first frame raises
    ValueError."""
    from rcnn_ocr_tpu_torch.data.image_io import imdecode, imread

    with np.load(os.path.join(APNG_FIXTURES, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    differing = [name for name, want in sorted(expected.items())
                 if not np.array_equal(imread(os.path.join(APNG_FIXTURES, name)), want)]
    check(not differing, f"the APNG decoder differs from cv2's pixels on {differing}")
    kinds = ("hidden_c0_1", "hidden_c0_16", "hidden_c2_16", "hidden_c3_1", "hidden_c4_16",
             "hidden_c6_8_adam7", "hidden_rgba_d2_b1", "hidden_rgb_full_split", "hidden_pil_rgb",
             "hidden_pil_rgba", "hidden_pil_l_", "hidden_pil_la", "hidden_pil_p",
             "hidden_damaged", "first_frame")
    found = {k: sum(n.startswith(k) for n in expected) for k in kinds}
    check(all(found.values()), f"an APNG kind has no fixture: {found}")
    with open(os.path.join(APNG_FIXTURES, "hidden_pil_rgb_23x61.png"), "rb") as f:
        data = f.read()
    try:
        imdecode(data[: len(data) // 2])
        check(False, "an APNG cut inside its first frame decoded (it must raise ValueError)")
    except ValueError:
        pass
    print(f"  APNG: {len(expected)} fixtures bit-equal to cv2's pixels ("
          + ", ".join(f"{k} {v}" for k, v in found.items()) + "); one cut inside its first "
          "frame raises ValueError")
    return {"fixtures_bit_equal": len(expected), "kinds": found}


def gif_decoder_check() -> dict:
    """The port's GIF decoder (data/gif.py, LZW in host C++)."""
    return web_decoder_check(GIF_FIXTURES, "GIF", (
        "pil_2colors", "pil_256colors", "interlaced", "pil_anim", "offset_transparent",
        "local_table", "no_tables", "deferred_clear", "full_table", "eoi_midstream", "app_"),
        "gif_line_0.gif", b"GIF89a\xff\xff\xff\xff\x00\x00\x00;")  # a 65535x65535 screen


def pnm_decoder_check() -> dict:
    """The port's Netpbm decoder (data/pnm.py)."""
    return web_decoder_check(PNM_FIXTURES, "Netpbm", (
        "p1_", "p2_", "p3_", "p4_", "p5_", "p6_", "p7_", "maxval15", "maxval100", "maxval1000",
        "maxval65535", "cv2_ascii"), "pgm_line_0.pgm",
        b"P5\n1048577 1\n255\n" + bytes(1048577))  # one pixel wider than 1 << 20


def jp2_decoder_check() -> dict:
    """The port's JPEG 2000 decoder (data/jpeg2000.py, the codestream in
    host C++): every fixture, the HTJ2K (Part 15) ones among them, bit-equal
    to cv2's pixels; the HT line equal to its PNG twin; and a Part 1
    codestream whose COD claims HT code-blocks raising ValueError, as cv2
    gives None on it (OpenJPEG reads its MQ-coded bytes as HT segments and
    fails)."""
    from rcnn_ocr_tpu_torch.data.image_io import imdecode, imread

    with open(os.path.join(JP2_FIXTURES, "pil_RGB_codestream_37x53.j2k"), "rb") as f:
        data = bytearray(f.read())
    oversized = bytearray(data)  # SIZ's image and tile widths made 1048577
    struct.pack_into(">I", oversized, 8, 1048577)
    struct.pack_into(">I", oversized, 24, 1048577)
    out = web_decoder_check(JP2_FIXTURES, "JPEG 2000", (
        "pil_L_", "pil_LA_", "pil_RGBA_", "pil_I16_", "irreversible", "LRCP", "RLCP", "RPCL",
        "PCRL", "CPRL", "tiles", "layers", "codestream", "cv2_", "bypass", "reset", "termall",
        "vsc", "pterm", "segsym", "sop_eph", "poc", "roi", "tile_parts", "ppm", "ppt", "prec12",
        "sycc", "palette", "cdef", "ht_gray_rev", "ht_rgb_irr", "ht_rgb_refine", "ht_gray_sigprop",
        "ht_rgb_layers", "ht_rgb_tiles_precincts_sop_eph", "ht_rgb_coc_part1", "ht_gray16",
        "ht_rgb_zblk", "ht_cover", "htj2k_line"), "jp2_line_0.jp2", bytes(oversized))
    out["ht_fixtures_bit_equal"] = sum(n.startswith(("ht_", "htj2k_")) for n in sorted(
        os.listdir(JP2_FIXTURES)) if n.endswith((".jp2", ".j2k")))
    check(np.array_equal(imread(os.path.join(JP2_FIXTURES, "htj2k_line_0.jp2")),
                         imread(os.path.join(JP2_FIXTURES, "htj2k_line_0.png"))),
          "the HTJ2K line differs from its PNG twin")
    data[data.index(b"\xff\x52") + 12] |= 0x40  # the HT code-block style over MQ data
    try:
        imdecode(bytes(data))
        check(False, "a Part 1 codestream flagged HT decoded (cv2 gives None on it)")
    except ValueError as err:
        check("HT code-block" in str(err), f"the flagged stream's error says: {err}")
    print(f"  JPEG 2000: {out['ht_fixtures_bit_equal']} HTJ2K fixtures among them; the HT line "
          "equals its PNG twin; a Part 1 stream flagged HT raises ValueError as cv2 gives None")
    return out


def raster_decoder_check() -> dict:
    """The port's Sun raster, PFM and Radiance HDR decoders (numpy)."""
    out = {}
    for ext, line, oversized in (
            ("ras", "ras_line_0.ras", b"\x59\xa6\x6a\x95" + struct.pack(">7I", 1048577, 1, 8,
                                                                       0, 1, 0, 0) + bytes(64)),
            ("pfm", "pfm_line_0.pfm", b"PF\n1048577 1\n-1\n" + bytes(64)),
            ("hdr", "hdr_line_0.hdr", b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 1048577\n"
             + bytes(64))):
        kinds = {"ras": ("cv2_", "1bit", "8bit_cmap", "short_cmap", "24bit", "32bit", "type0"),
                 "pfm": ("cv2_", "little_endian", "big_endian", "scale", "header_fields"),
                 "hdr": ("cv2_rle", "cv2_flat", "rle_then_flat", "rgbe_header", "narrow_flat")}[ext]
        out[ext] = web_decoder_check(RASTER_FIXTURES, {"ras": "Sun raster", "pfm": "PFM",
                                                       "hdr": "Radiance HDR"}[ext], kinds, line,
                                     oversized, suffix="." + ext)
    return out


def _post(base: str, body: bytes, ctype: str, timeout: float = 120.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + "/predict", data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def drive_daemon(base: str, jobs, concurrency: int, stop=None):
    """Run ``jobs`` ((idxs, kind, payload): kind "raw" with (ctype, body),
    or "batch" with a list of encoded images sent by OCRClient as one JSON
    batch) on ``concurrency`` client threads, round after round until
    ``stop`` is set when one is given.  Returns the start and end on the
    monotonic clock (shared by the processes of one machine) and one (idxs,
    latency s, status, texts or error) per request."""
    import itertools

    from rcnn_ocr_tpu_torch.client import OCRClient

    client = OCRClient(base, timeout_s=120, max_retries=0)
    counter = itertools.count()
    out, lock = [], threading.Lock()

    def worker():
        while True:
            k = next(counter)
            if stop is None and k >= len(jobs):
                return
            if stop is not None and stop.is_set():
                return
            idxs, kind, payload = jobs[k % len(jobs)]
            t0 = time.perf_counter()
            try:
                if kind == "raw":
                    status, reply = _post(base, payload[1], payload[0])
                    texts = reply.get("texts", reply.get("error"))
                else:
                    status, texts = 200, client.predict(payload)
            except Exception as err:  # a reset or refused connection
                status, texts = None, repr(err)
            with lock:
                out.append((idxs, time.perf_counter() - t0, status, texts))

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return t0, time.monotonic(), out


def undecodable_replies(base: str, imdecode) -> dict:
    """A ZSTD TIFF (cv2 gives None: its libtiff lacks ZSTD) posted to the
    daemon gets what other bytes cv2 cannot read get (a text file posted
    as a PNG): status 400 and the body ``{"error": "bad request: <the
    decoder's ValueError>"}``, never the refusal of a format cv2 reads."""
    with open(os.path.join(TIFF_FIXTURES, "none_zstd.tif"), "rb") as f:
        zstd = f.read()
    replies = {}
    for what, body, ctype in (("ZSTD TIFF", zstd, "image/tiff"),
                              ("text", b"not an image, a note\n", "image/png")):
        try:
            imdecode(body)
            check(False, f"{what}: the daemon's decoder read it")
        except ValueError as err:
            if isinstance(err, NotImplementedError):
                check(False, f"{what}: refused as unsupported, not ValueError: {err}")
            want = {"error": f"bad request: {err}"}
        replies[what] = _post(base, body, ctype)
        check(replies[what] == (400, want), f"{what}: the daemon answered {replies[what]}, "
                                            f"expected {(400, want)}")
    print(f"  bytes cv2 cannot read: a ZSTD TIFF answered {replies['ZSTD TIFF'][0]} "
          f"{replies['ZSTD TIFF'][1]}, as a text file is ({replies['text'][0]} "
          f"{replies['text'][1]})")
    return {k: {"status": v[0], "body": v[1]} for k, v in replies.items()}


def client_process(base: str, levels, conn) -> None:
    """A client process's work: each (name, jobs, concurrency) level in turn
    through :func:`drive_daemon`, the results sent back on ``conn``.  The
    clients run apart from the daemon, so their Python does not share its
    interpreter lock."""
    out = {}
    for name, jobs, concurrency in levels:
        out[name] = drive_daemon(base, jobs, concurrency)
        time.sleep(0.2)  # a gap between levels, so dispatches attribute cleanly
    conn.send(out)
    conn.close()


def cuda_tensors() -> collections.Counter:
    """Bytes of the live CUDA tensors Python can reach, by shape and dtype."""
    found = collections.Counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # isinstance() wakes deprecated lazy attributes
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) and obj.is_cuda:
                    found[(tuple(obj.shape), str(obj.dtype))] += obj.untyped_storage().nbytes()
            except Exception:  # objects that fail on attribute access are not tensors
                continue
    return found


def daemon_phase(kernels, variables, images, power: str):
    """The port's OCRServer on 127.0.0.1 over the main path's weights, driven
    by the port's OCRClient with PNG and JPEG lines."""
    from rcnn_ocr_tpu_torch.data.image_io import imdecode, png_encode
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.ops.preprocess import host_letterbox, host_resize_geometry
    from rcnn_ocr_tpu_torch.serving import OCRServer, install_hot_reload, serving_predict_fn

    t_phase = time.perf_counter()
    out = {"decoder": jpeg_decoder_check(), "tiff_decoder": tiff_decoder_check(),
           "bmp_decoder": bmp_decoder_check(), "webp_decoder": webp_decoder_check(),
           "gif_decoder": gif_decoder_check(), "pnm_decoder": pnm_decoder_check(),
           "jp2_decoder": jp2_decoder_check(), "raster_decoder": raster_decoder_check(),
           "png_decoder": png_decoder_check(), "canvas": list(DAEMON_CANVAS), "batch": DAEMON_BATCH, "max_wait_ms": DAEMON_WAIT_MS}
    charset_path = os.path.join(REPO, "configs", "charset.txt")

    def engine():
        return OCRInference(variables, charset_path=charset_path, device="cuda", img_h=IMG_H,
                            img_w=IMG_W, dtype=torch.bfloat16)

    # traffic: the main path's 512 lines as PNG, the 64 JPEG fixture lines,
    # then the variant lines (progressive, arithmetic and YCCK JPEG, TIFF,
    # fax and YCbCr TIFF, JPEG-in-TIFF, 1-bit and RLE8 BMP, lossy and
    # lossless-with-alpha WebP, interlaced GIF, binary PGM),
    # each followed by a PNG of the pixels it decodes to (its twin)
    wire = [("image/png", png_encode(im)) for im in images]
    kinds = ["PNG"] * len(images)
    for k in range(64):
        with open(os.path.join(JPEG_FIXTURES, f"line_{k:02d}.jpg"), "rb") as f:
            wire.append(("image/jpeg", f.read()))
        kinds.append("baseline JPEG")
    twins = []
    for name, ctype, variant in VARIANT_LINES:
        with open(fixture_path(name), "rb") as f:
            body = f.read()
        wire += [(ctype, body), ("image/png", png_encode(imdecode(body)))]
        kinds += [variant, "PNG twin"]
        twins.append((len(wire) - 2, len(wire) - 1))
    decoded = [imdecode(b) for _, b in wire]
    decode_ms = {}
    for kind in dict.fromkeys(kinds):  # host decode time per line, one thread
        if kind == "PNG twin":
            continue
        bodies = [b for (_, b), k in zip(wire, kinds) if k == kind]
        reps = max(1, 64 // len(bodies))
        t0 = time.perf_counter()
        for _ in range(reps):
            for b in bodies:
                imdecode(b)
        decode_ms[kind] = (time.perf_counter() - t0) * 1e3 / (reps * len(bodies))
    check(all(np.array_equal(a, b) for a, b in zip(decoded, images)), "PNG round trip differs")
    n = len(wire)
    ch, cw = DAEMON_CANVAS
    check(all(im.shape[0] <= ch and im.shape[1] <= cw for im in decoded),
          f"an image exceeds the {ch}x{cw} canvas")
    print(f"  traffic: {len(images)} PNG + 64 JPEG lines + {len(twins)} variant lines "
          f"({', '.join(dict.fromkeys(v for _, _, v in VARIANT_LINES))}) each with a PNG "
          f"twin; canvas {ch}x{cw} covers every image (largest "
          f"{max(im.shape[0] for im in decoded)}x{max(im.shape[1] for im in decoded)})")
    print("  host decode per line (one thread, the host CPU beside the card "
          f"{power}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in decode_ms.items()))
    out["decode_ms_per_image"] = decode_ms
    # one client at a time: 16 PNG and 16 JPEG lines and the variant lines
    # with their twins (the single-client latency needs no more); 16 and 64
    # clients: every line
    subsets = {1: (list(range(16)) + list(range(len(images), len(images) + 16))
                   + [i for pair in twins for i in pair]),
               16: list(range(n)), 64: list(range(n))}

    def twins_agree(results, what):
        """Each variant line's strings against its PNG twin's, where the
        level sent both."""
        got = {}
        for idxs, _, _, texts in results:
            got.update(zip(idxs, texts))
        pairs = [(v, p) for v, p in twins if v in got and p in got]
        apart = [(kinds[v], got[v], got[p]) for v, p in pairs if got[v] != got[p]]
        check(pairs and not apart, f"{what}: variant lines read otherwise than their PNG "
                                   f"twins ({len(pairs)} pairs): {apart}")
        return len(pairs)

    def jobs_for(idxs):
        raw = [([i], "raw", wire[i]) for i in idxs]
        batch = [(idxs[s : s + 8], "batch", [wire[i][1] for i in idxs[s : s + 8]])
                 for s in range(0, len(idxs), 8)]
        return {"raw": raw, "batch": batch}

    def compare(results, expected, what):
        rows = same = 0
        failed = [r for r in results if r[2] != 200]
        check(not failed, f"{what}: {len(failed)} requests failed, e.g. {failed[:3]}")
        for idxs, _, _, texts in results:
            check(len(texts) == len(idxs), f"{what}: {len(texts)} strings for {len(idxs)} images")
            for i, t in zip(idxs, texts):
                rows += 1
                if t == expected[i]:
                    same += 1
                else:
                    print(f"    {what}: row {i} differs: daemon {t!r}, in-process {expected[i]!r}")
        check(same >= 0.99 * rows, f"{what}: strings equal on {same}/{rows} rows (< 99%)")
        return same, rows

    launches = {"se_scale": 0, "bilstm_scan": 0}
    ref = engine()
    old_hup = signal.getsignal(signal.SIGHUP)
    for method in ("ctc_greedy", "attention"):
        knobs = dict(method=method, batch_size=DAEMON_BATCH, canvas=DAEMON_CANVAS,
                     max_length=MAX_LENGTH)
        expected = ref.predict_serving(decoded, **knobs)
        dispatches, gate = [], threading.Event()
        gate.set()
        inflight = [0]

        def build():
            fn = serving_predict_fn(engine(), **knobs)

            def timed(batch):
                inflight[0] = len(batch)
                gate.wait()
                t0 = time.monotonic()
                texts = fn(batch)
                dispatches.append((t0, len(batch), time.monotonic() - t0))
                inflight[0] = 0
                return texts
            return timed

        server = OCRServer(build(), host="127.0.0.1", port=0, max_batch=DAEMON_BATCH,
                           max_wait_ms=DAEMON_WAIT_MS)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = "http://%s:%d" % server.address[:2]
        _post(base, wire[0][1], wire[0][0])  # warm-up, not counted
        res = {"levels": {}}
        if method == "ctc_greedy":
            res["cv2_none"] = undecodable_replies(base, imdecode)
        kernels.reset_launch_counts()
        dispatches.clear()
        # the clients: a process of their own (spawned: it imports this
        # script, no CUDA), level after level
        levels = [(f"c{conc}_{kind}", jobs, conc) for conc in DAEMON_CONCURRENCY
                  for kind, jobs in jobs_for(subsets[conc]).items()]
        ctx = multiprocessing.get_context("spawn")
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=client_process, args=(base, levels, send))
        proc.start()
        send.close()
        check(recv.poll(600), "the client process sent no results in 600 s")
        by_level = recv.recv()
        proc.join(60)
        check(proc.exitcode == 0, f"the client process exited {proc.exitcode}")
        for name, _, conc in levels:
            kind = name.split("_", 1)[1]
            start, end, results = by_level[name]
            wall = end - start
            same, rows = compare(results, expected, f"{method} c={conc} {kind}")
            pairs = twins_agree(results, f"{method} c={conc} {kind}")
            lat = sorted(r[1] for r in results)
            pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] * 1e3  # noqa: E731
            mine = [(n, dt) for t, n, dt in dispatches if start <= t <= end]
            sizes = [n for n, _ in mine]
            level = {"requests": len(results), "images": rows, "wall_s": wall,
                     "req_s": len(results) / wall, "img_s": rows / wall,
                     "p50_ms": pick(0.5), "p95_ms": pick(0.95), "p99_ms": pick(0.99),
                     "dispatches": len(sizes), "mean_batch": sum(sizes) / len(sizes),
                     "dispatch_ms": 1e3 * sum(dt for _, dt in mine) / len(mine),
                     "strings_equal": same, "variant_twins_equal": pairs}
            res["levels"][f"c{conc}_{kind}"] = level
            print(f"  daemon {method} c={conc} {kind}: {len(results)} requests, {rows} "
                  f"images in {wall:.3f} s: {level['req_s']:.1f} req/s, "
                  f"{level['img_s']:.1f} img/s, latency p50/p95/p99 {level['p50_ms']:.2f}/"
                  f"{level['p95_ms']:.2f}/{level['p99_ms']:.2f} ms, {len(sizes)} dispatches "
                  f"of {level['mean_batch']:.1f} images and {level['dispatch_ms']:.1f} ms on "
                  f"average; strings equal in-process on {same}/{rows}, variant lines equal "
                  f"their PNG twins on {pairs}/{pairs} on {power}")
        counts = kernels.launch_counts()
        for name, per in (("se_scale", 11), ("bilstm_scan", 2)):
            check(counts[name] == per * len(dispatches),
                  f"daemon {method} launched {name} {counts[name]}x over {len(dispatches)} "
                  f"dispatches, expected {per * len(dispatches)}")
            launches[name] += counts[name]
        res["launches"] = counts
        res["dispatch_ms_mean"] = 1e3 * sum(dt for _, _, dt in dispatches) / len(dispatches)

        if method == "ctc_greedy":
            # hot reload: a SIGHUP while 16 clients keep sending, twice.  The
            # old engine must be released: the CUDA tensors Python can reach
            # after each reload are those before it, and with the cuBLAS
            # workspaces cleared (33 MiB for each thread that ran a GEMM,
            # the reload's helper thread included) allocated memory returns
            # to within RELOAD_MEM_MIB of before: the blocks only C++ holds
            # (no Python tensor) wander by a few MiB from one reading to the
            # next, where an engine's weights alone are 176.6 MiB.
            def rebuild():
                fn = build()
                fn([np.full((16, 32, 3), 255, np.uint8)])  # warm off the serving path
                return fn

            def reading():
                gc.collect()
                torch.cuda.synchronize()
                allocated = torch.cuda.memory_allocated()
                torch._C._cuda_clearCublasWorkspaces()
                return allocated, torch.cuda.memory_allocated(), cuda_tensors()

            install_hot_reload(server, rebuild)
            mem = [reading()]
            torch.cuda.reset_peak_memory_stats()
            reload_runs = []
            for swap in (1, 2):
                n0 = len(dispatches)
                kernels.reset_launch_counts()
                stop = threading.Event()
                box = {}
                sender = threading.Thread(target=lambda: box.update(zip(
                    ("start", "end", "results"),
                    drive_daemon(base, jobs_for(subsets[16])["raw"], 16, stop=stop))))
                sender.start()
                time.sleep(0.5)
                os.kill(os.getpid(), signal.SIGHUP)
                deadline = time.monotonic() + 120
                while server.batcher.engine_swaps < swap and time.monotonic() < deadline:
                    time.sleep(0.01)
                time.sleep(0.5)  # more requests on the new engine
                stop.set()
                sender.join()
                check(server.batcher.engine_swaps == swap,
                      f"engine_swaps {server.batcher.engine_swaps} after {swap} SIGHUPs")
                same, rows = compare(box["results"], expected, f"ctc_greedy across reload {swap}")
                counts = kernels.launch_counts()
                reload_dispatches = len(dispatches) - n0  # the new engine's warm-up included
                for name, per in (("se_scale", 11), ("bilstm_scan", 2)):
                    check(counts[name] == per * reload_dispatches,
                          f"reload {swap} window launched {name} {counts[name]}x, expected "
                          f"{per * reload_dispatches}")
                    launches[name] += counts[name]
                reload_runs.append({"requests": len(box["results"]), "strings_equal": same,
                                    "rows": rows})
                mem.append(reading())
            peak = torch.cuda.max_memory_allocated()
            model_mb = sum(p.numel() * p.element_size() for p in ref.model.parameters()) / 2**20
            mib = [(a / 2**20, b / 2**20, sum(t.values()) / 2**20) for a, b, t in mem]
            print(f"  hot reload x2: engine_swaps 2 with 16 clients in flight, "
                  f"{[r['requests'] for r in reload_runs]} requests all 200, strings equal on "
                  f"{[r['strings_equal'] for r in reload_runs]}/{[r['rows'] for r in reload_runs]}; "
                  f"memory allocated before / after reload 1 / after reload 2: "
                  f"{mib[0][0]:.1f} / {mib[1][0]:.1f} / {mib[2][0]:.1f} MiB, with the cuBLAS "
                  f"workspaces cleared {mib[0][1]:.1f} / {mib[1][1]:.1f} / {mib[2][1]:.1f} MiB, "
                  f"CUDA tensors Python reaches {mib[0][2]:.1f} / {mib[1][2]:.1f} / "
                  f"{mib[2][2]:.1f} MiB; peak {peak / 2**20:.1f} (one engine's weights: "
                  f"{model_mb:.1f} MiB)")
            for k in (1, 2):
                check(mem[k][2] == mem[0][2],
                      f"reload {k} changed the CUDA tensors Python reaches: "
                      f"{sorted((mem[k][2] - mem[0][2]).items())[:5]} more, "
                      f"{sorted((mem[0][2] - mem[k][2]).items())[:5]} fewer")
                check(abs(mem[k][1] - mem[0][1]) <= RELOAD_MEM_MIB * 2**20,
                      f"reload {k}: {mib[k][1]:.1f} MiB allocated with the cuBLAS workspaces "
                      f"cleared vs {mib[0][1]:.1f} before (more than {RELOAD_MEM_MIB} MiB apart)")
            res["reload"] = {"runs": reload_runs, "mem_mib": [m[0] for m in mib],
                             "mem_mib_workspaces_cleared": [m[1] for m in mib],
                             "python_cuda_tensors_mib": [m[2] for m in mib],
                             "peak_mib": peak / 2**20}

            # drain: shutdown_gracefully with 64 requests queued behind a held
            # dispatch; 8 more sent while draining must get 503
            gate.clear()
            held = [[] for _ in range(64)]
            clients = [threading.Thread(target=lambda k=k: held[k].append(
                _post(base, wire[k][1], wire[k][0]))) for k in range(64)]
            for c in clients:
                c.start()
            deadline = time.monotonic() + 60
            while (server.batcher.pending() + inflight[0] < 64
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            check(server.batcher.pending() + inflight[0] == 64, "the 64 requests never queued")
            drainer = threading.Thread(target=server.shutdown_gracefully)
            drainer.start()
            while not server._draining:
                time.sleep(0.001)
            late = [_post(base, wire[k][1], wire[k][0])[0] for k in range(64, 72)]
            gate.set()
            drainer.join(60)
            for c in clients:
                c.join(60)
            thread.join(30)
            answered = [h[0] for h in held if h]
            check(len(answered) == 64 and all(s == 200 for s, _ in answered),
                  f"drain: {len(answered)}/64 queued requests answered, statuses "
                  f"{sorted({s for s, _ in answered})}")
            check(all(r["texts"] == [expected[k]] for k, (_, r) in enumerate(answered)),
                  "drain: a queued request got other strings")
            check(late == [503] * 8, f"drain: requests sent while draining got {late}")
            check(not thread.is_alive(), "serve_forever did not return after the drain")
            print("  drain: shutdown_gracefully with 64 requests queued: all 64 answered 200 "
                  "with their strings, 8 sent while draining answered 503, none reset")
            res["drain"] = {"queued_answered_200": 64, "late_503": 8}
        else:
            server.close()
            thread.join(30)

        # where a dispatch's time goes, at the mean dispatched batch of c=16
        mean_b = max(1, round(res["levels"]["c16_raw"]["mean_batch"]))
        batch = decoded[:mean_b]
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            bufs = [torch.empty((DAEMON_BATCH, ch, cw, 3), dtype=torch.uint8, pin_memory=True)
                    for _ in range(2)]
            walls.append((time.perf_counter() - t0) * 1e3)
        rgb = [ref._to_rgb(im) for im in batch]
        rgb += [rgb[-1]] * (DAEMON_BATCH - len(rgb))
        lb = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, sizes = host_letterbox(rgb, ch, cw, out=bufs[0].numpy())
            lb.append((time.perf_counter() - t0) * 1e3)
        sizes = np.concatenate([sizes, host_resize_geometry(sizes, IMG_H, IMG_W)], axis=1)
        raw_d, sizes_d = bufs[0].cuda(), torch.from_numpy(sizes).cuda()
        kernel = ref.serving_kernel(method, max_length=MAX_LENGTH)
        split = {"mean_batch": mean_b, "pinned_alloc_ms_first": walls[0],
                 "pinned_alloc_ms": sorted(walls)[1],
                 "letterbox_ms": sorted(lb)[1],
                 "h2d_ms": time_ms(lambda: bufs[0].to("cuda", non_blocking=True), iters=10),
                 "h2d_mb": bufs[0].numel() / 1e6,
                 "device_ms": time_ms(lambda: kernel(raw_d, sizes_d), iters=3),
                 "dispatch_wall_ms": res["dispatch_ms_mean"]}
        fn = serving_predict_fn(ref, **knobs)
        fn(batch)
        split.update({f"profiled_{k}": v for k, v in profiled(lambda: fn(batch),
                                                               f"daemon_{method}").items()})
        res["split"] = split
        print(f"  daemon {method} dispatch of {mean_b} images (padded to {DAEMON_BATCH}) on "
              f"{power}: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                       for k, v in split.items()))
        out[method] = res
    signal.signal(signal.SIGHUP, old_hup)
    out["launch_counts"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  daemon phase: {out['seconds']:.1f} s")
    return out


def long_line_images(seed: int):
    """N_LONG seeded lines 24-48 high whose height-normalized width spans
    2-15 tiles of LONG_TILE_W at LONG_OVERLAP, then N_SHORT that fit one
    tile; dark glyph-like blobs on a light noisy ground."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_LONG + N_SHORT):
        h = int(rng.integers(24, 49))
        if i < N_LONG:
            n_tiles = int(rng.integers(2, 16))
            new_w = (LONG_TILE_W + (LONG_TILE_W - LONG_OVERLAP) * (n_tiles - 2)
                     + int(rng.integers(1, LONG_TILE_W - LONG_OVERLAP + 1)))
        else:
            new_w = int(rng.integers(24, LONG_TILE_W + 1))
        w = max(1, new_w * h // IMG_H)
        img = np.full((h, w, 3), int(rng.integers(200, 256)), np.int16)
        for _ in range(max(2, w // 10)):
            y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
            img[y0 : y0 + int(rng.integers(2, h // 2 + 3)),
                x0 : x0 + int(rng.integers(1, 6))] = int(rng.integers(0, 90))
        out.append(np.clip(img + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8))
    return out


def long_line_phase(kernels, variables, power: str):
    """predict_long for every method over seeded long lines and one-tile
    lines, on the main path's model."""
    from rcnn_ocr_tpu_torch import long_lines
    from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.postprocess import pad_rows

    charset_path = os.path.join(REPO, "configs", "charset.txt")
    engine = OCRInference(variables, charset_path=charset_path, device="cuda", img_h=IMG_H,
                          img_w=IMG_W, dtype=torch.bfloat16)
    cs = engine.charset
    lines = long_line_images(seed=9)
    short = lines[N_LONG:]
    t0 = time.perf_counter()
    tiles, plans = long_lines.plan_tiles([engine._to_rgb(im) for im in lines], IMG_H, LONG_TILE_W,
                                         LONG_OVERLAP, ResizeAndPad(IMG_H, LONG_TILE_W))
    plan_ms = (time.perf_counter() - t0) * 1e3
    per_line = [len(starts) for _, starts in plans]
    check(all(n == 1 for n in per_line[N_LONG:]), "a short line takes more than one tile")
    n_tiles, tile_batches = len(tiles), -(-len(tiles) // BATCH)
    print(f"  {N_LONG} long lines of {min(per_line[:N_LONG])}-{max(per_line[:N_LONG])} tiles "
          f"(mean {np.mean(per_line[:N_LONG]):.2f}) and {N_SHORT} one-tile lines, 24-48 high: "
          f"{n_tiles} tiles of {IMG_H}x{LONG_TILE_W} (overlap {LONG_OVERLAP}), {tile_batches} "
          f"batches of {BATCH}; host plan (decode, height-normalize, cut) {plan_ms:.1f} ms")
    kw = dict(tile_w=LONG_TILE_W, overlap=LONG_OVERLAP, batch_size=BATCH, max_length=MAX_LENGTH)
    methods = {
        "ctc_greedy": dict(method="ctc_greedy"),
        "ctc_beam": dict(method="ctc_beam", beam_width=CTC_BEAM, prune_k=CTC_BEAM),
        "attention_align": dict(method="attention", merge="align"),
        "attention_text": dict(method="attention", merge="text"),
        "attention_beam": dict(method="attention_beam", beam_width=BEAM_WIDTH),
        "hybrid": dict(method="hybrid"),
        "hybrid_beam": dict(method="hybrid_beam", beam_width=BEAM_WIDTH),
    }
    out = {"tiles": n_tiles, "tile_batches": tile_batches, "host_plan_ms": plan_ms,
           "lines_s": {}, "tiles_s": {}, "launches": {}}
    launches = {"se_scale": 0, "bilstm_scan": 0}
    results = {}
    for name, m in methods.items():
        engine.predict_long(lines[:4] + short[:4], **kw, **m)  # warm-up
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        results[name] = engine.predict_long(lines, **kw, **m)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        batches = counts["se_scale"] // 11
        check(counts == {"se_scale": 11 * batches, "bilstm_scan": 2 * batches},
              f"long lines {name} launched {counts}: not 11 + 2 per encoded batch")
        # the hybrid decodes also encode their segment crops
        check(batches == tile_batches if not name.startswith("hybrid") else batches >= tile_batches,
              f"long lines {name} encoded {batches} batches for {tile_batches} tile batches")
        check(len(results[name]) == len(lines) and all(isinstance(t, str) for t in results[name]),
              f"long lines {name} returned no string per line")
        for k in launches:
            launches[k] += counts[k]
        out["lines_s"][name], out["tiles_s"][name] = len(lines) / wall, n_tiles / wall
        out["launches"][name] = counts
        print(f"  {name}: {len(lines) / wall:.1f} lines/s, {n_tiles / wall:.1f} tiles/s ({wall:.2f}"
              f" s, bf16) on {power}; {batches} encoded batches; "
              f"{len(set(results[name]))} distinct strings")

    # one-tile lines decode as predict / predict_ctc; the ids fast path = top-k
    check(results["ctc_greedy"][N_LONG:] == engine.predict_ctc(short, batch_size=BATCH),
          "one-tile lines: predict_long ctc_greedy differs from predict_ctc")
    for name in ("attention_align", "attention_text"):
        check(results[name][N_LONG:] == engine.predict(short, max_length=MAX_LENGTH,
                                                       batch_size=BATCH),
              f"one-tile lines: predict_long {name} differs from predict")
    top_k = engine.tile_kernel(CTC_BEAM)
    vals, idx = long_lines.extract_tile_frames(tiles, BATCH,
                                               lambda b: top_k(engine._device_batch(b)))
    via_topk = long_lines.decode_stitched(vals, idx, plans, LONG_TILE_W, blank_id=cs.ctc_blank_id,
                                          num_classes=cs.num_classes, itos=list(cs.itos),
                                          skip_ids=engine._ctc_skip())
    check(via_topk == results["ctc_greedy"], "the ids fast path differs from the top-k path")
    print(f"  one-tile lines equal predict / predict_ctc exactly; the ids fast path equals the "
          f"top-k path on all {len(lines)} lines")

    # host plan and stitch against the device, ctc_greedy's fast path
    ids_kernel = engine.tile_ids_kernel()
    t0 = time.perf_counter()
    ids = long_lines.extract_tile_ids(tiles, BATCH, lambda b: ids_kernel(engine._device_batch(b)))
    extract_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    long_lines.decode_stitched_ids(ids, plans, LONG_TILE_W, blank_id=cs.ctc_blank_id,
                                   itos=list(cs.itos), skip_ids=engine._ctc_skip())
    stitch_ms = (time.perf_counter() - t0) * 1e3
    batch = engine._device_batch(np.stack(pad_rows(tiles[:BATCH], BATCH)[0]))
    device_ms = time_ms(lambda: ids_kernel(batch), iters=3) * tile_batches
    out.update(host_stitch_ms=stitch_ms, extract_ms=extract_ms, device_ids_ms=device_ms)
    print(f"  ctc_greedy split on {power}: host plan {plan_ms:.1f} ms, tile batches stacked, "
          f"shipped and run {extract_ms:.1f} ms (of which the ids kernel on the card "
          f"{device_ms:.1f} ms, CUDA events), host stitch and collapse {stitch_ms:.1f} ms")

    # fp32: through the kernels vs their plain versions
    ref = OCRInference(variables, charset_path=charset_path, device="cuda", img_h=IMG_H,
                       img_w=IMG_W, dtype=torch.float32)
    for name in ("ctc_greedy", "attention_align"):
        got = ref.predict_long(lines, **kw, **methods[name])
        with kernels.plain_only():
            want = ref.predict_long(lines, **kw, **methods[name])
        same = sum(a == b for a, b in zip(got, want))
        out[f"fp32_{name}_kernels_equal_plain"] = same
        print(f"  fp32 {name}: kernels = plain versions on {same}/{len(lines)} lines")
        need = len(lines) if name == "ctc_greedy" else 0.99 * len(lines)
        check(same >= need, f"fp32 long lines {name}: kernels = plain on only {same}/{len(lines)}")
    out["launch_counts"] = launches
    return out


def launch_pairs(call):
    """``(kernel name, its arguments, its output)`` of every kernel launch
    made by ``call``, copied as they happen."""
    from rcnn_ocr_tpu_torch.ops import bilstm_scan, se_scale

    seen, real = [], {m: m._launch for m in (se_scale, bilstm_scan)}

    def wrap(mod, name):
        def launch(*args):
            result = real[mod](*args)
            seen.append((name, tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                         result.clone()))
            return result
        return launch

    se_scale._launch, bilstm_scan._launch = wrap(se_scale, "se_scale"), \
        wrap(bilstm_scan, "bilstm_scan")
    try:
        call()
    finally:
        se_scale._launch, bilstm_scan._launch = real[se_scale], real[bilstm_scan]
    return seen


def int8_stage_convs(engine, images):
    """The int8 codes of the first conv of each stage and of ``out1`` on one
    bs-256 batch: ``{name: (x codes NHWC int8, w codes HWIO int8, strides,
    padding, x bf16 NHWC, w fp32 HWIO)}``, captured by forward pre-hooks."""
    from rcnn_ocr_tpu_torch.ops.quant import quantize_activation, quantize_weight_per_cout

    cnn = engine.model.cnn
    names = ("layer1_block0.conv1", "layer2_block0.conv1", "layer3_block0.conv1",
             "layer4_block0.conv1", "out1")
    captured, hooks = {}, []
    for name in names:
        mod = cnn.get_submodule(name)

        def grab(mod, args, name=name):
            c = mod.conv
            ph, pw = c.padding
            x = args[0].permute(0, 2, 3, 1).contiguous()
            w = c.weight.permute(2, 3, 1, 0)
            captured[name] = (quantize_activation(x)[0], quantize_weight_per_cout(w)[0],
                              tuple(c.stride), ((ph, ph), (pw, pw)), x, w)
        hooks.append(mod.register_forward_pre_hook(grab))
    try:
        engine.predict(images[:BATCH], max_length=MAX_LENGTH, batch_size=BATCH)
    finally:
        for h in hooks:
            h.remove()
    return captured


def artifact_sizes(path: str) -> dict:
    return {f: os.path.getsize(os.path.join(path, f)) for f in sorted(os.listdir(path))}


def int8_artifact_phase(kernels, variables, images, power: str):
    """int8 engines (dynamic and calibrated static) against their plain
    versions, the calibration file, serving artifacts loaded fresh against
    the live engine (one exported on the CPU and moved), and the daemon
    serving an artifact with a reload; on the main path's model."""
    import torch.nn.functional as F

    from rcnn_ocr_tpu_torch.data.image_io import png_encode
    from rcnn_ocr_tpu_torch.export import ServingArtifact, export_serving_artifact
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.ops import quant
    from rcnn_ocr_tpu_torch.ops.bilstm_scan import scan_reference
    from rcnn_ocr_tpu_torch.ops.se_scale import se_scale_reference

    charset_path = os.path.join(REPO, "configs", "charset.txt")
    root = os.path.join(REPO, "build", "chip_smoke", "int8")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {"launches": {}}
    launches = collections.Counter()

    def engine(dtype=torch.bfloat16, source=variables, device="cuda", **kw):
        return OCRInference(source, charset_path=charset_path, device=device, img_h=IMG_H,
                            img_w=IMG_W, dtype=dtype, **kw)

    def counted(name, call, batches):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = call()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        check(counts == {"se_scale": 11 * batches, "bilstm_scan": 2 * batches},
              f"{name} launched {counts}: not 11 + 2 per batch over {batches} batches")
        launches.update(counts)
        out["launches"][name] = counts
        return got, wall

    # (1) the int32 accumulators of the same codes, card vs CPU, and one int8
    # conv against the bf16 cuDNN conv of its shape
    dyn = engine(quantize=True)
    convs = int8_stage_convs(dyn, images)
    out["int8_convs"] = {}
    no_grad = torch.inference_mode()
    no_grad.__enter__()
    for name, (xq, wq, strides, pads, x, w) in convs.items():
        sub = xq[:16]
        card_acc = quant.int8_conv_accumulate(sub, wq, strides, pads)
        cpu_acc = quant.int8_conv_accumulate(sub.cpu(), wq.cpu(), strides, pads)
        check(torch.equal(card_acc.cpu(), cpu_acc), f"int8 {name}: card accumulators != CPU's")
        b, h, wd, cin = xq.shape
        ho, wo, cout = card_acc.shape[1], card_acc.shape[2], card_acc.shape[3]
        ops = 2.0 * b * ho * wo * cout * wq.shape[0] * wq.shape[1] * cin
        int8_ms = time_ms(lambda: quant.int8_conv_nhwc(x, w, strides, pads), iters=10)
        accum_ms = time_ms(lambda: quant.int8_conv_accumulate(xq, wq, strides, pads), iters=10)
        rows = torch.nn.functional.pad(xq, (0, 0, pads[1][0], pads[1][1], pads[0][0],
                                            pads[0][1])).unfold(1, wq.shape[0], strides[0]) \
            .unfold(2, wq.shape[1], strides[1]).permute(0, 1, 2, 4, 5, 3) \
            .reshape(-1, wq.shape[0] * wq.shape[1] * cin).contiguous()
        mat = wq.reshape(-1, wq.shape[3]).contiguous()
        mm_ms = time_ms(lambda: torch._int_mm(rows, mat), iters=10)
        x_cl = x.permute(0, 3, 1, 2)  # NCHW-shaped, channels_last memory
        w_bf = w.permute(3, 2, 0, 1).to(torch.bfloat16)
        padding = (pads[0][0], pads[1][0])  # symmetric, as every ConvBN pads
        bf16_ms = time_ms(lambda: F.conv2d(x_cl, w_bf, None, strides, padding), iters=10)
        out["int8_convs"][name] = dict(shape=[b, h, wd, cin, cout], gop=ops / 1e9,
                                       int8_ms=int8_ms, accumulate_ms=accum_ms, int_mm_ms=mm_ms,
                                       bf16_cudnn_ms=bf16_ms,
                                       int8_bound_ms=ops / 1979e12 * 1e3,
                                       bf16_bound_ms=ops / 989e12 * 1e3)
        print(f"  int8 {name} [{b},{h},{wd},{cin}]->{cout}: accumulators card = CPU exactly "
              f"(16 rows); int8 conv {int8_ms:.3f} ms (im2col + _int_mm {accum_ms:.3f} ms, "
              f"_int_mm alone {mm_ms:.3f} ms) vs bf16 cuDNN {bf16_ms:.3f} ms; op bounds "
              f"{ops / 1979e9:.3f} / "
              f"{ops / 989e9:.3f} ms (int8 / bf16) on {power}")
    no_grad.__exit__(None, None, None)
    del convs

    # (2) the int8 engines: throughput beside bf16 in the same call (bf16),
    # kernels against plain versions (fp32)
    n_batches = -(-N_IMAGES // BATCH)
    bf16 = engine()
    bf16.predict(images[:BATCH], max_length=MAX_LENGTH, batch_size=BATCH)
    ref_attn, t_ref_attn = counted("bf16_predict", lambda: bf16.predict(
        images, max_length=MAX_LENGTH, batch_size=BATCH), n_batches)
    ref_ctc, t_ref_ctc = counted("bf16_predict_ctc", lambda: bf16.predict_ctc(
        images, batch_size=BATCH), n_batches)
    static = engine(quantize=True)
    static.calibrate(images[:BATCH], batch_size=BATCH)
    check(static.model.act_quant == "static", "calibrate did not switch to the static path")
    out["img_s"] = {"bf16_attention": N_IMAGES / t_ref_attn, "bf16_ctc": N_IMAGES / t_ref_ctc}
    strings = {}
    for mode, eng in (("dynamic", dyn), ("static", static)):
        eng.predict(images[:BATCH], max_length=MAX_LENGTH, batch_size=BATCH)  # warm-up
        attn, t_attn = counted(f"int8_{mode}_predict", lambda: eng.predict(
            images, max_length=MAX_LENGTH, batch_size=BATCH), n_batches)
        ctc, t_ctc = counted(f"int8_{mode}_predict_ctc", lambda: eng.predict_ctc(
            images, batch_size=BATCH), n_batches)
        strings[mode] = (attn, ctc)
        out["img_s"][f"int8_{mode}_attention"] = N_IMAGES / t_attn
        out["img_s"][f"int8_{mode}_ctc"] = N_IMAGES / t_ctc
        agree_attn = sum(a == b for a, b in zip(attn, ref_attn))
        agree_ctc = sum(a == b for a, b in zip(ctc, ref_ctc))
        out[f"int8_{mode}_vs_bf16_strings_equal"] = dict(attention=agree_attn, ctc=agree_ctc)
        print(f"  int8 {mode}: attention {N_IMAGES / t_attn:.1f} img/s, CTC greedy "
              f"{N_IMAGES / t_ctc:.1f} img/s; bf16 in the same call {N_IMAGES / t_ref_attn:.1f} / "
              f"{N_IMAGES / t_ref_ctc:.1f} img/s (bs {BATCH}, host resize included) on {power}; "
              f"strings equal to bf16's on {agree_attn} / {agree_ctc} of {N_IMAGES} "
              "(random weights: not held)")
    # the kernels on the int8 path: each K1 and K2 launch of one bs-256 batch
    # against its plain version on the same inputs (held, TOL bf16 / fp32),
    # the engines' strings deterministic through the kernels and through the
    # plain versions (held), and kernels-vs-plain strings printed (see the
    # note at the end of TOL)
    for mode, eng in (("dynamic", dyn), ("static", static)):
        seen = launch_pairs(lambda: eng.predict_ctc(images[:BATCH], batch_size=BATCH))
        worst = {"se_scale": 0.0, "bilstm_scan": 0.0}
        for name, args, got in seen:
            if name == "se_scale":
                want = se_scale_reference(*args)
                tol = TOL["bf16"] if got.dtype == torch.bfloat16 else TOL["fp32"]
            else:
                want, tol = scan_reference(*args), TOL["fp32"]
            worst[name] = max(worst[name], held(got, want, what=f"int8 {mode} {name} launch "
                                                f"{tuple(args[0].shape)} vs plain", **tol))
        check(len(seen) == 13, f"int8 {mode}: {len(seen)} launches in one batch, not 11 + 2")
        again_attn = eng.predict(images, max_length=MAX_LENGTH, batch_size=BATCH)
        again_ctc = eng.predict_ctc(images, batch_size=BATCH)
        check((again_attn, again_ctc) == strings[mode],
              f"int8 {mode}: two runs through the kernels gave other strings")
        with kernels.plain_only():
            plain = [(eng.predict(images, max_length=MAX_LENGTH, batch_size=BATCH),
                      eng.predict_ctc(images, batch_size=BATCH)) for _ in range(2)]
        check(plain[0] == plain[1], f"int8 {mode}: two plain runs gave other strings")
        same_attn = sum(a == b for a, b in zip(strings[mode][0], plain[0][0]))
        same_ctc = sum(a == b for a, b in zip(strings[mode][1], plain[0][1]))
        out[f"int8_{mode}_kernels_vs_plain"] = dict(
            ctc_strings_equal=same_ctc, attention_strings_equal=same_attn,
            se_scale_max_abs_err=worst["se_scale"], bilstm_scan_max_abs_err=worst["bilstm_scan"])
        print(f"  int8 {mode} bf16: every launch of a batch within tolerance of its plain "
              f"version; kernels and plain each deterministic; strings kernels vs plain equal "
              f"on CTC {same_ctc}/{N_IMAGES}, attention {same_attn}/{N_IMAGES} (printed)")

    # (3) the calibration file reopens on the static path
    cal_path = os.path.join(root, "calibrated.msgpack")
    static.save_calibration(cal_path)
    reopened = engine(source=cal_path, quantize=True)
    check(reopened.model.act_quant == "static", "the calibrated file did not reopen static")
    check(reopened.predict(images, max_length=MAX_LENGTH, batch_size=BATCH) == strings["static"][0],
          "the reopened calibration decodes other strings")
    print(f"  save_calibration -> reopened static: the same {N_IMAGES} attention strings "
          f"({os.path.getsize(cal_path) / 2 ** 20:.1f} MiB)")
    del reopened

    # (4) artifacts, each loaded fresh, against the live engine
    canvas = DAEMON_CANVAS
    lines = long_line_images(seed=9)[: N_LONG // 4]
    exports = {
        "ctc_greedy_int8_static": (static, dict(method="ctc_greedy")),
        "attention_bf16": (bf16, dict(method="attention", max_length=MAX_LENGTH)),
        "hybrid_long_bf16": (bf16, dict(method="hybrid_long", max_length=MAX_LENGTH,
                                        tile_w=LONG_TILE_W, overlap=LONG_OVERLAP)),
    }
    out["artifacts"] = {}
    for name, (eng, kw) in exports.items():
        path = os.path.join(root, name)
        t0 = time.perf_counter()
        export_serving_artifact(eng, path, batch_size=BATCH, canvas=canvas, **kw)
        export_s = time.perf_counter() - t0
        long = kw["method"] == "hybrid_long"
        data = lines if long else images
        t0 = time.perf_counter()
        art = ServingArtifact.load(path)
        art.predict(data[:1])
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        if long:
            live_call = lambda: eng.predict_hybrid_long(  # noqa: E731
                data, tile_w=LONG_TILE_W, overlap=LONG_OVERLAP, batch_size=BATCH,
                max_length=MAX_LENGTH)
        else:
            live_call = lambda: eng.predict_serving(  # noqa: E731
                data, batch_size=BATCH, canvas=canvas, **kw)
        live_call()  # warm-up
        t0 = time.perf_counter()
        live = live_call()
        live_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = art.predict(data)
        art_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        launches.update(counts)
        out["launches"][f"artifact_{name}"] = counts
        batches = counts["se_scale"] // 11
        check(counts == {"se_scale": 11 * batches, "bilstm_scan": 2 * batches} and batches > 0,
              f"artifact {name} launched {counts}: not 11 + 2 per batch")
        same = sum(a == b for a, b in zip(got, live))
        check(same == len(data), f"artifact {name}: {same}/{len(data)} strings equal live")
        sizes = artifact_sizes(path)
        out["artifacts"][name] = dict(export_s=export_s, cold_start_s=cold_s,
                                      artifact_img_s=len(data) / art_s,
                                      live_img_s=len(data) / live_s, sizes=sizes,
                                      encoded_batches=batches)
        print(f"  artifact {name}: strings equal live on {same}/{len(data)}; export "
              f"{export_s:.1f} s; cold start (load + first batch) {cold_s:.2f} s; "
              f"{len(data) / art_s:.1f} vs live {len(data) / live_s:.1f} "
              f"{'lines' if long else 'img'}/s on {power}; {batches} encoded batches; "
              f"files {sizes}")
        del art
    # (5)'s daemon starts now, beside the CPU export below
    daemon_dir = os.path.join(root, "ctc_greedy_int8_static")
    artifact_daemon = serve_start(["--artifact", daemon_dir], "serve_artifact")
    # exported on the CPU, listing both platforms, moved to the card
    cpu_eng = engine(source=static.variables, device="cpu", quantize=True)
    path = os.path.join(root, "ctc_greedy_int8_static_from_cpu")
    t0 = time.perf_counter()
    export_serving_artifact(cpu_eng, path, method="ctc_greedy", batch_size=BATCH, canvas=canvas,
                            platforms=("cuda", "cpu"))
    export_s = time.perf_counter() - t0
    del cpu_eng
    art = ServingArtifact.load(path)
    got, _ = counted("artifact_from_cpu", lambda: art.predict(images), n_batches)
    live = static.predict_serving(images, batch_size=BATCH, canvas=canvas, method="ctc_greedy")
    same = sum(a == b for a, b in zip(got, live))
    check(same == N_IMAGES, f"CPU-exported artifact on the card: {same}/{N_IMAGES} equal live")
    out["artifacts"]["from_cpu"] = dict(export_s=export_s, strings_equal=same)
    print(f"  artifact exported on the CPU (platforms cuda, cpu; {export_s:.1f} s) runs on the "
          f"card: strings equal live on {same}/{N_IMAGES}, 11 + 2 launches per batch")
    del art

    # (5) python -m rcnn_ocr_tpu_torch.serve --artifact, with a SIGHUP reload
    # from a re-export at another batch size while clients are in flight
    sample = images[:64]
    bodies = [png_encode(im) for im in sample]
    want_256 = ServingArtifact.load(daemon_dir).predict(sample)
    proc = artifact_daemon["proc"]
    try:
        artifact_daemon["ready"].wait(600)
        base = artifact_daemon["base"]
        check(base is not None, "the artifact daemon never started serving")
        start_s = artifact_daemon["start_s"]
        jobs = [([i], "raw", ("image/png", bodies[i])) for i in range(len(sample))]
        _, _, served = drive_daemon(base, jobs, 16)
        ok = [(idx, texts) for idx, _, status, texts in served if status == 200]
        check(len(ok) == len(jobs), f"artifact daemon answered {len(ok)}/{len(jobs)} with 200")
        same = sum(texts == [want_256[idx[0]]] for idx, texts in ok)
        check(same == len(jobs), f"artifact daemon: {same}/{len(jobs)} strings equal in-process")
        print(f"  serve --artifact: up in {start_s:.1f} s (process start, load, warm-up; "
              f"beside the CPU export); "
              f"{len(jobs)} lines at c=16, all 200, strings equal in-process on {same}")
        export_serving_artifact(static, daemon_dir, method="ctc_greedy", batch_size=BATCH // 2,
                                canvas=canvas)
        want_128 = ServingArtifact.load(daemon_dir).predict(sample)
        stop = threading.Event()
        flight = {}
        runner = threading.Thread(target=lambda: flight.update(
            r=drive_daemon(base, jobs, 16, stop=stop)))
        runner.start()
        time.sleep(1.0)
        proc.send_signal(signal.SIGHUP)
        swapped = None
        deadline = time.monotonic() + 120
        import urllib.request

        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
                if "ocr_engine_swaps_total 1" in resp.read().decode():
                    swapped = time.monotonic()
                    break
            time.sleep(0.2)
        time.sleep(1.0)
        stop.set()
        runner.join(300)
        check(swapped is not None, "the artifact daemon never reloaded after SIGHUP")
        _, _, during = flight["r"]
        bad = [r for r in during if r[2] != 200]
        check(not bad, f"{len(bad)} requests failed across the reload: {bad[:3]}")
        mixed = sum(texts not in ([want_256[idx[0]]], [want_128[idx[0]]])
                    for idx, _, _, texts in during)
        check(mixed == 0, f"{mixed} answers across the reload match neither artifact")
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        out["daemon"] = dict(start_s=start_s, requests_c16=len(jobs), equal=same,
                             reload_requests=len(during), reload_failed=len(bad),
                             healthz_batch=health.get("batch_size"))
        print(f"  SIGHUP to a re-export at batch {BATCH // 2}: {len(during)} requests across "
              f"the reload, all 200, each equal to one of the two artifacts' strings")
    finally:
        serve_stop(artifact_daemon, "the artifact daemon")
    out["launch_counts"] = dict(launches)
    return out


def model_options_phase(kernels, variables, images, power: str) -> dict:
    """The model options JAX's model takes and no engine passes, on the main
    path's weights and 512 lines at bs 256 and 32x128: ``RCNN(stem_s2d=True)``
    against the default stem, the stem0 conv's time both ways, the static
    int8 stem against the int8 model with a float stem, and the linear device
    resize against its CPU twin and against ``area``."""
    import torch.nn.functional as F

    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN
    from rcnn_ocr_tpu_torch.ops.ctc import ctc_greedy_decode
    from rcnn_ocr_tpu_torch.ops.preprocess import (
        host_letterbox,
        host_resize_geometry,
        resize_pad_normalize,
    )
    from rcnn_ocr_tpu_torch.ops.stem import conv3x3_s2d, s2d_kernel, space_to_depth_pad1

    charset_path = os.path.join(REPO, "configs", "charset.txt")
    out = {}
    launches = collections.Counter()

    def engine(dtype, **kw):
        return OCRInference(variables, charset_path=charset_path, device="cuda", img_h=IMG_H,
                            img_w=IMG_W, dtype=dtype, **kw)

    def counted(what, call, encodes):
        """``call()`` with the launch counters from 0: 11 + 2 per encode."""
        kernels.reset_launch_counts()
        got = call()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check(counts == {"se_scale": 11 * encodes, "bilstm_scan": 2 * encodes},
              f"{what} launched {counts}: not 11 + 2 per encode over {encodes} encodes")
        launches.update(counts)
        return got

    def s2d_twin(eng):
        m = RCNN(**eng._model_kwargs, stem_s2d=True)
        m.load_state_dict(eng.model.state_dict())
        return m.eval().cuda()

    def decode(model, x, blank):
        enc = model.encode(x)
        tokens, valid = ctc_greedy_decode(model._ctc_head(enc), blank)
        return enc, tokens, valid, model.attn(enc, batch_max_length=MAX_LENGTH).argmax(-1)

    # (1) the s2d stem against the default one, fp32 (held) and bf16 (printed)
    fp32 = engine(torch.float32)
    blank = fp32.charset.ctc_blank_id
    s2d = s2d_twin(fp32)
    enc_err, ctc_same, attn_same, rows = 0.0, 0, 0, 0
    with torch.inference_mode():
        for _, n_real, x in device_batches(fp32, images, BATCH):
            enc_d, tok_d, val_d, att_d = decode(fp32.model, x, blank)
            enc_s, tok_s, val_s, att_s = counted("s2d fp32 encode", lambda: decode(s2d, x, blank), 1)
            enc_err = max(enc_err, held(enc_s, enc_d, what="s2d stem vs default, fp32 encoder "
                                        "states", **TOL["enc"]))
            ctc_same += int(((tok_s == tok_d).all(dim=1) & (val_s == val_d))[:n_real].sum())
            attn_same += int((att_s == att_d).all(dim=1)[:n_real].sum())
            rows += n_real
    check(ctc_same == rows, f"s2d stem: CTC tokens equal the default's on {ctc_same}/{rows}")
    check(attn_same >= 0.99 * rows, f"s2d stem: attention tokens equal on {attn_same}/{rows}")
    bf16 = engine(torch.bfloat16)
    s2d_bf16 = s2d_twin(bf16)
    bf16_ctc = bf16_attn = 0
    with torch.inference_mode():
        for _, n_real, x in device_batches(bf16, images, BATCH):
            _, tok_d, val_d, att_d = decode(bf16.model, x, blank)
            _, tok_s, val_s, att_s = counted("s2d bf16 encode", lambda: decode(s2d_bf16, x, blank),
                                             1)
            bf16_ctc += int(((tok_s == tok_d).all(dim=1) & (val_s == val_d))[:n_real].sum())
            bf16_attn += int((att_s == att_d).all(dim=1)[:n_real].sum())
    out["s2d"] = dict(enc_max_abs_err_fp32=enc_err, ctc_rows_equal_fp32=ctc_same,
                      attn_rows_equal_fp32=attn_same, ctc_rows_equal_bf16=bf16_ctc,
                      attn_rows_equal_bf16=bf16_attn, rows=rows)
    print(f"  s2d stem vs default: fp32 CTC tokens equal on {ctc_same}/{rows}, attention on "
          f"{attn_same}/{rows} (held); bf16 CTC {bf16_ctc}/{rows}, attention {bf16_attn}/{rows} "
          "(printed)")

    # (2) the stem0 conv alone, bf16 at bs 256: cuDNN 3x3 on C=3 against the
    # rewrite (s2d + 2x2 conv on C=12 + d2s), and the 2x2 conv alone
    _, _, x = next(device_batches(bf16, images[:BATCH], BATCH))
    xs = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    w = bf16.model.cnn.stem0.conv.weight
    with torch.inference_mode():
        want = F.conv2d(xs, w.to(torch.bfloat16), None, 1, 1)
        got = conv3x3_s2d(xs, w)
        # both accumulate in fp32 and round once to bf16: one ulp apart at most
        held(got, want, what="stem0 conv, s2d vs cuDNN 3x3, bf16", **TOL["bf16"])
        packed, kernel = space_to_depth_pad1(xs), s2d_kernel(w).to(torch.bfloat16)
        packed = packed.contiguous(memory_format=torch.channels_last)
        times = {"default_ms": time_ms(lambda: F.conv2d(xs, w.to(torch.bfloat16), None, 1, 1)),
                 "s2d_ms": time_ms(lambda: conv3x3_s2d(xs, w)),
                 "s2d_conv_alone_ms": time_ms(lambda: F.conv2d(packed, kernel))}
    moved = xs.numel() * 2 + want.numel() * 2
    times["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
    out["stem0_conv"] = times
    print(f"  stem0 conv [{BATCH},3,{IMG_H},{IMG_W}] -> {w.shape[0]} ch, bf16: cuDNN 3x3 "
          f"{times['default_ms']:.4f} ms, s2d rewrite {times['s2d_ms']:.4f} ms (its 2x2 conv "
          f"alone {times['s2d_conv_alone_ms']:.4f} ms), bytes bound {times['bound_ms']:.4f} ms "
          f"on {power}")

    # (3) the static int8 stem, calibrated on 256 lines, against the int8
    # model with a float stem; no engine takes quantize_stem (JAX's neither),
    # so this engine's model arguments are set before calibrate() rebuilds it
    n_batches = -(-N_IMAGES // BATCH)
    float_stem = engine(torch.bfloat16, quantize=True)
    int8_stem = engine(torch.bfloat16, quantize=True)
    int8_stem._model_kwargs["quantize_stem"] = True
    for eng in (float_stem, int8_stem):
        counted("calibrate", lambda: eng.calibrate(images[:BATCH], batch_size=BATCH), 1)
    absmax = {n: float(b) for n, b in int8_stem.model.named_buffers() if n.endswith("act_absmax")}
    stem_absmax = {n: v for n, v in absmax.items() if n.startswith("cnn.stem")}
    check(len(absmax) == 26 and len(stem_absmax) == 2, f"int8 stem: act_absmax of {sorted(absmax)}")
    check(all(np.isfinite(v) and v > 0 for v in absmax.values()),
          f"int8 stem: act_absmax not all finite and > 0: {stem_absmax}")
    check("cnn.stem0.conv.act_absmax" not in dict(float_stem.model.named_buffers()),
          "the float-stem int8 model holds a stem act_absmax")
    stats = int8_stem.variables["quant_stats"]["cnn"]
    check({"stem0", "stem1"} <= set(stats), "quant_stats lacks stem0 / stem1")
    texts, img_s, encode_ms = {}, {}, {}
    _, _, x = next(device_batches(float_stem, images[:BATCH], BATCH))
    for name, eng in (("float_stem", float_stem), ("int8_stem", int8_stem)):
        with torch.inference_mode():  # the device's share, without the host's
            encode_ms[name] = time_ms(lambda: eng.model.encode(x), iters=5)
        eng.predict(images[:BATCH], max_length=MAX_LENGTH, batch_size=BATCH)  # warm-up
        t0 = time.perf_counter()
        attn = counted(f"{name} predict", lambda: eng.predict(
            images, max_length=MAX_LENGTH, batch_size=BATCH), n_batches)
        t_attn = time.perf_counter() - t0
        t0 = time.perf_counter()
        ctc = counted(f"{name} predict_ctc", lambda: eng.predict_ctc(images, batch_size=BATCH),
                      n_batches)
        t_ctc = time.perf_counter() - t0
        texts[name] = (attn, ctc)
        img_s[name] = {"attention": N_IMAGES / t_attn, "ctc": N_IMAGES / t_ctc}
    agree = [sum(a == b for a, b in zip(texts["int8_stem"][i], texts["float_stem"][i]))
             for i in (0, 1)]
    out["int8_stem"] = dict(stem_act_absmax=stem_absmax, img_s=img_s, encode_ms=encode_ms,
                            strings_equal_float_stem={"attention": agree[0], "ctc": agree[1]})
    print(f"  int8 stem (static, calibrated on {BATCH} lines): stem act_absmax {stem_absmax}; "
          f"strings equal to the float-stem int8 model's on attention {agree[0]}/{N_IMAGES}, "
          f"CTC {agree[1]}/{N_IMAGES} (random weights: printed); img/s attention "
          f"{img_s['int8_stem']['attention']:.1f} vs {img_s['float_stem']['attention']:.1f}, "
          f"CTC {img_s['int8_stem']['ctc']:.1f} vs {img_s['float_stem']['ctc']:.1f} (bs {BATCH}, "
          f"bf16, host resize included); device encode of a batch {encode_ms['int8_stem']:.3f} "
          f"vs {encode_ms['float_stem']:.3f} ms on {power}")
    del float_stem, int8_stem

    # (4) the linear device resize on the serving phase's canvas: card vs the
    # CPU twin, then encoded and decoded beside the area resize
    canvas = (max(im.shape[0] for im in images), max(im.shape[1] for im in images))
    lin_err, ctc_same, attn_same = 0.0, 0, 0
    resize_ms = {}
    for lo in range(0, N_IMAGES, BATCH):
        chunk = images[lo : lo + BATCH]
        raw, sizes = host_letterbox(chunk, *canvas)
        sizes = np.concatenate([sizes, host_resize_geometry(sizes, IMG_H, IMG_W)], axis=1)
        raw_t, sizes_t = torch.from_numpy(raw), torch.from_numpy(sizes)
        raw_c, sizes_c = raw_t.cuda(), sizes_t.cuda()
        lin = resize_pad_normalize(raw_c, sizes_c, IMG_H, IMG_W, method="linear")
        twin = resize_pad_normalize(raw_t, sizes_t, IMG_H, IMG_W, method="linear")
        err = float((lin.cpu() - twin).abs().max())
        check(err <= 1e-5, f"linear resize: card vs CPU max abs diff {err:.3e} > 1e-5")
        lin_err = max(lin_err, err)
        area = resize_pad_normalize(raw_c, sizes_c, IMG_H, IMG_W, method="area")
        if not resize_ms:
            resize_ms = {m: time_ms(lambda m=m: resize_pad_normalize(raw_c, sizes_c, IMG_H, IMG_W,
                                                                     method=m), iters=10)
                         for m in ("linear", "area")}
        with torch.inference_mode():
            _, tok_l, val_l, att_l = counted("linear-resize encode",
                                             lambda: decode(bf16.model, lin, blank), 1)
            _, tok_a, val_a, att_a = decode(bf16.model, area, blank)
        n = len(chunk)
        ctc_same += int(((tok_l == tok_a).all(dim=1) & (val_l == val_a))[:n].sum())
        attn_same += int((att_l == att_a).all(dim=1)[:n].sum())
    out["linear_resize"] = dict(canvas=list(canvas), card_vs_cpu_max_abs_diff=lin_err,
                                ctc_rows_equal_area=ctc_same, attn_rows_equal_area=attn_same,
                                resize_ms=resize_ms)
    print(f"  linear resize on the {canvas[0]}x{canvas[1]} canvas: card vs CPU max abs diff "
          f"{lin_err:.3e} (<= 1e-5); bf16 tokens equal to the area resize's on CTC "
          f"{ctc_same}/{N_IMAGES}, attention {attn_same}/{N_IMAGES} (printed); device resize "
          f"of a bs-{BATCH} batch: linear {resize_ms['linear']:.3f} ms, area "
          f"{resize_ms['area']:.3f} ms on {power}")
    out["launch_counts"] = dict(launches)
    return out


def serve_start(args, name: str) -> dict:
    """``python -m rcnn_ocr_tpu_torch.serve`` with ``args`` started in a
    process of its own (its stderr in build/chip_smoke/``name``.err); a
    thread notes when it prints ``Serving on``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    started = {"t0": time.perf_counter(), "ready": threading.Event(), "base": None,
               "err": os.path.join(REPO, "build", "chip_smoke", f"{name}.err")}
    os.makedirs(os.path.dirname(started["err"]), exist_ok=True)
    with open(started["err"], "w") as err:
        started["proc"] = proc = subprocess.Popen(
            [sys.executable, "-m", "rcnn_ocr_tpu_torch.serve", *args, "--port", "0"], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=err, text=True)

    def watch():
        for line in proc.stdout:
            if line.startswith("Serving on ") and started["base"] is None:
                started.update(base=line.split()[2], start_s=time.perf_counter() - started["t0"])
                started["ready"].set()
        started["ready"].set()  # the process ended
    threading.Thread(target=watch, daemon=True).start()
    return started


def serve_stop(started: dict, what: str) -> None:
    proc = started["proc"]
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10)
    check(proc.returncode == 0, f"{what}: the daemon exited {proc.returncode}")


def warm_up(started: dict, png_path: str) -> None:
    """Once a daemon of :func:`serve_start` serves, its first request (the
    first batch's warm-up, not counted), timed into ``first_request_s``."""
    started["ready"].wait(600)
    if started["base"] is None:
        return
    try:
        with open(png_path, "rb") as f:
            t0 = time.perf_counter()
            _post(started["base"], f.read(), "image/png")
        started["first_request_s"] = time.perf_counter() - t0
    except Exception as err:  # reported by serve_and_load
        started["warm_up_error"] = repr(err)


def serve_and_load(started: dict, png_path: str, what: str, power: str) -> dict:
    """A daemon from :func:`serve_start`, warmed up by :func:`warm_up`, driven by ``python -m
    rcnn_ocr_tpu_torch.serve_loadtest`` with one line at each of MESH_LOAD's
    concurrencies: their final JSON lines, and the daemon's start-up
    seconds; the daemon is stopped after."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = {"levels": {}}
    try:
        started["ready"].wait(600)
        base = started["base"]
        if base is None:
            with open(started["err"], encoding="utf-8", errors="replace") as f:
                check(False, f"{what}: the daemon never started serving:\n{f.read()[-3000:]}")
        out["start_s"] = started["start_s"]
        check("warm_up_error" not in started,
              f"{what}: the warm-up request failed: {started.get('warm_up_error')}")
        out["first_request_s"] = started["first_request_s"]
        print(f"  {what}: serving {out['start_s']:.1f} s after the process started; the first "
              f"request (warm-up, not counted) {out['first_request_s']:.2f} s")
        for conc, n in MESH_LOAD:
            run = subprocess.run([sys.executable, "-m", "rcnn_ocr_tpu_torch.serve_loadtest",
                                  "--url", base, "--image", png_path, "--requests", str(n),
                                  "--concurrency", str(conc)], cwd=REPO, env=env,
                                 capture_output=True, text=True, timeout=300)
            check(run.returncode == 0, f"{what} c={conc}: the load tool exited "
                  f"{run.returncode}: {run.stdout[-2000:]} {run.stderr[-2000:]}")
            last = run.stdout.strip().splitlines()[-1]
            result = json.loads(last)
            check(result["ok"] == n and result["errors"] == 0
                  and result["server"]["images_served"] == n,
                  f"{what} c={conc}: {result['ok']}/{n} answered, {result['errors']} errors")
            out["levels"][f"c{conc}"] = result
            print(f"  {what} c={conc}: {last} on {power}")
    finally:
        serve_stop(started, what)
    return out


def kernels_on_a_second_card() -> dict:
    """K1 and K2 on cuda:1 from a thread whose current card is cuda:0, at
    the main path's shapes, against their plain versions."""
    from rcnn_ocr_tpu_torch.ops.bilstm_scan import bilstm_scan, scan_reference
    from rcnn_ocr_tpu_torch.ops.se_scale import se_scale, se_scale_reference

    dev = torch.device("cuda", 1)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(BATCH, 8, 32, 256, device=dev, generator=g).to(torch.bfloat16)
    w1 = torch.randn(256, 16, device=dev, generator=g) / 16
    w2 = torch.randn(16, 256, device=dev, generator=g) / 4
    xs = torch.randn(LSTM_T, 2, BATCH, 4 * HIDDEN, device=dev, generator=g)
    w_hh = (torch.randn(2, HIDDEN, 4 * HIDDEN, device=dev, generator=g) / 16).to(torch.bfloat16)
    got = {}

    def launch():
        torch.cuda.set_device(0)
        got["se"], got["lstm"] = se_scale(x, w1, w2), bilstm_scan(xs, w_hh, HIDDEN)
        torch.cuda.synchronize(dev)

    thread = threading.Thread(target=launch)
    thread.start()
    thread.join()
    return {"se_scale": held(got["se"], se_scale_reference(x, w1, w2), what="K1 on cuda:1",
                             **TOL["bf16"]),
            "bilstm_scan": held(got["lstm"], scan_reference(xs, w_hh, HIDDEN),
                                what="K2 on cuda:1", **TOL["fp32"])}


def mesh_phase(kernels, variables, images, power: str, daemon: dict) -> dict:
    """Serving across replicas: mesh=True on the visible cards, two replicas
    on cuda:0 (and across cuda:0 and cuda:1 where there are two cards), an
    artifact under a mesh, ``serve --mesh`` under the load tool and a .pth
    export read back."""
    from rcnn_ocr_tpu_torch.data.image_io import png_encode
    from rcnn_ocr_tpu_torch.export import ServingArtifact, export_serving_artifact
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.interop.torch_export import save_torch_checkpoint
    from rcnn_ocr_tpu_torch.training.checkpoint import msgpack_serialize
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    t_phase = time.perf_counter()
    charset_path = os.path.join(REPO, "configs", "charset.txt")
    root = os.path.join(REPO, "build", "chip_smoke", "mesh")
    os.makedirs(root, exist_ok=True)
    n_cards = torch.cuda.device_count()
    n_batches = -(-N_IMAGES // BATCH)
    out = {"cards": n_cards, "launches": {}, "img_s": {}}
    launches = collections.Counter()

    def engine(dtype=torch.bfloat16, **kw):
        return OCRInference(variables, charset_path=charset_path, device="cuda", img_h=IMG_H,
                            img_w=IMG_W, dtype=dtype, **kw)

    def counted(name, call, encodes):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = call()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        check(counts == {"se_scale": 11 * encodes, "bilstm_scan": 2 * encodes},
              f"{name} launched {counts}: not 11 + 2 per block over {encodes} blocks")
        launches.update(counts)
        out["launches"][name] = counts
        return got, wall

    calls = {
        "predict": lambda e: e.predict(images, max_length=MAX_LENGTH, batch_size=BATCH,
                                       return_confidence=True),
        "predict_ctc": lambda e: e.predict_ctc(images, batch_size=BATCH, return_confidence=True),
    }
    base = engine()
    want = {}
    for name, call in calls.items():
        call(base)  # warm-up
        want[name], wall = counted(f"no_mesh_{name}", lambda: call(base), n_batches)
        out["img_s"][f"no_mesh_{name}"] = N_IMAGES / wall

    # (1) mesh=True on the visible cards: with one card, the same bits and launches
    one = engine(mesh=True)
    check(len(one._replicas) == n_cards, f"mesh=True made {len(one._replicas)} replicas")
    if n_cards == 1:
        for name, call in calls.items():
            call(one)
            got, wall = counted(f"mesh_true_{name}", lambda: call(one), n_batches)
            out["img_s"][f"mesh_true_{name}"] = N_IMAGES / wall
            check(got == want[name], f"mesh=True {name}: strings or confidences differ from "
                  "mesh=None")
        print(f"  mesh=True on 1 card: predict and predict_ctc strings and confidences equal "
              f"mesh=None bit for bit, 11 + 2 launches per batch")
    del one

    # (2) two replicas (one card twice, and two cards where there are).  A
    # replica decodes a 128-row block, so the engine without a mesh at batch
    # 128 decodes the same rows as the same batches: the replicas must equal
    # it exactly.  Against batch 256, a convolution may take another cuDNN
    # algorithm for 128 rows: the agreement is printed beside the same
    # engine's batch-128-vs-256 agreement (they are equal when the exact
    # check holds), and held where the PR's bounds say.
    meshes = {"cuda:0 x2": ["cuda:0", "cuda:0"]}
    if n_cards >= 2:
        meshes["cuda:0 + cuda:1"] = ["cuda:0", "cuda:1"]
    else:
        print("  mesh across cards: not run (1 card)")
    out["across_cards"] = n_cards >= 2
    base32 = engine(torch.float32)
    half = BATCH // 2
    decodes = {  # name: (dtype, call of (engine, batch size))
        "bf16_predict": (torch.bfloat16, lambda e, b: e.predict(
            images, max_length=MAX_LENGTH, batch_size=b, return_confidence=True)),
        "bf16_predict_ctc": (torch.bfloat16, lambda e, b: e.predict_ctc(
            images, batch_size=b, return_confidence=True)),
        "bf16_serving_ctc_greedy": (torch.bfloat16, lambda e, b: e.predict_serving(
            images, method="ctc_greedy", batch_size=b, canvas="auto", max_length=MAX_LENGTH)),
        "bf16_serving_attention": (torch.bfloat16, lambda e, b: e.predict_serving(
            images, method="attention", batch_size=b, canvas="auto", max_length=MAX_LENGTH)),
        "fp32_predict": (torch.float32, lambda e, b: e.predict(
            images, max_length=MAX_LENGTH, batch_size=b)),
        "fp32_predict_ctc": (torch.float32, lambda e, b: e.predict_ctc(images, batch_size=b)),
    }
    # where batch 128 and 256 part: the convolution stack on the same rows,
    # through the plain versions (no kernel of ours), bf16 and fp32
    with torch.inference_mode(), kernels.plain_only():
        for eng, tag in ((base, "bf16"), (base32, "fp32")):
            _, _, x = next(device_batches(eng, images[:BATCH], BATCH))
            part = eng.model.cnn(x[:half].contiguous()).float()
            out[f"cnn_{tag}_max_diff_128_vs_256"] = float(
                (eng.model.cnn(x)[:half].float() - part).abs().max())
    print(f"  the CNN's features of rows 0-{half - 1}, plain versions, batch {half} vs "
          f"{BATCH}: max abs diff bf16 {out['cnn_bf16_max_diff_128_vs_256']:.3e}, fp32 "
          f"{out['cnn_fp32_max_diff_128_vs_256']:.3e}")
    check(out["cnn_fp32_max_diff_128_vs_256"] == 0.0,
          "fp32 convolutions give other bits at batch 128 than at 256")
    # the bounds against batch 256 (fraction of rows); None: printed only
    bounds = {"fp32_predict_ctc": 1.0, "fp32_predict": 0.99}
    refs = {}
    for name, (dtype, call) in decodes.items():
        eng = base if dtype == torch.bfloat16 else base32
        refs[name] = (call(eng, BATCH), call(eng, half))
    for label, devices in meshes.items():
        res = {}
        for dtype in (torch.bfloat16, torch.float32):
            two = engine(dtype, mesh=devices)
            for name, (dt, call) in decodes.items():
                if dt != dtype:
                    continue
                call(two, BATCH)  # warm-up
                got, wall = counted(f"{label}_{name}", lambda: call(two, BATCH), 2 * n_batches)
                out["img_s"][f"{label}_{name}"] = N_IMAGES / wall
                full, blocks = refs[name]
                exact = sum(a == b for a, b in zip(got, blocks))
                check(exact == N_IMAGES, f"{label} {name}: {exact}/{N_IMAGES} rows equal the "
                      f"engine without a mesh at batch {half} (strings and confidences)")
                text = [r[0] if isinstance(r, tuple) else r for r in got]
                want_full = [r[0] if isinstance(r, tuple) else r for r in full]
                control = sum(a == b for a, b in zip(
                    [r[0] if isinstance(r, tuple) else r for r in blocks], want_full))
                same = sum(a == b for a, b in zip(text, want_full))
                differing = [i for i, (a, b) in enumerate(zip(text, want_full)) if a != b]
                for i in differing[:4]:
                    print(f"    {label} {name}: row {i}: {text[i]!r} vs batch {BATCH} "
                          f"{want_full[i]!r}")
                res[name] = dict(equal_batch_128=exact, equal_batch_256=same,
                                 no_mesh_128_vs_256=control)
                need = bounds.get(name)
                if need is not None:
                    check(same >= need * N_IMAGES, f"{label} {name}: {same}/{N_IMAGES} rows "
                          f"equal the engine without a mesh at batch {BATCH}")
            del two
        out[label] = res
        print(f"  {label}: 2 x (11 + 2) launches per batch; every decode equals the engine "
              f"without a mesh at batch {half} on {N_IMAGES}/{N_IMAGES} rows (strings and "
              f"confidences); rows equal batch {BATCH} (the same engine's batch {half} vs "
              f"{BATCH} beside): " + ", ".join(
                  f"{k} {v['equal_batch_256']} ({v['no_mesh_128_vs_256']})"
                  for k, v in res.items()))
    del base32
    if n_cards >= 2:
        out["kernels_on_cuda1"] = kernels_on_a_second_card()

    # (3) an artifact under a mesh: equal to the same artifact without one
    # and to one exported at the replicas' block size
    arts = {}
    for b in (BATCH, half):
        arts[b] = os.path.join(root, f"ctc_greedy_b{b}")
        export_serving_artifact(base, arts[b], method="ctc_greedy", batch_size=b,
                                canvas=DAEMON_CANVAS)
    plain_art = ServingArtifact.load(arts[BATCH]).predict(images)
    block_art = ServingArtifact.load(arts[half]).predict(images)
    for label, devices in meshes.items():
        sharded = ServingArtifact.load(arts[BATCH], mesh=devices)
        got, wall = counted(f"{label}_artifact", lambda: sharded.predict(images),
                            2 * n_batches)
        exact = sum(a == b for a, b in zip(got, block_art))
        check(exact == N_IMAGES, f"{label} artifact: {exact}/{N_IMAGES} rows equal the "
              f"artifact exported at batch {half}")
        same = sum(a == b for a, b in zip(got, plain_art))
        out[f"{label}_artifact"] = dict(equal_batch_128=exact, equal_batch_256=same)
        print(f"  ctc_greedy artifact over {label}: rows equal the artifact without a mesh "
              f"{same}/{N_IMAGES}, the one exported at batch {half} {exact}/{N_IMAGES}; "
              f"{N_IMAGES / wall:.1f} img/s on {power}")
        del sharded

    # (4) serve --mesh and serve, each under the load tool
    weights = os.path.join(root, "weights.msgpack")
    with open(weights, "wb") as f:
        f.write(msgpack_serialize(variables))
    png_path = os.path.join(root, "line.png")
    with open(png_path, "wb") as f:
        f.write(png_encode(images[0]))
    args = ["--model", weights, "--charset", charset_path, "--img-h", str(IMG_H), "--img-w",
            str(IMG_W), "--canvas", ",".join(map(str, DAEMON_CANVAS)), "--batch-size",
            str(BATCH), "--method", "ctc_greedy"]
    # the two daemons start and take their warm-up request side by side, then
    # are loaded one at a time
    daemons = {"serve --mesh": serve_start([*args, "--mesh"], "serve_mesh"),
               "serve": serve_start(args, "serve")}
    try:
        warmers = [threading.Thread(target=warm_up, args=(d, png_path)) for d in daemons.values()]
        for t in warmers:
            t.start()
        for t in warmers:
            t.join()
        out["serve_mesh"] = serve_and_load(daemons["serve --mesh"], png_path, "serve --mesh",
                                           power)
        out["serve"] = serve_and_load(daemons["serve"], png_path, "serve", power)
    finally:
        for started in daemons.values():
            if started["proc"].poll() is None:
                started["proc"].kill()
    ref = daemon["ctc_greedy"]["levels"]
    print("  the daemon phase's ctc_greedy daemon (512 distinct lines, in-process): " + ", ".join(
        f"c={c} {ref[f'c{c}_raw']['req_s']:.1f} req/s p50 {ref[f'c{c}_raw']['p50_ms']:.2f} ms"
        for c, _ in MESH_LOAD) + f" on {power}")

    # (5) the .pth export of this model, read back through the importer
    cs = Charset.from_file(charset_path)
    pth = os.path.join(root, "model.pth")
    save_torch_checkpoint(pth, variables, layout="full", itos=list(cs.itos),
                          stoi=dict(cs.stoi), config={"img_h": IMG_H, "img_w": IMG_W})
    from_pth = OCRInference(pth, device="cuda", dtype=torch.bfloat16)
    check(not from_pth.model.with_ctc_head, "the .pth carried a CTC head")
    got = from_pth.predict(images, max_length=MAX_LENGTH, batch_size=BATCH)
    same = sum(a == b for a, (b, _) in zip(got, want["predict"]))
    check(same == N_IMAGES, f".pth round trip: {same}/{N_IMAGES} attention strings equal")
    out["pth"] = {"mb": os.path.getsize(pth) / 1e6, "strings_equal": same}
    print(f"  .pth export ({out['pth']['mb']:.1f} MB, full layout) -> OCRInference: "
          f"{same}/{N_IMAGES} attention strings equal the model's")
    del from_pth, base

    print(f"  img/s (bf16, bs {BATCH}, {N_IMAGES} lines, host resize included) on {power}: "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["img_s"].items()))
    out["launch_counts"] = dict(launches)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  mesh phase: {out['seconds']:.1f} s")
    return out


def cli_phase(kernels, variables, images, power: str) -> dict:
    """``python -m rcnn_ocr_tpu_torch.minimal_inference``, the single-image
    CLI, on the main path's weights written as a msgpack checkpoint: once as
    a subprocess (its wall from process start to exit is the cold start),
    then its flag matrix in-process, each run counted from 0: 11 + 2
    launches for its one image, and its printed string equal to the same
    engine's ``predict`` / ``predict_serving`` on that image at batch 1
    (the call the script makes; bf16 compared at equal block size).  The
    images are a PNG line and the lossless JPEG, BigTIFF and CIELab TIFF
    lines; the mesh phase's ``.pth`` export is read too, and
    ``--lm-weight`` without a beam raises as the JAX script's does."""
    import contextlib
    import io

    from rcnn_ocr_tpu_torch import minimal_inference as cli
    from rcnn_ocr_tpu_torch.data.image_io import png_encode
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.lm import save_lm
    from rcnn_ocr_tpu_torch.training.checkpoint import msgpack_serialize
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    t_phase = time.perf_counter()
    root = os.path.join(REPO, "build", "chip_smoke", "cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    charset_path = os.path.join(REPO, "configs", "charset.txt")
    weights = os.path.join(root, "weights.msgpack")
    with open(weights, "wb") as f:
        f.write(msgpack_serialize(variables))
    lm_path = os.path.join(root, "lm.npz")
    cs = Charset.from_file(charset_path)
    save_lm(lm_path, seeded_lm(cs), cs.itos)
    paths = {"png": os.path.join(root, "line.png")}
    with open(paths["png"], "wb") as f:
        f.write(png_encode(images[0]))
    for kind, name in (("lossless", "lossless_line_0.jpg"), ("bigtiff", "bigtiff_line_0.tif"),
                       ("cielab", "cielab_line_0.tif")):
        paths[kind] = fixture_path(name)
    size = ["--img-h", str(IMG_H), "--img-w", str(IMG_W)]
    out = {"runs": {}}

    # (1) a user's run: a process of its own
    cmd = [sys.executable, "-m", "rcnn_ocr_tpu_torch.minimal_inference", weights, charset_path,
           paths["png"], *size]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    out["cold_start_s"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"minimal_inference exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    sub_line = proc.stdout.strip().splitlines()[-1]

    # (2) the flag matrix in-process, the engine each run builds kept
    built = []

    def recording(*args, **kw):
        built.append(OCRInference(*args, **kw))
        return built[-1]

    beam = ["--beam-width", str(BEAM_WIDTH), "--lm", lm_path, "--lm-weight", str(LM_WEIGHT),
            "--length-penalty", "0.6"]
    pth = os.path.join(REPO, "build", "chip_smoke", "mesh", "model.pth")
    matrix = {  # name: (model, image, flags)
        "greedy": (weights, "png", size),
        "serving": (weights, "lossless", ["--serving", *size]),
        "beam_lm": (weights, "bigtiff", [*beam, *size]),
        "serving_beam_lm": (weights, "cielab", ["--serving", *beam, *size]),
        "width_buckets": (weights, "png", ["--width-buckets", "64,128", *size]),
        "default_size": (weights, "lossless", []),
        "quantize": (weights, "png", ["--quantize", *size]),
        "pth": (pth, "cielab", size),
    }
    launches = collections.Counter()
    cli.OCRInference = recording
    try:
        for name, (model, image, flags) in matrix.items():
            argv = [model, charset_path, paths[image], *flags]
            printed = io.StringIO()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                cli.main(argv)
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            check(counts == {"se_scale": 11, "bilstm_scan": 2},
                  f"minimal_inference {name} launched {counts} (11 + 2 for its one image)")
            launches.update(counts)
            engine = built[-1]
            if "--serving" in flags:
                use_beam = "--beam-width" in flags
                want = engine.predict_serving(
                    paths[image], canvas="auto",
                    method="attention_beam" if use_beam else "attention",
                    beam_width=BEAM_WIDTH if use_beam else 16,
                    length_penalty=0.6 if use_beam else 0.0,
                    lm_weight=LM_WEIGHT if use_beam else 0.0)
            elif "--beam-width" in flags:
                want = engine.predict(paths[image], beam_width=BEAM_WIDTH, length_penalty=0.6,
                                      lm_weight=LM_WEIGHT)
            else:
                want = engine.predict(paths[image])
            line = printed.getvalue().strip().splitlines()[-1]
            check(line == f"Result: '{want}'", f"minimal_inference {name} printed {line!r}, "
                  f"the engine's {'predict_serving' if '--serving' in flags else 'predict'} "
                  f"gives {want!r}")
            out["runs"][name] = {"wall_s": wall, "image": image, "text": want,
                                 "engine_dtype": str(engine.dtype),
                                 "quantize": "--quantize" in flags}
            print(f"  minimal_inference {name} ({os.path.basename(model)}, {image}): {line}, "
                  f"= the engine's call; 11 + 2 launches; {wall:.2f} s in-process")
            del engine
            built.clear()
        try:
            cli.main([weights, charset_path, paths["png"], *size, "--lm-weight", "0.5"])
            check(False, "--lm-weight without a beam ran (the JAX script raises)")
        except ValueError as err:
            check("beam" in str(err), f"--lm-weight without a beam: {err}")
    finally:
        cli.OCRInference = OCRInference
    check(sub_line == f"Result: '{out['runs']['greedy']['text']}'",
          f"the subprocess printed {sub_line!r}, in-process greedy "
          f"{out['runs']['greedy']['text']!r}")
    out["launch_counts"] = dict(launches)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  python -m rcnn_ocr_tpu_torch.minimal_inference as a user runs it: {sub_line} in "
          f"{out['cold_start_s']:.1f} s from process start to exit (the cold start: imports, "
          f"kernel libraries, weights, one image) on {power}; = the in-process greedy run; "
          f"--lm-weight without a beam raises ValueError; cli phase {out['seconds']:.1f} s")
    return out


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


def json_leaves_with_paths(tree, prefix=""):
    """``(path, leaf)`` of a nested dict of arrays, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from json_leaves_with_paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def json_leaves(tree):
    for _, leaf in json_leaves_with_paths(tree):
        yield leaf


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
        for csv_name, part in (("labels.csv", rows), ("labels_small.csv", rows[:LOOP_SMALL]),
                               ("labels_half.csv", rows[: DP_TRAIN + DP_VAL])):
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

    # run 1: LOOP_EPOCHS epochs, then SIGTERM a few steps into the next
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
    out["run1"] = loop_counts_check(kernels, first, f"run 1 (epochs 1-{LOOP_EPOCHS}, SIGTERM "
                                                    f"in epoch {LOOP_EPOCHS + 1})")
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

    # run 2: resume, finish the cut epoch
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    second = run_training(Config(dict(loop_config(paths, exp_dir, profile_steps=0),
                                      resume_path=exp_dir)))
    run2_s = time.perf_counter() - t0
    out["run2"] = loop_counts_check(kernels, second, f"run 2 (resumed, epoch {LOOP_EPOCHS + 1})")
    check(second["start_epoch"] == LOOP_EPOCHS + 1, f"resumed at epoch {second['start_epoch']}")
    check(second["global_step"] == blob["global_step"] + steps_per_epoch,
          f"global_step {second['global_step']} after the resume")
    check(second["epochs"][0]["train_loss"] < losses[0],
          "the resumed epoch trains from scratch, not from the slot")
    loop_launches = {k: out["run1"][k] + out["run2"][k] for k in ("se_scale", "bilstm_scan")}

    # the eval CLI on the last weights, its four processes started now, to run
    # beside the checks below (finished at the phase's end)
    import csv

    weights = os.path.join(exp_dir, "last_weights.msgpack")
    val_dir = paths["printed/val"]
    with open(os.path.join(val_dir, "labels.csv"), encoding="utf-8") as f:
        rows = list(csv.reader(f))
    eval_cli_finish = eval_cli_runs(weights, val_dir, rows, shipped["train_csvs"], cs)

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
    charset_path = os.path.join(REPO, "configs", "charset.txt")
    engine = OCRInference(weights, charset_path=charset_path, device="cuda", img_h=IMG_H,
                          img_w=IMG_W, dtype=torch.bfloat16)
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
    served_batches = list(device_batches(engine, val_paths, TRAIN_BATCH))
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

    # where the loop's time goes (epochs after the first, which carries the profile window)
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
    out.update(paths=paths)
    out.update(timing=timing, run1_s=run1_s, run2_s=run2_s, consistency=consistency,
               rows=len(rows), train_losses=losses, val_losses=val_losses,
               epochs=first["epochs"] + second["epochs"], launches=loop_launches,
               resumed_global_step=second["global_step"], preempted_slot_step=blob["global_step"])
    out["ckpt_tools"] = checkpoint_tools(kernels, exp_dir, val_paths, rows,
                                         served["attention"], power)
    out["eval_cli"] = eval_cli_finish()
    return out


def checkpoint_tools(kernels, exp_dir: str, val_paths, rows, last_texts, power: str) -> dict:
    """``python -m rcnn_ocr_tpu_torch.average_checkpoints`` and ``ckpt_info``
    as subprocesses on the loop's three slots (where flax does not import,
    these take the place of the JAX package's tools): the averages bit-equal
    to a float64 numpy recomputation, ``--json`` fields equal to the blobs',
    exit 2 on a format-2 copy and 1 on a missing path, and ``OCRInference``
    reading set B's validation lines with the uniform average."""
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.training import checkpoint as ckpt

    work = os.path.join(REPO, "build", "chip_smoke", "ckpt_tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    slots = [os.path.join(exp_dir, f"{s}{ckpt.CKPT_SUFFIX}") for s in ("best_acc", "best_loss",
                                                                         "last")]
    env = dict(os.environ, PYTHONPATH=REPO)
    walls = {}

    def tool(name, *args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"rcnn_ocr_tpu_torch.{name}", *args],
                              cwd=work, env=env, capture_output=True, text=True, timeout=300)
        walls.setdefault(name, []).append(time.perf_counter() - t0)
        return proc

    blobs = [ckpt.load_checkpoint_blob(p) for p in slots]
    averages = {}
    for label, weights in (("uniform", None), ("weighted", "0.5,0.3,0.2")):
        path = os.path.join(work, f"avg_{label}.msgpack")
        proc = tool("average_checkpoints", "--out", path, *slots,
                    *(["--weights", weights] if weights else []))
        check(proc.returncode == 0, f"average_checkpoints {label} exited {proc.returncode}:\n"
                                    f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        w = (np.asarray([float(v) for v in weights.split(",")]) if weights
             else np.ones(len(slots)))
        w = w / w.sum()
        got = ckpt.load_checkpoint_blob(path)
        n_leaves = 0
        for col in ("params", "batch_stats"):
            trees = [(b.get("ema_params") or b["params"]) if col == "params" else b[col]
                     for b in blobs]
            flat = [dict(json_leaves_with_paths(t)) for t in trees]
            for key, leaf in json_leaves_with_paths(got[col]):
                acc = np.asarray(flat[0][key], np.float64) * w[0]
                for f, wi in zip(flat[1:], w[1:]):
                    acc = acc + np.asarray(f[key], np.float64) * wi
                want = acc.astype(np.asarray(flat[0][key]).dtype)
                check(leaf.dtype == want.dtype and np.array_equal(leaf, want),
                      f"average {label}: {col}/{key} differs from numpy's float64 mix")
                n_leaves += 1
        check(got["itos"] == blobs[0]["itos"] and got["config"] == blobs[0]["config"],
              f"average {label}: charset / config not the first slot's")
        averages[label] = path
        print(f"  average_checkpoints {label}: exit 0 in {walls['average_checkpoints'][-1]:.1f} s; "
              f"{n_leaves} leaves bit-equal to numpy's float64 mix of the 3 slots")

    stamped = os.path.join(work, "format2.msgpack")
    ckpt._atomic_write(stamped, dict(blobs[-1], format_version=2))
    for path in slots + list(averages.values()):
        proc = tool("ckpt_info", path, "--json")
        check(proc.returncode == 0, f"ckpt_info {path} exited {proc.returncode}: {proc.stdout}")
        info, blob = json.loads(proc.stdout), ckpt.load_checkpoint_blob(path)
        full = "epoch" in blob
        n = sum(1 for _ in json_leaves_with_paths(blob["params"]))
        want = {"format_version": blob["format_version"], "readable": True,
                "kind": "full_checkpoint" if full else "weights",
                "has_ema_params": "ema_params" in blob, "has_batch_stats": True,
                "has_quant_calibration": False}
        if full:
            want.update(epoch=blob["epoch"], global_step=blob["global_step"],
                        best_val_loss=blob["best_val_loss"], best_val_acc=blob["best_val_acc"],
                        charset_size=len(blob["itos"]))
        check({k: info[k] for k in want} == want and info["params"]["leaves"] == n,
              f"ckpt_info {path}: {info} does not describe the blob")
    for path, rc in ((stamped, 2), (os.path.join(work, "missing.msgpack"), 1)):
        proc = tool("ckpt_info", path, "--json")
        check(proc.returncode == rc, f"ckpt_info {path} exited {proc.returncode}, not {rc}")
    print(f"  ckpt_info --json: the 3 slots and 2 averages described as their blobs (exit 0), a "
          f"format-2 copy exit 2, a missing path exit 1; "
          f"{np.mean(walls['ckpt_info']):.1f} s wall per call")

    charset_path = os.path.join(REPO, "configs", "charset.txt")
    engine = OCRInference(averages["uniform"], charset_path=charset_path, device="cuda",
                          img_h=IMG_H, img_w=IMG_W, dtype=torch.bfloat16)
    batches = -(-len(val_paths) // TRAIN_BATCH)
    kernels.reset_launch_counts()
    texts = engine.predict(val_paths, max_length=TRAIN_MAX_LEN, batch_size=TRAIN_BATCH)
    counts = kernels.launch_counts()
    check(counts == {"se_scale": 11 * batches, "bilstm_scan": 2 * batches},
          f"OCRInference on the average launched {counts} over {batches} batches")
    right = sum(t == r[1] for t, r in zip(texts, rows))
    last_right = sum(t == r[1] for t, r in zip(last_texts, rows))
    print(f"  OCRInference(average of 3 slots) on set B's {len(rows)} validation lines: "
          f"{right} exactly right beside last_weights' {last_right} (attention, bf16), 11 + 2 "
          f"launches per batch; tool wall times {({k: [round(t, 2) for t in v] for k, v in walls.items()})} s "
          f"on {power}")
    return {"wall_s": walls, "avg_exactly_right": right, "last_exactly_right": last_right,
            "rows": len(rows), "launch_counts": counts}


def eval_cli_runs(weights: str, val_dir: str, rows, train_csvs, cs):
    """``python -m rcnn_ocr_tpu_torch.evaluate`` as a user runs it, on the
    loop's last weights over set B's validation PNGs: ``--decode ctc_beam``,
    and ``attention_beam`` with a bigram LM from the training labels and an
    LM-weight sweep, each from a folder of its own, side by side with each
    other and with :func:`eval_cli_variants`' pair (four processes on the
    card beside what the caller does meanwhile; each wall is a process's
    start to its exit among the others).  Returns the call that waits for
    them: each must exit 0 and write a report of all rows and a per-sample
    CSV of as many rows."""
    import csv

    from rcnn_ocr_tpu_torch.lm import iter_labels, save_lm, train_bigram_lm

    work = os.path.join(REPO, "build", "chip_smoke", "eval_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    labels = os.path.join(work, "labels.csv")
    with open(labels, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows([("filename", "text"), *rows])
    lm_path = os.path.join(work, "lm.npz")
    save_lm(lm_path, train_bigram_lm((t for c in train_csvs for t in iter_labels(c)), cs), cs.itos)
    base = [sys.executable, "-m", "rcnn_ocr_tpu_torch.evaluate", "--model", weights,
            "--charset", os.path.join(REPO, "configs", "charset.txt"), "--csv", labels,
            "--root", val_dir, "--img-h", str(IMG_H), "--img-w", str(IMG_W),
            "--max-length", str(TRAIN_MAX_LEN), "--batch-size", str(TRAIN_BATCH)]
    runs = {"ctc_beam": ["--decode", "ctc_beam"],
            "attention_beam_lm_sweep": ["--decode", "attention_beam", "--lm", lm_path,
                                        "--lm-weight", f"0,{LM_WEIGHT}"]}
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = {}
    for name, extra in runs.items():
        folder = os.path.join(work, name)
        os.makedirs(folder)
        procs[name] = popen_logged(base + extra + ["--report-json",
                                                   os.path.join(folder, "report.json")],
                                   os.path.join(folder, "log"), env, timeout=600, cwd=folder)
    variants_finish = eval_cli_variants(weights, work, env)
    return lambda: eval_cli_finish(procs, runs, variants_finish, weights, rows)


def eval_cli_finish(procs: dict, runs: dict, variants_finish, weights: str, rows) -> dict:
    """Waits for :func:`eval_cli_runs`' processes and checks what they wrote."""
    import csv

    out = {"variant_formats": variants_finish()}
    for name, (proc, logs) in procs.items():
        stdout, stderr = wait_logged(proc, logs)
        check(proc.returncode == 0, f"evaluate {name} exited {proc.returncode}:\n"
                                    f"{stdout[-3000:]}{stderr[-3000:]}")
        folder = os.path.dirname(logs["paths"][0])
        with open(os.path.join(folder, "report.json"), encoding="utf-8") as f:
            payload = json.load(f)
        metrics = payload["sweep"] if "sweep" in payload else [payload]
        check(all(m["n"] == len(rows) for m in metrics), f"evaluate {name}: report {payload}")
        with open(os.path.join(folder, f"evaluation_results_{os.path.basename(weights)}.csv"),
                  encoding="utf-8") as f:
            sample_rows = list(csv.reader(f))[1:]
        check(len(sample_rows) == len(rows), f"evaluate {name}: {len(sample_rows)} sample rows")
        out[name] = dict(wall_s=logs["wall_s"], metrics=metrics)
        print(f"  python -m rcnn_ocr_tpu_torch.evaluate {' '.join(runs[name])}: exit 0 in "
              f"{logs['wall_s']:.1f} s wall (one process: start, build check, load, {len(rows)} "
              f"PNGs; beside three others); " + "; ".join(
                  f"accuracy {m['accuracy']:.4f}, CER {m['cer']:.4f}, WER {m['wer']:.4f}"
                  + (f" at lm_weight {m['lm_weight']}" if "lm_weight" in m else "")
                  for m in metrics))
    return out


def eval_cli_variants(weights: str, work: str, env: dict):
    """The eval CLI over a CSV of the NEW_VARIANTS lines (G4 and G3
    TIFF, JPEG-in-TIFF, YCbCr TIFF, 1-bit and RLE8 BMP, lossy and
    lossless-with-alpha WebP, interlaced GIF, binary PGM) and over one of PNG
    twins of their pixels, the two processes started side by side on the
    card; the call returned waits for them: both exit 0 with every row read
    (none left out as unreadable) and give each line its twin's string."""
    import csv

    from rcnn_ocr_tpu_torch.data.image_io import imread, png_encode

    names = [n for n, _, v in VARIANT_LINES if v in NEW_VARIANTS]
    procs = {}
    for kind in ("variants", "twins"):
        folder = os.path.join(work, kind)
        os.makedirs(folder)
        files = []
        for n in names:
            if kind == "variants":
                shutil.copy(fixture_path(n), folder)
                files.append(n)
            else:
                with open(os.path.join(folder, n + ".png"), "wb") as f:
                    f.write(png_encode(imread(fixture_path(n))))
                files.append(n + ".png")
        labels = os.path.join(folder, "labels.csv")
        with open(labels, "w", newline="", encoding="utf-8") as f:
            csv.writer(f).writerows([("filename", "text")] + [(n, "a") for n in files])
        procs[kind] = popen_logged(
            [sys.executable, "-m", "rcnn_ocr_tpu_torch.evaluate", "--model", weights,
             "--charset", os.path.join(REPO, "configs", "charset.txt"), "--csv", labels,
             "--root", folder, "--img-h", str(IMG_H), "--img-w", str(IMG_W), "--max-length",
             str(TRAIN_MAX_LEN), "--batch-size", str(len(files)), "--decode", "ctc_greedy",
             "--report-json", os.path.join(folder, "report.json")],
            os.path.join(folder, "log"), env, timeout=600, cwd=folder)
    return lambda: eval_cli_variants_finish(procs, names, work, weights)


def eval_cli_variants_finish(procs: dict, names, work: str, weights: str) -> dict:
    """Waits for :func:`eval_cli_variants`' pair and checks what it wrote."""
    import csv

    out, predicted = {}, {}
    for kind, (proc, logs) in procs.items():
        stdout, stderr = wait_logged(proc, logs)
        wall = logs["wall_s"]
        check(proc.returncode == 0, f"evaluate over the {kind} exited {proc.returncode}:\n"
                                    f"{stdout[-3000:]}{stderr[-3000:]}")
        folder = os.path.join(work, kind)
        with open(os.path.join(folder, "report.json"), encoding="utf-8") as f:
            n_read = json.load(f)["n"]
        check(n_read == len(names), f"evaluate over the {kind} read {n_read} of {len(names)} rows")
        with open(os.path.join(folder, f"evaluation_results_{os.path.basename(weights)}.csv"),
                  encoding="utf-8") as f:
            predicted[kind] = [r[2] for r in list(csv.reader(f))[1:]]
        out[kind] = dict(wall_s=wall, rows=n_read)
    apart = [(n, a, b) for n, a, b in zip(names, predicted["variants"], predicted["twins"])
             if a != b]
    check(len(predicted["variants"]) == len(names) and not apart,
          f"evaluate read variant lines otherwise than their PNG twins: {apart}")
    out["rows_equal"] = len(names)
    print(f"  python -m rcnn_ocr_tpu_torch.evaluate --decode ctc_greedy over {len(names)} lines "
          f"({', '.join(NEW_VARIANTS)}) and over their PNG twins, side by side: exit 0 in "
          f"{out['variants']['wall_s']:.1f} / {out['twins']['wall_s']:.1f} s, every row read, "
          f"rows equal on {len(names)}/{len(names)}")
    return out


# --- scale-out: data parallelism across processes, and the HPO driver -----------

def synthetic_fixtures():
    """tests/torch_port_data/make_synthetic_fixtures.py as a module: the
    seeded sets and the digest recipe expected.json was written with."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_fixtures", os.path.join(os.path.dirname(SYNTH_EXPECTED), "..",
                                                "make_synthetic_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthetic_phase(power: str) -> dict:
    """The port's synthetic generator on the card's host, then its dataset on
    the card.  Builds the host libraries it needs (the TrueType reader and
    the JPEG encoder) from the repo's sources; holds a seeded set a
    difficulty from the carried font to ``expected.json``'s digest (the
    bytes this host gives must be the CPU's); writes the CLI's default
    dataset (512 + 128 medium lines, img_h 48, charset, config with one
    epoch) through ``generate_dataset`` with the carried font, and 128 hard
    lines, printing lines/s and host ms per line per stage; runs ``python
    -m rcnn_ocr_tpu_torch.make_synthetic_dataset`` where the host has fonts
    (beside the training); trains the written config.json (the shipped
    model, bs 128, one epoch) with ``python -m
    rcnn_ocr_tpu_torch.training.train``: finite losses and 11 + 2 launches
    a batch; then ``python -m rcnn_ocr_tpu_torch.evaluate`` on val/eval.csv
    (every row read; the accuracy printed, not held).  Within
    SYNTH_PHASE_S."""
    from rcnn_ocr_tpu_torch import native
    from rcnn_ocr_tpu_torch.data import synthetic
    from rcnn_ocr_tpu_torch.make_synthetic_dataset import write_dataset

    t_phase = time.perf_counter()
    work = os.path.join(REPO, "build", "chip_smoke", "synthetic")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    t0 = time.perf_counter()
    for lib in ("truetype", "jpeg_encode", "jpeg_decode"):
        native.load(lib)
    out["host_build_s"] = time.perf_counter() - t0
    print(f"  host libraries truetype, jpeg_encode, jpeg_decode built or loaded in "
          f"{out['host_build_s']:.2f} s")

    with open(SYNTH_EXPECTED, encoding="utf-8") as f:
        expected = json.load(f)
    digests = synthetic_fixtures().render_digests(os.path.join(work, "digest"))
    for difficulty, want in expected.items():
        got = digests[difficulty]
        bad = [k for k, (a, b) in enumerate(zip(got["images"], want["images"])) if a != b]
        check(got["csv"] == want["csv"] and not bad,
              f"synthetic {difficulty}: this host's bytes are not the CPU's (CSV "
              f"{'equal' if got['csv'] == want['csv'] else 'differs'}, images {bad} differ)")
    print(f"  digest: {len(expected)} seeded sets ({', '.join(expected)}), "
          f"{sum(v['n'] for v in expected.values())} lines, equal to expected.json")

    data = os.path.join(work, "data")
    with synthetic.stage_seconds() as spent:
        t0 = time.perf_counter()
        made = write_dataset(data, SYNTH_TRAIN, SYNTH_VAL, fonts=[SYNTH_FONT], epochs=1)
        gen_s = time.perf_counter() - t0
    n = SYNTH_TRAIN + SYNTH_VAL
    out["medium"] = dict(lines=n, seconds=gen_s, lines_per_s=n / gen_s,
                         ms_per_line={k: v / n * 1e3 for k, v in spent.items()})
    with synthetic.stage_seconds() as spent:
        t0 = time.perf_counter()
        synthetic.generate_dataset(os.path.join(work, "hard"), SYNTH_HARD, difficulty="hard",
                                   fonts=[SYNTH_FONT])
        hard_s = time.perf_counter() - t0
    out["hard"] = dict(lines=SYNTH_HARD, seconds=hard_s, lines_per_s=SYNTH_HARD / hard_s,
                       ms_per_line={k: v / SYNTH_HARD * 1e3 for k, v in spent.items()})
    for name in ("medium", "hard"):
        r = out[name]
        print(f"  generate {name}: {r['lines']} lines in {r['seconds']:.2f} s, "
              f"{r['lines_per_s']:.1f} lines/s on the host; ms per line: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in r["ms_per_line"].items()) + f" ({power})")

    fonts = synthetic.discover_fonts()
    env = dict(os.environ, PYTHONPATH=REPO)
    cli = None
    if fonts:
        cli_cmd = [sys.executable, "-m", "rcnn_ocr_tpu_torch.make_synthetic_dataset", "--out",
                   os.path.join(work, "cli"), "--n-train", str(SYNTH_CLI_TRAIN), "--n-val",
                   str(SYNTH_CLI_VAL)]
        cli = popen_logged(cli_cmd, os.path.join(work, "cli"), env, timeout=SYNTH_PHASE_S)
    else:
        print("  make_synthetic_dataset CLI not run: this host has no TrueType fonts under "
              "/usr/share/fonts or /usr/local/share/fonts")

    gc.collect()
    torch.cuda.empty_cache()
    result_path = os.path.join(work, "train_result.json")
    train_cmd = [sys.executable, "-m", "rcnn_ocr_tpu_torch.training.train", made["config"],
                 "--result-json", result_path]
    proc, logs = popen_logged(train_cmd, os.path.join(work, "train"), env, timeout=SYNTH_PHASE_S)
    stdout, stderr = wait_logged(proc, logs)
    check(proc.returncode == 0, f"synthetic training exited {proc.returncode}:\n"
                                f"{stdout[-3000:]}{stderr[-5000:]}")
    with open(result_path, encoding="utf-8") as f:
        result = json.load(f)
    losses = epoch_losses(result)
    check(len(losses) == 1 and all(np.isfinite(v) for v in losses[0]),
          f"synthetic training: epoch losses {losses}")
    out["launches"] = dp_launch_check(result, 2, "synthetic training")
    out["train"] = dict(wall_s=logs["wall_s"], losses=losses, epochs=result["epochs"])
    print(f"  python -m rcnn_ocr_tpu_torch.training.train {os.path.relpath(made['config'], REPO)}"
          f": exit 0 in {logs['wall_s']:.1f} s wall, train / val loss {losses[0]}, "
          f"launches {out['launches']}")
    if cli is not None:
        stdout, stderr = wait_logged(*cli)
        check(cli[0].returncode == 0, f"make_synthetic_dataset exited {cli[0].returncode}:\n"
                                      f"{stdout[-3000:]}{stderr[-3000:]}")
        for rel in ("train/labels.csv", "val/eval.csv", "charset.txt", "config.json"):
            check(os.path.exists(os.path.join(work, "cli", rel)), f"the CLI wrote no {rel}")
        out["cli"] = dict(wall_s=cli[1]["wall_s"], fonts=len(fonts))
        print(f"  python -m rcnn_ocr_tpu_torch.make_synthetic_dataset ({len(fonts)} fonts on this "
              f"host): exit 0 in {cli[1]['wall_s']:.1f} s wall, "
              f"{SYNTH_CLI_TRAIN} + {SYNTH_CLI_VAL} lines")

    exp = os.path.join(data, "exp")
    report = os.path.join(work, "eval.json")
    eval_cmd = [sys.executable, "-m", "rcnn_ocr_tpu_torch.evaluate", "--model",
                os.path.join(exp, "last_weights.msgpack"), "--charset", made["charset"],
                "--csv", made["eval_csv"], "--root", os.path.dirname(made["eval_csv"]),
                "--batch-size", "128", "--report-json", report]
    t0 = time.perf_counter()
    proc = subprocess.run(eval_cmd, cwd=work, env=env, capture_output=True, text=True,
                          timeout=SYNTH_PHASE_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"evaluate exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                                f"{proc.stderr[-3000:]}")
    with open(report, encoding="utf-8") as f:
        metrics = json.load(f)
    check(metrics["n"] == SYNTH_VAL, f"evaluate read {metrics['n']} of {SYNTH_VAL} rows")
    out["evaluate"] = dict(wall_s=wall, accuracy=metrics["accuracy"], cer=metrics["cer"])
    print(f"  python -m rcnn_ocr_tpu_torch.evaluate on val/eval.csv: exit 0 in {wall:.1f} s, "
          f"{metrics['n']} rows, accuracy {metrics['accuracy']:.4f}, CER {metrics['cer']:.4f} "
          f"(one epoch of random labels: printed, not held)")
    out["seconds"] = time.perf_counter() - t_phase
    check(out["seconds"] <= SYNTH_PHASE_S,
          f"the synthetic phase took {out['seconds']:.1f} s, over {SYNTH_PHASE_S:.0f}")
    return out


def dp_config(paths: dict, exp_dir: str, **overrides) -> dict:
    """configs/config.json on half of set A (its random split for
    validation), 1 epoch in fp32 at the shipped global batch of 128."""
    with open(os.path.join(REPO, "configs", "config.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    a = paths["handwritten/train"]
    cfg.update(train_csvs=[os.path.join(a, "labels_half.csv")], train_roots=[a], val_csvs=None,
               val_roots=None, train_proportions=None, val_size=DP_VAL,
               charset_path=os.path.join(REPO, "configs", "charset.txt"), exp_dir=exp_dir,
               epochs=1, eval_every=1, num_workers=8, compute_dtype="float32", progress=False)
    cfg.update(overrides)
    return cfg


def train_cli_start(name: str, cfg: dict, nproc: int = 0, extra=(), deterministic: bool = True):
    """``python -m rcnn_ocr_tpu_torch.training.train`` on ``cfg`` started in
    the background, alone (``nproc=0``) or under ``python -m
    torch.distributed.run`` with ``nproc`` ranks; every collective bounded
    by DP_TIMEOUT_S, the whole run by a subprocess timeout.  TF32 is off
    (NVIDIA_TF32_OVERRIDE=0), so that fp32 is fp32; ``--deterministic``
    unless ``deterministic`` is false (the CTC loss's backward has no
    deterministic CUDA kernel, so a run with a CTC head leaves it off).
    Returns the call that waits for it and gives each rank's result (the
    CLI's --result-json)."""
    work = os.path.join(REPO, "build", "chip_smoke", "scale_out")
    cfg_path = os.path.join(work, f"{name}.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    result = os.path.join(work, f"{name}_result.json")
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(nproc)] if nproc else [sys.executable])
    cmd = launcher + ["-m", "rcnn_ocr_tpu_torch.training.train", cfg_path, "--result-json",
                      result, *(["--deterministic"] if deterministic else []), *extra]
    if nproc:
        cmd += ["--dist-timeout", str(DP_TIMEOUT_S)]
    env = dict(os.environ, PYTHONPATH=REPO, NVIDIA_TF32_OVERRIDE="0")
    proc, logs = popen_logged(cmd, os.path.join(work, name), env)

    def finish() -> list:
        stdout, stderr = wait_logged(proc, logs)
        wall = logs["wall_s"]
        check(proc.returncode == 0, f"{name}: {' '.join(cmd[1:])} exited {proc.returncode}:\n"
                                    f"{stdout[-3000:]}{stderr[-5000:]}")
        # one process (or one rank) writes the named file, N ranks one file each
        paths = [result] if nproc <= 1 else [f"{result[:-5]}.rank{r}.json" for r in range(nproc)]
        out = []
        for path in paths:
            with open(path, encoding="utf-8") as f:
                out.append(dict(json.load(f), wall_s=wall))
        return out
    return finish


def popen_logged(cmd, stem: str, env: dict, timeout: float = DP_RUN_TIMEOUT_S,
                 cwd: str = REPO):
    """``cmd`` started from ``cwd`` (the repo) with its output in ``stem``.out
    and ``stem``.err (files, not pipes: nothing stalls while another process
    is waited for), killed past ``timeout``; a thread notes when it ends."""
    logs = {"paths": (stem + ".out", stem + ".err"), "t0": time.perf_counter()}
    with open(logs["paths"][0], "w") as out, open(logs["paths"][1], "w") as err:
        proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=out, stderr=err, text=True)

    def watch():
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        logs["wall_s"] = time.perf_counter() - logs["t0"]
    logs["watcher"] = threading.Thread(target=watch, daemon=True)
    logs["watcher"].start()
    return proc, logs


def wait_logged(proc, logs):
    """Waits for a :func:`popen_logged` process and returns its stdout and
    stderr (its wall from start to exit is ``logs["wall_s"]`` then)."""
    logs["watcher"].join()
    texts = []
    for path in logs["paths"]:
        with open(path, encoding="utf-8", errors="replace") as f:
            texts.append(f.read())
    return texts


def epoch_losses(result: dict) -> list:
    return [(e["train_loss"], e["val_loss"]) for e in result["epochs"]]


def dp_timing(result: dict) -> dict:
    """Per step: the wall time of the train epoch and the gradient
    all_reduce's host time (gloo copies through the host and waits for the
    other rank), and the loader's wait."""
    e = result["epochs"][0]
    steps = max(1, e["steps"])
    return {"step_ms": e["train_s"] * 1e3 / steps,
            "allreduce_ms_per_step": e.get("allreduce_s", 0.0) * 1e3 / steps,
            "loader_wait_ms_per_step": e["loader_wait_s"] * 1e3 / steps,
            "step_dispatch_p50_ms": e["step_timer"].get("p50_ms"),
            "val_s": e.get("val_s"), "steps": e["steps"], "val_batches": e["val_batches"],
            "img_s": e["images"] / max(e["train_s"], 1e-9), "run_wall_s": result["wall_s"]}


def dp_launch_check(result: dict, lstm_layers: int, what: str) -> dict:
    """11 se_scale and ``lstm_layers`` bilstm_scan launches per train step
    and per validation batch of one rank's run."""
    got = result["kernel_launches"]
    batches = sum(e["steps"] + e["val_batches"] for e in result["epochs"])
    want = {"se_scale": 11 * batches, "bilstm_scan": lstm_layers * batches}
    check(got == want, f"{what} launched {got}, expected {want}")
    return got


def expected_tp_report(lstm_layers: int = 2) -> dict:
    """The leaves JAX's DEFAULT_TP_RULES shard on a model axis of 2 at the
    production shape with both heads, and their specs, written out."""
    conv = "PartitionSpec(None, None, None, 'model')"
    want = {f"cnn/layer{stage}_block{b}/conv{c}/conv/kernel": conv
            for stage, blocks in ((3, 5), (4, 3)) for b in range(blocks) for c in (1, 2)}
    for i in range(lstm_layers):
        want.update({f"enc_rnn{i}/w_ih": "PartitionSpec(None, None, 'model')",
                     f"enc_rnn{i}/w_hh": "PartitionSpec(None, None, 'model')",
                     f"enc_rnn{i}/bias": "PartitionSpec(None, 'model')",
                     f"enc_rnn{i}/proj/kernel": "PartitionSpec('model', None)"})
    want.update({"attn/w_gen": "PartitionSpec(None, 'model')",
                 "attn/b_gen": "PartitionSpec('model',)",
                 "attn/w_emb": "PartitionSpec(None, 'model')",
                 "ctc_proj/kernel": "PartitionSpec(None, 'model')",
                 "ctc_proj/bias": "PartitionSpec('model',)"})
    return want


def flat_leaves(tree, prefix: str = ""):
    """(path, array) for every leaf of a nested dict."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from flat_leaves(sub, f"{prefix}/{key}")
    else:
        yield prefix, np.asarray(tree)


def validation_paths(cfg: dict) -> list:
    """The image paths of the random split a scale-out run validates on."""
    from rcnn_ocr_tpu_torch.data.dataset import OCRDataset, random_split
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    cs = Charset.from_file(cfg["charset_path"])
    full = OCRDataset(cfg["train_csvs"][0], cfg["train_roots"][0], cs.stoi,
                      img_height=cfg["img_h"], img_max_width=cfg["img_w"],
                      max_len=cfg["max_len"], strict_max_len=True)
    _, va = random_split(full, len(full) - cfg["val_size"], cfg["val_size"], seed=cfg["seed"])
    return [va.sample_path(i) for i in range(len(va))]


def tensor_parallel_check(ranks: list, alone: dict, exp: dict, power: str) -> dict:
    """The ``tp2`` job's checks and numbers (see the module docstring, 10.2b)
    against ``alone``, the run with no group of the same configuration
    (``exp["alone_both"]``)."""
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.training import checkpoint as ckpt

    check([r["rank"] for r in ranks] == [0, 1] and all(r["ranks"] == 2 for r in ranks),
          "the tensor-parallel job did not run two ranks")
    want = expected_tp_report()
    for r, res in enumerate(ranks):
        check(res["tp_report"] == want, f"tp2 rank {r} shards {sorted(res['tp_report'])}, "
                                        f"expected the {len(want)} leaves {sorted(want)}")
    reading = []
    for (a, b), (c, d) in zip(epoch_losses(ranks[0]), epoch_losses(alone)):
        reading += [abs(a - c) / abs(c), abs(b - d) / abs(d)]
        check(abs(a - c) <= 1e-3 * abs(c) and abs(b - d) <= 1e-3 * abs(d),
              f"tp2 (train, val) {(a, b)} vs one process {(c, d)}: beyond rtol 1e-3")
    check(all(ranks[0]["epochs"][0][k] == ranks[1]["epochs"][0][k]
              for k in ("train_loss", "val_loss", "val_acc", "val_cer", "val_wer")),
          "the two tensor-parallel ranks report different metrics")
    launches = {"se_scale": 0, "bilstm_scan": 0}
    for r, res in enumerate(ranks):
        for k, v in dp_launch_check(res, 2, f"tp2 rank {r}").items():
            launches[k] += v
    files = sorted(os.listdir(exp["tp2"]))
    check(all(f"{slot}{ckpt.CKPT_SUFFIX}" in files for slot in ("last", "best_loss", "best_acc"))
          and not [f for f in files if f.endswith(".tmp")], f"tp2 exp dir holds {files}")
    with open(os.path.join(exp["tp2"], "train.log"), encoding="utf-8") as f:
        log = f.read()
    check("rank 0;" in log and "rank 1;" not in log, "a tp2 rank besides 0 wrote train.log")
    check(f"TP-sharded params: {len(want)} on model axis 2" in log, "tp2 logged no tp_report")

    # the 'last' slot is the whole JAX tree, and serves alone_both's strings
    def shapes(tree):
        return {k: v.shape for k, v in flat_leaves(tree)}

    blobs = {who: ckpt.load_checkpoint_blob(os.path.join(exp[who], f"last{ckpt.CKPT_SUFFIX}"))
             for who in ("alone_both", "tp2")}
    for key in ("params", "batch_stats", "opt_state"):
        check(shapes(blobs["tp2"][key]) == shapes(blobs["alone_both"][key]),
              f"tp2's checkpoint {key} is not the whole tree")
    with open(os.path.join(REPO, "build", "chip_smoke", "scale_out", "tp2.json"),
              encoding="utf-8") as f:
        cfg = json.load(f)
    # the same training from one start: Adam moves an element at most lr a
    # step, so two runs part by at most 2 * lr * steps on any element (a
    # block joined out of place or not gathered parts by a weight's size)
    bound = 2 * cfg["lr"] * ranks[0]["global_step"]
    got, ref = (dict(flat_leaves(blobs[who]["params"])) for who in ("tp2", "alone_both"))
    weight_diff = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
    check(weight_diff <= bound, f"tp2's weights part from alone_both's by {weight_diff:.3e} "
                                f"> 2 * lr * steps = {bound:.3e}")
    paths = validation_paths(cfg)
    strings = {}
    for who in ("alone_both", "tp2", "alone", "gloo2"):
        engine = OCRInference(os.path.join(exp[who], f"last{ckpt.WEIGHTS_SUFFIX}"),
                              charset_path=cfg["charset_path"], device="cuda",
                              img_h=cfg["img_h"], img_w=cfg["img_w"], dtype=torch.float32)
        strings[who] = (engine.predict(paths, max_length=cfg["max_len"], batch_size=128),
                        engine.predict_ctc(paths, batch_size=128)
                        if engine.model.ctc_proj is not None else None)
        del engine
    n = len(paths)

    def agree(a, b, k):
        return sum(x == y for x, y in zip(strings[a][k], strings[b][k]))

    same_attn, same_ctc = agree("tp2", "alone_both", 0), agree("tp2", "alone_both", 1)
    control = agree("gloo2", "alone", 0)
    # two trainings that differ only in reduction order flip 1-4 of 128
    # greedy attention decodes of these two-step weights at near-tied
    # tokens (PERF.md; the data axis's pair is printed beside), so
    # the weights' bound above carries the check and the attention
    # strings need 90% (a block joined out of place reads no line alike)
    check(same_ctc == n and same_attn >= 0.9 * n,
          f"tp2's checkpoint read {same_ctc}/{n} CTC and {same_attn}/{n} attention strings "
          f"as the run with no group's (two gloo ranks vs no group: {control}/{n})")

    out = {"rel_diff": max(reading), "losses": epoch_losses(ranks[0]), "files": files,
           "tp_report_leaves": len(want), "weight_max_abs_diff": weight_diff,
           "weight_bound": bound,
           "strings_equal": {"ctc": same_ctc, "attention": same_attn, "lines": n,
                             "attention_gloo2_vs_alone": control},
           "launches": launches, "ranks": []}
    alone_bytes = alone["state_bytes"]
    for r, res in enumerate(ranks):
        e = res["epochs"][0]
        steps = max(1, e["steps"])
        row = dict(dp_timing(res), tp_collective_ms_per_step=e["tp_collective_s"] * 1e3 / steps,
                   tp_collective_mb_per_step=e["tp_collective_bytes"] / 2**20 / steps,
                   state_bytes=res["state_bytes"],
                   state_share={k: res["state_bytes"][k] / alone_bytes[k] for k in alone_bytes},
                   max_memory_allocated_gib=res["max_memory_allocated"] / 2**30)
        check(all(0.5 < v < 0.65 for v in row["state_share"].values()),
              f"tp2 rank {r} holds {row['state_share']} of one process's state")
        out["ranks"].append(row)
    out["alone_state_bytes"] = alone_bytes
    out["alone_max_memory_allocated_gib"] = alone["max_memory_allocated"] / 2**30
    print(f"  tp2 (data 1 x model 2, gloo on cuda:0) vs one process: (train, val) "
          f"{out['losses']} vs {epoch_losses(alone)}, largest relative difference "
          f"{out['rel_diff']:.3e} (rtol 1e-3); both ranks val_acc {ranks[0]['val_acc']}; "
          f"{len(want)} leaves sharded on each rank; 'last' is the whole tree, its weights "
          f"within {weight_diff:.3e} of alone_both's (bound {bound:.3e}), and reads "
          f"{same_ctc}/{n} CTC and {same_attn}/{n} attention strings as alone_both's "
          f"(two gloo ranks vs no group, attention only: {control}/{n})")
    for r, row in enumerate(out["ranks"]):
        print(f"  tp2 rank {r} on {power}: step_ms {row['step_ms']:.3f}, model-axis "
              f"collectives {row['tp_collective_ms_per_step']:.3f} ms and "
              f"{row['tp_collective_mb_per_step']:.1f} MiB per step, all-reduce "
              f"{row['allreduce_ms_per_step']:.3f} ms per step, params + grads + Adam "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["state_share"].items())
              + f" of one process's, peak CUDA memory {row['max_memory_allocated_gib']:.2f} GiB "
              f"(one process {out['alone_max_memory_allocated_gib']:.2f})")
    return out


def scale_out_phase(kernels, paths: dict, power: str) -> dict:
    """One-rank NCCL vs no group; two gloo ranks on the one card vs one
    process, over the data axis and over the model axis; an HPO study at
    hidden 512 and the hpo_search CLI."""
    from rcnn_ocr_tpu_torch.hpo import driver as hpo_driver
    from rcnn_ocr_tpu_torch.training import checkpoint as ckpt

    base = os.path.join(REPO, "build", "chip_smoke")
    for sub in ("scale_out", "hpo", "hpo_cli"):
        shutil.rmtree(os.path.join(base, sub), ignore_errors=True)
    os.makedirs(os.path.join(base, "scale_out"))
    exp = {name: os.path.join(base, "scale_out", f"exp_{name}")
           for name in ("alone", "nccl1", "gloo2", "alone_both", "tp2")}
    out = {"dp_launches": {"se_scale": 0, "bilstm_scan": 0}}
    # the card's memory for the processes that run side by side: this
    # process's allocator gives back what earlier phases left cached
    gc.collect()
    cached = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    out["parent_reserved_gib"] = (cached / 2**30, torch.cuda.memory_reserved() / 2**30)
    print(f"  this process's CUDA memory reserved before the side-by-side runs: "
          f"{out['parent_reserved_gib'][0]:.1f} GiB, {out['parent_reserved_gib'][1]:.1f} after "
          f"releasing the cache ({torch.cuda.memory_allocated() / 2**30:.1f} allocated)")

    # (1) one rank of NCCL equals the run with no group, bit for bit; (2)
    # two gloo ranks on cuda:0 match one process at the same global batch.
    # The three jobs run side by side on the card (--deterministic: the
    # contention moves their times, not their numbers; more processes
    # beside them would press the card's memory, where a deterministic
    # convolution may take another algorithm and so other bits)
    t0 = time.perf_counter()
    runs = [train_cli_start("alone", dp_config(paths, exp["alone"])),
            train_cli_start("nccl1", dp_config(paths, exp["nccl1"]), nproc=1),
            train_cli_start("gloo2", dp_config(paths, exp["gloo2"]), nproc=2,
                            extra=["--device", "cuda:0", "--backend", "gloo"])]
    (alone,), (nccl1,), ranks = (finish() for finish in runs)
    check(epoch_losses(nccl1) == epoch_losses(alone) and nccl1["val_acc"] == alone["val_acc"],
          f"one NCCL rank {epoch_losses(nccl1)} differs from no group {epoch_losses(alone)}")
    print(f"  one NCCL rank = no group, exactly: (train loss, val loss) per epoch "
          f"{epoch_losses(nccl1)}, val_acc {nccl1['val_acc']}")
    for k, v in dp_launch_check(nccl1, 2, "one NCCL rank").items():
        out["dp_launches"][k] += v

    check([r["rank"] for r in ranks] == [0, 1] and all(r["ranks"] == 2 for r in ranks),
          "the gloo job did not run two ranks")
    reading = []
    for (a, b), (c, d) in zip(epoch_losses(ranks[0]), epoch_losses(alone)):
        reading += [abs(a - c) / abs(c), abs(b - d) / abs(d)]
        check(abs(a - c) <= 1e-3 * abs(c) and abs(b - d) <= 1e-3 * abs(d),
              f"two gloo ranks (train, val) {(a, b)} vs one process {(c, d)}: beyond rtol 1e-3")
    same = all(ranks[0]["epochs"][0][k] == ranks[1]["epochs"][0][k]
               for k in ("train_loss", "val_loss", "val_acc", "val_cer", "val_wer"))
    check(same, "the two ranks report different metrics")
    print(f"  two gloo ranks vs one process: (train, val) {epoch_losses(ranks[0])} vs "
          f"{epoch_losses(alone)}, largest relative difference {max(reading):.3e} "
          f"(rtol 1e-3); both ranks report val_acc {ranks[0]['val_acc']}, val_loss "
          f"{ranks[0]['val_loss']}")
    for r, res in enumerate(ranks):
        for k, v in dp_launch_check(res, 2, f"gloo rank {r}").items():
            out["dp_launches"][k] += v
    files = sorted(os.listdir(exp["gloo2"]))
    for slot in ("last", "best_loss", "best_acc"):
        check(f"{slot}{ckpt.CKPT_SUFFIX}" in files, f"rank 0 wrote no {slot} slot")
    check("metrics_epoch.csv" in files and not [f for f in files if f.endswith(".tmp")],
          f"exp dir holds {files}")
    events = os.listdir(os.path.join(exp["gloo2"], "logs"))
    check(len([f for f in events if "tfevents" in f]) <= 1, f"events files {events}")
    with open(os.path.join(exp["gloo2"], "train.log"), encoding="utf-8") as f:
        log = f.read()
    check("rank 0;" in log and "rank 1;" not in log, "a rank besides 0 wrote train.log")
    out.update(alone=dp_timing(alone), nccl1=dp_timing(nccl1),
               gloo2=[dp_timing(r) for r in ranks], gloo2_rel_diff=max(reading),
               losses={"alone": epoch_losses(alone), "gloo2": epoch_losses(ranks[0])},
               gloo2_files=files)
    out["dp_s"] = time.perf_counter() - t0
    # (2b) two gloo ranks on a model axis of 2 match one process too, both
    # with both heads, so that every leaf the model axis shards is trained
    # (without --deterministic: the CTC loss's backward has no
    # deterministic CUDA kernel); the two jobs side by side, and beside them
    # (3) and (4), the HPO study and CLI: the pair is held to tolerances, not
    # to bits, so the card's other users cannot fail it (the data axis's
    # trio, held bit for bit, ran alone)
    t_tp = time.perf_counter()
    both = dict(head="both")
    tp_runs = [train_cli_start("alone_both", dp_config(paths, exp["alone_both"], **both),
                               deterministic=False),
               train_cli_start("tp2", dp_config(paths, exp["tp2"], mesh_shape=[1, 2],
                                                mesh_axes=["data", "model"], **both),
                               nproc=2, extra=["--device", "cuda:0", "--backend", "gloo"],
                               deterministic=False)]

    # (3) the HPO study, "LSTM 2 512": 2 trials x 2 epochs of half of set A,
    # full width; beside it on the card (4) the CLI with DEFAULT_SPACE and
    # --parallel-trials 2, which must cap at the one card (and the pair of 2b)
    hpo_cfg = dp_config(paths, "", epochs=HPO_EPOCHS, compute_dtype="bfloat16")
    hpo_cfg.pop("exp_dir")
    cli_cfg = os.path.join(base, "scale_out", "hpo_cli.json")
    with open(cli_cfg, "w", encoding="utf-8") as f:
        json.dump(dict(hpo_cfg, epochs=3), f)
    cmd = [sys.executable, "-m", "rcnn_ocr_tpu_torch.hpo_search", "--config", cli_cfg,
           "--trials", "2", "--epochs-per-trial", "1", "--parallel-trials", "2",
           "--storage-dir", os.path.join(base, "hpo_cli"), "--study", "cli"]
    cli_proc, cli_logs = popen_logged(cmd, os.path.join(base, "scale_out", "hpo_cli"),
                                      dict(os.environ, PYTHONPATH=REPO))
    space = dict(hpo_driver.DEFAULT_SPACE, hidden_size=("cat", (512,)), lstm_layers=("cat", (2,)))
    per_trial = []

    def counted(base_cfg, params, trial_dir, report=None):
        before = kernels.launch_counts()
        t_trial = time.perf_counter()
        try:
            return hpo_driver._default_objective(base_cfg, params, trial_dir, report)
        finally:
            after = kernels.launch_counts()
            per_trial.append(dict({k: after[k] - before[k] for k in after},
                                  seconds=time.perf_counter() - t_trial))

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    study = hpo_driver.run_hpo(hpo_cfg, n_trials=HPO_TRIALS, study_name="lstm2_512",
                               storage_dir=os.path.join(base, "hpo"), space=space, seed=0,
                               objective=counted)
    out["hpo_launches"] = kernels.launch_counts()
    out["hpo_s"] = time.perf_counter() - t0
    check(len(study["trials"]) == HPO_TRIALS and len(per_trial) == HPO_TRIALS,
          f"the study ran {len(study['trials'])} trials")
    steps_per_epoch = DP_TRAIN // TRAIN_BATCH
    val_per_epoch = -(-DP_VAL // TRAIN_BATCH)
    for t, launches in zip(study["trials"], per_trial):
        check(np.isfinite(t["value"]) and t["params"]["hidden_size"] == 512
              and t["params"]["lstm_layers"] == 2, f"trial {t}")
        batches = t["epochs_run"] * (steps_per_epoch + val_per_epoch)
        check(launches["se_scale"] == 11 * batches and launches["bilstm_scan"] == 2 * batches,
              f"trial {t['number']} launched {launches} over {batches} batches")
        t["launches"] = launches
        print(f"  trial {t['number']}: value {t['value']:.4f}, epochs {t['epochs_run']}, "
              f"pruned {t['pruned']}, {t['seconds']} s, launches se_scale "
              f"{launches['se_scale']} / bilstm_scan {launches['bilstm_scan']} (K2 at H=512), "
              f"params " + ", ".join(f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                                     for k, v in sorted(t["params"].items())))
    out["hpo_trials"] = study["trials"]

    # (2b) the model-axis pair, finished
    (alone_both,), tp_ranks = (finish() for finish in tp_runs)
    out["tp2"] = tensor_parallel_check(tp_ranks, alone_both, exp, power)
    out["alone_both"] = dp_timing(alone_both)
    out["tp_launches"] = out["tp2"].pop("launches")
    out["tp_s"] = time.perf_counter() - t_tp
    for name, t in (("no group", out["alone"]), ("one NCCL rank", out["nccl1"]),
                    ("gloo rank 0 of 2", out["gloo2"][0]), ("gloo rank 1 of 2", out["gloo2"][1]),
                    ("no group, both heads", out["alone_both"])):
        print(f"  {name} on {power}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in t.items()))

    # (4) the CLI, started beside the study
    cli_out, cli_err = wait_logged(cli_proc, cli_logs)
    out["hpo_cli_s"] = cli_logs["wall_s"]
    check(cli_proc.returncode == 0, f"hpo_search exited {cli_proc.returncode}:\n"
                                    f"{cli_out[-3000:]}{cli_err[-3000:]}")
    check("parallel_trials=2 > 1 devices; running 1 concurrent trials" in cli_err,
          f"hpo_search did not cap at the one card:\n{cli_err[-2000:]}")
    with open(os.path.join(base, "hpo_cli", "cli_results.json"), encoding="utf-8") as f:
        cli = json.load(f)
    check(len(cli["trials"]) == 2 and all(t["epochs_run"] == 1 for t in cli["trials"]),
          f"hpo_search trials {cli['trials']}")
    print(f"  python -m rcnn_ocr_tpu_torch.hpo_search --parallel-trials 2: warned and ran one "
          f"trial at a time on the one card, {out['hpo_cli_s']:.1f} s (beside the study); "
          f"trials " + "; ".join(
              f"{t['number']}: value {t['value']:.4f}, {t['seconds']} s, hidden "
              f"{t['params']['hidden_size']} x {t['params']['lstm_layers']}"
              for t in cli["trials"]))
    out["hpo_cli_trials"] = cli["trials"]

    # (5) the port's report and the JAX package's stdlib tool read it alike
    results = os.path.join(base, "hpo", "lstm2_512_results.json")
    reports = [subprocess.run([sys.executable, *tool, results], cwd=REPO, capture_output=True,
                              text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
               for tool in (["-m", "rcnn_ocr_tpu_torch.hpo.report"],
                            [os.path.join(REPO, "tools", "hpo_report.py")])]
    check(all(r.returncode == 0 for r in reports) and reports[0].stdout == reports[1].stdout,
          f"the two reports differ:\n{reports[0].stdout}\n{reports[1].stdout}")
    print("  hpo.report = tools/hpo_report.py on the study's results:\n    "
          + reports[0].stdout.strip().replace("\n", "\n    "))
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

    phase_s = {}
    mark = [time.perf_counter()]

    def timed(name: str) -> None:  # the phase that just ended
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        print(f"  {name} phase {phase_s[name]:.1f} s")

    build(kernels)
    timed("build")
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernel phase")
    rows = kernel_phase(gen)
    for row in rows:
        for call in row["calls"]:
            print(f"  {row['name']} " + ", ".join(f"{k} {v}" for k, v in call.items()))
    timed("kernel")
    print("bench phase")
    bench = bench_phase(kernels, power)
    timed("bench")
    print("main path phase")
    path, variables, images = main_path(kernels, power)
    timed("main path")
    print("beam phase")
    beams = beam_phase(kernels, variables, images, power)
    timed("beam")
    print("serving phase")
    serving = serving_phase(kernels, variables, images, power)
    timed("serving")
    print("daemon phase")
    daemon = daemon_phase(kernels, variables, images, power)
    timed("daemon")
    print("long-line phase")
    long_line = long_line_phase(kernels, variables, power)
    timed("long-line")
    print("int8 + artifacts phase")
    int8 = int8_artifact_phase(kernels, variables, images, power)
    timed("int8 + artifacts")
    int8["seconds"] = phase_s["int8 + artifacts"]
    print("model-options phase")
    options = model_options_phase(kernels, variables, images, power)
    timed("model-options")
    options["seconds"] = phase_s["model-options"]
    print("mesh phase")
    mesh = mesh_phase(kernels, variables, images, power, daemon)
    timed("mesh")
    print("cli phase")
    cli = cli_phase(kernels, variables, images, power)
    timed("cli")
    print("synthetic phase")
    synth = synthetic_phase(power)
    timed("synthetic")
    del variables
    print("training phase")
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    charset_path = os.path.join(REPO, "configs", "charset.txt")
    cs = Charset.from_file(charset_path)
    training = training_phase(kernels, cs, charset_path, power)
    timed("training")
    print("training-loop phase")
    loop = training_loop_phase(kernels, cs, training["train"]["img_s"], power)
    timed("training-loop")
    print("scale-out phase")
    scale = scale_out_phase(kernels, loop["paths"], power)
    timed("scale-out")
    scale["seconds"] = phase_s["scale-out"]
    backward = {"se_scale": "autograd: plain torch (the hand VJP of se_pallas.py:_se_bwd)",
                "bilstm_scan": "autograd: plain torch (recompute through scan_reference)"}
    train = training["train"]
    for row in rows:
        name = row["name"]
        by_path = {"bench": bench["launches"][name],
                   "inference": path["launch_counts"][name],
                   "beam": beams["launch_counts"][name],
                   "serving": serving["launch_counts"][name],
                   "daemon": daemon["launch_counts"][name],
                   "long_lines": long_line["launch_counts"][name],
                   "int8_artifacts": int8["launch_counts"][name],
                   "model_options": options["launch_counts"][name],
                   "mesh": mesh["launch_counts"][name],
                   "cli": cli["launch_counts"][name],
                   "synthetic": synth["launches"][name],
                   "train": train["launch_counts"][name],
                   "train_loop": loop["launches"][name],
                   "checkpoint_average": loop["ckpt_tools"]["launch_counts"][name],
                   "dp": scale["dp_launches"][name],
                   "tp": scale["tp_launches"][name],
                   "hpo": scale["hpo_launches"][name]}
        row.update(launches=by_path["inference"], launches_by_path=by_path,
                   max_err=row["max_abs_err"], backward_route=backward[name],
                   launches_per_train_step=train["launch_counts"][name] // TRAIN_STEPS,
                   train_fwd_ms_per_step=train[f"{name}_forward_ms"],
                   train_bwd_ms_per_step=train[f"{name}_backward_ms"])
        for p, n in by_path.items():
            check(n > 0, f"{name} never launched on the {p} path")
    result = {"card": power, "kernels": rows, "bench": bench, "main_path": path, "beam": beams,
              "serving": serving, "daemon": daemon, "long_lines": long_line,
              "int8_artifacts": int8, "model_options": options, "mesh": mesh, "cli": cli, "synthetic": synth,
              "training": training, "training_loop": loop, "scale_out": scale,
              "phase_seconds": phase_s, "seconds": time.perf_counter() - t_start}
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "cold_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "max_err", "bound_us",
            "launches_per_encode", "dtype", "batch", "library_call", "launches_by_path",
            "backward_route", "launches_per_train_step", "train_fwd_ms_per_step",
            "train_bwd_ms_per_step")
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    print(f"total {result['seconds']:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
