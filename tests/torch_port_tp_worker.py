"""One rank of a tensor-parallel check of the port, or the one-process reference.

    python -m torch.distributed.run --standalone --nproc-per-node N \
        tests/torch_port_tp_worker.py OUT_DIR D M [--jax STATE] [--units] [--loop CFG]
        [--units-only-on cuda:0] [--production-traffic]

Each rank joins a gloo group on the CPU (every collective bounded by a
timeout), lays the N = D x M ranks out as a ``("data", "model")`` mesh and
writes ``OUT_DIR/rank<R>.npz`` with:

* ``step``: one ``make_train_step(head="both")`` of
  ``tests/torch_port_dp_worker.py``'s small model (width 0.125, hidden 16,
  14 tokens) with encoder and attention dropout, DropBlock, device
  augmentation and ``grad_clip`` on, placed on the model axis, over its data
  index's rows of the 8-row batch: the losses, the clip factor, the
  gradients, parameters (both gathered whole) and batch statistics after the
  step, every mask drawn, and the rank's ``tp_report``;
* ``jax`` (``--jax STATE``, a ``torch.save``d state dict of the JAX model of
  :func:`jax_tp_model`): one step of that model with dropout off, Adam 1e-3,
  on :func:`jax_tp_batch`: loss, gathered gradients, parameters, statistics;
* ``unit`` (``--units``, two model ranks): each autograd Function of the
  model axis forward and backward on known values (``--units-only-on
  DEVICE``: only these, in fp32 and bf16, on that device, e.g. two gloo
  ranks on ``cuda:0``);
* ``--loop CFG``: ``run_training`` on the config file (a resume), with no
  output here (the loop writes its experiment directory).

``--production-traffic`` (two ranks, 1 x 2) prints instead what the model
axis moves in a train step of the shipped model on the CPU
(:func:`production_traffic`).

The test imports :func:`tp_step_case` / :func:`jax_tp_case` to run the
same functions in one process without a group.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
for p in (REPO, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch_port_dp_worker as dp  # noqa: E402

GRAD_CLIP = 0.05  # below the step's global norm, so the clip scales
# the JAX comparison's model: every DEFAULT_TP_RULES leaf divides by 2
JAX_HIDDEN, JAX_WIDTH, JAX_STEPS = 16, 0.0625, 3


def _whole(t: torch.Tensor, p: torch.Tensor) -> np.ndarray:
    """``t`` (a parameter or its gradient) gathered whole over the model
    axis when ``p`` is sharded."""
    from rcnn_ocr_tpu_torch.parallel.mesh import gather_blocks, tp_shard

    s = tp_shard(p)
    t = t.detach()
    if s is not None:
        t = gather_blocks(t.contiguous(), s.dim, s.mesh)
    return t.numpy().copy()


def _state_out(model) -> dict:
    out = {}
    for n, p in model.named_parameters():
        out[f"param_{n}"] = _whole(p, p)
        out[f"grad_{n}"] = _whole(p.grad, p)
    out.update({f"stat_{n}": b.numpy().copy() for n, b in model.named_buffers()
                if "running" in n})
    return out


def tp_step_case(mesh=None, rows: slice = slice(None)) -> dict:
    """One clipped train step of the DP worker's model over ``rows`` of its
    batch, placed on ``mesh``'s model axis (one process: ``None``)."""
    from rcnn_ocr_tpu_torch.interop.jax_params import shard_model
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_train_params
    from rcnn_ocr_tpu_torch.training import optim
    from rcnn_ocr_tpu_torch.training.train_step import create_train_state, make_train_step
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    cs = Charset.from_tokens(dp.TOKENS)
    model = RCNN(num_classes=len(dp.TOKENS), hidden_size=16, width_mult=0.125,
                 with_ctc_head=True, sos_id=cs.sos_id, eos_id=cs.eos_id, pad_id=cs.pad_id,
                 blank_id=cs.blank_id, enc_dropout_p=0.2, dropblock_p=0.2,
                 dropblock_block_size=3)
    init_train_params(model, torch.Generator().manual_seed(3))
    report = shard_model(model, mesh) if mesh is not None else {}
    tx = optim.build_optimizer("Adam", 1e-3, grad_clip=GRAD_CLIP)
    state = create_train_state(model, tx, device="cpu")
    step = make_train_step(model, tx, dp.MAX_LEN, cs.pad_id, head="both",
                           ctc_blank_id=cs.ctc_blank_id, augment=dp.AUGMENT)
    batch = {k: v[rows] for k, v in dp.step_batch().items() if isinstance(v, np.ndarray)}
    norms = []
    clip = optim.clip_by_global_norm_

    def recorded_clip(params, max_norm):
        norms.append(float(clip(params, max_norm)))
        return norms[-1]

    optim.clip_by_global_norm_ = recorded_clip
    recorder = dp.MaskRecorder()
    try:
        metrics = step(state, batch, torch.Generator().manual_seed(5))
    finally:
        recorder.close()
        optim.clip_by_global_norm_ = clip
    out = {f"metric_{k}": float(v) for k, v in metrics.items()}
    out["clip_factor"] = min(1.0, GRAD_CLIP / norms[0])
    out["tp_report"] = np.array(json.dumps(report, sort_keys=True))
    out["n_local"] = sum(p.numel() for p in model.parameters())
    out.update(_state_out(model))
    out.update({f"mask_{i:03d}": m for i, m in enumerate(recorder.masks)})
    return out


def jax_tp_model():
    """The port's twin of the JAX comparison's model, attention dropout off."""
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    cs = Charset.from_tokens(dp.TOKENS)
    model = RCNN(num_classes=len(dp.TOKENS), hidden_size=JAX_HIDDEN, width_mult=JAX_WIDTH,
                 with_ctc_head=True, sos_id=cs.sos_id, eos_id=cs.eos_id, pad_id=cs.pad_id,
                 blank_id=cs.blank_id, enc_dropout_p=0.0)
    model.attn.dropout_p = 0.0
    return model


def jax_tp_batch() -> dict:
    """8 normalized 32x32 lines with CTC targets, made with numpy."""
    from rcnn_ocr_tpu_torch.data.loader import collate_batch
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    rng = np.random.default_rng(4)
    items = [(rng.normal(size=(32, 32, 3)).astype(np.float32),
              "".join(rng.choice(list("abcdefghij"), size=int(rng.integers(1, 3)))))
             for _ in range(dp.GLOBAL_BATCH)]
    batch = collate_batch(items, Charset.from_tokens(dp.TOKENS), JAX_STEPS, with_ctc=True)
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray) and k != "lengths"}


def jax_tp_case(state_path: str, mesh=None, rows: slice = slice(None)) -> dict:
    """One step of the JAX comparison's model, Adam 1e-3, on its rows."""
    from rcnn_ocr_tpu_torch.interop.jax_params import shard_model
    from rcnn_ocr_tpu_torch.training.optim import build_optimizer
    from rcnn_ocr_tpu_torch.training.train_step import create_train_state, make_train_step
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    cs = Charset.from_tokens(dp.TOKENS)
    model = jax_tp_model()
    model.load_state_dict(torch.load(state_path))
    if mesh is not None:
        shard_model(model, mesh)
    tx = build_optimizer("Adam", 1e-3)
    state = create_train_state(model, tx, device="cpu")
    step = make_train_step(model, tx, JAX_STEPS, cs.pad_id, head="both",
                           ctc_blank_id=cs.ctc_blank_id)
    batch = {k: v[rows] for k, v in jax_tp_batch().items()}
    metrics = step(state, batch, torch.Generator().manual_seed(0))
    return dict({f"metric_{k}": float(v) for k, v in metrics.items()}, **_state_out(model))


def unit_case(mesh, device: str = "cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Each model-axis Function on known values (two model ranks) on
    ``device`` in ``dtype``: the forward's values and the backward's
    gradient on this rank, and a channels-last conv output gathered along
    its channels as the backbone gathers it."""
    from torch import nn

    from rcnn_ocr_tpu_torch.parallel import mesh as pm

    def new(values):
        return torch.tensor(values, device=device, dtype=dtype)

    def host(t):
        return t.detach().float().cpu().numpy()

    r = mesh.model_index
    w = new([1.0, 2.0, 3.0, 4.0])
    out = {}
    # gather: rank r holds [r+1, r+1]; the loss weights the whole by w
    x = new([r + 1.0, r + 1.0]).requires_grad_(True)
    y = pm.gather_from_model(x, 0, mesh)
    (y * w).sum().backward()
    out.update(gather_y=host(y), gather_dx=host(x.grad))
    # gather_param: a parameter holding block r of [1, 2, 3, 4]
    p = nn.Parameter(w[2 * r:2 * r + 2].clone())
    p.tp_shard = pm.TPShard(0, 4, mesh)
    y = pm.gather_param(p)
    (y * w).sum().backward()
    out.update(param_y=host(y), param_dx=host(p.grad))
    # copy: the same x on both ranks, each scales its copy by r + 1
    x = new([1.0, 2.0]).requires_grad_(True)
    (pm.copy_to_model(x, mesh) * (r + 1.0)).sum().backward()
    out.update(copy_dx=host(x.grad))
    # scatter: the same [1, 2, 3, 4] on both ranks, each scales its block
    x = w.clone().requires_grad_(True)
    y = pm.scatter_to_model(x, 0, mesh)
    (y * (r + 1.0)).sum().backward()
    out.update(scatter_y=host(y), scatter_dx=host(x.grad))
    # reduce: rank r holds [r + 1]; the sum is weighted by 5
    x = new([r + 1.0]).requires_grad_(True)
    y = pm.reduce_from_model(x, mesh)
    (y * 5.0).sum().backward()
    out.update(reduce_y=host(y), reduce_dx=host(x.grad))
    # NCHW channels-last [2, 3, 2, 2]: rank r's channels hold 10 * r + c,
    # gathered to 6 channels
    c = torch.arange(3, device=device, dtype=dtype) + 10.0 * r
    x = c[None, :, None, None].expand(2, 3, 2, 2).contiguous(memory_format=torch.channels_last)
    y = pm.gather_from_model(x.permute(0, 2, 3, 1), -1, mesh).permute(0, 3, 1, 2)
    out.update(channels=host(y[0, :, 0, 0]))
    return {f"unit_{k}": v for k, v in out.items()}


def production_traffic(mesh) -> dict:
    """The model axis's buffers in one train step of the shipped model
    (width 1.0, hidden 256, configs/charset.txt, both heads, max_len 40,
    32x128 lines) at batch 2 and 4, and the parameters one rank holds: the
    step's bytes are linear in the batch, so two sizes give them at any."""
    from rcnn_ocr_tpu_torch.data.loader import collate_batch
    from rcnn_ocr_tpu_torch.interop.jax_params import shard_model
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_train_params
    from rcnn_ocr_tpu_torch.parallel.mesh import TP_TRAFFIC
    from rcnn_ocr_tpu_torch.training.optim import build_optimizer
    from rcnn_ocr_tpu_torch.training.train_step import create_train_state, make_train_step
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    cs = Charset.from_file(os.path.join(REPO, "configs", "charset.txt"))
    model = RCNN(num_classes=cs.num_classes, hidden_size=256, width_mult=1.0,
                 with_ctc_head=True, sos_id=cs.sos_id, eos_id=cs.eos_id, pad_id=cs.pad_id,
                 blank_id=cs.blank_id)
    init_train_params(model, torch.Generator().manual_seed(0))
    out = {"params_total": sum(p.numel() for p in model.parameters())}
    out["leaves"] = len(shard_model(model, mesh))
    out["params_rank"] = sum(p.numel() for p in model.parameters())
    tx = build_optimizer("Adam", 5e-4, 2e-5)
    state = create_train_state(model, tx, device="cpu")
    step = make_train_step(model, tx, 40, cs.pad_id, head="both", ctc_blank_id=cs.ctc_blank_id)
    rng = np.random.default_rng(0)
    letters = [c for c in "abcdefghij" if c in cs.stoi]
    for bs in (2, 4):
        items = [(rng.normal(size=(32, 128, 3)).astype(np.float32),
                  "".join(rng.choice(letters, 5))) for _ in range(bs)]
        batch = {k: v for k, v in collate_batch(items, cs, 40, with_ctc=True).items()
                 if isinstance(v, np.ndarray) and k != "lengths"}
        b0, c0 = TP_TRAFFIC["bytes"], TP_TRAFFIC["calls"]
        step(state, batch, torch.Generator().manual_seed(0))
        out[f"bytes_bs{bs}"] = TP_TRAFFIC["bytes"] - b0
        out[f"collectives_bs{bs}"] = TP_TRAFFIC["calls"] - c0
    per_row = (out["bytes_bs4"] - out["bytes_bs2"]) / 2
    out.update(bytes_per_row=per_row, bytes_fixed=out["bytes_bs2"] - 2 * per_row)
    return out


UNITS = {0: dict(gather_y=[1, 1, 2, 2], gather_dx=[1, 2], param_y=[1, 2, 3, 4],
                 param_dx=[1, 2], copy_dx=[3, 3], scatter_y=[1, 2],
                 scatter_dx=[1, 1, 2, 2], reduce_y=[3], reduce_dx=[5],
                 channels=[0, 1, 2, 10, 11, 12]),
         1: dict(gather_y=[1, 1, 2, 2], gather_dx=[3, 4], param_y=[1, 2, 3, 4],
                 param_dx=[3, 4], copy_dx=[3, 3], scatter_y=[3, 4],
                 scatter_dx=[1, 1, 2, 2], reduce_y=[3], reduce_dx=[5],
                 channels=[0, 1, 2, 10, 11, 12])}


def assert_units(out: dict, prefix: str) -> None:
    """A rank's :func:`unit_case` outputs (keys ``prefix + name``) equal the
    known values, exactly: every sum here is of small integers."""
    for k, v in UNITS[int(out["model_index"])].items():
        np.testing.assert_array_equal(out[prefix + k], np.asarray(v, np.float32), err_msg=k)


def main() -> int:
    from rcnn_ocr_tpu_torch.parallel.mesh import init_distributed, make_mesh, process_index

    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("data", type=int)
    ap.add_argument("model", type=int)
    ap.add_argument("--jax", default=None)
    ap.add_argument("--units", action="store_true")
    ap.add_argument("--loop", default=None)
    ap.add_argument("--units-only-on", default=None, metavar="DEVICE",
                    help="run only the units, in fp32 and bf16, on this device (cuda:0)")
    ap.add_argument("--production-traffic", action="store_true",
                    help="print only production_traffic() as JSON (rank 0)")
    args = ap.parse_args()
    init_distributed(backend="gloo", device=args.units_only_on or "cpu", timeout_s=300)
    mesh = make_mesh((args.data, args.model), ("data", "model"))
    out = dict(data_index=mesh.data_index, model_index=mesh.model_index)
    if args.production_traffic:
        traffic = production_traffic(mesh)
        if process_index() == 0:
            print(json.dumps(traffic))
        torch.distributed.destroy_process_group()
        return 0
    if args.units_only_on:
        for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            out.update({f"{name}_{k}": v
                        for k, v in unit_case(mesh, args.units_only_on, dtype).items()})
        np.savez(os.path.join(args.out_dir, f"rank{process_index()}.npz"), **out)
        torch.distributed.destroy_process_group()
        return 0
    rows = dp.rows_of(mesh.data_index, mesh.n_data)
    out.update({f"step_{k}": v for k, v in tp_step_case(mesh, rows).items()})
    if args.jax:
        out.update({f"jax_{k}": v for k, v in jax_tp_case(args.jax, mesh, rows).items()})
    if args.units:
        out.update(unit_case(mesh))
    if args.loop:
        from rcnn_ocr_tpu_torch.training.config import Config
        from rcnn_ocr_tpu_torch.training.train import run_training

        result = run_training(Config(args.loop), device="cpu")
        out["loop_epochs"] = np.array(json.dumps(result["epochs"], default=str))
    np.savez(os.path.join(args.out_dir, f"rank{process_index()}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
