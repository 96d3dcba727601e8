"""One rank of a data-parallel check of the port, or the one-process reference.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        tests/torch_port_dp_worker.py OUT_DIR [JAX_SETUP_STATE]

Each rank joins a gloo group on the CPU (every collective bounded by a
timeout) and writes ``OUT_DIR/rank<R>.npz`` with:

* ``step``: one ``make_train_step(head="both")`` of a small model (width
  0.125, hidden 16, 32x64 lines) with encoder and attention dropout,
  DropBlock and ``device_augment`` on, over its rows of an 8-row batch made
  from a numpy seed: the losses, the gradients, the parameters and batch
  statistics after the step, and every mask drawn (dropout, DropBlock, the augmented images);
* ``jax``: with ``JAX_SETUP_STATE`` (a ``torch.save``d state dict of the
  JAX package's ``test_dp_train_step_matches_single_device`` model), one
  attention step of that model with dropout off on its rows of that test's
  batch: loss, gradients, parameters and statistics;
* ``metric_sum``: ``global_metric_sum`` of a vector that depends on the rank.

The test imports :func:`step_case` / :func:`jax_case` to run the same
functions in one process without a group.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
GLOBAL_BATCH, MAX_LEN = 8, 6
AUGMENT = {"p_ShiftScaleRotate": 0.7, "shift_limit": 0.05, "scale_limit": 0.1,
           "rotate_limit": 5, "p_BrightnessContrast": 0.7, "brightness_limit": 0.3,
           "contrast_limit": 0.3, "invert_p": 0.3}
# tests/test_parallel.py:test_dp_train_step_matches_single_device
JAX_CLASSES, JAX_HIDDEN, JAX_WIDTH, JAX_STEPS = 8, 16, 0.0625, 3


def rows_of(rank: int, count: int) -> slice:
    b = GLOBAL_BATCH // count
    return slice(rank * b, (rank + 1) * b)


def step_batch():
    """The 8-row uint8 batch (device augmentation takes uint8), made with numpy."""
    from rcnn_ocr_tpu_torch.data.loader import collate_batch
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    rng = np.random.default_rng(11)
    items = [(rng.integers(0, 256, size=(32, 64, 3), dtype=np.uint8),
              "".join(rng.choice(list("abcdefghij"), size=int(rng.integers(2, 6)))))
             for _ in range(GLOBAL_BATCH)]
    return collate_batch(items, Charset.from_tokens(TOKENS), MAX_LEN, with_ctc=True)


class MaskRecorder:
    """Wraps the draw sites the train step reaches and records each mask
    (dropout, DropBlock: the zero pattern of the output; device
    augmentation: the augmented images)."""

    def __init__(self):
        from rcnn_ocr_tpu_torch.models import attention, rcnn, seresnet31
        from rcnn_ocr_tpu_torch.ops import augment

        self.masks = []
        self._undo = []
        for mod, name in ((rcnn, "dropout"), (attention, "dropout"),
                          (seresnet31, "dropblock_2d"), (augment, "device_train_augment")):
            orig = getattr(mod, name)
            keep_values = name == "device_train_augment"
            setattr(mod, name, self._wrap(orig, keep_values))
            self._undo.append((mod, name, orig))

    def _wrap(self, fn, keep_values: bool):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            if keep_values or out is not args[0]:  # DropBlock returns x when it is off
                self.masks.append((out if keep_values else out != 0).detach().float().numpy())
            return out

        return recorded

    def close(self):
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)


def step_case(rows: slice):
    """One train step over ``rows`` of the batch; returns what the npz holds."""
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_train_params
    from rcnn_ocr_tpu_torch.training.optim import build_optimizer
    from rcnn_ocr_tpu_torch.training.train_step import create_train_state, make_train_step
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    cs = Charset.from_tokens(TOKENS)
    model = RCNN(num_classes=len(TOKENS), hidden_size=16, width_mult=0.125, with_ctc_head=True,
                 sos_id=cs.sos_id, eos_id=cs.eos_id, pad_id=cs.pad_id, blank_id=cs.blank_id,
                 enc_dropout_p=0.2, dropblock_p=0.2, dropblock_block_size=3)
    init_train_params(model, torch.Generator().manual_seed(3))
    tx = build_optimizer("Adam", 1e-3)  # JAX's test_parallel.py step: Adam 1e-3, no decay
    state = create_train_state(model, tx, device="cpu")
    step = make_train_step(model, tx, MAX_LEN, cs.pad_id, head="both",
                           ctc_blank_id=cs.ctc_blank_id, augment=AUGMENT)
    batch = {k: v[rows] for k, v in step_batch().items() if isinstance(v, np.ndarray)}
    recorder = MaskRecorder()
    try:
        metrics = step(state, batch, torch.Generator().manual_seed(5))
    finally:
        recorder.close()
    out = {f"metric_{k}": float(v) for k, v in metrics.items()}
    for n, p in model.named_parameters():
        out[f"param_{n}"] = p.detach().numpy().copy()
        out[f"grad_{n}"] = p.grad.numpy().copy()  # under a group: the summed gradient
    out.update({f"stat_{n}": b.numpy().copy() for n, b in model.named_buffers()
                if "running" in n})
    out.update({f"mask_{i:03d}": m for i, m in enumerate(recorder.masks)})
    return out


def jax_batch():
    """``test_dp_train_step_matches_single_device``'s batch."""
    return {
        "image": np.random.default_rng(0).normal(size=(8, 32, 32, 3)).astype(np.float32),
        "text_in": np.tile(np.array([[1, 3, 4, 0]], np.int32), (8, 1)),
        "target_y": np.tile(np.array([[3, 4, 2, 0]], np.int32), (8, 1)),
        "valid": np.ones((8,), np.bool_),
    }


def jax_model():
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN

    model = RCNN(num_classes=JAX_CLASSES, hidden_size=JAX_HIDDEN, width_mult=JAX_WIDTH,
                 enc_dropout_p=0.0)
    model.attn.dropout_p = 0.0  # the two packages draw differently
    return model


def jax_case(state_path: str, rows: slice):
    """One attention step, Adam 1e-3, of the JAX test's model on its rows."""
    from rcnn_ocr_tpu_torch.training.optim import build_optimizer
    from rcnn_ocr_tpu_torch.training.train_step import create_train_state, make_train_step

    model = jax_model()
    model.load_state_dict(torch.load(state_path))
    tx = build_optimizer("Adam", 1e-3)
    state = create_train_state(model, tx, device="cpu")
    step = make_train_step(model, tx, JAX_STEPS, 0, head="attention")
    batch = {k: v[rows] for k, v in jax_batch().items()}
    metrics = step(state, batch, torch.Generator().manual_seed(0))
    out = {"metric_loss": float(metrics["loss"])}
    for n, p in model.named_parameters():
        out[f"param_{n}"] = p.detach().numpy().copy()
        out[f"grad_{n}"] = p.grad.numpy().copy()
    out.update({f"stat_{n}": b.numpy().copy() for n, b in model.named_buffers()
                if "running" in n})
    return out


def main() -> int:
    from rcnn_ocr_tpu_torch.parallel.mesh import (
        global_metric_sum,
        init_distributed,
        process_count,
        process_index,
    )

    out_dir = sys.argv[1]
    init_distributed(backend="gloo", device="cpu", timeout_s=120)
    rank, count = process_index(), process_count()
    out = {f"step_{k}": v for k, v in step_case(rows_of(rank, count)).items()}
    if len(sys.argv) > 2:
        out.update({f"jax_{k}": v for k, v in jax_case(sys.argv[2], rows_of(rank, count)).items()})
    out["metric_sum"] = global_metric_sum([1.0, rank + 0.5, 2.0 ** -40 * (rank + 1)])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
