"""Average N checkpoints into one deployable weights file (SWA-style).

The port's copy of the JAX package's ``tools/average_checkpoints.py``, with
the same arguments, rules, messages and output bytes; it needs neither flax
nor JAX:

    python -m rcnn_ocr_tpu_torch.average_checkpoints \\
        --out exp1/avg_weights.msgpack \\
        exp1/best_acc_ckpt.msgpack exp1/best_loss_ckpt.msgpack \\
        exp1/last_ckpt.msgpack [--weights 0.5,0.3,0.2]

Rules:

* ``params`` and ``batch_stats`` are averaged leaf-wise in float64 and cast
  back to the first input's dtype of each leaf (a bfloat16 leaf rounds as
  numpy's cast to ``ml_dtypes``' bfloat16 does: :meth:`BFloat16Array.from_float64`);
* EMA checkpoints contribute their EMA tree (the deploy weights); an empty
  one falls back to ``params``;
* ``batch_stats`` are renormalized over the mixing weight of the inputs
  that carry them;
* ``quant_stats`` calibration is NOT averaged — scales are model-specific;
  re-run ``calibrate()`` on the averaged model;
* charset/config metadata is copied from the FIRST input (all inputs must
  agree on the architecture — mismatched trees fail loudly).

The output is a bare-weights msgpack (+ embedded charset/config when the
first input carries them), written atomically, loadable by ``OCRInference``
and by ``load_variables`` in either package.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from rcnn_ocr_tpu_torch.training.msgpack_codec import (
    CHECKPOINT_FORMAT_VERSION,
    BFloat16Array,
    _atomic_write,
    load_checkpoint_blob,
)


def _tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _float64(leaf) -> np.ndarray:
    if isinstance(leaf, BFloat16Array):
        return leaf.to_float32().astype(np.float64)
    return np.asarray(leaf, np.float64)


def _tree_axpy(acc, tree, w):
    """acc += w * tree, leaf-wise, building acc on first call."""
    out = {}
    for k in tree:
        v = tree[k]
        if isinstance(v, dict):
            out[k] = _tree_axpy(acc.get(k, {}) if acc else {}, v, w)
        else:
            base = acc.get(k) if acc else None
            contrib = _float64(v) * w
            out[k] = contrib if base is None else base + contrib
    return out


def _finalize(tree, ref):
    out = {}
    for k in tree:
        if isinstance(tree[k], dict):
            out[k] = _finalize(tree[k], ref[k])
        elif isinstance(ref[k], BFloat16Array):
            out[k] = BFloat16Array.from_float64(tree[k])
        else:
            out[k] = tree[k].astype(np.asarray(ref[k]).dtype)
    return out


def average_variables(blobs, weights):
    """Leaf-wise weighted average of checkpoint blobs' model variables."""
    first_tree = None
    stats_ref = stats_sig = None
    acc_p = acc_b = None
    stats_mass = 0.0  # weight actually contributed to batch_stats
    for blob, w in zip(blobs, weights):
        # EMA checkpoints deploy the EMA tree (matches save_weights)
        params = blob.get("ema_params") or blob["params"]
        stats = blob.get("batch_stats", {})
        sig = [p for p, _ in _tree_paths(params)]
        if first_tree is None:
            first_tree = (sig, params)
        elif sig != first_tree[0]:
            raise ValueError(
                "checkpoint parameter trees differ — all inputs must share "
                "one architecture"
            )
        acc_p = _tree_axpy(acc_p, params, w)
        if stats:
            cur_sig = [p for p, _ in _tree_paths(stats)]
            if stats_ref is None:
                stats_ref, stats_sig = stats, cur_sig
            elif cur_sig != stats_sig:
                raise ValueError(
                    "checkpoint batch_stats trees differ — all inputs must "
                    "share one architecture"
                )
            acc_b = _tree_axpy(acc_b, stats, w)
            stats_mass += w
    out = {"params": _finalize(acc_p, first_tree[1])}
    if acc_b:
        # stats-less inputs contribute no mass: renormalize by the weight
        # that actually accumulated, else BN moments scale by stats_mass
        if stats_mass < 1.0 - 1e-9:
            print(
                f"note: {stats_mass:.4f} of the mixing weight carries "
                "batch_stats; BN moments renormalized over that mass"
            )
            acc_b = _tree_axpy(None, acc_b, 1.0 / stats_mass)
        out["batch_stats"] = _finalize(acc_b, stats_ref)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpts", nargs="+", help="2+ checkpoint/weights msgpack files")
    ap.add_argument("--out", required=True, help="output weights msgpack")
    ap.add_argument(
        "--weights", default=None,
        help="comma-separated mixing weights (default: uniform); normalized",
    )
    args = ap.parse_args(argv)
    if len(args.ckpts) < 2:
        ap.error("need at least two checkpoints to average")

    if args.weights:
        w = np.asarray([float(v) for v in args.weights.split(",")], np.float64)
        if len(w) != len(args.ckpts):
            ap.error(f"{len(w)} weights for {len(args.ckpts)} checkpoints")
        if w.sum() <= 0:
            ap.error("mixing weights must sum to a positive value")
    else:
        w = np.ones(len(args.ckpts), np.float64)
    w = w / w.sum()

    blobs = [load_checkpoint_blob(p, keep_bfloat16=True) for p in args.ckpts]
    for p, b in zip(args.ckpts, blobs):
        if "params" not in b:
            raise SystemExit(f"{p} holds no model parameters")
        if "quant_stats" in b:
            print(f"note: {p} carries int8 calibration; NOT averaged — "
                  "re-run calibrate() on the result")

    out_blob = average_variables(blobs, w)
    out_blob["format_version"] = CHECKPOINT_FORMAT_VERSION
    # carry charset/config provenance from the first input so the averaged
    # file is as self-describing as a training slot
    for key in ("itos", "stoi", "config"):
        if key in blobs[0]:
            out_blob[key] = blobs[0][key]

    _atomic_write(args.out, out_blob)
    n_leaves = sum(1 for _ in _tree_paths(out_blob["params"]))
    print(
        f"averaged {len(blobs)} checkpoints (weights {np.round(w, 4).tolist()}) "
        f"-> {args.out} ({n_leaves} param tensors)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
