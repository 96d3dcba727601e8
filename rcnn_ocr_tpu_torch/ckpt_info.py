"""Describe a checkpoint without building a model.

The port's copy of the JAX package's ``tools/ckpt_info.py``, with the same
arguments, text, ``--json`` object and exit codes; it needs neither flax
nor JAX.  It decodes the msgpack blob only (no model, no device work):

    python -m rcnn_ocr_tpu_torch.ckpt_info exp1/best_acc_ckpt.msgpack
    python -m rcnn_ocr_tpu_torch.ckpt_info exp1/last_weights.msgpack --json

Works on full checkpoints (training state + embedded charset + config),
bare weights and version-less legacy blobs.  A blob of a newer format is
still described (``readable: false``).  Exit codes: 0 readable, 1
missing/corrupt, 2 newer than :data:`CHECKPOINT_FORMAT_VERSION` (refuse
before a deploy mis-reads it).  The dtype histogram counts each array by
its stored dtype: bfloat16 arrays as ``bfloat16``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np

from rcnn_ocr_tpu_torch.training.msgpack_codec import (
    CHECKPOINT_FORMAT_VERSION,
    BFloat16Array,
    msgpack_restore,
)


def _tree_stats(tree) -> dict:
    """Leaf count / parameter count / bytes / dtype histogram."""
    n_leaves = 0
    n_params = 0
    n_bytes = 0
    dtypes: dict = {}
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
            continue
        if isinstance(node, BFloat16Array):
            size, nbytes, key = node.size, node.nbytes, node.dtype_name
        else:
            arr = np.asarray(node)
            size, nbytes, key = int(arr.size), int(arr.nbytes), str(arr.dtype)
        n_leaves += 1
        n_params += size
        n_bytes += nbytes
        dtypes[key] = dtypes.get(key, 0) + size
    return {
        "leaves": n_leaves,
        "params": n_params,
        "bytes": n_bytes,
        "dtypes": dtypes,
    }


def ckpt_info(path: str) -> dict:
    with open(path, "rb") as f:
        blob = msgpack_restore(f.read(), keep_bfloat16=True)
    if not isinstance(blob, dict) or "params" not in blob:
        raise ValueError("not a checkpoint blob (no params tree)")
    version = int(blob.get("format_version", 1))
    full = "epoch" in blob
    info = {
        "path": path,
        "format_version": version,
        "version_less_legacy": "format_version" not in blob,
        "readable": version <= CHECKPOINT_FORMAT_VERSION,
        "kind": "full_checkpoint" if full else "weights",
        "has_batch_stats": bool(blob.get("batch_stats")),
        "has_ema_params": "ema_params" in blob,
        "has_quant_calibration": bool(blob.get("quant_stats")),
        "params": _tree_stats(blob["params"]),
    }
    if full:
        info.update(
            epoch=int(blob["epoch"]),
            global_step=int(blob["global_step"]),
            best_val_loss=float(blob["best_val_loss"]),
            best_val_acc=float(blob["best_val_acc"]),
            charset_size=len(blob.get("itos") or []),
        )
        cfg = blob.get("config") or {}
        info["config"] = {
            k: cfg[k]
            for k in (
                "img_h", "img_w", "hidden_size", "head", "max_length",
                "batch_size", "width_mult",
            )
            if k in cfg
        }
    return info


def _print_text(info: dict) -> None:
    print(f"checkpoint:      {info['path']}")
    notes = []
    if info["version_less_legacy"]:
        notes.append("version-less legacy")
    if not info["readable"]:
        notes.append("NEWER than this tree — refuse")
    note = f"  ({'; '.join(notes)})" if notes else ""
    print(f"format_version:  {info['format_version']}{note}")
    print(f"kind:            {info['kind']}")
    if info["kind"] == "full_checkpoint":
        print(
            f"progress:        epoch {info['epoch']}, "
            f"step {info['global_step']}, "
            f"best val_loss {info['best_val_loss']:.4f}, "
            f"best acc {info['best_val_acc']:.4f}"
        )
        print(f"charset:         {info['charset_size']} tokens (embedded)")
        if info["config"]:
            cfg = ", ".join(f"{k}={v}" for k, v in info["config"].items())
            print(f"config:          {cfg}")
    ps = info["params"]
    mb = ps["bytes"] / (1024 * 1024)
    dt = ", ".join(f"{k}:{v:,}" for k, v in sorted(ps["dtypes"].items()))
    print(
        f"params:          {ps['params']:,} in {ps['leaves']} arrays, "
        f"{mb:.1f} MB  ({dt})"
    )
    extras = [
        name
        for flag, name in (
            (info["has_batch_stats"], "batch_stats"),
            (info["has_ema_params"], "ema_params"),
            (info["has_quant_calibration"], "int8 calibration"),
        )
        if flag
    ]
    print(f"carries:         {', '.join(extras) if extras else '(params only)'}")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help=".msgpack checkpoint or weights file")
    p.add_argument("--json", action="store_true", help="one JSON object")
    args = p.parse_args(argv)
    try:
        info = ckpt_info(args.checkpoint)
    except FileNotFoundError:
        print(f"no such file: {args.checkpoint}")
        return 1
    except ValueError as e:
        # a NEWER-format blob raises from load paths too — classify here
        if "format" in str(e) and "newer" in str(e):
            print(str(e))
            return 2
        print(f"unreadable checkpoint: {e}")
        return 1
    except Exception as e:  # noqa: BLE001 - any decode failure is "unreadable"
        print(f"unreadable checkpoint: {e}")
        return 1

    if args.json:
        print(json.dumps(info))
    else:
        _print_text(info)
    return 0 if info["readable"] else 2


if __name__ == "__main__":
    sys.exit(main())
