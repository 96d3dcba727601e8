"""JSON training configs with the resume overlay.

Counterpart of ``rcnn_ocr_tpu/training/config.py`` (``Config``,
``DEFAULTS``, ``EXTRA_KNOWN_KEYS``, the unknown-key warning and the resume
overlay), with the same keys and defaults:

* a config is a JSON dict read as attributes (``cfg["key"]`` too);
  :meth:`Config.get` falls back to ``DEFAULTS``;
* without ``exp_dir`` the first free ``expN`` is taken;
* a key known to neither ``DEFAULTS`` nor ``EXTRA_KNOWN_KEYS`` warns once,
  with a did-you-mean;
* resume overlay: with ``resume_path`` (a checkpoint file or an experiment
  directory, whose slots are tried last > best_loss > best_acc), that
  experiment's ``config.json`` is the base, the user's non-``None`` keys
  overlay it, and ``exp_dir`` becomes the resume directory.

``p_EdgeCrop`` and ``edge_crop_limit`` are registered (JAX's config warns
on them though its train transform reads them).  On one card some keys
mean nothing and are only logged by the training loop (``use_pallas``,
``compile_cache_dir``); ``mesh_shape`` over more than one device waits for
a later slice and raises there.  ``export_artifact`` is validated by
:func:`rcnn_ocr_tpu_torch.export.validate_export_request`.
"""

from __future__ import annotations

import difflib
import json
import os
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

RESUME_CKPT_CANDIDATES = [
    "last_ckpt.msgpack", "best_loss_ckpt.msgpack", "best_acc_ckpt.msgpack",
    "last_ckpt.pth", "best_loss_ckpt.pth", "best_acc_ckpt.pth",
]

DEFAULTS: Dict[str, Any] = {
    "encoding": "utf-8",
    "img_h": 64,
    "img_w": 256,
    "max_len": 25,
    "hidden_size": 256,
    "batch_size": 32,
    "epochs": 20,
    "lr": 1e-3,
    "optimizer": "Adam",
    "scheduler": "ReduceLROnPlateau",
    "weight_decay": 0.0,
    "momentum": 0.9,
    "seed": 42,
    "eval_every": 1,
    "val_size": 3000,
    "num_workers": 0,
    "train_proportions": None,
    "resume_path": None,
    "val_csvs": None,
    "val_roots": None,
    "head": "attention",  # "attention" | "ctc" | "both"
    "ctc_loss_weight": 1.0,
    "compute_dtype": "bfloat16",
    "mesh_shape": None,  # one card: None or a shape of one device
    "mesh_axes": ["data"],
    "width_buckets": None,  # a list of widths, or an int K for the automatic DP
    "proportional_quotas": "expected",  # width_buckets x train_proportions: or "batch"
    "grad_accum": 1,
    "grad_clip": 0.0,
    "cache_dir": None,  # disk cache of the deterministic uint8 transforms
    "compile_cache_dir": None,  # JAX's XLA cache: nothing to do on the card
    "label_smoothing": 0.0,
    "ema_decay": 0.0,
    "export_artifact": None,
    "use_pallas": False,  # on the card the kernels are always the path
    "device_augment": False,
    "log_every": 50,
    "progress": True,
    "profile_steps": 0,  # >0: a torch.profiler capture of N steps in the first epoch
    "profile_dir": None,  # default: exp_dir/profile
    "sampling_prob": 0.0,
    "lstm_layers": 2,
    "width_mult": 1.0,
    "enc_dropout_p": 0.1,
    "dropblock_p": 0.0,
    "dropblock_block_size": 5,
    "shift_limit": 0.03,
    "scale_limit": 0.08,
    "rotate_limit": 3,
    "p_ShiftScaleRotate": 0.3,
    "brightness_limit": 0.2,
    "contrast_limit": 0.2,
    "p_BrightnessContrast": 0.3,
    "invert_p": 0.0,
    "p_EdgeCrop": 0.0,  # crop a strip off one edge of the raw image (host path only)
    "edge_crop_limit": 0.35,
}

EXTRA_KNOWN_KEYS = frozenset({
    "exp_dir", "charset_path", "train_csvs", "train_roots",
    "save_every", "async_checkpoint", "graceful_shutdown",
})


def _warn_unknown_keys(keys) -> None:
    """Warn on keys no consumer reads, with a did-you-mean."""
    known = sorted(set(DEFAULTS) | EXTRA_KNOWN_KEYS)
    unknown = [k for k in keys if k not in known]
    if not unknown:
        return
    parts = []
    for k in unknown:
        close = difflib.get_close_matches(k, known, n=1)
        parts.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)" if close else ""))
    warnings.warn("Unknown config key(s) ignored by every consumer: " + ", ".join(parts),
                  stacklevel=3)


class Config:
    """Attribute-bag config loaded from JSON (or a dict) with the resume overlay."""

    def __init__(self, path_or_dict: "str | Dict[str, Any]"):
        if isinstance(path_or_dict, str):
            with open(path_or_dict, "r", encoding="utf-8") as f:
                user_data = json.load(f)
        else:
            user_data = dict(path_or_dict)
        # the user's keys are checked, not the overlay's: an experiment
        # saved by a newer version must still open
        _warn_unknown_keys(user_data.keys())
        for k, v in self._maybe_apply_resume(user_data).items():
            setattr(self, k, v)
        if not getattr(self, "exp_dir", None):
            exp_idx = 1
            while os.path.exists(f"exp{exp_idx}"):
                exp_idx += 1
            self.exp_dir = f"exp{exp_idx}"

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        """A hyperparameter, falling back to ``DEFAULTS``, then ``default``."""
        if hasattr(self, key):
            return getattr(self, key)
        if key in DEFAULTS:
            return DEFAULTS[key]
        return default

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def save(self, out_path: Optional[str] = None) -> None:
        if out_path is None:
            out_path = os.path.join(self.exp_dir, "config.json")
        parent = os.path.dirname(out_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(self.__dict__, f, indent=4, ensure_ascii=False)

    @staticmethod
    def _maybe_apply_resume(user_data: Dict[str, Any]) -> Dict[str, Any]:
        resume_path = user_data.get("resume_path")
        if not resume_path:
            return dict(user_data)
        resume = Path(resume_path).expanduser().resolve()
        if not resume.exists():
            raise FileNotFoundError(f"Resume path not found: {resume}")
        if resume.is_dir():
            resume_dir = resume
            resume_ckpt = next((resume_dir / n for n in RESUME_CKPT_CANDIDATES
                                if (resume_dir / n).is_file()), None)
            if resume_ckpt is None:
                raise FileNotFoundError(
                    f"No checkpoint among {RESUME_CKPT_CANDIDATES} in {resume_dir}")
        else:
            resume_ckpt = resume
            resume_dir = resume_ckpt.parent
        resume_config: Dict[str, Any] = {}
        resume_config_path = resume_dir / "config.json"
        if resume_config_path.is_file():
            try:
                with open(resume_config_path, "r", encoding="utf-8") as f:
                    resume_config = json.load(f)
            except (OSError, ValueError) as e:
                print(f"[Config] Could not read resume config {resume_config_path}: {e}")
        else:
            print("[Config] Resume dir has no config.json; using current config")
        merged = dict(resume_config)
        merged.update({k: v for k, v in user_data.items() if v is not None})
        merged["resume_path"] = str(resume_ckpt)
        merged["exp_dir"] = str(resume_dir)
        return merged
