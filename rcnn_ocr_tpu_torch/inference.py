"""Batched OCR inference: checkpoint in, strings out.

Counterpart of ``rcnn_ocr_tpu/inference.py:OCRInference`` for greedy
decoding: ``predict`` (attention head) and ``predict_ctc`` (CTC head).
Images are resize-padded to uint8 on the host, stacked into batches padded
to a static size, normalized on the device by lookup and decoded there;
token rows come back to the host and become strings.

The engine runs on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU it raises.  Beam search, LM fusion, image
files and PIL inputs, ``"auto:K"`` width buckets, int8, long lines and
multi-card serving arrive in later slices of the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad, load_rgb_uint8
from rcnn_ocr_tpu_torch.interop.jax_params import load_jax_variables
from rcnn_ocr_tpu_torch.models.rcnn import RCNN
from rcnn_ocr_tpu_torch.ops.augment import device_normalize
from rcnn_ocr_tpu_torch.ops.ctc import ctc_greedy_decode, ids_to_text
from rcnn_ocr_tpu_torch.postprocess import (
    chunk_indices,
    ctc_skip_ids,
    decode_attention_row,
    pad_rows,
)
from rcnn_ocr_tpu_torch.training.checkpoint import load_variables
from rcnn_ocr_tpu_torch.vocab.charset import Charset

_BEAM_LATER = "beam search arrives with the beam slice of the PyTorch port"


def infer_architecture(params: Dict[str, Any]) -> Dict[str, Any]:
    """Model hyperparameters from a JAX parameter tree (any checkpoint
    layout): hidden size and LSTM depth from the encoder BiLSTMs, the CNN
    width multiplier from the widest stage, heads from their presence."""
    arch: Dict[str, Any] = {}
    rnn_names = sorted(k for k in params if k.startswith("enc_rnn"))
    if rnn_names:
        arch["lstm_layers"] = len(rnn_names)
        arch["hidden_size"] = int(np.asarray(params[rnn_names[0]]["w_hh"]).shape[1])
    if "cnn" in params:
        l3 = params["cnn"]["layer3_block0"]["conv1"]["conv"]["kernel"]
        arch["width_mult"] = float(np.asarray(l3).shape[-1]) / 512.0
    if "attn" in params:
        arch["num_classes"] = int(np.asarray(params["attn"]["b_gen"]).shape[0])
    elif "ctc_proj" in params:
        arch["num_classes"] = int(np.asarray(params["ctc_proj"]["bias"]).shape[0])
    arch["with_attention_head"] = "attn" in params
    arch["with_ctc_head"] = "ctc_proj" in params
    return arch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``"cuda"`` / ``"auto"`` -> the card (raises without one); ``"cpu"`` only
    when asked for by name."""
    dev = torch.device("cuda" if str(device) == "auto" else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def scaled_width(h: int, w: int, img_h: int) -> int:
    """Width of an (h, w) image after height-normalizing to ``img_h``."""
    return max(1, int(round(w * (img_h / max(h, 1)))))


def bucket_for_width(width: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= width (the largest bucket when none fits)."""
    for b in sorted(buckets):
        if width <= b:
            return int(b)
    return int(max(buckets))


class OCRInference:
    """Load a checkpoint (path or JAX variable tree) and recognize text lines."""

    def __init__(
        self,
        model_path_or_variables: Union[str, Dict[str, Any]],
        charset_path: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
        img_h: Optional[int] = None,
        img_w: Optional[int] = None,
        hidden_size: Optional[int] = None,
        dtype: torch.dtype = torch.bfloat16,
        width_buckets: Optional[Sequence[int]] = None,
        with_ctc_head: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        if isinstance(width_buckets, str):
            raise NotImplementedError(
                "automatic width buckets ('auto:K') arrive with the serving slice "
                "of the PyTorch port; pass a list of widths"
            )
        self.width_buckets = sorted(int(w) for w in width_buckets) if width_buckets else None
        self.dtype = dtype

        if isinstance(model_path_or_variables, str):
            variables, blob = load_variables(model_path_or_variables)
        else:
            blob = dict(model_path_or_variables)
            variables = {"params": blob["params"], "batch_stats": blob.get("batch_stats", {})}
        ckpt_cfg = blob.get("config") or {}
        self.img_h = int(img_h if img_h is not None else ckpt_cfg.get("img_h", 64))
        self.img_w = int(img_w if img_w is not None else ckpt_cfg.get("img_w", 256))

        if charset_path is not None:
            self.charset = Charset.from_file(charset_path)
        elif blob.get("itos"):
            self.charset = Charset.from_tokens(blob["itos"])
        else:
            raise ValueError("charset_path required (checkpoint has no embedded charset)")

        arch = infer_architecture(variables["params"])
        if hidden_size is None:
            hidden_size = ckpt_cfg.get("hidden_size") or arch.get("hidden_size") or 256
        if with_ctc_head is None:
            with_ctc_head = arch.get("with_ctc_head", False)
        cs = self.charset
        self.model = RCNN(
            num_classes=cs.num_classes,
            hidden_size=int(hidden_size),
            sos_id=cs.sos_id,
            eos_id=cs.eos_id,
            pad_id=cs.pad_id,
            blank_id=cs.blank_id,
            with_attention_head=arch.get("with_attention_head", True),
            with_ctc_head=with_ctc_head,
            lstm_layers=arch.get("lstm_layers", 2),
            width_mult=arch.get("width_mult", 1.0),
            dtype=dtype,
        )
        load_jax_variables(self.model, variables)
        self.model.eval().to(self.device)
        self._itos = list(cs.itos)
        self.transform = ResizeAndPad(img_h=self.img_h, img_w=self.img_w)
        self._bucket_transforms = (
            {w: ResizeAndPad(img_h=self.img_h, img_w=w) for w in self.width_buckets}
            if self.width_buckets else None
        )

    # -- batching ----------------------------------------------------------
    def _preprocess(self, image, width: Optional[int]) -> np.ndarray:
        rgb = load_rgb_uint8(image)
        if width is not None:
            return self._bucket_transforms[width](rgb)
        return self.transform(rgb)

    def _bucket_chunks(self, images: List[Any], batch_size: int) -> List[Tuple[Optional[int], List[int]]]:
        groups: Dict[Optional[int], List[int]] = {}
        for i, img in enumerate(images):
            bucket = None
            if self.width_buckets:
                h, w = (img if isinstance(img, np.ndarray) else load_rgb_uint8(img)).shape[:2]
                bucket = bucket_for_width(scaled_width(h, w, self.img_h), self.width_buckets)
            groups.setdefault(bucket, []).append(i)
        return chunk_indices(groups, batch_size)

    def _batches(self, images: List[Any], batch_size: int):
        """(chunk indices, real rows, normalized device batch) per static batch."""
        for bucket, chunk in self._bucket_chunks(images, batch_size):
            arrays, n_real = pad_rows([self._preprocess(images[j], bucket) for j in chunk],
                                      batch_size)
            batch = torch.from_numpy(np.stack(arrays)).to(self.device, non_blocking=True)
            yield chunk, n_real, device_normalize(batch)

    # -- public API --------------------------------------------------------
    @torch.inference_mode()
    def predict(self, images, max_length: int = 25, batch_size: int = 32,
                return_confidence: bool = False, beam_width: Optional[int] = None,
                lm_weight: float = 0.0):
        """Attention greedy decode -> text (or (text, confidence)) per image."""
        if beam_width is not None or lm_weight:
            raise NotImplementedError(_BEAM_LATER)
        if not self.model.with_attention_head:
            raise ValueError("this checkpoint has no attention head; use predict_ctc()")
        is_single = not isinstance(images, list)
        images_list = [images] if is_single else list(images)
        if not images_list:
            return []
        cs = self.charset
        results: List[Any] = [None] * len(images_list)
        for chunk, n_real, x in self._batches(images_list, batch_size):
            logits = self.model(x, batch_max_length=max_length)
            pred = torch.argmax(logits, dim=-1)[:n_real].cpu().numpy()
            maxp = torch.softmax(logits, dim=-1).amax(dim=-1)[:n_real].cpu().numpy()
            for j, out_idx in enumerate(chunk):
                results[out_idx] = decode_attention_row(
                    pred[j], maxp[j], self._itos, pad_id=cs.pad_id, eos_id=cs.eos_id,
                    blank_id=cs.blank_id, return_confidence=return_confidence,
                )
        return results[0] if is_single else results

    @torch.inference_mode()
    def predict_ctc(self, images, batch_size: int = 32, method: str = "greedy",
                    return_confidence: bool = False, beam_width: Optional[int] = None,
                    lm_weight: float = 0.0):
        """CTC greedy decode -> text (or (text, confidence)) per image."""
        if method == "beam" or beam_width is not None or lm_weight:
            raise NotImplementedError(_BEAM_LATER)
        if method != "greedy":
            raise ValueError(f"Unsupported decode method: {method}")
        if not self.model.with_ctc_head:
            raise ValueError("this checkpoint has no CTC head")
        is_single = not isinstance(images, list)
        images_list = [images] if is_single else list(images)
        if not images_list:
            return []
        cs = self.charset
        skip = ctc_skip_ids(cs.pad_id, cs.sos_id, cs.eos_id, cs.ctc_blank_id)
        results: List[Any] = [None] * len(images_list)
        for chunk, n_real, x in self._batches(images_list, batch_size):
            out = ctc_greedy_decode(self.model.ctc_logits(x), cs.ctc_blank_id,
                                    return_confidence=return_confidence)
            tokens, valid = out[0].cpu().numpy(), out[1].cpu().numpy()
            rows = [tokens[b, : valid[b]].tolist() for b in range(n_real)]
            texts = ids_to_text(rows, self._itos, skip_ids=skip)
            confs = out[2][:n_real].cpu().numpy() if return_confidence else None
            for j, out_idx in enumerate(chunk):
                results[out_idx] = (texts[j], float(confs[j])) if return_confidence else texts[j]
        return results[0] if is_single else results
