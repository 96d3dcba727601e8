"""Batched OCR inference: checkpoint in, strings out.

Counterpart of ``rcnn_ocr_tpu/inference.py:OCRInference``: ``predict``
(attention head: greedy, or beam search with an optional length penalty
and bigram LM fusion) and ``predict_ctc`` (CTC head: greedy, or the prefix
beam on the device or on the host, with fusion on the device beam).
Images are resize-padded to uint8 on the host, stacked into batches padded
to a static size, normalized on the device by lookup and decoded there;
token rows come back to the host and become strings.  The serving path
(``predict_serving``, resize-pad on the device) and the long-line decodes
(``predict_long``, ``predict_ctc_long``, ``predict_hybrid_long``) are mixed
in from :mod:`rcnn_ocr_tpu_torch.serving_engine` and
:mod:`rcnn_ocr_tpu_torch.long_lines`.

Every path decodes through the engine's kernels (``_greedy_fn``,
``_greedy_align_fn``, ``_attn_beam_fn``, ``_attn_beam_align_fn``,
``_ctc_frame_ids_fn``, ``_ctc_fn``, ``_ctc_beam_device_fn``): each returns a
function of one device batch, uint8 or already normalized, that normalizes
it and runs the model.  The weights live in the module, so unlike JAX's
jitted kernels they take no ``variables`` argument.

The engine runs on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU it raises.  Checkpoints are the JAX
package's msgpack files, a JAX variable tree, or the reference's ``.pth``
layouts (:mod:`rcnn_ocr_tpu_torch.interop.torch_import`).  Inputs are
arrays, paths to PNG/BMP/JPEG files or PIL-like images (anything with
``.convert("RGB")``; PIL itself is never imported).  Width buckets are a
list of widths or ``"auto:K"`` (K widths fitted to the first multi-image
call).

``quantize=True`` runs the backbone's wide convs in int8
(:mod:`rcnn_ocr_tpu_torch.ops.quant`) on every decode path: with dynamic
activation scales, or static ones when the checkpoint carries calibrated
``quant_stats`` or after :meth:`calibrate` (:mod:`rcnn_ocr_tpu_torch.calibration`).
:mod:`rcnn_ocr_tpu_torch.export` writes any decode configuration of the
engine as a serving artifact.

``mesh=`` serves data-parallel, as JAX's ``mesh=`` does: ``True`` replicates
the model (and the LM table) on every visible card, and a sequence of
devices on each one named (``["cuda:0", "cuda:1"]``; ``["cpu"] * 8`` on the
CPU), one replica per entry.  Every path rounds its batch up to tile the
replicas (:meth:`_round_batch`) and decodes it through :meth:`_call`: each
replica takes its contiguous block of rows to its device and runs it in its
own thread and stream (:class:`rcnn_ocr_tpu_torch.parallel.mesh.ReplicaSet`),
and the host gathers the outputs in row order.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rcnn_ocr_tpu_torch.calibration import CalibrationMixin
from rcnn_ocr_tpu_torch.data.image_io import image_size
from rcnn_ocr_tpu_torch.data.loader import bucket_for_width, optimal_width_buckets, scaled_width
from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad, load_rgb_uint8
from rcnn_ocr_tpu_torch.interop.jax_params import load_jax_variables, to_jax_variables
from rcnn_ocr_tpu_torch.interop.torch_import import import_torch_checkpoint
from rcnn_ocr_tpu_torch.lm import load_lm
from rcnn_ocr_tpu_torch.long_lines import LongLineMixin
from rcnn_ocr_tpu_torch.models.rcnn import RCNN
from rcnn_ocr_tpu_torch.ops.augment import device_normalize
from rcnn_ocr_tpu_torch.parallel.mesh import ReplicaSet, gather_rows, serving_devices, to_host
from rcnn_ocr_tpu_torch.ops.ctc import (
    ctc_beam_from_logits,
    ctc_beam_search,
    ctc_greedy_decode,
    ctc_top_frames,
    ids_to_text,
)
from rcnn_ocr_tpu_torch.postprocess import (
    chunk_indices,
    ctc_skip_ids,
    decode_attention_row,
    decode_beam_row,
    decode_ctc_batch,
    pad_rows,
)
from rcnn_ocr_tpu_torch.serving_engine import ServingEngineMixin
from rcnn_ocr_tpu_torch.training.checkpoint import load_variables
from rcnn_ocr_tpu_torch.vocab.charset import Charset


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


class OCRInference(ServingEngineMixin, LongLineMixin, CalibrationMixin):
    """Load a checkpoint (path or JAX variable tree) and recognize text lines.

    ``lm`` is a bigram table for beam shallow fusion: a ``[V, V]`` array or
    an ``.npz`` written by :func:`rcnn_ocr_tpu_torch.lm.save_lm` (or the JAX
    package's ``tools/train_lm.py``), whose token order must be the
    charset's.  ``mesh`` serves across several devices (see the module
    docstring; :func:`rcnn_ocr_tpu_torch.parallel.mesh.serving_devices`).
    """

    def __init__(
        self,
        model_path_or_variables: Union[str, Dict[str, Any]],
        charset_path: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
        img_h: Optional[int] = None,
        img_w: Optional[int] = None,
        hidden_size: Optional[int] = None,
        dtype: torch.dtype = torch.bfloat16,
        width_buckets: Optional[Union[Sequence[int], str]] = None,
        with_ctc_head: Optional[bool] = None,
        lm: Any = None,
        quantize: bool = False,
        mesh: Any = None,
    ):
        self.device = resolve_device(device)
        # the replicas' devices (None: no mesh); the first is the engine's device
        self._mesh = serving_devices(mesh, self.device)
        if self._mesh is not None:
            self.device = self._mesh[0]
        self._replicas = ReplicaSet(self._mesh or [self.device], mesh=self._mesh is not None)
        # "auto" / "auto:K": the first call with two or more images fits K
        # waste-minimizing widths to them (fixed for the engine's lifetime)
        self._auto_bucket_k = 0
        if isinstance(width_buckets, str):
            if not width_buckets.startswith("auto"):
                raise ValueError(f"width_buckets: unknown spec {width_buckets!r}")
            self._auto_bucket_k = int(width_buckets.split(":")[1]) if ":" in width_buckets else 4
            width_buckets = None
        self.width_buckets = sorted(int(w) for w in width_buckets) if width_buckets else None
        self.dtype = dtype

        self.model_path = model_path_or_variables if isinstance(
            model_path_or_variables, str) else None
        if self.model_path is not None:
            variables, meta = self._load_variables(self.model_path)
        else:
            blob = dict(model_path_or_variables)
            variables = {"params": blob["params"], "batch_stats": blob.get("batch_stats", {})}
            if blob.get("quant_stats"):
                variables["quant_stats"] = blob["quant_stats"]
            meta = self._meta(blob)
        ckpt_cfg = meta.get("config") or {}
        self.img_h = int(img_h if img_h is not None else ckpt_cfg.get("img_h", 64))
        self.img_w = int(img_w if img_w is not None else ckpt_cfg.get("img_w", 256))

        if charset_path is not None:
            self.charset = Charset.from_file(charset_path)
        elif meta.get("itos"):
            self.charset = Charset.from_tokens(meta["itos"])
        else:
            raise ValueError("charset_path required (checkpoint has no embedded charset)")

        arch = infer_architecture(variables["params"])
        if hidden_size is None:
            hidden_size = meta.get("hidden_size") or arch.get("hidden_size") or 256
        if with_ctc_head is None:
            with_ctc_head = arch.get("with_ctc_head", False)
        cs = self.charset
        # a checkpoint carrying calibrated scales resumes the static int8
        # path directly; scales the model does not read ride along for
        # `variables` (export, save_calibration), as they do in JAX
        static = quantize and "quant_stats" in variables
        self._model_kwargs = dict(
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
            quantize=quantize,
            act_quant="static" if static else "dynamic",
        )
        model = RCNN(**self._model_kwargs)
        if not with_ctc_head and "ctc_proj" in variables["params"]:
            # a CTC head the caller turned off is not loaded (JAX's engine
            # ignores it likewise)
            variables = dict(variables, params={k: v for k, v in variables["params"].items()
                                                if k != "ctc_proj"})
        self._quant_stats = None if static else variables.get("quant_stats")
        load_jax_variables(model, {k: v for k, v in variables.items()
                                   if static or k != "quant_stats"})
        model.eval()
        # one replica of the model per device (the first is `model` itself)
        devices = self._replicas.devices
        self._models: List[RCNN] = [copy.deepcopy(model).to(d) for d in devices[1:]]
        self._models.insert(0, model.to(devices[0]))
        self._itos = list(cs.itos)
        self._lms: List[Optional[torch.Tensor]] = [None] * len(devices)
        if lm is not None:
            table = load_lm(lm, cs) if isinstance(lm, str) else np.asarray(lm, np.float32)
            V = cs.num_classes
            if table.shape != (V, V):
                raise ValueError(f"lm must be [{V}, {V}] for this charset, got {table.shape}")
            self._lms = [torch.from_numpy(np.ascontiguousarray(table)).to(d) for d in devices]
        self.transform = ResizeAndPad(img_h=self.img_h, img_w=self.img_w)
        self._bucket_transforms = (
            {w: ResizeAndPad(img_h=self.img_h, img_w=w) for w in self.width_buckets}
            if self.width_buckets else None
        )

    @property
    def model(self) -> RCNN:
        """The first replica's model (the only one without a mesh)."""
        return self._models[0]

    @property
    def variables(self) -> Dict[str, Any]:
        """The engine's weights as a JAX variable tree (numpy copies), with
        ``quant_stats`` when calibrated or carried by the checkpoint."""
        out = to_jax_variables(self.model)
        if self._quant_stats is not None:
            out["quant_stats"] = self._quant_stats
        return out

    # -- checkpoint loading ------------------------------------------------
    @staticmethod
    def _meta(blob: Dict[str, Any]) -> Dict[str, Any]:
        config = blob.get("config")
        return {"itos": blob.get("itos"), "config": config,
                "hidden_size": (config or {}).get("hidden_size")}

    @staticmethod
    def _load_variables(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(variables, meta)`` from a msgpack (weights or full checkpoint)
        or one of the reference's ``.pth`` / ``.pt`` layouts; ``meta`` holds
        ``itos``, ``hidden_size`` and ``config`` (``None`` where absent)."""
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if path.endswith((".pth", ".pt")):
            out = import_torch_checkpoint(path)
            return out["variables"], out
        variables, blob = load_variables(path)
        return variables, OCRInference._meta(blob)

    # -- batching ----------------------------------------------------------
    def _to_rgb(self, image) -> np.ndarray:
        """An input -> contiguous RGB uint8 HWC (what the C++ letterbox takes)."""
        return np.ascontiguousarray(load_rgb_uint8(image))

    def _preprocess(self, image, width: Optional[int]) -> np.ndarray:
        rgb = load_rgb_uint8(image)
        if width is not None:
            return self._bucket_transforms[width](rgb)
        return self.transform(rgb)

    def _device_batch(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, non_blocking=True)

    def _round_batch(self, batch_size: int) -> int:
        """Under a mesh, ``batch_size`` rounded up to tile the replicas
        (``rcnn_ocr_tpu/inference.py:_round_batch``: 6 images at batch 4
        over 8 replicas decode as one batch of 8)."""
        return self._replicas.round_batch(batch_size)

    def _call(self, run, *arrays: np.ndarray):
        """Run a decode kernel over host batch arrays, the outputs back on
        the host as numpy arrays (one, or a tuple as the kernel returns).
        Under a mesh each replica takes its contiguous block of rows to its
        device and runs ``run(*blocks, replica=i)`` in its own thread and
        stream; the blocks' outputs are joined in row order."""
        def work(i: int, lo: int, hi: int):
            dev = self._replicas.devices[i]
            blocks = [torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev, non_blocking=True)
                      for a in arrays]
            return to_host(run(*blocks, replica=i))
        return gather_rows(self._replicas.run(work, len(arrays[0])))

    def _probe_hw(self, img) -> Tuple[int, int]:
        """(h, w) of an input without decoding it: the file header for a
        path, the shape or ``.size`` for a decoded one."""
        if isinstance(img, str):
            if not os.path.exists(img):
                raise FileNotFoundError(f"Image file not found: {img}")
            return image_size(img)
        if isinstance(img, np.ndarray):
            return int(img.shape[0]), int(img.shape[1])
        if hasattr(img, "size") and hasattr(img, "convert"):  # PIL-like
            w, h = img.size
            return int(h), int(w)
        h, w = load_rgb_uint8(img).shape[:2]
        return int(h), int(w)

    def _resolve_auto_buckets(self, images: List[Any]) -> None:
        """The first call with two or more images fixes ``"auto:K"``'s widths:
        the loader's waste-minimizing fit over their scaled widths, the widest
        lifted to ``img_w`` (later, wider images land there).  A single image
        (a warm-up request) fixes nothing and decodes at ``img_w``."""
        if not self._auto_bucket_k or self.width_buckets or len(images) < 2:
            return
        scaled = [scaled_width(*self._probe_hw(img), self.img_h) for img in images]
        buckets = optimal_width_buckets(scaled, self._auto_bucket_k, multiple=8,
                                        max_width=self.img_w)
        self.width_buckets = sorted(set(buckets[:-1]) | {self.img_w})
        self._bucket_transforms = {w: ResizeAndPad(img_h=self.img_h, img_w=w)
                                   for w in self.width_buckets}

    def _bucket_chunks(self, images: List[Any], batch_size: int) -> List[Tuple[Optional[int], List[int]]]:
        self._resolve_auto_buckets(images)
        groups: Dict[Optional[int], List[int]] = {}
        for i, img in enumerate(images):
            bucket = None
            if self.width_buckets:
                h, w = self._probe_hw(img)
                bucket = bucket_for_width(scaled_width(h, w, self.img_h), self.width_buckets)
            groups.setdefault(bucket, []).append(i)
        return chunk_indices(groups, batch_size)

    def _batches(self, images: List[Any], batch_size: int):
        """(chunk indices, real rows, uint8 host batch) per static batch."""
        for bucket, chunk in self._bucket_chunks(images, batch_size):
            arrays, n_real = pad_rows([self._preprocess(images[j], bucket) for j in chunk],
                                      batch_size)
            yield chunk, n_real, np.stack(arrays)

    def _fuses(self, lm_weight: float) -> bool:
        """Whether a decode fuses the bigram table at this weight (raises
        for a weight without a table)."""
        if not lm_weight:
            return False
        if self._lms[0] is None:
            raise ValueError(
                "lm_weight > 0 needs a bigram table: pass lm= to OCRInference "
                "(build one with python -m rcnn_ocr_tpu_torch.lm)"
            )
        return True

    # -- decode kernels: functions of one device batch -----------------------
    # Each takes a uint8 (or already normalized) batch [B, H, W, 3] on a
    # replica's device and normalizes it first, as JAX's jitted kernels do;
    # `replica` picks the replica whose model runs it (the first by default).
    def _greedy_fn(self, steps: int):
        """``(tokens [B, steps], max-softmax [B, steps])`` of the greedy
        attention decode (``rcnn_ocr_tpu/inference.py:_greedy_fn``)."""
        @torch.inference_mode()
        def run(images, replica: int = 0):
            logits = self._models[replica](device_normalize(images), batch_max_length=steps - 1)
            return torch.argmax(logits, dim=-1), torch.softmax(logits, dim=-1).amax(dim=-1)
        return run

    def _greedy_align_fn(self, steps: int):
        """``(tokens, alignment [B, steps])``: the greedy decode with each
        step's attention argmax, the aligned long-line merge's input
        (``rcnn_ocr_tpu/inference.py:_greedy_align_fn``)."""
        @torch.inference_mode()
        def run(images, replica: int = 0):
            logits, align = self._models[replica].greedy_decode_aligned(
                device_normalize(images), batch_max_length=steps - 1)
            return torch.argmax(logits, dim=-1), align
        return run

    def _attn_beam_fn(self, steps: int, beam_width: int, length_penalty: float,
                      lm_weight: float = 0.0):
        """``(tokens, scores [B])`` of the attention beam, fusing the engine's
        bigram table at ``lm_weight`` > 0 (``rcnn_ocr_tpu/inference.py:_attn_beam_fn``)."""
        return self._beam(steps, beam_width, length_penalty, lm_weight, False)

    def _attn_beam_align_fn(self, steps: int, beam_width: int, length_penalty: float,
                            lm_weight: float = 0.0):
        """``(tokens, scores, alignment)``: the winner's per-step attention
        argmax rides the beam's parent selection
        (``rcnn_ocr_tpu/inference.py:_attn_beam_align_fn``)."""
        return self._beam(steps, beam_width, length_penalty, lm_weight, True)

    def _beam(self, steps, beam_width, length_penalty, lm_weight, alignment):
        fuse = self._fuses(lm_weight)

        @torch.inference_mode()
        def run(images, replica: int = 0):
            return self._models[replica].beam_decode(
                device_normalize(images), int(beam_width), steps - 1,
                length_penalty=length_penalty, lm_logp=self._lms[replica] if fuse else None,
                lm_weight=lm_weight, return_alignment=alignment)
        return run

    def _ctc_frame_ids_fn(self, with_maxp: bool = False):
        """Per-frame argmax class ids ``[B, T]`` int32, plus with ``with_maxp``
        the per-frame max-softmax ``[B, T]``, ``exp(max - logsumexp)`` in fp32
        (``rcnn_ocr_tpu/inference.py:_ctc_frame_ids_fn``)."""
        @torch.inference_mode()
        def run(images, replica: int = 0):
            logits = self._models[replica].ctc_logits(device_normalize(images))
            ids = torch.argmax(logits, dim=-1).to(torch.int32)
            if not with_maxp:
                return ids
            lg = logits.float()
            return ids, torch.exp(lg.amax(dim=-1) - torch.logsumexp(lg, dim=-1))
        return run

    def _ctc_fn(self, greedy: bool, prune_k: int = 0, with_conf: bool = False):
        """The CTC head (``rcnn_ocr_tpu/inference.py:_ctc_fn``): ``greedy``,
        the collapsed ``(tokens, valid)`` (and with ``with_conf`` the mean
        emitted-frame max-softmax ``[B]``); else the frame log-probs ``[B, T,
        V]``, or with ``prune_k`` > 0 each frame's top-k ``(log-probs, ids
        int32)`` in ``lax.top_k``'s order."""
        blank = self.charset.ctc_blank_id

        @torch.inference_mode()
        def run(images, replica: int = 0):
            logits = self._models[replica].ctc_logits(device_normalize(images))
            if greedy:
                return ctc_greedy_decode(logits, blank, return_confidence=with_conf)
            if prune_k:
                vals, idx = ctc_top_frames(logits, prune_k)
                return vals, idx.to(torch.int32)
            return torch.log_softmax(logits.float(), dim=-1)
        return run

    def _ctc_beam_device_fn(self, beam_width: int, prune_k: int, lm_weight: float = 0.0,
                            with_conf: bool = False):
        """Encoder, CTC log-probs, top-k pruning and the prefix beam on the
        device: ``(labels [B, T], lengths [B])`` (and the winner's posterior)
        (``rcnn_ocr_tpu/inference.py:_ctc_beam_device_fn``)."""
        fuse = self._fuses(lm_weight)
        cs = self.charset

        @torch.inference_mode()
        def run(images, replica: int = 0):
            logits = self._models[replica].ctc_logits(device_normalize(images))
            return ctc_beam_from_logits(logits, blank_id=cs.ctc_blank_id, beam_width=beam_width,
                                        prune_k=prune_k,
                                        lm_logp=self._lms[replica] if fuse else None,
                                        lm_weight=lm_weight, sos_id=cs.sos_id,
                                        return_confidence=with_conf)
        return run

    # -- rows -> text --------------------------------------------------------
    def _decode_attention_row(self, pred_row: np.ndarray, maxp_row, return_confidence: bool):
        cs = self.charset
        return decode_attention_row(pred_row, maxp_row, self._itos, pad_id=cs.pad_id,
                                    eos_id=cs.eos_id, blank_id=cs.blank_id,
                                    return_confidence=return_confidence)

    def _decode_beam_row(self, pred_row: np.ndarray, score, return_confidence: bool):
        cs = self.charset
        return decode_beam_row(pred_row, score, self._itos, pad_id=cs.pad_id, eos_id=cs.eos_id,
                               blank_id=cs.blank_id, return_confidence=return_confidence)

    def _ctc_skip(self) -> set:
        cs = self.charset
        return ctc_skip_ids(cs.pad_id, cs.sos_id, cs.eos_id, cs.ctc_blank_id)

    # -- public API --------------------------------------------------------
    @torch.inference_mode()
    def predict(self, images, max_length: int = 25, batch_size: int = 32,
                return_confidence: bool = False, beam_width: Optional[int] = None,
                length_penalty: float = 0.0, lm_weight: float = 0.0):
        """Attention decode -> text (or (text, confidence)) per image: greedy,
        or beam search when ``beam_width`` > 1.

        Greedy confidence is the mean max-softmax over the non-PAD, non-EOS
        steps; the beam's is ``exp(score / len)`` with ``len`` counted
        through the first EOS.  ``length_penalty`` ranks the final beams by
        ``score / len ** length_penalty``; ``lm_weight`` > 0 fuses the
        engine's bigram table (``lm=``) into the beam's step scores.
        """
        if not self.model.with_attention_head:
            raise ValueError("this checkpoint has no attention head; use predict_ctc()")
        is_single = not isinstance(images, list)
        images_list = [images] if is_single else list(images)
        if not images_list:
            return []
        beam = beam_width is not None and beam_width > 1
        if lm_weight and not beam:
            raise ValueError("lm_weight requires beam_width > 1 (fusion is beam-only)")
        if length_penalty and not beam:
            raise ValueError(
                "length_penalty requires beam_width > 1 (rank normalization "
                "is beam-only)"
            )
        steps = max_length + 1
        batch_size = self._round_batch(batch_size)
        if beam:
            run = self._attn_beam_fn(steps, int(beam_width), length_penalty, lm_weight)
            decode_row = self._decode_beam_row
        else:
            run = self._greedy_fn(steps)
            decode_row = self._decode_attention_row
        results: List[Any] = [None] * len(images_list)
        for chunk, n_real, x in self._batches(images_list, batch_size):
            pred, aux = (t[:n_real] for t in self._call(run, x))
            for j, out_idx in enumerate(chunk):
                results[out_idx] = decode_row(pred[j], aux[j], return_confidence)
        return results[0] if is_single else results

    @torch.inference_mode()
    def predict_ctc(self, images, batch_size: int = 32, method: str = "greedy",
                    beam_width: int = 16, prune_k: int = 16, device_beam: bool = True,
                    lm_weight: float = 0.0, return_confidence: bool = False):
        """CTC decode -> text (or (text, confidence)) per image.

        ``method="beam"`` runs the prefix beam over each frame's ``prune_k``
        best classes on the device (:func:`ctc_beam_from_logits`), fusing
        the engine's bigram table at ``lm_weight`` > 0.  ``device_beam=False``
        or ``prune_k=0`` runs the C++ search on the host instead, over the
        shipped top-k frames rebuilt dense at -1e30 (``prune_k=0``: all
        classes).  Confidence: greedy, the mean max-softmax over the emitted
        frames (all frames when none is emitted); beam, the winner's
        posterior among the final beams.
        """
        if not self.model.with_ctc_head:
            raise ValueError("this checkpoint has no CTC head")
        if lm_weight and (method != "beam" or not device_beam):
            raise ValueError("lm_weight requires method='beam' with device_beam=True")
        if method not in ("greedy", "beam"):
            raise ValueError(f"Unsupported decode method: {method}")
        is_single = not isinstance(images, list)
        images_list = [images] if is_single else list(images)
        if not images_list:
            return []
        cs = self.charset
        skip = self._ctc_skip()
        batch_size = self._round_batch(batch_size)
        k = min(prune_k, cs.num_classes) if prune_k else 0
        if method == "greedy":
            run = self._ctc_fn(True, with_conf=return_confidence)
        elif k and device_beam:
            run = self._ctc_beam_device_fn(beam_width, k, lm_weight, with_conf=return_confidence)
        else:
            run = self._ctc_fn(False, k)
        on_device = method == "greedy" or (bool(k) and device_beam)
        results: List[Any] = [None] * len(images_list)
        for chunk, n_real, x in self._batches(images_list, batch_size):
            out = self._call(run, x)
            confs = None
            if on_device:
                texts = decode_ctc_batch(out[0], out[1], n_real, self._itos, skip)
                if return_confidence:
                    confs = out[2][:n_real]
            else:
                if k:
                    vals, idx = (t[:n_real] for t in out)
                    # the pruned frames rebuilt dense: a class outside the top k
                    # is -1e30, far below anything the beam keeps
                    log_probs = np.full((n_real, vals.shape[1], cs.num_classes), -1e30,
                                        np.float32)
                    np.put_along_axis(log_probs, idx.astype(np.int64), vals, -1)
                else:
                    log_probs = out[:n_real]
                got = ctc_beam_search(log_probs, blank_id=cs.ctc_blank_id, beam_width=beam_width,
                                      already_log_probs=True, return_totals=return_confidence)
                texts = ids_to_text(got[0], self._itos, skip_ids=skip)
                if return_confidence:
                    confs = np.exp(got[1] - got[2])
            for j, out_idx in enumerate(chunk):
                results[out_idx] = (texts[j], float(confs[j])) if return_confidence else texts[j]
        return results[0] if is_single else results
