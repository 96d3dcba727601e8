"""Static int8 activation calibration for the inference engine.

Counterpart of ``rcnn_ocr_tpu/calibration.py:CalibrationMixin``.  The
dynamic int8 path computes an abs-max over every quantized conv's input on
every call; calibration records those ranges once, from sample data, so
each conv quantizes its input at a fixed scale (``act_absmax / 127``) and
values beyond the calibrated range clip.

Mixed into :class:`rcnn_ocr_tpu_torch.inference.OCRInference`.  Under a
mesh each replica records its block of every chunk, and the replicas' ranges
are joined by an element-wise max after each chunk (JAX shards the batch and
replicates the statistics); a max does not depend on the order, so the
scales equal the one-replica engine's exactly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np
import torch

from rcnn_ocr_tpu_torch.models.rcnn import RCNN
from rcnn_ocr_tpu_torch.models.seresnet31 import recording_act_absmax
from rcnn_ocr_tpu_torch.ops.augment import device_normalize
from rcnn_ocr_tpu_torch.postprocess import pad_rows
from rcnn_ocr_tpu_torch.training.checkpoint import (
    CHECKPOINT_FORMAT_VERSION,
    _atomic_write,
    load_checkpoint_blob,
)

ABSMAX_SUFFIX = ".act_absmax"


class CalibrationMixin:
    """``calibrate`` / ``save_calibration`` for ``OCRInference``."""

    def calibrate(self, images: Union[Any, List[Any]], batch_size: int = 32) -> None:
        """Post-training calibration: switch the int8 path to STATIC
        activation scales recorded from sample data.

        Each quantized conv keeps the running max of ``|x|`` over the
        batches of a full-precision forward (every ``predict*`` call after
        this one takes the static path).  A short last chunk is padded by
        repeating its last image, and the repeats count in the max, as in
        JAX.  Calibrating again starts from zero.  Under a mesh the chunk
        size rounds up to tile the replicas.
        """
        if not self.model.quantize:
            raise ValueError("calibrate() requires OCRInference(quantize=True)")
        images_list: List[Any] = [images] if not isinstance(images, list) else list(images)
        if not images_list:
            raise ValueError("calibration needs at least one image")
        batch_size = self._round_batch(batch_size)
        calibs = [self._calibration_model(model) for model in self._models]
        for i in range(0, len(images_list), batch_size):
            arrays, _ = pad_rows([self._preprocess(img, None)
                                  for img in images_list[i : i + batch_size]], batch_size)
            x = np.stack(arrays)

            def record(r: int, lo: int, hi: int):
                calib = calibs[r]
                block = torch.from_numpy(x[lo:hi]).to(self._replicas.devices[r])
                with torch.no_grad(), recording_act_absmax(calib):
                    calib.encode(device_normalize(block))

            self._replicas.run(record, batch_size)
            if len(calibs) > 1:
                _join_absmax(calibs)
        self._models = calibs
        self._model_kwargs["act_quant"] = "static"
        self._quant_stats = None

    def _calibration_model(self, model: RCNN) -> RCNN:
        """A static-int8 copy of ``model`` on its device: the weights carry
        over, the act_absmax buffers start at zero."""
        calib = RCNN(**{**self._model_kwargs, "act_quant": "static"})
        state = {k: v for k, v in model.state_dict().items() if not k.endswith(ABSMAX_SUFFIX)}
        missing, unexpected = calib.load_state_dict(state, strict=False)
        if unexpected or any(not k.endswith(ABSMAX_SUFFIX) for k in missing):
            raise RuntimeError(f"calibration model mismatch: missing {missing}, "
                               f"unexpected {unexpected}")
        return calib.eval().to(next(model.parameters()).device)

    def save_calibration(self, path: str) -> None:
        """Persist the calibrated static-int8 scales: a copy of the source
        checkpoint with ``quant_stats`` embedded (written atomically).
        Reopening it with ``OCRInference(..., quantize=True)`` takes the
        static path directly.  A ``.pth`` source (or a variable tree) has no
        msgpack blob to copy, so the file is made standalone: weights,
        charset and the geometry this engine uses."""
        variables = self.variables  # the first replica's (all hold the same)
        if "quant_stats" not in variables:
            raise ValueError("no calibration recorded; call calibrate() first")
        if self.model_path is None or self.model_path.endswith((".pth", ".pt")):
            cs = self.charset
            blob: Dict[str, Any] = {
                "format_version": CHECKPOINT_FORMAT_VERSION,
                "itos": list(cs.itos),
                "stoi": {str(k): int(v) for k, v in cs.stoi.items()},
                "config": {"img_h": self.img_h, "img_w": self.img_w,
                           "hidden_size": self._model_kwargs["hidden_size"]},
            }
        else:
            blob = dict(load_checkpoint_blob(self.model_path))
        blob["params"] = variables["params"]
        blob["batch_stats"] = variables.get("batch_stats", {})
        blob["quant_stats"] = variables["quant_stats"]
        _atomic_write(path, blob)


def _join_absmax(models: List[RCNN]) -> None:
    """Set every model's act_absmax buffers to their element-wise max over
    the models (replicas, possibly on several cards; each replica's work is
    complete)."""
    buffers = [{k: v for k, v in m.named_buffers() if k.endswith(ABSMAX_SUFFIX)} for m in models]
    for name in buffers[0]:
        top = torch.stack([b[name].cpu() for b in buffers]).amax(dim=0)
        for b in buffers:
            b[name].copy_(top)
    for dev in {t.device for b in buffers for t in b.values()}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the copies land before the next chunk reads them
