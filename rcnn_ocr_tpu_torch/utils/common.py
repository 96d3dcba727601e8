"""Standalone model loading: any checkpoint in, a model with its weights out.

Counterpart of ``rcnn_ocr_tpu/utils/common.py:load_model``: the JAX
package's msgpack slots or the reference's ``.pth`` layouts, with the
charset resolved in JAX's order.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from rcnn_ocr_tpu_torch.interop.jax_params import load_jax_variables
from rcnn_ocr_tpu_torch.models.rcnn import RCNN
from rcnn_ocr_tpu_torch.vocab.charset import Charset


def load_model(
    checkpoint_path: str,
    itos: Optional[list] = None,
    stoi: Optional[dict] = None,
    charset_path: Optional[str] = None,
    hidden_size: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[RCNN, dict, Charset]:
    """``(model, variables, charset)`` from a checkpoint file.

    The model is an eval-mode :class:`RCNN` on ``device`` (the card unless
    ``"cpu"`` is asked for) holding the checkpoint's weights; ``variables``
    is the JAX-layout numpy tree it was loaded from.  Charset resolution
    order: ``itos``, then ``stoi``, then ``charset_path``, then the charset
    embedded in a full checkpoint.
    """
    from rcnn_ocr_tpu_torch.inference import OCRInference, infer_architecture, resolve_device

    dev = resolve_device(device)
    variables, meta = OCRInference._load_variables(checkpoint_path)
    if itos is not None:
        charset = Charset.from_tokens(itos)
    elif stoi is not None:
        inv = {int(v): k for k, v in stoi.items()}
        charset = Charset.from_tokens([inv[i] for i in range(len(inv))])
    elif charset_path is not None:
        charset = Charset.from_file(charset_path)
    elif meta.get("itos"):
        charset = Charset.from_tokens(meta["itos"])
    else:
        raise ValueError(
            "charset required: pass itos/stoi or charset_path, or use a full "
            "checkpoint with an embedded charset"
        )

    arch = infer_architecture(variables.get("params", {}))
    model = RCNN(
        num_classes=charset.num_classes,
        hidden_size=int(hidden_size or meta.get("hidden_size") or arch.get("hidden_size") or 256),
        sos_id=charset.sos_id,
        eos_id=charset.eos_id,
        pad_id=charset.pad_id,
        blank_id=charset.blank_id,
        with_attention_head=arch.get("with_attention_head", True),
        with_ctc_head=arch.get("with_ctc_head", False),
        lstm_layers=arch.get("lstm_layers", 2),
        width_mult=arch.get("width_mult", 1.0),
        dtype=dtype,
    )
    load_jax_variables(model, variables)
    return model.eval().to(dev), variables, charset
