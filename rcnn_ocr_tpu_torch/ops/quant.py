"""int8 quantized inference: post-training quantization of the wide convs.

Counterpart of ``rcnn_ocr_tpu/ops/quant.py``:

* weights: symmetric per-output-channel int8, quantized from the fp32
  parameter (no calibration needed);
* activations: a symmetric per-tensor int8 scale ``max|x| / 127`` (floored
  at 1e-8), computed per call (*dynamic*) or taken from a calibrated
  ``act_absmax / 127`` (*static*, :mod:`rcnn_ocr_tpu_torch.calibration`);
* accumulation in int32, dequantized as ``acc.float() * (x_scale *
  w_scale[c])``, the JAX package's order, so results are bit-equal to it.

``round`` is round-half-even in both packages and codes clip to ±127.  The
JAX package leaves the convolution to XLA (``lax.conv_general_dilated`` with
an int32 accumulator, no Pallas kernel); here it is an im2col of the int8
codes (``Tensor.unfold`` views of the padded tensor, copied once into a
``[B*Ho*Wo, kh*kw*Cin]`` matrix) and one ``torch._int_mm`` (int8 x int8 ->
int32: cuBLASLt on the card, a reference GEMM on the CPU).  ``_int_mm`` on
the card wants more than 16 rows and a depth and width that are multiples
of 8: rows, depth and output channels are zero-padded where they fall
short, which leaves every accumulator unchanged.

Public functions take JAX's layouts (``x`` NHWC, ``w`` HWIO) so the tests
compare like with like.  Training never takes this path; it is an
inference-serving option (``RCNN(quantize=True)``,
``OCRInference(..., quantize=True)``).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]

SCALE_FLOOR = 1e-8
QMAX = 127.0


def quantize_weight_per_cout(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO conv kernel -> (int8 kernel, per-output-channel float32 scale)."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)) / QMAX, SCALE_FLOOR)
    wq = torch.clamp(torch.round(w / s), -QMAX, QMAX).to(torch.int8)
    return wq, s


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor -> (int8 tensor, scalar float32 scale), symmetric dynamic."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax() / QMAX, SCALE_FLOOR)
    return quantize_static(xf, s), s


def quantize_static(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``x`` at a given scalar scale (values beyond ±127·scale clip)."""
    return torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX).to(torch.int8)


def _pads(padding: Padding) -> Tuple[int, int, int, int]:
    """``(top, bottom, left, right)`` of JAX's padding spec."""
    if isinstance(padding, str):
        if padding != "VALID":
            raise ValueError(f"padding must be 'VALID' or explicit pairs, got {padding!r}")
        return 0, 0, 0, 0
    (pt, pb), (pl, pr) = padding
    return int(pt), int(pb), int(pl), int(pr)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_conv_accumulate(xq: torch.Tensor, wq: torch.Tensor, strides: Sequence[int],
                         padding: Padding) -> torch.Tensor:
    """The int32 accumulators of an int8 convolution: ``xq [B, H, W, Cin]``
    int8 NHWC, ``wq [kh, kw, Cin, Cout]`` int8 HWIO -> ``[B, Ho, Wo, Cout]``
    int32, as ``lax.conv_general_dilated(..., preferred_element_type=int32)``."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 codes expected, got {xq.dtype} and {wq.dtype}")
    kh, kw, cin, cout = wq.shape
    if xq.shape[-1] != cin:
        raise ValueError(f"input has {xq.shape[-1]} channels, the kernel takes {cin}")
    sh, sw = (int(s) for s in strides)
    pt, pb, pl, pr = _pads(padding)
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb))  # zero codes are exact zeros
    batch = xp.shape[0]
    # [B, Ho, Wo, Cin, kh, kw] views -> rows ordered (kh, kw, Cin) as HWIO flattens
    patches = xp.unfold(1, kh, sh).unfold(2, kw, sw)
    ho, wo = patches.shape[1], patches.shape[2]
    m, k = batch * ho * wo, kh * kw * cin
    # one copy of the patches into a matrix padded to _int_mm's rules: 16 to
    # 47 more rows, to a multiple of 32 (it takes more than 16, and on the
    # H100 cuBLASLt refuses a depth of 64 or less unless the rows are a
    # multiple of 32: the int8 stem's 27), and depth and width to multiples
    # of 8.  The row padding is unconditional, so no branch reads the batch
    # and a program exported with a symbolic batch runs at any size.
    k_pad, n_pad = _round_up(k, 8) - k, _round_up(cout, 8) - cout
    rows = xq.new_empty((_round_up(m + 16, 32), k + k_pad))
    rows[:m, :k].view(batch, ho, wo, kh, kw, cin).copy_(patches.permute(0, 1, 2, 4, 5, 3))
    rows[m:].zero_()
    if k_pad:
        rows[:m, k:].zero_()
    mat = wq.reshape(k, cout)
    if k_pad or n_pad:
        mat = F.pad(mat, (0, n_pad, 0, k_pad))
    acc = torch._int_mm(rows, mat.contiguous())
    return acc[:m, :cout].reshape(batch, ho, wo, cout)


def int8_conv_nhwc(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
                   padding: Padding) -> torch.Tensor:
    """Quantize-on-the-fly int8 convolution, float32 output: ``x [B, H, W,
    Cin]`` float, ``w [kh, kw, Cin, Cout]`` float (the fp32 parameter)."""
    wq, ws = quantize_weight_per_cout(w)
    xq, xs = quantize_activation(x)
    acc = int8_conv_accumulate(xq, wq, strides, padding)
    return acc.float() * (xs * ws)


def int8_conv_nhwc_static(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
                          padding: Padding, act_scale: torch.Tensor) -> torch.Tensor:
    """int8 convolution with a calibrated static activation scale (scalar
    float32, ``act_absmax / 127``): no abs-max reduction over the input;
    values beyond the calibrated range clip at ±127·scale."""
    act_scale = torch.clamp_min(act_scale.float(), SCALE_FLOOR)
    wq, ws = quantize_weight_per_cout(w)
    acc = int8_conv_accumulate(quantize_static(x, act_scale), wq, strides, padding)
    return acc.float() * (act_scale * ws)
