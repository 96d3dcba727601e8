"""Fused squeeze-excite: ``x * sigmoid(relu(mean_hw(x) @ w1) @ w2)``.

Counterpart of ``rcnn_ocr_tpu/ops/se_pallas.py:se_scale``.  On a CUDA
tensor :func:`se_scale` launches the hand-written kernel
``csrc/se_scale.cu``; on a CPU tensor it runs :func:`se_scale_reference`,
the plain PyTorch version of the same math (gate computed in fp32, then
rounded to x's dtype before the multiply).  Forward only: the training
slice adds the backward.
"""

from __future__ import annotations

import torch

from rcnn_ocr_tpu_torch.ops import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def se_scale_reference(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain version.  ``x [B, H, W, C]`` NHWC, ``w1 [C, C/r]``, ``w2 [C/r, C]``."""
    m = x.float().mean(dim=(1, 2))
    y = torch.relu(m @ w1.float())
    g = torch.sigmoid(y @ w2.float())
    return x * g[:, None, None, :].to(x.dtype)


def se_scale(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Squeeze-excite over NHWC ``x`` (fp32 or bf16); weights are used in fp32."""
    if not kernels.use_kernel(x):
        return se_scale_reference(x, w1, w2)
    batch, h, w, c = x.shape
    s = w1.shape[1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"se_scale: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("se_scale: x must be contiguous NHWC (channels_last)")
    if tuple(w1.shape) != (c, s) or tuple(w2.shape) != (s, c):
        raise ValueError(f"se_scale: weights {tuple(w1.shape)}, {tuple(w2.shape)} do not fit C={c}")
    if c > 1024 or s > 64:
        raise ValueError(f"se_scale: kernel takes C <= 1024 and C/r <= 64, got {c}, {s}")
    w1f = w1.to(device=x.device, dtype=torch.float32).contiguous()
    w2f = w2.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = kernels.SE_SCALE.fn()
    err = fn(x.data_ptr(), w1f.data_ptr(), w2f.data_ptr(), out.data_ptr(),
             batch, h * w, c, s, _DTYPES[x.dtype], kernels.stream_ptr())
    kernels.SE_SCALE.check(err)
    kernels.SE_SCALE.launches += 1
    return out
