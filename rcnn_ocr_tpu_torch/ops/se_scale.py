"""Fused squeeze-excite: ``x * sigmoid(relu(mean_hw(x) @ w1) @ w2)``.

Counterpart of ``rcnn_ocr_tpu/ops/se_pallas.py:se_scale``.  On a CUDA
tensor :func:`se_scale` launches the hand-written kernel
``csrc/se_scale.cu`` (:func:`route` says how it splits a shape); on a CPU
tensor it runs :func:`se_scale_reference`,
the plain PyTorch version of the same math (gate computed in fp32, then
rounded to x's dtype before the multiply).  That choice lives in the
registered operator ``torch.ops.rcnn_ocr_tpu_torch.se_scale``
(:func:`se_scale_op`), whose fake implementation gives ``torch.export`` the
output's shape: an exported serving program calls the same operator, and so
the same kernel, on the card.

:func:`se_scale` is differentiable on both devices: a
``torch.autograd.Function`` whose backward is :func:`se_scale_backward`, a
copy of the hand-derived VJP ``se_pallas.py:_se_bwd`` (plain XLA there,
plain PyTorch here).
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


def route(shape, squeeze: int, dtype: torch.dtype, device=None) -> dict:
    """How ``csrc/se_scale.cu`` runs ``x`` of ``shape`` [B, H, W, C] on
    ``device`` (a card; default the current one): ``slots`` persistent
    clusters of ``cluster`` CTAs, each CTA holding C/cluster channels of
    ``samples`` samples at a time, or the ``streaming`` route."""
    batch, h, w, c = shape
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    cluster, samples, slots, smem = kernels.SE_SCALE.plan(dev, batch, h * w, c, squeeze,
                                                          _DTYPES[dtype])
    return dict(route="cluster" if cluster else "streaming", cluster=cluster, samples=samples,
                slots=slots, smem=smem)


def se_scale_backward(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                      dout: torch.Tensor):
    """``(dx, dw1, dw2)`` of :func:`se_scale` at ``dout``: the gate and its
    pre-activations recomputed in fp32, each gradient in its input's dtype."""
    xf, df = x.float(), dout.float()
    w1f, w2f = w1.float(), w2.float()
    hw = x.shape[1] * x.shape[2]
    m = xf.mean(dim=(1, 2))  # [B, C]
    y_pre = m @ w1f
    y = torch.relu(y_pre)
    g = torch.sigmoid(y @ w2f)
    dgate = (df * xf).sum(dim=(1, 2))  # [B, C]
    dg_pre = dgate * g * (1.0 - g)
    dy_pre = (dg_pre @ w2f.T) * (y_pre > 0.0)
    dm = dy_pre @ w1f.T
    dx = df * g[:, None, None, :] + dm[:, None, None, :] / hw
    return dx.to(x.dtype), (m.T @ dy_pre).to(w1.dtype), (y.T @ dg_pre).to(w2.dtype)


@torch.library.custom_op("rcnn_ocr_tpu_torch::se_scale", mutates_args=())
def se_scale_op(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The forward as a registered operator, so that ``torch.export`` records
    it in a program: on a CUDA tensor the kernel, on a CPU tensor
    :func:`se_scale_reference`.  A program traced on one device records no
    layout copy where that device's convolution already gave NHWC; on
    another device the input may come in another layout, so the kernel's
    branch makes it NHWC-contiguous (a no-op on the live path)."""
    if not kernels.use_kernel(x):
        return se_scale_reference(x, w1, w2)
    return _launch(x.contiguous(), w1, w2)


@se_scale_op.register_fake
def _se_scale_fake(x, w1, w2):
    return torch.empty_like(x)


class _SEScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2):
        ctx.save_for_backward(x, w1, w2)
        return se_scale_op(x, w1, w2)

    @staticmethod
    def backward(ctx, dout):
        return se_scale_backward(*ctx.saved_tensors, dout)


def se_scale(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Squeeze-excite over NHWC ``x`` (fp32 or bf16); weights are used in fp32.
    Differentiable in ``x``, ``w1`` and ``w2``.  A CUDA ``x`` must be
    contiguous NHWC, as the kernel reads it (an exported program calls the
    operator, which copies another layout)."""
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("se_scale: x must be contiguous NHWC (channels_last)")
    return _SEScale.apply(x, w1, w2)


def _launch(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
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
    kernels.SE_SCALE.launch(x.device, x.data_ptr(), w1f.data_ptr(), w2f.data_ptr(),
                            out.data_ptr(), batch, h * w, c, s, _DTYPES[x.dtype])
    return out
