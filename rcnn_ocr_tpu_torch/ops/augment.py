"""On-device input normalization and training augmentation.

Counterpart of ``rcnn_ocr_tpu/ops/augment.py`` (``device_normalize``,
``inverse_affine_matrices``, ``affine_warp``, ``shift_scale_rotate_batch``,
``brightness_contrast_batch``, ``invert_batch``, ``device_train_augment``),
in plain PyTorch on the batch's device (these are not TPU kernels).

Semantics are the host path's (``data/transforms.py``): angle ~ U(-rot,
rot) degrees about the pixel center, scale 1 + U(-s, s), shift U(-sh, sh)
* (W, H), white fill; brightness/contrast ``x*alpha + beta + 0.5*(1-alpha)``
on [0, 1]; every image draws its own parameters and apply coins.  Random
draws come from the ``torch.Generator`` passed in (on the batch's device),
in the order coin, then parameters, per op; the config values get the host
path's coercions (``round(.., 4)``, ``int`` on the rotation).  Under a
data-parallel step every draw covers the global batch and this rank keeps
its rows (:func:`rcnn_ocr_tpu_torch.parallel.mesh.rand_rows`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from rcnn_ocr_tpu_torch.parallel.mesh import rand_rows

# all 256 normalized uint8 values, computed once with host IEEE fp32
# arithmetic; the device applies them by lookup, so device- and
# host-normalized pixels are bit-identical
U8_NORM_TABLE = (
    (np.arange(256, dtype=np.float32) / np.float32(255.0)) - np.float32(0.5)
) / np.float32(0.5)


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC batch -> normalized [-1, 1] float32 on the batch's device;
    float inputs pass through unchanged."""
    if images.dtype == torch.uint8:
        table = torch.from_numpy(U8_NORM_TABLE).to(images.device)
        return table[images.long()]
    return images


def inverse_affine_matrices(angles_deg: torch.Tensor, scales: torch.Tensor, dx: torch.Tensor,
                            dy: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``[B, 2, 3]`` output->input maps inverting ``getRotationMatrix2D((W/2 -
    0.5, H/2 - 0.5), angle, scale)`` plus the shift."""
    theta = angles_deg * (math.pi / 180.0)
    alpha = scales * torch.cos(theta)
    beta = scales * torch.sin(theta)
    cx, cy = width / 2.0 - 0.5, height / 2.0 - 0.5
    tx = (1.0 - alpha) * cx - beta * cy + dx
    ty = beta * cx + (1.0 - alpha) * cy + dy
    det = torch.clamp(alpha * alpha + beta * beta, min=1e-12)
    ia, ib = alpha / det, beta / det
    itx = -(ia * tx - ib * ty)
    ity = -(ib * tx + ia * ty)
    row0 = torch.stack([ia, -ib, itx], dim=-1)
    row1 = torch.stack([ib, ia, ity], dim=-1)
    return torch.stack([row0, row1], dim=1)


def affine_warp(images: torch.Tensor, inv_mats: torch.Tensor, fill: float = 1.0) -> torch.Tensor:
    """Batched bilinear warp of ``[B, H, W, C]`` floats by gathering the four
    source taps; taps outside the image read ``fill``."""
    b, h, w, c = images.shape
    ys = torch.arange(h, dtype=torch.float32, device=images.device)
    xs = torch.arange(w, dtype=torch.float32, device=images.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    src = torch.einsum("bij,hwj->bhwi", inv_mats, coords)
    sx, sy = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = images.reshape(b, h * w, c)

    def tap(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()).reshape(b, h * w)
        vals = torch.gather(flat, 1, idx[..., None].expand(b, h * w, c)).reshape(b, h, w, c)
        return torch.where(inside[..., None], vals, torch.full_like(vals, fill))

    top = tap(y0, x0) * (1.0 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1.0 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def _uniform(n: int, lo: float, hi: float, generator: torch.Generator,
             device: torch.device) -> torch.Tensor:
    return lo + (hi - lo) * rand_rows((n,), generator, device)


def shift_scale_rotate_batch(images: torch.Tensor, generator: torch.Generator, p: float = 0.3,
                             shift_limit: float = 0.03, scale_limit: float = 0.08,
                             rotate_limit: float = 3.0, fill: float = 1.0) -> torch.Tensor:
    """Per-image random affine on ``[B, H, W, C]`` in [0, 1]; skipped images
    get the identity map."""
    b, h, w, _ = images.shape
    dev = images.device
    apply = rand_rows((b,), generator, dev) < p
    angles = _uniform(b, -rotate_limit, rotate_limit, generator, dev)
    scales = 1.0 + _uniform(b, -scale_limit, scale_limit, generator, dev)
    dx = _uniform(b, -shift_limit, shift_limit, generator, dev) * w
    dy = _uniform(b, -shift_limit, shift_limit, generator, dev) * h
    zero = torch.zeros_like(angles)
    mats = inverse_affine_matrices(torch.where(apply, angles, zero),
                                   torch.where(apply, scales, torch.ones_like(scales)),
                                   torch.where(apply, dx, zero), torch.where(apply, dy, zero),
                                   h, w)
    return affine_warp(images, mats, fill=fill)


def brightness_contrast_batch(images: torch.Tensor, generator: torch.Generator, p: float = 0.3,
                              brightness_limit: float = 0.2,
                              contrast_limit: float = 0.2) -> torch.Tensor:
    """Contrast about mid-gray and a brightness shift, per image, on [0, 1]."""
    b, dev = images.shape[0], images.device
    apply = rand_rows((b,), generator, dev) < p
    alpha = 1.0 + _uniform(b, -contrast_limit, contrast_limit, generator, dev)
    beta = _uniform(b, -brightness_limit, brightness_limit, generator, dev)
    return apply_brightness_contrast(images, torch.where(apply, alpha, torch.ones_like(alpha)),
                                     torch.where(apply, beta, torch.zeros_like(beta)))


def apply_brightness_contrast(images: torch.Tensor, alpha: torch.Tensor,
                              beta: torch.Tensor) -> torch.Tensor:
    """``clip(x * alpha + beta + 0.5 * (1 - alpha), 0, 1)`` with per-image
    ``alpha`` and ``beta`` ``[B]``."""
    alpha, beta = alpha[:, None, None, None], beta[:, None, None, None]
    return torch.clamp(images * alpha + beta + 0.5 * (1.0 - alpha), 0.0, 1.0)


def invert_batch(images: torch.Tensor, generator: torch.Generator, p: float = 0.0) -> torch.Tensor:
    apply = rand_rows((images.shape[0],), generator, images.device) < p
    return torch.where(apply[:, None, None, None], 1.0 - images, images)


def device_train_augment(images_u8: torch.Tensor, generator: torch.Generator,
                         params: Optional[Dict] = None) -> torch.Tensor:
    """uint8 ``[B, H, W, C]`` (resize-padded on the host) -> affine ->
    brightness/contrast -> invert -> normalized [-1, 1] float32, with the
    host pipeline's config keys, defaults and coercions."""
    if images_u8.dtype != torch.uint8:
        raise ValueError(f"device augmentation takes uint8 images, got {images_u8.dtype}")
    p = params or {}
    x = images_u8.float() / 255.0
    x = shift_scale_rotate_batch(
        x, generator, p=round(float(p.get("p_ShiftScaleRotate", 0.3)), 4),
        shift_limit=round(float(p.get("shift_limit", 0.03)), 4),
        scale_limit=round(float(p.get("scale_limit", 0.08)), 4),
        rotate_limit=int(p.get("rotate_limit", 3)))
    x = brightness_contrast_batch(
        x, generator, p=round(float(p.get("p_BrightnessContrast", 0.3)), 4),
        brightness_limit=round(float(p.get("brightness_limit", 0.2)), 4),
        contrast_limit=round(float(p.get("contrast_limit", 0.2)), 4))
    x = invert_batch(x, generator, p=round(float(p.get("invert_p", 0.0)), 4))
    return (x - 0.5) / 0.5
