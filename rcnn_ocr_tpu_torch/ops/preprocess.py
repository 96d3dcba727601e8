"""Resize-pad-normalize on the device, and the host letterbox that feeds it.

Counterpart of ``rcnn_ocr_tpu/ops/preprocess.py`` (``_coverage_weights``,
``_bilinear_weights``, ``host_resize_geometry``, ``resize_pad_normalize``
with ``method="area"`` and ``"linear"``, ``host_letterbox``).  The serving path ships raw
uint8 pixels letterboxed into a fixed canvas; the device scales each image
onto the model canvas, keeping its aspect (left-aligned, vertically
centered), fills the rest with white and normalizes to [-1, 1].

The resize follows :class:`~rcnn_ocr_tpu_torch.data.transforms.ResizeAndPad`:
INTER_AREA box coverage when the image shrinks, clamped INTER_LINEAR when it
grows, each axis a weight matrix, so one image is two matrix products,
rounded to uint8 as cv2 rounds.  The weights and products are float64, on
the card as on the host: the pixel is a rounded sum of up to Hc x Wc
products, and TF32 (a 10-bit mantissa), which a caller may enable for
float32 matmuls, would move it across a .5 on many pixels; float64 matmuls
never use TF32, so the output does not depend on that global setting.

``method="linear"`` is JAX's other resize, ``jax.image.scale_and_translate``
with the triangle kernel and antialiasing over the whole canvas
(:func:`_triangle_weights`): the canvas's zeros beyond the image are input
too and bleed into its bottom and right edge, and the result is not
rounded to uint8, so it has only a normalized form.  Its weights are float32,
as JAX builds them, and its products float64, as the area path's.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from rcnn_ocr_tpu_torch.ops.augment import device_normalize

_warned_crop = False  # host_letterbox warns once per process about a crop


def _grid(n_out: int, n_src: int, ref: torch.Tensor):
    r = torch.arange(n_out, dtype=ref.dtype, device=ref.device)[:, None]
    j = torch.arange(n_src, dtype=ref.dtype, device=ref.device)[None, :]
    return r, j


def _coverage_weights(n_out: int, n_src: int, src_len: torch.Tensor, dst_len: torch.Tensor,
                      origin: torch.Tensor) -> torch.Tensor:
    """``[B, n_out, n_src]`` INTER_AREA (box coverage) weights: output pixel
    ``r``, placed at ``origin + [0, dst_len)``, integrates the source over
    ``[(r - origin) * src / dst, (r + 1 - origin) * src / dst)``.  Rows
    outside the placed rect and columns past the true source extent are 0.
    ``src_len``, ``dst_len`` and ``origin`` are ``[B]`` float tensors."""
    src_len, dst_len, origin = (t[:, None, None] for t in (src_len, dst_len, origin))
    r, j = _grid(n_out, n_src, src_len)
    inv = src_len / dst_len  # source pixels per output pixel
    lo = (r - origin) * inv
    hi = (r + 1.0 - origin) * inv
    w = (torch.minimum(hi, j + 1.0) - torch.maximum(lo, j)).clamp_min(0.0) / inv
    keep = (j < src_len) & (r >= origin) & (r < origin + dst_len)
    return torch.where(keep, w, torch.zeros_like(w))


def _bilinear_weights(n_out: int, n_src: int, src_len: torch.Tensor, dst_len: torch.Tensor,
                      origin: torch.Tensor) -> torch.Tensor:
    """``[B, n_out, n_src]`` clamped-bilinear weights (cv2 INTER_LINEAR):
    pixel centers ``src = (r - origin + 0.5) * src / dst - 0.5``, clamped to
    the source extent."""
    src_len, dst_len, origin = (t[:, None, None] for t in (src_len, dst_len, origin))
    r, j = _grid(n_out, n_src, src_len)
    inv = src_len / dst_len
    src = torch.minimum(((r - origin + 0.5) * inv - 0.5).clamp_min(0.0), src_len - 1.0)
    w = (1.0 - (j - src).abs()).clamp(0.0, 1.0)
    keep = (j < src_len) & (r >= origin) & (r < origin + dst_len)
    return torch.where(keep, w, torch.zeros_like(w))


def _triangle_weights(n_out: int, n_in: int, scale: torch.Tensor,
                      translation: torch.Tensor) -> torch.Tensor:
    """``[B, n_out, n_in]`` float32 weights of ``jax.image.scale_and_translate``
    (``method="linear"``, ``antialias=True``; jax 0.9.0's
    ``compute_weight_mat``): a triangle kernel widened by ``1/scale`` when
    shrinking, sample ``(i + 0.5)/scale - t/scale - 0.5``, each output's
    weights normalized by their sum (0 where that sum is below 1000 float32
    epsilons) and 0 where the sample lies outside ``[-0.5, n_in - 0.5]``.
    ``scale`` and ``translation`` are ``[B]`` float32 tensors."""
    scale, translation = scale[:, None, None], translation[:, None, None]
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    i = torch.arange(n_out, dtype=torch.float32, device=scale.device)[None, :, None]
    j = torch.arange(n_in, dtype=torch.float32, device=scale.device)[None, None, :]
    sample_f = (i + 0.5) * inv_scale - translation * inv_scale - 0.5  # [B, n_out, 1]
    w = (1.0 - (sample_f - j).abs() / kernel_scale).clamp_min(0.0)
    total = w.sum(dim=2, keepdim=True)
    zero = torch.zeros_like(w)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), zero)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside, w, zero)


def host_resize_geometry(sizes, img_h: int, img_w: int) -> np.ndarray:
    """Per-image ``(dst_h, dst_w, y0)`` int32 ``[B, 3]`` of the placed rect,
    in float64 with round-half-even as ``ResizeAndPad`` computes it.  Append
    it to the ``[B, 2]`` sizes: the in-kernel float32 geometry can round a
    half-boundary size to a rect one pixel off the host's."""
    sizes = np.asarray(sizes, dtype=np.int64)
    h = np.maximum(sizes[:, 0], 1).astype(np.float64)
    w = np.maximum(sizes[:, 1], 1).astype(np.float64)
    scale = np.minimum(img_h / h, img_w / w)
    dst_h = np.maximum(np.rint(h * scale), 1.0).astype(np.int64)
    dst_w = np.maximum(np.rint(w * scale), 1.0).astype(np.int64)
    y0 = (img_h - dst_h) // 2
    return np.stack([dst_h, dst_w, y0], axis=1).astype(np.int32)


def _placed_rects(sizes: torch.Tensor, img_h: int, img_w: int):
    """(h, w, dst_h, dst_w, y0) float32 ``[B]`` each and the shrink flag:
    from the 5-column sizes as given, else computed in float32 as the JAX
    kernel computes it."""
    h = sizes[:, 0].clamp_min(1).to(torch.float32)
    w = sizes[:, 1].clamp_min(1).to(torch.float32)
    if sizes.shape[1] >= 5:
        new_h, new_w, y0 = (sizes[:, i].to(torch.float32) for i in (2, 3, 4))
        shrink = (new_h < h) | (new_w < w)  # the host transform's own pick
    else:
        scale = torch.minimum(img_h / h, img_w / w)
        new_h = torch.round(h * scale).clamp_min(1.0)
        new_w = torch.round(w * scale).clamp_min(1.0)
        y0 = torch.floor((img_h - new_h) / 2.0)
        shrink = scale < 1.0
    return h, w, new_h, new_w, y0, shrink


def _resample(raw: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """``einsum("bhH,bHWc,bwW->bhwc", wh, raw, ww)`` in float64, as two
    batched products; the second takes (h, c) as rows so that ``ww`` is not
    broadcast (and copied) per row."""
    batch, canvas_h, canvas_w = raw.shape[:3]
    img_h, img_w = wh.shape[1], ww.shape[1]
    wh, ww = wh.to(torch.float64), ww.to(torch.float64)
    rows = torch.bmm(wh, raw.to(torch.float64).reshape(batch, canvas_h, canvas_w * 3))
    rows = rows.reshape(batch, img_h, canvas_w, 3).transpose(2, 3)  # [B, h, 3, Wc]
    out = torch.bmm(rows.reshape(batch, img_h * 3, canvas_w), ww.transpose(1, 2))
    return out.reshape(batch, img_h, 3, img_w).transpose(2, 3)  # [B, h, w, 3]


def _inside(y0: torch.Tensor, new_h: torch.Tensor, new_w: torch.Tensor, img_h: int,
            img_w: int) -> torch.Tensor:
    """``[B, img_h, img_w, 1]``: the pixels of each placed rect (the rest is white)."""
    r = torch.arange(img_h, dtype=y0.dtype, device=y0.device)[None, :, None]
    c = torch.arange(img_w, dtype=y0.dtype, device=y0.device)[None, None, :]
    return ((r >= y0[:, None, None]) & (r < (y0 + new_h)[:, None, None])
            & (c < new_w[:, None, None]))[..., None]


def resize_pad_u8(raw: torch.Tensor, sizes: torch.Tensor, img_h: int, img_w: int,
                  method: str = "area") -> torch.Tensor:
    """uint8 canvas batch ``[B, Hc, Wc, 3]`` (each image in its top-left
    corner) -> the resize-padded uint8 model input ``[B, img_h, img_w, 3]``.

    ``sizes`` is ``[B, 2]`` int ``(h, w)``, or ``[B, 5]`` ``(h, w, dst_h,
    dst_w, y0)`` with :func:`host_resize_geometry`'s rect, which serving
    sends so that every rect is the host's.  Only ``method="area"`` has a
    uint8 form: ``"linear"`` raises ``ValueError`` (JAX does not round the
    linear resize; :func:`resize_pad_normalize` computes it)."""
    if method == "linear":
        raise ValueError("the linear resize has no uint8 form (JAX does not round it to "
                         "uint8); use resize_pad_normalize(method='linear')")
    if method != "area":
        raise ValueError(f"method must be 'area' or 'linear', got {method!r}")
    canvas_h, canvas_w = raw.shape[1:3]
    h, w, new_h, new_w, y0, shrink = _placed_rects(sizes, img_h, img_w)
    h, w, new_h, new_w, y0 = (t.to(torch.float64) for t in (h, w, new_h, new_w, y0))
    zero = torch.zeros_like(y0)
    pick = shrink[:, None, None]
    wh = torch.where(pick, _coverage_weights(img_h, canvas_h, h, new_h, y0),
                     _bilinear_weights(img_h, canvas_h, h, new_h, y0))
    ww = torch.where(pick, _coverage_weights(img_w, canvas_w, w, new_w, zero),
                     _bilinear_weights(img_w, canvas_w, w, new_w, zero))
    # the host materializes cv2.resize's uint8 output before normalizing
    out = torch.round(_resample(raw, wh, ww).clamp(0.0, 255.0))
    out = torch.where(_inside(y0, new_h, new_w, img_h, img_w), out, torch.full_like(out, 255.0))
    return out.to(torch.uint8)


def resize_pad_normalize(raw: torch.Tensor, sizes: torch.Tensor, img_h: int, img_w: int,
                         method: str = "area") -> torch.Tensor:
    """The normalized [-1, 1] model input, float32 ``[B, img_h, img_w, 3]``.

    ``method="area"``: :func:`resize_pad_u8` then the lookup of
    :func:`~rcnn_ocr_tpu_torch.ops.augment.device_normalize`, so a row whose
    pixels equal the host ``ResizeAndPad``'s is bit-equal to ``predict``'s
    normalized batch.  ``method="linear"``: JAX's triangle-kernel resize of
    the whole canvas (module docstring), unrounded, the rect's outside
    white, then ``(x / 255 - 0.5) / 0.5`` in float32 as JAX computes it."""
    if method != "linear":
        return device_normalize(resize_pad_u8(raw, sizes, img_h, img_w, method))
    canvas_h, canvas_w = raw.shape[1:3]
    h, w, new_h, new_w, y0, _ = _placed_rects(sizes, img_h, img_w)
    wh = _triangle_weights(img_h, canvas_h, new_h / h, y0)
    ww = _triangle_weights(img_w, canvas_w, new_w / w, torch.zeros_like(y0))
    out = _resample(raw, wh, ww).to(torch.float32)
    out = torch.where(_inside(y0, new_h, new_w, img_h, img_w), out, torch.full_like(out, 255.0))
    return (out / 255.0 - 0.5) / 0.5


def host_letterbox(images: List[np.ndarray], canvas_h: int, canvas_w: int,
                   out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Paste contiguous HWC uint8 RGB images into a uint8 canvas batch
    ``[B, canvas_h, canvas_w, 3]`` (zeros around each), with the thread-pooled
    C++ copy of :mod:`rcnn_ocr_tpu_torch.native`; ``out`` is a buffer to
    fill (a pinned host tensor's array, for one).  Larger images are cropped
    to the canvas, with a warning once per process.  Returns ``(canvas,
    sizes [B, 2] int32)``."""
    from rcnn_ocr_tpu_torch import native

    global _warned_crop
    if not _warned_crop and any(
        img.shape[0] > canvas_h or img.shape[1] > canvas_w for img in images
    ):
        _warned_crop = True
        warnings.warn(
            f"host_letterbox: input image(s) exceed the {canvas_h}x{canvas_w} "
            f"canvas and will be CROPPED — pass a canvas covering your data",
            stacklevel=2,
        )
    return native.letterbox_u8(images, canvas_h, canvas_w, out=out)


def _letterbox_py(images: List[np.ndarray], canvas_h: int,
                  canvas_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy paste, the plain twin the tests hold the C++ letterbox to."""
    out = np.zeros((len(images), canvas_h, canvas_w, 3), dtype=np.uint8)
    sizes = np.zeros((len(images), 2), dtype=np.int32)
    for i, img in enumerate(images):
        h, w = min(img.shape[0], canvas_h), min(img.shape[1], canvas_w)
        out[i, :h, :w] = img[:h, :w]
        sizes[i] = (h, w)
    return out, sizes
