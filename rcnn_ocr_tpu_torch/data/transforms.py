"""Host-side image transforms in numpy alone: canonicalization, resize-pad,
augmentation, normalization.

Counterpart of ``rcnn_ocr_tpu/data/transforms.py`` (``load_rgb_uint8``,
``ResizeAndPad``, ``shift_scale_rotate``, ``random_brightness_contrast``,
``invert_img``, ``random_edge_crop``, ``normalize_unit``,
``get_train_transform``, ``get_val_transform``), without OpenCV:

* the resize geometry is the same float64 arithmetic with Python ``round``
  (half to even), origins clamped into the canvas, left/center alignment by
  default and a canvas filled with 255;
* resampling follows cv2: INTER_AREA (box coverage) when either side
  shrinks, else clamped INTER_LINEAR, each written as a per-axis weight
  matrix (the method of ``rcnn_ocr_tpu/ops/preprocess.py``), then rounded to
  uint8 as cv2 does.  Pixels agree with cv2's within one uint8 step;
* the affine warp is cv2's ``getRotationMatrix2D`` + ``warpAffine``
  (bilinear, constant white border) written out in numpy with cv2's fixed
  point: source coordinates on a 1/32-pixel grid and integer tap weights
  summing to 2^15 (see :func:`warp_affine`).

A transform is a callable ``(image HWC uint8, rng) -> image``.  Random
transforms draw from the ``numpy.random.Generator`` they are given, in
JAX's order, and refuse to run without one: the loader seeds one per
sample, so a run is repeatable (JAX's falls back to an unseeded
``default_rng()``).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np

from rcnn_ocr_tpu_torch.data.image_io import imread

_PIL_LATER = "arrives with the serving slice of the PyTorch port; pass a path or an array"

Transform = Callable[[np.ndarray, Optional[np.random.Generator]], np.ndarray]


def ensure_rgb(img: np.ndarray) -> np.ndarray:
    """Gray (HxW or HxWx1) / RGBA -> RGB."""
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    if img.shape[2] == 4:
        return np.ascontiguousarray(img[:, :, :3])
    return img


def load_rgb_uint8(image) -> np.ndarray:
    """An inference input (a path to a PNG/BMP file, or an array) -> RGB
    uint8 HWC.  Non-uint8 arrays are taken as 0..255-scaled and rounded."""
    if isinstance(image, str):
        if not os.path.exists(image):
            raise FileNotFoundError(f"Image file not found: {image}")
        return imread(image)
    if isinstance(image, np.ndarray):
        if image.dtype != np.uint8:
            image = np.clip(np.rint(image), 0, 255).astype(np.uint8)
            return ensure_rgb(image)
        return ensure_rgb(image.copy())
    if hasattr(image, "convert"):
        raise NotImplementedError(f"PIL inputs {_PIL_LATER}")
    raise ValueError(f"Unsupported image type: {type(image)}")


def _area_weights(n_dst: int, n_src: int) -> np.ndarray:
    """[n_dst, n_src] box-coverage weights (cv2 INTER_AREA, shrinking)."""
    inv = n_src / n_dst
    r = np.arange(n_dst, dtype=np.float64)[:, None]
    j = np.arange(n_src, dtype=np.float64)[None, :]
    cover = np.minimum((r + 1.0) * inv, j + 1.0) - np.maximum(r * inv, j)
    return np.clip(cover, 0.0, None) / inv


def _linear_weights(n_dst: int, n_src: int) -> np.ndarray:
    """[n_dst, n_src] bilinear weights with samples clamped to the source
    (cv2 INTER_LINEAR, pixel-center convention)."""
    inv = n_src / n_dst
    r = np.arange(n_dst, dtype=np.float64)[:, None]
    j = np.arange(n_src, dtype=np.float64)[None, :]
    src = np.clip((r + 0.5) * inv - 0.5, 0.0, n_src - 1.0)
    return np.clip(1.0 - np.abs(j - src), 0.0, 1.0)


def resize_uint8(img: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    """cv2.resize of an HxWxC uint8 image, INTER_AREA when either side
    shrinks, else INTER_LINEAR."""
    src_h, src_w = img.shape[:2]
    if (dst_h, dst_w) == (src_h, src_w):
        return img.copy()
    weights = _area_weights if (dst_h < src_h or dst_w < src_w) else _linear_weights
    rows = weights(dst_h, src_h) @ img.reshape(src_h, -1).astype(np.float64)
    out = np.einsum("hWc,wW->hwc", rows.reshape(dst_h, src_w, -1), weights(dst_w, src_w),
                    optimize=True)
    return np.rint(np.clip(out, 0.0, 255.0)).astype(np.uint8)


class ResizeAndPad:
    """Aspect-preserving resize pasted onto a white canvas: scale =
    min(img_h/h, img_w/w), sides >= 1px, left (horizontal) / center
    (vertical) alignment by default.  Deterministic: it ignores ``rng`` and
    carries a ``cache_key`` for the disk transform cache."""

    _START, _END = ("left", "top"), ("right", "bottom")

    def __init__(self, img_h=32, img_w=256, align_h="left", align_v="center"):
        self.img_h = int(img_h)
        self.img_w = int(img_w)
        self.align_h = align_h
        self.align_v = align_v

    @property
    def cache_key(self) -> str:
        return f"ResizeAndPad:{self.img_h}:{self.img_w}:{self.align_h}:{self.align_v}"

    @classmethod
    def _origin(cls, align: str, span: int, extent: int) -> int:
        """Paste offset of a span inside an extent, clamped into range."""
        if align in cls._START:
            off = 0
        elif align in cls._END:
            off = extent - span
        else:
            off = (extent - span) // 2
        return min(max(off, 0), extent - span)

    def __call__(self, img: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        img = ensure_rgb(img)
        src_h, src_w = img.shape[:2]
        scale = min(self.img_h / max(src_h, 1), self.img_w / max(src_w, 1))
        dst_w = max(1, int(round(src_w * scale)))
        dst_h = max(1, int(round(src_h * scale)))
        resized = resize_uint8(img, dst_h, dst_w)
        canvas = np.full((self.img_h, self.img_w, 3), 255, dtype=img.dtype)
        x = self._origin(self.align_h, dst_w, self.img_w)
        y = self._origin(self.align_v, dst_h, self.img_h)
        canvas[y : y + dst_h, x : x + dst_w] = resized
        return canvas


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the forward 2x3 map (float64)."""
    a = math.radians(angle)
    alpha, beta = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def warp_affine(img: np.ndarray, m: np.ndarray, fill: int = 255) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), INTER_LINEAR, BORDER_CONSTANT, fill)``
    of a uint8 HxWxC image: the map inverted in float64 as
    ``cv2.invertAffineTransform`` does, source coordinates and bilinear
    interpolation in float32, taps outside the image reading ``fill``,
    rounded to uint8.  Within one uint8 step of cv2 (OpenCV 5's float
    path), on about 0.02% of the pixels."""
    h, w = img.shape[:2]
    (m00, m01, m02), (m10, m11, m12) = m
    det = m00 * m11 - m01 * m10
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = m11 * det, m00 * det, -m01 * det, -m10 * det
    inv = np.array([[a11, a12, -a11 * m02 - a12 * m12],
                    [a21, a22, -a21 * m02 - a22 * m12]]).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    src = img.reshape(h, w, -1).astype(np.float32)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return np.where(inside[..., None], src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)],
                        np.float32(fill))

    p00, p01, p10, p11 = tap(y0, x0), tap(y0, x0 + 1), tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = p00 + ax * (p01 - p00)
    bot = p10 + ax * (p11 - p10)
    out = np.clip(np.rint(top + ay * (bot - top)), 0, 255).astype(np.uint8)
    return out.reshape(img.shape)


def shift_scale_rotate(img: np.ndarray, rng: np.random.Generator, shift_limit: float = 0.03,
                       scale_limit: float = 0.08, rotate_limit: float = 3.0,
                       fill: int = 255) -> np.ndarray:
    """Random affine: angle ~ U(-rot, rot) degrees about the pixel center,
    scale 1 + U(-s, s), shift U(-sh, sh) * (w, h); constant white border."""
    h, w = img.shape[:2]
    angle = rng.uniform(-rotate_limit, rotate_limit)
    scale = 1.0 + rng.uniform(-scale_limit, scale_limit)
    dx = rng.uniform(-shift_limit, shift_limit) * w
    dy = rng.uniform(-shift_limit, shift_limit) * h
    m = rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle, scale)
    m[0, 2] += dx
    m[1, 2] += dy
    return warp_affine(img, m, fill)


def random_brightness_contrast(img: np.ndarray, rng: np.random.Generator,
                               brightness_limit: float = 0.2,
                               contrast_limit: float = 0.2) -> np.ndarray:
    """alpha = 1+U(-c, c) contrast about the mid-gray, beta = U(-b, b)*255."""
    alpha = 1.0 + rng.uniform(-contrast_limit, contrast_limit)
    beta = rng.uniform(-brightness_limit, brightness_limit) * 255.0
    out = img.astype(np.float32) * alpha + beta + 127.5 * (1 - alpha)
    return np.clip(out, 0, 255).astype(img.dtype)


def invert_img(img: np.ndarray) -> np.ndarray:
    return 255 - img


def random_edge_crop(img: np.ndarray, rng: np.random.Generator, limit: float = 0.35) -> np.ndarray:
    """Clip ``U(0.05, limit) * h`` pixels off the left or right edge (the
    label is kept); no crop when that would take a quarter of the width."""
    h, w = img.shape[:2]
    crop = int(round(rng.uniform(0.05, limit) * h))
    if crop <= 0 or crop >= w // 4:
        return img
    if rng.random() < 0.5:
        return img[:, crop:]
    return img[:, : w - crop]


def normalize_unit(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] (Normalize(mean=std=0.5))."""
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


def get_train_transform(params: dict, img_h: int, img_w: int) -> Transform:
    """The training pipeline from config keys, with JAX's names, coercions
    and draw order: edge crop (raw image) -> resize-pad -> shift-scale-
    rotate -> brightness/contrast -> invert -> normalize."""
    resize = ResizeAndPad(img_h=img_h, img_w=img_w)
    shift = round(float(params.get("shift_limit", 0.03)), 4)
    scale = round(float(params.get("scale_limit", 0.08)), 4)
    rot = int(params.get("rotate_limit", 3))
    p_ssr = round(float(params.get("p_ShiftScaleRotate", 0.3)), 4)
    bright = round(float(params.get("brightness_limit", 0.2)), 4)
    contrast = round(float(params.get("contrast_limit", 0.2)), 4)
    p_bc = round(float(params.get("p_BrightnessContrast", 0.3)), 4)
    p_inv = round(float(params.get("invert_p", 0.0)), 4)
    p_edge = round(float(params.get("p_EdgeCrop", 0.0) or 0.0), 4)
    edge_limit = round(float(params.get("edge_crop_limit", 0.35)), 4)

    def transform(img: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        if rng is None:
            raise ValueError("the train transform draws from a seeded numpy Generator; "
                             "pass one as rng")
        if p_edge and rng.random() < p_edge:
            img = random_edge_crop(img, rng, edge_limit)
        img = resize(img)
        if rng.random() < p_ssr:
            img = shift_scale_rotate(img, rng, shift, scale, rot)
        if rng.random() < p_bc:
            img = random_brightness_contrast(img, rng, bright, contrast)
        if rng.random() < p_inv:
            img = invert_img(img)
        return normalize_unit(img)

    return transform


def get_val_transform(img_h: int, img_w: int) -> Transform:
    """ResizeAndPad + normalize, no augmentation."""
    resize = ResizeAndPad(img_h=img_h, img_w=img_w)

    def transform(img: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        return normalize_unit(resize(img))

    return transform
