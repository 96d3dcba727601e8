"""Host-side input canonicalization and resize-pad, in numpy alone.

Counterpart of ``rcnn_ocr_tpu/data/transforms.py:load_rgb_uint8`` and
``ResizeAndPad``, without OpenCV:

* the geometry is the same float64 arithmetic with Python ``round``
  (half to even), origins clamped into the canvas, left/center alignment by
  default and a canvas filled with 255;
* resampling follows cv2: INTER_AREA (box coverage) when either side
  shrinks, else clamped INTER_LINEAR, each written as a per-axis weight
  matrix (the method of ``rcnn_ocr_tpu/ops/preprocess.py``), then rounded to
  uint8 as cv2 does.  Pixels agree with cv2's within one uint8 step.

Decoding image files and PIL images arrives with the serving slice.
"""

from __future__ import annotations

import numpy as np

_LATER = "arrives with the serving slice of the PyTorch port; pass an RGB/gray uint8 ndarray"


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
    """An inference input -> RGB uint8 HWC.  Non-uint8 arrays are taken as
    0..255-scaled and rounded."""
    if isinstance(image, str):
        raise NotImplementedError(f"reading image files {_LATER}")
    if isinstance(image, np.ndarray):
        if image.dtype != np.uint8:
            image = np.clip(np.rint(image), 0, 255).astype(np.uint8)
            return ensure_rgb(image)
        return ensure_rgb(image.copy())
    if hasattr(image, "convert"):
        raise NotImplementedError(f"PIL inputs {_LATER}")
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
    (vertical) alignment by default."""

    _START, _END = ("left", "top"), ("right", "bottom")

    def __init__(self, img_h=32, img_w=256, align_h="left", align_v="center"):
        self.img_h = int(img_h)
        self.img_w = int(img_w)
        self.align_h = align_h
        self.align_v = align_v

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

    def __call__(self, img: np.ndarray) -> np.ndarray:
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
