"""Plain resize-pad of raw line images onto the model canvas, in numpy.

What a user's line goes through before the model: keep the aspect, scale to
fit ``img_h x img_w`` (each side at least one pixel), box-average when the
line shrinks and clamped bilinear interpolation when it grows (OpenCV's
INTER_AREA / INTER_LINEAR), round to uint8, paste left-aligned and
vertically centred on white, then map ``[0, 255]`` to ``[-1, 1]``.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _area(n_out: int, n_src: int) -> np.ndarray:
    """[n_out, n_src] box coverage: output pixel r averages the source over
    [r * n_src / n_out, (r + 1) * n_src / n_out)."""
    inv = n_src / n_out
    r = np.arange(n_out, dtype=np.float64)[:, None]
    j = np.arange(n_src, dtype=np.float64)[None, :]
    lo, hi = r * inv, (r + 1.0) * inv
    return np.clip(np.minimum(hi, j + 1.0) - np.maximum(lo, j), 0.0, None) / inv


def _linear(n_out: int, n_src: int) -> np.ndarray:
    """[n_out, n_src] bilinear weights at pixel centres, clamped to the edges."""
    inv = n_src / n_out
    r = np.arange(n_out, dtype=np.float64)[:, None]
    j = np.arange(n_src, dtype=np.float64)[None, :]
    src = np.minimum(np.maximum((r + 0.5) * inv - 0.5, 0.0), n_src - 1.0)
    return np.clip(1.0 - np.abs(j - src), 0.0, 1.0)


def resize_pad(image: np.ndarray, img_h: int, img_w: int) -> np.ndarray:
    """One ``[h, w, 3]`` uint8 line -> ``[img_h, img_w, 3]`` uint8."""
    h, w = image.shape[:2]
    scale = min(img_h / max(h, 1), img_w / max(w, 1))
    dst_h = max(1, int(np.rint(h * scale)))
    dst_w = max(1, int(np.rint(w * scale)))
    weights = _area if (dst_h < h or dst_w < w) else _linear
    wh, ww = weights(dst_h, h), weights(dst_w, w)
    rows = (wh @ image.astype(np.float64).reshape(h, w * 3)).reshape(dst_h, w, 3)
    resized = (rows.transpose(0, 2, 1) @ ww.T).transpose(0, 2, 1)  # [dst_h, dst_w, 3]
    out = np.full((img_h, img_w, 3), 255, np.uint8)
    y0 = (img_h - dst_h) // 2
    out[y0:y0 + dst_h, :dst_w] = np.rint(np.clip(resized, 0.0, 255.0)).astype(np.uint8)
    return out


def model_input(images: Sequence[np.ndarray], img_h: int, img_w: int) -> np.ndarray:
    """Lines -> the normalized float32 batch ``[B, img_h, img_w, 3]`` in [-1, 1]."""
    batch: List[np.ndarray] = [resize_pad(im, img_h, img_w) for im in images]
    return (np.stack(batch).astype(np.float32) / np.float32(255.0) - np.float32(0.5)) \
        / np.float32(0.5)
