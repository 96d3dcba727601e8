"""The synthetic generator's effect operations, without OpenCV.

Each matches the cv2 call of ``rcnn_ocr_tpu/data/synthetic.py:render_line``
that it replaces:

* :func:`gaussian_blur_u8` is ``cv2.GaussianBlur(img, (0, 0), sigmaX=s)``
  on uint8 bit for bit: OpenCV's 8-bit path is fixed point (a kernel of
  ``cvRound(6 s + 1) | 1`` taps from ``getGaussianKernelBitExact``,
  quantized to 1/256 with error diffusion, the centre tap taking the rest;
  rows then columns, the sum rounded once), with BORDER_REFLECT_101;
* :func:`area_resize_u8` is ``cv2.resize(img, (w, h), INTER_AREA)`` for a
  shrink on both axes, bit for bit: the exact halving as ``resizeAreaFast``
  does it, else ``resizeArea``'s float32 tables and sums in its order;
* :func:`jpeg_round_trip` is ``cv2.imdecode(cv2.imencode(".jpg", img,
  [IMWRITE_JPEG_QUALITY, q])[1], IMREAD_GRAYSCALE)``: the bytes of
  ``csrc/host/jpeg_encode.cpp`` (equal to cv2's) through the port's JPEG
  decoder (equal to cv2's).

The shear and the rotation go through ``data/transforms.py``'s
``warp_affine`` and ``rotation_matrix``, within one uint8 step of cv2.
Integer or float32 element-wise arithmetic throughout, so every host gives
the same pixels.
"""

from __future__ import annotations

import math

import numpy as np

from rcnn_ocr_tpu_torch import native
from rcnn_ocr_tpu_torch.data.transforms import resize_uint8


def gaussian_kernel_q8(sigma: float) -> np.ndarray:
    """OpenCV's fixed-point Gaussian taps for ``sigma`` (sum 256)."""
    n = int(np.rint(sigma * 6 + 1)) | 1  # cvRound (half to even), odd
    if n == 1:
        return np.array([256], np.int64)
    scale2 = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    values, total = [], 0.0
    for i in range(half):
        x = 1 - n + 2 * i
        t = math.exp(float(x * x) * scale2)
        values.append(t)
        total += t
    mul = 1.0 / (total * 2.0 + 1.0)
    taps = np.zeros(n, np.int64)
    err, used = 0.0, 0
    for i in range(half):
        adj = values[i] * mul * 256.0 + err
        v = round(adj)  # half to even, as cvRound
        err = adj - float(v)
        taps[i] = taps[n - 1 - i] = v
        used += v
    taps[half] = 256 - 2 * used
    return taps


def _reflect_101(n: int, r: int) -> np.ndarray:
    """Source index of each of ``n + 2 r`` padded positions under
    BORDER_REFLECT_101 (OpenCV's ``borderInterpolate``)."""
    idx = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(idx)
    while ((idx < 0) | (idx >= n)).any():
        idx = np.where(idx < 0, -idx, idx)
        idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return idx


def gaussian_blur_u8(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigmaX=sigma)`` of a uint8 ``[H, W]``
    image, bit for bit."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"gaussian_blur_u8 takes a uint8 [H, W] image, got {img.dtype} {img.shape}")
    taps = gaussian_kernel_q8(float(sigma))
    n, r = taps.size, taps.size // 2
    if n == 1:
        return img.copy()
    h, w = img.shape
    src = img.astype(np.int64)[_reflect_101(h, r)][:, _reflect_101(w, r)]
    rows = sum(taps[i] * src[:, i:i + w] for i in range(n))
    acc = sum(taps[i] * rows[i:i + h] for i in range(n))
    return np.minimum((acc + 32768) >> 16, 255).astype(np.uint8)


def _area_table(src: int, dst: int, scale: float):
    """``computeResizeAreaTab``: (destination, source, float32 weight) per
    entry, destination by destination."""
    di, si, alpha = [], [], []
    for dx in range(dst):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            di.append(dx), si.append(s1 - 1), alpha.append((s1 - f1) / cell)
        for sx in range(s1, s2):
            di.append(dx), si.append(sx), alpha.append(1.0 / cell)
        if f2 - s2 > 1e-3:
            di.append(dx), si.append(s2), alpha.append(min(min(f2 - s2, 1.0), cell) / cell)
    di = np.array(di)
    rank = np.zeros_like(di)  # each entry's place among its destination's
    for k in range(1, di.size):
        rank[k] = rank[k - 1] + 1 if di[k] == di[k - 1] else 0
    return di, np.array(si), np.array(alpha, np.float32), rank


def area_resize_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)`` of a
    uint8 ``[H, W]`` image.  Bit for bit where both sides shrink (or stay);
    elsewhere :func:`resize_uint8`, within one uint8 step."""
    img = np.asarray(img)
    h, w = img.shape
    sx, sy = 1.0 / (out_w / w), 1.0 / (out_h / h)
    if sx < 1.0 or sy < 1.0:
        return resize_uint8(img[:, :, None], out_h, out_w)[:, :, 0]
    if (out_h, out_w) == (h, w):
        return img.copy()
    if w == 2 * out_w and h == 2 * out_h:
        s = img.astype(np.int32)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2) >> 2
                ).astype(np.uint8)
    src = img.astype(np.float32)
    xd, xs, xa, xr = _area_table(w, out_w, sx)
    buf = np.zeros((h, out_w), np.float32)
    for r in range(int(xr.max()) + 1):
        m = xr == r
        buf[:, xd[m]] = buf[:, xd[m]] + src[:, xs[m]] * xa[m]
    yd, ys, ya, yr = _area_table(h, out_h, sy)
    out = np.zeros((out_h, out_w), np.float32)
    for r in range(int(yr.max()) + 1):
        m = yr == r
        term = buf[ys[m]] * ya[m][:, None]
        out[yd[m]] = term if r == 0 else out[yd[m]] + term
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def jpeg_round_trip(img: np.ndarray, quality: int) -> np.ndarray:
    """A gray uint8 image encoded at ``quality`` and decoded again, as
    ``cv2.imencode`` then ``cv2.imdecode(..., IMREAD_GRAYSCALE)``."""
    data = native.jpeg_encode_gray(img, int(quality))
    return np.ascontiguousarray(native.jpeg_decode_u8(data)[:, :, 0])
