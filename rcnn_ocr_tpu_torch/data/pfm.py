"""PFM (portable float map) without OpenCV, to RGB uint8, pixel for pixel
as OpenCV's ``grfmt_pfm.cpp`` reads it under ``cv2.imdecode(buf,
IMREAD_COLOR)``.

* The header: ``PF`` (colour) or ``Pf`` (gray) and a line feed, then three fields, each the
  bytes up to the next whitespace byte (which is consumed, one byte only;
  a byte of 128 or more in a field is an error): the width and height as
  ``atoi`` reads them and the scale as ``atof`` reads it (a leading number,
  whatever follows it in the field).  The raster starts right after the
  byte that ended the scale.
* The scale's sign gives the byte order (negative little-endian, else
  big-endian); a scale of 0 (or one that reads as 0 or NaN) is an error.
  Every float is multiplied by ``float32(1 / |scale|)``.
* Rows are stored bottom-up, RGB; the raster must hold every row, and
  bytes after it are ignored.
* float32 -> uint8 as OpenCV's ``convertTo`` rounds: to nearest, ties to
  even, saturated to 0..255, except that NaN and values of 2**31 or more
  (infinities too) read 0, as ``cvRound`` gives ``INT_MIN`` for them.

``Pf`` (gray) reads alike, one float a pixel, the gray value on all three
channels: cv2 gives a one-channel array for it under ``IMREAD_COLOR``, and
the JAX path's BGR -> RGB conversion makes it three.  Sides are held to
OpenCV's size limit
(:mod:`~rcnn_ocr_tpu_torch.data.size_limit`).
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from rcnn_ocr_tpu_torch.data.size_limit import check_size

_SPACE = b" \t\n\v\f\r"
_FIELD_MAX = 2048  # OpenCV's read_number buffer: a longer field is cut there
_INT = re.compile(rb"[+-]?[0-9]+")
_FLOAT = re.compile(rb"[+-]?(?:0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)"
                    rb"(?:[pP][+-]?[0-9]+)?|(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
                    rb"|(?i:infinity|inf|nan(?:\([0-9A-Za-z_]*\))?))")
_TWO31 = np.float32(2.0 ** 31)


def _field(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The bytes up to the next whitespace byte, and the position after it."""
    end = pos
    while end - pos < _FIELD_MAX:
        if end >= len(data):
            raise ValueError("PFM header is truncated")
        c = data[end]
        if c >= 128:
            raise ValueError("PFM header holds a byte past ASCII")
        end += 1
        if c in _SPACE:
            return data[pos : end - 1], end
    return data[pos:end], end


def atoi32(field: bytes) -> int:
    """C's ``atoi`` on the start of ``field``: 0 without digits, else the
    value clamped to a long, then its low 32 bits as a signed int."""
    m = _INT.match(field)
    if m is None:
        return 0
    value = max(-(2 ** 63), min(2 ** 63 - 1, int(m.group())))  # strtol clamps to long
    return (value + 2 ** 31) % 2 ** 32 - 2 ** 31  # and atoi keeps its low 32 bits


def _atof(field: bytes) -> float:
    m = _FLOAT.match(field)
    if m is None:
        return 0.0
    text = m.group().decode()
    if "x" in text.lower():
        try:
            return float.fromhex(text)
        except OverflowError:  # strtod gives HUGE_VAL
            return float("-inf") if text.startswith("-") else float("inf")
    if "(" in text:
        return float("nan")
    return float(text)


def saturate_u8(values: np.ndarray) -> np.ndarray:
    """float32 -> uint8 as OpenCV's ``saturate_cast<uchar>(float)``: round
    half to even, clip to 0..255; NaN and values of 2**31 or more read 0."""
    bad = ~(values < _TWO31)  # NaN too
    return np.clip(np.rint(np.where(bad, 0, values)), 0, 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A PFM file -> RGB uint8 ``[H, W, 3]``; ``ValueError`` where OpenCV
    gives ``None`` or raises."""
    if data[:2] not in (b"PF", b"Pf") or data[2:3] != b"\n":
        raise ValueError("PFM header is damaged (expected PF or Pf and a line feed)")
    field, pos = _field(data, 3)
    width = atoi32(field)
    field, pos = _field(data, pos)
    height = atoi32(field)
    field, pos = _field(data, pos)
    scale = _atof(field)
    if width <= 0 or height <= 0:
        raise ValueError(f"PFM of {width}x{height} pixels is invalid")
    check_size(width, height, "PFM")
    if not abs(scale) > 0.0:
        raise ValueError(f"PFM scale {field!r} is 0")
    channels = 3 if data[1] == ord("F") else 1
    n = width * height * channels
    if len(data) < pos + 4 * n:
        raise ValueError("PFM data is truncated")
    order = "<" if scale < 0 else ">"
    img = np.frombuffer(data, order + "f4", n, pos).astype(np.float32)
    img = img.reshape(height, width, channels)
    with np.errstate(over="ignore", invalid="ignore"):
        factor = (np.float64(1.0) / np.float64(abs(scale))).astype(np.float32)
        img = saturate_u8(img[::-1] * factor)
    return img if channels == 3 else np.repeat(img, 3, axis=2)
