"""Sun raster without OpenCV, to RGB uint8, pixel for pixel as OpenCV's
``grfmt_sunras.cpp`` reads it under ``cv2.imdecode(buf, IMREAD_COLOR)``.

The 32-byte big-endian header: magic ``59 a6 6a 95``, width, height and
depth (signed; sides above 0, depth 1, 8, 24 or 32), a length field that
is ignored, the type, the colormap type and its length.  What OpenCV reads:

* Types old (0) and standard (1), which read alike.  OpenCV's header check
  accepts the byte-encoded (2, RLE) and RGB-format (3) types by testing a
  field that never holds them, so cv2 reads no file of either type: they
  raise ``ValueError`` here too.
* No colormap (type 0, length 0), or an equal-RGB one (type 1) of at most
  ``3 << depth`` bytes on a 1- or 8-bit raster: ``length // 3`` entries,
  the red plane, then green, then blue; the raster starts right after the
  map (a trailing byte of a length not divisible by 3 is skipped), and an
  index past the map reads black.  Without a map a 1-bit raster reads 0 as
  black and 1 as white, an 8-bit one as gray.
* Rows are padded to 16 bits; 1-bit rows pack the leftmost pixel in the
  most significant bit; 24-bit pixels are B, G, R and 32-bit ones a pad
  byte then B, G, R.  The raster must hold every padded row (the last
  one's pad too); bytes after it are ignored.
* Sides are held to OpenCV's size limit
  (:mod:`~rcnn_ocr_tpu_torch.data.size_limit`).
"""

from __future__ import annotations

import struct

import numpy as np

from rcnn_ocr_tpu_torch.data.size_limit import check_size

MAGIC = b"\x59\xa6\x6a\x95"
_RMT_NONE, _RMT_EQUAL_RGB = 0, 1


def decode(data: bytes) -> np.ndarray:
    """A Sun raster file -> RGB uint8 ``[H, W, 3]``; ``ValueError`` where
    OpenCV gives ``None``."""
    if len(data) < 32 or not data.startswith(MAGIC):
        raise ValueError("Sun raster header is truncated")
    width, height, depth, _, kind, maptype, maplength = struct.unpack_from(">iiiIiii", data, 4)
    if width <= 0 or height <= 0 or depth not in (1, 8, 24, 32):
        raise ValueError(f"Sun raster of {width}x{height} at depth {depth} is invalid")
    if kind not in (0, 1):
        raise ValueError(f"Sun raster type {kind}: OpenCV reads types 0 and 1 only")
    palsize = 3 << depth if depth <= 8 else 0
    if not ((maptype == _RMT_NONE and maplength == 0)
            or (maptype == _RMT_EQUAL_RGB and 0 < maplength <= palsize)):
        raise ValueError(f"Sun raster colormap type {maptype} of {maplength} bytes is invalid")
    check_size(width, height, "Sun raster")
    pos = 32 + maplength
    pitch = ((width * depth + 7) // 8 + 1) & ~1
    if len(data) < pos + pitch * height:
        raise ValueError("Sun raster data is truncated")
    rows = np.frombuffer(data, np.uint8, pitch * height, pos).reshape(height, pitch)
    if depth == 24:
        return np.ascontiguousarray(rows[:, : 3 * width].reshape(height, width, 3)[:, :, ::-1])
    if depth == 32:
        return np.ascontiguousarray(rows[:, : 4 * width].reshape(height, width, 4)[:, :, :0:-1])
    if depth == 1:
        idx = np.unpackbits(rows, axis=1)[:, :width]
    else:
        idx = rows[:, :width]
    palette = np.zeros((256, 3), np.uint8)
    if maptype == _RMT_EQUAL_RGB:
        n = maplength // 3
        planes = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        palette[:n] = planes.T
    elif depth == 1:
        palette[1] = 255
    else:
        palette[:] = np.arange(256, dtype=np.uint8)[:, None]
    return palette[idx]
