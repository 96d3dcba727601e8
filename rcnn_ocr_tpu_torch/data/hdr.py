"""Radiance HDR (RGBE) without OpenCV, to RGB uint8, pixel for pixel as
OpenCV's ``grfmt_hdr.cpp`` and ``rgbe.cpp`` read it under
``cv2.imdecode(buf, IMREAD_COLOR)``.

* The header, read line by line as ``fgets`` reads it into 128 bytes (a
  line of 127 bytes or more is read in pieces; a line holding a NUL byte
  ends there as a C string, one starting with NUL is skipped as any other):
  lines are skipped, the ``#?RADIANCE`` or ``#?RGBE`` one too, up to the
  line ``FORMAT=32-bit_rle_rgbe`` (an empty line before it is an error,
  so ``32-bit_rle_xyze`` files fail); then an empty line; then
  the size line as ``sscanf(line, "-Y %d +X %d")`` reads it (any other
  orientation is an error).  The pixels start after the size line.
* Pixels as ``RGBE_ReadPixels_RLE`` reads them: widths under 8 or over
  0x7fff are flat (4 bytes a pixel, no padding); otherwise each scanline
  starts ``2 2`` and its 16-bit width, then its four channels as runs
  (a count over 128 repeats the next byte count - 128 times, another
  count of 1 to 128 copies that many bytes; a count of 0, or one past
  the channel's end, is an error).  A scanline that does not start
  ``2 2`` (or whose third byte has its top bit set) makes the rest of the
  image flat, that scanline's 4 bytes its next pixel.  Bytes after the
  last pixel are ignored.
* A pixel (r, g, b, e) reads ``c * 2 ** (e - 136)`` a channel (0 where
  ``e`` is 0), times 255, rounded half to even and saturated to 0..255;
  values of 2**31 or more read 0, as OpenCV's ``cvRound`` gives ``INT_MIN``
  for them.  Every step is exact in float64, so it gives float32's values.

Sides are held to OpenCV's size limit
(:mod:`~rcnn_ocr_tpu_torch.data.size_limit`).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.data.pfm import atoi32, saturate_u8
from rcnn_ocr_tpu_torch.data.size_limit import check_size

SIGNATURES = (b"#?RADIANCE", b"#?RGBE")
_FGETS = 128
_SIZE = re.compile(rb"-Y[ \t\n\v\f\r]*[ \t\n\v\f\r]*([+-]?[0-9]+)[ \t\n\v\f\r]*\+X"
                   rb"[ \t\n\v\f\r]*([+-]?[0-9]+)")


def _fgets(data: bytes, pos: int) -> Tuple[Optional[bytes], int]:
    """One ``fgets(buf, 128, fp)``: the bytes up to and with the next line
    feed, at most 127 of them, as a C string (cut at a NUL), and the new
    position; ``None`` at the end of the data."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + _FGETS - 1)
    end = min(len(data), pos + _FGETS - 1) if end < 0 else end + 1
    line = data[pos:end]
    nul = line.find(b"\0")
    return (line if nul < 0 else line[:nul]), end


def _header(data: bytes) -> Tuple[int, int, int]:
    """(width, height, position of the pixels)."""
    line, pos = _fgets(data, 0)
    while True:
        if line is None:
            raise ValueError("Radiance HDR header is truncated")
        if line[:1] == b"\n":
            raise ValueError("Radiance HDR has no FORMAT=32-bit_rle_rgbe line")
        if line == b"FORMAT=32-bit_rle_rgbe\n":
            break
        line, pos = _fgets(data, pos)
    line, pos = _fgets(data, pos)
    if line != b"\n":
        raise ValueError("Radiance HDR has no blank line after its FORMAT line")
    line, pos = _fgets(data, pos)
    m = _SIZE.match(line or b"")
    if m is None:
        raise ValueError("Radiance HDR has no -Y N +X M size line")
    return atoi32(m.group(2)), atoi32(m.group(1)), pos


def _rle_scanline(data: bytes, pos: int, width: int, out: np.ndarray) -> int:
    """Four channels of runs into ``out`` ``[4, width]``; the new position."""
    for c in range(4):
        row = out[c]
        x = 0
        while x < width:
            if pos + 2 > len(data):
                raise ValueError("Radiance HDR data is truncated")
            count, value = data[pos], data[pos + 1]
            pos += 2
            if count > 128:
                count -= 128
                if count > width - x:
                    raise ValueError("Radiance HDR scanline run is too long")
                row[x : x + count] = value
                x += count
                continue
            if count == 0 or count > width - x:
                raise ValueError("Radiance HDR scanline data is damaged")
            row[x] = value
            if count > 1:
                if pos + count - 1 > len(data):
                    raise ValueError("Radiance HDR data is truncated")
                row[x + 1 : x + count] = np.frombuffer(data, np.uint8, count - 1, pos)
                pos += count - 1
            x += count
    return pos


def _rgbe(data: bytes, pos: int, width: int, height: int) -> np.ndarray:
    """The ``[height * width, 4]`` RGBE bytes as ``RGBE_ReadPixels_RLE``
    reads them (memory is taken only as the data fills it)."""
    total = width * height
    lines = []
    if 8 <= width <= 0x7FFF:
        while len(lines) < height:
            if pos + 4 > len(data):
                raise ValueError("Radiance HDR data is truncated")
            head = data[pos : pos + 4]
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                break  # not run-length encoded: the rest is flat
            if (head[2] << 8 | head[3]) != width:
                raise ValueError("Radiance HDR scanline has the wrong width")
            scan = np.empty((4, width), np.uint8)
            pos = _rle_scanline(data, pos + 4, width, scan)
            lines.append(scan.T)
    need = 4 * (total - width * len(lines))
    if pos + need > len(data):
        raise ValueError("Radiance HDR data is truncated")
    lines.append(np.frombuffer(data, np.uint8, need, pos).reshape(-1, 4))
    return np.concatenate(lines)


def decode(data: bytes) -> np.ndarray:
    """A Radiance HDR file -> RGB uint8 ``[H, W, 3]``; ``ValueError`` where
    OpenCV gives ``None``."""
    width, height, pos = _header(data)
    if width <= 0 or height <= 0:
        raise ValueError(f"Radiance HDR of {width}x{height} pixels is invalid")
    check_size(width, height, "Radiance HDR")
    px = _rgbe(data, pos, width, height)
    e = px[:, 3].astype(np.int64)
    scale = np.where(e > 0, np.ldexp(255.0, e - 136), 0.0)
    return saturate_u8(px[:, :3] * scale[:, None]).reshape(height, width, 3)
