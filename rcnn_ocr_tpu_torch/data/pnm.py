"""Netpbm without OpenCV: PBM, PGM and PPM (P1-P6) and PAM (P7), to RGB
uint8, pixel for pixel as OpenCV's ``grfmt_pxm.cpp`` and ``grfmt_pam.cpp``
read them under ``cv2.imdecode(buf, IMREAD_COLOR)``.

P1-P6:

* The header's numbers as OpenCV's ``ReadNumber`` reads them: whitespace
  and ``#`` comments (to the end of the line) skipped before each, digits
  up to the first other byte, which is consumed (any byte: a letter too);
  any other byte where a number should start is an error.  P1 and P4 have
  no maxval; the others take maxval 1-65535, and the raster starts right
  after the byte that ended it.
* ASCII rasters (P1, P2, P3) read their samples the same way; P1 reads one
  digit a sample (``0101`` is four), any non-zero digit black.  8-bit P2 and
  P3 samples are clamped to maxval and scaled to 0..255 (``v * 255 //
  maxval``); with maxval over 255 a sample is clamped and keeps its high
  byte, unscaled.  The last sample needs a byte after it, as ``ReadNumber``
  reads one (cv2 fails a P2 or P3 file that ends on a digit).
* Binary rasters (P4, P5, P6) are not scaled: 8-bit samples come raw (a
  value over maxval too), 16-bit ones (maxval over 255, big-endian) keep
  their high byte; P4 rows are packed bits, most significant first, padded
  to a byte.  Bytes after the raster are ignored.
* PBM's 1 is black and 0 white; gray is put on all three channels.

P7 (PAM): the header lines ``WIDTH``, ``HEIGHT``, ``DEPTH``, ``MAXVAL``
(each once, a number with an optional minus sign and nothing else),
``TUPLTYPE`` (the last one counts, an empty one is none) and ``ENDHDR``,
upper case,
``#`` comment lines and blank lines between them, lines ending at a CR or
an LF; the raster starts right after the CR or LF that ends ``ENDHDR``.
Without a ``TUPLTYPE``, depth 1 with maxval 1 is BLACKANDWHITE, depth 1 with
maxval under 256 GRAYSCALE, depth 3 with maxval under 256 RGB.  As OpenCV
gives them:

* GRAYSCALE (depth 1) and RGB (depth 3): raw samples (16-bit ones keep the
  high byte), RGB with its first and third samples swapped (OpenCV copies
  the tuples into its BGR image as they are);
* maxval 1 (BLACKANDWHITE, or any depth-1 or depth-3 tuple type): each row
  is ``width * depth`` bytes whose first ``ceil(width / 8)`` are read as
  packed bits, most significant first, 1 white and 0 black.

The alpha tuple types (GRAYSCALE_ALPHA, RGB_ALPHA, BLACKANDWHITE_ALPHA)
raise ``NotImplementedError`` naming them (``image_io`` turns it into
``UnsupportedImageFormat``): OpenCV's conversion of them reads
memory it never wrote, so no decoder can give its pixels.  Where OpenCV
fails (a damaged header, sides past OpenCV's size limit, a
tuple type it does not know or one that does not match the depth, a
raster short of its last row), ``ValueError``.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.data.size_limit import check_size

_SPACE = b" \t\n\v\f\r"
# one ReadNumber: whitespace and comments, digits, the byte that ends them (the
# digits are possessive: a number that ends the data does not match shorter)
_NUMBER = re.compile(rb"(?:[ \t\n\v\f\r]|#[^\n\r]*[\n\r])*([0-9]++)(?s:.)")
_DIGIT = re.compile(rb"(?:[ \t\n\v\f\r]|#[^\n\r]*[\n\r])*([0-9])")
_INT_MAX = 2 ** 31 - 1
_PAM_FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")
# tuple type -> depth; the alpha ones are refused (see the module docstring)
_TUPLES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"RGB": 3}
_ALPHA_TUPLES = (b"BLACKANDWHITE_ALPHA", b"GRAYSCALE_ALPHA", b"RGB_ALPHA")


def _number(data: bytes, pos: int) -> Tuple[int, int]:
    m = _NUMBER.match(data, pos)
    if m is None:
        raise ValueError("Netpbm number expected")
    value = int(m.group(1))
    if value > _INT_MAX:
        raise ValueError("Netpbm number too large")
    return value, m.end()


def _ascii_samples(data: bytes, pos: int, count: int, one_digit: bool) -> np.ndarray:
    """``count`` ASCII samples from ``pos`` on, as ``ReadNumber`` reads them."""
    values: List[int] = []
    pattern = _DIGIT if one_digit else _NUMBER
    for _ in range(count):
        m = pattern.match(data, pos)
        if m is None:
            raise ValueError("Netpbm raster is damaged or truncated")
        values.append(int(m.group(1)))
        pos = m.end()
    out = np.array(values, dtype=np.int64)
    if out.size and int(out.max()) > _INT_MAX:
        raise ValueError("Netpbm number too large")
    return out


def _binary(data: bytes, pos: int, size: int) -> np.ndarray:
    if pos + size > len(data):
        raise ValueError("Netpbm raster is truncated")
    return np.frombuffer(data, np.uint8, size, pos)


def _bits(rows: np.ndarray, width: int) -> np.ndarray:
    """Packed rows ``[h, >= ceil(width / 8)]`` -> ``[h, width]`` 0/1."""
    return np.unpackbits(rows[:, : (width + 7) // 8], axis=1)[:, :width]


def _pnm(data: bytes) -> np.ndarray:
    kind = data[1] - 48
    width, pos = _number(data, 2)
    height, pos = _number(data, pos)
    maxval = 1
    if kind not in (1, 4):
        maxval, pos = _number(data, pos)
    if width <= 0 or height <= 0 or maxval <= 0 or maxval > 65535:
        raise ValueError(f"Netpbm header is invalid ({width}x{height}, maxval {maxval})")
    check_size(width, height, "Netpbm image")
    channels = 3 if kind in (3, 6) else 1
    n = width * height * channels
    if kind == 1:
        black = _ascii_samples(data, pos, n, one_digit=True) != 0
        gray = np.where(black, 0, 255).astype(np.uint8).reshape(height, width)
    elif kind == 4:
        pitch = (width + 7) // 8
        rows = _binary(data, pos, pitch * height).reshape(height, pitch)
        gray = ((1 - _bits(rows, width)) * 255).astype(np.uint8)
    elif kind in (2, 3):
        vals = np.minimum(_ascii_samples(data, pos, n, one_digit=False), maxval)
        vals = vals * 255 // maxval if maxval < 256 else vals >> 8
        gray = vals.astype(np.uint8).reshape(height, width, channels)
    else:
        if maxval < 256:
            vals = _binary(data, pos, n)
        else:
            vals = _binary(data, pos, 2 * n)[0::2]
        gray = vals.reshape(height, width, channels)
    if gray.ndim == 2 or gray.shape[2] == 1:
        return np.repeat(gray.reshape(height, width, 1), 3, axis=2)
    return np.ascontiguousarray(gray)


def _pam_line(data: bytes, pos: int):
    """One header line as ``ReadPAMHeaderLine`` reads it -> (field or None
    for a blank or comment line, value, position after it)."""
    end = len(data)
    while pos < end and data[pos] in _SPACE:  # blank lines are skipped here too
        pos += 1
    if pos >= end:
        raise ValueError("PAM header is truncated")
    if data[pos] == 0x23:  # '#': a comment to the end of the line
        stop = min([i for i in (data.find(b"\n", pos), data.find(b"\r", pos)) if i >= 0],
                   default=-1)
        if stop < 0:
            raise ValueError("PAM header is truncated")
        return None, b"", stop + 1
    start = pos
    while pos < end and data[pos] not in _SPACE:
        pos += 1
    if pos >= end:
        raise ValueError("PAM header is truncated")
    ident = data[start:pos]
    if ident not in _PAM_FIELDS:
        raise ValueError(f"PAM header field {ident[:16]!r} is unknown")
    if data[pos] in b"\n\r":
        return ident, b"", pos + 1
    pos += 1
    while pos < end and data[pos] in _SPACE:
        pos += 1
    start = pos
    while pos < end and data[pos] not in b"\n\r":
        pos += 1
    if pos >= end:
        raise ValueError("PAM header is truncated")
    return ident, data[start:pos].rstrip(_SPACE), pos + 1


def _pam_number(value: bytes) -> int:
    """A header value as OpenCV parses it: an optional minus sign and
    digits, nothing else, within an ``int``."""
    if not re.fullmatch(rb"-?[0-9]+", value) or abs(int(value)) > _INT_MAX:
        raise ValueError(f"PAM header number {value[:16]!r} is invalid")
    return int(value)


def _pam(data: bytes) -> np.ndarray:
    if data[2] not in b"\n\r":
        raise ValueError("PAM magic is not followed by a line end")
    pos, fields, tupl = 3, {}, None
    while True:
        field, value, pos = _pam_line(data, pos)
        if field is None:
            continue
        if field == b"ENDHDR":
            break
        if field == b"TUPLTYPE":  # the last one counts; an empty one is none
            if value and value not in _TUPLES and value not in _ALPHA_TUPLES:
                raise ValueError(f"PAM tuple type {value[:32]!r} is unknown")
            tupl = value or None
            continue
        if field in fields:
            raise ValueError(f"PAM header repeats {field.decode()}")
        fields[field] = _pam_number(value)
    if len(fields) < 4:
        raise ValueError("PAM header lacks a field")
    width, height = fields[b"WIDTH"], fields[b"HEIGHT"]
    depth, maxval = fields[b"DEPTH"], fields[b"MAXVAL"]
    if maxval > 65535 or width <= 0 or height <= 0:  # (OpenCV raises on sides <= 0)
        raise ValueError(f"PAM header is invalid ({width}x{height}, maxval {maxval})")
    check_size(width, height, "PAM image")
    if tupl in _ALPHA_TUPLES:
        raise NotImplementedError(f"PAM with tuple type {tupl.decode()}")
    if tupl is None:
        if depth == 1 and maxval < 256:
            tupl = b"GRAYSCALE"
        elif depth == 3 and maxval < 256:
            tupl = b"RGB"
        else:
            raise ValueError(f"PAM depth {depth} at maxval {maxval} needs a tuple type")
    if depth != _TUPLES[tupl]:
        raise ValueError(f"PAM tuple type {tupl.decode()} does not take depth {depth}")
    sample = 2 if maxval > 255 else 1
    row = width * depth * sample
    raw = _binary(data, pos, row * height).reshape(height, row)
    if maxval == 1:
        white = _bits(raw, width)
        return np.repeat((white * 255).astype(np.uint8)[:, :, None], 3, axis=2)
    vals = raw[:, 0::2] if sample == 2 else raw
    vals = vals.reshape(height, width, depth)
    if depth == 1:
        return np.repeat(vals, 3, axis=2)
    return np.ascontiguousarray(vals[:, :, ::-1])


def decode(data: bytes) -> np.ndarray:
    """A PBM / PGM / PPM / PAM file -> RGB uint8 ``[H, W, 3]``, as
    ``cv2.imdecode(data, IMREAD_COLOR)`` then BGR -> RGB gives it;
    ``ValueError`` where OpenCV gives ``None``."""
    if len(data) < 3:
        raise ValueError("Netpbm file is truncated")
    return _pam(data) if data[1] == 0x37 else _pnm(data)
