"""Image files without OpenCV or PIL: PNG, BMP and JPEG decoding, header
probes and a PNG writer.

Counterpart of ``rcnn_ocr_tpu/data/transforms.py:imread_cv2``,
``imdecode_cv2``, ``image_size``, ``_exif_orientation`` and
``build_file_index``.  The decoders give what ``cv2.imread(path,
IMREAD_COLOR)`` followed by BGR -> RGB gives, as an RGB uint8 HWC array:

* PNG (zlib and numpy): bit depths 1/2/4/8/16; gray, gray+alpha, RGB, RGBA
  and palette; plain or Adam7-interlaced; row filters None/Sub/Up/Average/
  Paeth.  16-bit samples keep their high byte, gray samples under 8 bits
  are scaled to 0..255 (1 -> 255, 2 -> 85 steps, 4 -> 17 steps), alpha and
  transparency are dropped (not composited).  PNG is lossless, so the
  pixels are bit-equal to cv2's.  None, Sub and Up rows are numpy
  (Sub as a wrapping cumulative sum); Average and Paeth rows depend on
  the pixel to their left, so they run as a loop over the row's bytes.
* BMP: 24- and 32-bit (alpha dropped) and 8-bit palette, bottom-up or
  top-down, uncompressed.
* JPEG: baseline and extended-sequential Huffman frames, 8-bit, gray or
  three components at any integral chroma subsampling, with restart
  markers and EXIF orientation, through the port's host C++
  (``csrc/host/jpeg_decode.cpp`` via :func:`rcnn_ocr_tpu_torch.native.
  jpeg_decode_u8`, built with g++ at first use): libjpeg-turbo's ISLOW IDCT,
  fancy upsampling and colour tables, so the pixels are bit-equal to cv2's.
  Frames with no DHT take the standard tables, and damaged entropy data
  decodes as libjpeg-turbo decodes it with warnings (bad codes, restart
  markers out of sequence).  Progressive, arithmetic-coded, lossless and
  12-bit frames and CMYK / YCCK images raise :class:`UnsupportedImageFormat`
  naming the variant; truncated data and damaged headers raise
  ``ValueError`` (cv2 returns ``None``).

Other formats (GIF, TIFF, ...) raise :class:`UnsupportedImageFormat`,
which names the supported ones; ``image_size`` still reads their headers
(JPEG's through the SOF walk, with EXIF orientations 5-8 swapping the
sides as the decode does).  :func:`png_encode` writes 8-bit PNGs.
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}
SUPPORTED = "PNG, BMP and baseline JPEG"

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


class UnsupportedImageFormat(NotImplementedError):
    """An image in a format this decoder does not read (a loud error: the
    datasets do not quarantine it as an unreadable sample)."""


def build_file_index(roots, exts=IMG_EXTS) -> Dict[str, List[str]]:
    """Recursive walk of image roots -> {lowercased basename: [paths]}."""
    if isinstance(roots, str):
        roots = [roots]
    index: Dict[str, List[str]] = defaultdict(list)
    for root in roots:
        if not root or not os.path.isdir(root):
            continue
        for dirpath, _, filenames in os.walk(root):
            for fn in filenames:
                if exts and os.path.splitext(fn)[1].lower() not in exts:
                    continue
                index[fn.lower()].append(os.path.join(dirpath, fn))
    return index


# --- PNG -------------------------------------------------------------------------------

def _unfilter(data: bytes, pos: int, h: int, stride: int, bpp: int) -> Tuple[np.ndarray, int]:
    """Undo the row filters of ``h`` scanlines of ``stride`` bytes starting at
    ``data[pos]``; returns the ``[h, stride]`` uint8 rows and the new position."""
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        if pos + 1 + stride > len(data):
            raise ValueError("PNG image data is truncated")
        ftype = data[pos]
        raw = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += 1 + stride
        if ftype == 0:
            cur = raw
        elif ftype == 1:  # Sub: a running sum mod 256 along each byte lane
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = raw + prev
        elif ftype in (3, 4):
            cur = np.frombuffer(_unfilter_left(ftype, bytearray(raw), prev.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out, pos


def _unfilter_left(ftype: int, c: bytearray, p: bytes, bpp: int) -> bytearray:
    """Average (3) or Paeth (4) in place on one row: each byte depends on the
    decoded byte ``bpp`` to its left, so this is a loop."""
    n = len(c)
    if ftype == 3:
        for i in range(min(bpp, n)):
            c[i] = (c[i] + (p[i] >> 1)) & 255
        for i in range(bpp, n):
            c[i] = (c[i] + ((c[i - bpp] + p[i]) >> 1)) & 255
        return c
    for i in range(min(bpp, n)):  # a = c = 0: the predictor is b
        c[i] = (c[i] + p[i]) & 255
    for i in range(bpp, n):
        a, b, cc = c[i - bpp], p[i], p[i - bpp]
        d_b, d_a = b - cc, a - cc  # |p - a| = |b - c|, |p - b| = |a - c|
        pa, pb, pc = abs(d_b), abs(d_a), abs(d_b + d_a)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = cc
        c[i] = (c[i] + pred) & 255
    return c


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines -> ``[h, width, channels]`` uint8 samples (16-bit
    samples keep their high byte; sub-byte samples are unpacked, unscaled)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, : width * channels].reshape(h, width, channels)
    if depth == 16:
        return rows[:, : width * channels * 2].reshape(h, width, channels, 2)[..., 0]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width].reshape(h, width, 1)


def _png_decode(data: bytes) -> np.ndarray:
    pos = len(_PNG_SIG)
    ihdr = plte = None
    idat: List[bytes] = []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("PNG chunk is truncated")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"PNG color type {ctype} / bit depth {depth} is invalid")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    channels = _PNG_CHANNELS[ctype]
    bits = channels * depth
    bpp = max(1, bits // 8)
    raw = zlib.decompress(b"".join(idat))
    img = np.empty((height, width, channels), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        rows, pos = _unfilter(raw, pos, ph, -(-pw * bits // 8), bpp)
        img[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    if ctype == 3:
        if int(img.max(initial=0)) >= len(plte):
            raise ValueError("PNG palette index out of range")
        return plte[img[:, :, 0]]
    if depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if channels <= 2:  # gray (+ alpha): the gray sample on all three channels
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


# --- BMP -------------------------------------------------------------------------------

def _bmp_decode(data: bytes) -> np.ndarray:
    offset = int.from_bytes(data[10:14], "little")
    dib = int.from_bytes(data[14:18], "little")
    if dib == 12:
        w, h = struct.unpack("<hh", data[18:22])
        bitcount, compression, n_colors, entry = int.from_bytes(data[24:26], "little"), 0, 0, 3
    else:
        w, h, _, bitcount, compression = struct.unpack("<iiHHI", data[18:34])
        n_colors, entry = int.from_bytes(data[46:50], "little"), 4
    if compression not in (0, 3) or (compression == 3 and bitcount != 32):
        raise ValueError(f"BMP compression {compression} is not supported")
    if bitcount not in (8, 24, 32):
        raise ValueError(f"BMP of {bitcount} bits per pixel is not supported")
    top_down, h, w = h < 0, abs(h), abs(w)
    stride = (w * bitcount + 31) // 32 * 4
    if offset + stride * h > len(data):
        raise ValueError("BMP pixel data is truncated")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bitcount == 8:
        n_colors = n_colors or 256
        start = 14 + dib
        palette = np.frombuffer(data, np.uint8, n_colors * entry, start).reshape(n_colors, entry)
        idx = rows[:, :w]
        if int(idx.max(initial=0)) >= n_colors:
            raise ValueError("BMP palette index out of range")
        bgr = palette[idx][:, :, :3]
    else:
        bgr = rows[:, : w * bitcount // 8].reshape(h, w, bitcount // 8)[:, :, :3]
    return np.ascontiguousarray(bgr[:, :, ::-1])


# --- public API ------------------------------------------------------------------------

def imdecode(data) -> np.ndarray:
    """Encoded image bytes -> RGB uint8 HWC (the counterpart of
    ``imdecode_cv2``).  Raises ``ValueError`` on damaged data and
    :class:`UnsupportedImageFormat` on a format or JPEG variant it does not
    decode."""
    data = bytes(data)
    if data.startswith(b"\xff\xd8"):
        from rcnn_ocr_tpu_torch.native import jpeg_decode_u8

        try:
            return jpeg_decode_u8(data)
        except NotImplementedError as err:
            raise UnsupportedImageFormat(
                f"cannot decode {err}: the PyTorch port decodes {SUPPORTED} images") from None
    decode = (_png_decode if data.startswith(_PNG_SIG) else
              _bmp_decode if data.startswith(b"BM") and len(data) >= 26 else None)
    if decode is not None:
        try:
            return decode(data)
        except (zlib.error, struct.error, IndexError) as err:
            raise ValueError(f"damaged image data: {err}") from err
    kind = ("GIF" if data[:6] in (b"GIF87a", b"GIF89a") else
            "TIFF" if data[:4] in (b"II*\x00", b"MM\x00*") else "an unknown format")
    raise UnsupportedImageFormat(
        f"cannot decode {kind}: the PyTorch port decodes {SUPPORTED} images")


def png_encode(img: np.ndarray) -> bytes:
    """An 8-bit PNG of a uint8 gray ``[H, W]`` (or ``[H, W, 1]``), RGB
    ``[H, W, 3]`` or RGBA ``[H, W, 4]`` array, channels stored as given,
    every row with filter None (the cheapest to decode: Average and Paeth
    rows cost :func:`imdecode` a Python loop over the row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"png_encode takes uint8 arrays, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        c, ctype = 1, 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        c, ctype = img.shape[2], {3: 2, 4: 6}[img.shape[2]]
    else:
        raise ValueError(f"png_encode takes [H, W], [H, W, 3] or [H, W, 4], got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def imread(path: str) -> np.ndarray:
    """Image file -> RGB uint8 HWC (the counterpart of ``imread_cv2``)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return imdecode(data)
    except UnsupportedImageFormat as err:
        raise UnsupportedImageFormat(f"{path}: {err}") from None


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) from the file header without decoding the pixels;
    formats whose header is not parsed here fall back to a decode."""
    with open(path, "rb") as f:
        head = f.read(32)
        if head.startswith(_PNG_SIG) and head[12:16] == b"IHDR":
            return int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big")
        if head.startswith(b"BM") and len(head) >= 26:
            # the 12-byte OS/2 core header stores int16 sides at 18/20,
            # every later header int32 at 18/22
            if int.from_bytes(head[14:18], "little") == 12:
                w = int.from_bytes(head[18:20], "little", signed=True)
                h = int.from_bytes(head[20:22], "little", signed=True)
            else:
                w = int.from_bytes(head[18:22], "little", signed=True)
                h = int.from_bytes(head[22:26], "little", signed=True)
            if w != 0 and h != 0:
                return abs(h), abs(w)
        elif head[:6] in (b"GIF87a", b"GIF89a"):
            return int.from_bytes(head[8:10], "little"), int.from_bytes(head[6:8], "little")
        elif head.startswith(b"\xff\xd8"):  # JPEG: walk the segments to the SOF
            f.seek(2)
            swap = False
            while True:
                seg = f.read(4)
                if len(seg) < 4 or seg[0] != 0xFF:
                    break
                marker, size = seg[1], int.from_bytes(seg[2:4], "big")
                if marker == 0xE1 and size > 8:  # APP1: maybe EXIF
                    if _exif_orientation(f.read(size - 2)) in (5, 6, 7, 8):
                        swap = True
                    continue
                if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                    sof = f.read(5)
                    h, w = int.from_bytes(sof[1:3], "big"), int.from_bytes(sof[3:5], "big")
                    return (w, h) if swap else (h, w)
                f.seek(size - 2, os.SEEK_CUR)
    img = imread(path)
    return img.shape[0], img.shape[1]


def _exif_orientation(app1: bytes) -> int:
    """EXIF orientation (tag 0x0112) from a JPEG APP1 body, 0 if absent or
    unparseable."""
    if not app1.startswith(b"Exif\x00\x00"):
        return 0
    tiff = app1[6:]
    order = {b"II": "little", b"MM": "big"}.get(tiff[:2])
    if order is None or len(tiff) < 8:
        return 0
    ifd0 = int.from_bytes(tiff[4:8], order)
    n = int.from_bytes(tiff[ifd0 : ifd0 + 2], order)
    for i in range(n):
        e = ifd0 + 2 + 12 * i
        if e + 10 > len(tiff):
            return 0
        if int.from_bytes(tiff[e : e + 2], order) == 0x0112:
            return int.from_bytes(tiff[e + 8 : e + 10], order)
    return 0
