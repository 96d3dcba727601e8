"""Image files without OpenCV or PIL: PNG, BMP, JPEG, TIFF, WebP, GIF,
Netpbm, JPEG 2000, Sun raster, PFM and Radiance HDR decoding, header
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
* BMP (:mod:`rcnn_ocr_tpu_torch.data.bmp`): every BMP OpenCV reads, as
  its ``grfmt_bmp.cpp`` reads it: 1-, 4- and 8-bit palettes, 16-bit 5-5-5
  and 5-6-5, 24-bit, 32-bit (BI_BITFIELDS masks scaled as OpenCV 5 scales
  them), RLE8 and RLE4 with every escape code, the OS/2 core header and
  headers of 40 to 124 bytes, bottom-up or top-down.
* JPEG: 8-bit sequential (baseline and extended) and progressive frames,
  Huffman or arithmetic-coded (with DAC conditioning), gray, YCbCr / RGB
  at any integral chroma subsampling, and CMYK / YCCK (Adobe-inverted, as
  OpenCV converts them), and lossless frames (SOF3: predictors 1-7, the
  point transform, precisions 2-8, RGB and CMYK, as libjpeg-turbo 3
  decodes them), with restart markers and EXIF orientation,
  through the port's host C++ (``csrc/host/jpeg_decode.cpp`` via
  :func:`rcnn_ocr_tpu_torch.native.jpeg_decode_u8`, built with g++ at
  first use): libjpeg-turbo's ISLOW IDCT, block smoothing of progressive
  streams cut short, fancy upsampling and colour tables, so the pixels are
  bit-equal to cv2's.  Frames with no DHT take the standard tables, and
  damaged entropy data decodes as libjpeg-turbo decodes it with warnings
  (bad codes, restart markers out of sequence).  What cv2 gives ``None``
  on raises ``ValueError`` naming it: hierarchical, 12-bit and
  arithmetic-coded lossless frames, DNL heights, lossless gray, YCbCr and
  YCCK frames (libjpeg-turbo converts no lossless frame), truncated data
  and damaged headers.
* TIFF (:mod:`rcnn_ocr_tpu_torch.data.tiff`): the first page of a TIFF or
  BigTIFF, II or MM, strips or tiles, chunky or planar; uncompressed,
  PackBits, LZW (old-style too) and the CCITT fax codings (modified
  Huffman, RLEW, Group 3 1-D / 2-D, Group 4; host C++), Deflate, with the
  horizontal predictor, JPEG (through the host JPEG decoder with the
  JPEGTables spliced in; planar YCbCr a plane a JPEG) and SGI LogL; gray
  at 1, 8 and 16 bits (signed too), palette at 1, 4 and 8, RGB(A) at 8
  and 16, CMYK at 8, YCbCr at any subsampling libtiff reads, CIELab at 8
  and 16, and the Orientation tag, as libtiff's RGBA reader under OpenCV
  turns them into 8-bit RGB.  What cv2 gives ``None`` on raises
  ``ValueError`` naming it (floating-point and 32-bit samples, ICCLab and
  ITULab, the compressions OpenCV's libtiff lacks: LZMA, ZSTD, WebP, LERC,
  PixarLog, old-style JPEG); SGI LogLuv at 8 or 16 bits, which cv2 reads,
  raises :class:`UnsupportedImageFormat`.

* WebP (:mod:`rcnn_ocr_tpu_torch.data.webp`): lossy (VP8) and lossless
  (VP8L) bitstreams in the port's host C++ (``csrc/host/webp_decode.cpp``),
  VP8X files with ALPH (decoded and checked, its values dropped: the colour
  under alpha 0 comes out as coded) and animations (the first frame), as
  libwebp decodes them for OpenCV.
* GIF (:mod:`rcnn_ocr_tpu_torch.data.gif`): GIF87a / GIF89a, the first
  frame on the logical screen, global and local colour tables, interlace,
  transparency (the background colour shows), LZW in host C++
  (``csrc/host/gif_decode.cpp``), as OpenCV's own GIF reader gives it.
* Netpbm (:mod:`rcnn_ocr_tpu_torch.data.pnm`): PBM, PGM and PPM, ASCII and
  binary, with comments and any maxval, and PAM's gray, RGB and
  black-and-white tuple types, as OpenCV's readers give them.
* JPEG 2000 (:mod:`rcnn_ocr_tpu_torch.data.jpeg2000`): JP2 files and raw
  codestreams, the codestream in host C++ (``csrc/host/j2k_decode.cpp``)
  as OpenJPEG decodes it, the JP2 boxes and OpenCV's conversion in Python;
  HT (Part 15) code-blocks raise :class:`UnsupportedImageFormat`.
* Sun raster (:mod:`rcnn_ocr_tpu_torch.data.sunras`), PFM
  (:mod:`rcnn_ocr_tpu_torch.data.pfm`) and Radiance HDR
  (:mod:`rcnn_ocr_tpu_torch.data.hdr`), in numpy, as OpenCV's readers give
  them.

Of the formats OpenCV reads, AVIF raises :class:`UnsupportedImageFormat`
naming it by its magic (so do PAM's alpha tuple types, whose pixels
OpenCV's reader leaves to memory it never wrote, HTJ2K code-blocks, SGI
LogLuv TIFFs and the predictor on subsampled YCbCr TIFF).  Bytes that no
decoder claims are no image cv2 reads either (an empty file, a download
cut inside a signature, a text file, OpenEXR, which this cv2 lacks): they
raise ``ValueError``, which the datasets quarantine as JAX's quarantine
what cv2 fails on.
``image_size`` reads the headers of PNG, BMP, GIF (the logical screen),
JPEG (through the SOF walk) and TIFF and BigTIFF (the first IFD, whatever its
compression, with orientations 5-8 swapping the sides as the decode does)
and decodes the others, as JAX's does.  :func:`png_encode` writes 8-bit
PNGs.
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.data import bmp, gif, hdr, jpeg2000, pfm, pnm, sunras, tiff, webp
from rcnn_ocr_tpu_torch.data.size_limit import PNG_MAX_SIDE, check_size

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}
SUPPORTED = ("PNG, BMP, JPEG (8-bit sequential or progressive, lossless), JPEG 2000 (Part 1), "
             "WebP, GIF, Netpbm (PBM, PGM, PPM, PAM), Sun raster, PFM, Radiance HDR and TIFF "
             "(baseline and BigTIFF, CCITT fax, JPEG, YCbCr, CIELab, SGI LogL)")
# formats OpenCV reads and the port does not, by their magic bytes
_REFUSED = ((lambda d: d[4:12] in (b"ftypavif", b"ftypavis"), "AVIF"),)

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_TIFF_SIGS = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")  # TIFF and BigTIFF
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
    check_size(width, height, "PNG", max_side=PNG_MAX_SIDE)
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


# --- public API ------------------------------------------------------------------------

def imdecode(data) -> np.ndarray:
    """Encoded image bytes -> RGB uint8 HWC (the counterpart of
    ``imdecode_cv2``).  Raises ``ValueError`` on damaged data and on bytes
    that are no image cv2 reads, and :class:`UnsupportedImageFormat` on a
    format or variant cv2 reads and the port does not decode."""
    data = bytes(data)
    if data.startswith(b"\xff\xd8"):
        from rcnn_ocr_tpu_torch.native import jpeg_decode_u8

        return jpeg_decode_u8(data)
    if data[:4] in _TIFF_SIGS:
        try:
            return tiff.decode(data)
        except NotImplementedError as err:
            raise UnsupportedImageFormat(
                f"cannot decode {err}: the PyTorch port decodes {SUPPORTED} images") from None
        except (struct.error, IndexError) as err:
            raise ValueError(f"damaged TIFF data: {err}") from err
    decode = (_png_decode if data.startswith(_PNG_SIG) else
              bmp.decode if data.startswith(b"BM") else
              webp.decode if data[:4] == b"RIFF" and data[8:12] == b"WEBP" else
              gif.decode if data[:6] in (b"GIF87a", b"GIF89a") else
              pnm.decode if _is_pnm(data) else
              jpeg2000.decode if jpeg2000.is_jpeg2000(data) else
              sunras.decode if data.startswith(sunras.MAGIC) else
              pfm.decode if data[:2] in (b"PF", b"Pf") else
              hdr.decode if data.startswith(hdr.SIGNATURES) else None)
    if decode is not None:
        try:
            return decode(data)
        except NotImplementedError as err:  # a variant refused by name (PAM's alpha types)
            raise UnsupportedImageFormat(
                f"cannot decode {err}: the PyTorch port decodes {SUPPORTED} images") from None
        except (zlib.error, struct.error, IndexError) as err:
            raise ValueError(f"damaged image data: {err}") from err
    kind = next((name for match, name in _REFUSED if match(data)), None)
    if kind is None:  # cv2 gives None too: a damaged sample, not a format to port
        raise ValueError(f"not an image cv2 reads: {_describe(data)}")
    raise UnsupportedImageFormat(
        f"cannot decode {kind}: the PyTorch port decodes {SUPPORTED} images")


def _describe(data: bytes) -> str:
    if not data:
        return "an empty file"
    return f"{len(data)} bytes starting {data[:8]!r}"


def _is_pnm(data: bytes) -> bool:
    """``P1``-``P7`` followed by whitespace, as OpenCV recognises Netpbm."""
    return len(data) >= 3 and data[0] == 0x50 and 0x31 <= data[1] <= 0x37 and data[2:3].isspace()


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
        elif head[:4] in _TIFF_SIGS:  # the first IFD, orientations 5-8 swapping
            f.seek(0)
            try:
                return tiff.size(f.read())
            except (ValueError, struct.error):
                pass  # a damaged header: the decode below raises
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
