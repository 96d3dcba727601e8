"""Image files without OpenCV or PIL: PNG, BMP, JPEG, TIFF, WebP, GIF,
Netpbm, JPEG 2000, Sun raster, PFM and Radiance HDR decoding, header
probes and a PNG writer.

Counterpart of ``rcnn_ocr_tpu/data/transforms.py:imread_cv2``,
``imdecode_cv2``, ``image_size``, ``_exif_orientation`` and
``build_file_index``.  The decoders give what ``cv2.imread(path,
IMREAD_COLOR)`` followed by BGR -> RGB gives, as an RGB uint8 HWC array:

* PNG (:mod:`rcnn_ocr_tpu_torch.data.png`, zlib and numpy): bit depths
  1/2/4/8/16; gray, gray+alpha, RGB, RGBA and palette; plain or
  Adam7-interlaced; the chunk rules, CRCs and zlib stream as libpng's
  sequential reader under OpenCV checks them, and the ``eXIf`` chunk's
  orientation.  16-bit samples keep their high byte, gray samples under 8
  bits are scaled to 0..255, alpha and transparency are dropped (not
  composited).  PNG is lossless, so the pixels are bit-equal to cv2's.
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
  JPEGTables spliced in; planar YCbCr a plane a JPEG), SGI LogL and SGI
  LogLuv (32- and 24-bit); gray at 1, 8 and 16 bits (signed too), palette
  at 1, 4 and 8, RGB(A) at 8 and 16, CMYK at 8, YCbCr at any subsampling
  libtiff reads (with the predictor too), CIELab at 8 and 16, and the
  Orientation tag, as libtiff's RGBA reader under OpenCV turns them into
  8-bit RGB.  What cv2 gives ``None`` on raises ``ValueError`` naming it
  (floating-point and 32-bit samples, ICCLab and ITULab, the compressions
  OpenCV's libtiff lacks: LZMA, ZSTD, WebP, LERC, PixarLog, old-style
  JPEG).

* WebP (:mod:`rcnn_ocr_tpu_torch.data.webp`): lossy (VP8) and lossless
  (VP8L) bitstreams in the port's host C++ (``csrc/host/webp_decode.cpp``),
  VP8X files with ALPH (decoded and checked, its values dropped: the colour
  under alpha 0 comes out as coded) and animations (the first frame), as
  libwebp decodes them for OpenCV, turned by an ``EXIF`` chunk's
  orientation where libwebp's demuxer reads the file.
* GIF (:mod:`rcnn_ocr_tpu_torch.data.gif`): GIF87a / GIF89a, the first
  frame on the logical screen, global and local colour tables, interlace,
  transparency (the background colour shows), LZW in host C++
  (``csrc/host/gif_decode.cpp``), as OpenCV's own GIF reader gives it.
* Netpbm (:mod:`rcnn_ocr_tpu_torch.data.pnm`): PBM, PGM and PPM, ASCII and
  binary, with comments and any maxval, and PAM's gray, RGB and
  black-and-white tuple types, as OpenCV's readers give them.
* JPEG 2000 (:mod:`rcnn_ocr_tpu_torch.data.jpeg2000`): JP2 files and raw
  codestreams, the codestream in host C++ (``csrc/host/j2k_decode.cpp``)
  as OpenJPEG decodes it, HTJ2K (Part 15) code-blocks included, the JP2
  boxes and OpenCV's conversion in Python.
* Sun raster (:mod:`rcnn_ocr_tpu_torch.data.sunras`), PFM
  (:mod:`rcnn_ocr_tpu_torch.data.pfm`) and Radiance HDR
  (:mod:`rcnn_ocr_tpu_torch.data.hdr`), in numpy, as OpenCV's readers give
  them.

Of the formats OpenCV reads, AVIF raises :class:`UnsupportedImageFormat`
naming it by its magic (so do PAM's alpha tuple types, whose pixels
OpenCV's reader leaves to memory it never wrote).
EXIF orientation turns JPEG, PNG and WebP images as OpenCV turns them
(:mod:`rcnn_ocr_tpu_torch.data.exif`); OpenCV reads it from no other
container the port decodes (a JPEG 2000 ``uuid`` box of Exif is not
applied).  Bytes that no
decoder claims are no image cv2 reads either (an empty file, a download
cut inside a signature, a text file, OpenEXR, which this cv2 lacks): they
raise ``ValueError``, which the datasets quarantine as JAX's quarantine
what cv2 fails on.
``image_size`` reads the headers of PNG (IHDR's sides: like JAX's, it does
not turn them by ``eXIf`` as the decode does), BMP, GIF (the logical
screen), JPEG (through the SOF walk) and TIFF and BigTIFF (the first IFD,
whatever its compression, with orientations 5-8 swapping the sides as the
decode does) and decodes the others, as JAX's does.  :func:`png_encode`
writes 8-bit PNGs.
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.data import (bmp, gif, hdr, jpeg2000, pfm, png, pnm, sunras, tiff,
                                     webp)

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}
SUPPORTED = ("PNG, BMP, JPEG (8-bit sequential or progressive, lossless), JPEG 2000 (Part 1 "
             "and HTJ2K), "
             "WebP, GIF, Netpbm (PBM, PGM, PPM, PAM), Sun raster, PFM, Radiance HDR and TIFF "
             "(baseline and BigTIFF, CCITT fax, JPEG, YCbCr, CIELab, SGI LogL and LogLuv)")
# formats OpenCV reads and the port does not, by their magic bytes
_REFUSED = ((lambda d: d[4:12] in (b"ftypavif", b"ftypavis"), "AVIF"),)

_PNG_SIG = png.SIGNATURE
_TIFF_SIGS = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")  # TIFF and BigTIFF


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
        except (struct.error, IndexError) as err:
            raise ValueError(f"damaged TIFF data: {err}") from err
    decode = (png.decode if data.startswith(_PNG_SIG) else
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
