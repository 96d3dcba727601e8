"""Baseline TIFF without libtiff: the first page of a TIFF file to RGB uint8.

The port's counterpart of what ``cv2.imdecode(buf, IMREAD_COLOR)`` gives
for a TIFF (OpenCV reads it through libtiff's RGBA interface,
``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``, then applies the Orientation
tag), pixel for pixel:

* the header and the first IFD in ``struct``: II and MM byte order, TIFF
  and BigTIFF (8-byte offsets and counts, 20-byte IFD entries, the LONG8,
  SLONG8 and IFD8 types), strips or tiles, PlanarConfiguration 1 (chunky)
  and 2 (planar), later pages ignored;
* compression: none, PackBits (32773), LZW (5, in the port's host C++:
  ``csrc/host/tiff_decode.cpp``; also the old style of writers before TIFF
  6.0, least significant bit first, as libtiff's LZWDecodeCompat reads it
  when the first strip or tile starts so), Deflate (8 and 32946, through
  ``zlib``);
  the horizontal Predictor (2) on LZW and Deflate data, 8 and 16 bits (as
  in libtiff, none and PackBits ignore the tag); FillOrder 2;
* CCITT fax (1-bit samples, host C++ as libtiff's tif_fax3.c decodes
  them): modified Huffman (2) and RLEW (32771), Group 3 (3) in 1-D or, by
  T4Options bit 0, 2-D (EOLs byte-aligned or not), Group 4 (4); black runs
  decode to 1 bits, which MinIsWhite and MinIsBlack then map to 0 / 255;
* JPEG (7): each strip or tile through the host JPEG decoder with the
  JPEGTables tag (347) spliced in front, as libtiff has libjpeg decode it:
  gray and RGB with no colour conversion, YCbCr (photometric 6) to RGB with
  libjpeg's fancy upsampling (JPEGCOLORMODE_RGB, as the RGBA reader sets
  it); the luma sampling from YCbCrSubsampling, else the first strip's; a
  last strip coded at full RowsPerStrip height is cropped, tiles cropped
  at the image's edge; planar YCbCr (YCbCrSubsampling 1x1, the only planar
  case of libtiff's RGBA reader) a one-component JPEG a plane, its samples
  converted as YCbCr without JPEG is;
* YCbCr without JPEG (8 bits, 3 samples): data units of YCbCrSubsampling
  (530, default 2x2) luma samples then Cb and Cr, each pixel its unit's
  chroma, converted with tif_color.c's fixed-point tables built in float32
  from YCbCrCoefficients (529) and ReferenceBlackWhite (532) or their
  defaults; 4x4, 4x2, 4x1, 2x2, 2x1, 1x2 and 1x1 (libtiff's RGBA reader
  has no other), planar only at 1x1; the horizontal predictor undone on
  the data-unit bytes as libtiff undoes it, where it does
  (``_ycbcr_predictor``); two libtiff quirks kept: a strip is
  read as TIFFScanlineSize's whole rows (a 4x4 row of an odd number of
  units loses its last two bytes, read as zeros) and a right-edge 4x4
  tile's block rows are stepped 10 bytes a skipped unit, not 18;
* CIELab (photometric 8), 8-bit L with signed a* and b* or all 16-bit,
  chunky: tif_color.c's TIFFCIELab16ToXYZ and TIFFXYZToRGB over the
  display_sRGB tables and the WhitePoint tag (default D50), in float32 in
  libtiff's order of operations;
* SGI LogL (compression 34676 on photometric LogL, host C++ as libtiff's
  LogL16Decode reads it a row at a time), each 16-bit log luminance to
  8-bit gray as L16toGry takes it, ``256 * sqrt(Y)``;
* SGI LogLuv (photometric 32845, chunky, 3 samples of 1, 8 or 16 bits) as
  the RGBA reader has the codec give it, SGILOGDATAFMT_8BIT: LogLuv32
  (34676, four run-length byte planes a row, host C++ as LogLuvDecode32)
  through LogLuv32toXYZ, LogLuv24 (34677, three bytes a pixel) through
  LogLuv24toXYZ and uv_decode's table of 163 rows (``_UV_ROWS``, read back
  from cv2's pixels of all 2**24 codes), then XYZtoRGB24, in the C code's
  double arithmetic with XYZ rounded to float (``_luv_rgb``);
* samples as libtiff's ``tif_getimage.c`` turns them into 8-bit RGB
  (signed integer samples as their unsigned bits, as libtiff reads them):
  MinIsBlack / MinIsWhite at 1, 8 and 16 bits (16 bits: the high byte),
  palette at 1, 4 and 8 bits (a colour map with any entry over 255 is
  shifted right by 8, else taken as 8-bit values, libtiff's ``checkcmap``),
  RGB at 8 and 16 bits (16 bits: ``(v + 128) // 257``), CMYK at 8 bits;
  an unassociated alpha (ExtraSamples 2) premultiplies RGB,
  ``(v * a + 127) // 255``, and any other alpha is dropped; chunky gray
  drops its alpha, planar gray is read as RGB (16 bits rounded, an
  unassociated alpha premultiplied); a right-edge tile of 16-bit gray, or
  of gray with alpha, is read at libtiff's skewed row step (``_skewed``);
* Orientation (tag 274) as OpenCV applies it: 2 flips the columns, 3 both
  axes, 4 the rows, 5-8 transpose first and then flip as 1-4 do; in a tiled
  file libtiff mirrors 2, 3, 6 and 7 within each tile (``_orient``).

Where OpenCV or libtiff fail, ``ValueError``, as
``cv2.imdecode`` gives ``None``, checked before the compression as OpenCV's
``TiffDecoder::readHeader`` and libtiff's ``TIFFRGBAImageOK`` check them:
floating-point, untyped and complex samples, 32- and 64-bit samples,
photometric interpretations the RGBA reader lacks (ICCLab, ITULab, colour
filter arrays and the rest), gray or RGB at 2 or 4 bits (NeXT and
ThunderScan among them), palette at 2 or 16 bits, RGB at other depths,
CIELab planar or with other sample counts, LogLuv at 32 bits; then the
compressions OpenCV's libtiff lacks (old-style JPEG 6, LZMA, ZSTD, WebP,
LERC, PixarLog, JBIG); YCbCr subsampled 2x4 or 1x4,
planar YCbCr JPEG without 1x1 subsampling, uncompressed tiles whose size
is not a multiple of 1 KiB, damaged or truncated data.  One deliberate
divergence: damaged compressed data raises, and so do strips of an
unknown compression, where libtiff's RGBA reader, which does not stop on
a strip that fails, gives OpenCV what it decoded (or its buffer as it
was); so does damaged fax data (a bad code word, a
row whose runs miss the width, data that ends before the last row, the
uncompressed-mode extension), where libtiff's fax decoder warns and fills
the rest of the row (its RLEW and modified-Huffman readers do so on some
rows of valid data too: the bits left in the accumulator at a strip's end
misplace the alignment).
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.data.size_limit import check_size

_FORMATS = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i",
            10: "ii", 11: "f", 12: "d"}
_BIG_FORMATS = {**_FORMATS, 16: "Q", 17: "q", 18: "Q"}  # BigTIFF's LONG8, SLONG8, IFD8
# none, LZW, Deflate, PackBits, old Deflate; the CCITT fax codings; JPEG
# (SGI LogL, 34676, only on PhotometricInterpretation LogL)
_DECODED = (1, 5, 8, 32773, 32946, 2, 3, 4, 32771, 7)
_FAX = (2, 3, 4, 32771)
_COMPRESSION = {6: "old-style JPEG", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP",
                34887: "LERC", 32909: "PixarLog", 34661: "JBIG", 32766: "NeXT",
                32809: "ThunderScan", 34676: "SGI LogL", 34677: "SGI LogLuv"}
_PHOTOMETRIC = {4: "transparency mask", 9: "ICCLab", 10: "ITULab", 32803: "colour filter array",
                34892: "linear raw"}
_SAMPLE_FORMAT = {2: "signed-integer", 3: "floating-point", 4: "untyped", 5: "complex integer",
                  6: "complex floating-point"}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _header(data: bytes) -> Tuple[str, int, bool]:
    """Byte order, the first IFD's offset and whether the file is a
    BigTIFF (magic 43: 8-byte offsets, counts and IFD entry values)."""
    if len(data) < 8:
        raise ValueError("TIFF header is truncated")
    order = {b"II": "<", b"MM": ">"}[bytes(data[:2])]
    (magic,) = struct.unpack_from(order + "H", data, 2)
    if magic == 43:
        if len(data) < 16:
            raise ValueError("BigTIFF header is truncated")
        width, zero, offset = struct.unpack_from(order + "HHQ", data, 4)
        if width != 8 or zero != 0:
            raise ValueError(f"BigTIFF offsets of {width} bytes")
        return order, offset, True
    if magic != 42:
        raise ValueError(f"TIFF magic number {magic} is not 42")
    return order, struct.unpack_from(order + "I", data, 4)[0], False


def _tags(data: bytes, order: str, offset: int, big: bool = False) -> Dict[int, tuple]:
    """The first IFD's tags -> their values (unknown field types skipped,
    as libtiff skips them); a BigTIFF's IFD has an 8-byte count and
    20-byte entries whose values fit in 8 bytes before an offset."""
    count_fmt, entry_size, inline, formats = ("Q", 20, 8, _BIG_FORMATS) if big else \
        ("H", 12, 4, _FORMATS)
    head = struct.calcsize(count_fmt)
    if offset < (16 if big else 8) or offset + head > len(data):
        raise ValueError("TIFF directory lies outside the file")
    (n,) = struct.unpack_from(order + count_fmt, data, offset)
    if offset + head + entry_size * n > len(data):
        raise ValueError("TIFF directory is truncated")
    tags = {}
    for i in range(n):
        entry = offset + head + entry_size * i
        tag, typ, count = struct.unpack_from(order + "HH" + ("Q" if big else "I"), data, entry)
        fmt = formats.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(order + fmt) * count
        at = entry + entry_size - inline
        if size > inline:
            (at,) = struct.unpack_from(order + ("Q" if big else "I"), data, at)
        if at + size > len(data):
            raise ValueError(f"TIFF tag {tag} lies outside the file")
        tags[tag] = struct.unpack_from(order + fmt * count, data, at)
    return tags


def _one(tags, tag: int, default=None) -> int:
    vals = tags.get(tag)
    if not vals:
        if default is None:
            raise ValueError(f"TIFF without required tag {tag}")
        return default
    return int(vals[0])


def _orientation(tags) -> int:
    o = _one(tags, 274, 1)
    return o if 1 <= o <= 8 else 1  # libtiff refuses other values and keeps 1


def size(data: bytes) -> Tuple[int, int]:
    """(height, width) of the first page after its orientation, from the
    header alone."""
    tags = _tags(data, *_header(data))
    h, w = _one(tags, 257), _one(tags, 256)
    return (w, h) if _orientation(tags) >= 5 else (h, w)


def _packbits(raw: bytes, size: int) -> bytes:
    """libtiff's PackBitsDecode: a run header, then bytes copied or one
    repeated; a run past the output is cut, one past the input ends."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n and len(out) < size:
        h = raw[i]
        i += 1
        if h > 128:
            if i >= n:
                break
            out += raw[i : i + 1] * min(257 - h, size - len(out))
            i += 1
        elif h < 128:
            run = min(h + 1, size - len(out))
            if i + run > n:
                break
            out += raw[i : i + run]
            i += run
    if len(out) < size:
        raise ValueError("PackBits data ends short of the strip or tile")
    return bytes(out)


def _inflate(raw: bytes, size: int) -> bytes:
    try:
        out = zlib.decompressobj().decompress(raw, size)
    except zlib.error as err:
        raise ValueError(f"damaged Deflate data: {err}") from None
    if len(out) < size:
        raise ValueError("Deflate data ends short of the strip or tile")
    return out


def _jpeg(raw: bytes, tables: bytes, rows: int, cols: int, per: int, ycbcr: bool,
          sampling: list, fits: bool) -> bytes:
    """One JPEG-in-TIFF strip or tile -> its ``rows`` x ``cols`` pixels of
    ``per`` 8-bit samples (``ycbcr``: RGB), as libtiff has libjpeg decode
    it: the JPEGTables stream (tag 347) spliced in front, no colour
    conversion (a gray + alpha frame's two components come as coded) but
    for PhotometricInterpretation YCbCr (JPEGCOLORMODE_RGB),
    the luma sampling equal to ``sampling`` (YCbCrSubsampling, else the
    first strip's, as libtiff's JPEGFixupTagsSubsampling takes it; 1x1 but
    for YCbCr) and the chroma's 1x1.  A frame taller than the segment is
    cropped where libtiff allows it (``fits``: the last strip); any other
    size is refused as libtiff refuses it."""
    from rcnn_ocr_tpu_torch.native import jpeg_decode_frame, jpeg_frame

    stream = raw
    if tables[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9" and raw[:2] == b"\xff\xd8":
        stream = tables[:-2] + raw[2:]
    fh, fw, nc, luma, chroma = jpeg_frame(stream)
    if not sampling:
        sampling.append(luma if ycbcr else (1, 1))
    if nc != (3 if ycbcr else per) or luma != sampling[0] or (nc > 1 and chroma != (1, 1)):
        raise ValueError(f"JPEG-in-TIFF frame of {nc} components sampled {luma} / {chroma}, "
                         f"which libtiff refuses here (expected {sampling[0]})")
    if fw != cols or fh < rows or (fh > rows and not fits):
        raise ValueError(f"JPEG-in-TIFF frame of {fw}x{fh} for a strip or tile of "
                         f"{cols}x{rows}, which libtiff refuses")
    return jpeg_decode_frame(stream, ycbcr)[:rows].tobytes()


def _ycbcr_units(buf: bytes, rows: int, cols: int, hs: int, vs: int, npix: int) -> bytes:
    """A subsampled YCbCr strip or tile (data units of ``hs * vs`` luma
    samples, then Cb and Cr) -> ``rows`` x ``cols`` pixels of Y, Cb, Cr,
    each pixel taking its unit's chroma, as libtiff's putcontig8bitYCbCr*
    functions read the ``npix`` columns the image shows.  Where a tile
    shows fewer than its columns, putcontig8bitYCbCr44tile skips the rest
    of a block row at 10 bytes a unit, not 18, so its later block rows are
    read from there (columns past ``npix`` are left zero)."""
    unit = hs * vs + 2
    vb, hb = -(-rows // vs), -(-cols // hs)
    flat = np.frombuffer(buf, np.uint8, vb * hb * unit)
    if hs == vs == 4 and npix < cols:
        used = -(-npix // 4)
        step = used * unit + (cols - npix) // 4 * 10
        at = np.arange(vb)[:, None] * step + np.arange(used)[None, :] * unit
        u = np.zeros((vb, hb, unit), np.uint8)
        u[:, :used] = flat[at[:, :, None] + np.arange(unit)]
    else:
        u = flat.reshape(vb, hb, unit)
    y = u[:, :, : hs * vs].reshape(vb, hb, vs, hs).transpose(0, 2, 1, 3).reshape(vb * vs, hb * hs)
    c = np.repeat(np.repeat(u[:, :, hs * vs :], vs, axis=0), hs, axis=1)
    return np.ascontiguousarray(np.concatenate([y[:, :, None], c], axis=2)[:rows, :cols]).tobytes()


def _raw(data: bytes, offset: int, count: int, fill_order: int) -> bytes:
    """A strip or tile's bytes as libtiff reads them (FillOrder 2 reversed)."""
    if offset + count > len(data) or count < 0:
        raise ValueError("TIFF strip or tile lies outside the file")
    raw = data[offset : offset + count]
    if fill_order == 2:
        raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
    return raw


def _chunk(data: bytes, offset: int, count: int, compression: int, size: int,
           fill_order: int, rows: int, cols: int, options: int, old_lzw: bool = False) -> bytes:
    """One strip or tile of ``rows`` x ``cols`` pixels, decompressed to its
    ``size`` bytes (``old_lzw``: LZW in the pre-TIFF 6.0 style)."""
    raw = _raw(data, offset, count, fill_order)
    if compression == 1:
        if len(raw) < size:
            raise ValueError("TIFF strip or tile is truncated")
        return raw[:size]
    if compression == 32773:
        return _packbits(raw, size)
    if compression == 5:
        from rcnn_ocr_tpu_torch.native import tiff_lzw_decode

        return tiff_lzw_decode(raw, size, old_lzw)
    if compression in _FAX:
        from rcnn_ocr_tpu_torch.native import tiff_fax_decode

        return tiff_fax_decode(raw, rows, cols, compression, options)
    return _inflate(raw, size)


def _ycbcr_predictor(buf: bytes, row: int) -> bytes:
    """libtiff's horizontal predictor on a subsampled YCbCr strip or tile:
    PredictorDecodeTile runs horAcc8 over the decoded data-unit bytes as if
    they were three-sample pixels, in pieces of ``row`` bytes (TIFFScanlineSize
    for strips, TIFFTileRowSize, three bytes a column, for tiles).  Where
    the data is not whole pieces, or a piece not whole pixels, libtiff fails
    the strip before it changes a byte and its RGBA reader converts the
    bytes as they are, so they stay so."""
    if row % 3 or len(buf) % row:
        return buf
    pix = np.frombuffer(buf, np.uint8).reshape(-1, row // 3, 3)
    return np.cumsum(pix, axis=1, dtype=np.uint8).tobytes()


def _unpack(buf: bytes, rows: int, cols: int, spp: int, bits: int, order: str,
            predictor: bool) -> np.ndarray:
    """Decoded rows -> ``[rows, cols, spp]`` samples (uint8 or uint16), each
    row padded to whole bytes, the horizontal predictor undone."""
    if bits == 16:
        s = np.frombuffer(buf, order + "u2", rows * cols * spp).astype(np.uint16)
        s = s.reshape(rows, cols, spp)
    elif bits == 8:
        s = np.frombuffer(buf, np.uint8, rows * cols * spp).reshape(rows, cols, spp)
    else:
        stride = -(-cols * spp * bits // 8)
        b = np.frombuffer(buf, np.uint8, rows * stride).reshape(rows, stride)
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        v = (b[:, :, None] >> shifts) & np.uint8((1 << bits) - 1)
        s = v.reshape(rows, -1)[:, : cols * spp].reshape(rows, cols, spp)
    if predictor:  # a wrapping running sum along the row, per sample
        s = np.cumsum(s, axis=1, dtype=s.dtype)
    return s


def _skewed(tile: np.ndarray, npix: int, rows: int, bits: int) -> np.ndarray:
    """The first sample of each pixel of a tile clipped to ``npix`` columns,
    as libtiff's ``putgreytile`` / ``put16bitbwtile`` read it: they step to
    the next row by the clipped part's bytes plus the clip in samples, not
    in bytes, so in a right-edge tile of 16-bit gray, or of gray with
    alpha, every row after the first starts off its own."""
    tl, tw, spp = tile.shape
    pb = spp * bits // 8
    buf = np.frombuffer(tile.astype("<u2" if bits == 16 else np.uint8).tobytes(), np.uint8)
    off = np.arange(rows)[:, None] * (npix * pb + tw - npix) + np.arange(npix)[None, :] * pb
    if bits == 16:  # a little-endian 16-bit read, aligned or not
        return buf[off].astype(np.uint16) | (buf[off + 1].astype(np.uint16) << 8)
    return buf[off]


def _samples(data: bytes, tags, order: str, bits: int, spp: int, photometric: int):
    """The first page's samples ``[H, W, spp]`` (strips or tiles, chunky or
    planar) and the width of the blocks they were read in (a tile's, or
    the image's for strips)."""
    h, w = _one(tags, 257), _one(tags, 256)
    if h <= 0 or w <= 0:
        raise ValueError(f"TIFF of {w}x{h} pixels")
    check_size(w, h, "TIFF")
    compression = _one(tags, 259, 1)
    planar = _one(tags, 284, 1)
    if planar not in (1, 2):
        raise ValueError(f"TIFF PlanarConfiguration {planar}")
    predictor = _one(tags, 317, 1) if compression in (5, 8, 32946) else 1
    sgilog = compression in (34676, 34677)
    if predictor not in (1, 2) or (predictor == 2 and bits not in (8, 16)):
        raise ValueError(f"TIFF Predictor {predictor} with {bits}-bit samples")
    fill_order = _one(tags, 266, 1)
    per = 1 if planar == 2 else spp  # samples in one strip or tile
    if compression in _FAX and (bits != 1 or per != 1):
        raise ValueError(f"CCITT-coded TIFF of {bits}-bit samples, {per} a pixel, which "
                         "libtiff's fax decoder refuses")
    options = _one(tags, 292, 0) if compression == 3 else 0
    ycbcr = photometric == 6
    hs, vs = (int(v) for v in (tags.get(530) or (2, 2))[:2]) if ycbcr else (1, 1)
    if ycbcr and compression != 7 and (hs, vs) != (1, 1):
        if planar == 2 or (hs << 4 | vs) not in (0x44, 0x42, 0x41, 0x22, 0x21, 0x12, 0x11):
            raise ValueError(f"YCbCr TIFF subsampled {hs}x{vs}{' planar' if planar == 2 else ''}, "
                             "which libtiff's RGBA reader does not read")
    if ycbcr and compression == 7 and planar == 2 and (hs, vs) != (1, 1):
        raise ValueError(f"planar YCbCr JPEG-in-TIFF subsampled {hs}x{vs}, which libtiff's RGBA "
                         "reader does not read")
    sampling = [tuple(int(v) for v in tags[530][:2])] if ycbcr and 530 in tags else []
    tables = bytes(tags.get(347, ()))
    planes = spp if planar == 2 else 1
    out = np.empty((h, w, spp), np.uint16 if bits == 16 else np.uint8)
    if 322 in tags:
        tw, tl = _one(tags, 322), _one(tags, 323)
        if tw <= 0 or tl <= 0:
            raise ValueError("TIFF tile of size 0")
        offsets, counts = tags.get(324, ()), tags.get(325, ())
        boxes = [(y, x, tl, tw) for y in range(0, h, tl) for x in range(0, w, tw)]
    else:
        rps = min(_one(tags, 278, h), h)
        if rps <= 0:
            raise ValueError("TIFF RowsPerStrip of 0")
        tw = w
        offsets, counts = tags.get(273, ()), tags.get(279, ())
        boxes = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    if len(offsets) < len(boxes) * planes or len(counts) < len(boxes) * planes:
        raise ValueError("TIFF lists fewer strips or tiles than its size needs")
    if 322 not in tags:
        tile_bytes = 0
    elif (hs, vs) != (1, 1) and compression != 7:
        tile_bytes = -(-tl // vs) * -(-tw // hs) * (hs * vs + 2)
    else:
        tile_bytes = tl * -(-tw * per * bits // 8)
    if compression == 1 and tile_bytes % 1024:
        # libtiff 4.7.1 under OpenCV 5.0: "Invalid tile byte count ...
        # Expected 256, got 1024" for every such tile, whatever the image
        raise ValueError(f"uncompressed TIFF tiles of {tile_bytes} bytes, not a multiple of "
                         "1024, which libtiff's reader under OpenCV refuses")
    skew = planar == 1 and photometric in (0, 1) and (bits == 16 or spp > 1)
    # LZWPreDecode: old-style codes start 0x00 then an odd byte (Clear, least
    # significant bit first); libtiff keeps the style of the first strip or
    # tile it decodes for the file
    first = _raw(data, int(offsets[0]), int(counts[0]), fill_order) if compression == 5 else b""
    old_lzw = len(first) >= 2 and first[0] == 0 and bool(first[1] & 1)
    i = 0
    for p in range(planes):
        for y, x, rows, cols in boxes:
            size = rows * -(-cols * per * bits // 8)
            if compression == 7:
                if offsets[i] + counts[i] > len(data):
                    raise ValueError("TIFF strip or tile lies outside the file")
                buf = _jpeg(data[offsets[i] : offsets[i] + counts[i]], tables, rows, cols, per,
                            ycbcr and planar == 1, sampling, 322 not in tags and y + rows >= h)
            elif sgilog:
                raw = _raw(data, int(offsets[i]), int(counts[i]), fill_order)
                buf = _sgilog(raw, rows, cols, compression, spp)
            elif (hs, vs) != (1, 1):
                unit_row = -(-cols // hs) * (hs * vs + 2)
                units = -(-rows // vs) * unit_row
                # a strip is read as TIFFScanlineSize's whole rows, unit_row
                # // vs bytes each: a 4x4 row of an odd number of units
                # loses its last 2 bytes per block row there, zeros instead
                got = units if 322 in tags else -(-rows // vs) * vs * (unit_row // vs)
                buf = _chunk(data, int(offsets[i]), int(counts[i]), compression, got,
                             fill_order, rows, cols, options, old_lzw)
                if predictor == 2:  # undone on the unit bytes, a scanline or tile row a piece
                    buf = _ycbcr_predictor(buf, 3 * cols if 322 in tags else unit_row // vs)
                buf = _ycbcr_units(buf + bytes(units - got), rows, cols, hs, vs,
                                   min(cols, w - x))
            else:
                buf = _chunk(data, int(offsets[i]), int(counts[i]), compression, size,
                             fill_order, rows, cols, options, old_lzw)
            blk = _unpack(buf, rows, cols, per, bits, order,
                          predictor == 2 and (hs, vs) == (1, 1))
            ch = slice(p, p + 1) if planar == 2 else slice(0, spp)
            out[y : y + rows, x : x + cols, ch] = blk[: h - y, : w - x]
            if skew and x + cols > w:
                out[y : y + rows, x:, 0] = _skewed(blk, w - x, min(rows, h - y), bits)
            i += 1
    return out, tw


def _sgilog(raw: bytes, rows: int, cols: int, compression: int, spp: int) -> bytes:
    """One SGI LogL or LogLuv strip or tile -> 8-bit gray (LogL) or RGB
    (LogLuv) bytes, as libtiff's codec hands them to its RGBA reader with
    SGILOGDATAFMT_8BIT."""
    from rcnn_ocr_tpu_torch import native

    if spp == 1:  # LogL: 16-bit values in two run-length byte planes
        return _logl_gray()[native.tiff_sgilog16_decode(raw, rows, cols).view(np.uint16)].tobytes()
    if compression == 34676:  # LogLuv32: four run-length byte planes
        return _luv32_rgb(native.tiff_sgilog32_decode(raw, rows, cols)).tobytes()
    n = rows * cols  # LogLuv24: three bytes a pixel, most significant first
    if len(raw) < 3 * n:
        raise ValueError(f"SGI LogLuv24 data is {3 * n - len(raw)} bytes short of its rows")
    b = np.frombuffer(raw, np.uint8, 3 * n).reshape(n, 3).astype(np.uint32)
    return _luv24_rgb(b[:, 0] << 16 | b[:, 1] << 8 | b[:, 2]).tobytes()


_LN2 = 0.69314718055994530942  # M_LN2
# libtiff's uv_row (uvcode.h) as (ustart, nus): its 163 rows of the (u', v')
# gamut, read back from cv2's decode of all 2**24 LogLuv24 codes by
# tests/torch_port_data/derive_uv_rows.py (where several six-decimal
# ustarts reproduce a row, the smallest); bit-equal on every code
_UV_ROWS: Tuple[Tuple[float, int], ...] = (
    (0.247663, 4), (0.243777, 6), (0.241684, 7), (0.237874, 9),
    (0.235906, 10), (0.232153, 12), (0.228352, 14), (0.226259, 15),
    (0.222371, 17), (0.220410, 18), (0.214710, 21), (0.212714, 22),
    (0.210721, 23), (0.204976, 26), (0.202986, 27), (0.199245, 29),
    (0.195525, 31), (0.193560, 32), (0.189878, 34), (0.186216, 36),
    (0.186216, 36), (0.182592, 38), (0.179003, 40), (0.175466, 42),
    (0.172001, 44), (0.172001, 44), (0.168612, 46), (0.168612, 46),
    (0.163575, 49), (0.158642, 52), (0.158642, 52), (0.158642, 52),
    (0.153815, 55), (0.153815, 55), (0.149097, 58), (0.149097, 58),
    (0.142746, 62), (0.142746, 62), (0.142746, 62), (0.138270, 65),
    (0.138270, 65), (0.138270, 65), (0.132166, 69), (0.132166, 69),
    (0.126204, 73), (0.126204, 73), (0.126204, 73), (0.120381, 77),
    (0.120381, 77), (0.120381, 77), (0.120381, 77), (0.112962, 82),
    (0.112962, 82), (0.112962, 82), (0.107450, 86), (0.107450, 86),
    (0.107450, 86), (0.107450, 86), (0.100343, 91), (0.100343, 91),
    (0.100343, 91), (0.095126, 95), (0.095126, 95), (0.095126, 95),
    (0.095126, 95), (0.088276, 100), (0.088276, 100), (0.088276, 100),
    (0.088276, 100), (0.081523, 105), (0.081523, 105), (0.081523, 105),
    (0.081523, 105), (0.074861, 110), (0.074861, 110), (0.074861, 110),
    (0.074861, 110), (0.068290, 115), (0.068290, 115), (0.068290, 115),
    (0.068290, 115), (0.063573, 119), (0.063573, 119), (0.063573, 119),
    (0.063573, 119), (0.057219, 124), (0.057219, 124), (0.057219, 124),
    (0.057219, 124), (0.050985, 129), (0.050985, 129), (0.050985, 129),
    (0.050985, 129), (0.050985, 129), (0.044859, 134), (0.044859, 134),
    (0.044859, 134), (0.044859, 134), (0.040571, 138), (0.040571, 138),
    (0.040571, 138), (0.040571, 138), (0.036339, 142), (0.036339, 142),
    (0.036339, 142), (0.036339, 142), (0.032139, 146), (0.032139, 146),
    (0.032139, 146), (0.032139, 146), (0.027947, 150), (0.027947, 150),
    (0.027947, 150), (0.023739, 154), (0.023739, 154), (0.023739, 154),
    (0.023739, 154), (0.019504, 158), (0.019504, 158), (0.019504, 158),
    (0.016976, 161), (0.016976, 161), (0.016976, 161), (0.016976, 161),
    (0.012639, 165), (0.012639, 165), (0.012639, 165), (0.009991, 168),
    (0.009991, 168), (0.009991, 168), (0.009016, 170), (0.009016, 170),
    (0.009016, 170), (0.006217, 173), (0.006217, 173), (0.005097, 175),
    (0.005097, 175), (0.005097, 175), (0.003909, 177), (0.003909, 177),
    (0.002340, 177), (0.002389, 170), (0.001068, 164), (0.001653, 157),
    (0.000717, 150), (0.001614, 143), (0.000270, 136), (0.000484, 129),
    (0.001103, 123), (0.001242, 115), (0.001188, 109), (0.001011, 103),
    (0.000709, 97), (0.000301, 89), (0.002416, 82), (0.003251, 76),
    (0.003246, 69), (0.004141, 62), (0.005963, 55), (0.008839, 47),
    (0.010490, 40), (0.016994, 31), (0.023657, 21),
)


@functools.lru_cache(maxsize=None)
def _logl16_y() -> np.ndarray:
    """tif_luv.c's LogL16toY for each 15-bit log luminance (a set sign bit
    makes Y negative, which LogLuv reads as black): exp(ln 2 / 256 * (Le +
    0.5) - ln 2 * 64), 0 for Le 0, through the C library's exp."""
    y = np.zeros(1 << 16, np.float64)
    y[1 : 1 << 15] = [math.exp(_LN2 / 256.0 * (le + 0.5) - _LN2 * 64.0) for le in
                      range(1, 1 << 15)]
    return y


@functools.lru_cache(maxsize=None)
def _logl_gray() -> np.ndarray:
    """tif_luv.c's L16toGry for each 16-bit LogL value: Y from LogL16toY
    (0 for Le 0 or a negative sign), then 0 at or under 0, 255 at or over
    1, else ``(int)(256 * sqrt(Y))``."""
    y = _logl16_y()
    gray = np.zeros(1 << 16, np.uint8)
    for le in range(1, 1 << 15):
        gray[le] = 255 if y[le] >= 1.0 else int(256.0 * math.sqrt(y[le]))
    return gray


def _luv_rgb(lum: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """tif_luv.c's LogLuv32toXYZ / LogLuv24toXYZ from the luminance and
    (u', v'), then XYZtoRGB24 (CCIR-709 primaries, gamma 2): double
    arithmetic in the C code's order, XYZ rounded to float, each channel 0
    at or under 0, 255 at or over 1, else ``(int)(256 * sqrt(c))``."""
    s = 1.0 / (6.0 * u - 16.0 * v + 12.0)
    x = 9.0 * u * s
    y = 4.0 * v * s
    lit = lum > 0.0
    xyz = [np.where(lit, c, 0.0).astype(np.float32).astype(np.float64)
           for c in (x / y * lum, lum, (1.0 - x - y) / y * lum)]
    out = np.empty(lum.shape + (3,), np.uint8)
    for k, (a, b, c) in enumerate(((2.690, -1.276, -0.414), (-1.022, 1.978, 0.044),
                                   (0.061, -0.224, 1.163))):
        ch = a * xyz[0] + b * xyz[1] + c * xyz[2]
        q = (256.0 * np.sqrt(np.clip(ch, 0.0, 1.0))).astype(np.int64)
        out[..., k] = np.where(ch <= 0.0, 0, np.where(ch >= 1.0, 255, q))
    return out


def _luv32_rgb(p: np.ndarray) -> np.ndarray:
    """32-bit LogLuv values -> RGB: a signed 16-bit log luminance, then u'
    and v' as bytes, ``(b + 0.5) / 410``."""
    lum = _logl16_y()[p >> 16]
    u = 1.0 / 410.0 * (((p >> 8) & 255) + 0.5)
    v = 1.0 / 410.0 * ((p & 255) + 0.5)
    return _luv_rgb(lum, u, v)


def _luv24_rgb(p: np.ndarray) -> np.ndarray:
    """24-bit LogLuv values -> RGB: a 10-bit log luminance, exp(ln 2 / 64 *
    (Le + 0.5) - ln 2 * 12) (0 for Le 0), then a 14-bit (u', v') index
    through :func:`_uv24`."""
    u, v = _uv24()
    c = p & 0x3FFF
    return _luv_rgb(_logl10_y()[(p >> 14) & 0x3FF], u[c], v[c])


@functools.lru_cache(maxsize=None)
def _logl10_y() -> np.ndarray:
    """tif_luv.c's LogL10toY for each 10-bit log luminance, through the C
    library's exp."""
    return np.array([0.0] + [math.exp(_LN2 / 64.0 * (le + 0.5) - _LN2 * 12.0)
                             for le in range(1, 1024)])


@functools.lru_cache(maxsize=None)
def _uv24() -> Tuple[np.ndarray, np.ndarray]:
    """tif_luv.c's uv_decode for each 14-bit index: index ``c`` lies in the
    row ``vi`` of :data:`_UV_ROWS` whose ``ncum`` is the last at or under
    it, ``u = ustart + (c - ncum + 0.5) * UV_SQSIZ`` and ``v = UV_VSTART +
    (vi + 0.5) * UV_SQSIZ`` (the constants floats); indices past the
    table's 16289 take the neutral (u', v')."""
    sq, vstart = float(np.float32(0.0035)), float(np.float32(0.01694))
    u = np.full(1 << 14, 0.210526316)
    v = np.full(1 << 14, 0.473684211)
    ncum = 0
    for vi, (ustart, nus) in enumerate(_UV_ROWS):
        ui = np.arange(nus)
        u[ncum : ncum + nus] = float(np.float32(ustart)) + (ui + 0.5) * sq
        v[ncum : ncum + nus] = vstart + (vi + 0.5) * sq
        ncum += nus
    return u, v


def _to8(v: np.ndarray, bits: int) -> np.ndarray:
    """libtiff's Bitdepth16To8, ``(v + 128) // 257``, for 16-bit samples."""
    if bits == 16:
        return ((v.astype(np.uint32) + 128) // 257).astype(np.uint8)
    return v


def decode(data: bytes) -> np.ndarray:
    """The first page of a TIFF file -> RGB uint8 ``[H, W, 3]``, as
    ``cv2.imdecode(data, IMREAD_COLOR)`` then BGR -> RGB gives it."""
    data = bytes(data)
    order, offset, big = _header(data)
    tags = _tags(data, order, offset, big)
    compression = _one(tags, 259, 1)
    # OpenCV's own refusals (TiffDecoder::readHeader, TIFFRGBAImageOK), then
    # the compressions its libtiff lacks: cv2 gives None on each
    fmt = _one(tags, 339, 1)
    if fmt not in (1, 2):  # signed samples are read as their unsigned bits
        kind = _SAMPLE_FORMAT.get(fmt, f"SampleFormat {fmt}")
        raise ValueError(f"{kind} TIFF samples, which OpenCV does not read")
    photometric = _one(tags, 262)
    if photometric not in (0, 1, 2, 3, 5, 6, 8, 32844, 32845):
        kind = _PHOTOMETRIC.get(photometric, f"PhotometricInterpretation {photometric}")
        raise ValueError(f"{kind} TIFF, which OpenCV does not read")
    bits = _one(tags, 258, 1)
    if len(set(tags.get(258, ()))) > 1:
        raise ValueError("TIFF BitsPerSample differs between samples, which libtiff refuses")
    spp = _one(tags, 277, 1)
    extra = tags.get(338, ())
    planar = _one(tags, 284, 1)
    # what OpenCV's readHeader and libtiff's TIFFRGBAImageOK accept
    ok_bits = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8), 5: (8,),
               6: (8,), 8: (8, 16), 32844: (1, 8, 16), 32845: (1, 8, 16)}[photometric]
    if bits not in ok_bits:
        raise ValueError(f"{bits}-bit TIFF samples of PhotometricInterpretation {photometric}, "
                         "which OpenCV does not read")
    if photometric == 32844 and (compression != 34676 or spp != 1):
        raise ValueError(f"LogL TIFF of compression {compression} and {spp} samples, which "
                         "libtiff refuses")
    if photometric == 32845 and (compression not in (34676, 34677) or planar != 1 or spp != 3
                                 or extra):
        raise ValueError(f"LogLuv TIFF of compression {compression}, {spp} samples, "
                         f"PlanarConfiguration {planar}, which libtiff refuses")
    if compression not in _DECODED and photometric not in (32844, 32845):
        name = _COMPRESSION.get(compression, "an unknown")
        raise ValueError(f"{name} TIFF compression ({compression}), which OpenCV's libtiff "
                         "does not decode")
    if bits < 8 and spp != 1 and photometric != 32845:  # LogLuv's codec ignores the depth
        raise ValueError(f"{bits}-bit TIFF of {spp} samples a pixel")
    if (photometric == 2 and spp < 3) or (photometric == 5 and spp < 4):
        raise ValueError(f"TIFF of PhotometricInterpretation {photometric} with {spp} samples")
    if planar == 2 and photometric == 3:
        raise ValueError("planar palette TIFF, which libtiff's RGBA reader does not read")
    if photometric == 6 and spp != 3:
        raise ValueError(f"YCbCr TIFF of {spp} samples, which libtiff's RGBA reader does not read")
    if photometric == 8 and (spp - len(extra) != 3 or spp != 3 or planar == 2):
        raise ValueError(f"CIELab TIFF of {spp} samples{' planar' if planar == 2 else ''}, which "
                         "libtiff's RGBA reader does not read")
    if compression == 7 and bits != 8:
        raise ValueError(f"JPEG-in-TIFF of {bits}-bit samples, which libtiff refuses")
    if photometric == 32844:  # read as 8-bit gray (SGILOGDATAFMT_8BIT)
        photometric, bits = 1, 8
    elif photometric == 32845:  # read as 8-bit RGB (SGILOGDATAFMT_8BIT)
        photometric, bits = 2, 8
    s, block_w = _samples(data, tags, order, bits, spp, photometric)
    # libtiff's alpha: ExtraSamples 2 is unassociated (premultiplied on
    # read), 1 associated, 0 associated past three samples
    unassociated = bool(extra) and extra[0] == 2
    if photometric in (0, 1) and planar == 1:
        v = s[:, :, 0]
        if bits == 1:
            v = v * np.uint8(255)
        elif bits == 16:  # put16bitbwtile: the high byte
            v = (v >> 8).astype(np.uint8)
        if photometric == 0:
            v = 255 - v
        rgb = np.repeat(v[:, :, None], 3, axis=2)
    elif photometric in (0, 1, 2):  # planar gray is read as RGB with r = g = b
        colour = s[:, :, :3] if photometric == 2 else np.repeat(s[:, :, :1], 3, axis=2)
        if photometric == 0:
            colour = (1 << bits) - 1 - colour
        rgb = _to8(colour, bits)
        alpha = 3 if photometric == 2 else 1
        if unassociated and spp > alpha:
            a = _to8(s[:, :, alpha : alpha + 1], bits).astype(np.uint32)
            rgb = ((rgb.astype(np.uint32) * a + 127) // 255).astype(np.uint8)
    elif photometric == 8:
        rgb = _cielab_rgb(s, tags, bits)
    elif photometric == 6:  # JPEG's came out as RGB (JPEGCOLORMODE_RGB)
        rgb = s if compression == 7 and planar == 1 else _ycbcr_rgb(s, tags)
    elif photometric == 3:
        cmap = np.asarray(tags.get(320, ()), np.uint16)
        n = 1 << bits
        if cmap.size < 3 * n:
            raise ValueError("palette TIFF without a full ColorMap")
        cmap = cmap[: 3 * n].reshape(3, n).T
        if (cmap >= 256).any():  # libtiff's checkcmap: 16-bit entries
            cmap = cmap >> 8
        rgb = cmap.astype(np.uint8)[s[:, :, 0]]
    else:  # CMYK: tif_getimage.c's putRGBcontig8bitCMYKtile
        k = 255 - s[:, :, 3:4].astype(np.uint32)
        rgb = (k * (255 - s[:, :, :3].astype(np.uint32)) // 255).astype(np.uint8)
    return _orient(rgb, _orientation(tags), block_w)


def _floats(tags, tag: int, default) -> list:
    """A RATIONAL tag as libtiff reads it into floats: ``(float)num /
    (float)den`` in single precision, 0 for a zero numerator."""
    vals = tags.get(tag)
    if not vals:
        return [np.float32(v) for v in default]
    return [np.float32(0) if n == 0 else np.float32(n) / np.float32(d)
            for n, d in zip(vals[0::2], vals[1::2])]


def _ycbcr_rgb(s: np.ndarray, tags) -> np.ndarray:
    """8-bit Y, Cb, Cr -> RGB as libtiff's tif_color.c converts them
    (TIFFYCbCrToRGBInit's fixed-point tables, SHIFT 16, built in float32
    from YCbCrCoefficients (529) and ReferenceBlackWhite (532), with
    libtiff's defaults when they are absent; TIFFYCbCrtoRGB)."""
    f32 = np.float32
    lr, lg, lb = _floats(tags, 529, (0.299, 0.587, 0.114))[:3]
    rbw = _floats(tags, 532, (0, 255, 128, 255, 128, 255))[:6]
    if np.isnan([lr, lg, lb]).any() or lg == 0:
        raise ValueError("TIFF YCbCrCoefficients that libtiff refuses")
    if len(rbw) < 6 or not all(f32(-0x7FFFFFFF + 128) < v < f32(0x7FFFFFFF) for v in rbw):
        raise ValueError("TIFF ReferenceBlackWhite that libtiff refuses")

    def fix(x):  # FIX(CLAMP(x, 0, 2)): the float times 65536, + 0.5 in double
        x = min(max(x, f32(0)), f32(2)) if x >= 0 else f32(0)
        return int(float(x * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d2 = fix(f1), -fix(lr * f1 / lg)
    d3, d4 = fix(f3), -fix(lb * f3 / lg)
    x = np.arange(-128, 128, dtype=np.int64)

    def code2v(c, rb, rw, cr):  # Code2V, CLAMPw to +-4096, truncated
        den = rw - rb
        v = (c - int(rb)).astype(f32) * f32(cr) / (den if den != 0 else f32(1))
        return np.clip(v, f32(-4096), f32(4096)).astype(np.int64)

    cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    cr_r, cb_b = (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + 32768
    y_tab = code2v(x + 128, rbw[0], rbw[1], 255)
    yy, ub, vr = (s[:, :, k].astype(np.intp) for k in range(3))
    yv = y_tab[yy]
    rgb = np.stack([yv + cr_r[vr], yv + ((cb_g[ub] + cr_g[vr]) >> 16), yv + cb_b[ub]], axis=2)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# tif_getimage.c's display_sRGB: the XYZ -> luminance matrix, the light
# output of reference white and of black, gamma 2.4 and white at 255
_SRGB = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                  [0.0556, -0.2040, 1.0570]], np.float32)
_LAB_RANGE = 1500  # CIELABTORGB_TABLE_RANGE
@functools.lru_cache(maxsize=None)
def _cielab_table() -> np.ndarray:
    """TIFFCIELabToRGBInit's Yr2r (and Yg2g, Yb2b: the same display),
    ``255 * (float)pow(i / 1500., 1 / 2.4F)`` through the C library's pow."""
    gamma = 1.0 / float(np.float32(2.4))
    powed = np.array([math.pow(i / _LAB_RANGE, gamma) for i in range(_LAB_RANGE + 1)],
                     np.float64).astype(np.float32)
    return np.float32(255) * powed


def _cielab_rgb(s: np.ndarray, tags, bits: int) -> np.ndarray:
    """CIE L*a*b* (8-bit L with signed a*, b*, or 16-bit L with signed
    16-bit a*, b*) -> RGB as libtiff's RGBA reader converts it: the
    reference white from the WhitePoint tag (318, default D50), then
    tif_color.c's TIFFCIELab16ToXYZ and TIFFXYZToRGB over the display_sRGB
    tables, in float32 in libtiff's order of operations."""
    f = np.float32
    d50 = (f(96.4250), f(100.0), f(82.4680))
    total = d50[0] + d50[1] + d50[2]
    wp = _floats(tags, 318, (d50[0] / total, d50[1] / total))
    if len(wp) < 2:
        wp = [d50[0] / total, d50[1] / total]
    if wp[1] == 0:
        raise ValueError("CIELab TIFF with a WhitePoint y of 0, which libtiff refuses")
    x0 = wp[0] / wp[1] * f(100)
    y0 = f(100)
    z0 = (f(1) - wp[0] - wp[1]) / wp[1] * f(100)
    if bits == 8:
        l_ = s[:, :, 0].astype(np.uint32) * 257
        a = s[:, :, 1].astype(np.uint8).view(np.int8).astype(np.int32) * 256
        b = s[:, :, 2].astype(np.uint8).view(np.int8).astype(np.int32) * 256
    else:
        l_ = s[:, :, 0].astype(np.uint32)
        a = s[:, :, 1].astype(np.uint16).view(np.int16).astype(np.int32)
        b = s[:, :, 2].astype(np.uint16).view(np.int16).astype(np.int32)
    with np.errstate(all="ignore"):
        lum = l_.astype(f) * f(100) / f(65535)
        dark = lum < f(8.856)
        y_dark = (lum * y0) / f(903.292)
        cby = np.where(dark, f(7.787) * (y_dark / y0) + f(16) / f(116), (lum + f(16)) / f(116))
        y = np.where(dark, y_dark, y0 * cby * cby * cby)

        def axis(t, white):
            return np.where(t < f(0.2069), white * (t - f(0.13793)) / f(7.787),
                            white * t * t * t)

        x = axis(a.astype(f) / f(256) / f(500) + cby, x0)
        z = axis(cby - b.astype(f) / f(256) / f(200), z0)
        table, step = _cielab_table(), (f(100) - f(1)) / f(_LAB_RANGE)
        out = []
        for row in _SRGB:
            yc = row[0] * x + row[1] * y + row[2] * z
            yc = np.minimum(np.maximum(yc, f(1)), f(100))
            i = np.minimum(((yc - f(1)) / step).astype(np.int64), _LAB_RANGE)
            out.append(np.minimum((table[i].astype(np.float64) + 0.5).astype(np.int64), 255))
    return np.stack(out, axis=2).astype(np.uint8)


def _orient(rgb: np.ndarray, o: int, block_w: int) -> np.ndarray:
    """Orientation as OpenCV reads it: libtiff mirrors each strip or tile
    left to right for 2, 3, 6 and 7 (its columns within the image, a tile's
    within itself), then the rows are flipped and the image transposed."""
    if o in (2, 3, 6, 7):
        rgb = rgb.copy()
        for x in range(0, rgb.shape[1], block_w):
            rgb[:, x : x + block_w] = rgb[:, x : x + block_w][:, ::-1]
    transpose, flip_rows, flip_cols = {1: (0, 0, 0), 2: (0, 0, 0), 3: (0, 1, 0), 4: (0, 1, 0),
                                       5: (1, 0, 0), 6: (1, 1, 1), 7: (1, 0, 1),
                                       8: (1, 1, 0)}[o]
    if transpose:
        rgb = rgb.transpose(1, 0, 2)
    if flip_rows:
        rgb = rgb[::-1]
    if flip_cols:
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb, dtype=np.uint8)
