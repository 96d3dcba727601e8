"""Write the TIFF fixtures the port's decoder is held to on the card.

    python tests/torch_port_data/make_tiff_fixtures.py

Needs cv2 and PIL (the card's script reads only the files).  Writes into
``tests/torch_port_data/tiff/`` and, for SGI LogLuv and the predictor on
subsampled YCbCr (:func:`_logluv_fixtures`), ``tiff_variants/``:

* files written by :func:`tiff_bytes` below, one per decoder path: every
  compression (none, PackBits, LZW, Deflate 8 and 32946) with and without
  the horizontal predictor, gray (MinIsBlack and MinIsWhite) at 1, 4, 8 and
  16 bits, palette at 4 and 8 bits (16-bit and 8-bit-valued colour maps),
  RGB at 8 and 16 bits, RGBA (associated, unassociated and unspecified
  alpha), strips and tiles, both byte orders, planar configurations 1 and
  2, orientations 1-8 and a two-page file;
* files written by cv2 and PIL (each of their compressions and modes);
* ``expected.npz``: cv2's RGB pixels (``cv2.imdecode(IMREAD_COLOR)`` then
  BGR -> RGB) of every file, keyed by file name.

JPEG-compressed gray + alpha (:func:`_gray_alpha_jpeg_fixtures`) goes into
``tiff_gray_alpha/``: PIL's ``LA`` TIFFs of two-component JPEG frames in
strips, 16x16 tiles and at quality 20, one size per partial-MCU edge, and
a planar variant written here.

:func:`tiff_bytes` writes any of these layouts from a sample array, so the
tests use it for their seeded fuzz too.  Everything is seeded, so a rerun
writes the same bytes with the same cv2 and PIL.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiff")
# the SGI LogLuv and predicted subsampled YCbCr files, in a folder of their own (``tiff/``
# keeps under the 256 KiB its test allows)
OUT_VARIANTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiff_variants")
# JPEG-compressed gray + alpha (two-component frames), in a folder of their own
OUT_GRAY_ALPHA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiff_gray_alpha")
COMPRESSION = {"none": 1, "lzw": 5, "lzw_old": 5, "deflate": 8, "zip": 32946, "packbits": 32773,
               "sgilog": 34676, "sgilog24": 34677,
               "ccitt_rle": 2, "ccitt_rlew": 32771, "g3": 3, "g4": 4, "jpeg": 7}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


# --- encoders ---------------------------------------------------------------------------

def packbits(data: bytes) -> bytes:
    """PackBits: literal runs of up to 128 bytes and repeats of 2-128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + data[i : i + 1]
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9 to 12 bits, Clear (256) first and when
    the table fills, EOI (257) last, the width growing one code early."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code: int, width: int) -> None:
        nonlocal acc, nacc
        acc, nacc = (acc << width) | code, nacc + width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)

    table = {bytes([i]): i for i in range(256)}
    free, width = 258, 9
    put(256, width)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = free
        free += 1
        if free == 4094:
            put(256, width)
            table = {bytes([i]): i for i in range(256)}
            free, width = 258, 9
        elif free > (1 << width) - 1:
            width += 1
        w = bytes([b])
    if w:
        put(table[w], width)
        free += 1
        if free > (1 << width) - 1 and width < 12:
            width += 1
    put(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def lzw_old_style(data: bytes) -> bytes:
    """Old-style (pre-TIFF 6.0) LZW, as libtiff's LZWDecodeCompat reads it:
    codes least significant bit first, the width growing only when the
    next free entry passes 2^n (one code later than :func:`lzw`)."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code: int, width: int) -> None:
        nonlocal acc, nacc
        acc, nacc = acc | (code << nacc), nacc + width
        while nacc >= 8:
            out.append(acc & 255)
            acc, nacc = acc >> 8, nacc - 8

    table = {bytes([i]): i for i in range(256)}
    free, width = 258, 9
    put(256, width)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = free
        free += 1
        if free == 4094:
            put(256, width)
            table = {bytes([i]): i for i in range(256)}
            free, width = 258, 9
        elif free > 1 << width:
            width += 1
        w = bytes([b])
    if w:
        put(table[w], width)
        free += 1
        if free > 1 << width and width < 12:
            width += 1
    put(257, width)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def sgilog16(values: np.ndarray) -> bytes:
    """SGI LogL: each row's 16-bit values as two byte planes (high, then
    low), each run-length coded as libtiff's LogL16Encode codes them
    (a run of 2 to 129 equal bytes as 126 + n and the byte, else literals
    of up to 127 bytes after their count)."""
    return _sgilog_planes(values, 2)


def sgilog32(values: np.ndarray) -> bytes:
    """SGI LogLuv32 (compression 34676 on PhotometricInterpretation LogLuv):
    each row's 32-bit values as four byte planes, most significant first,
    run-length coded as :func:`sgilog16` codes its two."""
    return _sgilog_planes(values, 4)


def sgilog24(values: np.ndarray) -> bytes:
    """SGI LogLuv24 (compression 34677): each 24-bit value as three bytes,
    most significant first, as libtiff's LogLuvEncode24 writes them."""
    v = np.asarray(values, np.uint32).reshape(-1)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], axis=1).astype(np.uint8).tobytes()


def logluv_tiff(values: np.ndarray, compression: str = "sgilog", bits: int = 16,
                rows_per_strip: int = 8, tile=None, order: str = "<", **kw) -> bytes:
    """A LogLuv TIFF (PhotometricInterpretation 32845, three samples of
    ``bits``) of ``values`` ``[H, W]``: 32-bit LogLuv values coded by
    :func:`sgilog32` (``compression="sgilog"``) or 24-bit ones by
    :func:`sgilog24` (``"sgilog24"``), in strips or tiles ``(w, h)``."""
    values = np.asarray(values, np.uint32)
    h, w = values.shape
    code = sgilog32 if compression == "sgilog" else sgilog24
    if tile is None:
        chunks = [code(values[y : y + rows_per_strip]) for y in range(0, h, rows_per_strip)]
    else:
        tw, tl = tile
        padded = np.zeros((-(-h // tl) * tl, -(-w // tw) * tw), np.uint32)
        padded[:h, :w] = values
        chunks = [code(padded[y : y + tl, x : x + tw]) for y in range(0, h, tl)
                  for x in range(0, w, tw)]
    return tiff_bytes(np.zeros((h, w, 3), np.uint16), bits=bits, photometric=32845,
                      compression=compression, rows_per_strip=rows_per_strip, tile=tile,
                      order=order, chunks=chunks, **kw)


def _sgilog_planes(values: np.ndarray, nbytes: int) -> bytes:
    out = bytearray()
    for row in np.asarray(values, np.int64).reshape(values.shape[0], -1):
        for plane in ((row >> (8 * k)) & 255 for k in range(nbytes - 1, -1, -1)):
            i, n = 0, len(plane)
            while i < n:
                j = i
                while j + 1 < n and plane[j + 1] == plane[i] and j - i < 128:
                    j += 1
                if j - i >= 2:  # a run of 3 or more
                    out += bytes([128 + j - i + 1 - 2, int(plane[i])])
                    i = j + 1
                    continue
                k = i
                while k < n and k - i < 127 and not (k + 2 < n and plane[k] == plane[k + 1]
                                                     == plane[k + 2]):
                    k += 1
                out += bytes([k - i]) + bytes(int(v) for v in plane[i:k])
                i = k
    return bytes(out)


# --- CCITT fax (T.4 / T.6), as libtiff's encoder writes it ------------------------------

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
               "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
               "000000011111").split()
_EOL = "000000000001"
_VERTICAL = {-3: "0000010", -2: "000010", -1: "010", 0: "1", 1: "011", 2: "000011",
             3: "0000011"}  # a1 - b1


def _span(run: int, black: bool) -> str:
    """libtiff's putspan: extended make-up codes of 2560 while the run is
    2624 or more, one make-up code, then the terminating code."""
    term, makeup = (_BLACK_TERM, _BLACK_MAKEUP) if black else (_WHITE_TERM, _WHITE_MAKEUP)
    out = []
    while run >= 2624:
        out.append(_EXT_MAKEUP[-1])
        run -= 2560
    if run >= 64:
        k = run >> 6
        out.append(makeup[k - 1] if k <= 27 else _EXT_MAKEUP[k - 28])
        run -= k << 6
    out.append(term[run])
    return "".join(out)


def _diff(row, start: int, color: int) -> int:
    """The first position at or after ``start`` whose pixel is not ``color``."""
    x = start
    while x < len(row) and row[x] == color:
        x += 1
    return x


def _row_1d(row) -> str:
    out, x, color = [], 0, 0
    while x < len(row):
        end = _diff(row, x, color)
        out.append(_span(end - x, color == 1))
        x, color = end, 1 - color
    if not len(row):
        out.append(_span(0, False))
    return "".join(out)


def _row_2d(row, ref) -> str:
    """libtiff's Fax3Encode2DRow of ``row`` against the reference ``ref``."""
    w = len(row)

    def px(r, x):
        return r[x] if x < w else 0

    out = []
    a0 = 0
    a1 = 0 if row[0] else _diff(row, 0, 0)
    b1 = 0 if ref[0] else _diff(ref, 0, 0)
    while True:
        b2 = w if b1 >= w else _diff(ref, b1, px(ref, b1))
        if b2 >= a1:
            d = b1 - a1
            if -3 <= d <= 3:
                out.append(_VERTICAL[-d])
                a0 = a1
            else:
                a2 = w if a1 >= w else _diff(row, a1, px(row, a1))
                white_first = a0 + a1 == 0 or px(row, a0) == 0
                out.append("001" + _span(a1 - a0, not white_first) + _span(a2 - a1, white_first))
                a0 = a2
        else:
            out.append("0001")
            a0 = b2
        if a0 >= w:
            return "".join(out)
        a1 = _diff(row, a0, px(row, a0))
        b1 = _diff(ref, a0, 1 - px(row, a0))
        b1 = _diff(ref, b1, px(row, a0))


def fax_encode(bits: np.ndarray, compression: str, t4options: int = 0, k: int = 4,
               rtc: bool = True) -> bytes:
    """CCITT coding of ``[rows, cols]`` 0/1 pixels, 1 coded as black runs:
    ``ccitt_rle`` (modified Huffman, each row from a byte boundary),
    ``ccitt_rlew`` (each row from a 16-bit word), ``g3`` (an EOL before each
    row, byte-aligned with T4Options bit 2, with bit 0 a 1-D / 2-D tag bit
    after it and every ``k``-th row 1-D, the rest 2-D; RTC last with
    ``rtc``) or ``g4`` (2-D rows against a white first reference, EOFB
    last)."""
    rows = [[int(v) for v in r] for r in np.asarray(bits).reshape(bits.shape[0], -1)]
    out = []

    def align(unit):
        out.append("0" * (-len("".join(out)) % unit))

    ref = [0] * (len(rows[0]) if rows else 0)
    two_d = compression == "g3" and t4options & 1
    for i, row in enumerate(rows):
        if compression in ("ccitt_rle", "ccitt_rlew"):
            out.append(_row_1d(row))
            align(8 if compression == "ccitt_rle" else 16)
            continue
        if compression == "g4":
            out.append(_row_2d(row, ref))
        else:
            if t4options & 4:  # fill so that the EOL ends on a byte boundary
                out.append("0" * ((-(len("".join(out)) + 12)) % 8))
            out.append(_EOL)
            if two_d:
                one_d = i % k == 0
                out.append("1" if one_d else "0")
                out.append(_row_1d(row) if one_d else _row_2d(row, ref))
            else:
                out.append(_row_1d(row))
        ref = row
    if compression == "g4":
        out.append(_EOL * 2)
    elif compression == "g3" and rtc:
        out.append((_EOL + ("1" if two_d else "")) * 6)
    bitstr = "".join(out)
    bitstr += "0" * (-len(bitstr) % 8)
    return bytes(int(bitstr[i : i + 8], 2) for i in range(0, len(bitstr), 8))


# --- YCbCr and JPEG-in-TIFF -------------------------------------------------------------

def ycbcr_units(blk: np.ndarray, hs: int, vs: int) -> bytes:
    """``[rows, cols, 3]`` Y, Cb, Cr -> data units of ``hs * vs`` luma
    samples (row by row) then the unit's mean Cb and Cr, the block's edges
    replicated to whole units."""
    rows, cols = blk.shape[:2]
    vb, hb = -(-rows // vs), -(-cols // hs)
    full = np.pad(blk.astype(np.int64), ((0, vb * vs - rows), (0, hb * hs - cols), (0, 0)),
                  mode="edge")
    u = full.reshape(vb, vs, hb, hs, 3).transpose(0, 2, 1, 3, 4)
    y = u[..., 0].reshape(vb, hb, vs * hs)
    c = (u[..., 1:].reshape(vb, hb, vs * hs, 2).mean(axis=2) + 0.5).astype(np.int64)
    return np.concatenate([y, c], axis=2).astype(np.uint8).tobytes()


def jpeg_split(stream: bytes, keep_app: bool = False):
    """A JPEG stream -> (tables, abbreviated stream): SOI, its DQT and DHT
    segments and EOI for the JPEGTables tag, and SOI plus the rest (APPn
    segments only with ``keep_app``) for the strip or tile."""
    tables, rest, i = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while i < len(stream):
        marker = stream[i + 1]
        if marker == 0xDA:
            rest += stream[i:]
            break
        n = struct.unpack(">H", stream[i + 2 : i + 4])[0]
        seg = stream[i : i + 2 + n]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif keep_app or not 0xE0 <= marker <= 0xEF:
            rest += seg
        i += 2 + n
    return bytes(tables + b"\xff\xd9"), bytes(rest)


def jpeg_encode(block: np.ndarray, photometric: int, quality: int = 90,
                sampling: str = "444") -> bytes:
    """A JPEG of ``block`` as a TIFF writer stores it: gray for
    PhotometricInterpretation 1, RGB coded with no colour transform for 2
    (PIL's raw YCbCr path: the samples go in as they are), YCbCr from RGB
    at ``sampling`` (cv2's 444 / 422 / 420 / 411 / 440) for 6."""
    import cv2
    from PIL import Image

    if photometric == 1:
        return cv2.imencode(".jpg", np.ascontiguousarray(block[:, :, 0]),
                            [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
    if photometric == 2:
        bio = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(block), "YCbCr").save(bio, format="JPEG",
                                                                    quality=quality,
                                                                    subsampling=0)
        return bio.getvalue()
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    return cv2.imencode(".jpg", np.ascontiguousarray(block[:, :, ::-1]),
                        [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         factor])[1].tobytes()


_LUMA = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "411": (4, 1), "440": (1, 2)}


def jpeg_tiff(img: np.ndarray, photometric: int, tile=None, rows_per_strip: int = 8,
              quality: int = 90, sampling: str = "444", tables: bool = True,
              tall_last: bool = False, subsampling_tag: bool = True, **kw) -> bytes:
    """A JPEG-in-TIFF (compression 7) of ``img`` ``[H, W, 1 or 3]``: one
    JPEG per strip or tile (tiles padded by replicating the edge), its DQT
    and DHT moved into JPEGTables (tag 347) with ``tables``, the last strip
    coded at the full RowsPerStrip height with ``tall_last`` (libtiff reads
    such a frame and crops it), YCbCrSubsampling written for photometric 6
    with ``subsampling_tag`` (else libtiff takes the first strip's).
    ``planar=2`` with photometric 6 writes ``img``'s three samples as Y,
    Cb and Cr planes, each strip or tile a one-component JPEG, and
    YCbCrSubsampling 1x1 (libtiff's RGBA reader has no other planar
    case)."""
    h, w = img.shape[:2]
    planar = kw.pop("planar", 1)
    blocks = []
    for plane in [img] if planar == 1 else [img[:, :, c : c + 1] for c in range(img.shape[2])]:
        if tile is None:
            for y in range(0, h, rows_per_strip):
                blk = plane[y : y + rows_per_strip]
                if tall_last and len(blk) < rows_per_strip:
                    blk = np.pad(blk, ((0, rows_per_strip - len(blk)), (0, 0), (0, 0)),
                                 mode="edge")
                blocks.append(blk)
        else:
            tw, tl = tile
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    part = plane[y : y + tl, x : x + tw]
                    blocks.append(np.pad(part, ((0, tl - part.shape[0]), (0, tw - part.shape[1]),
                                                (0, 0)), mode="edge"))
    streams = [jpeg_encode(b, photometric if planar == 1 else 1, quality, sampling)
               for b in blocks]
    extra = list(kw.pop("extra_tags", ()))
    chunks = streams
    if tables:
        split = [jpeg_split(st) for st in streams]
        chunks = [b for _, b in split]
        extra.append((347, 7, list(split[0][0])))
    if photometric == 6 and subsampling_tag:
        extra.append((530, 3, list(_LUMA[sampling] if planar == 1 else (1, 1))))
    return tiff_bytes(img, photometric=photometric, compression="jpeg", tile=tile,
                      rows_per_strip=rows_per_strip, chunks=chunks, extra_tags=extra,
                      planar=planar, **kw)


def compress(raw: bytes, compression: str) -> bytes:
    if compression == "none":
        return raw
    if compression == "packbits":
        return packbits(raw)
    if compression == "lzw":
        return lzw(raw)
    if compression == "lzw_old":
        return lzw_old_style(raw)
    return zlib.compress(raw)


# --- the writer -------------------------------------------------------------------------

def _rows(block: np.ndarray, bits: int, order: str) -> bytes:
    """[rows, width, spp] samples -> bytes, each row padded to a byte."""
    if bits == 16:
        return block.astype(order + "u2").tobytes()
    if bits == 8:
        return block.astype(np.uint8).tobytes()
    flat = block.reshape(block.shape[0], -1).astype(np.uint8)
    per = 8 // bits
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad)))
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    packed = (flat.reshape(flat.shape[0], -1, per) << shifts).sum(axis=2, dtype=np.uint16)
    return packed.astype(np.uint8).tobytes()


def _predict(block: np.ndarray, bits: int) -> np.ndarray:
    """Horizontal differencing along each row, per sample."""
    dt = np.uint16 if bits == 16 else np.uint8
    b = block.astype(dt)
    out = b.copy()
    out[:, 1:] = b[:, 1:] - b[:, :-1]
    return out


def _predict_bytes(data: bytes, row: int) -> bytes:
    """Horizontal differencing of a subsampled YCbCr strip or tile as
    libtiff's predictor does it: over the data-unit bytes as if they were
    three-sample pixels, in pieces of ``row`` bytes (TIFFScanlineSize for
    strips, TIFFTileRowSize for tiles); a piece that is not whole pixels is
    left as it is (libtiff refuses to difference it)."""
    b = np.frombuffer(data, np.uint8).copy()
    if row % 3:
        return b.tobytes()
    whole = len(b) // row * row
    pix = b[:whole].reshape(-1, row // 3, 3)
    diff = pix.copy()
    diff[:, 1:] = pix[:, 1:] - pix[:, :-1]
    b[:whole] = diff.reshape(-1)
    return b.tobytes()


def tiff_bytes(samples: np.ndarray, bits: int = 8, photometric: int = 1,
               compression: str = "none", predictor: int = 1, planar: int = 1,
               tile=None, rows_per_strip: int = 8, order: str = "<",
               orientation=None, extra_samples=None, colormap=None,
               fill_order: int = 1, pages=None, t4options=None, extra_tags=(),
               chunks=None, subsampling=None) -> bytes:
    """One TIFF from ``samples`` ``[H, W, spp]`` (values below ``2**bits``):
    strips of ``rows_per_strip`` rows or tiles of ``tile = (w, h)``, chunky
    (``planar=1``) or planar (2), ``order`` ``"<"`` (II) or ``">"`` (MM).
    CCITT compressions code 1-bit samples with :func:`fax_encode`
    (``t4options`` written as tag 292 when given).  ``extra_tags`` are
    ``(tag, type, values)``: type 3 or 4 integers, 5 ``(numerator,
    denominator)`` pairs, 7 bytes.  ``chunks`` replaces the coded strips or
    tiles (the samples then only size the image).  ``subsampling`` ``(h,
    v)`` packs YCbCr samples (PhotometricInterpretation 6) into data units
    of ``h * v`` luma samples then Cb and Cr (each unit's chroma its mean,
    edges replicated) and writes tag 530.  ``pages`` are further
    ``tiff_bytes`` keyword dicts, written as later IFDs."""
    pages = [dict(samples=samples, bits=bits, photometric=photometric, compression=compression,
                  predictor=predictor, planar=planar, tile=tile, rows_per_strip=rows_per_strip,
                  orientation=orientation, extra_samples=extra_samples, colormap=colormap,
                  fill_order=fill_order, t4options=t4options, extra_tags=extra_tags,
                  chunks=chunks, subsampling=subsampling)] + list(pages or [])
    body = bytearray(b"II*\x00" if order == "<" else b"MM\x00*")
    body += struct.pack(order + "I", 0)
    link = 4  # where the next IFD offset goes
    for page in pages:
        ifd_at = _write_page(body, order, **{"bits": 8, "photometric": 1, "compression": "none",
                                             "predictor": 1, "planar": 1, "tile": None,
                                             "rows_per_strip": 8, "orientation": None,
                                             "extra_samples": None, "colormap": None,
                                             "fill_order": 1, "t4options": None,
                                             "extra_tags": (), "chunks": None,
                                             "subsampling": None, **page})
        body[link : link + 4] = struct.pack(order + "I", ifd_at)
        link = len(body) - 4
    return bytes(body)


def _write_page(body: bytearray, order: str, samples, bits, photometric, compression,
                predictor, planar, tile, rows_per_strip, orientation, extra_samples,
                colormap, fill_order, t4options, extra_tags, chunks, subsampling) -> int:
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, spp = samples.shape
    planes = [samples] if planar == 1 else [samples[:, :, i : i + 1] for i in range(spp)]
    coded, chunks = chunks, []
    for plane in planes if coded is None else ():
        if tile is None:
            blocks = [plane[y : y + rows_per_strip] for y in range(0, h, rows_per_strip)]
        else:
            tw, tl = tile
            blocks = []
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    t = np.zeros((tl, tw, plane.shape[2]), plane.dtype)
                    part = plane[y : y + tl, x : x + tw]
                    t[: part.shape[0], : part.shape[1]] = part
                    blocks.append(t)
        for blk in blocks:
            if predictor == 2 and subsampling is None:
                blk = _predict(blk, bits)
            if compression in ("ccitt_rle", "ccitt_rlew", "g3", "g4"):
                raw = fax_encode(blk[:, :, 0], compression, t4options or 0)
            elif subsampling is not None:
                units = ycbcr_units(blk, *subsampling)
                if predictor == 2:  # differenced as bytes, three apart, a row at a time
                    hs, vs = subsampling
                    row = 3 * tile[0] if tile else -(-w // hs) * (hs * vs + 2) // vs
                    units = _predict_bytes(units, row)
                raw = compress(units, compression)
            elif compression == "sgilog":
                raw = sgilog16(blk[:, :, 0])
            else:
                raw = compress(_rows(blk, bits, order), compression)
            if fill_order == 2:  # bits stored least significant first
                raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            chunks.append(raw)
    chunks = list(coded) if coded is not None else chunks
    offsets = []
    for c in chunks:
        if len(body) % 2:
            body.append(0)
        offsets.append(len(body))
        body += c
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
            (259, 3, [COMPRESSION[compression]]), (262, 3, [photometric])]
    if fill_order != 1:
        tags.append((266, 3, [fill_order]))
    if tile is None:
        tags.append((273, 4, offsets))
    if orientation is not None:
        tags.append((274, 3, [orientation]))
    tags.append((277, 3, [spp]))
    if tile is None:
        tags += [(278, 4, [rows_per_strip]), (279, 4, [len(c) for c in chunks])]
    tags.append((284, 3, [planar]))
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if colormap is not None:
        tags.append((320, 3, list(np.asarray(colormap, np.uint16).T.reshape(-1))))
    if tile is not None:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, offsets),
                 (325, 4, [len(c) for c in chunks])]
    if extra_samples is not None:
        tags.append((338, 3, [extra_samples]))
    if t4options is not None:
        tags.append((292, 4, [t4options]))
    if subsampling is not None:
        tags.append((530, 3, list(subsampling)))
    tags = sorted(tags + list(extra_tags), key=lambda t: t[0])

    def packed(typ, vals):
        if typ == 7:
            return bytes(vals), len(vals)
        if typ == 5:
            return struct.pack(order + "II" * len(vals), *(int(v) for p in vals for v in p)), \
                len(vals)
        return struct.pack(order + ("H" if typ == 3 else "I") * len(vals), *map(int, vals)), \
            len(vals)

    data, where = bytearray(), {}
    for tag, typ, vals in tags:  # values over 4 bytes go before the IFD
        raw, _ = packed(typ, vals)
        if len(raw) > 4:
            where[tag] = len(body) + len(data)
            data += raw + b"\0" * (len(raw) % 2)
    body += data
    ifd_at = len(body)
    body += struct.pack(order + "H", len(tags))
    for tag, typ, vals in tags:
        raw, count = packed(typ, vals)
        value = struct.pack(order + "I", where[tag]) if tag in where else raw.ljust(4, b"\0")
        body += struct.pack(order + "HHI", tag, typ, count) + value
    body += struct.pack(order + "I", 0)  # the next IFD, set by the caller
    return ifd_at


# --- the fixtures -----------------------------------------------------------------------

def _smooth(rng, h: int, w: int, channels: int = 3) -> np.ndarray:
    import cv2

    img = rng.integers(0, 256, (h, w, channels)).astype(np.uint8)
    return cv2.GaussianBlur(img, (3, 3), 0).reshape(h, w, channels)


def _line(rng) -> np.ndarray:
    """A small text line: light ground, dark strokes, noise of +-3."""
    h, w = 24, int(rng.integers(60, 90))
    img = np.full((h, w, 3), int(rng.integers(200, 256)), np.uint8)
    for _ in range(int(rng.integers(3, 8))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0 : y0 + int(rng.integers(2, 14)), x0 : x0 + int(rng.integers(1, 6))] = \
            rng.integers(0, 90, 3)
    return np.clip(img.astype(np.int16) + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)


def fixtures() -> dict:
    import cv2
    from PIL import Image

    rng = np.random.default_rng(20261020)
    files = {}
    rgb = _smooth(rng, 13, 19)
    for comp in ("none", "packbits", "lzw", "deflate", "zip"):
        files[f"rgb8_{comp}_13x19.tif"] = tiff_bytes(rgb, photometric=2, compression=comp,
                                                      rows_per_strip=5)
        if comp in ("lzw", "deflate", "zip"):
            files[f"rgb8_{comp}_pred2_13x19.tif"] = tiff_bytes(
                rgb, photometric=2, compression=comp, predictor=2, rows_per_strip=5)
    gray = _smooth(rng, 11, 17, 1)
    for phot, name in ((1, "minisblack"), (0, "miniswhite")):
        files[f"gray1_{name}_11x17.tif"] = tiff_bytes((gray > 127).astype(np.uint8), bits=1,
                                                       photometric=phot, compression="packbits")
        files[f"gray8_{name}_11x17.tif"] = tiff_bytes(gray, photometric=phot, compression="lzw")
        files[f"gray16_{name}_mm_11x17.tif"] = tiff_bytes(
            gray.astype(np.uint16) * 257 + rng.integers(0, 257, gray.shape).astype(np.uint16),
            bits=16, photometric=phot, compression="deflate", predictor=2, order=">")
    for bits, cmap_max, name in ((1, 65536, "map16"), (4, 65536, "map16"), (8, 65536, "map16"),
                                 (8, 256, "map8")):
        idx = rng.integers(0, 1 << bits, (12, 15, 1)).astype(np.uint8)
        cmap = rng.integers(0, cmap_max, (1 << bits, 3))
        files[f"palette{bits}_{name}_12x15.tif"] = tiff_bytes(idx, bits=bits, photometric=3,
                                                              colormap=cmap, compression="lzw")
    rgb16 = rng.integers(0, 65536, (10, 14, 3)).astype(np.uint16)
    files["rgb16_lzw_pred2_mm_10x14.tif"] = tiff_bytes(rgb16, bits=16, photometric=2,
                                                       compression="lzw", predictor=2, order=">")
    files["rgb16_deflate_10x14.tif"] = tiff_bytes(rgb16, bits=16, photometric=2,
                                                  compression="deflate")
    rgba = np.concatenate([_smooth(rng, 12, 16), rng.integers(0, 256, (12, 16, 1)).astype(np.uint8)], 2)
    for extra, name in ((2, "unassociated"), (1, "associated"), (0, "unspecified")):
        files[f"rgba8_{name}_12x16.tif"] = tiff_bytes(rgba, photometric=2, extra_samples=extra,
                                                      compression="lzw")
    files["rgba16_unassociated_planar_10x14.tif"] = tiff_bytes(
        np.concatenate([rgb16, rng.integers(0, 65536, (10, 14, 1)).astype(np.uint16)], 2),
        bits=16, photometric=2, extra_samples=2, planar=2, compression="deflate")
    files["gray_alpha8_12x16.tif"] = tiff_bytes(rgba[:, :, 2:], photometric=1, extra_samples=2)
    files["gray_alpha8_planar_12x16.tif"] = tiff_bytes(rgba[:, :, 2:], photometric=1,
                                                       extra_samples=2, planar=2)
    files["cmyk8_packbits_12x16.tif"] = tiff_bytes(rng.integers(0, 256, (12, 16, 4)).astype(np.uint8),
                                                   photometric=5, compression="packbits")
    files["rgb8_planar_lzw_pred2_13x19.tif"] = tiff_bytes(rgb, photometric=2, planar=2,
                                                          compression="lzw", predictor=2)
    big = _smooth(rng, 21, 37)
    files["rgb8_tiles16_lzw_21x37.tif"] = tiff_bytes(big, photometric=2, tile=(16, 16),
                                                     compression="lzw")
    files["rgb8_tiles32_none_21x37.tif"] = tiff_bytes(big, photometric=2, tile=(32, 32))
    files["rgb8_tiles_planar_deflate_mm_21x37.tif"] = tiff_bytes(
        big, photometric=2, tile=(16, 16), planar=2, compression="deflate", order=">")
    files["gray16_tiles_deflate_21x37.tif"] = tiff_bytes(
        rng.integers(0, 65536, (21, 37, 1)).astype(np.uint16), bits=16, tile=(32, 16),
        compression="deflate")
    small = _smooth(rng, 7, 11)
    for o in range(1, 9):
        files[f"orientation{o}_7x11.tif"] = tiff_bytes(small, photometric=2, orientation=o,
                                                       compression="lzw", rows_per_strip=3)
    for o in (2, 6):
        files[f"orientation{o}_tiles_21x37.tif"] = tiff_bytes(
            big, photometric=2, tile=(16, 16), orientation=o, compression="lzw")
    files["gray1_fillorder2_11x17.tif"] = tiff_bytes((gray < 100).astype(np.uint8), bits=1,
                                                     fill_order=2)
    files["two_pages_13x19.tif"] = tiff_bytes(rgb, photometric=2, compression="lzw",
                                              pages=[dict(samples=gray, photometric=1)])
    for comp in (1, 5, 8, 32773):
        ok, buf = cv2.imencode(".tiff", _smooth(rng, 12, 18), [cv2.IMWRITE_TIFF_COMPRESSION, comp])
        assert ok
        files[f"cv2_c{comp}_12x18.tif"] = buf.tobytes()
    ok, buf = cv2.imencode(".tiff", rng.integers(0, 65536, (9, 13)).astype(np.uint16))
    files["cv2_gray16_9x13.tif"] = buf.tobytes()
    src = _smooth(rng, 12, 18, 4)
    for mode, comp in (("RGB", "tiff_lzw"), ("RGBA", "tiff_adobe_deflate"), ("P", "packbits"),
                       ("1", None), ("LA", "tiff_deflate"), ("CMYK", "tiff_lzw"), ("L", "jpeg"),
                       ("1", "group4")):
        bio = io.BytesIO()
        kw = {"compression": comp} if comp else {}
        Image.fromarray(src, "RGBA").convert(mode).save(bio, format="TIFF", **kw)
        name = f"pil_{mode.lower()}_{comp or 'raw'}_12x18.tif"
        files[name] = bio.getvalue()
    for k in range(2):  # text lines for the card's daemon phase
        line = _line(rng)
        files[f"tiff_line_{k}.tif"] = tiff_bytes(line, photometric=2, compression=("lzw", "deflate")[k],
                                                 predictor=2, rows_per_strip=8)
    files.update(_fax_fixtures(rng))
    files.update(_ycbcr_fixtures(rng))
    files.update(_jpeg_fixtures(rng))
    files.update(_refusals())
    files.update(_variant_fixtures(np.random.default_rng(20261021)))
    return files


def _bilevel(rng, h: int, w: int) -> np.ndarray:
    """0/1 pixels: rectangles of 1 (text-like strokes) over 0, a few specks."""
    img = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(4, 12))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0 : y0 + int(rng.integers(1, 8)), x0 : x0 + int(rng.integers(1, 12))] = 1
    img[rng.random((h, w)) < 0.03] ^= 1
    return img[:, :, None]


def _ycc(rgb: np.ndarray) -> np.ndarray:
    """RGB -> Y, Cb, Cr (BT.601, full range), as a writer stores them."""
    import cv2

    return cv2.cvtColor(rgb, cv2.COLOR_RGB2YCrCb)[:, :, [0, 2, 1]]


def _fax_fixtures(rng) -> dict:
    from PIL import Image

    files = {}
    img = _bilevel(rng, 19, 37)
    for comp, t4, name in (("g4", None, "g4"), ("g3", 0, "g3_1d"), ("g3", 1, "g3_2d"),
                           ("g3", 5, "g3_2d_fill"), ("ccitt_rle", None, "mh")):
        for phot, pname in ((0, "miniswhite"), (1, "minisblack")):
            files[f"{name}_{pname}_19x37.tif"] = tiff_bytes(
                img, bits=1, photometric=phot, compression=comp, t4options=t4,
                rows_per_strip=7)
    files["g4_fillorder2_19x37.tif"] = tiff_bytes(img, bits=1, photometric=0, compression="g4",
                                                  fill_order=2, rows_per_strip=19)
    files["g3_2d_tiles_mm_19x37.tif"] = tiff_bytes(img, bits=1, photometric=0, compression="g3",
                                                   t4options=1, tile=(32, 16), order=">")
    # libtiff's RLEW reader drops the word alignment where its accumulator
    # holds 16 bits or more at a row's end (and warns on what follows), so
    # this one is three rows long
    files["ccitt_rlew_3x37.tif"] = tiff_bytes(img[:3], bits=1, photometric=0,
                                              compression="ccitt_rlew", rows_per_strip=3)
    wide = _bilevel(rng, 3, 2700)  # runs past 1728 and 2560: the extended make-up codes
    wide[1, 5:2690] = 1
    wide[2, :] = 0
    for comp, t4 in (("g4", None), ("g3", 1), ("ccitt_rle", None)):
        files[f"{comp}_wide_3x2700.tif"] = tiff_bytes(wide, bits=1, photometric=0,
                                                      compression=comp, t4options=t4)
    for comp in ("group3", "tiff_ccitt"):
        bio = io.BytesIO()
        Image.fromarray(img[:, :, 0] * 255).convert("1").save(bio, format="TIFF",
                                                              compression=comp)
        files[f"pil_1_{comp}_19x37.tif"] = bio.getvalue()
    for k in range(2):  # text lines for the card's daemon phase, G4 and G3 2-D
        line = (_line(rng).mean(axis=2) < 128).astype(np.uint8)[:, :, None]
        files[f"g4_line_{k}.tif"] = tiff_bytes(line, bits=1, photometric=0, compression="g4",
                                               rows_per_strip=len(line))
        line = (_line(rng).mean(axis=2) < 128).astype(np.uint8)[:, :, None]
        files[f"g3_line_{k}.tif"] = tiff_bytes(line, bits=1, photometric=0, compression="g3",
                                               t4options=5, rows_per_strip=len(line))
    return files


def _ycbcr_fixtures(rng) -> dict:
    from PIL import Image

    files = {}
    ycc = _ycc(_smooth(rng, 21, 29))
    rbw = (532, 5, [(15, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])
    luma = (529, 5, [(2126, 10000), (7152, 10000), (722, 10000)])
    for (hs, vs), comp, extra in (((1, 1), "none", ()), ((2, 2), "lzw", ()),
                                  ((2, 1), "packbits", (rbw,)), ((1, 2), "deflate", (luma,)),
                                  ((4, 2), "lzw", (rbw, luma)), ((4, 1), "deflate", ()),
                                  ((4, 4), "lzw", ())):
        files[f"ycbcr{hs}{vs}_{comp}_21x29.tif"] = tiff_bytes(
            ycc, photometric=6, compression=comp, subsampling=(hs, vs), rows_per_strip=8,
            extra_tags=extra)
    files["ycbcr44_tiles_lzw_21x29.tif"] = tiff_bytes(ycc, photometric=6, compression="lzw",
                                                      subsampling=(4, 4), tile=(16, 16))
    files["ycbcr22_tiles_deflate_mm_21x29.tif"] = tiff_bytes(
        ycc, photometric=6, compression="deflate", subsampling=(2, 2), tile=(16, 16), order=">")
    files["ycbcr11_planar_lzw_21x29.tif"] = tiff_bytes(
        ycc, photometric=6, compression="lzw", planar=2, extra_tags=[(530, 3, [1, 1])])
    files["ycbcr44_odd_rows_lzw_13x11.tif"] = tiff_bytes(
        ycc[:13, :11], photometric=6, compression="lzw", subsampling=(4, 4), rows_per_strip=13)
    bio = io.BytesIO()
    Image.fromarray(_smooth(rng, 12, 18)).convert("YCbCr").save(bio, format="TIFF")
    files["pil_ycbcr_raw_12x18.tif"] = bio.getvalue()
    for k in range(2):  # text lines for the card's daemon phase
        files[f"ycbcr_line_{k}.tif"] = tiff_bytes(_ycc(_line(rng)), photometric=6,
                                                  compression="lzw", subsampling=(2, 2),
                                                  rows_per_strip=8)
    return files


def _jpeg_fixtures(rng) -> dict:
    from PIL import Image

    files = {}
    rgb = _smooth(rng, 21, 37)
    # 2x2 chroma with sharp edges: fancy and plain upsampling part on them
    sharp = np.zeros((16, 24, 3), np.uint8)
    sharp[:, :, 1] = 120
    sharp[::4, :, 0] = 255
    sharp[:, ::6, 2] = 255
    sharp[5:11, 7:17] = (20, 200, 40)
    files["jpeg_ycbcr420_sharp_16x24.tif"] = jpeg_tiff(sharp, 6, rows_per_strip=16,
                                                       sampling="420", quality=95)
    for phot, sampling, name, kw in (
            (1, "444", "gray", dict(rows_per_strip=8)),
            (2, "444", "rgb", dict(rows_per_strip=8)),
            (6, "420", "ycbcr420", dict(rows_per_strip=16)),
            (6, "422", "ycbcr422_tiles", dict(tile=(16, 16))),
            (6, "411", "ycbcr411_notag", dict(rows_per_strip=8, subsampling_tag=False)),
            (6, "440", "ycbcr440_tall_last", dict(rows_per_strip=16, tall_last=True)),
            (6, "444", "ycbcr444_no_tables_mm", dict(rows_per_strip=16, tables=False,
                                                     order=">")),
            (2, "444", "rgb_tiles_tall", dict(tile=(16, 32)))):
        img = rgb[:, :, :1] if phot == 1 else rgb
        files[f"jpeg_{name}_21x37.tif"] = jpeg_tiff(img, phot, sampling=sampling, **kw)
    for mode in ("RGB", "YCbCr"):
        bio = io.BytesIO()
        Image.fromarray(_smooth(rng, 12, 18)).convert(mode).save(bio, format="TIFF",
                                                                 compression="jpeg")
        files[f"pil_{mode.lower()}_jpeg_12x18.tif"] = bio.getvalue()
    for k in range(2):  # text lines for the card's daemon phase
        files[f"jpeg_line_{k}.tif"] = jpeg_tiff(_line(rng), 6, sampling="420",
                                                rows_per_strip=16)
    return files


def _relabelled(compression: int) -> bytes:
    """An LZW file whose compression tag says ``compression``."""
    data = bytearray(tiff_bytes(np.zeros((4, 5, 1), np.uint8), compression="lzw"))
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    for i in range(n):
        e = ifd + 2 + 12 * i
        if struct.unpack_from("<H", data, e)[0] == 259:
            struct.pack_into("<H", data, e + 8, compression)
    return bytes(data)


def _refusals() -> dict:
    """The files cv2 gives ``None`` on (:data:`CV2_NONE`), and an SGI
    LogLuv file the port refused before it read LogLuv (its name kept)."""
    from PIL import Image

    files = {}
    gray = np.arange(40, dtype=np.uint8).reshape(5, 8)
    for mode, kw, name in (("L", {"compression": "zstd"}, "zstd"), ("F", {}, "float"),
                           ("I", {}, "signed32")):
        bio = io.BytesIO()
        Image.fromarray(gray).convert(mode).save(bio, format="TIFF", **kw)
        files[f"none_{name}.tif"] = bio.getvalue()
    for code, name in ((6, "old_jpeg"), (34925, "lzma"), (50001, "webp"), (34887, "lerc"),
                       (32909, "pixarlog")):
        files[f"none_{name}.tif"] = _relabelled(code)
    files["none_bigtiff_no_directory.tif"] = b"II+\x00\x08\x00\x00\x00" + bytes(16)
    g = gray[:, :, None]
    files["none_untyped.tif"] = tiff_bytes(g, extra_tags=[(339, 3, [4])])
    files["none_float16.tif"] = tiff_bytes(g.astype(np.uint16), bits=16,
                                           extra_tags=[(339, 3, [3])])
    rgb = np.repeat(g, 3, axis=2)
    files["none_icclab.tif"] = tiff_bytes(rgb, photometric=9)
    files["none_itulab.tif"] = tiff_bytes(rgb, photometric=10)
    files["none_thunderscan4.tif"] = tiff_bytes(g >> 4, bits=4, compression="none",
                                                extra_tags=[])
    files["refused_logluv16.tif"] = tiff_bytes(
        np.zeros((2, 3, 3), np.uint16), bits=16, photometric=32845, compression="sgilog",
        rows_per_strip=2, chunks=[bytes([3, 1, 2, 3] * 8)])
    return files


# the files ``cv2.imdecode`` gives None on, and the words the port's
# ValueError names each by; the tests and the card's smoke read them,
# expected.npz has no pixels for them
CV2_NONE = {"none_zstd.tif": "ZSTD TIFF compression (50000)",
            "none_old_jpeg.tif": "old-style JPEG TIFF compression (6)",
            "none_lzma.tif": "LZMA TIFF compression (34925)",
            "none_webp.tif": "WebP TIFF compression (50001)",
            "none_lerc.tif": "LERC TIFF compression (34887)",
            "none_pixarlog.tif": "PixarLog TIFF compression (32909)",
            "none_float.tif": "floating-point TIFF samples",
            "none_float16.tif": "floating-point TIFF samples",
            "none_untyped.tif": "untyped TIFF samples",
            "none_signed32.tif": "32-bit TIFF samples",
            "none_icclab.tif": "ICCLab TIFF",
            "none_itulab.tif": "ITULab TIFF",
            "none_thunderscan4.tif": "4-bit TIFF samples",
            "none_bigtiff_no_directory.tif": "directory"}


def _variant_fixtures(rng) -> dict:
    """BigTIFF (PIL's), signed gray, old-style LZW, planar YCbCr JPEG,
    CIELab and SGI LogL, and a text line of each of BigTIFF and CIELab for
    the card's daemon phase."""
    from PIL import Image

    files = {}
    src = _smooth(rng, 9, 14, 4)
    for mode, comp in (("RGB", "tiff_lzw"), ("L", None), ("I;16", None), ("1", "group4")):
        bio = io.BytesIO()
        kw = {"compression": comp} if comp else {}
        Image.fromarray(src, "RGBA").convert(mode).save(bio, format="TIFF", big_tiff=True, **kw)
        files[f"bigtiff_pil_{mode.lower().replace(';', '')}_{comp or 'raw'}_9x14.tif"] = \
            bio.getvalue()
    files["bigtiff_tiles_mm_11x20.tif"] = big_tiff(tiff_bytes(
        _smooth(rng, 11, 20), photometric=2, tile=(16, 16), compression="lzw", order=">"))
    span = (np.arange(10 * 13) * 2 - 128).reshape(10, 13, 1)  # -128 .. 130, wrapping
    files["signed8_gray_lzw_10x13.tif"] = tiff_bytes(
        (span & 255).astype(np.uint8), compression="lzw", extra_tags=[(339, 3, [2])])
    files["signed16_gray_minisblack_10x13.tif"] = tiff_bytes(
        ((span * 251) & 0xFFFF).astype(np.uint16), bits=16, extra_tags=[(339, 3, [2])])
    files["signed16_gray_miniswhite_mm_10x13.tif"] = tiff_bytes(
        ((span * 257 - 99) & 0xFFFF).astype(np.uint16), bits=16, photometric=0, order=">",
        extra_tags=[(339, 3, [2])])
    old = _smooth(rng, 14, 27)
    files["lzw_old_rgb8_14x27.tif"] = tiff_bytes(old, photometric=2, compression="lzw_old",
                                                 rows_per_strip=5)
    files["lzw_old_gray16_pred2_tiles_14x27.tif"] = tiff_bytes(
        rng.integers(0, 65536, (14, 27, 1)).astype(np.uint16), bits=16, compression="lzw_old",
        predictor=2, tile=(16, 16))
    files["jpeg_ycbcr_planar_17x23.tif"] = jpeg_tiff(_ycc(_smooth(rng, 17, 23)), 6, planar=2,
                                                      rows_per_strip=8)
    files["jpeg_ycbcr_planar_tiles_17x23.tif"] = jpeg_tiff(_ycc(_smooth(rng, 17, 23)), 6,
                                                            planar=2, tile=(16, 16))
    lab = _smooth(rng, 11, 16)
    files["cielab8_lzw_11x16.tif"] = tiff_bytes(lab, photometric=8, compression="lzw")
    files["cielab16_whitepoint_11x16.tif"] = tiff_bytes(
        rng.integers(0, 65536, (11, 16, 3)).astype(np.uint16), bits=16, photometric=8,
        extra_tags=[(318, 5, [(3127, 10000), (3290, 10000)])])
    bio = io.BytesIO()
    Image.fromarray(_smooth(rng, 10, 15)).convert("LAB").save(bio, format="TIFF")
    files["pil_lab_raw_10x15.tif"] = bio.getvalue()
    logl = rng.integers(-2000, 32768, (12, 17, 1))
    logl[:4, :] = 20000  # runs for the run-length code
    files["sgilog_logl_12x17.tif"] = tiff_bytes(
        (logl & 0xFFFF).astype(np.uint16), bits=16, photometric=32844, compression="sgilog",
        rows_per_strip=5, extra_tags=[(339, 3, [2])])
    line = _line(rng)
    bio = io.BytesIO()
    Image.fromarray(line).save(bio, format="TIFF", big_tiff=True, compression="tiff_lzw")
    files["bigtiff_line_0.tif"] = bio.getvalue()
    bio = io.BytesIO()
    Image.fromarray(_line(rng)).convert("LAB").save(bio, format="TIFF", compression="tiff_lzw")
    files["cielab_line_0.tif"] = bio.getvalue()
    return files


# the 24-bit LogLuv index nearest the neutral (u', v') = (0.2105, 0.4737)
LUV24_NEUTRAL = 12266


def _logluv_line(rng, bits24: bool) -> np.ndarray:
    """A text line (:func:`_line`'s) as gray LogLuv values: each pixel's
    luminance ``((g + 0.5) / 256)**2`` as a log luminance, the chromaticity
    neutral (bytes 86 and 194, or :data:`LUV24_NEUTRAL`)."""
    g = _line(rng).astype(np.float64).mean(axis=2)
    y = ((g + 0.5) / 256.0) ** 2
    if bits24:
        le = np.clip(np.floor(64.0 * (np.log2(y) + 12.0)), 1, 1023).astype(np.uint32)
        return le << 14 | LUV24_NEUTRAL
    le = np.clip(np.floor(256.0 * (np.log2(y) + 64.0)), 1, 32767).astype(np.uint32)
    return le << 16 | 86 << 8 | 194


def _logluv_fixtures(rng) -> dict:
    """SGI LogLuv32 and LogLuv24 at 8 and 16 bits (strips, tiles, MM,
    runs, black and negative luminances, indices past the table), the
    horizontal predictor on subsampled YCbCr (strips and tiles, where
    libtiff undoes it and where it refuses to), and a text line of each
    LogLuv kind for the card's daemon phase."""
    files = {}
    v32 = rng.integers(0, 1 << 32, (13, 19), dtype=np.uint64).astype(np.uint32)
    v32[:4] = (v32[:4] & 0xFFFF) | (rng.integers(0x3000, 0x4800, (4, 19)).astype(np.uint32) << 16)
    v32[4, :9] = v32[4, 0]  # a run in every plane
    v32[5, :3] = 0  # black: Le 0
    files["logluv32_16_strips_13x19.tif"] = logluv_tiff(v32, bits=16, rows_per_strip=5)
    files["logluv32_8_tiles_mm_13x19.tif"] = logluv_tiff(v32, bits=8, tile=(16, 16), order=">")
    v24 = rng.integers(0, 1 << 24, (13, 19)).astype(np.uint32)
    v24[:4] = (rng.integers(300, 900, (4, 19)).astype(np.uint32) << 14) | (v24[:4] & 0x3FFF)
    v24[4, :5] = 16289 + np.arange(5, dtype=np.uint32)  # past the table: neutral
    files["logluv24_8_strips_13x19.tif"] = logluv_tiff(v24, compression="sgilog24", bits=8,
                                                       rows_per_strip=4)
    files["logluv24_16_tiles_13x19.tif"] = logluv_tiff(v24, compression="sgilog24", bits=16,
                                                       tile=(16, 16))
    ycc = _ycc(_smooth(rng, 21, 29))
    for (hs, vs), comp, tile in (((2, 2), "lzw", None), ((2, 1), "deflate", None),
                                 ((1, 2), "lzw", (16, 16)), ((4, 2), "deflate", None),
                                 ((4, 4), "lzw", (16, 16)), ((4, 2), "zip", (16, 16))):
        where = "tiles" if tile else "strips"
        files[f"ycbcr{hs}{vs}_pred2_{comp}_{where}_21x29.tif"] = tiff_bytes(
            ycc, photometric=6, compression=comp, predictor=2, subsampling=(hs, vs), tile=tile,
            rows_per_strip=8)
    files["luv32_line_0.tif"] = logluv_tiff(_logluv_line(rng, False), bits=16, rows_per_strip=8)
    files["luv24_line_0.tif"] = logluv_tiff(_logluv_line(rng, True), compression="sgilog24",
                                            bits=8, rows_per_strip=8)
    return files


def big_tiff(data: bytes) -> bytes:
    """A classic TIFF rewritten as a BigTIFF: the same data, the first IFD
    moved to the end with 20-byte entries, LONG offsets and counts kept."""
    order = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(order + "I", data, 4)
    (n,) = struct.unpack_from(order + "H", data, ifd)
    sizes = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
    body = bytearray(data[:2] + struct.pack(order + "HHHQ", 43, 8, 0, 0) + data[8:])
    shift = 8  # the BigTIFF header is 16 bytes, the classic 8
    entries = []
    for i in range(n):
        tag, typ, count = struct.unpack_from(order + "HHI", data, ifd + 2 + 12 * i)
        size = sizes[typ] * count
        if size <= 4:
            raw = data[ifd + 10 + 12 * i : ifd + 10 + 12 * i + size]
        else:
            (at,) = struct.unpack_from(order + "I", data, ifd + 10 + 12 * i)
            raw = data[at : at + size]
        if tag in (273, 324):  # offsets of strips or tiles move with the header
            vals = struct.unpack(order + ("I" if typ == 4 else "H") * count, raw)
            typ, raw = 16, struct.pack(order + "Q" * count, *(v + shift for v in vals))
            size = len(raw)
        if size <= 8:
            value = raw.ljust(8, b"\0")
        else:
            value = struct.pack(order + "Q", len(body))
            body += raw
        entries.append(struct.pack(order + "HHQ", tag, typ, count) + value)
    at = len(body)
    body += struct.pack(order + "Q", n) + b"".join(entries) + struct.pack(order + "Q", 0)
    struct.pack_into(order + "Q", body, 8, at)
    return bytes(body)


def _gray_alpha_jpeg_fixtures(rng) -> dict:
    """Gray + alpha (SamplesPerPixel 2) JPEG-in-TIFF: libtiff decodes each
    two-component frame as it is, and cv2 shows the gray sample."""
    from PIL import Image

    files = {}
    for h, w in ((23, 61), (8, 8), (9, 8), (8, 9), (9, 9), (1, 1), (17, 33)):
        gray = _smooth(rng, h, w, 1)[:, :, 0]
        la = np.dstack([gray, rng.integers(0, 256, (h, w)).astype(np.uint8)])
        for name, kw in (("strips", dict(compression="jpeg")),
                         ("strips8", dict(compression="jpeg", strip_size=8 * w * 2)),
                         ("tiles16", dict(compression="jpeg", tile=(16, 16))),
                         ("q20", dict(compression="jpeg", quality=20))):
            if name == "strips8" and h <= 8:
                continue
            bio = io.BytesIO()
            Image.fromarray(la, "LA").save(bio, format="TIFF", **kw)
            files[f"pil_la_jpeg_{name}_{h}x{w}.tif"] = bio.getvalue()
    la = np.dstack([_smooth(rng, 17, 23, 1), rng.integers(0, 256, (17, 23, 1)).astype(np.uint8)])
    files["la_jpeg_planar_17x23.tif"] = jpeg_tiff(la, 1, planar=2, extra_samples=2)
    files["la_jpeg_planar_tiles_17x23.tif"] = jpeg_tiff(la, 1, planar=2, tile=(16, 16),
                                                         extra_samples=2)
    return files


def write(out: str, files: dict) -> None:
    """Write ``files`` and cv2's pixels of them (``expected.npz``) into ``out``."""
    import cv2

    os.makedirs(out, exist_ok=True)
    expected = {}
    for name, data in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if name in CV2_NONE:
            assert bgr is None, name
            continue
        assert bgr is not None, name
        expected[name] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    np.savez_compressed(os.path.join(out, "expected.npz"), **expected)
    total = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"wrote {len(files)} TIFFs and expected.npz into {out}: {total} bytes")
    for name in sorted(set(os.listdir(out)) - set(files) - {"expected.npz"}):
        print(f"  {name} is written by no fixture any more")


def main() -> None:
    write(OUT, fixtures())
    write(OUT_VARIANTS, _logluv_fixtures(np.random.default_rng(20261019)))
    write(OUT_GRAY_ALPHA, _gray_alpha_jpeg_fixtures(np.random.default_rng(20261021)))


if __name__ == "__main__":
    main()
