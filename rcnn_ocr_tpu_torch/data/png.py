"""PNG without OpenCV or libpng: what ``cv2.imdecode(buf, IMREAD_COLOR)``
gives for a PNG, then BGR -> RGB, pixel for pixel.

OpenCV 5 walks the chunks before the first ``IDAT`` itself (for APNG),
then has libpng 1.6 read the file with its sequential reader
(``png_read_info``, the rows, ``png_read_end``), and turns the image by the
``eXIf`` chunk's orientation.  This module follows that reading:

* OpenCV's walk: the first chunk is a 13-byte ``IHDR``; an ``acTL`` of 8
  bytes and at least one frame, an ``fcTL`` of 26 bytes whose frame lies
  inside the image, a ``bKGD`` of 1, 2 or 6 bytes; no chunk but ``IDAT``,
  ``fdAT`` and ``tEXt`` over 7,999,988 bytes (OpenCV's and libpng's
  8,000,000-byte chunk limit).  CRCs are not checked there.
* libpng's chunk rules: every chunk up to ``IEND`` must be whole (a file
  cut before ``IEND`` fails), with a length under 2**31, four ASCII
  letters for its type and the reserved bit (the third letter's case)
  clear.  A critical chunk whose CRC fails fails the file (``IEND`` is read
  as ancillary); an ancillary one is dropped.  ``IHDR`` once and first, its
  fields valid; ``PLTE`` before the image data and, for a palette image,
  once, of 1-256 entries (for other colour types a bad ``PLTE`` is
  dropped); no ``IEND`` before ``IDAT``; no unknown critical chunk.
* the image data as libpng inflates it: ``IDAT`` chunks read in pieces of
  8,192 bytes, the rows filled from one unbroken run of ``IDAT`` chunks (a
  chunk of another type inside the run fails the file while rows are
  still missing, and so does a zlib stream that ends early or is damaged
  there).  Once the last row is in, the rest of the stream is checked as
  libpng checks it after the image: a damaged tail or a bad Adler-32 that
  libpng meets only then is a warning, but a stream whose end lies past
  the run of ``IDAT`` chunks fails.  Trailing data and extra ``IDAT``
  chunks are warnings, their CRCs still checked.
* pixels: bit depths 1/2/4/8/16; gray, gray+alpha, RGB, RGBA and palette;
  plain or Adam7-interlaced; row filters None/Sub/Up/Average/Paeth.  16-bit
  samples keep their high byte, gray samples under 8 bits are scaled to
  0..255, alpha and transparency are dropped (not composited), a palette
  index past the palette reads black (libpng's zeroed 256-entry palette).
  ``gAMA``, ``sBIT``, ``bKGD`` and the colour chunks change nothing.
* orientation: the first ``eXIf`` chunk whose CRC holds and that starts
  ``II*\\0`` or ``MM\\0*`` (libpng drops the others), before or after the
  image data, read by :mod:`~rcnn_ocr_tpu_torch.data.exif`.  The header
  probe ``image_io.image_size`` keeps JAX's IHDR sides, unturned.

Where cv2 gives ``None`` this raises ``ValueError`` naming the cause.  An
APNG's default image is what cv2 returns; its frames are not decoded.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.data import exif
from rcnn_ocr_tpu_torch.data.size_limit import PNG_MAX_SIDE, check_size

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_PIECE = 8192  # libpng's IDAT_read_size
_CHUNK_LIMIT = 8_000_000 - 12  # PNG_USER_CHUNK_MALLOC_MAX less the chunk's framing
_EXIF_HEADS = (b"II*\x00", b"MM\x00*")


class _Chunk:
    __slots__ = ("kind", "start", "length", "crc_ok")

    def __init__(self, kind: bytes, start: int, length: int, crc_ok: bool):
        self.kind, self.start, self.length, self.crc_ok = kind, start, length, crc_ok

    @property
    def critical(self) -> bool:
        return not self.kind[0] & 0x20


def _chunks(data: bytes) -> Iterator[_Chunk]:
    """The chunks after the signature, each checked as libpng reads its
    header and data (the last one may be cut: the caller fails only when
    libpng would reach it)."""
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG data is truncated before its IEND chunk")
        length, kind = struct.unpack_from(">I4s", data, pos)
        if length > 0x7FFFFFFF:
            raise ValueError(f"PNG chunk length {length} is over 2**31 - 1")
        if not all(0x41 <= (c & ~0x20) <= 0x5A for c in kind):
            raise ValueError(f"PNG chunk type {kind!r} is not four letters")
        if kind[2] & 0x20:
            raise ValueError(f"PNG chunk type {kind!r} has its reserved bit set")
        if pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        crc = struct.unpack_from(">I", data, pos + 8 + length)[0]
        yield _Chunk(kind, pos + 8, length, zlib.crc32(data[pos + 4 : pos + 8 + length]) == crc)
        pos += 12 + length


def _opencv_walk(data: bytes) -> None:
    """OpenCV's own pass over the chunks before the first IDAT."""
    pos = len(SIGNATURE)
    first = True
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        if first and (kind != b"IHDR" or length != 13):
            raise ValueError(f"PNG starts with a {length}-byte {kind!r} chunk, not a 13-byte IHDR")
        first = False
        if kind == b"IDAT":
            return
        if pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        body = data[pos + 8 : pos + 8 + length]
        if kind == b"acTL" and (length != 8 or struct.unpack(">I", body[:4])[0] == 0):
            raise ValueError("PNG acTL chunk is not 8 bytes of at least one frame")
        if kind == b"fcTL":
            ihdr_w, ihdr_h = struct.unpack_from(">II", data, len(SIGNATURE) + 8)
            if length != 26:
                raise ValueError("PNG fcTL chunk is not 26 bytes")
            w, h, x, y = struct.unpack(">IIII", body[4:20])
            if x + w > ihdr_w or y + h > ihdr_h:
                raise ValueError("PNG fcTL frame lies outside the image")
        if kind == b"bKGD" and length not in (1, 2, 6):
            raise ValueError(f"PNG bKGD chunk of {length} bytes")
        if length > _CHUNK_LIMIT and kind not in (b"IDAT", b"fdAT", b"tEXt"):
            raise ValueError(f"PNG chunk {kind!r} of {length} bytes is over OpenCV's limit")
        pos += 12 + length


def _ihdr(data: bytes, c: _Chunk) -> Tuple[int, int, int, int, int]:
    if c.length != 13:
        raise ValueError(f"PNG IHDR of {c.length} bytes")
    if not c.crc_ok:
        raise ValueError("PNG chunk b'IHDR' fails its CRC")
    width, height, depth, ctype, comp, filt, interlace = struct.unpack_from(">IIBBBBB", data,
                                                                            c.start)
    if not 0 < width <= 0x7FFFFFFF or not 0 < height <= 0x7FFFFFFF:
        raise ValueError(f"PNG of {width}x{height} pixels")
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"PNG color type {ctype} / bit depth {depth} is invalid")
    if comp or filt or interlace > 1:
        raise ValueError(f"PNG compression {comp}, filter {filt}, interlace {interlace} is invalid")
    check_size(width, height, "PNG", max_side=PNG_MAX_SIDE)
    return width, height, depth, ctype, interlace


class _Reader:
    """libpng's sequential reader over the chunks of one file."""

    def __init__(self, data: bytes):
        self.data = data
        self.it = _chunks(data)
        self.ctype = 0
        self.plte: Optional[np.ndarray] = None
        self.exif: Optional[bytes] = None
        self.cur: Optional[_Chunk] = None  # the IDAT chunk being read
        self.used = 0  # of cur's data

    def ancillary(self, c: _Chunk, after_idat: bool) -> None:
        """A chunk other than IHDR, IDAT and IEND."""
        if c.critical and c.kind != b"PLTE":
            raise ValueError(f"PNG critical chunk {c.kind!r} is unknown")
        palette = c.kind == b"PLTE" and self.ctype == 3
        if not c.crc_ok:
            if palette and not after_idat:
                raise ValueError("PNG chunk b'PLTE' fails its CRC")
            return  # dropped with a warning
        body = self.data[c.start : c.start + c.length]
        if c.kind == b"PLTE":
            if after_idat or not self.ctype & 2:
                return  # out of place, or a gray image's: ignored
            ok = c.length and c.length % 3 == 0 and c.length <= 768 and self.plte is None
            if palette and not ok:
                raise ValueError(f"PNG PLTE of {c.length} bytes is invalid or repeated")
            if ok:
                self.plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif c.kind == b"eXIf" and self.exif is None and body[:4] in _EXIF_HEADS:
            self.exif = body

    def pieces(self) -> Iterator[bytes]:
        """The image data as libpng feeds it to zlib: 8,192-byte pieces of
        each IDAT chunk, the next chunk's header read when one runs out."""
        while True:
            c = self.cur
            while self.used < c.length:
                n = min(_PIECE, c.length - self.used)
                self.used += n
                yield self.data[c.start + self.used - n : c.start + self.used]
            if not c.crc_ok:
                raise ValueError("PNG chunk b'IDAT' fails its CRC")
            nxt = next(self.it)
            if nxt.kind != b"IDAT":
                raise ValueError(f"PNG image data runs into a {nxt.kind.decode('latin-1')!r} "
                                 "chunk before its zlib stream ends")
            self.cur, self.used = nxt, 0

    def read(self) -> Tuple[Tuple[int, int, int, int, int], bytes]:
        c = next(self.it)
        ihdr = _ihdr(self.data, c)
        self.ctype = ihdr[3]
        for c in self.it:  # png_read_info: up to the first IDAT
            if c.kind == b"IDAT":
                break
            if c.kind in (b"IHDR", b"IEND"):
                raise ValueError(f"PNG chunk {c.kind!r} before the image data")
            self.ancillary(c, after_idat=False)
        if self.ctype == 3 and self.plte is None:
            raise ValueError("palette PNG without a PLTE before its IDAT")
        self.cur = c
        raw = self.inflate(ihdr)
        for c in self.it:  # png_read_end: up to IEND
            if c.kind == b"IEND":
                break
            if c.kind == b"IHDR":
                raise ValueError("PNG chunk b'IHDR' after the image data")
            if c.kind == b"IDAT":
                if not c.crc_ok:
                    raise ValueError("PNG chunk b'IDAT' fails its CRC")
                continue  # "Too many IDATs found": a warning
            self.ancillary(c, after_idat=True)
        return ihdr, raw

    def inflate(self, ihdr) -> bytes:
        width, height, depth, ctype, interlace = ihdr
        bits = _CHANNELS[ctype] * depth
        total = 0
        for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw > 0 and ph > 0:
                total += ph * (1 + -(-pw * bits // 8))
        z = zlib.decompressobj()
        out: List[bytes] = []
        got, tail = 0, b""
        pieces = self.pieces()
        while got < total:  # the rows: every fault is fatal
            if not tail:
                tail = next(pieces)
            try:
                part = z.decompress(tail, total - got)
            except zlib.error as err:
                raise ValueError(f"PNG image data is damaged: {err}") from None
            out.append(part)
            got += len(part)
            tail = z.unconsumed_tail
            if z.eof and got < total:
                raise ValueError("PNG image data ends before the image is whole")
        extra = 0
        while not z.eof:  # after the last row: png_read_finish_IDAT
            if not tail:
                tail = next(pieces)  # a chunk of another type here fails
            try:
                extra += len(z.decompress(tail, 1024))
            except zlib.error:
                break  # a warning
            tail = z.unconsumed_tail
            if extra == 0:
                break
        if not self.cur.crc_ok:  # the rest of the last chunk read is skipped, its CRC checked
            raise ValueError("PNG chunk b'IDAT' fails its CRC")
        return b"".join(out)


def _unfilter(data: bytes, pos: int, h: int, stride: int, bpp: int) -> Tuple[np.ndarray, int]:
    """Undo the row filters of ``h`` scanlines of ``stride`` bytes starting at
    ``data[pos]``; returns the ``[h, stride]`` uint8 rows and the new position."""
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
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


def decode(data: bytes) -> np.ndarray:
    """A PNG file -> RGB uint8 ``[H, W, 3]``, as ``cv2.imdecode(data,
    IMREAD_COLOR)`` then BGR -> RGB gives it; ``ValueError`` where OpenCV
    gives ``None``."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    _opencv_walk(data)
    reader = _Reader(data)
    (width, height, depth, ctype, interlace), raw = reader.read()
    channels = _CHANNELS[ctype]
    bits = channels * depth
    bpp = max(1, bits // 8)
    img = np.empty((height, width, channels), np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        rows, pos = _unfilter(raw, pos, ph, -(-pw * bits // 8), bpp)
        img[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    if ctype == 3:
        palette = np.zeros((256, 3), np.uint8)
        palette[: len(reader.plte)] = reader.plte
        rgb = palette[img[:, :, 0]]
    else:
        if depth < 8:
            img = img * np.uint8(255 // ((1 << depth) - 1))
        # gray (+ alpha): the gray sample on all three channels
        rgb = np.repeat(img[:, :, :1], 3, axis=2) if channels <= 2 else img[:, :, :3]
    o = exif.orientation(reader.exif) if reader.exif is not None else 1
    return exif.apply(rgb, o)
