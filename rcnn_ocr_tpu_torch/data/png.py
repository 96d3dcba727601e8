"""PNG without OpenCV or libpng: what ``cv2.imdecode(buf, IMREAD_COLOR)``
gives for a PNG, then BGR -> RGB, pixel for pixel.

OpenCV 5 walks the chunks before the first ``IDAT`` itself (for APNG),
then has libpng 1.6 read the file with its sequential reader
(``png_read_info``, the rows, ``png_read_end``), and turns the image by the
``eXIf`` chunk's orientation.  This module follows that reading:

* OpenCV's walk: the first chunk is a 13-byte ``IHDR``; an ``acTL`` of 8
  bytes and at least one frame, an ``fcTL`` of 26 bytes whose frame lies
  inside the image and whose dispose and blend ops are at most 2 and 1, a
  ``bKGD`` of 1, 2 or 6 bytes; no chunk but ``IDAT``, ``fdAT`` and
  ``tEXt`` over 7,999,988 bytes (OpenCV's and libpng's 8,000,000-byte
  chunk limit).  CRCs are not checked there.
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

An APNG (the last ``acTL`` before ``IDAT`` counts two frames or more) is
read as OpenCV's own APNG path reads it, which returns the first frame:
where no ``fcTL`` precedes ``IDAT`` the ``IDAT`` image is hidden and the
first frame comes from the ``fdAT`` chunks after the next ``fcTL``.  That
path feeds libpng's progressive reader chunk by chunk and checks no CRC
and no sequence number; :func:`_apng_first_frame` gives its rules.  It
draws the frame's rectangle on a zero canvas (the first frame's blend and
dispose ops change nothing), converts 16-bit samples as ``convertTo(CV_8U,
1/255)`` and applies no ``eXIf`` orientation.  Two cases differ from cv2,
which returns memory there that no decoder wrote: rows that neither the
``IDAT`` image nor the frame wrote, and an interlaced frame whose data
stops short (libpng's partial passes); both raise ``ValueError``.

Where cv2 gives ``None`` this raises ``ValueError`` naming the cause, and
so it does where cv2's process dies (libpng errors inside OpenCV's APNG
frame loop).
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


def _opencv_chunk(kind: bytes, body: bytes, width: int, height: int,
                  before_idat: bool = True) -> None:
    """OpenCV's own checks of one chunk (its ``read_chunk``), before the
    first IDAT and, for an APNG, while it reads the first frame."""
    length = len(body)
    if kind == b"IHDR" and length != 13:
        raise ValueError(f"PNG IHDR chunk of {length} bytes")
    if kind == b"acTL" and (length != 8 or (before_idat
                                            and struct.unpack(">I", body[:4])[0] == 0)):
        raise ValueError("PNG acTL chunk is not 8 bytes of at least one frame")
    if kind == b"fcTL":
        if length != 26:
            raise ValueError("PNG fcTL chunk is not 26 bytes")
        w, h, x, y = struct.unpack(">IIII", body[4:20])
        if x + w > width or y + h > height:
            raise ValueError("PNG fcTL frame lies outside the image")
        if body[24] > 2 or body[25] > 1:
            raise ValueError(f"PNG fcTL of dispose op {body[24]}, blend op {body[25]}")
    if kind == b"bKGD" and length not in (1, 2, 6):
        raise ValueError(f"PNG bKGD chunk of {length} bytes")
    if length > _CHUNK_LIMIT and kind not in (b"IDAT", b"fdAT", b"tEXt"):
        raise ValueError(f"PNG chunk {kind!r} of {length} bytes is over OpenCV's limit")


class _Walk:
    """What OpenCV's pass before the first IDAT finds: the frame count of
    the last ``acTL`` (0: none), the last ``fcTL``'s body (None: none) and
    where the first IDAT chunk starts."""
    __slots__ = ("frames", "fctl", "idat")

    def __init__(self):
        self.frames, self.fctl, self.idat = 0, None, -1


def _opencv_walk(data: bytes) -> _Walk:
    """OpenCV's own pass over the chunks before the first IDAT."""
    walk = _Walk()
    pos = len(SIGNATURE)
    first = True
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        if first and (kind != b"IHDR" or length != 13):
            raise ValueError(f"PNG starts with a {length}-byte {kind!r} chunk, not a 13-byte IHDR")
        first = False
        if kind == b"IDAT":
            walk.idat = pos
            return walk
        if pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        body = data[pos + 8 : pos + 8 + length]
        _opencv_chunk(kind, body, *struct.unpack_from(">II", data, len(SIGNATURE) + 8))
        if kind == b"acTL":
            walk.frames = struct.unpack(">I", body[:4])[0]
        elif kind == b"fcTL":
            walk.fctl = body
        pos += 12 + length
    return walk


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
        if palette and after_idat:  # libpng checks "duplicate" before the chunk's place
            raise ValueError("PNG palette image with a second PLTE after its image data")
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

    def info(self) -> Tuple[int, int, int, int, int]:
        """png_read_info: IHDR and the chunks up to the first IDAT."""
        c = next(self.it)
        ihdr = _ihdr(self.data, c)
        self.ctype = ihdr[3]
        for c in self.it:
            if c.kind == b"IDAT":
                break
            if c.kind in (b"IHDR", b"IEND"):
                raise ValueError(f"PNG chunk {c.kind!r} before the image data")
            self.ancillary(c, after_idat=False)
        if self.ctype == 3 and self.plte is None:
            raise ValueError("palette PNG without a PLTE before its IDAT")
        self.cur = c
        return ihdr

    def read(self) -> Tuple[Tuple[int, int, int, int, int], bytes]:
        ihdr = self.info()
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


def _unfilter(data: bytes, pos: int, h: int, stride: int, bpp: int,
              prev: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int]:
    """Undo the row filters of ``h`` scanlines of ``stride`` bytes starting at
    ``data[pos]`` (``prev``: the row above the first, else zeros); returns
    the ``[h, stride]`` uint8 rows and the new position."""
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8) if prev is None else prev
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


def _samples(rows: np.ndarray, width: int, channels: int, depth: int,
             wide: bool = False) -> np.ndarray:
    """Unfiltered scanlines -> ``[h, width, channels]`` uint8 samples (16-bit
    samples keep their high byte, or with ``wide`` come whole as uint16;
    sub-byte samples are unpacked, unscaled)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, : width * channels].reshape(h, width, channels)
    if depth == 16:
        pairs = rows[:, : width * channels * 2].reshape(h, width, channels, 2)
        if wide:
            return pairs[..., 0].astype(np.uint16) << 8 | pairs[..., 1]
        return pairs[..., 0]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width].reshape(h, width, 1)


def _rgb(img: np.ndarray, depth: int, ctype: int, plte: Optional[np.ndarray]) -> np.ndarray:
    """``[h, w, channels]`` samples -> RGB uint8 as OpenCV's IMREAD_COLOR takes
    them: a palette looked up (libpng's zeroed 256 entries past PLTE), gray
    under 8 bits scaled to 0..255, uint16 samples (OpenCV's APNG path) to 8
    bits as ``convertTo(CV_8U, 1/255)``, gray on all three channels, alpha
    dropped."""
    if ctype == 3:
        palette = np.zeros((256, 3), np.uint8)
        palette[: len(plte)] = plte
        return palette[img[:, :, 0]]
    if img.dtype == np.uint16:
        img = np.minimum(np.rint(img / 255.0), 255).astype(np.uint8)
    elif depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    return np.repeat(img[:, :, :1], 3, axis=2) if img.shape[2] <= 2 else img[:, :, :3]


class _Progressive:
    """libpng's progressive reader (``png_process_data``) on one image of
    ``width`` x ``height`` as OpenCV's APNG path feeds it: no CRC checked,
    each chunk's data handed to zlib whole.  A zlib data error keeps the
    rows read so far (a benign error); any other zlib error, a bad row
    filter and, while the stream has not ended, a chunk that is not image
    data fail.  Once the last row is in, more data only ends the stream."""

    def __init__(self, width: int, height: int, depth: int, ctype: int, interlace: int):
        if width == 0 or height == 0:
            raise ValueError(f"PNG frame of {width}x{height} pixels")
        self.depth, self.ctype, self.channels = depth, ctype, _CHANNELS[ctype]
        bits = self.channels * depth
        self.bpp = max(1, bits // 8)
        self.passes = []
        for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw > 0 and ph > 0:
                self.passes.append((x0, y0, dx, dy, pw, ph, -(-pw * bits // 8)))
        self.interlace = interlace
        self.img = np.zeros((height, width, self.channels),
                            np.uint16 if depth == 16 else np.uint8)
        self.z = zlib.decompressobj()
        self.fed = self.ended = False
        self.pass_no = self.row = 0
        self.buf = bytearray()
        self.prev: Optional[np.ndarray] = None

    @property
    def whole(self) -> bool:
        return self.pass_no == len(self.passes)

    @property
    def rows(self) -> int:
        """The leading rows written whole (an interlaced image: all or none)."""
        if self.whole:
            return self.img.shape[0]
        return 0 if self.interlace else self.row

    def feed(self, piece: bytes) -> None:
        self.fed = True
        tail = piece
        while tail and not self.ended:
            if self.whole:
                self.ended = True  # "Extra compressed data in IDAT": a warning
                break
            x0, y0, dx, dy, pw, ph, stride = self.passes[self.pass_no]
            try:
                part = self.z.decompress(tail, stride + 1 - len(self.buf))
            except zlib.error as err:
                self.ended = True
                if not str(err).startswith("Error -3 "):  # not Z_DATA_ERROR
                    raise ValueError(f"PNG frame data is damaged: {err}") from None
                break
            tail = self.z.unconsumed_tail
            self.buf += part
            if len(self.buf) == stride + 1:
                rows, _ = _unfilter(bytes(self.buf), 0, 1, stride, self.bpp, self.prev)
                self.prev = rows[0]
                self.img[y0 + self.row * dy, x0::dx] = _samples(rows, pw, self.channels,
                                                                self.depth, wide=True)[0]
                self.buf.clear()
                self.row += 1
                if self.row == ph:
                    self.pass_no, self.row, self.prev = self.pass_no + 1, 0, None
            if self.z.eof:
                self.ended = True

    def other(self, kind: bytes) -> None:
        """A chunk that is not image data."""
        if self.fed and not self.ended:
            raise ValueError(f"PNG frame data runs into a {kind.decode('latin-1')!r} chunk "
                             "before its zlib stream ends")
        if not all(0x41 <= (c & ~0x20) <= 0x5A for c in kind) or kind[2] & 0x20:
            raise ValueError(f"PNG chunk type {kind!r} is not four letters with the reserved "
                             "bit clear")
        if kind == b"IHDR" or (kind == b"PLTE" and self.ctype == 3):
            raise ValueError(f"PNG chunk {kind!r} out of place in an APNG frame")
        if not kind[0] & 0x20 and kind != b"PLTE":
            raise ValueError(f"PNG critical chunk {kind!r} is unknown")

    def finish(self) -> None:
        """OpenCV's processing_finish: libpng reads an IEND."""
        if not self.fed:
            raise ValueError("PNG frame without image data")
        if not self.ended:
            raise ValueError("PNG frame data ends before its zlib stream does")


def _opencv_chunks(data: bytes, pos: int, width: int, height: int) -> Iterator[Tuple[bytes, bytes]]:
    """The chunks from ``pos`` as OpenCV's ``read_chunk`` reads them for an
    APNG's frame: no CRC checked, a chunk cut short fails."""
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG data is truncated before its first frame ends")
        length, kind = struct.unpack_from(">I4s", data, pos)
        if pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        body = data[pos + 8 : pos + 8 + length]
        _opencv_chunk(kind, body, width, height, before_idat=False)
        yield kind, body
        pos += 12 + length


def _apng_first_frame(data: bytes, walk: _Walk) -> np.ndarray:
    """The first frame of an APNG as OpenCV 5's reader gives it.  It reads
    the chunks from the first IDAT itself: the IDAT data goes to a decoder
    of the whole image, whose rows fill a buffer of the image's size.
    Where an ``fcTL`` came before the IDAT, that image is the first frame;
    else the first ``fcTL`` after it starts a decoder of the frame's size,
    fed the ``fdAT`` data after its 4-byte sequence number (not checked),
    which writes the buffer's top-left rows.  The next ``fcTL`` or ``IEND``
    ends the frame, whose rectangle of the buffer goes onto a zero canvas
    (the first frame's dispose and blend ops change nothing) and converts
    as IMREAD_COLOR does; ``eXIf`` is not applied.  An ``IEND`` before any
    frame gives the zero canvas."""
    reader = _Reader(data)
    width, height, depth, ctype, interlace = reader.info()
    base = _Progressive(width, height, depth, ctype, interlace)
    fctl = walk.fctl
    frame = base if fctl is not None else None
    for kind, body in _opencv_chunks(data, walk.idat, width, height):
        if kind == b"fcTL":
            if frame is not None:
                break
            fctl = body
            frame = _Progressive(*struct.unpack(">II", body[4:12]), depth, ctype, interlace)
        elif kind == b"IEND":
            break
        elif kind == b"IDAT":
            (frame or base).feed(body)
        elif kind == b"fdAT" and frame is not None:
            if len(body) < 4:
                raise ValueError(f"PNG fdAT chunk of {len(body)} bytes")
            frame.feed(body[4:])
        else:
            (frame or base).other(kind)
    canvas = np.zeros((height, width, 3), np.uint8)
    if frame is None:  # IEND before any frame: the IDAT image ends, nothing is drawn
        base.finish()
        return canvas
    frame.finish()
    w0, h0, x0, y0 = struct.unpack(">IIII", fctl[4:20])
    if frame.rows < h0 and (frame.interlace or frame is base or base.rows < h0):
        raise ValueError("APNG frame pixels that no decoder wrote whole (OpenCV returns "
                         "memory it never wrote there, or libpng's partial passes)")
    part = frame.img[:h0, :w0]
    if frame.rows < h0:  # the rows the frame left keep the IDAT image's
        part = np.concatenate([part[: frame.rows], base.img[frame.rows : h0, :w0]])
    canvas[y0 : y0 + h0, x0 : x0 + w0] = _rgb(part, depth, ctype, reader.plte)
    return canvas


def decode(data: bytes) -> np.ndarray:
    """A PNG file -> RGB uint8 ``[H, W, 3]``, as ``cv2.imdecode(data,
    IMREAD_COLOR)`` then BGR -> RGB gives it; ``ValueError`` where OpenCV
    gives ``None``."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    walk = _opencv_walk(data)
    if walk.frames > 1 and walk.idat >= 0:
        return _apng_first_frame(data, walk)
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
    rgb = _rgb(img, depth, ctype, reader.plte)
    o = exif.orientation(reader.exif) if reader.exif is not None else 1
    return exif.apply(rgb, o)
