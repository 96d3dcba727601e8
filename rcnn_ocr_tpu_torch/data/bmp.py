"""BMP without OpenCV: every BMP that ``cv2.imdecode(buf, IMREAD_COLOR)``
reads, to RGB uint8, pixel for pixel as OpenCV's ``grfmt_bmp.cpp`` gives it.

* Headers: the OS/2 core header (12 bytes: unsigned 16-bit sides, 3-byte
  palette entries, always bottom-up) and every header of 36 bytes or more
  (40, 52, 56, V4's 108, V5's 124: signed 32-bit sides, a negative height
  top-down, 4-byte palette entries).  The palette starts right after the
  header, and 16-bit BI_BITFIELDS masks are the three words there too, as
  OpenCV reads them, not the ones inside a V2-V5 header.  The pixels start
  at the file header's offset.
* Pixels: 1-, 4- and 8-bit palette indices (an index past the colours
  the header lists reads the palette's zero fill: black); 16-bit words
  as 5-5-5 (BI_RGB, or BI_BITFIELDS masks 7C00/03E0/001F) or 5-6-5 (masks
  F800/07E0/001F), each channel shifted up to 8 bits with its low bits
  zero (``(v << 3) & 0xF8`` ...), other masks refused as OpenCV refuses
  them; 24-bit BGR; 32-bit BGRx (the fourth byte dropped), and under
  BI_BITFIELDS with a header of 56 bytes or more whose red, green and blue
  masks (inside the header) are all non-zero, each channel its mask's
  bits scaled to 0..255 in float32 as OpenCV 5 scales them.
* RLE8 (compression 1) and RLE4 (2) as OpenCV's loops run them: encoded
  runs (RLE4: two alternating indices), absolute runs padded to a word,
  and the escapes.  What the escapes skip takes palette entry 0.  RLE8:
  end-of-line fills the rest of the row, except right after a run that
  filled it; delta (dx, dy) fills dx pixels and dy rows, wrapping; end of
  bitmap fills the rest of the image and ends.  RLE4: end-of-line and end
  of bitmap both fill the rest of the row, delta fills dx pixels and
  ignores dy, and decoding ends only when the last row is passed.  A run
  that overruns its row fails.

Where OpenCV fails (other bit depths and compressions, a palette of over
256 colours, a width of 0 or less, a height of 0, data short of the last
row, RLE data that ends before the image does), ``ValueError``: every BMP
OpenCV reads, this module reads.  RLE is a loop over the codes in Python,
one numpy slice per run (a text line takes a few hundred codes).
"""

from __future__ import annotations

import struct

import numpy as np

from rcnn_ocr_tpu_torch.data.size_limit import check_size

_MASKS = {(0x7C00, 0x03E0, 0x001F): 15, (0xF800, 0x07E0, 0x001F): 16}


def _palette(data: bytes, at: int, count: int, entry: int) -> np.ndarray:
    """256 RGB entries: ``count`` read at ``at`` (BGR first), zeros after."""
    if at + count * entry > len(data):
        raise ValueError("BMP palette lies past the end of the file")
    pal = np.zeros((256, 3), np.uint8)
    pal[:count] = np.frombuffer(data, np.uint8, count * entry, at).reshape(count, entry)[:, 2::-1]
    return pal


def decode(data: bytes) -> np.ndarray:
    """A BMP file -> RGB uint8 ``[H, W, 3]``, as ``cv2.imdecode(data,
    IMREAD_COLOR)`` then BGR -> RGB gives it; ``ValueError`` where OpenCV
    gives ``None``."""
    (offset, size) = struct.unpack_from("<iI", data, 10)
    pal = masks32 = None
    if size == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", data, 18)
        compression = 0
        if w <= 0 or h == 0 or bits not in (1, 4, 8, 24, 32):
            raise ValueError(f"OS/2 BMP of {w}x{h} pixels at {bits} bits, which OpenCV refuses")
        if bits <= 8:
            pal = _palette(data, 26, 1 << bits, 3)
    elif size >= 36:
        w, h, bits, compression = struct.unpack_from("<iiiI", data, 18)
        bits >>= 16
        (colours,) = struct.unpack_from("<i", data, 46)
        if compression > 3:
            raise ValueError(f"BMP compression {compression}, which OpenCV refuses")
        if not (w > 0 and h != 0 and (
                (bits in (1, 4, 8, 24, 32) and compression == 0)
                or (bits in (16, 32) and compression in (0, 3))
                or (bits, compression) in ((8, 1), (4, 2)))):
            raise ValueError(f"BMP of {w}x{h} pixels at {bits} bits with compression "
                             f"{compression}, which OpenCV refuses")
        if bits == 32 and compression == 3 and size >= 56:
            masks32 = struct.unpack_from("<III", data, 54)
        if bits <= 8:
            if not 0 <= colours <= 256:
                raise ValueError(f"BMP palette of {colours} colours")
            pal = _palette(data, 14 + size, colours or 1 << bits, 4)
        elif bits == 16:
            if compression == 3:
                masks = struct.unpack_from("<III", data, 14 + size)
                if masks not in _MASKS:
                    raise ValueError(f"16-bit BMP masks {[hex(m) for m in masks]}, which OpenCV "
                                     "refuses (it reads 5-5-5 and 5-6-5)")
                bits = _MASKS[masks]
            else:
                bits = 15
    else:
        raise ValueError(f"BMP header of {size} bytes")
    top_down, h = h < 0, abs(h)
    check_size(w, h, "BMP")
    if h * w * 3 >= 1 << 30:
        raise ValueError(f"BMP of {w}x{h} pixels, which OpenCV refuses (1 GiB)")
    if offset < 0 or offset > len(data):
        raise ValueError("BMP pixel offset lies past the end of the file")
    if compression in (1, 2):
        idx = (_rle8 if compression == 1 else _rle4)(data, offset, h, w)
    else:
        pitch = ((w * (16 if bits == 15 else bits) + 7) // 8 + 3) & -4
        if offset + pitch * h > len(data):
            raise ValueError("BMP pixel data is truncated")
        rows = np.frombuffer(data, np.uint8, pitch * h, offset).reshape(h, pitch)
        if bits <= 8:
            if bits == 8:
                idx = rows[:, :w]
            else:
                shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
                idx = ((rows[:, :, None] >> shifts) & np.uint8((1 << bits) - 1))
                idx = idx.reshape(h, -1)[:, :w]
        elif bits in (15, 16):
            t = rows[:, : 2 * w].view("<u2").astype(np.uint16)
            if bits == 15:
                rgb = np.stack([(t >> 7) & 0xF8, (t >> 2) & 0xF8, (t << 3) & 0xF8], axis=2)
            else:
                rgb = np.stack([(t >> 8) & 0xF8, (t >> 3) & 0xFC, (t << 3) & 0xF8], axis=2)
            rgb = rgb.astype(np.uint8)
        elif masks32 is not None and all(masks32):
            v = rows[:, : 4 * w].view("<u4")
            rgb = np.stack([_scaled(v, m) for m in masks32], axis=2)
        else:
            rgb = rows[:, : w * bits // 8].reshape(h, w, bits // 8)[:, :, 2::-1]
    if pal is not None:
        rgb = pal[idx]
    if not top_down:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def _scaled(v: np.ndarray, mask: int) -> np.ndarray:
    """One channel of 32-bit pixels under a BI_BITFIELDS mask, as OpenCV
    scales it: the masked bits shifted down, times ``255.0f / max`` in
    float32, truncated (so a 3-bit channel tops out at 254)."""
    shift = (mask & -mask).bit_length() - 1
    top = mask >> shift
    x = ((v & np.uint32(mask)) >> np.uint32(shift)).astype(np.float32)
    return (x * (np.float32(255) / np.float32(top))).astype(np.uint8)


class _Rle:
    """The state of OpenCV's RLE loops: the row ``y`` and column ``x`` of
    the next pixel, in file order (the first row stored first)."""

    def __init__(self, data: bytes, pos: int, h: int, w: int):
        self.data, self.pos, self.h, self.w = data, pos, h, w
        self.idx = np.zeros((h, w), np.uint8)
        self.y = self.x = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("BMP RLE data ends before the image does")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def fill(self, count: int, index: int) -> None:
        """FillUniColor: ``count`` pixels of ``index`` from (y, x), wrapping
        to the next row at a row's end (even for a count of 0), stopping
        past the last row."""
        while True:
            end = min(self.x + count, self.w)
            count -= end - self.x
            self.idx[self.y, self.x : end] = index
            self.x = end
            if self.x >= self.w:
                self.x = 0
                self.y += 1
                if self.y >= self.h:
                    return
            if count <= 0:
                return

    def absolute(self, n: int, nibbles: bool) -> None:
        if self.x + n > self.w:
            raise ValueError("BMP RLE absolute run overruns its row")
        raw = np.frombuffer(self.take(((n + 1) // 2 + 1) & ~1 if nibbles else (n + 1) & ~1),
                            np.uint8)
        if nibbles:
            raw = np.stack([raw >> 4, raw & 15], axis=1).reshape(-1)
        self.idx[self.y, self.x : self.x + n] = raw[:n]
        self.x += n


def _rle8(data: bytes, pos: int, h: int, w: int) -> np.ndarray:
    s = _Rle(data, pos, h, w)
    row_ended = False  # the last run filled its row exactly
    while True:
        n, code = s.take(2)
        if n:
            if s.x + n > w:
                raise ValueError("BMP RLE8 run overruns its row")
            y0 = s.y
            s.fill(n, code)
            row_ended = s.y != y0
            if s.y >= h:
                break
        elif code > 2:
            s.absolute(code, False)
            row_ended = False
        else:
            if code or not row_ended or s.x > 0:
                shift, rows = w - s.x, h - s.y
                if code == 2:
                    shift, rows = s.take(2)
                if code:
                    shift += rows * w
                s.fill(shift, 0)
            row_ended = False
            if s.y >= h:
                break
    return s.idx


def _rle4(data: bytes, pos: int, h: int, w: int) -> np.ndarray:
    s = _Rle(data, pos, h, w)
    while True:
        n, code = s.take(2)
        if n:
            if s.x + n > w:
                raise ValueError("BMP RLE4 run overruns its row")
            s.idx[s.y, s.x : s.x + n] = np.array([code >> 4, code & 15], np.uint8)[np.arange(n) & 1]
            s.x += n
        elif code > 2:
            s.absolute(code, True)
        else:
            shift = w - s.x
            if code == 2:
                shift = s.take(2)[0]  # dy is read and ignored
            s.fill(shift, 0)
            if s.y >= h:
                break
    return s.idx
