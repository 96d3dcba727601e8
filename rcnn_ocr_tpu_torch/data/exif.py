"""The EXIF orientation as OpenCV's ``ExifReader`` reads it, for the
decoders whose container carries an EXIF block (PNG's ``eXIf`` chunk,
WebP's ``EXIF`` chunk and JPEG's APP1 after its ``Exif\\0\\0``).

OpenCV parses the block as a TIFF header and its first IFD only:

* the byte order is Intel when the first two bytes are both ``I``,
  Motorola otherwise (``MM``, and also two bytes that differ or are
  neither letter), and the next 16 bits must be 42;
* the IFD's entries are read in order; each known tag reads its value,
  and a read past the block's end stops the parse (a tag's 16-bit value
  sits at entry byte 8, whatever its type and count: a LONG orientation
  reads as its first two bytes);
* what was read before the parse stopped stays: the first Orientation
  entry read wins, and an entry that runs past the end, or an earlier
  string or rational tag whose data lies outside the block, hides it;
* values other than 1-8 leave the image as it is.

``ApplyExifOrientation`` then turns the decoded image (:func:`apply`).
"""

from __future__ import annotations

import numpy as np

_ORIENTATION = 0x0112
# ExifReader's tags that read more than their entry: strings, rationals at an
# offset (the count of rationals read), and the 16-bit ones
_STRINGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)
_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3, 0x0214: 6}
_SHORTS = (0x0128, 0x0213)


class _Short(Exception):
    """A read past the end of the block (OpenCV's ExifParsingError)."""


def orientation(block: bytes) -> int:
    """The orientation (1-8, 1 where there is none) of an EXIF block that
    starts at its TIFF header."""
    n = len(block)
    intel = n >= 1 and block[0] == 0x49 and (n < 2 or block[1] == 0x49)

    def u16(at: int) -> int:
        if at + 1 >= n:
            raise _Short
        return block[at] | block[at + 1] << 8 if intel else block[at] << 8 | block[at + 1]

    def u32(at: int) -> int:
        lo, hi = (u16(at), u16(at + 2)) if intel else (u16(at + 2), u16(at))
        return lo | hi << 16

    try:
        if u16(2) != 0x2A:
            return 1
        ifd = u32(4)
        for i in range(u16(ifd)):
            at = ifd + 2 + 12 * i
            tag = u16(at)
            if tag == _ORIENTATION:
                value = u16(at + 8)
                return value if 1 <= value <= 8 else 1
            if tag in _STRINGS:
                size, where = u32(at + 4), 8
                if size > 4:
                    where = u32(at + 8)
                if where > n or where + size > n:
                    raise _Short
            elif tag in _RATIONALS:
                where = u32(at + 8)
                for k in range(_RATIONALS[tag]):
                    u32(where + 8 * k)
                    u32(where + 8 * k + 4)
            elif tag in _SHORTS:
                u16(at + 8)
    except _Short:
        pass
    return 1


def apply(img: np.ndarray, o: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation``: 2 flips the columns, 3 both axes,
    4 the rows; 5-8 transpose first, then flip as 1-4 do."""
    if o >= 5:
        img = img.transpose(1, 0, 2)
    if o in (2, 3, 6, 7):
        img = img[:, ::-1]
    if o in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)
