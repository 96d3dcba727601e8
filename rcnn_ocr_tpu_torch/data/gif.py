"""GIF without OpenCV: the first frame of a GIF87a or GIF89a file, to RGB
uint8, pixel for pixel as OpenCV's ``grfmt_gif.cpp`` gives it under
``cv2.imdecode(buf, IMREAD_COLOR)``.

* The whole file is walked first, as OpenCV counts its frames
  (:func:`_frame_walk`, with its reading of application extensions), then
  again as its decoder reads it: blocks are image descriptors (their
  colour table and LZW sub-blocks skipped), extensions (sub-blocks
  skipped; a graphic control extension must have a 4-byte first block) and
  the trailer, which must come; anything else, or data that ends before
  the trailer, is an error.  Bytes after the trailer
  are ignored.
* The first frame's descriptor must lie inside the logical screen and have
  sides above 0; its LZW data (minimum code size 2 to 11) must fill the
  frame exactly (:func:`rcnn_ocr_tpu_torch.native.gif_lzw_decode`, host
  C++); interlaced rows come in GIF's four passes.
* The canvas is the logical screen (held to OpenCV's size limit,
  :mod:`~rcnn_ocr_tpu_torch.data.size_limit`), filled with the global colour table's
  entry at the background index (byte 11 of the screen descriptor; it must
  lie inside the table), or black without a global table.  The frame's
  pixels take the local colour table, an index past it the global one, an
  index past both is an error; with no colour table at all, OpenCV's
  default one (index i gray i, index 1 white).  The transparent index of
  the last graphic control extension before the frame leaves the canvas
  showing.  Later frames are not decoded (OpenCV reads the first).
"""

from __future__ import annotations

import struct

import numpy as np

from rcnn_ocr_tpu_torch.data.size_limit import check_size

_DEFAULT_TABLE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
_DEFAULT_TABLE[1] = 255


def _sub_blocks(data: bytes, pos: int) -> int:
    """The position after the sub-blocks starting at ``pos`` (and their
    terminator)."""
    while True:
        size = data[pos]
        if size == 0:
            return pos + 1
        pos += 1 + size
        if pos >= len(data):
            raise ValueError("GIF data ends inside a block")


def _frame_walk(data: bytes, pos: int) -> None:
    """OpenCV's frame count (``getFrameCount_``), which walks the blocks
    after the screen descriptor before anything is decoded, and fails the
    file on a block type it does not know or on data that ends first.  It
    reads an application extension's sub-blocks as OpenCV does: an 11-byte
    one is an identifier, and a 3-byte one after an identifier other than
    ``NETSCAPE2.0`` (or before any) is read as 2 bytes, so the walk goes on
    one byte early and usually leaves the block structure."""
    def byte() -> int:
        nonlocal pos
        if pos >= len(data):
            raise ValueError("GIF data ends before its trailer")
        pos += 1
        return data[pos - 1]

    def skip_sub_blocks() -> None:
        nonlocal pos
        while (size := byte()) != 0:
            pos += size

    while True:
        block = byte()
        if block == 0x3B:
            return
        if block == 0x2C:
            pos += 8
            flags = byte()
            pos += (3 * (2 << (flags & 7)) if flags & 0x80 else 0) + 1
            skip_sub_blocks()
        elif block == 0x21:
            if byte() != 0xFF:
                skip_sub_blocks()
                continue
            netscape = False
            while (size := byte()) != 0:
                if size == 11:
                    netscape = data[pos : pos + 11] == b"NETSCAPE2.0"
                pos += 2 if size == 3 and not netscape else size
        else:
            raise ValueError(f"GIF block 0x{block:02x} is unknown to OpenCV's frame count")


def _table(data: bytes, pos: int, flags: int):
    """A colour table of ``2 << (flags & 7)`` entries at ``pos``."""
    n = 2 << (flags & 7)
    if pos + 3 * n > len(data):
        raise ValueError("GIF colour table is truncated")
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), pos + 3 * n


def decode(data: bytes) -> np.ndarray:
    """A GIF file -> RGB uint8 ``[screen H, screen W, 3]`` of its first
    frame, as ``cv2.imdecode(data, IMREAD_COLOR)`` then BGR -> RGB gives it;
    ``ValueError`` where OpenCV gives ``None``."""
    from rcnn_ocr_tpu_torch.native import gif_lzw_decode

    if len(data) < 13:
        raise ValueError("GIF header is truncated")
    sw, sh, flags, bg = struct.unpack_from("<HHBB", data, 6)
    pos = 13
    gtable = None
    if flags & 0x80:
        gtable, pos = _table(data, pos, flags)
        if bg >= len(gtable):
            raise ValueError(f"GIF background index {bg} lies past the global colour table")
    if sw == 0 or sh == 0:
        raise ValueError("GIF logical screen is empty")
    check_size(sw, sh, "GIF logical screen")
    _frame_walk(data, pos)
    first = None
    transparent = None
    try:
        while True:
            block = data[pos]
            pos += 1
            if block == 0x3B:
                break
            if block == 0x21:
                label = data[pos]
                pos += 1
                if label == 0xF9:
                    if data[pos] != 4:
                        raise ValueError("GIF graphic control extension is not 4 bytes")
                    if first is None:
                        transparent = data[pos + 4] if data[pos + 1] & 1 else None
                    pos += 5
                pos = _sub_blocks(data, pos)
            elif block == 0x2C:
                left, top, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
                pos += 9
                ltable = None
                if iflags & 0x80:
                    ltable, pos = _table(data, pos, iflags)
                mcs = data[pos]
                start = pos + 1
                pos = _sub_blocks(data, start)
                if first is None:
                    first = (left, top, w, h, iflags, ltable, mcs, start, transparent)
            else:
                raise ValueError(f"GIF block 0x{block:02x} is unknown")
    except (IndexError, struct.error):
        raise ValueError("GIF data ends before its trailer") from None
    if first is None:
        raise ValueError("GIF holds no image")
    left, top, w, h, iflags, ltable, mcs, start, transparent = first
    if w == 0 or h == 0 or left + w > sw or top + h > sh:
        raise ValueError(f"GIF frame {w}x{h} at ({left}, {top}) lies outside the {sw}x{sh} screen")
    if not 2 <= mcs <= 11:
        raise ValueError(f"GIF LZW minimum code size {mcs} is out of range")
    lzw = bytearray()  # the sub-blocks' bytes, joined
    p = start
    while data[p]:
        lzw += data[p + 1 : p + 1 + data[p]]
        p += 1 + data[p]
    idx = gif_lzw_decode(bytes(lzw), mcs, w * h).reshape(h, w)
    if iflags & 0x40:  # interlaced: rows 0, 8, ..; 4, 12, ..; 2, 6, ..; 1, 3, ..
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    if ltable is None and gtable is None:
        table = _DEFAULT_TABLE
    else:
        # the local table first, the global one past its end
        n = max(0 if ltable is None else len(ltable), 0 if gtable is None else len(gtable))
        table = np.zeros((n, 3), np.uint8)
        if gtable is not None:
            table[: len(gtable)] = gtable
        if ltable is not None:
            table[: len(ltable)] = ltable
    background = gtable[bg] if gtable is not None else np.zeros(3, np.uint8)
    shown = np.ones(idx.shape, bool) if transparent is None else idx != transparent
    if int(idx[shown].max(initial=0)) >= len(table):
        raise ValueError("GIF colour index lies past the colour tables")
    img = np.empty((sh, sw, 3), np.uint8)
    img[:] = background
    frame = table[np.minimum(idx, len(table) - 1)]
    frame[~shown] = background
    img[top : top + h, left : left + w] = frame
    return img
