"""WebP without OpenCV: the RIFF container walked in Python, the two
bitstreams decoded by the port's host C++ (``csrc/host/webp_decode.cpp``
through :func:`rcnn_ocr_tpu_torch.native.webp_decode_vp8l` and
:func:`~rcnn_ocr_tpu_torch.native.webp_decode_vp8`), to RGB uint8, pixel for
pixel as ``cv2.imdecode(buf, IMREAD_COLOR)`` gives it through libwebp.

* Simple files: one ``VP8 `` (lossy) or ``VP8L`` (lossless) chunk.
* Extended files (``VP8X``): unknown and metadata chunks (ICCP, XMP)
  skipped; an ``ALPH`` chunk before a lossy frame is decoded and checked
  as libwebp checks it (its header's reserved bits, compression, filter and
  preprocessing fields, raw data of at least width x height bytes, or a
  headerless VP8L stream that decodes), so a damaged ALPH fails the file
  as it fails cv2, but its values never reach the RGB output: the colour
  stored under alpha 0 comes out as coded, nothing is composited or
  premultiplied.  The frame's sides must equal the canvas's.
* Animations (the VP8X animation flag, an ``ANIM`` chunk, then ``ANMF``
  frames): the
  first frame, decoded into a canvas of zeros (black) at its offset, as
  libwebp's animation decoder starts a key frame; the frame must lie
  inside the canvas.
* EXIF orientation, as OpenCV applies it: the payload of the first
  ``EXIF`` chunk of a VP8X file whose EXIF flag (0x08) is set, read by
  :mod:`~rcnn_ocr_tpu_torch.data.exif` as a bare TIFF header (a leading
  ``Exif\0\0`` hides it), turns the image (an animation's first frame
  with its canvas).  OpenCV takes the chunk from libwebp's demuxer, so
  the chunk counts only where the demuxer accepts the whole file
  (:func:`_exif_block`): the chunk need not follow the image, but bytes
  that are no chunk, a chunk past the RIFF size, a second image or
  reserved VP8X flags leave the image unturned.

Sizes are checked as libwebp checks them: a RIFF size past the end of the
data (a truncated file) or under 12 bytes, a chunk past the RIFF size or
the data, a VP8X chunk that is not 10 bytes.  A canvas is held to OpenCV's
size limit (:mod:`~rcnn_ocr_tpu_torch.data.size_limit`).  Bytes after the
RIFF size are ignored.  Damaged bitstreams fail in the C++ where libwebp
fails.
"""

from __future__ import annotations

import struct

import numpy as np

from rcnn_ocr_tpu_torch.data import exif
from rcnn_ocr_tpu_torch.data.size_limit import check_size

_ANIMATION_FLAG = 0x02  # VP8X flags; the alpha flag (0x10) changes nothing cv2 gives
_EXIF_FLAG = 0x08
_VALID_FLAGS = 0x3E  # alpha, animation, ICC, EXIF, XMP: libwebp's demuxer refuses others


def _chunk(data: bytes, pos: int, end: int):
    """(tag, payload start, payload size, position after the padded
    chunk) of the chunk at ``pos``."""
    if pos + 8 > end:
        raise ValueError("WebP chunk header is truncated")
    tag = data[pos : pos + 4]
    size = struct.unpack_from("<I", data, pos + 4)[0]
    if pos + 8 + size > end:
        raise ValueError(f"WebP chunk {tag!r} runs past the end of the file")
    return tag, pos + 8, size, pos + 8 + size + (size & 1)


def _vp8_sides(frame: bytes):
    if len(frame) < 10 or frame[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP VP8 frame header is damaged")
    bits = frame[0] | (frame[1] << 8) | (frame[2] << 16)
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= len(frame):
        raise ValueError("WebP VP8 frame header is invalid")
    w = struct.unpack_from("<H", frame, 6)[0] & 0x3FFF
    h = struct.unpack_from("<H", frame, 8)[0] & 0x3FFF
    if w == 0 or h == 0:
        raise ValueError("WebP VP8 frame has a zero side")
    return w, h


def _vp8l_sides(frame: bytes):
    if len(frame) < 5 or frame[0] != 0x2F or frame[4] >> 5:
        raise ValueError("WebP VP8L header is invalid")
    bits = int.from_bytes(frame[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def _check_alpha(alph: bytes, w: int, h: int) -> None:
    """Decode an ALPH chunk as libwebp's alpha decoder does (and drop it)."""
    from rcnn_ocr_tpu_torch.native import webp_decode_vp8l

    if len(alph) < 1:
        raise ValueError("WebP ALPH chunk is empty")
    # bits 0-1 compression, 2-3 filter (any of the four: it changes only the
    # alpha values), 4-5 preprocessing, 6-7 reserved
    method, pre, rsrv = alph[0] & 3, (alph[0] >> 4) & 3, alph[0] >> 6
    if method > 1 or pre > 1 or rsrv != 0:
        raise ValueError(f"WebP ALPH header 0x{alph[0]:02x} is invalid")
    if method == 0:
        if len(alph) - 1 < w * h:
            raise ValueError("WebP ALPH raw data is short of the image")
    else:
        webp_decode_vp8l(alph[1:], w, h, header=False)


def _frame(data: bytes, pos: int, end: int, animated: bool, extended: bool = False):
    """Decode the image at ``pos`` (optional ALPH, then VP8 or VP8L; other
    chunks before them skipped) -> RGB ``[h, w, 3]``.  As libwebp, the
    bitstream reads on past its chunk: a still image's to the end of the
    data (padding, later chunks, bytes after the RIFF size), an animation
    frame's through its chunk's padding byte; it matters only to a
    stream that runs short.  In a still VP8X file (``extended``) the chunks
    through the image, padding included, must lie inside the RIFF size, as
    libwebp's ParseOptionalChunks counts them."""
    from rcnn_ocr_tpu_torch.native import webp_decode_vp8, webp_decode_vp8l

    alph = None
    while True:
        tag, start, size, pos = _chunk(data, pos, end)
        if extended and pos > end:
            raise ValueError(f"WebP chunk {tag!r} and its padding run past the RIFF size")
        stream = data[start : start + size + (size & 1) if animated else len(data)]
        if tag == b"ALPH":
            alph = data[start : start + size]
        elif tag == b"VP8 ":
            w, h = _vp8_sides(data[start : start + size])
            if alph is not None:
                _check_alpha(alph, w, h)
            return webp_decode_vp8(stream, w, h)
        elif tag == b"VP8L":
            w, h = _vp8l_sides(data[start : start + size])
            argb = webp_decode_vp8l(stream, w, h)
            return argb.view(np.uint8).reshape(h, w, 4)[:, :, 2::-1].copy()


def decode(data: bytes) -> np.ndarray:
    """A WebP file -> RGB uint8 ``[H, W, 3]`` (an animation's first frame),
    as ``cv2.imdecode(data, IMREAD_COLOR)`` then BGR -> RGB gives it;
    ``ValueError`` where OpenCV gives ``None``."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a RIFF WebP file")
    riff = struct.unpack_from("<I", data, 4)[0]
    if riff < 12 or riff > len(data) - 8:
        raise ValueError(f"WebP RIFF size {riff} does not fit the {len(data)}-byte file")
    end = 8 + riff
    tag, start, size, pos = _chunk(data, 12, end)
    if tag in (b"VP8 ", b"VP8L"):
        return _frame(data, 12, end, animated=False)
    if tag != b"VP8X":
        raise ValueError(f"WebP first chunk {tag!r} is unknown")
    if size != 10:
        raise ValueError("WebP VP8X chunk is not 10 bytes")
    flags = data[start]
    cw = int.from_bytes(data[start + 4 : start + 7], "little") + 1
    ch = int.from_bytes(data[start + 7 : start + 10], "little") + 1
    check_size(cw, ch, "WebP canvas")
    valid, block = _demux(data, pos, end, flags)
    o = exif.orientation(block) if valid and block is not None and flags & _EXIF_FLAG else 1
    if not flags & _ANIMATION_FLAG:
        img = _frame(data, pos, end, animated=False, extended=True)
        if img.shape[:2] != (ch, cw):
            raise ValueError(f"WebP frame {img.shape[1]}x{img.shape[0]} differs from its "
                             f"{cw}x{ch} canvas")
        return exif.apply(img, o)
    if not valid:  # OpenCV decodes animations through libwebp's demuxer
        raise ValueError("WebP animation that libwebp's demuxer refuses")
    seen_anim = False
    while True:  # ANIM, then the first ANMF
        tag, start, size, pos = _chunk(data, pos, end)
        if tag == b"ANMF":
            break
        seen_anim |= tag == b"ANIM"
    if not seen_anim:
        raise ValueError("WebP animation has no ANIM chunk before its first frame")
    if size < 16:
        raise ValueError("WebP ANMF chunk is truncated")
    x = 2 * int.from_bytes(data[start : start + 3], "little")
    y = 2 * int.from_bytes(data[start + 3 : start + 6], "little")
    fw = int.from_bytes(data[start + 6 : start + 9], "little") + 1
    fh = int.from_bytes(data[start + 9 : start + 12], "little") + 1
    if x + fw > cw or y + fh > ch:
        raise ValueError("WebP animation frame lies outside its canvas")
    frame = _frame(data, start + 16, start + size, animated=True)
    if frame.shape[:2] != (fh, fw):
        raise ValueError("WebP animation frame differs from its ANMF sides")
    img = np.zeros((ch, cw, 3), np.uint8)
    img[y : y + fh, x : x + fw] = frame
    return exif.apply(img, o)


def _demux(data: bytes, pos: int, end: int, flags: int):
    """Whether libwebp's demuxer (WebPDemux on the whole file) accepts the
    file after its VP8X chunk at ``pos``, and the first EXIF chunk's
    payload (``None`` where there is none): every chunk whole inside the
    RIFF size and the walk ending on it, one image (ALPH, then VP8 or
    VP8L) in a still file and none outside ANMF in an animation, ANMF only
    after an ANIM of at least 6 bytes, no second VP8X, no reserved flag."""
    animated = bool(flags & _ANIMATION_FLAG)
    block = None
    seen_image = seen_anim = seen_frame = False
    while pos < end:
        if end - pos < 8:
            return False, None
        tag = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        padded = size + (size & 1)
        if padded > end - pos - 8 or tag == b"VP8X":
            return False, None
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            if animated or seen_image:
                return False, None
            if tag == b"ALPH":  # StoreFrame: an optional ALPH, then the image
                pos += 8 + padded
                if end - pos < 8 or data[pos : pos + 4] != b"VP8 ":
                    return False, None  # VP8L carries its own alpha
                size = struct.unpack_from("<I", data, pos + 4)[0]
                padded = size + (size & 1)
                if padded > end - pos - 8:
                    return False, None
            seen_image = True
        elif tag == b"ANIM":
            if padded < 6:
                return False, None
            seen_anim = True
        elif tag == b"ANMF":
            if not seen_anim:
                return False, None
            seen_frame = True
        elif tag == b"EXIF" and block is None:
            block = data[pos + 8 : pos + 8 + size]
        pos += 8 + padded
    valid = not flags & ~_VALID_FLAGS and (seen_frame if animated else seen_image)
    return valid, block
