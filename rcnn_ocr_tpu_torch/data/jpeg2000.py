"""JPEG 2000 without OpenCV: JP2 files and raw codestreams, to RGB uint8,
pixel for pixel as ``cv2.imdecode(buf, IMREAD_COLOR)`` gives them through
OpenJPEG and OpenCV's ``grfmt_jpeg2000_openjpeg.cpp``.

The codestream is decoded by the port's host C++
(``csrc/host/j2k_decode.cpp`` through :func:`rcnn_ocr_tpu_torch.native.j2k_header`
and :func:`~rcnn_ocr_tpu_torch.native.j2k_decode`) into the integer planes
OpenJPEG gives.  Here:

* The JP2 boxes, walked as OpenJPEG walks them: the signature box first,
  ``ftyp`` second, ``jp2h`` (its ``ihdr``, the first ``colr``, ``bpcc``,
  ``pclr``, ``cmap``, ``cdef``; unknown boxes skipped) before ``jp2c``,
  whose codestream runs to the end of the data.  A header box outside
  ``jp2h`` is read once ``jp2h`` has been, else skipped.  ``ihdr``'s sides
  must equal SIZ's.
* OpenJPEG's colour handling: ``cdef`` and ``cmap`` checked against the
  components, the palette (``pclr`` with ``cmap``, indices clamped to the
  table) and the channel definitions (``cdef`` swapping colour channels)
  applied, the colour space from ``colr``'s enumerated value (sRGB 16,
  gray 17, sYCC 18, e-sYCC 24, CMYK 12, anything else unknown; a raw
  codestream has none).
* OpenCV's checks and conversion: 1 to 4 components, none signed, the
  largest precision 8 or more (every sample is shifted right by that
  precision less 8, so a 16-bit component keeps its high byte), every
  component unsubsampled at offset 0; an unknown or unspecified colour
  space is taken as sRGB (3 or more components: the first three as RGB,
  an alpha channel dropped), gray puts the first component on all three
  channels, sYCC takes the first three through OpenCV's YUV -> BGR
  (14-bit fixed point, its coefficients 2.032, 0.395, 0.581, 1.140);
  e-sYCC and CMYK fail in OpenCV.

Code-blocks of either kind are decoded: Part 1's and HTJ2K's (Part 15,
the HT code-block style of COD or COC) as OpenJPEG decodes them.  Where
OpenJPEG or OpenCV fails, ``ValueError``: the codestream decoder refuses
nothing cv2 reads.  Sides are held to OpenCV's size limit
(:mod:`~rcnn_ocr_tpu_torch.data.size_limit`) before any plane is
allocated.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from rcnn_ocr_tpu_torch.data.size_limit import check_size

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
CODESTREAM = b"\xff\x4f\xff\x51"
_SIGNATURE, _FILE_TYPE, _HEADER = 1, 2, 4
_HEADER_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")
_SRGB, _GRAY, _SYCC = 16, 17, 18
_FAILING_SPACES = {24: "e-sYCC", 12: "CMYK"}


def is_jpeg2000(data: bytes) -> bool:
    return data.startswith(JP2_SIGNATURE) or data.startswith(CODESTREAM)


class _Jp2:
    """What the JP2 header boxes hold, as OpenJPEG keeps it."""

    def __init__(self):
        self.state = 0
        self.ihdr: Optional[tuple] = None  # (height, width, components)
        self.numcomps = 0
        self.enumcs: Optional[int] = None  # None: no usable colr
        self.has_colr = False
        self.pclr: Optional[np.ndarray] = None  # [entries, columns]
        self.cmap: Optional[list] = None
        self.cdef: Optional[list] = None

    # --- the header boxes ---
    def ihdr_box(self, body: bytes) -> None:
        if self.ihdr is not None:
            return  # OpenJPEG reads the first ihdr
        if len(body) != 14:
            raise ValueError("JP2 ihdr box size is not 14")
        h, w, nc = struct.unpack_from(">IIH", body)
        if w < 1 or h < 1 or not 1 <= nc <= 16384:
            raise ValueError(f"JP2 ihdr box: wrong sides or components ({w}x{h}, {nc})")
        self.ihdr = (h, w, nc)
        self.numcomps = nc

    def colr_box(self, body: bytes) -> None:
        if len(body) < 3:
            raise ValueError("JP2 colr box is too short")
        if self.has_colr:
            return  # all colr boxes after the first are ignored
        meth = body[0]
        if meth == 1:
            if len(body) < 7:
                raise ValueError("JP2 colr box is too short")
            self.enumcs = struct.unpack_from(">I", body, 3)[0]
            self.has_colr = True
        elif meth == 2:  # an ICC profile: the colour space is unknown
            self.enumcs = 0
            self.has_colr = True

    def bpcc_box(self, body: bytes) -> None:
        if len(body) != self.numcomps:
            raise ValueError("JP2 bpcc box size differs from the components")

    def pclr_box(self, body: bytes) -> None:
        if self.pclr is not None:
            raise ValueError("JP2: a second pclr box")
        if len(body) < 3:
            raise ValueError("JP2 pclr box is too short")
        entries, channels = struct.unpack_from(">HB", body)
        if not 1 <= entries <= 1024:
            raise ValueError(f"JP2 pclr box of {entries} entries")
        if channels == 0 or len(body) < 3 + channels:
            raise ValueError("JP2 pclr box has no palette columns")
        sizes = [(b & 0x7F) + 1 for b in body[3 : 3 + channels]]
        table = np.zeros((entries, channels), np.int64)
        pos = 3 + channels
        for j in range(entries):
            for i, size in enumerate(sizes):
                k = min((size + 7) >> 3, 4)
                if pos + k > len(body):
                    raise ValueError("JP2 pclr box is truncated")
                table[j, i] = int.from_bytes(body[pos : pos + k], "big")
                pos += k
        self.pclr = table

    def cmap_box(self, body: bytes) -> None:
        if self.pclr is None:
            raise ValueError("JP2 cmap box before its pclr box")
        if self.cmap is not None:
            raise ValueError("JP2: a second cmap box")
        n = self.pclr.shape[1]
        if len(body) < 4 * n:
            raise ValueError("JP2 cmap box is too short")
        self.cmap = [list(struct.unpack_from(">HBB", body, 4 * i)) for i in range(n)]

    def cdef_box(self, body: bytes) -> None:
        if self.cdef is not None:
            raise ValueError("JP2: a second cdef box")
        if len(body) < 2:
            raise ValueError("JP2 cdef box is too short")
        n = struct.unpack_from(">H", body)[0]
        if n == 0 or len(body) < 2 + 6 * n:
            raise ValueError("JP2 cdef box is damaged")
        self.cdef = [list(struct.unpack_from(">HHH", body, 2 + 6 * i)) for i in range(n)]

    def header_box(self, kind: bytes, body: bytes) -> None:
        getattr(self, kind.decode() + "_box")(body)

    def jp2h(self, body: bytes) -> None:
        if not self.state & _FILE_TYPE:
            raise ValueError("JP2 jp2h box before the ftyp box")
        pos, has_ihdr = 0, False
        while pos < len(body):
            length, kind, head = _box_header(body, pos, len(body) - pos, inner=True)
            if length > len(body) - pos:
                raise ValueError("JP2 jp2h: a box longer than its parent")
            if kind in _HEADER_BOXES:
                self.header_box(kind, body[pos + head : pos + length])
            has_ihdr |= kind == b"ihdr"
            pos += length
        if not has_ihdr:
            raise ValueError("JP2 jp2h box without ihdr")
        self.state |= _HEADER


def _box_header(data: bytes, pos: int, room: int, inner: bool):
    """(length, type, header length) of the box at ``pos``."""
    if room < 8:
        raise ValueError("JP2 box header is truncated")
    length, kind = struct.unpack_from(">I4s", data, pos)
    head = 8
    if length == 1:
        if room < 16:
            raise ValueError("JP2 XL box header is truncated")
        high, length = struct.unpack_from(">II", data, pos + 8)
        if high != 0:
            raise ValueError("JP2 box over 2**32 bytes")
        head = 16
        if inner and length == 0:
            raise ValueError("JP2 box of undefined size")
    elif length == 0:
        if inner:
            raise ValueError("JP2 box of undefined size")
        length = room  # the last box: to the end of the data
    if length < head:
        raise ValueError("JP2 box length is inconsistent")
    return length, kind, head


def _walk(data: bytes):
    """The JP2 boxes -> (:class:`_Jp2`, offset of the codestream)."""
    jp2 = _Jp2()
    pos = 0
    while len(data) - pos >= 8:
        length, kind, head = _box_header(data, pos, len(data) - pos, inner=False)
        if kind == b"jp2c":
            if not jp2.state & _HEADER:
                raise ValueError("JP2 codestream before its jp2h box")
            return jp2, pos + head
        size = length - head
        body_start = pos + head
        if kind in (b"jP  ", b"ftyp", b"jp2h") or kind in _HEADER_BOXES:
            if kind in _HEADER_BOXES and not jp2.state & _HEADER:  # misplaced: skipped
                if size > len(data) - body_start:
                    raise ValueError("JP2 box past the end of the data")
                pos = body_start + size
                continue
            if size > len(data) - body_start:
                raise ValueError("JP2 box past the end of the data")
            body = data[body_start : body_start + size]
            if kind == b"jP  ":
                if jp2.state != 0:
                    raise ValueError("JP2 signature box is not the first box")
                if size != 4 or body != b"\r\n\x87\n":
                    raise ValueError("JP2 signature box is damaged")
                jp2.state |= _SIGNATURE
            elif kind == b"ftyp":
                if jp2.state != _SIGNATURE:
                    raise ValueError("JP2 ftyp box is not the second box")
                if size < 8 or (size - 8) % 4:
                    raise ValueError("JP2 ftyp box size")
                jp2.state |= _FILE_TYPE
            elif kind == b"jp2h":
                jp2.jp2h(body)
            else:
                jp2.header_box(kind, body)
        else:
            if not jp2.state & _SIGNATURE:
                raise ValueError("JP2: the first box must be the signature box")
            if not jp2.state & _FILE_TYPE:
                raise ValueError("JP2: the second box must be the ftyp box")
            if size > len(data) - body_start:
                raise ValueError("JP2 box past the end of the data")
        pos = body_start + size
    raise ValueError("JP2 file without a codestream box")


def _check_color(jp2: _Jp2, ncomps: int) -> None:
    """OpenJPEG's opj_jp2_check_color: cdef and cmap against the components
    (a cmap mapping every column from one component is repaired)."""
    if jp2.cdef is not None:
        channels = ncomps
        if jp2.pclr is not None and jp2.cmap is not None:
            channels = jp2.pclr.shape[1]
        for cn, _, asoc in jp2.cdef:
            if cn >= channels:
                raise ValueError("JP2 cdef: invalid channel")
            if asoc != 65535 and asoc > 0 and asoc - 1 >= channels:
                raise ValueError("JP2 cdef: invalid association")
        listed = {cn for cn, _, _ in jp2.cdef}
        if any(c not in listed for c in range(channels)):
            raise ValueError("JP2 cdef: incomplete channel definitions")
    if jp2.pclr is not None and jp2.cmap is not None:
        n = jp2.pclr.shape[1]
        sane = True
        used = [False] * n
        for i, (cmp, mtyp, pcol) in enumerate(jp2.cmap):
            if cmp >= ncomps:
                sane = False
        for i, (cmp, mtyp, pcol) in enumerate(jp2.cmap):
            if mtyp not in (0, 1) or pcol >= n or (used[pcol] and mtyp == 1) \
                    or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        if any(not used[i] and jp2.cmap[i][1] != 0 for i in range(n)):
            sane = False
        if sane and ncomps == 1 and not all(used):
            for i in range(n):  # "Component mapping seems wrong. Trying to correct."
                jp2.cmap[i][1], jp2.cmap[i][2] = 1, i
        if not sane:
            raise ValueError("JP2 cmap box is inconsistent")


def _apply_color(jp2: _Jp2, planes: List[np.ndarray]) -> List[np.ndarray]:
    """The palette and the channel definitions, as opj_jp2_apply_pclr and
    opj_jp2_apply_cdef apply them (the alpha flags cdef sets change nothing
    OpenCV gives in three channels)."""
    if jp2.pclr is not None and jp2.cmap is not None:
        table = jp2.pclr
        top = table.shape[0] - 1
        out = []
        for cmp, mtyp, pcol in jp2.cmap:
            if mtyp == 0:
                out.append(planes[cmp].copy())
            else:  # entries are unsigned 32-bit, stored into int32 samples
                out.append(table[np.clip(planes[cmp], 0, top), pcol].astype(np.uint32)
                           .view(np.int32))
        planes = out
    if jp2.cdef is not None:
        info = [list(d) for d in jp2.cdef]
        for i, (cn, typ, asoc) in enumerate(info):
            acn = asoc - 1
            if asoc in (0, 65535) or cn >= len(planes) or acn >= len(planes):
                continue
            if cn != acn and typ == 0:  # a colour channel in another's place: swapped
                planes[cn], planes[acn] = planes[acn], planes[cn]
                for later in info[i + 1 :]:
                    if later[0] == cn:
                        later[0] = acn
                    elif later[0] == acn:
                        later[0] = cn
    return planes


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """OpenCV's ``COLOR_YUV2BGR`` on uint8 (14-bit fixed point, rounded),
    as RGB."""
    y = y.astype(np.int32)
    u = u.astype(np.int32) - 128
    v = v.astype(np.int32) - 128
    half = 1 << 13
    b = y + ((u * 33292 + half) >> 14)
    g = y + ((u * -6472 + v * -9519 + half) >> 14)
    r = y + ((v * 18678 + half) >> 14)
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A JP2 file or a raw JPEG 2000 codestream -> RGB uint8 ``[H, W, 3]``."""
    from rcnn_ocr_tpu_torch.native import j2k_decode, j2k_header

    jp2: Optional[_Jp2] = None
    stream = data
    if data.startswith(JP2_SIGNATURE):
        jp2, start = _walk(data)
        stream = data[start:]
    (x0, y0, x1, y1), comps = j2k_header(stream)
    if jp2 is not None and jp2.ihdr is not None:
        h, w, _ = jp2.ihdr
        if w != x1 - x0 or h != y1 - y0:
            raise ValueError("JP2 ihdr sides differ from the codestream's")
    # OpenCV's header checks
    if not 1 <= len(comps) <= 4:
        raise ValueError(f"JPEG 2000 with {len(comps)} components (OpenCV reads 1 to 4)")
    if any(c[7] for c in comps):
        raise ValueError("JPEG 2000 with a signed component (OpenCV refuses it)")
    max_prec = max(c[6] for c in comps)
    if max_prec < 8:
        raise ValueError(f"JPEG 2000 of precision {max_prec} (OpenCV reads 8 or more)")
    width, height = x1 - x0, y1 - y0
    check_size(width, height, "JPEG 2000")
    if any(c[0] != 1 or c[1] != 1 or c[4] != 0 or c[5] != 0 for c in comps):
        # OpenCV fails after decoding: subsampled or offset components
        raise ValueError("JPEG 2000 with subsampled or offset components (OpenCV refuses them)")
    planes = j2k_decode(stream, comps)
    space: Optional[int] = None  # unspecified
    if jp2 is not None:
        _check_color(jp2, len(planes))
        space = jp2.enumcs if jp2.enumcs in (_SRGB, _GRAY, _SYCC, 24, 12) else 0
        planes = _apply_color(jp2, planes)
    if space in _FAILING_SPACES:
        raise ValueError(f"JPEG 2000 in {_FAILING_SPACES[space]} (OpenCV does not convert it)")
    shift = max_prec - 8
    if space == _SYCC:
        if len(planes) < 3:
            raise ValueError(f"JPEG 2000 of {len(planes)} components in sYCC (OpenCV needs 3)")
        return _yuv_to_rgb(*[(p >> shift).astype(np.uint8) for p in planes[:3]])
    if space == _GRAY:
        gray = (planes[0] >> shift).astype(np.uint8)
        return np.repeat(gray[:, :, None], 3, axis=2)
    if len(planes) < 3:
        raise ValueError(f"JPEG 2000 of {len(planes)} components in sRGB (OpenCV needs 3)")
    return np.stack([(p >> shift).astype(np.uint8) for p in planes[:3]], axis=2)
