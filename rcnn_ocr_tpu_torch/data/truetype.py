"""TrueType fonts for the synthetic line generator, without PIL.

:class:`TrueTypeFont` stands in for ``PIL.ImageFont.truetype(path, size)``
where the generator uses it (``textbbox`` and ``draw.text`` in mode L):
``csrc/host/truetype.cpp`` reads the font (cmap 4 / 12, simple and
composite ``glyf`` outlines, ``hmtx``), shapes the text as raqm and
HarfBuzz do with the default left-to-right features (GSUB ligatures and
single substitutions, GPOS pair kerning, one run a script) and rasterizes
the UNHINTED outline with exact-area coverage in integer arithmetic, so the
bitmap is the same on every host.  PIL hints the DejaVu fonts' outlines with
their TrueType bytecode, which this reader does not run: widths and layout
follow PIL's, edge pixels do not (the bound is stated in
``tests/test_torch_port_synthetic.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from rcnn_ocr_tpu_torch import native

_U32P = ctypes.POINTER(ctypes.c_uint32)


def _text(text: str) -> Tuple[np.ndarray, int]:
    cps = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32).copy()
    return cps, cps.size


def _raise(msg) -> None:
    raise ValueError(msg.value.decode("utf-8", "replace"))


class TrueTypeFont:
    """A TrueType font file at one pixel ``size`` (PIL's
    ``ImageFont.truetype(path, size)``).  Raises ``ValueError`` on a file
    the reader cannot parse (no ``glyf`` outlines, a missing table, no
    Unicode cmap of format 4 or 12)."""

    def __init__(self, path: str, size: int):
        with open(path, "rb") as f:
            data = f.read()
        self.path, self.size = path, int(size)
        self._lib = native.load("truetype")
        handle = ctypes.c_int64(0)
        msg = ctypes.create_string_buffer(256)
        if self._lib.rcnn_tt_open(data, len(data), ctypes.byref(handle), msg, len(msg)) < 0:
            raise ValueError(f"{path}: {msg.value.decode('utf-8', 'replace')}")
        self._handle = handle.value

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", 0), 0
        if handle:
            self._lib.rcnn_tt_close(handle)

    def shape(self, text: str):
        """``(glyph ids, x advances, x offsets)`` of the shaped text, the
        positions in 26.6 fixed point (1/64 pixel)."""
        cps, n = _text(text)
        cap = max(n, 1)
        ids = np.zeros(cap, np.int32)
        adv = np.zeros(cap, np.int64)
        off = np.zeros(cap, np.int64)
        msg = ctypes.create_string_buffer(256)
        got = self._lib.rcnn_tt_shape(self._handle, self.size, cps.ctypes.data_as(_U32P), n,
                                      ids.ctypes.data_as(native._P32),
                                      adv.ctypes.data_as(native._P64),
                                      off.ctypes.data_as(native._P64), cap, msg, len(msg))
        if got < 0:
            _raise(msg)
        return ids[:got], adv[:got], off[:got]

    def getlength(self, text: str) -> float:
        """The pen's advance over the text in pixels (PIL's ``getlength``)."""
        return float(self.shape(text)[1].sum()) / 64.0

    def metrics(self) -> Tuple[int, int]:
        """``(ascent, descent)`` in pixels, as PIL's ``getmetrics``."""
        box = self._box("")
        return int(box[4]), -int(box[5])

    def _box(self, text: str) -> np.ndarray:
        cps, n = _text(text)
        box = np.zeros(6, np.int64)
        msg = ctypes.create_string_buffer(256)
        if self._lib.rcnn_tt_text_box(self._handle, self.size, cps.ctypes.data_as(_U32P), n,
                                      box.ctypes.data_as(native._P64), msg, len(msg)) < 0:
            _raise(msg)
        return box

    def getbbox(self, text: str) -> Tuple[int, int, int, int]:
        """``(left, top, right, bottom)`` of the text drawn at (0, 0) with
        the top at the ascender (PIL's ``getbbox`` / ``textbbox``)."""
        return tuple(int(v) for v in self._box(text)[:4])

    def draw(self, canvas: np.ndarray, xy, text: str, fill: int) -> None:
        """PIL's ``ImageDraw.Draw(canvas).text(xy, text, font=self,
        fill=fill)`` on a uint8 ``[H, W]`` canvas (mode L), in place."""
        if canvas.dtype != np.uint8 or canvas.ndim != 2 or not canvas.flags["C_CONTIGUOUS"]:
            raise ValueError("canvas must be a contiguous uint8 [H, W] array")
        cps, n = _text(text)
        msg = ctypes.create_string_buffer(256)
        h, w = canvas.shape
        if self._lib.rcnn_tt_draw(self._handle, self.size, cps.ctypes.data_as(_U32P), n,
                                  canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                                  int(xy[0]), int(xy[1]), int(fill), msg, len(msg)) < 0:
            _raise(msg)
