"""Recover libtiff's LogLuv24 (u', v') table from cv2's decode.

    python tests/torch_port_data/derive_uv_rows.py

Needs cv2.  A LogLuv24 pixel is a 10-bit log luminance ``Le`` and a 14-bit
index ``Ce`` into libtiff's ``uv_row`` table (``uvcode.h``: 163 rows of
``ustart``, ``nus``, ``ncum``), which no source file here holds.  This
writes one 4096 x 4096 LogLuv24 TIFF holding every one of the 2**24 codes,
decodes it with ``cv2.imdecode``, and reads the table back from the
pixels:

1. For a known v' and luminance ``L``, each of XYZtoRGB24's channels is
   ``L * (slope * u' + intercept)`` (X / L = 9u' / 4v' and Z / L = (12 -
   3u' - 20v') / 4v' are linear in u'), and an 8-bit output ``k`` bounds
   the channel to ``[(k / 256)**2, ((k + 1) / 256)**2)`` (0 and 255 to
   one side).  Over the 1023 lit luminances that bounds each code's u'
   to a narrow interval.
2. Codes run through the rows in order, v' = UV_VSTART + (vi + 0.5) *
   UV_SQSIZ in row ``vi`` and u' = ustart + (ui + 0.5) * UV_SQSIZ at the
   row's ``ui``-th code, so a row's codes must agree on one ``ustart``: a
   code that cannot (under the row's v') starts the next row.  That gives
   ``nus`` per row and an interval for ``ustart``.
3. uvcode.h writes ``ustart`` with six decimals: of the six-decimal values
   in the interval, the one whose float reproduces cv2's pixels for every
   code of the row and every luminance through the port's own arithmetic
   (``rcnn_ocr_tpu_torch.data.tiff._luv24_rgb``) is the row's.

It prints the rows as the ``_UV_ROWS`` literal of ``data/tiff.py`` and
checks the whole table against all 2**24 codes.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
sys.path.insert(0, HERE)

SQ = float(np.float32(0.0035))  # UV_SQSIZ
VSTART = float(np.float32(0.01694))  # UV_VSTART
NDIVS = 16289  # UV_NDIVS: indices past the table decode neutral
# XYZtoRGB24's rows
MATRIX = ((2.690, -1.276, -0.414), (-1.022, 1.978, 0.044), (0.061, -0.224, 1.163))


def all_codes_tiff() -> bytes:
    """A 4096 x 4096 LogLuv24 TIFF whose pixel ``i`` (row-major) is code
    ``i``: ``Le = i >> 14``, ``Ce = i & 0x3FFF``."""
    from make_tiff_fixtures import logluv_tiff

    return logluv_tiff(np.arange(1 << 24, dtype=np.uint32).reshape(4096, 4096),
                       compression="sgilog24", bits=8, rows_per_strip=256)


def cv2_pixels(data: bytes) -> np.ndarray:
    """cv2's RGB for every code, ``[1024 (Le), 16384 (Ce), 3]``."""
    import cv2

    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return np.ascontiguousarray(bgr[:, :, ::-1]).reshape(1024, 16384, 3)


def _u_interval(out: np.ndarray, lum: np.ndarray, v: float):
    """The u' interval that a code's outputs ``out`` ``[1023, 3]`` at the
    lit luminances ``lum`` allow under ``v``, or ``None``."""
    lo, hi = -np.inf, np.inf
    for k, (a, b, c) in enumerate(MATRIX):
        slope = (9.0 * a - 3.0 * c) / (4.0 * v)
        icpt = b + c * (12.0 - 20.0 * v) / (4.0 * v)
        o = out[:, k].astype(np.float64)
        ch_lo = np.where(o == 0, -np.inf, (o / 256.0) ** 2)
        ch_hi = np.where(o == 255, np.inf, ((o + 1.0) / 256.0) ** 2)
        margin = 1e-6  # XYZ's float rounding, against the channel's cancellation
        u1 = (ch_lo / lum - margin - icpt) / slope
        u2 = (ch_hi / lum + margin - icpt) / slope
        if slope < 0:
            u1, u2 = u2, u1
        lo, hi = max(lo, np.max(u1)), min(hi, np.min(u2))
    return (lo, hi) if lo <= hi else None


def derive(px: np.ndarray):
    """The rows ``(ustart interval, nus)`` from cv2's pixels."""
    from rcnn_ocr_tpu_torch.data.tiff import _logl10_y

    lum = _logl10_y()[1:]
    lit = px[1:]
    rows = []
    vi, start, window = 0, 0, (-np.inf, np.inf)
    for c in range(NDIVS):
        for attempt in (0, 1):
            v = VSTART + (vi + 0.5) * SQ
            iv = _u_interval(lit[:, c], lum, v)
            if iv is not None:
                off = (c - start + 0.5) * SQ
                nxt = (max(window[0], iv[0] - off), min(window[1], iv[1] - off))
                if nxt[0] <= nxt[1]:
                    window = nxt
                    break
            if attempt:
                raise RuntimeError(f"code {c} fits neither row {vi - 1} nor row {vi}")
            rows.append((window, c - start))
            vi, start, window = vi + 1, c, (-np.inf, np.inf)
    rows.append((window, NDIVS - start))
    return rows


def exact(px: np.ndarray, rows):
    """Each row's six-decimal ``ustart`` that reproduces cv2's pixels."""
    from rcnn_ocr_tpu_torch.data import tiff

    out, ncum = [], 0
    le = np.arange(1024, dtype=np.uint32)
    for vi, ((lo, hi), nus) in enumerate(rows):
        codes = np.arange(ncum, ncum + nus, dtype=np.uint32)
        p = (le[:, None] << 14 | codes[None, :]).reshape(-1)
        want = px[:, ncum : ncum + nus].reshape(-1, 3)
        found = None
        for cand in np.arange(np.floor(lo * 1e6) - 2, np.ceil(hi * 1e6) + 3) / 1e6:
            trial = tuple(out) + ((round(float(cand), 6), nus),)
            tiff._UV_ROWS = trial + tuple((0.0, 0) for _ in range(len(rows) - vi - 1))
            tiff._uv24.cache_clear()
            if np.array_equal(tiff._luv24_rgb(p), want):
                found = round(float(cand), 6)
                break
        if found is None:
            raise RuntimeError(f"no six-decimal ustart in [{lo}, {hi}] reproduces row {vi}")
        out.append((found, nus))
        ncum += nus
    return out


def main() -> None:
    from rcnn_ocr_tpu_torch.data import tiff

    data = all_codes_tiff()
    px = cv2_pixels(data)
    rows = exact(px, derive(px))
    tiff._UV_ROWS = tuple(rows)
    tiff._uv24.cache_clear()
    got = tiff.decode(data).reshape(1024, 16384, 3)
    assert np.array_equal(got, px), "the table does not reproduce every code"
    print(f"{len(rows)} rows, {sum(n for _, n in rows)} indices; all 2**24 codes bit-equal")
    print("_UV_ROWS = (")
    for k in range(0, len(rows), 4):
        print("    " + " ".join(f"({u:.6f}, {n})," for u, n in rows[k : k + 4]))
    print(")")


if __name__ == "__main__":
    main()
