"""Write the BMP fixtures the port's decoder is held to on the card.

    python tests/torch_port_data/make_bmp_fixtures.py

Needs cv2 and PIL (the card's script reads only the files).  Writes into
``tests/torch_port_data/bmp/``:

* files written by :func:`bmp_bytes` below, one per decoder path: 1-, 4-
  and 8-bit palettes (full, short with indices past them, gray), 16-bit
  5-5-5 (BI_RGB and BI_BITFIELDS) and 5-6-5, 24-bit, 32-bit BI_RGB and
  BI_BITFIELDS, RLE8 and RLE4 (encoded and absolute runs, odd absolute
  lengths, end-of-line, delta and end-of-bitmap codes), the OS/2 core
  header (12 bytes, 3-byte palette entries) and the V4 / V5 headers (108
  and 124 bytes), bottom-up and top-down, odd widths;
* files written by cv2 and PIL (PIL's 1-bit bilevel scan among them);
* ``bmp1_line_N.bmp`` and ``rle8_line_N.bmp``: text lines for the card's
  daemon phase;
* ``expected.npz``: cv2's RGB pixels (``cv2.imdecode(IMREAD_COLOR)`` then
  BGR -> RGB) of every file, keyed by file name.

:func:`bmp_bytes` writes any of these layouts, and :func:`rle_random`
draws RLE streams of every code, so the tests use them for their seeded
fuzz too.  Everything is seeded, so a rerun writes the same bytes with the
same cv2 and PIL.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bmp")
COMPRESSION = {"rgb": 0, "rle8": 1, "rle4": 2, "bitfields": 3}
MASKS_555 = (0x7C00, 0x03E0, 0x001F)
MASKS_565 = (0xF800, 0x07E0, 0x001F)


# --- RLE --------------------------------------------------------------------------------

def rle_encode(idx: np.ndarray, bits: int) -> bytes:
    """RLE8 (``bits`` 8) or RLE4 (4) of palette indices ``[H, W]`` in the
    order the rows are stored: runs of equal indices (RLE4: of an
    alternating pair) as encoded runs, the rest as word-padded absolute
    runs of 3 or more, end-of-line after each row and end-of-bitmap last."""
    out = bytearray()
    per = 255 if bits == 8 else 254
    for row in idx:
        row = [int(v) for v in row]
        x, w = 0, len(row)
        while x < w:
            if bits == 8:
                n = 1
                while x + n < w and n < per and row[x + n] == row[x]:
                    n += 1
            else:
                n = 2 if x + 1 < w else 1
                while x + n < w and n < per and row[x + n] == row[x + n - 2]:
                    n += 1
            if n >= 3 or w - x < 3:
                pair = row[x] if bits == 8 else (row[x] << 4) | (row[x + 1] if n > 1 else 0)
                out += bytes([n, pair])
                x += n
                continue
            n = 3
            while x + n < w and n < per and not (x + n + 2 < w
                                                 and row[x + n] == row[x + n + 1] == row[x + n + 2]):
                n += 1
            out += _absolute(row[x : x + n], bits)
            x += n
        out += b"\x00\x00"
    out[-2:] = b"\x00\x01"
    return bytes(out)


def _absolute(vals, bits: int) -> bytes:
    """An absolute run (``00 n`` then the indices, padded to a word)."""
    if bits == 8:
        body = bytes(vals)
    else:
        v = list(vals) + [0] * (len(vals) % 2)
        body = bytes((v[i] << 4) | v[i + 1] for i in range(0, len(v), 2))
    return bytes([0, len(vals)]) + body + b"\x00" * (len(body) % 2)


def rle_random(rng, h: int, w: int, bits: int, n_index: int, dy: bool = True,
               early_end: bool = True) -> bytes:
    """A random RLE8 / RLE4 stream of ``h`` rows of ``w`` pixels: encoded
    and absolute runs, deltas (moving down rows too with ``dy``),
    end-of-line before the row is full, and (with ``early_end``) an
    end-of-bitmap that may come early; every run fits its row.  OpenCV's
    RLE4 loop ignores a delta's rows and reads on after an early
    end-of-bitmap, so it decodes RLE4 streams drawn without either."""
    out = bytearray()
    y = 0
    while y < h:
        x = 0
        while x < w:
            r = rng.random()
            left = w - x
            if r < 0.45:
                n = int(rng.integers(1, min(left, 255) + 1))
                pair = int(rng.integers(0, n_index)) if bits == 8 else \
                    (int(rng.integers(0, n_index)) << 4) | int(rng.integers(0, n_index))
                out += bytes([n, pair])
                x += n
            elif r < 0.8 and left >= 3:
                n = int(rng.integers(3, min(left, 255) + 1))
                out += _absolute(rng.integers(0, n_index, n).tolist(), bits)
                x += n
            elif r < 0.9 and y + 1 < h:
                dx = int(rng.integers(0, left))
                down = int(rng.integers(0, min(3, h - y))) if dy else 0
                out += bytes([0, 2, dx, down])
                x += dx
                y += down
            elif r < 0.95 or not early_end:
                break  # end of line before the row is full
            else:
                return bytes(out + b"\x00\x01")  # end of bitmap, early
        out += b"\x00\x00"
        y += 1
    return bytes(out + b"\x00\x01")


# --- the writer -------------------------------------------------------------------------

def _rows(raw: np.ndarray, bits: int) -> bytes:
    """Pixel rows (top first, as given) -> bytes, each padded to 4 bytes."""
    h = raw.shape[0]
    if bits < 8:
        per = 8 // bits
        flat = raw.reshape(h, -1).astype(np.uint8)
        flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % per)))
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        body = (flat.reshape(h, -1, per) << shifts).sum(axis=2, dtype=np.uint16).astype(np.uint8)
    elif bits == 16:
        body = raw.astype("<u2").reshape(h, -1).view(np.uint8)
    else:
        body = raw.astype(np.uint8).reshape(h, -1)
    body = np.pad(body, ((0, 0), (0, (-body.shape[1]) % 4)))
    return body.tobytes()


def bmp_bytes(raw: np.ndarray, bits: int = 24, compression: str = "rgb", header: int = 40,
              top_down: bool = False, palette=None, n_colors=None, masks=None, rle=None,
              gap: int = 0, masks_after_header=None) -> bytes:
    """One BMP from ``raw`` pixels in file order, top row first: palette
    indices ``[H, W]`` for ``bits`` <= 8, 16-bit words ``[H, W]`` for 16,
    bytes ``[H, W, 3]`` (B, G, R) or ``[H, W, 4]`` for 24 and 32.

    ``header`` is the DIB header's size: 12 (OS/2 core), 40, 52, 56, 108
    (V4) or 124 (V5); ``palette`` ``[N, 3]`` RGB (3-byte entries in a core
    header, 4-byte otherwise), ``n_colors`` the header's colours-used field
    (default ``N``, 0 kept as 0); ``masks`` (R, G, B) for BI_BITFIELDS, in
    the header from 52 bytes on, else after it, or both with
    ``masks_after_header``; ``rle`` a ready RLE stream (else
    :func:`rle_encode` of ``raw``); ``gap`` spare bytes before the pixels."""
    raw = np.asarray(raw)
    h, w = raw.shape[:2]
    if rle is None and compression in ("rle8", "rle4"):
        rle = rle_encode(raw if top_down else raw[::-1], 8 if compression == "rle8" else 4)
    pixels = rle if rle is not None else _rows(raw if top_down else raw[::-1], bits)
    masks = tuple(masks) if masks is not None else None
    if header == 12:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        comp = COMPRESSION[compression]
        ncol = (len(palette) if palette is not None else 0) if n_colors is None else n_colors
        dib = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, comp,
                          len(pixels), 2835, 2835, ncol, 0)
        if header >= 52:
            dib += struct.pack("<III", *(masks or (0, 0, 0)))
        if header >= 56:
            dib += struct.pack("<I", 0)  # alpha mask
        if header >= 108:
            dib += b"BGRs" + bytes(36) + bytes(12)  # colour space, endpoints, gammas
        if header >= 124:
            dib += struct.pack("<IIII", 4, 0, 0, 0)  # intent, profile data / size, reserved
        dib = dib.ljust(header, b"\0")
        if masks is not None and (header == 40 if masks_after_header is None
                                  else masks_after_header):
            dib += struct.pack("<III", *masks)
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]  # RGB -> BGR
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], axis=1)
        pal = p.tobytes()
    offset = 14 + len(dib) + len(pal) + gap
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + dib + pal
            + bytes(gap) + pixels)


# --- the fixtures -----------------------------------------------------------------------

def _line(rng) -> np.ndarray:
    """A small text line: light ground, dark strokes, noise of +-3."""
    h, w = 24, int(rng.integers(60, 90))
    img = np.full((h, w, 3), int(rng.integers(200, 256)), np.uint8)
    for _ in range(int(rng.integers(3, 8))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0 : y0 + int(rng.integers(2, 14)), x0 : x0 + int(rng.integers(1, 6))] = \
            rng.integers(0, 90, 3)
    return np.clip(img.astype(np.int16) + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)


def _quantize(img: np.ndarray, levels: int):
    """An RGB image -> (indices, palette) over ``levels`` gray levels."""
    gray = img.mean(axis=2)
    idx = np.clip((gray * levels / 256).astype(np.int64), 0, levels - 1).astype(np.uint8)
    pal = np.repeat(((np.arange(levels) * 255) // max(levels - 1, 1))[:, None], 3, 1)
    return idx, pal.astype(np.uint8)


def fixtures() -> dict:
    import cv2
    from PIL import Image

    rng = np.random.default_rng(20261112)
    files = {}
    h, w = 11, 19
    for bits in (1, 4, 8):
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, n, (h, w)).astype(np.uint8)
        files[f"pal{bits}_{h}x{w}.bmp"] = bmp_bytes(idx, bits, palette=pal)
        files[f"pal{bits}_topdown_{h}x{w}.bmp"] = bmp_bytes(idx, bits, palette=pal, top_down=True)
        files[f"pal{bits}_core_{h}x{w}.bmp"] = bmp_bytes(idx, bits, palette=pal, header=12)
        files[f"pal{bits}_v5_{h}x{w}.bmp"] = bmp_bytes(idx, bits, palette=pal, header=124)
        short = max(1, n // 2 - 1)  # indices past the palette's end
        files[f"pal{bits}_short{short}_{h}x{w}.bmp"] = bmp_bytes(idx, bits, palette=pal[:short])
    files["pal8_gray_{}x{}.bmp".format(h, w)] = bmp_bytes(
        rng.integers(0, 256, (h, w)).astype(np.uint8), 8,
        palette=np.repeat(np.arange(256)[:, None], 3, 1))
    files["pal4_gap_13x7.bmp"] = bmp_bytes(rng.integers(0, 16, (13, 7)).astype(np.uint8), 4,
                                           palette=rng.integers(0, 256, (16, 3)), gap=6)
    words = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    files[f"rgb555_{h}x{w}.bmp"] = bmp_bytes(words, 16)
    files[f"rgb555_bitfields_{h}x{w}.bmp"] = bmp_bytes(words, 16, "bitfields", masks=MASKS_555)
    files[f"rgb565_bitfields_{h}x{w}.bmp"] = bmp_bytes(words, 16, "bitfields", masks=MASKS_565)
    files[f"rgb565_v3_{h}x{w}.bmp"] = bmp_bytes(words, 16, "bitfields", header=56,
                                               masks=MASKS_565, masks_after_header=True)
    files[f"rgb555_topdown_{h}x{w}.bmp"] = bmp_bytes(words, 16, top_down=True)
    bgr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    bgra = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    files[f"rgb24_v4_{h}x{w}.bmp"] = bmp_bytes(bgr, 24, header=108)
    files[f"rgb24_core_{h}x{w}.bmp"] = bmp_bytes(bgr, 24, header=12)
    files[f"rgb32_{h}x{w}.bmp"] = bmp_bytes(bgra, 32)
    files[f"rgb32_bitfields_v5_{h}x{w}.bmp"] = bmp_bytes(
        bgra, 32, "bitfields", header=124, masks=(0xFF0000, 0xFF00, 0xFF))
    for bits, name in ((8, "rle8"), (4, "rle4")):
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        img = rng.integers(0, 3, (14, 23)).astype(np.uint8).repeat(1, 0)
        img[:, 5:] = np.repeat(rng.integers(0, n, (14, 1)), 18, axis=1)  # long encoded runs
        img[3, :] = rng.integers(0, n, 23)  # absolute runs, odd length
        files[f"{name}_14x23.bmp"] = bmp_bytes(img, bits, name, palette=pal)
        files[f"{name}_topdown_14x23.bmp"] = bmp_bytes(img, bits, name, palette=pal, top_down=True)
        for k in range(3):
            files[f"{name}_codes{k}_17x29.bmp"] = bmp_bytes(
                np.zeros((17, 29), np.uint8), bits, name, palette=pal,
                rle=rle_random(rng, 17, 29, bits, n, dy=bits == 8, early_end=bits == 8))
        files[f"{name}_short_14x23.bmp"] = bmp_bytes(img % 5, bits, name, palette=pal[:3])
    src = np.concatenate([cv2.GaussianBlur(rng.integers(0, 256, (12, 18, 3)).astype(np.uint8),
                                           (3, 3), 0), rng.integers(0, 256, (12, 18, 1))
                          .astype(np.uint8)], axis=2)
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        bio = io.BytesIO()
        Image.fromarray(src, "RGBA").convert(mode).save(bio, format="BMP")
        files[f"pil_{mode.lower()}_12x18.bmp"] = bio.getvalue()
    files["cv2_12x18.bmp"] = cv2.imencode(".bmp", src[:, :, :3])[1].tobytes()
    files["cv2_gray_12x18.bmp"] = cv2.imencode(".bmp", src[:, :, 0])[1].tobytes()
    for k in range(2):  # text lines for the card's daemon phase
        idx, pal = _quantize(_line(rng), 2)
        files[f"bmp1_line_{k}.bmp"] = bmp_bytes(idx, 1, palette=pal)
        idx, pal = _quantize(_line(rng), 64)
        files[f"rle8_line_{k}.bmp"] = bmp_bytes(idx, 8, "rle8", palette=pal)
    return files


def main() -> None:
    import cv2

    os.makedirs(OUT, exist_ok=True)
    expected = {}
    for name, data in fixtures().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert bgr is not None, name
        expected[name] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    np.savez_compressed(os.path.join(OUT, "expected.npz"), **expected)
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {len(expected)} BMPs and expected.npz into {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
