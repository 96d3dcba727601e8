"""Write the TIFF fixtures the port's decoder is held to on the card.

    python tests/torch_port_data/make_tiff_fixtures.py

Needs cv2 and PIL (the card's script reads only the files).  Writes into
``tests/torch_port_data/tiff/``:

* files written by :func:`tiff_bytes` below, one per decoder path: every
  compression (none, PackBits, LZW, Deflate 8 and 32946) with and without
  the horizontal predictor, gray (MinIsBlack and MinIsWhite) at 1, 4, 8 and
  16 bits, palette at 4 and 8 bits (16-bit and 8-bit-valued colour maps),
  RGB at 8 and 16 bits, RGBA (associated, unassociated and unspecified
  alpha), strips and tiles, both byte orders, planar configurations 1 and
  2, orientations 1-8 and a two-page file;
* files written by cv2 and PIL (each of their compressions and modes);
* ``expected.npz``: cv2's RGB pixels (``cv2.imdecode(IMREAD_COLOR)`` then
  BGR -> RGB) of every file, keyed by file name.

:func:`tiff_bytes` writes any of these layouts from a sample array, so the
tests use it for their seeded fuzz too.  Everything is seeded, so a rerun
writes the same bytes with the same cv2 and PIL.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiff")
COMPRESSION = {"none": 1, "lzw": 5, "deflate": 8, "zip": 32946, "packbits": 32773}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


# --- encoders ---------------------------------------------------------------------------

def packbits(data: bytes) -> bytes:
    """PackBits: literal runs of up to 128 bytes and repeats of 2-128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + data[i : i + 1]
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9 to 12 bits, Clear (256) first and when
    the table fills, EOI (257) last, the width growing one code early."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code: int, width: int) -> None:
        nonlocal acc, nacc
        acc, nacc = (acc << width) | code, nacc + width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)

    table = {bytes([i]): i for i in range(256)}
    free, width = 258, 9
    put(256, width)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = free
        free += 1
        if free == 4094:
            put(256, width)
            table = {bytes([i]): i for i in range(256)}
            free, width = 258, 9
        elif free > (1 << width) - 1:
            width += 1
        w = bytes([b])
    if w:
        put(table[w], width)
        free += 1
        if free > (1 << width) - 1 and width < 12:
            width += 1
    put(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def compress(raw: bytes, compression: str) -> bytes:
    if compression == "none":
        return raw
    if compression == "packbits":
        return packbits(raw)
    if compression == "lzw":
        return lzw(raw)
    return zlib.compress(raw)


# --- the writer -------------------------------------------------------------------------

def _rows(block: np.ndarray, bits: int, order: str) -> bytes:
    """[rows, width, spp] samples -> bytes, each row padded to a byte."""
    if bits == 16:
        return block.astype(order + "u2").tobytes()
    if bits == 8:
        return block.astype(np.uint8).tobytes()
    flat = block.reshape(block.shape[0], -1).astype(np.uint8)
    per = 8 // bits
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad)))
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    packed = (flat.reshape(flat.shape[0], -1, per) << shifts).sum(axis=2, dtype=np.uint16)
    return packed.astype(np.uint8).tobytes()


def _predict(block: np.ndarray, bits: int) -> np.ndarray:
    """Horizontal differencing along each row, per sample."""
    dt = np.uint16 if bits == 16 else np.uint8
    b = block.astype(dt)
    out = b.copy()
    out[:, 1:] = b[:, 1:] - b[:, :-1]
    return out


def tiff_bytes(samples: np.ndarray, bits: int = 8, photometric: int = 1,
               compression: str = "none", predictor: int = 1, planar: int = 1,
               tile=None, rows_per_strip: int = 8, order: str = "<",
               orientation=None, extra_samples=None, colormap=None,
               fill_order: int = 1, pages=None) -> bytes:
    """One TIFF from ``samples`` ``[H, W, spp]`` (values below ``2**bits``):
    strips of ``rows_per_strip`` rows or tiles of ``tile = (w, h)``, chunky
    (``planar=1``) or planar (2), ``order`` ``"<"`` (II) or ``">"`` (MM).
    ``pages`` are further ``tiff_bytes`` keyword dicts, written as later
    IFDs."""
    pages = [dict(samples=samples, bits=bits, photometric=photometric, compression=compression,
                  predictor=predictor, planar=planar, tile=tile, rows_per_strip=rows_per_strip,
                  orientation=orientation, extra_samples=extra_samples, colormap=colormap,
                  fill_order=fill_order)] + list(pages or [])
    body = bytearray(b"II*\x00" if order == "<" else b"MM\x00*")
    body += struct.pack(order + "I", 0)
    link = 4  # where the next IFD offset goes
    for page in pages:
        ifd_at = _write_page(body, order, **{"bits": 8, "photometric": 1, "compression": "none",
                                             "predictor": 1, "planar": 1, "tile": None,
                                             "rows_per_strip": 8, "orientation": None,
                                             "extra_samples": None, "colormap": None,
                                             "fill_order": 1, **page})
        body[link : link + 4] = struct.pack(order + "I", ifd_at)
        link = len(body) - 4
    return bytes(body)


def _write_page(body: bytearray, order: str, samples, bits, photometric, compression,
                predictor, planar, tile, rows_per_strip, orientation, extra_samples,
                colormap, fill_order) -> int:
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, spp = samples.shape
    planes = [samples] if planar == 1 else [samples[:, :, i : i + 1] for i in range(spp)]
    chunks = []
    for plane in planes:
        if tile is None:
            blocks = [plane[y : y + rows_per_strip] for y in range(0, h, rows_per_strip)]
        else:
            tw, tl = tile
            blocks = []
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    t = np.zeros((tl, tw, plane.shape[2]), plane.dtype)
                    part = plane[y : y + tl, x : x + tw]
                    t[: part.shape[0], : part.shape[1]] = part
                    blocks.append(t)
        for blk in blocks:
            if predictor == 2:
                blk = _predict(blk, bits)
            raw = compress(_rows(blk, bits, order), compression)
            if fill_order == 2:  # bits stored least significant first
                raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            chunks.append(raw)
    offsets = []
    for c in chunks:
        if len(body) % 2:
            body.append(0)
        offsets.append(len(body))
        body += c
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
            (259, 3, [COMPRESSION[compression]]), (262, 3, [photometric])]
    if fill_order != 1:
        tags.append((266, 3, [fill_order]))
    if tile is None:
        tags.append((273, 4, offsets))
    if orientation is not None:
        tags.append((274, 3, [orientation]))
    tags.append((277, 3, [spp]))
    if tile is None:
        tags += [(278, 4, [rows_per_strip]), (279, 4, [len(c) for c in chunks])]
    tags.append((284, 3, [planar]))
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if colormap is not None:
        tags.append((320, 3, list(np.asarray(colormap, np.uint16).T.reshape(-1))))
    if tile is not None:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, offsets),
                 (325, 4, [len(c) for c in chunks])]
    if extra_samples is not None:
        tags.append((338, 3, [extra_samples]))
    tags.sort()
    data, where = bytearray(), {}
    for tag, typ, vals in tags:  # values over 4 bytes go before the IFD
        raw = struct.pack(order + ("H" if typ == 3 else "I") * len(vals), *map(int, vals))
        if len(raw) > 4:
            where[tag] = len(body) + len(data)
            data += raw + b"\0" * (len(raw) % 2)
    body += data
    ifd_at = len(body)
    body += struct.pack(order + "H", len(tags))
    for tag, typ, vals in tags:
        raw = struct.pack(order + ("H" if typ == 3 else "I") * len(vals), *map(int, vals))
        value = struct.pack(order + "I", where[tag]) if tag in where else raw.ljust(4, b"\0")
        body += struct.pack(order + "HHI", tag, typ, len(vals)) + value
    body += struct.pack(order + "I", 0)  # the next IFD, set by the caller
    return ifd_at


# --- the fixtures -----------------------------------------------------------------------

def _smooth(rng, h: int, w: int, channels: int = 3) -> np.ndarray:
    import cv2

    img = rng.integers(0, 256, (h, w, channels)).astype(np.uint8)
    return cv2.GaussianBlur(img, (3, 3), 0).reshape(h, w, channels)


def _line(rng) -> np.ndarray:
    """A small text line: light ground, dark strokes, noise of +-3."""
    h, w = 24, int(rng.integers(60, 90))
    img = np.full((h, w, 3), int(rng.integers(200, 256)), np.uint8)
    for _ in range(int(rng.integers(3, 8))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0 : y0 + int(rng.integers(2, 14)), x0 : x0 + int(rng.integers(1, 6))] = \
            rng.integers(0, 90, 3)
    return np.clip(img.astype(np.int16) + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)


def fixtures() -> dict:
    import cv2
    from PIL import Image

    rng = np.random.default_rng(20261020)
    files = {}
    rgb = _smooth(rng, 13, 19)
    for comp in ("none", "packbits", "lzw", "deflate", "zip"):
        files[f"rgb8_{comp}_13x19.tif"] = tiff_bytes(rgb, photometric=2, compression=comp,
                                                      rows_per_strip=5)
        if comp in ("lzw", "deflate", "zip"):
            files[f"rgb8_{comp}_pred2_13x19.tif"] = tiff_bytes(
                rgb, photometric=2, compression=comp, predictor=2, rows_per_strip=5)
    gray = _smooth(rng, 11, 17, 1)
    for phot, name in ((1, "minisblack"), (0, "miniswhite")):
        files[f"gray1_{name}_11x17.tif"] = tiff_bytes((gray > 127).astype(np.uint8), bits=1,
                                                       photometric=phot, compression="packbits")
        files[f"gray8_{name}_11x17.tif"] = tiff_bytes(gray, photometric=phot, compression="lzw")
        files[f"gray16_{name}_mm_11x17.tif"] = tiff_bytes(
            gray.astype(np.uint16) * 257 + rng.integers(0, 257, gray.shape).astype(np.uint16),
            bits=16, photometric=phot, compression="deflate", predictor=2, order=">")
    for bits, cmap_max, name in ((1, 65536, "map16"), (4, 65536, "map16"), (8, 65536, "map16"),
                                 (8, 256, "map8")):
        idx = rng.integers(0, 1 << bits, (12, 15, 1)).astype(np.uint8)
        cmap = rng.integers(0, cmap_max, (1 << bits, 3))
        files[f"palette{bits}_{name}_12x15.tif"] = tiff_bytes(idx, bits=bits, photometric=3,
                                                              colormap=cmap, compression="lzw")
    rgb16 = rng.integers(0, 65536, (10, 14, 3)).astype(np.uint16)
    files["rgb16_lzw_pred2_mm_10x14.tif"] = tiff_bytes(rgb16, bits=16, photometric=2,
                                                       compression="lzw", predictor=2, order=">")
    files["rgb16_deflate_10x14.tif"] = tiff_bytes(rgb16, bits=16, photometric=2,
                                                  compression="deflate")
    rgba = np.concatenate([_smooth(rng, 12, 16), rng.integers(0, 256, (12, 16, 1)).astype(np.uint8)], 2)
    for extra, name in ((2, "unassociated"), (1, "associated"), (0, "unspecified")):
        files[f"rgba8_{name}_12x16.tif"] = tiff_bytes(rgba, photometric=2, extra_samples=extra,
                                                      compression="lzw")
    files["rgba16_unassociated_planar_10x14.tif"] = tiff_bytes(
        np.concatenate([rgb16, rng.integers(0, 65536, (10, 14, 1)).astype(np.uint16)], 2),
        bits=16, photometric=2, extra_samples=2, planar=2, compression="deflate")
    files["gray_alpha8_12x16.tif"] = tiff_bytes(rgba[:, :, 2:], photometric=1, extra_samples=2)
    files["gray_alpha8_planar_12x16.tif"] = tiff_bytes(rgba[:, :, 2:], photometric=1,
                                                       extra_samples=2, planar=2)
    files["cmyk8_packbits_12x16.tif"] = tiff_bytes(rng.integers(0, 256, (12, 16, 4)).astype(np.uint8),
                                                   photometric=5, compression="packbits")
    files["rgb8_planar_lzw_pred2_13x19.tif"] = tiff_bytes(rgb, photometric=2, planar=2,
                                                          compression="lzw", predictor=2)
    big = _smooth(rng, 21, 37)
    files["rgb8_tiles16_lzw_21x37.tif"] = tiff_bytes(big, photometric=2, tile=(16, 16),
                                                     compression="lzw")
    files["rgb8_tiles32_none_21x37.tif"] = tiff_bytes(big, photometric=2, tile=(32, 32))
    files["rgb8_tiles_planar_deflate_mm_21x37.tif"] = tiff_bytes(
        big, photometric=2, tile=(16, 16), planar=2, compression="deflate", order=">")
    files["gray16_tiles_deflate_21x37.tif"] = tiff_bytes(
        rng.integers(0, 65536, (21, 37, 1)).astype(np.uint16), bits=16, tile=(32, 16),
        compression="deflate")
    small = _smooth(rng, 7, 11)
    for o in range(1, 9):
        files[f"orientation{o}_7x11.tif"] = tiff_bytes(small, photometric=2, orientation=o,
                                                       compression="lzw", rows_per_strip=3)
    for o in (2, 6):
        files[f"orientation{o}_tiles_21x37.tif"] = tiff_bytes(
            big, photometric=2, tile=(16, 16), orientation=o, compression="lzw")
    files["gray1_fillorder2_11x17.tif"] = tiff_bytes((gray < 100).astype(np.uint8), bits=1,
                                                     fill_order=2)
    files["two_pages_13x19.tif"] = tiff_bytes(rgb, photometric=2, compression="lzw",
                                              pages=[dict(samples=gray, photometric=1)])
    for comp in (1, 5, 8, 32773):
        ok, buf = cv2.imencode(".tiff", _smooth(rng, 12, 18), [cv2.IMWRITE_TIFF_COMPRESSION, comp])
        assert ok
        files[f"cv2_c{comp}_12x18.tif"] = buf.tobytes()
    ok, buf = cv2.imencode(".tiff", rng.integers(0, 65536, (9, 13)).astype(np.uint16))
    files["cv2_gray16_9x13.tif"] = buf.tobytes()
    src = _smooth(rng, 12, 18, 4)
    for mode, comp in (("RGB", "tiff_lzw"), ("RGBA", "tiff_adobe_deflate"), ("P", "packbits"),
                       ("1", None), ("LA", "tiff_deflate"), ("CMYK", "tiff_lzw"), ("L", "jpeg"),
                       ("1", "group4")):
        bio = io.BytesIO()
        kw = {"compression": comp} if comp else {}
        Image.fromarray(src, "RGBA").convert(mode).save(bio, format="TIFF", **kw)
        name = f"pil_{mode.lower()}_{comp or 'raw'}_12x18.tif"
        files[name] = bio.getvalue()
    for k in range(2):  # text lines for the card's daemon phase
        line = _line(rng)
        files[f"tiff_line_{k}.tif"] = tiff_bytes(line, photometric=2, compression=("lzw", "deflate")[k],
                                                 predictor=2, rows_per_strip=8)
    return files


# the refusals of ``data/tiff.py``, which the tests read but expected.npz
# has no pixels for
REFUSED = {"pil_l_jpeg_12x18.tif": "JPEG TIFF compression (7)",
           "pil_1_group4_12x18.tif": "CCITT Group 4 fax TIFF compression (4)"}


def main() -> None:
    import cv2

    os.makedirs(OUT, exist_ok=True)
    expected = {}
    for name, data in fixtures().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert bgr is not None, name
        if name not in REFUSED:
            expected[name] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    np.savez_compressed(os.path.join(OUT, "expected.npz"), **expected)
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {len(expected) + len(REFUSED)} TIFFs and expected.npz into {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
