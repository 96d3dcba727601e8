"""Write the Sun raster, PFM and Radiance HDR fixtures the port's decoders
are held to on the card.

    python tests/torch_port_data/make_raster_fixtures.py

Needs cv2 (the card's script reads only the files).  Writes into
``tests/torch_port_data/raster/``:

* files written by cv2: 8- and 24-bit Sun rasters, PFM (``PF``, scale -1)
  and run-length encoded and flat Radiance HDR;
* hand-written bytes from :func:`ras_bytes` (1-, 8-, 24- and 32-bit, type
  0, colormaps full, short and of a length not divisible by 3, odd widths),
  :func:`pfm_bytes` (big- and little-endian, scales, values to round and
  saturate, NaN and infinities, spare header bytes) and :func:`hdr_bytes`
  (``#?RGBE``, header lines before FORMAT, runs and literals, widths under
  8 read flat, a scanline that turns the rest flat, exponents 0 and huge);
* ``ras_line_N.ras``, ``pfm_line_N.pfm``, ``hdr_line_N.hdr``: text lines
  for the card's daemon phase (an 8-bit colormapped raster, a ``PF`` map,
  a run-length encoded HDR);
* ``expected.npz``: cv2's RGB pixels (``cv2.imdecode(IMREAD_COLOR)`` then
  BGR -> RGB) of every file, keyed by file name.

Everything is seeded, so a rerun writes the same bytes with the same cv2.
"""

from __future__ import annotations

import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def ras_bytes(pixels: np.ndarray, depth: int, kind: int = 1, cmap=None, maplength=None,
              pad: int = 0) -> bytes:
    """A Sun raster: ``pixels`` are indices ``[H, W]`` (depth 1 or 8) or RGB
    ``[H, W, 3]`` (24 or 32); ``cmap`` an ``[n, 3]`` colormap written as its
    three planes (``maplength`` overrides the stored length, extra bytes
    zero); rows padded to 16 bits with ``pad``."""
    h, w = pixels.shape[:2]
    if depth == 1:
        rows = np.packbits(pixels.astype(np.uint8) & 1, axis=1)
    elif depth == 8:
        rows = pixels.astype(np.uint8)
    elif depth == 24:
        rows = pixels[:, :, ::-1].reshape(h, -1).astype(np.uint8)
    else:
        xbgr = np.concatenate([np.full((h, w, 1), pad, np.uint8), pixels[:, :, ::-1]], axis=2)
        rows = xbgr.reshape(h, -1).astype(np.uint8)
    if rows.shape[1] % 2:
        rows = np.concatenate([rows, np.full((h, 1), pad, np.uint8)], axis=1)
    mapbytes = b"" if cmap is None else np.asarray(cmap, np.uint8).T.tobytes()
    if maplength is not None:
        mapbytes = (mapbytes + bytes(maplength))[:maplength]
    raster = rows.tobytes()
    return struct.pack(">4sIIIIIII", b"\x59\xa6\x6a\x95", w, h, depth, len(raster), kind,
                       0 if cmap is None and not maplength else 1, len(mapbytes)) \
        + mapbytes + raster


def pfm_bytes(values: np.ndarray, scale: float = -1.0, header: bytes = None) -> bytes:
    """A ``PF`` map of float ``values`` ``[H, W, 3]`` (top row first; stored
    bottom-up), in the byte order the scale's sign gives."""
    h, w = values.shape[:2]
    order = "<" if scale < 0 else ">"
    head = header if header is not None else b"PF\n%d %d\n%r\n" % (w, h, scale)
    return head + np.ascontiguousarray(values[::-1], order + "f4").tobytes()


def hdr_bytes(rgbe: np.ndarray, rle: bool = True, header: bytes = None,
              flat_from: int = -1) -> bytes:
    """A Radiance HDR of ``rgbe`` ``[H, W, 4]`` bytes: each scanline run-length
    encoded (runs of 3 or more repeated bytes, literals of up to 128 between
    them), or flat; from scanline ``flat_from`` on, flat."""
    h, w = rgbe.shape[:2]
    out = [header if header is not None else
           b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w)]
    for y in range(h):
        if not rle or 0 <= flat_from <= y:
            out.append(rgbe[y:].astype(np.uint8).tobytes())
            break
        out.append(bytes([2, 2, w >> 8, w & 255]))
        for c in range(4):
            out.append(_runs(rgbe[y, :, c].astype(np.uint8).tobytes()))
    return b"".join(out)


def _runs(row: bytes) -> bytes:
    out, i, lit = [], 0, bytearray()
    while i < len(row):
        j = i
        while j < len(row) and row[j] == row[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            while lit:
                out.append(bytes([min(len(lit), 128)]) + bytes(lit[:128]))
                del lit[:128]
            out.append(bytes([128 + j - i, row[i]]))
            i = j
        else:
            lit.append(row[i])
            i += 1
    while lit:
        out.append(bytes([min(len(lit), 128)]) + bytes(lit[:128]))
        del lit[:128]
    return b"".join(out)


def fixtures(rng) -> dict:
    import cv2

    files = {}
    # an even width: cv2's writer pads an odd row with a byte it never sets
    img = rng.integers(0, 256, (13, 18, 3)).astype(np.uint8)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    files["cv2_24bit_13x18.ras"] = cv2.imencode(".ras", img[:, :, ::-1])[1].tobytes()
    files["cv2_8bit_13x18.ras"] = cv2.imencode(".ras", gray)[1].tobytes()
    bits = rng.integers(0, 2, (11, 21))
    idx = rng.integers(0, 256, (11, 21))
    pal = rng.integers(0, 256, (256, 3))
    files["hand_1bit_11x21.ras"] = ras_bytes(bits, 1)
    files["hand_1bit_cmap_11x21.ras"] = ras_bytes(bits, 1, cmap=pal[:2])
    files["hand_1bit_one_entry_cmap_11x21.ras"] = ras_bytes(bits, 1, cmap=pal[:1])
    files["hand_8bit_gray_type0_11x21.ras"] = ras_bytes(idx, 8, kind=0)
    files["hand_8bit_cmap_11x21.ras"] = ras_bytes(idx, 8, cmap=pal)
    files["hand_8bit_short_cmap_11x21.ras"] = ras_bytes(idx % 40, 8, cmap=pal[:20])
    files["hand_8bit_cmap_length_7_11x21.ras"] = ras_bytes(idx % 4, 8, cmap=pal[:2],
                                                          maplength=7)
    files["hand_24bit_odd_11x21.ras"] = ras_bytes(rng.integers(0, 256, (11, 21, 3)), 24,
                                                  pad=0xAB)
    files["hand_32bit_pad_11x21.ras"] = ras_bytes(rng.integers(0, 256, (11, 21, 3)), 32,
                                                  pad=0x5A)
    fimg = (rng.random((9, 14, 3)) * 1.2).astype(np.float32)
    files["cv2_9x14.pfm"] = cv2.imencode(".pfm", fimg[:, :, ::-1])[1].tobytes()
    vals = rng.uniform(-20, 300, (9, 14, 3)).astype(np.float32)
    vals[0, :6, 0] = [0.5, 1.5, 2.5, 254.5, 255.5, -0.5]
    vals[1, :4, 1] = [np.nan, np.inf, -np.inf, 3e9]
    files["hand_little_endian_9x14.pfm"] = pfm_bytes(vals, -1.0)
    files["hand_big_endian_scale_2_9x14.pfm"] = pfm_bytes(vals * 2, 2.0)
    files["hand_scale_quarter_9x14.pfm"] = pfm_bytes(vals / 4, -0.25)
    files["hand_header_fields_9x14.pfm"] = pfm_bytes(
        vals, -1.0, header=b"PF\n014\n9\t-1.000e0xyz\r")
    rgbe = rng.integers(0, 256, (7, 19, 4)).astype(np.uint8)
    rgbe[:, :, 3] = rng.integers(120, 140, (7, 19))
    rgbe[2, 3:14] = rgbe[2, 3]  # runs
    rgbe[4, :, 3] = 0
    rgbe[5, 0, 3] = 255
    hdr_img = (rng.random((11, 23, 3)) * 1.5).astype(np.float32)
    files["cv2_rle_11x23.hdr"] = cv2.imencode(".hdr", hdr_img[:, :, ::-1])[1].tobytes()
    files["cv2_flat_11x23.hdr"] = cv2.imencode(".hdr", hdr_img[:, :, ::-1], [
        cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_NONE])[1].tobytes()
    files["hand_rle_7x19.hdr"] = hdr_bytes(rgbe)
    files["hand_rle_then_flat_7x19.hdr"] = hdr_bytes(rgbe, flat_from=3)
    files["hand_rgbe_header_lines_7x19.hdr"] = hdr_bytes(
        rgbe, header=b"#?RGBE\nGAMMA=1.0\n# a comment\nEXPOSURE=2\n"
                     b"FORMAT=32-bit_rle_rgbe\n\n-Y7+X 19\n")
    files["hand_narrow_flat_7x5.hdr"] = hdr_bytes(rgbe[:, :5])
    from tests.torch_port_data.make_bmp_fixtures import _line, _quantize

    for k in range(2):  # text lines for the card's daemon phase
        q, grays = _quantize(_line(rng), 16)
        files[f"ras_line_{k}.ras"] = ras_bytes(q, 8, cmap=grays)
        line = _line(rng).astype(np.float32)
        files[f"pfm_line_{k}.pfm"] = pfm_bytes(line, -1.0)
        line = _line(rng)
        files[f"hdr_line_{k}.hdr"] = cv2.imencode(".hdr", (line[:, :, ::-1] / 255.0).astype(
            np.float32))[1].tobytes()
    return files


def main() -> None:
    import sys

    import cv2

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # for tests.torch_port_data
    out = os.path.join(HERE, "raster")
    os.makedirs(out, exist_ok=True)
    expected = {}
    for name, data in fixtures(np.random.default_rng(20261018)).items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert bgr is not None, name
        expected[name] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    np.savez_compressed(os.path.join(out, "expected.npz"), **expected)
    total = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"wrote {len(expected)} files and expected.npz into {out}: {total} bytes")


if __name__ == "__main__":
    main()
