"""Write the PNG fixtures the port's decoder is held to on the card.

    python tests/torch_port_data/make_png_fixtures.py

Needs cv2 (the card's script reads only the files).  Writes into
``tests/torch_port_data/png/``, every file by :func:`png_bytes` and
:func:`chunk` below (no encoder library):

* ``exif{o}_{mm|ii}_{pre|post}_7x11.png``: an ``eXIf`` chunk of each
  orientation 1-8 in each byte order, before or after the image data;
* files whose chunks break a rule that libpng under OpenCV forgives or
  reads past: CRCs of ancillary chunks and of ``IEND``, two ``eXIf``
  chunks, a malformed IFD, ``PLTE`` out of place, split and empty
  ``IDAT`` chunks, zlib data past the image, a bad Adler-32 that libpng
  reads only after the last row, a palette index past the palette;
* ``none_*.png``: files cv2 gives ``None`` on, and the words the port's
  ``ValueError`` names each by (:data:`CV2_NONE`);
* ``pngo_line_0.png``: a text line stored on its side with orientation 6,
  for the card's daemon phase;
* ``expected.npz``: cv2's RGB pixels (``cv2.imdecode(IMREAD_COLOR)`` then
  BGR -> RGB) of every file cv2 decodes, keyed by file name.

Everything is seeded, so a rerun writes the same bytes.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "png")
SIGNATURE = b"\x89PNG\r\n\x1a\n"


def chunk(kind: bytes, body: bytes, crc=None) -> bytes:
    """A chunk, its CRC computed unless ``crc`` gives it."""
    c = zlib.crc32(kind + body) if crc is None else crc
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", c & 0xFFFFFFFF)


def exif_tiff(orientation: int, order: str = "MM", prefix: bytes = b"") -> bytes:
    """An EXIF block as a bare TIFF header and one IFD of one SHORT
    Orientation entry (``prefix`` before it, e.g. ``Exif\\0\\0``)."""
    e = ">" if order == "MM" else "<"
    head = b"MM\x00*" if order == "MM" else b"II*\x00"
    return (prefix + head + struct.pack(e + "I", 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))


def scanlines(img: np.ndarray) -> bytes:
    """``[h, w, c]`` uint8 samples -> filter-None scanlines."""
    h = img.shape[0]
    return np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1).tobytes()


def png_bytes(img: np.ndarray, ctype: int = 2, depth: int = 8, pre=(), post=(), idat=None,
              iend: bool = True, raw: bytes = None) -> bytes:
    """A PNG of ``img`` (8-bit samples, or ``raw`` scanlines) with the
    chunks ``pre`` before and ``post`` after the image data; ``idat`` is
    the list of IDAT payloads (default: one, zlib of the scanlines)."""
    h, w = img.shape[:2]
    if idat is None:
        idat = [zlib.compress(scanlines(img) if raw is None else raw)]
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    out += b"".join(pre) + b"".join(chunk(b"IDAT", z) for z in idat) + b"".join(post)
    return out + (chunk(b"IEND", b"") if iend else b"")


def _image(rng, h: int, w: int) -> np.ndarray:
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


def unturned(img: np.ndarray, o: int) -> np.ndarray:
    """The image to store so that orientation ``o`` shows ``img``."""
    if o in (3, 4, 7, 8):
        img = img[::-1]
    if o in (2, 3, 6, 7):
        img = img[:, ::-1]
    if o >= 5:
        img = img.transpose(1, 0, 2)
    return np.ascontiguousarray(img)


def fixtures() -> dict:
    from tests.torch_port_data.make_bmp_fixtures import _line

    rng = np.random.default_rng(20261019)
    img = _image(rng, 7, 11)
    files = {}
    for o in range(1, 9):
        for order in ("MM", "II"):
            x = chunk(b"eXIf", exif_tiff(o, order))
            files[f"exif{o}_{order.lower()}_pre_7x11.png"] = png_bytes(img, pre=[x])
            files[f"exif{o}_{order.lower()}_post_7x11.png"] = png_bytes(img, post=[x])
    ex6, ex3 = chunk(b"eXIf", exif_tiff(6)), chunk(b"eXIf", exif_tiff(3, "II"))
    text = chunk(b"tEXt", b"Comment\x00line")
    z = zlib.compress(scanlines(img))
    files.update({
        "crc_text_7x11.png": png_bytes(img, pre=[chunk(b"tEXt", b"a\x00b", crc=1)]),
        "crc_iend_7x11.png": png_bytes(img, iend=False) + chunk(b"IEND", b"", crc=7),
        "crc_exif6_then_exif3_7x11.png": png_bytes(
            img, pre=[chunk(b"eXIf", exif_tiff(6), crc=2)], post=[ex3]),
        "exif6_then_exif3_7x11.png": png_bytes(img, pre=[ex6], post=[ex3]),
        "exif6_prefixed_7x11.png": png_bytes(
            img, pre=[chunk(b"eXIf", exif_tiff(6, prefix=b"Exif\x00\x00"))]),
        "exif6_cut_entry_7x11.png": png_bytes(img, pre=[chunk(b"eXIf", exif_tiff(6)[:19])]),
        "exif6_long_ii_7x11.png": png_bytes(img, pre=[chunk(b"eXIf", b"II*\x00" + struct.pack(
            "<IHHHII", 8, 1, 0x0112, 4, 1, 6) + bytes(4))]),
        "plte_after_idat_rgb_7x11.png": png_bytes(img, post=[chunk(b"PLTE", bytes(range(9)))]),
        "plte_crc_rgb_7x11.png": png_bytes(img, pre=[chunk(b"PLTE", bytes(9), crc=3)]),
        "idat_split_7x11.png": png_bytes(img, idat=[z[:7], b"", z[7:20], z[20:]]),
        "idat_extra_after_text_7x11.png": png_bytes(img, post=[text, chunk(b"IDAT", b"xy")]),
        "zlib_past_image_7x11.png": png_bytes(img, idat=[zlib.compress(scanlines(img) + bytes(9))]),
        "zlib_trailing_bytes_7x11.png": png_bytes(img, idat=[z + b"junk"]),
        "after_iend_7x11.png": png_bytes(img) + b"trailing bytes",
    })
    # a bad Adler-32 that libpng reads only after the last row (it lies in
    # the next 8,192-byte read): a warning
    big = rng.integers(0, 256, (1, 8184, 1)).astype(np.uint8)  # 8185 scanline bytes, stored
    stored = zlib.compress(scanlines(big), 0)
    files["adler_after_rows_8184x1.png"] = png_bytes(big, ctype=0,
                                                     idat=[stored[:-4] + bytes(4)])
    pal = rng.integers(0, 256, (5, 3)).astype(np.uint8)
    idx = rng.integers(0, 8, (7, 11, 1)).astype(np.uint8)  # 5-7 lie past the palette: black
    files["palette_index_past_plte_7x11.png"] = png_bytes(idx, ctype=3,
                                                          pre=[chunk(b"PLTE", pal.tobytes())])
    files.update(_cv2_none(img, z, idx, pal))
    line = _line(rng)
    files["pngo_line_0.png"] = png_bytes(unturned(line, 6), pre=[ex6])
    return files


def _cv2_none(img, z: bytes, idx, pal) -> dict:
    h, w = img.shape[:2]
    stored = zlib.compress(scanlines(img), 0)
    return {
        "none_no_iend_7x11.png": png_bytes(img, iend=False),
        "none_crc_idat_7x11.png": png_bytes(img, iend=False)[:-4] + b"\x00\x00\x00\x00"
                                  + chunk(b"IEND", b""),
        "none_crc_ihdr_7x11.png": SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, 8, 2, 0, 0, 0), crc=5) + chunk(b"IDAT", z) + chunk(b"IEND", b""),
        "none_plte_after_idat_7x11.png": png_bytes(idx, ctype=3,
                                                   post=[chunk(b"PLTE", pal.tobytes())]),
        "none_idat_broken_7x11.png": png_bytes(img, idat=[z[:10]],
                                               post=[chunk(b"tEXt", b"a\x00b"),
                                                     chunk(b"IDAT", z[10:])]),
        "none_second_ihdr_7x11.png": png_bytes(img, post=[chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, 8, 2, 0, 0, 0))]),
        "none_unknown_critical_7x11.png": png_bytes(img, pre=[chunk(b"ABCD", b"xy")]),
        "none_zlib_short_7x11.png": png_bytes(img, idat=[zlib.compress(scanlines(img)[:-5])]),
        "none_adler_in_rows_7x11.png": png_bytes(img, idat=[stored[:-4] + bytes(4)]),
        "none_reserved_bit_7x11.png": png_bytes(img, pre=[chunk(b"abcd", b"xy")]),
        "none_actl_no_frames_7x11.png": png_bytes(img, pre=[chunk(b"acTL", bytes(8))]),
    }


# the files cv2 gives None on, and the words the port's ValueError names
# each by; the tests and the card's smoke read them, expected.npz has no
# pixels for them
CV2_NONE = {"none_no_iend_7x11.png": "truncated",
            "none_crc_idat_7x11.png": "b'IDAT' fails its CRC",
            "none_crc_ihdr_7x11.png": "b'IHDR' fails its CRC",
            "none_plte_after_idat_7x11.png": "without a PLTE before its IDAT",
            "none_idat_broken_7x11.png": "before its zlib stream ends",
            "none_second_ihdr_7x11.png": "b'IHDR' after the image data",
            "none_unknown_critical_7x11.png": "critical chunk b'ABCD' is unknown",
            "none_zlib_short_7x11.png": "ends before the image is whole",
            "none_adler_in_rows_7x11.png": "incorrect data check",
            "none_reserved_bit_7x11.png": "reserved bit",
            "none_actl_no_frames_7x11.png": "acTL"}


def main() -> None:
    import sys

    import cv2

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # for tests.torch_port_data
    os.makedirs(OUT, exist_ok=True)
    expected = {}
    for name, data in fixtures().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if name in CV2_NONE:
            assert bgr is None, name
            continue
        assert bgr is not None, name
        expected[name] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    np.savez_compressed(os.path.join(OUT, "expected.npz"), **expected)
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {len(expected) + len(CV2_NONE)} PNGs and expected.npz into {OUT}: "
          f"{total} bytes")


if __name__ == "__main__":
    main()
