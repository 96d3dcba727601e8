"""Write the JPEG fixtures the port's decoder is held to on the card.

    python tests/torch_port_data/make_jpeg_fixtures.py

Needs cv2 and PIL (the card's script reads only the files).  Writes into
``tests/torch_port_data/jpeg/``:

* small JPEGs, one per decoder path: 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1
  subsampling, gray, restart intervals (colour and gray), EXIF orientations
  3, 6 and 8, qualities 50 / 75 / 90 / 100, odd and even sizes, PIL's
  optimized Huffman tables, an Adobe-marked RGB JPEG, one progressive
  JPEG (which the port refuses), a frame with no DHT segment (as Motion-JPEG
  cameras send: the decoder takes the standard tables), and a damaged one
  (a run of one-bits that is no Huffman code, and a restart marker out of
  sequence) that cv2 decodes with warnings;
* ``line_NN.jpg``: 64 seeded 4:2:0 text-line images (24-40 high, 2-6 times
  as wide: light ground, dark strokes, noise of +-3) at quality 90;
* ``expected.npz``: cv2's RGB pixels (``cv2.imdecode(IMREAD_COLOR)`` then
  BGR -> RGB) of every decodable file, keyed by file name.

Everything is seeded, so a rerun writes the same bytes with the same cv2
and PIL.
"""

from __future__ import annotations

import io
import os
import struct

import cv2
import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg")
N_LINES = 64
SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}


def smooth(rng, h: int, w: int, channels: int = 3) -> np.ndarray:
    img = rng.integers(0, 256, (h, w, channels)).astype(np.uint8)
    img = cv2.GaussianBlur(img, (5, 5), 0)
    return img if channels > 1 else img.reshape(h, w)


def line_image(rng) -> np.ndarray:
    h = int(rng.integers(24, 41))
    w = int(h * rng.uniform(2.0, 6.0))
    img = np.full((h, w, 3), int(rng.integers(200, 256)), np.uint8)
    for _ in range(int(rng.integers(3, 10))):  # dark strokes
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0 : y0 + int(rng.integers(2, h // 2 + 3)),
            x0 : x0 + int(rng.integers(1, 6))] = rng.integers(0, 90, 3)
    noise = rng.integers(-3, 4, img.shape)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def cv2_jpeg(rgb: np.ndarray, quality: int = 90, sampling: str = "420", **flags) -> bytes:
    bgr = rgb if rgb.ndim == 2 else cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if rgb.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    for key, val in flags.items():
        params += [getattr(cv2, key), val]
    ok, buf = cv2.imencode(".jpg", bgr, params)
    assert ok
    return buf.tobytes()


def pil_jpeg(rgb: np.ndarray, **kw) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(rgb).save(bio, format="JPEG", **kw)
    return bio.getvalue()


def with_exif(data: bytes, orientation: int) -> bytes:
    """``data`` with an APP1 EXIF segment carrying ``orientation`` after SOI."""
    ifd = struct.pack("<H", 1) + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
    body = b"Exif\x00\x00" + b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0)
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


def segments(data: bytes):
    """(marker, start, end) of each header segment up to and including SOS."""
    i, out = 2, []
    while True:
        m, n = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        out.append((m, i, i + 2 + n))
        if m == 0xDA:
            return out
        i += 2 + n


def without_dht(data: bytes) -> bytes:
    out, last = data[:2], 2
    for m, start, end in segments(data):
        if m == 0xC4:
            out, last = out + data[last:start], end
    return out + data[last:]


def damaged(data: bytes) -> bytes:
    """24 one-bits (no Huffman code is that long) a third of the way into
    the entropy data, and the last restart marker renumbered."""
    sos_end = segments(data)[-1][2]
    cut = sos_end + (len(data) - sos_end) // 3
    while data[cut - 1] == 0xFF or data[cut] == 0xFF:
        cut += 1
    out = bytearray(data[:cut] + b"\xff\x00" * 3 + data[cut:])
    rst = [i for i in range(sos_end, len(out) - 1)
           if out[i] == 0xFF and 0xD0 <= out[i + 1] <= 0xD7]
    out[rst[-1] + 1] = 0xD0 + (out[rst[-1] + 1] - 0xD0 + 4) % 8
    return bytes(out)


def fixtures() -> dict:
    rng = np.random.default_rng(20261017)
    files = {
        "s444_q90_17x33.jpg": cv2_jpeg(smooth(rng, 17, 33), 90, "444"),
        "s422_q90_16x40.jpg": cv2_jpeg(smooth(rng, 16, 40), 90, "422"),
        "s420_q50_31x57.jpg": cv2_jpeg(smooth(rng, 31, 57), 50, "420"),
        "s440_q90_21x19.jpg": cv2_jpeg(smooth(rng, 21, 19), 90, "440"),
        "s411_q90_24x45.jpg": cv2_jpeg(smooth(rng, 24, 45), 90, "411"),
        "s420_q100_33x65.jpg": cv2_jpeg(smooth(rng, 33, 65), 100, "420"),
        "gray_q90_13x29.jpg": cv2_jpeg(smooth(rng, 13, 29, 1), 90),
        "s420_rst2_q90_40x72.jpg": cv2_jpeg(smooth(rng, 40, 72), 90, "420",
                                            IMWRITE_JPEG_RST_INTERVAL=2),
        "gray_rst1_q75_19x41.jpg": cv2_jpeg(smooth(rng, 19, 41, 1), 75,
                                            IMWRITE_JPEG_RST_INTERVAL=1),
        "pil_s420_optimized_q75_27x61.jpg": pil_jpeg(smooth(rng, 27, 61), quality=75,
                                                    subsampling=2, optimize=True),
        "pil_adobe_rgb_q90_18x22.jpg": pil_jpeg(smooth(rng, 18, 22), quality=90, keep_rgb=True),
        "progressive_17x33.jpg": cv2_jpeg(smooth(rng, 17, 33), 90, "420",
                                          IMWRITE_JPEG_PROGRESSIVE=1),
    }
    base = smooth(rng, 20, 50)
    for o in (3, 6, 8):
        files[f"exif{o}_q90_20x50.jpg"] = with_exif(cv2_jpeg(base, 90, "420"), o)
    for i in range(N_LINES):
        files[f"line_{i:02d}.jpg"] = cv2_jpeg(line_image(rng), 90, "420")
    rng = np.random.default_rng(20261018)  # apart, so the files above keep their bytes
    files["nodht_s422_q85_23x37.jpg"] = without_dht(cv2_jpeg(smooth(rng, 23, 37), 85, "422"))
    files["damaged_s420_rst1_q90_29x47.jpg"] = damaged(
        cv2_jpeg(smooth(rng, 29, 47), 90, "420", IMWRITE_JPEG_RST_INTERVAL=1))
    return files


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    expected = {}
    for name, data in fixtures().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if not name.startswith("progressive"):
            assert bgr is not None, name
            expected[name] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    np.savez_compressed(os.path.join(OUT, "expected.npz"), **expected)
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {len(expected) + 1} JPEGs and expected.npz into {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
