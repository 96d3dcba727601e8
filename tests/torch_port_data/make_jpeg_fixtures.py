"""Write the JPEG fixtures the port's decoder is held to on the card.

    python tests/torch_port_data/make_jpeg_fixtures.py

Needs cv2 and PIL, and ``gcc`` with libjpeg's headers and library
(``jpeglib.h``, ``-ljpeg``) to build ``jpeg_writer.c``, which writes the
variants neither cv2 nor PIL writes (the card's script reads only the
files).  Writes into ``tests/torch_port_data/jpeg/``:

* small JPEGs, one per decoder path: 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1
  subsampling, gray, restart intervals (colour and gray), EXIF orientations
  3, 6 and 8, qualities 50 / 75 / 90 / 100, odd and even sizes, PIL's
  optimized Huffman tables, an Adobe-marked RGB JPEG, a frame with no DHT
  segment (as Motion-JPEG cameras send: the decoder takes the standard
  tables), and a damaged one (a run of one-bits that is no Huffman code,
  and a restart marker out of sequence) that cv2 decodes with warnings;
* progressive JPEGs from cv2 and PIL at each subsampling, and from
  ``jpeg_writer``: custom scan scripts (non-interleaved DC, successive
  approximation down to Al 2, restart intervals) and streams cut short
  after a scan, or inside one, and closed by EOI (libjpeg smooths their
  blocks);
* arithmetic-coded JPEGs from ``jpeg_writer``: sequential and progressive,
  with restarts and with DAC conditioning other than the default;
* CMYK (PIL's Adobe-inverted, and ``jpeg_writer``'s with no Adobe marker)
  and YCCK (4:4:4, and Y and K subsampled 2x2);
* ``prog_line_N.jpg``, ``arith_line_N.jpg``, ``cmyk_line_N.jpg``: text
  lines as ``line_NN.jpg`` draws them, for the card's daemon phase;
* ``line_NN.jpg``: 64 seeded 4:2:0 text-line images (24-40 high, 2-6 times
  as wide: light ground, dark strokes, noise of +-3) at quality 90;
* lossless JPEGs (SOF3) from :func:`lossless_jpeg`, a hand-written T.81
  Annex H encoder (no container library writes SOF3): RGB under each of
  predictors 1-7, a point transform, restart intervals, one scan a
  component, subsampled components, an Adobe marker, 'R','G','B' ids,
  CMYK, precisions under 8, and ``lossless_line_N.jpg`` text lines;
* the files of :data:`CV2_NONE`, on which ``cv2.imdecode`` gives ``None``
  (lossless gray and YCbCr, SOF11, hierarchical, 12-bit and DNL frames),
  with no pixels;
* ``expected.npz``: cv2's RGB pixels (``cv2.imdecode(IMREAD_COLOR)`` then
  BGR -> RGB) of every decodable file, keyed by file name.

Everything is seeded, so a rerun writes the same bytes with the same cv2
and PIL.
"""

from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
import tempfile

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


class CWriter:
    """``jpeg_writer.c`` built with gcc against the system libjpeg."""

    SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_writer.c")

    def __init__(self):
        self.dir = tempfile.mkdtemp()
        self.exe = os.path.join(self.dir, "jpeg_writer")
        subprocess.run(["gcc", "-O2", "-o", self.exe, self.SOURCE, "-ljpeg"], check=True)

    def __call__(self, pix: np.ndarray, *opts) -> bytes:
        h, w = pix.shape[:2]
        nc = 1 if pix.ndim == 2 else pix.shape[2]
        src, dst = os.path.join(self.dir, "in.raw"), os.path.join(self.dir, "out.jpg")
        with open(src, "wb") as f:
            f.write(np.ascontiguousarray(pix, np.uint8).tobytes())
        subprocess.run([self.exe, src, dst, str(w), str(h), str(nc), *map(str, opts)], check=True)
        with open(dst, "rb") as f:
            return f.read()

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


# --- lossless (SOF3) -------------------------------------------------------------------

JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
# code lengths of categories 0-16 (short ones for small differences)
LOSSLESS_CODES = [3, 2, 2, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def adobe(transform: int) -> bytes:
    """An APP14 Adobe segment with the colour ``transform``."""
    return b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])


def lossless_jpeg(img: np.ndarray, predictor: int = 1, pt: int = 0, restart: int = 0,
                  precision: int = 8, ids=None, sampling=None, markers: bytes = b"",
                  separate: bool = False, sof: int = 0xC3, flat: bool = False) -> bytes:
    """A lossless JPEG of ``img`` (``[H, W]`` or ``[H, W, C]``, values below
    ``2**precision``) as T.81 Annex H codes it: each component's samples
    shifted right by the point transform ``pt``, differences from
    ``predictor`` (1-7; the first row of the scan and of each restart
    interval from ``2**(precision - pt - 1)`` and the left neighbour, every
    other row's first sample from the one above) coded by one Huffman table
    (:data:`LOSSLESS_CODES`: 2 to 15 bits for categories 0-16, or 5 bits
    each with ``flat``).  ``sampling`` is each component's
    ``(h, v)``, ``separate`` writes a scan a component, ``restart`` the DRI
    interval in MCUs, ``markers`` go after SOI."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, nc = img.shape
    ids = list(ids or range(1, nc + 1))
    sampling = list(sampling or [(1, 1)] * nc)
    hmax, vmax = max(f[0] for f in sampling), max(f[1] for f in sampling)
    planes = [img[:: vmax // vs, :: hmax // hs, c][: -(-h * vs // vmax), : -(-w * hs // hmax)]
              .astype(np.int64) >> pt for c, (hs, vs) in enumerate(sampling)]
    lengths = [5] * 17 if flat else LOSSLESS_CODES
    order = sorted(range(17), key=lambda c: (lengths[c], c))
    codes, code = {}, 0
    for i, cat in enumerate(order):  # canonical codes, shortest first
        if i:
            code = (code + 1) << (lengths[cat] - lengths[order[i - 1]])
        codes[cat] = format(code, f"0{lengths[cat]}b")
    out = bytearray(b"\xff\xd8" + markers)
    out += struct.pack(">BBHBHHB", 0xFF, sof, 8 + 3 * nc, precision, h, w, nc)
    for c in range(nc):
        out += bytes([ids[c], sampling[c][0] << 4 | sampling[c][1], 0])
    out += struct.pack(">BBHB", 0xFF, 0xC4, 36, 0)
    out += bytes(sum(lengths[c] == n for c in range(17)) for n in range(1, 17)) + bytes(order)
    if restart:
        out += struct.pack(">BBHH", 0xFF, 0xDD, 4, restart)
    for comps in ([[c] for c in range(nc)] if separate else [list(range(nc))]):
        out += struct.pack(">BBHB", 0xFF, 0xDA, 6 + 2 * len(comps), len(comps))
        for c in comps:
            out += bytes([ids[c], 0])
        out += bytes([predictor, 0, pt])
        units = {c: (1, 1) if len(comps) == 1 else sampling[c] for c in comps}
        diffs = {c: _differences(planes[c], predictor, pt, precision, units[c][1],
                                 restart // (planes[c].shape[1] if len(comps) == 1
                                             else -(-w // hmax)) if restart else 0)
                 for c in comps}
        mcux = planes[comps[0]].shape[1] if len(comps) == 1 else -(-w // hmax)
        mcuy = planes[comps[0]].shape[0] if len(comps) == 1 else -(-h // vmax)
        bits, n = [], 0
        for my in range(mcuy):
            for mx in range(mcux):
                if restart and n and n % restart == 0:
                    out += _packed(bits) + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                    bits = []
                n += 1
                for c in comps:
                    hs, vs = units[c]
                    d = diffs[c]
                    for y in range(my * vs, my * vs + vs):
                        for x in range(mx * hs, mx * hs + hs):
                            v = int(d[y, x]) if y < d.shape[0] and x < d.shape[1] else 0
                            cat = 16 if v == -32768 else abs(v).bit_length()
                            bits.append(codes[cat])
                            if 0 < cat < 16:
                                bits.append(format(v if v > 0 else v - 1 + (1 << cat),
                                                   f"0{cat}b")[-cat:])
        out += _packed(bits)
    return bytes(out + b"\xff\xd9")


def _differences(p: np.ndarray, psv: int, pt: int, precision: int, rows_per_mcu: int,
                 restart_rows: int) -> np.ndarray:
    """Each sample's difference from its prediction, as a signed 16-bit value."""
    d = np.zeros_like(p)
    for y in range(p.shape[0]):
        first = y == 0 or (restart_rows and y % rows_per_mcu == 0
                           and (y // rows_per_mcu) % restart_rows == 0)
        for x in range(p.shape[1]):
            ra = int(p[y, x - 1]) if x else 0
            rb = int(p[y - 1, x]) if y else 0
            rc = int(p[y - 1, x - 1]) if x and y else 0
            if first:
                pred = (1 << (precision - pt - 1)) if x == 0 else ra
            elif x == 0:
                pred = rb
            else:
                pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                        (ra + rb) >> 1)[psv - 1]
            v = (int(p[y, x]) - pred) & 0xFFFF
            d[y, x] = v - 0x10000 if v >= 0x8000 else v
    return d


def _packed(bits: list) -> bytes:
    """Bit strings -> bytes, the last padded with ones, 0xFF stuffed."""
    s = "".join(bits)
    s += "1" * (-len(s) % 8)
    out = bytearray()
    for i in range(0, len(s), 8):
        out.append(int(s[i : i + 8], 2))
        if out[-1] == 0xFF:
            out.append(0)
    return bytes(out)


def lossless_fixtures(rng) -> dict:
    """Small lossless JPEGs (the fixtures' directory keeps under 512 KiB)."""
    files = {}
    for p in range(1, 8):
        h, w = (int(v) for v in rng.integers(5, 12, 2))
        files[f"lossless_p{p}_{h}x{w}.jpg"] = lossless_jpeg(smooth(rng, h, w), predictor=p)
    files["lossless_p4_pt2_flat_9x11.jpg"] = lossless_jpeg(smooth(rng, 9, 11), 4, pt=2, flat=True)
    files["lossless_p7_rst2rows_10x7.jpg"] = lossless_jpeg(smooth(rng, 10, 7), 7, restart=14)
    files["lossless_p6_separate_rst_8x9.jpg"] = lossless_jpeg(
        smooth(rng, 8, 9), 6, restart=9, separate=True)
    files["lossless_p1_sub221111_9x11.jpg"] = lossless_jpeg(
        smooth(rng, 9, 11), 1, sampling=[(2, 2), (1, 1), (1, 1)])
    files["lossless_p5_sub112112_9x11.jpg"] = lossless_jpeg(
        smooth(rng, 9, 11), 5, sampling=[(1, 1), (2, 1), (1, 2)], restart=6)
    files["lossless_adobe0_p2_7x9.jpg"] = lossless_jpeg(smooth(rng, 7, 9), 2, markers=adobe(0))
    files["lossless_rgb_ids_p3_7x8.jpg"] = lossless_jpeg(smooth(rng, 7, 8), 3, ids=(82, 71, 66))
    files["lossless_cmyk_p1_6x9.jpg"] = lossless_jpeg(smooth(rng, 6, 9, 4), 1)
    files["lossless_prec5_p4_8x10.jpg"] = lossless_jpeg(smooth(rng, 8, 10) >> 3, 4, precision=5)
    # a text line for the card's daemon phase
    files["lossless_line_0.jpg"] = lossless_jpeg(line_image(rng)[:22, :64], 4)
    gray, rgb = smooth(rng, 4, 5, 1), smooth(rng, 4, 5)
    base = cv2_jpeg(rgb, 90, "444")
    sof = base.find(b"\xff\xc0")
    files.update({
        "none_lossless_gray.jpg": lossless_jpeg(gray, 1),
        "none_lossless_ycbcr_jfif.jpg": lossless_jpeg(rgb, 1, markers=JFIF),
        "none_lossless_12bit.jpg": lossless_jpeg(rgb.astype(np.int64) << 4, 1, precision=12),
        "none_lossless_arith_sof11.jpg": lossless_jpeg(rgb, 1, sof=0xCB),
        "none_lossless_restart_not_a_row.jpg": lossless_jpeg(rgb, 1, restart=3),
        "none_hierarchical_sof5.jpg": base[: sof + 1] + b"\xc5" + base[sof + 2 :],
        "none_12bit_sof1.jpg": base[: sof + 1] + b"\xc1\x00\x11\x0c" + base[sof + 5 :],
        "none_dnl_height.jpg": base[: sof + 5] + b"\x00\x00" + base[sof + 7 :],
    })
    return files


# the files cv2.imdecode gives None on, and the words the port's ValueError
# names each by; the tests and the card's smoke read them, expected.npz has
# no pixels for them
CV2_NONE = {"none_lossless_gray.jpg": "lossless gray",
            "none_lossless_ycbcr_jfif.jpg": "lossless YCbCr",
            "none_lossless_12bit.jpg": "12-bit lossless",
            "none_lossless_arith_sof11.jpg": "SOF11",
            "none_lossless_restart_not_a_row.jpg": "restart interval",
            "none_hierarchical_sof5.jpg": "hierarchical",
            "none_12bit_sof1.jpg": "12-bit",
            "none_dnl_height.jpg": "DNL"}


def sos_offsets(data: bytes) -> list:
    """Where each SOS marker starts (entropy data holds no 0xFF 0xDA)."""
    return [i for i in range(2, len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]


def cut_after(data: bytes, scans: int) -> bytes:
    """The stream's first ``scans`` scans, closed by EOI."""
    return data[: sos_offsets(data)[scans]] + b"\xff\xd9"


# non-interleaved DC with successive approximation (Al 1), AC bands split at
# 5 and refined down from Al 2; then interleaved DC at Al 2 refined twice
SCRIPTS = {
    "ni_dc": ("0:0:0:0:1;1:0:0:0:1;2:0:0:0:1;0:1:5:0:2;2:1:63:0:1;1:1:63:0:1;0:6:63:0:2;"
              "0:1:63:2:1;0:0:0:1:0;1:0:0:1:0;2:0:0:1:0;2:1:63:1:0;1:1:63:1:0;0:1:63:1:0"),
    "al2": "0.1.2:0:0:0:2;0:1:9:0:0;0.1.2:0:0:2:1;0.1.2:0:0:1:0;0:10:63:0:0;1:1:63:0:0;2:1:63:0:0",
}


def variant_fixtures(rng, writer: CWriter) -> dict:
    """The progressive, arithmetic, CMYK and YCCK fixtures."""
    files = {}
    for sampling in ("444", "422"):
        files[f"progressive_s{sampling}_q85_23x41.jpg"] = cv2_jpeg(
            smooth(rng, 23, 41), 85, sampling, IMWRITE_JPEG_PROGRESSIVE=1)
    for sub in (0, 1, 2):
        files[f"pil_progressive_sub{sub}_q80_21x35.jpg"] = pil_jpeg(
            smooth(rng, 21, 35), quality=80, subsampling=sub, progressive=True)
    files["progressive_gray_q75_19x27.jpg"] = writer(smooth(rng, 19, 27, 1), "-p", "-q", 75)
    files["progressive_ni_dc_rst2_s420_26x38.jpg"] = writer(
        smooth(rng, 26, 38), "-p", "-s", SCRIPTS["ni_dc"], "-f", "2,2,1,1,1,1", "-r", 2)
    files["progressive_al2_rst1_s422_17x30.jpg"] = writer(
        smooth(rng, 17, 30), "-p", "-s", SCRIPTS["al2"], "-f", "2,1,1,1,1,1", "-r", 1)
    prog = writer(smooth(rng, 29, 43), "-p", "-f", "2,2,1,1,1,1", "-q", 85)
    for k in (1, 3, 6):
        files[f"cut_after_{k}_progressive_s420_29x43.jpg"] = cut_after(prog, k)
    ss = sos_offsets(prog)
    files["cut_inside_5_progressive_s420_29x43.jpg"] = prog[: (ss[4] + ss[5]) // 2] + b"\xff\xd9"
    files["arith_s444_q90_18x25.jpg"] = writer(smooth(rng, 18, 25), "-a", "-f", "1,1,1,1,1,1")
    files["arith_s420_rst1_q80_27x33.jpg"] = writer(smooth(rng, 27, 33), "-a", "-r", 1, "-q", 80)
    files["arith_dac_s422_q90_20x31.jpg"] = writer(smooth(rng, 20, 31), "-a", "-f", "2,1,1,1,1,1",
                                                   "-d", "2,6,12")
    files["arith_progressive_s420_q85_25x37.jpg"] = writer(smooth(rng, 25, 37), "-a", "-p")
    files["arith_progressive_ni_dc_rst3_22x29.jpg"] = writer(
        smooth(rng, 22, 29), "-a", "-p", "-s", SCRIPTS["ni_dc"], "-r", 3)
    aprog = writer(smooth(rng, 24, 33), "-a", "-p")
    files["cut_after_4_arith_progressive_24x33.jpg"] = cut_after(aprog, 4)
    bio = io.BytesIO()
    cmyk = smooth(rng, 19, 28, 4)
    Image.frombytes("CMYK", (28, 19), cmyk.tobytes()).save(bio, format="JPEG", quality=85)
    files["pil_cmyk_q85_19x28.jpg"] = bio.getvalue()
    files["cmyk_no_adobe_q90_17x23.jpg"] = writer(smooth(rng, 17, 23, 4), "-c", "cmyk", "-n")
    files["ycck_s444_q90_18x26.jpg"] = writer(smooth(rng, 18, 26, 4), "-c", "ycck",
                                              "-f", "1,1,1,1,1,1,1,1")
    files["ycck_s2222_q85_21x33.jpg"] = writer(smooth(rng, 21, 33, 4), "-c", "ycck",
                                               "-f", "2,2,1,1,1,1,2,2", "-q", 85)
    for k in range(2):  # text lines for the card's daemon phase
        line = line_image(rng)
        files[f"prog_line_{k}.jpg"] = cv2_jpeg(line, 90, "420", IMWRITE_JPEG_PROGRESSIVE=1)
        files[f"arith_line_{k}.jpg"] = writer(line, "-a", "-q", 90)
        cmyk = np.concatenate([255 - line, np.full(line.shape[:2] + (1,), 255, np.uint8)], 2)
        files[f"cmyk_line_{k}.jpg"] = writer(cmyk, "-c", "ycck", "-q", 90)
    return files


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
    writer = CWriter()
    try:  # apart again, so the files above keep their bytes
        files.update(variant_fixtures(np.random.default_rng(20261019), writer))
    finally:
        writer.close()
    files.update(lossless_fixtures(np.random.default_rng(20261020)))
    return files


def main() -> None:
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
    print(f"wrote {len(expected)} JPEGs and expected.npz into {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
