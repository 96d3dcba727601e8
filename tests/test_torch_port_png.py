"""The port's PNG decoder (``data/png.py``) and EXIF reader
(``data/exif.py``) vs the JAX package's ``imdecode_cv2`` / ``imread_cv2``
and ``image_size``, on the CPU.

* Every fixture of ``tests/torch_port_data/png/`` bit-equal to
  ``imdecode_cv2`` and to the pixels the card's smoke reads
  (``expected.npz``); the ``none_*`` files raise ``ValueError`` naming
  their cause where cv2 gives ``None``.
* The orientation grid: an ``eXIf`` chunk of orientation 0-9 in both byte
  orders, before and after the image data, turns the image as cv2 turns
  it.
* The chunk rules, one named case each (CRCs of critical and ancillary
  chunks, ``IHDR``, ``PLTE``, ``IDAT`` runs and ``IEND``, unknown and
  reserved chunk types, OpenCV's own APNG checks, the zlib stream's end),
  and a seeded fuzz that flips, cuts, drops and splices bytes of valid
  PNGs (plain and Adam7, every colour type and depth, filters 0-4, split
  ``IDAT`` runs, ``eXIf`` chunks), and flips bytes with the chunk's CRC
  mended: on every case the port gives cv2's pixels or raises
  ``ValueError`` where cv2 gives ``None``.
* A seeded fuzz of EXIF blocks (the IFD's tags, types, counts and offsets,
  cut short, either byte order or none) through PNG's ``eXIf`` and JPEG's
  APP1: :func:`exif.orientation` is the orientation cv2 applies.
* ``image_size`` equal to JAX's on every PNG fixture (IHDR's sides,
  unturned, as JAX's header probe reads them) and on the WebP ones.
* The four faults of the port against cv2, repaired: an ``eXIf``
  orientation ignored, a WebP ``EXIF`` orientation ignored, an ancillary
  chunk's bad CRC failing the file, a file without ``IEND`` decoding.
* APNG as OpenCV 5's APNG path reads it: every fixture of
  ``tests/torch_port_data/apng/`` (the first ``fcTL`` frame where the
  ``IDAT`` image is hidden, a fault the port had), named cases of its chunk
  rules and a seeded ``fdAT`` damage fuzz, with cv2 run in child processes
  (its process dies on some damaged frames); the 16-bit conversion on all
  65,536 values; where cv2 returns memory no decoder wrote, ``ValueError``.
  Also repaired: ``fcTL`` ops past their range, and a palette image's
  second ``PLTE`` after its image data.
"""

import functools
import io
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from rcnn_ocr_tpu.data import transforms as jax_tf  # noqa: E402
from rcnn_ocr_tpu_torch.data import exif, image_io  # noqa: E402
from tests.test_torch_port_data import png_bytes as filtered_png  # noqa: E402
from tests.torch_port_data.make_png_fixtures import (  # noqa: E402
    CV2_NONE, SIGNATURE, chunk, exif_tiff, png_bytes, scanlines)

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "png"
NAMES = sorted(p.name for p in FIXTURES.glob("*.png"))


@pytest.fixture(scope="module")
def expected():
    with np.load(FIXTURES / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def _cv2(data):
    try:
        return jax_tf.imdecode_cv2(data)
    except ValueError:
        return None


def _assert_as_cv2(data, info=""):
    """Bit-equal to cv2 where it decodes, ValueError (not a refusal) where
    it gives None.  Returns whether cv2 decoded."""
    want = _cv2(data)
    if want is None:
        with pytest.raises(ValueError) as err:
            image_io.imdecode(data)
        assert not isinstance(err.value, image_io.UnsupportedImageFormat), info
        return False
    got = image_io.imdecode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, info
    np.testing.assert_array_equal(got, want, err_msg=str(info))
    return True


def _image(seed, h=5, w=7):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


# --- fixtures ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_bit_equal_to_cv2(name, expected):
    data = (FIXTURES / name).read_bytes()
    if name in CV2_NONE:
        assert _cv2(data) is None
        with pytest.raises(ValueError, match=re.escape(CV2_NONE[name])) as err:
            image_io.imread(str(FIXTURES / name))
        assert not isinstance(err.value, image_io.UnsupportedImageFormat)
        return
    got = image_io.imread(str(FIXTURES / name))
    np.testing.assert_array_equal(got, jax_tf.imread_cv2(str(FIXTURES / name)))
    np.testing.assert_array_equal(got, expected[name])


def test_every_fixture_is_named():
    assert set(NAMES) == set(CV2_NONE) | set(np.load(FIXTURES / "expected.npz").files)


def test_the_card_smoke_holds_the_same_cv2_none_files():
    import chip_smoke

    assert chip_smoke.PNG_CV2_NONE == CV2_NONE
    assert chip_smoke.APNG_CV2_NONE == apng_fx.CV2_NONE


@pytest.mark.parametrize("name", NAMES)
def test_image_size_is_jaxs(name):
    """JAX's header probe reads IHDR's sides and not the ``eXIf``
    orientation its decode applies (a hazard the port keeps, not fixes)."""
    path = str(FIXTURES / name)
    assert image_io.image_size(path) == jax_tf.image_size(path)


# --- orientation -------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["before", "after"])
@pytest.mark.parametrize("order", ["MM", "II"])
@pytest.mark.parametrize("o", range(10))
def test_orientation_grid_matches_cv2(o, order, where):
    img = _image(o, 3, 5)
    x = chunk(b"eXIf", exif_tiff(o, order))
    data = png_bytes(img, pre=[x]) if where == "before" else png_bytes(img, post=[x])
    assert _assert_as_cv2(data, (o, order, where))
    want = exif.apply(img, o if 1 <= o <= 8 else 1)
    np.testing.assert_array_equal(image_io.imdecode(data), want)


def _ifd(entries, order="MM", offset=8, count=None):
    e = ">" if order == "MM" else "<"
    head = b"MM\x00*" if order == "MM" else b"II*\x00"
    body = head + struct.pack(e + "I", offset) + bytes(max(0, offset - 8))
    body += struct.pack(e + "H", len(entries) if count is None else count)
    for tag, typ, cnt, value in entries:
        body += struct.pack(e + "HHI", tag, typ, cnt) + (
            struct.pack(e + "HH", value, 0) if typ == 3 else struct.pack(e + "I", value))
    return body + bytes(4)


EXIF_CASES = {
    "two eXIf chunks: the first": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", exif_tiff(6)), chunk(b"eXIf", exif_tiff(3))]),
    "before and after: the one before": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", exif_tiff(6))], post=[chunk(b"eXIf", exif_tiff(3))]),
    "a bad CRC drops the first": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", exif_tiff(6), crc=1), chunk(b"eXIf", exif_tiff(3))]),
    "an invalid header drops the first": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", exif_tiff(6, prefix=b"Exif\x00\x00")),
                  chunk(b"eXIf", exif_tiff(3))]),
    "Exif prefix": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", exif_tiff(6, prefix=b"Exif\x00\x00"))]),
    "magic 43": lambda img: png_bytes(img, pre=[chunk(b"eXIf", b"MM\x00+" + exif_tiff(6)[4:])]),
    "entry cut to 10 bytes": lambda img: png_bytes(img, pre=[chunk(b"eXIf", exif_tiff(6)[:20])]),
    "entry cut to 9 bytes": lambda img: png_bytes(img, pre=[chunk(b"eXIf", exif_tiff(6)[:19])]),
    "IFD past the end": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", _ifd([(0x112, 3, 1, 6)], offset=200)[:30])]),
    "IFD at 0": lambda img: png_bytes(img, pre=[chunk(b"eXIf", _ifd([(0x112, 3, 1, 6)])[:4]
                                                      + bytes(4) + exif_tiff(6)[8:])]),
    "LONG orientation, Motorola": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", _ifd([(0x112, 4, 1, 6)]))]),
    "LONG orientation, Intel": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", _ifd([(0x112, 4, 1, 6)], "II"))]),
    "count past the entries": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", _ifd([(0x112, 3, 1, 6)], count=9))]),
    "a rational past the end before it": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", _ifd([(0x11A, 5, 1, 1000), (0x112, 3, 1, 6)]))]),
    "a rational past the end after it": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", _ifd([(0x112, 3, 1, 6), (0x11A, 5, 1, 1000)]))]),
    "a string past the end before it": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", _ifd([(0x10E, 2, 100, 1000), (0x112, 3, 1, 6)]))]),
    "a short string in its entry before it": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", _ifd([(0x10E, 2, 4, 0x41424300), (0x112, 3, 1, 6)]))]),
    "an unknown tag before it": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", _ifd([(0x9999, 4, 1, 5), (0x112, 3, 1, 6)]))]),
    "two orientation entries": lambda img: png_bytes(
        img, pre=[chunk(b"eXIf", _ifd([(0x112, 3, 1, 3), (0x112, 3, 1, 6)]))]),
    "empty eXIf": lambda img: png_bytes(img, pre=[chunk(b"eXIf", b"")]),
    "header only": lambda img: png_bytes(img, pre=[chunk(b"eXIf", exif_tiff(6)[:8])]),
}


@pytest.mark.parametrize("case", sorted(EXIF_CASES))
def test_exif_block_cases_match_cv2(case):
    assert _assert_as_cv2(EXIF_CASES[case](_image(11, 4, 6)), case)


def _random_block(rng):
    """An EXIF block of random entries of OpenCV's tags (and others), their
    types, counts and values random, the IFD offset and count sometimes
    off, the block sometimes cut."""
    tags = [0x10E, 0x10F, 0x110, 0x112, 0x11A, 0x11B, 0x128, 0x131, 0x132, 0x13E, 0x13F, 0x211,
            0x213, 0x214, 0x8298, 0x8769, 0x9999, 0x100]
    intel = rng.random() < 0.5
    e = "<" if intel else ">"
    ifd = int(rng.choice([8, 8, 8, 10, int(rng.integers(0, 40))]))
    body = bytearray((b"II*\x00" if intel else b"MM\x00*") + struct.pack(e + "I", ifd))
    body += bytes(max(0, ifd - len(body)))
    n = int(rng.integers(0, 6))
    entries = b""
    for _ in range(n):
        tag, typ = int(rng.choice(tags)), int(rng.choice([2, 3, 4, 5]))
        cnt = int(rng.choice([1, 2, 4, 5, 20, int(rng.integers(0, 100))]))
        val = int(rng.choice([1, 3, 6, 8, 9, 0, int(rng.integers(0, 60)),
                              int(rng.integers(0, 2**32))]))
        if tag == 0x112 and rng.random() < 0.8:
            entries += struct.pack(e + "HHIHH", tag, 3, cnt, val % 10, 0)
        else:
            entries += struct.pack(e + "HHII", tag, typ, cnt, val)
    if ifd >= 8:
        count = n if rng.random() < 0.8 else int(rng.integers(0, 10))
        body += struct.pack(e + "H", count) + entries + bytes(4 + int(rng.integers(0, 40)))
    cut = len(body) if rng.random() < 0.7 else int(rng.integers(0, len(body) + 1))
    return bytes(body[:cut])


def _orientation_of(got, base):
    for o in range(1, 9):
        want = exif.apply(base, o)
        if want.shape == got.shape and np.array_equal(want, got):
            return o
    return None


@pytest.mark.parametrize("seed", range(3))
def test_exif_reader_fuzz_matches_cv2(seed):
    """Random EXIF blocks: the orientation :func:`exif.orientation` reads is
    the one cv2 applies, through a PNG's ``eXIf`` (libpng passes only
    blocks starting ``II*\\0`` or ``MM\\0*``) and a JPEG's APP1 (any first
    bytes: two that differ read as Motorola order), and the port's JPEG
    decoder applies it too."""
    rng = np.random.default_rng(1900 + seed)
    img = _image(seed, 2, 3)
    jpeg = (FIXTURES.parent / "jpeg" / "arith_dac_s422_q90_20x31.jpg").read_bytes()
    base = jax_tf.imdecode_cv2(jpeg)
    for k in range(80):
        block = _random_block(rng)
        want = exif.orientation(block)
        if len(block) >= 4:
            got = jax_tf.imdecode_cv2(png_bytes(img, pre=[chunk(b"eXIf", block)]))
            assert _orientation_of(got, img) == want, (k, block.hex())
        if rng.random() < 0.3 and len(block) >= 2:
            block = b"MI" + block[2:]
        app1 = b"Exif\x00\x00" + block
        data = jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + jpeg[2:]
        got = jax_tf.imdecode_cv2(data)
        assert _orientation_of(got, base) == exif.orientation(block), (k, block.hex())
        np.testing.assert_array_equal(image_io.imdecode(data), got)


# --- chunk rules -------------------------------------------------------------------------

def _ihdr(w, h, depth=8, ctype=2, comp=0, filt=0, interlace=0, extra=b""):
    return chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, comp, filt, interlace)
                 + extra)


def _rgb():
    img = _image(5, 4, 5)
    return img, zlib.compress(scanlines(img))


def _file(*chunks):
    return SIGNATURE + b"".join(chunks)


def _palette_file(post_plte=False, n=4, idx_max=4, plte_crc=None, plte_len=None, plte2=False):
    rng = np.random.default_rng(4)
    idx = rng.integers(0, idx_max, (4, 5, 1)).astype(np.uint8)
    pal = rng.integers(0, 256, (max(n, 1), 3)).astype(np.uint8)[:n].tobytes()
    if plte_len is not None:
        pal = (pal * 90)[:plte_len]
    plte = chunk(b"PLTE", pal, crc=plte_crc)
    pre = [] if post_plte else [plte] + ([plte] if plte2 else [])
    return png_bytes(idx, ctype=3, pre=pre, post=[plte] if post_plte else [])


def _fctl(w, h, x=0, y=0):
    return chunk(b"fcTL", struct.pack(">IIIIIHHBB", 0, w, h, x, y, 1, 1, 0, 0))


@functools.lru_cache(maxsize=None)
def _rules():
    img, z = _rgb()
    h, w = img.shape[:2]
    ih, ie, idat = _ihdr(w, h), chunk(b"IEND", b""), chunk(b"IDAT", z)
    text = chunk(b"tEXt", b"a\x00b")
    raw = scanlines(img)
    stored = zlib.compress(raw, 0)
    return {
        "plain": _file(ih, idat, ie),
        "IDAT CRC": _file(ih, chunk(b"IDAT", z, crc=1), ie),
        "IHDR CRC": SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0),
                                      crc=1) + idat + ie,
        "IEND CRC": _file(ih, idat, chunk(b"IEND", b"", crc=1)),
        "tEXt CRC before": _file(ih, chunk(b"tEXt", b"a\x00b", crc=1), idat, ie),
        "tEXt CRC after": _file(ih, idat, chunk(b"tEXt", b"a\x00b", crc=1), ie),
        "unknown ancillary CRC": _file(ih, chunk(b"abCD", b"xx", crc=1), idat, ie),
        "sRGB CRC": _file(ih, chunk(b"sRGB", b"\x00", crc=1), idat, ie),
        "no IEND": _file(ih, idat),
        "IEND cut": _file(ih, idat, ie)[:-2],
        "IEND with a body": _file(ih, idat, chunk(b"IEND", b"xx")),
        "bytes after IEND": _file(ih, idat, ie) + b"garbage",
        "a chunk after IEND": _file(ih, idat, ie, text),
        "no IDAT": _file(ih, ie),
        "IEND before IDAT": _file(ih, ie, idat, ie),
        "second IHDR after IDAT": _file(ih, idat, ih, ie),
        "second IHDR before IDAT": _file(ih, ih, idat, ie),
        "tEXt before IHDR": _file(text, ih, idat, ie),
        "CgBI first": _file(chunk(b"CgBI", bytes(4)), ih, idat, ie),
        "IHDR of 14 bytes": _file(_ihdr(w, h, extra=b"\x00"), idat, ie),
        "IHDR width 0": _file(_ihdr(0, h), idat, ie),
        "IHDR compression 1": _file(_ihdr(w, h, comp=1), idat, ie),
        "IHDR filter 1": _file(_ihdr(w, h, filt=1), idat, ie),
        "IHDR interlace 2": _file(_ihdr(w, h, interlace=2), idat, ie),
        "IHDR RGB at 4 bits": _file(_ihdr(w, h, depth=4), idat, ie),
        "IHDR colour type 1": _file(_ihdr(w, h, ctype=1), idat, ie),
        "unknown critical before IDAT": _file(ih, chunk(b"ABCD", b"xx"), idat, ie),
        "unknown critical after IDAT": _file(ih, idat, chunk(b"ABCD", b"xx"), ie),
        "reserved bit before IDAT": _file(ih, chunk(b"abcd", b"xx"), idat, ie),
        "reserved bit after IDAT": _file(ih, idat, chunk(b"abcD", b"xx"), ie),
        "chunk type not letters": _file(ih, chunk(b"ab1D", b"xx"), idat, ie),
        "lower-case IDAT": _file(ih, chunk(b"IDAt", z), ie),
        "chunk length over 2**31": _file(ih, idat) + struct.pack(">I", 0x80000010) + b"tEXt"
                                    + b"a" * 16 + ie,
        "chunk past the end": _file(ih, idat) + struct.pack(">I", 100) + b"tEXt" + b"abc",
        "IDAT split": _file(ih, chunk(b"IDAT", z[:5]), chunk(b"IDAT", z[5:]), ie),
        "IDAT split by tEXt": _file(ih, chunk(b"IDAT", z[:5]), text, chunk(b"IDAT", z[5:]), ie),
        "empty IDAT first": _file(ih, chunk(b"IDAT", b""), idat, ie),
        "empty IDAT between": _file(ih, chunk(b"IDAT", z[:5]), chunk(b"IDAT", b""),
                                    chunk(b"IDAT", z[5:]), ie),
        "second IDAT CRC": _file(ih, chunk(b"IDAT", z[:5]), chunk(b"IDAT", z[5:], crc=1), ie),
        "extra IDAT after the image": _file(ih, idat, chunk(b"IDAT", b"junk"), ie),
        "extra IDAT CRC": _file(ih, idat, chunk(b"IDAT", b"xx", crc=1), ie),
        "extra IDAT after tEXt": _file(ih, idat, text, chunk(b"IDAT", b"xx"), ie),
        "extra IDAT after tEXt, CRC": _file(ih, idat, text, chunk(b"IDAT", b"xx", crc=1), ie),
        "zlib past the image": _file(ih, chunk(b"IDAT", zlib.compress(raw + bytes(10))), ie),
        "zlib short of the image": _file(ih, chunk(b"IDAT", zlib.compress(raw[:-3])), ie),
        "bytes after the zlib stream": _file(ih, chunk(b"IDAT", z + b"garbage"), ie),
        "zlib without its Adler-32": _file(ih, chunk(b"IDAT", z[:-4]), ie),
        "bad Adler-32": _file(ih, chunk(b"IDAT", z[:-4] + bytes(4)), ie),
        "bad Adler-32 in the next IDAT": _file(ih, chunk(b"IDAT", stored[:-4]),
                                               chunk(b"IDAT", bytes(4)), ie),
        "Adler-32 after a tEXt": _file(ih, chunk(b"IDAT", z[:-4]), text,
                                       chunk(b"IDAT", z[-4:]), ie),
        "row filter 5": _file(ih, chunk(b"IDAT", zlib.compress(b"\x05" + raw[1:])), ie),
        "PLTE after IDAT, RGB": _file(ih, idat, chunk(b"PLTE", bytes(range(9))), ie),
        "PLTE CRC, RGB": _file(ih, chunk(b"PLTE", bytes(9), crc=1), idat, ie),
        "PLTE of 10 bytes, RGB": _file(ih, chunk(b"PLTE", bytes(10)), idat, ie),
        "two PLTE, RGB": _file(ih, chunk(b"PLTE", bytes(9)), chunk(b"PLTE", bytes(9)), idat, ie),
        "PLTE in gray": png_bytes(img[:, :, :1], ctype=0, pre=[chunk(b"PLTE", bytes(9))]),
        "gAMA too short": _file(ih, chunk(b"gAMA", b"abc"), idat, ie),
        "gAMA after IDAT": _file(ih, idat, chunk(b"gAMA", struct.pack(">I", 45455)), ie),
        "tRNS of 5 bytes, RGB": _file(ih, chunk(b"tRNS", b"abcde"), idat, ie),
        "sBIT 9": _file(ih, chunk(b"sBIT", b"\x09\x09\x09"), idat, ie),
        "iCCP damaged": _file(ih, chunk(b"iCCP", b"name\x00\x00junk"), idat, ie),
        "zTXt damaged": _file(ih, chunk(b"zTXt", b"k\x00\x00junk"), idat, ie),
        "bKGD of 6 bytes": _file(ih, chunk(b"bKGD", bytes(6)), idat, ie),
        "bKGD of 3 bytes": _file(ih, chunk(b"bKGD", bytes(3)), idat, ie),
        "bKGD of 3 bytes after IDAT": _file(ih, idat, chunk(b"bKGD", bytes(3)), ie),
        "acTL of one frame": _file(ih, chunk(b"acTL", struct.pack(">II", 1, 0)), idat, ie),
        "acTL of no frames": _file(ih, chunk(b"acTL", struct.pack(">II", 0, 0)), idat, ie),
        "acTL of no frames after IDAT": _file(ih, idat, chunk(b"acTL", bytes(8)), ie),
        "acTL of 3 bytes": _file(ih, chunk(b"acTL", b"\x00\x00\x01"), idat, ie),
        "fcTL inside": _file(ih, chunk(b"acTL", struct.pack(">II", 1, 0)), _fctl(w, h), idat,
                             ie),
        "fcTL outside": _file(ih, _fctl(w + 3, h), idat, ie),
        "fcTL outside after IDAT": _file(ih, idat, chunk(b"fcTL", b"abc"), ie),
        "fcTL of 3 bytes": _file(ih, chunk(b"fcTL", b"abc"), idat, ie),
        "unknown ancillary of 7,999,989 bytes": _file(ih, chunk(b"abCd", bytes(7_999_989)),
                                                      idat, ie),
        "unknown ancillary of 7,999,988 bytes": _file(ih, chunk(b"abCd", bytes(7_999_988)),
                                                      idat, ie),
        "palette": _palette_file(),
        "palette index past PLTE": _palette_file(n=3),
        "palette PLTE after IDAT": _palette_file(post_plte=True),
        "palette PLTE CRC": _palette_file(plte_crc=1),
        "palette PLTE of 13 bytes": _palette_file(plte_len=13),
        "palette PLTE empty": _palette_file(plte_len=0),
        "palette PLTE of 257 entries": _palette_file(plte_len=771),
        "palette two PLTE": _palette_file(plte2=True),
    }


RULES = sorted(_rules())


@pytest.mark.parametrize("case", RULES)
def test_chunk_rules_match_cv2(case):
    _assert_as_cv2(_rules()[case], case)


def test_rules_meet_both_outcomes():
    rules = _rules()
    decoded = sum(_cv2(rules[c]) is not None for c in RULES)
    assert 30 <= decoded <= len(RULES) - 30


# --- the damage fuzz ---------------------------------------------------------------------

def _chunks(data):
    pos, out = 8, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        out.append((kind, data[pos + 8 : pos + 8 + n]))
        pos += 12 + n
    return out


def _valid_pngs(rng, n=4):
    """Valid PNGs of random kinds: every colour type and depth, plain or
    Adam7, random row filters, sometimes a palette, split IDAT runs, eXIf
    and tEXt chunks, and PIL's writer."""
    from PIL import Image

    out = []
    for _ in range(n):
        big = rng.random() < 0.25
        h, w = ((int(rng.integers(30, 90)), int(rng.integers(60, 160))) if big
                else (int(rng.integers(1, 30)), int(rng.integers(1, 30))))
        ctype = int(rng.choice([0, 2, 3, 4, 6]))
        depth = int(rng.choice({0: [1, 2, 4, 8, 16], 2: [8, 16], 3: [1, 2, 4, 8], 4: [8, 16],
                                6: [8, 16]}[ctype]))
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        palette = None
        if ctype == 3:
            n_pal = int(rng.integers(1, 1 << depth)) + 1
            samples = rng.integers(0, n_pal, (h, w, 1))
            palette = rng.integers(0, 256, (n_pal, 3))
        else:
            samples = rng.integers(0, 1 << depth, (h, w, ch))
        ftypes = tuple(int(f) for f in rng.integers(0, 5, int(rng.integers(1, 4))))
        if rng.random() < 0.2:
            bio = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
                bio, format="PNG", compress_level=int(rng.integers(0, 10)))
            data = bio.getvalue()
        else:
            data = filtered_png(samples, ctype, depth, ftypes=ftypes, palette=palette,
                                interlace=bool(rng.random() < 0.4))
        if rng.random() < 0.5:
            data = _rewrap(data, rng)
        out.append(data)
    return out


def _rewrap(data, rng):
    """The same image with its IDAT run split at random and ancillary
    chunks (eXIf, tEXt) before or after it."""
    parts = _chunks(data)
    z = b"".join(b for k, b in parts if k == b"IDAT")
    head = [chunk(k, b) for k, b in parts if k not in (b"IDAT", b"IEND")]
    if rng.random() < 0.6:
        head.append(chunk(b"eXIf", exif_tiff(int(rng.integers(1, 9)),
                                             "MM" if rng.random() < 0.5 else "II")))
    cuts = sorted(set(int(c) for c in rng.integers(0, len(z) + 1, int(rng.integers(1, 4)))))
    idats = [chunk(b"IDAT", z[a:b]) for a, b in zip([0] + cuts, cuts + [len(z)])]
    tail = [chunk(b"tEXt", b"k\x00v")] if rng.random() < 0.3 else []
    return SIGNATURE + b"".join(head + idats + tail) + chunk(b"IEND", b"")


def _damaged(data, rng):
    m = bytearray(data)
    r = rng.random()
    if r < 0.35:  # bit flips (most fail a CRC)
        for _ in range(int(rng.integers(1, 3))):
            m[int(rng.integers(8, len(m)))] ^= 1 << int(rng.integers(0, 8))
        return bytes(m)
    if r < 0.55:  # cut
        return bytes(m[: int(rng.integers(8, len(m)))])
    if r < 0.65:  # a run of bytes dropped
        a = int(rng.integers(8, len(m)))
        return bytes(m[:a] + m[int(rng.integers(a, len(m) + 1)) :])
    if r < 0.9:  # a flip inside one chunk, its CRC mended: structure, zlib, Adler-32
        parts = _chunks(data)
        i = int(rng.choice([k for k, (_, b) in enumerate(parts) if b] or [0]))
        kind, body = parts[i]
        body = bytearray(body)
        if body:
            at = len(body) - int(rng.integers(1, min(5, len(body)) + 1)) \
                if kind == b"IDAT" and rng.random() < 0.4 else int(rng.integers(0, len(body)))
            body[at] ^= 1 << int(rng.integers(0, 8))
        return SIGNATURE + b"".join(chunk(k, bytes(body) if j == i else b)
                                    for j, (k, b) in enumerate(parts))
    src = _valid_pngs(rng, 1)[0]  # spliced bytes of another PNG
    a, s = int(rng.integers(8, len(m))), int(rng.integers(8, len(src)))
    return bytes(m[:a]) + src[s : s + int(rng.integers(1, 40))] + bytes(m[a:])


@pytest.mark.parametrize("seed", range(6))
def test_damage_fuzz_matches_cv2(seed):
    rng = np.random.default_rng(1700 + seed)
    decoded = failed = 0
    for k, data in enumerate(_valid_pngs(rng)):
        assert _assert_as_cv2(data, (seed, k, "valid"))
        for j in range(30):
            if _assert_as_cv2(_damaged(data, rng), (seed, k, j)):
                decoded += 1
            else:
                failed += 1
    assert decoded >= 2 and failed >= 30


# --- the four faults ---------------------------------------------------------------------

def test_fault_png_exif_orientation_is_applied():
    img = _image(1, 2, 3)
    for o, where in ((6, "pre"), (3, "post")):
        x = chunk(b"eXIf", exif_tiff(o))
        data = png_bytes(img, pre=[x]) if where == "pre" else png_bytes(img, post=[x])
        np.testing.assert_array_equal(image_io.imdecode(data), jax_tf.imdecode_cv2(data))
        assert image_io.imdecode(data).shape == ((3, 2, 3) if o == 6 else (2, 3, 3))


def test_fault_webp_exif_orientation_is_applied():
    from tests.torch_port_data.make_web_fixtures import chunk as wchunk
    from tests.torch_port_data.make_web_fixtures import riff, vp8x, webp_chunks

    data = (FIXTURES.parent / "webp" / "cv2_lossless_23x37.webp").read_bytes()
    vp8l = dict(webp_chunks(data))[b"VP8L"]
    rotated = riff(vp8x(37, 23, 0x08), wchunk(b"VP8L", vp8l), wchunk(b"EXIF", exif_tiff(6)))
    assert jax_tf.imdecode_cv2(rotated).shape == (37, 23, 3)
    np.testing.assert_array_equal(image_io.imdecode(rotated), jax_tf.imdecode_cv2(rotated))


def test_fault_ancillary_crc_is_dropped_not_fatal():
    img = _image(2)
    data = png_bytes(img, pre=[chunk(b"tEXt", b"Comment\x00x", crc=0)])
    np.testing.assert_array_equal(image_io.imdecode(data), jax_tf.imdecode_cv2(data))


def test_fault_png_without_iend_fails_as_in_cv2():
    data = png_bytes(_image(3), iend=False)
    with pytest.raises(ValueError):
        jax_tf.imdecode_cv2(data)
    with pytest.raises(ValueError, match="truncated"):
        image_io.imdecode(data)


def test_fault_palette_png_with_a_second_plte_after_idat_fails_as_in_cv2():
    plte = chunk(b"PLTE", bytes(range(12)))
    twice = png_bytes(np.zeros((4, 5, 1), np.uint8), ctype=3, pre=[plte], post=[plte])
    assert _cv2(twice) is None
    with pytest.raises(ValueError, match="second PLTE"):
        image_io.imdecode(twice)


@pytest.mark.parametrize("dispose,blend", [(3, 0), (0, 2)])
def test_fault_fctl_ops_past_their_range_fail_as_in_cv2(dispose, blend):
    img, z = _rgb()
    h, w = img.shape[:2]
    ctl = chunk(b"fcTL", struct.pack(">IIIIIHHBB", 0, w, h, 0, 0, 1, 1, dispose, blend))
    data = _file(_ihdr(w, h), ctl, chunk(b"IDAT", z), chunk(b"IEND", b""))
    assert _cv2(data) is None
    with pytest.raises(ValueError, match="dispose op"):
        image_io.imdecode(data)


# --- APNG: the first frame, as OpenCV 5's APNG path reads it ------------------------------

from tests.torch_port_data import make_apng_fixtures as apng_fx  # noqa: E402

APNG = FIXTURES.parent / "apng"
APNG_NAMES = sorted(p.name for p in APNG.glob("*.png"))
HIDDEN = [n for n in APNG_NAMES if n.startswith("hidden_")]

# cv2 in a child process: on some damaged APNG frames libpng's error
# unwinds into OpenCV's frame loop and the process dies (SIGSEGV)
_CV2_CHILD = r"""
import sys
import cv2
import numpy as np
for path in sys.argv[1:]:
    print(path, flush=True)
    bgr = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        open(path + ".none", "wb").close()
    else:
        np.save(path + ".npy", cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
"""


def _cv2_apart(datas, folder):
    """cv2's RGB pixels of each file, decoded in child processes: None
    where cv2 gives None or its process dies."""
    import subprocess
    import sys

    paths = []
    for k, data in enumerate(datas):
        p = Path(folder) / f"{k}.png"
        p.write_bytes(data)
        paths.append(str(p))
    todo = paths
    while todo:
        r = subprocess.run([sys.executable, "-c", _CV2_CHILD, *todo], capture_output=True,
                           text=True, timeout=300)
        if r.returncode == 0:
            break
        assert r.returncode < 0, r.stderr[-2000:]  # killed by a signal, not a Python error
        last = r.stdout.split()[-1]
        todo = todo[todo.index(last) + 1 :]
    out = []
    for p in paths:
        npy = Path(p + ".npy")
        out.append(np.load(npy) if npy.exists() else None)
    return out


def _held(data, want, info=""):
    """The port gives ``want`` (cv2's pixels) or raises ValueError where cv2
    has none.  Returns whether cv2 decoded."""
    if want is None:
        with pytest.raises(ValueError) as err:
            image_io.imdecode(data)
        assert not isinstance(err.value, image_io.UnsupportedImageFormat), info
        return False
    got = image_io.imdecode(data)
    assert got.shape == want.shape, info
    np.testing.assert_array_equal(got, want, err_msg=str(info))
    return True


@pytest.fixture(scope="module")
def apng_expected():
    with np.load(APNG / "expected.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", HIDDEN)
def test_fault_hidden_default_apng_decodes_its_first_frame_as_cv2(name, apng_expected):
    data = (APNG / name).read_bytes()
    got = image_io.imdecode(data)
    np.testing.assert_array_equal(got, jax_tf.imdecode_cv2(data))
    np.testing.assert_array_equal(got, apng_expected[name])


@pytest.mark.parametrize("name", [n for n in APNG_NAMES if n not in HIDDEN])
def test_apng_fixture_is_bit_equal_to_cv2(name, apng_expected):
    data = (APNG / name).read_bytes()
    if name in apng_fx.CV2_NONE:
        assert _cv2(data) is None
        with pytest.raises(ValueError, match=re.escape(apng_fx.CV2_NONE[name])):
            image_io.imdecode(data)
        return
    np.testing.assert_array_equal(image_io.imdecode(data), jax_tf.imdecode_cv2(data))
    np.testing.assert_array_equal(image_io.imdecode(data), apng_expected[name])


def test_apng_fixtures_are_named_and_small():
    assert set(APNG_NAMES) == set(apng_fx.CV2_NONE) | set(np.load(APNG / "expected.npz").files)
    assert len(HIDDEN) >= 60
    assert sum(p.stat().st_size for p in APNG.iterdir()) < 256 * 1024


def test_apng_16_bit_samples_reach_8_bits_as_cv2_takes_them():
    """OpenCV's APNG path converts 16-bit frames with convertTo(CV_8U, 1/255)
    (a still 16-bit PNG keeps the high byte): all 65,536 values."""
    vals = np.arange(65536, dtype=np.uint16).reshape(256, 256, 1)
    zero = np.zeros_like(vals)
    data = apng_fx.apng_bytes(zero, [(vals, 0, 0, 0, 0), (zero, 0, 0, 0, 0)], 16, 0)
    got = image_io.imdecode(data)
    np.testing.assert_array_equal(got, jax_tf.imdecode_cv2(data))
    assert got[0, 127, 0] == 0 and got[0, 128, 0] == 1 and got[255, 255, 0] == 255


@pytest.mark.parametrize("case", ["interlaced frame cut short", "both images cut short"])
def test_apng_pixels_no_decoder_wrote_raise(case, tmp_path):
    """A deliberate divergence: where cv2 returns pixels its buffer held but
    no decoder wrote (an interlaced frame's partial passes, rows neither
    the hidden IDAT image nor the frame reached), the port raises."""
    parts, i, raw = _frame_file(interlace=case.startswith("interlaced"))
    seq = parts[i][1][:4]
    cut = zlib.compress(raw[: len(raw) // 3])
    if case.startswith("both"):
        j = [k for k, _ in parts].index(b"IDAT")
        parts[j] = (b"IDAT", zlib.compress(apng_fx.scanlines(np.full((2, 13, 3), 50, np.uint8),
                                                             8)))
    parts[i] = (b"fdAT", seq + cut)
    data = apng_fx.rejoin(parts)
    assert _cv2_apart([data], tmp_path)[0] is not None
    with pytest.raises(ValueError, match="no decoder wrote"):
        image_io.imdecode(data)


def _frame_file(**kw):
    """A hidden-default RGB APNG of 9x13, first frame 5x7 at (4, 3): its
    chunks, the index of the first fdAT, the frame's scanlines."""
    rng = np.random.default_rng(7)
    f1 = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    d = np.full((9, 13, 3), 50, np.uint8)
    f2 = rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)
    parts = apng_fx.apng_chunks(apng_fx.apng_bytes(d, [(f1, 4, 3, 0, 0), (f2, 0, 0, 0, 0)], **kw))
    return (parts, [k for k, _ in parts].index(b"fdAT"),
            apng_fx.scanlines(f1, 8, kw.get("interlace", False)))


@functools.lru_cache(maxsize=None)
def _apng_rules():
    parts, i, raw = _frame_file()
    join = apng_fx.rejoin
    body = parts[i][1]
    seq, z = body[:4], body[4:]
    j_idat = [k for k, _ in parts].index(b"IDAT")
    j_next = len(parts) - 3  # the second frame's fcTL

    def at(k, *new):
        return join(parts[:k] + list(new) + parts[k:])

    def fdat(new):
        return join(parts[:i] + [(b"fdAT", new)] + parts[i + 1 :])

    split = _frame_file(split=9)[0]
    k2 = [k for k, _ in split].index(b"fdAT") + 1
    co = zlib.compressobj(zdict=b"abc")
    big = np.random.default_rng(3).integers(0, 256, (1000, 8200, 1)).astype(np.uint8)
    nil = np.zeros_like(big)
    return {
        "fdAT of 3 bytes": fdat(body[:3]),
        "fdAT of 4 bytes": fdat(seq),
        "fdAT cut by one byte": fdat(body[:-1]),
        "fdAT without Adler-32": fdat(body[:-4]),
        "fdAT bad Adler-32": fdat(body[:-4] + bytes(4)),
        "fdAT garbage": fdat(seq + b"garbage!"),
        "fdAT stream of 2 rows": fdat(seq + zlib.compress(raw[: 2 * len(raw) // 5])),
        "fdAT stream past the rows": fdat(seq + zlib.compress(raw + raw)),
        "fdAT stream with a dictionary": fdat(seq + co.compress(raw) + co.flush()),
        "fdAT stream without its end": fdat(seq + zlib.compressobj().compress(raw)
                                            + zlib.compressobj().flush(zlib.Z_SYNC_FLUSH)),
        "fdAT row filter 7": fdat(seq + zlib.compress(b"\x07" + raw[1:])),
        "fdAT bytes after the stream": fdat(body + b"junk"),
        "fdAT CRC": join(parts, {i: 0}),
        "fdAT sequence 0": fdat(bytes(4) + z),
        "fcTL CRC": join(parts, {i - 1: 0}),
        "IDAT CRC": join(parts, {j_idat: 0}),
        "acTL CRC": join(parts, {1: 0}),
        "IHDR CRC": join(parts, {0: 0}),
        "hidden IDAT damaged": join(parts[:j_idat] + [(b"IDAT", b"garbage!")]
                                    + parts[j_idat + 1 :]),
        "hidden IDAT short, then tEXt": join(parts[:j_idat] + [(b"IDAT", parts[j_idat][1][:9]),
                                                                (b"tEXt", b"k\x00v")]
                                             + parts[j_idat + 1 :]),
        "unknown critical after IDAT": at(j_idat + 1, (b"ABCD", b"xy")),
        "IHDR after IDAT": at(j_idat + 1, parts[0]),
        "bKGD of 3 bytes after IDAT": at(j_idat + 1, (b"bKGD", bytes(3))),
        "acTL of no frames after IDAT": at(j_idat + 1, (b"acTL", bytes(8))),
        "tEXt inside the fdAT run": apng_fx.rejoin(split[:k2] + [(b"tEXt", b"k\x00v")]
                                                   + split[k2:]),
        "IDAT inside the fdAT run": apng_fx.rejoin(split[:k2] + [(b"IDAT", b"zz")]
                                                   + split[k2:]),
        "fcTL inside the fdAT run": apng_fx.rejoin(split[:k2] + [split[k2 - 2]] + split[k2:]),
        "fdAT run missing a chunk": apng_fx.rejoin(split[: k2 - 1] + split[k2:]),
        "unknown critical after the stream": at(i + 1, (b"ABCD", b"xy")),
        "unknown ancillary after the stream": at(i + 1, (b"abCD", b"xy")),
        "PLTE after the stream, RGB": at(i + 1, (b"PLTE", bytes(6))),
        "ancillary of 7,999,989 bytes after the stream": at(i + 1, (b"zTXt", bytes(7_999_989))),
        "tEXt of 7,999,989 bytes after the stream": at(i + 1, (b"tEXt", bytes(7_999_989))),
        "next fcTL outside": join(parts[:j_next] + [(b"fcTL", apng_fx.fctl(3, 13, 9, 1)[8:-4])]
                                  + parts[j_next + 1 :]),
        "next fcTL blend 2": join(parts[:j_next] + [(b"fcTL", apng_fx.fctl(3, 13, 9, 0, 0, 0, 2)
                                                     [8:-4])] + parts[j_next + 1 :]),
        "next fcTL of 25 bytes": join(parts[:j_next] + [(b"fcTL", parts[j_next][1][:25])]
                                      + parts[j_next + 1 :]),
        "cut before the next fcTL": join(parts[:j_next]),
        "cut inside the next fcTL": join(parts)[: len(join(parts[:j_next])) + 20],
        "cut inside the next fdAT": join(parts)[: len(join(parts[: j_next + 1])) + 20],
        "IEND right after the frame": join(parts[:j_next] + parts[-1:]),
        "IEND right after IDAT": join(parts[: j_idat + 1] + parts[-1:]),
        "fdAT over 8,000,000 bytes": apng_fx.apng_bytes(nil, [(big, 0, 0, 0, 0), (nil, 0, 0, 0, 0)],
                                                        8, 0),
        "two acTL, 1 then 2": at(2, (b"acTL", struct.pack(">II", 2, 0)))
                                .replace(b"acTL\x00\x00\x00\x02", b"acTL\x00\x00\x00\x01", 1),
        "acTL of one frame": join([parts[0], (b"acTL", struct.pack(">II", 1, 0))] + parts[2:]),
    }


APNG_RULES = sorted(_apng_rules())


@pytest.fixture(scope="module")
def apng_rules_cv2(tmp_path_factory):
    rules = _apng_rules()
    return dict(zip(APNG_RULES, _cv2_apart([rules[c] for c in APNG_RULES],
                                           tmp_path_factory.mktemp("apng_rules"))))


@pytest.mark.parametrize("case", APNG_RULES)
def test_apng_frame_rules_match_cv2(case, apng_rules_cv2):
    _held(_apng_rules()[case], apng_rules_cv2[case], case)


def test_apng_rules_meet_both_outcomes(apng_rules_cv2):
    decoded = sum(v is not None for v in apng_rules_cv2.values())
    assert 12 <= decoded <= len(APNG_RULES) - 12


def _valid_apngs(rng, n=3):
    """Hidden-default APNGs of random kinds: colour types and depths, first
    frames of random sides and offsets, fdAT runs cut at random."""
    out = []
    for _ in range(n):
        ctype = int(rng.choice([0, 2, 3, 4, 6]))
        depth = int(rng.choice({0: [1, 2, 4, 8, 16], 2: [8, 16], 3: [1, 2, 4, 8], 4: [8, 16],
                                6: [8, 16]}[ctype]))
        h, w = int(rng.integers(1, 24)), int(rng.integers(1, 40))
        n_pal = int(rng.integers(1, 1 << depth)) + 1 if ctype == 3 else 0
        pre = [chunk(b"PLTE", rng.integers(0, 256, (n_pal, 3)).astype(np.uint8).tobytes())] \
            if ctype == 3 else []
        fh, fw = int(rng.integers(1, h + 1)), int(rng.integers(1, w + 1))
        x, y = int(rng.integers(0, w - fw + 1)), int(rng.integers(0, h - fh + 1))
        frames = [(apng_fx.samples(rng, fh, fw, ctype, depth, n_pal), x, y,
                   int(rng.integers(0, 3)), int(rng.integers(0, 2))),
                  (apng_fx.samples(rng, h, w, ctype, depth, n_pal), 0, 0, 0, 0)]
        out.append(apng_fx.apng_bytes(apng_fx.samples(rng, h, w, ctype, depth, n_pal), frames,
                                      depth, ctype, pre, split=int(rng.choice([0, 0, 5, 23]))))
    return out


def _damaged_frames(data, rng):
    """One damage to the chunks from the first fdAT on (the IDAT image stays
    whole: where neither image wrote a row cv2 returns unwritten memory)."""
    parts = apng_fx.apng_chunks(data)
    first = [k for k, _ in parts].index(b"fdAT")
    i = int(rng.integers(first, len(parts)))
    kind, body = parts[i]
    r = rng.random()
    if r < 0.3 and body:  # bits flipped in one chunk (CRCs mended or not: neither is read)
        body = bytearray(body)
        for _ in range(int(rng.integers(1, 4))):
            body[int(rng.integers(0, len(body)))] ^= 1 << int(rng.integers(0, 8))
        parts[i] = (kind, bytes(body))
    elif r < 0.45:  # a chunk cut short
        parts[i] = (kind, body[: int(rng.integers(0, len(body) + 1))])
    elif r < 0.55:  # a chunk dropped
        del parts[i]
    elif r < 0.7:  # a chunk put in
        new = [(b"tEXt", b"k\x00v"), (b"IDAT", bytes(rng.integers(0, 256, 6).tolist())),
               (b"abCD", b"x"), (b"ABCD", b"x"), parts[first - 1], (b"IEND", b""),
               (b"fdAT", bytes(4) + zlib.compress(b"\x00" * 9))][int(rng.integers(0, 7))]
        parts.insert(i, new)
    elif r < 0.8 and kind == b"fdAT" and len(body) > 5:  # an fdAT split in two
        a = int(rng.integers(5, len(body)))
        parts[i : i + 1] = [(kind, body[:a]), (kind, body[:4] + body[a:])]
    elif r < 0.9:  # bytes of the file cut off
        whole = apng_fx.rejoin(parts)
        start = len(apng_fx.rejoin(parts[:first]))
        return whole[: int(rng.integers(start, len(whole)))]
    else:  # a run of bytes dropped
        whole = apng_fx.rejoin(parts)
        start = len(apng_fx.rejoin(parts[:first]))
        a = int(rng.integers(start, len(whole)))
        return whole[:a] + whole[int(rng.integers(a, len(whole) + 1)) :]
    return apng_fx.rejoin(parts, {k: int(rng.integers(0, 1 << 32)) for k in range(len(parts))
                                  if rng.random() < 0.2})


@pytest.mark.parametrize("seed", range(8))
def test_apng_fdat_damage_fuzz_matches_cv2(seed, tmp_path):
    rng = np.random.default_rng(2100 + seed)
    cases = []
    for k, data in enumerate(_valid_apngs(rng)):
        cases.append(((seed, k, "valid"), data))
        cases += [((seed, k, j), _damaged_frames(data, rng)) for j in range(25)]
    wants = _cv2_apart([d for _, d in cases], tmp_path)
    decoded = sum(_held(d, want, info) for (info, d), want in zip(cases, wants))
    assert all(w is not None for (info, _), w in zip(cases, wants) if info[2] == "valid")
    assert 10 <= decoded <= len(cases) - 10
