"""The port's TIFF decoder (``data/tiff.py``) vs the JAX package's
``imdecode_cv2``, on the CPU.

* Every fixture of ``tests/torch_port_data/tiff/`` (each compression with
  and without the predictor, gray at 1/8/16 bits both ways, palette at
  1/4/8 with 16- and 8-bit colour maps, RGB(A) at 8/16, CMYK, planar, tiles,
  II and MM, orientations 1-8, FillOrder 2, two pages; CCITT modified
  Huffman, RLEW, Group 3 1-D and 2-D and Group 4; JPEG-in-TIFF gray, RGB
  and YCbCr at every subsampling, strips, tiles and a tall last strip;
  YCbCr at every subsampling libtiff reads; files from cv2 and PIL):
  bit-equal to ``imdecode_cv2`` and to the pixels the card's smoke reads
  (``expected.npz``).
* A seeded fuzz over compression x predictor x photometric x bit depth x
  strips or tiles x planar x byte order x orientation: bit-equal wherever
  cv2 decodes; ``ValueError`` where it fails (uncompressed tiles whose
  byte size is not a multiple of 1 KiB among them).
* 16-bit samples reach 8 bits as cv2 takes them, on every 16-bit value.
* ``image_size`` equals JAX's ``image_size`` (orientations 5-8 swap the
  sides) without decoding.
* Seeded fuzzes of CCITT (compression 2 / 3 / 4 / 32771 x T4Options x
  FillOrder x photometric 0 / 1 x strips or tiles, runs past 2560), YCbCr
  (subsampling x compression x ReferenceBlackWhite x YCbCrCoefficients x
  planar x tiles) and JPEG-in-TIFF (photometric 1 / 2 / 6 x subsampling x
  strips or tiles x JPEGTables or not x a tall last strip): bit-equal
  wherever cv2 decodes cleanly; damaged fax data raises ``ValueError``
  where libtiff warns and fills the row.
* BigTIFF (PIL's, and classic files rewritten with 20-byte entries and
  LONG8 offsets), signed 8- and 16-bit samples, old-style LZW, planar YCbCr
  JPEG-in-TIFF, CIELab at 8 and 16 bits and SGI LogL: the fixtures and
  seeded fuzzes bit-equal to cv2 (LogL on every 16-bit value).
* Where cv2 gives ``None`` the port raises ``ValueError`` naming the
  cause, before it looks at the compression as OpenCV does: old-style
  JPEG, LZMA, ZSTD, WebP, LERC and PixarLog compression, floating-point,
  untyped and 32-bit samples, ICCLab and ITULab, 4-bit ThunderScan, LogLuv
  at 32 bits (the ``none_*`` fixtures and more); the kinds refused before
  they were ported (CCITT, JPEG, YCbCr, BigTIFF, signed samples, planar
  YCbCr JPEG, old-style LZW, CIELab, LogL, LogLuv) decode bit-equal.
* SGI LogLuv and the predictor on subsampled YCbCr (the fixtures of
  ``tests/torch_port_data/tiff_variants/``): LogLuv32 on a seeded fuzz and
  on every (u', v') byte pair at a spread of luminances, LogLuv24 on all
  2**24 codes (the table of ``data/tiff.py``'s ``_UV_ROWS``, read back
  from cv2 by ``tests/torch_port_data/derive_uv_rows.py``), both at 1, 8
  and 16 bits, strips and tiles; subsampled YCbCr with the predictor on a
  seeded fuzz over subsampling, LZW and Deflate, strips and tiles, where
  libtiff undoes the predictor and where it refuses to (the bytes then
  stay as coded): all bit-equal to cv2.
* TIFF datasets with no further change: ``run_training`` on TIFF lines
  equals a run on PNGs of cv2's decode of them.
* JPEG-compressed gray + alpha (two-component frames, a fault the port
  had): the fixtures of ``tests/torch_port_data/tiff_gray_alpha/`` and a
  seeded fuzz bit-equal to cv2; the same frame as a JPEG file still raises
  ``ValueError``, as cv2 gives None.
"""

import csv
import io
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

jax = pytest.importorskip("jax")

from rcnn_ocr_tpu.data import transforms as jax_tf  # noqa: E402
from rcnn_ocr_tpu_torch.data import image_io  # noqa: E402
from tests.torch_port_data.make_tiff_fixtures import (  # noqa: E402
    CV2_NONE, _ycc, big_tiff, jpeg_tiff, logluv_tiff, lzw, lzw_old_style, tiff_bytes)

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "tiff"
NAMES = sorted(p.name for p in FIXTURES.glob("*.tif") if p.name not in CV2_NONE)
VARIANTS = FIXTURES.parent / "tiff_variants"
VARIANT_NAMES = sorted(p.name for p in VARIANTS.glob("*.tif"))


@pytest.fixture(scope="module")
def expected():
    with np.load(FIXTURES / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def _cv2(data):
    try:
        return jax_tf.imdecode_cv2(data)
    except (ValueError, cv2.error):
        return None


def _assert_bit_equal(data):
    want = jax_tf.imdecode_cv2(data)
    got = image_io.imdecode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


# --- fixtures ---------------------------------------------------------------------------

def test_fixtures_cover_the_paths():
    kinds = ("none", "packbits", "lzw", "deflate", "zip", "pred2", "gray1", "gray8", "gray16",
             "miniswhite", "minisblack", "palette1", "palette4", "palette8", "map8", "rgb16",
             "rgba8_unassociated", "rgba8_associated", "rgba16", "gray_alpha", "cmyk8",
             "planar", "tiles", "_mm_", "fillorder2", "two_pages", "cv2_", "pil_", "tiff_line",
             "g4_", "g3_1d", "g3_2d", "g3_2d_fill", "mh_", "ccitt_rlew", "_wide_",
             "pil_1_group4", "pil_1_group3", "pil_1_tiff_ccitt", "g4_line", "g3_line",
             "jpeg_gray", "jpeg_rgb", "jpeg_ycbcr420", "jpeg_ycbcr422_tiles", "notag",
             "tall_last", "no_tables", "pil_l_jpeg", "pil_ycbcr_jpeg", "jpeg_line",
             "ycbcr11", "ycbcr22", "ycbcr21", "ycbcr12", "ycbcr42", "ycbcr41", "ycbcr44",
             "ycbcr44_tiles", "pil_ycbcr_raw", "ycbcr_line", "bigtiff_pil_rgb",
             "bigtiff_pil_l", "bigtiff_pil_i16", "bigtiff_pil_1", "bigtiff_tiles_mm", "signed8",
             "signed16_gray_minisblack", "signed16_gray_miniswhite", "lzw_old_rgb8",
             "lzw_old_gray16_pred2_tiles", "jpeg_ycbcr_planar_", "jpeg_ycbcr_planar_tiles",
             "cielab8", "cielab16_whitepoint", "pil_lab", "sgilog_logl", "bigtiff_line",
             "cielab_line")
    for kind in kinds:
        assert any(kind in n for n in NAMES), kind
    assert sum(f"orientation{o}_" in n for n in NAMES for o in range(1, 9)) == 10
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 256 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_bit_equal_to_cv2(name, expected):
    data = (FIXTURES / name).read_bytes()
    got = _assert_bit_equal(data)
    np.testing.assert_array_equal(got, expected[name])
    assert image_io.imread(str(FIXTURES / name)).shape == got.shape


@pytest.mark.parametrize("name", sorted(CV2_NONE))
def test_cv2_none_fixtures_raise_value_error_naming_them(name):
    """cv2 gives None on these, so JAX quarantines such a row: the port's
    ``ValueError`` (never ``UnsupportedImageFormat``) lets its datasets do
    the same."""
    data = (FIXTURES / name).read_bytes()
    assert _cv2(data) is None
    with pytest.raises(ValueError) as err:
        image_io.imread(str(FIXTURES / name))
    assert CV2_NONE[name] in str(err.value)
    assert not isinstance(err.value, image_io.UnsupportedImageFormat)


# --- fuzz -------------------------------------------------------------------------------

def _random_tiff(rng):
    """A random layout and its samples: (bytes, keyword arguments)."""
    h, w = (int(v) for v in rng.integers(1, 50, 2))
    phot = int(rng.choice([0, 1, 2, 3, 5]))
    bits = int(rng.choice({0: [1, 8, 16], 1: [1, 8, 16], 2: [8, 16], 3: [1, 4, 8],
                           5: [8]}[phot]))
    spp = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4}[phot]
    extra = None
    if phot in (1, 2) and bits >= 8 and rng.random() < 0.4:
        spp, extra = spp + 1, int(rng.choice([0, 1, 2]))
    samples = rng.integers(0, 1 << bits, (h, w, spp)).astype(np.uint16 if bits == 16 else np.uint8)
    comp = str(rng.choice(["none", "lzw", "deflate", "zip", "packbits"]))
    kw = dict(bits=bits, photometric=phot, compression=comp,
              predictor=2 if bits >= 8 and rng.random() < 0.5 else 1,
              planar=2 if spp > 1 and phot != 3 and rng.random() < 0.4 else 1,
              tile=((int(rng.choice([16, 32, 48])), int(rng.choice([16, 32])))
                    if rng.random() < 0.4 else None),
              rows_per_strip=int(rng.integers(1, 20)), order=str(rng.choice(["<", ">"])),
              orientation=int(rng.integers(1, 9)) if rng.random() < 0.4 else None,
              extra_samples=extra,
              colormap=(rng.integers(0, 65536 if rng.random() < 0.5 else 256, (1 << bits, 3))
                        if phot == 3 else None))
    return tiff_bytes(samples, **kw), kw


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_is_bit_equal(seed):
    rng = np.random.default_rng(900 + seed)
    decoded = 0
    for _ in range(40):
        data, kw = _random_tiff(rng)
        want = _cv2(data)
        if want is None:
            with pytest.raises(ValueError):
                image_io.imdecode(data)
            continue
        np.testing.assert_array_equal(image_io.imdecode(data), want, err_msg=str(kw))
        decoded += 1
    assert decoded >= 30


def _held_to_cv2(make, seed: int, n: int, at_least: int) -> None:
    """``n`` files from ``make(rng)``: bit-equal where cv2 decodes,
    ``ValueError`` where it gives None."""
    rng = np.random.default_rng(seed)
    decoded = 0
    for _ in range(n):
        data = make(rng)
        want = _cv2(data)
        if want is None:
            with pytest.raises(ValueError):
                image_io.imdecode(data)
            continue
        np.testing.assert_array_equal(image_io.imdecode(data), want)
        decoded += 1
    assert decoded >= at_least


def _layout(rng):
    """Strips or tiles, byte order and orientation at random."""
    return dict(tile=(int(rng.choice([16, 32])), 16) if rng.random() < 0.3 else None,
                rows_per_strip=int(rng.integers(1, 20)), order=str(rng.choice(["<", ">"])),
                orientation=int(rng.integers(1, 9)) if rng.random() < 0.3 else None)


@pytest.mark.parametrize("seed", range(2))
def test_bigtiff_fuzz_is_bit_equal(seed):
    """The fuzz's random layouts rewritten as BigTIFFs (LONG8 offsets,
    20-byte entries, values up to 8 bytes inline)."""
    _held_to_cv2(lambda rng: big_tiff(_random_tiff(rng)[0]), 1100 + seed, 25, 15)


@pytest.mark.parametrize("seed", range(2))
def test_signed_sample_fuzz_is_bit_equal(seed):
    """SampleFormat 2 at 1, 8 and 16 bits: libtiff's RGBA reader takes the
    samples' unsigned bits, negative values included."""
    def make(rng):
        phot = int(rng.choice([0, 1, 2, 3]))
        bits = int(rng.choice({0: [1, 8, 16], 1: [1, 8, 16], 2: [8, 16], 3: [8]}[phot]))
        spp = 3 if phot == 2 else 1
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        v = rng.integers(-(1 << (bits - 1)) if bits > 1 else 0, 1 << (bits - 1) if bits > 1 else 2,
                         (h, w, spp)) & ((1 << bits) - 1)
        return tiff_bytes(v.astype(np.uint16 if bits == 16 else np.uint8), bits=bits,
                          photometric=phot,
                          compression=str(rng.choice(["none", "lzw", "deflate"])),
                          predictor=2 if bits >= 8 and rng.random() < 0.4 else 1,
                          planar=2 if spp == 3 and rng.random() < 0.3 else 1,
                          colormap=rng.integers(0, 65536, (256, 3)) if phot == 3 else None,
                          extra_tags=[(339, 3, [2] * spp)], **_layout(rng))
    _held_to_cv2(make, 1200 + seed, 25, 20)


@pytest.mark.parametrize("seed", range(2))
def test_old_style_lzw_fuzz_is_bit_equal(seed):
    """Old-style LZW strips and tiles, long enough for 12-bit codes and a
    Clear mid-strip."""
    def make(rng):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        spp, bits = int(rng.choice([1, 3])), int(rng.choice([8, 16]))
        v = rng.integers(0, 1 << bits, (h, w, spp))
        if rng.random() < 0.6:  # runs, for long strings
            v = np.cumsum(rng.integers(0, 2, (h, w, spp)), axis=1) % (1 << bits)
        return tiff_bytes(v.astype(np.uint16 if bits == 16 else np.uint8), bits=bits,
                          photometric=2 if spp == 3 else 1, compression="lzw_old",
                          predictor=int(rng.choice([1, 2])),
                          planar=int(rng.choice([1, 2])) if spp == 3 else 1,
                          fill_order=int(rng.choice([1, 2])), **_layout(rng))
    _held_to_cv2(make, 1300 + seed, 20, 20)


def test_old_style_lzw_round_trips_long_strings_and_a_full_table():
    from rcnn_ocr_tpu_torch.native import tiff_lzw_decode

    rng = np.random.default_rng(17)
    raw = bytes(rng.integers(0, 256, 20000).astype(np.uint8)) + bytes(5000)
    coded = lzw_old_style(raw)
    assert coded[0] == 0 and coded[1] & 1 and lzw(raw)[0] == 0x80  # how libtiff tells them
    assert tiff_lzw_decode(coded, len(raw), old_style=True) == raw
    assert tiff_lzw_decode(coded, 12345, old_style=True) == raw[:12345]
    with pytest.raises(ValueError):
        tiff_lzw_decode(coded, len(raw))  # read in the new style


@pytest.mark.parametrize("seed", range(2))
def test_planar_ycbcr_jpeg_fuzz_is_bit_equal(seed):
    """Planar YCbCr JPEG-in-TIFF, a one-component JPEG a plane: strips,
    tiles, tall last strips, JPEGTables or not, ReferenceBlackWhite; no
    YCbCrSubsampling tag (2x2 then) gives cv2's None."""
    def make(rng):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        rbw = [(532, 5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])]
        return jpeg_tiff(rng.integers(0, 256, (h, w, 3)).astype(np.uint8), 6, planar=2,
                         tile=(16, 16) if rng.random() < 0.3 else None,
                         rows_per_strip=int(rng.integers(1, 20)),
                         tables=bool(rng.random() < 0.7), tall_last=bool(rng.random() < 0.3),
                         subsampling_tag=bool(rng.random() < 0.9),
                         extra_tags=rbw if rng.random() < 0.3 else [],
                         order=str(rng.choice(["<", ">"])))
    _held_to_cv2(make, 1400 + seed, 15, 10)


@pytest.mark.parametrize("bits", [8, 16])
def test_cielab_fuzz_is_bit_equal(bits):
    """CIELab over random L*, a*, b* (every 8-bit triple's region) and
    WhitePoints: libtiff's float tables, value for value."""
    def make(rng):
        v = rng.integers(0, 1 << bits, (int(rng.integers(1, 48)), int(rng.integers(1, 48)), 3))
        wp = [(318, 5, [(int(rng.integers(1, 1000)), 1000), (int(rng.integers(1, 1000)), 1000)])]
        return tiff_bytes(v.astype(np.uint16 if bits == 16 else np.uint8), bits=bits,
                          photometric=8, compression=str(rng.choice(["none", "lzw"])),
                          predictor=int(rng.choice([1, 2])),
                          extra_tags=wp if rng.random() < 0.4 else [], **_layout(rng))
    _held_to_cv2(make, 1500 + bits, 14, 8)


def test_every_sgi_logl_value_reaches_gray_as_cv2_takes_it():
    v = np.arange(65536, dtype=np.uint32).reshape(256, 256, 1).astype(np.uint16)
    _assert_bit_equal(tiff_bytes(v, bits=16, photometric=32844, compression="sgilog",
                                 rows_per_strip=37, extra_tags=[(339, 3, [2])]))


def test_sgi_logl_fuzz_is_bit_equal():
    def make(rng):
        v = rng.integers(0, 65536, (int(rng.integers(1, 40)), int(rng.integers(1, 40)), 1))
        if rng.random() < 0.5:  # runs for the run-length code
            v = np.repeat(v[:, : max(1, v.shape[1] // 4)], 4, axis=1)[:, : v.shape[1]]
        return tiff_bytes(v.astype(np.uint16), bits=16, photometric=32844, compression="sgilog",
                          **_layout(rng))
    _held_to_cv2(make, 1600, 15, 15)


@pytest.mark.parametrize("kind", ["gray", "miniswhite", "rgb", "rgba", "gray_planar"])
def test_every_16_bit_value_reaches_8_bits_as_cv2_takes_it(kind):
    """libtiff's RGBA reader under OpenCV: gray keeps the high byte, RGB
    rounds (``(v + 128) // 257``), an unassociated alpha premultiplies, and
    planar gray is read as RGB (rounded)."""
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256, 1)
    samples, kw = {
        "gray": (v, dict(photometric=1)),
        "miniswhite": (v, dict(photometric=0)),
        "rgb": (np.concatenate([v, v[::-1], v[:, ::-1]], 2), dict(photometric=2)),
        "rgba": (np.concatenate([v, v[::-1], v[:, ::-1], v.transpose(1, 0, 2)], 2),
                 dict(photometric=2, extra_samples=2)),
        "gray_planar": (np.concatenate([v, v[::-1]], 2),
                        dict(photometric=1, planar=2, extra_samples=1)),
    }[kind]
    _assert_bit_equal(tiff_bytes(samples, bits=16, compression="deflate", rows_per_strip=64, **kw))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("tiled", [False, True], ids=["strips", "tiles"])
def test_orientation_and_image_size_agree(orientation, tiled, tmp_path):
    """cv2 applies the Orientation tag (6: a 17x33 image comes back 33x17);
    for tiles it mirrors 2, 3, 6 and 7 within each tile, as libtiff's RGBA
    tile reader does."""
    img = np.random.default_rng(orientation).integers(0, 256, (17, 33, 3)).astype(np.uint8)
    data = tiff_bytes(img, photometric=2, compression="lzw", orientation=orientation,
                      tile=(16, 16) if tiled else None)
    got = _assert_bit_equal(data)
    assert got.shape[:2] == ((33, 17) if orientation >= 5 else (17, 33))
    path = tmp_path / f"o{orientation}.tif"
    path.write_bytes(data)
    assert image_io.image_size(str(path)) == got.shape[:2] == jax_tf.image_size(str(path))


def test_image_size_reads_the_header_as_jax_sizes_the_fixtures(monkeypatch):
    want = {name: jax_tf.image_size(str(FIXTURES / name)) for name in NAMES}
    monkeypatch.setattr(image_io, "imread", lambda path: pytest.fail(f"decoded {path}"))
    assert {name: image_io.image_size(str(FIXTURES / name)) for name in NAMES} == want


def test_first_page_of_a_multi_page_file():
    rng = np.random.default_rng(3)
    first, second = (rng.integers(0, 256, (9, 14, 3)).astype(np.uint8) for _ in range(2))
    data = tiff_bytes(first, photometric=2, compression="deflate",
                      pages=[dict(samples=second, photometric=2), dict(samples=second[:, :, :1])])
    np.testing.assert_array_equal(_assert_bit_equal(data), first)
    bio = io.BytesIO()
    Image.fromarray(first).save(bio, format="TIFF", save_all=True,
                                append_images=[Image.fromarray(second)], compression="tiff_lzw")
    np.testing.assert_array_equal(_assert_bit_equal(bio.getvalue()), first)


# --- CCITT, YCbCr and JPEG-in-TIFF ------------------------------------------------------

def _bilevel(rng, h, w):
    if rng.random() < 0.3:
        return (rng.random((h, w)) < rng.random()).astype(np.uint8)
    img = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(1, 12))):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0 : y0 + int(rng.integers(1, h + 1)), x0 : x0 + int(rng.integers(1, w + 1))] ^= 1
    return img


@pytest.mark.parametrize("seed", range(6))
def test_fax_fuzz_is_bit_equal(seed, capfd):
    """Modified Huffman, RLEW, Group 3 (T4Options 0 / 1 / 4 / 5) and Group
    4, MinIsWhite and MinIsBlack, FillOrder 1 and 2, strips and tiles, rows
    up to 3,000 pixels (the extended make-up codes): bit-equal wherever
    libtiff decodes without a warning.  Where libtiff warns (its RLEW and
    modified-Huffman readers misplace a row after a strip's last byte runs
    out mid-accumulator), it fills the row and cv2 returns that; the port
    raises ValueError, and only there."""
    rng = np.random.default_rng(1300 + seed)
    clean = 0
    for _ in range(30):
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 70))
        if rng.random() < 0.1:
            h, w = int(rng.integers(1, 4)), int(rng.integers(1700, 3000))
        comp = str(rng.choice(["ccitt_rle", "ccitt_rlew", "g3", "g4"]))
        tile = ((int(rng.choice([16, 32])), int(rng.choice([16, 32])))
                if w < 100 and rng.random() < 0.2 else None)
        kw = dict(bits=1, photometric=int(rng.integers(0, 2)), compression=comp,
                  t4options=int(rng.choice([0, 1, 4, 5])) if comp == "g3" else None,
                  fill_order=int(rng.integers(1, 3)), rows_per_strip=int(rng.integers(1, h + 1)),
                  tile=tile)
        data = tiff_bytes(_bilevel(rng, h, w)[:, :, None], **kw)
        capfd.readouterr()
        want = _cv2(data)
        warned = "TIFF_Warning" in capfd.readouterr().err
        assert want is not None
        if warned:
            with pytest.raises(ValueError):
                image_io.imdecode(data)
            continue
        np.testing.assert_array_equal(image_io.imdecode(data), want, err_msg=str((h, w, kw)))
        clean += 1
    assert clean >= 20


def _ycc_image(rng, h, w):
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (3, 3), 0).reshape(h, w, 3) if rng.random() < 0.5 else img


@pytest.mark.parametrize("seed", range(6))
def test_ycbcr_fuzz_is_bit_equal(seed):
    """YCbCr without JPEG: subsampling 1/2/4 on each axis, none / LZW /
    Deflate / PackBits, ReferenceBlackWhite and YCbCrCoefficients or their
    defaults, strips of any height, tiles, planar: bit-equal where cv2
    decodes, ValueError where it fails (2x4 and 1x4, planar subsampled)."""
    rng = np.random.default_rng(1400 + seed)
    decoded = 0
    for _ in range(30):
        h, w = (int(v) for v in rng.integers(1, 45, 2))
        hs, vs = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2), (2, 4),
                  (1, 4)][int(rng.integers(0, 9))]
        extra = []
        if rng.random() < 0.4:
            extra.append((532, 5, [(int(rng.integers(0, 40)), 1), (int(rng.integers(200, 256)), 1),
                                   (int(rng.integers(100, 128)), 1), (int(rng.integers(200, 300)), 1),
                                   (int(rng.integers(0, 128)), int(rng.integers(1, 3))),
                                   (int(rng.integers(129, 300)), 1)]))
        if rng.random() < 0.3:
            extra.append((529, 5, [(int(rng.integers(200, 400)), 1000),
                                   (int(rng.integers(500, 650)), 1000),
                                   (int(rng.integers(50, 200)), 1000)]))
        kw = dict(photometric=6, compression=str(rng.choice(["none", "lzw", "deflate",
                                                             "packbits"])),
                  tile=((int(rng.choice([16, 32])), int(rng.choice([16, 32])))
                        if rng.random() < 0.3 else None),
                  rows_per_strip=int(rng.integers(1, h + 1)))
        if rng.random() < 0.15:
            kw.update(planar=2, extra_tags=extra + [(530, 3, [hs, vs])])
        else:
            kw.update(subsampling=(hs, vs), extra_tags=extra)
        data = tiff_bytes(_ycc_image(rng, h, w), **kw)
        want = _cv2(data)
        if want is None:
            with pytest.raises(ValueError):
                image_io.imdecode(data)
            continue
        np.testing.assert_array_equal(image_io.imdecode(data), want,
                                      err_msg=str((h, w, hs, vs, kw)))
        decoded += 1
    assert decoded >= 12


@pytest.mark.parametrize("seed", range(6))
def test_jpeg_in_tiff_fuzz_is_bit_equal(seed):
    """JPEG-in-TIFF as libtiff has libjpeg decode it: gray (1) and RGB (2)
    with no colour conversion, YCbCr (6) to RGB with fancy upsampling at
    4:4:4 / 4:2:2 / 4:2:0 / 4:1:1 / 4:4:0; strips or tiles, JPEGTables or
    tables in each strip, a last strip coded at full height, the
    YCbCrSubsampling tag or the first strip's sampling."""
    rng = np.random.default_rng(1500 + seed)
    for _ in range(20):
        h, w = (int(v) for v in rng.integers(1, 45, 2))
        phot = int(rng.choice([1, 2, 6]))
        img = _ycc_image(rng, h, w)
        kw = dict(tile=((int(rng.choice([16, 32])), int(rng.choice([16, 32])))
                        if rng.random() < 0.3 else None),
                  rows_per_strip=int(rng.integers(1, h + 1)), quality=int(rng.integers(50, 100)),
                  sampling=str(rng.choice(["444", "422", "420", "411", "440"])) if phot == 6
                  else "444", tables=bool(rng.random() < 0.8), tall_last=bool(rng.random() < 0.3),
                  subsampling_tag=bool(rng.random() < 0.7))
        data = jpeg_tiff(img[:, :, :1] if phot == 1 else img, phot, **kw)
        np.testing.assert_array_equal(image_io.imdecode(data), jax_tf.imdecode_cv2(data),
                                      err_msg=str((h, w, phot, kw)))


def test_jpeg_ycbcr_upsampling_is_fancy_as_cv2s():
    """libtiff leaves libjpeg's fancy upsampling on: on the fixture whose
    2x2 chroma has sharp edges, the fancy decode of its strip equals cv2's
    pixels and a decode with the chroma replicated does not."""
    from rcnn_ocr_tpu_torch.native import jpeg_decode_frame

    data = (FIXTURES / "jpeg_ycbcr420_sharp_16x24.tif").read_bytes()
    want = jax_tf.imdecode_cv2(data)
    tags = image_io.tiff._tags(data, *image_io.tiff._header(data))
    (off,), (count,) = tags[273], tags[279]
    stream = bytes(tags[347])[:-2] + data[off : off + count][2:]
    np.testing.assert_array_equal(jpeg_decode_frame(stream, ycbcr=True), want)
    plain = jpeg_decode_frame(stream, ycbcr=True, fancy=False)
    assert (plain != want).any(axis=2).sum() > 50


@pytest.mark.parametrize("kind", ["g4", "g3_2d", "jpeg_ycbcr", "ycbcr22"])
@pytest.mark.parametrize("orientation", [3, 6])
def test_orientation_of_the_new_codings(kind, orientation, tmp_path):
    """The Orientation tag applies to fax, JPEG and YCbCr pages as to the
    others, and ``image_size`` swaps the sides without decoding."""
    rng = np.random.default_rng(orientation)
    if kind in ("g4", "g3_2d"):
        data = tiff_bytes(_bilevel(rng, 17, 33)[:, :, None], bits=1, photometric=0,
                          compression=kind[:2], t4options=1 if kind == "g3_2d" else None,
                          orientation=orientation)
    elif kind == "jpeg_ycbcr":
        data = jpeg_tiff(_ycc_image(rng, 17, 33), 6, sampling="420", rows_per_strip=16,
                         orientation=orientation)
    else:
        data = tiff_bytes(_ycc_image(rng, 17, 33), photometric=6, compression="lzw",
                          subsampling=(2, 2), orientation=orientation)
    got = _assert_bit_equal(data)
    assert got.shape[:2] == ((33, 17) if orientation >= 5 else (17, 33))
    path = tmp_path / "o.tif"
    path.write_bytes(data)
    assert image_io.image_size(str(path)) == got.shape[:2] == jax_tf.image_size(str(path))


@pytest.mark.parametrize("compression", ["g4", "g3", "ccitt_rle"])
def test_damaged_fax_data_raises(compression, capfd):
    """A deliberate divergence, as for other damaged compressed data:
    libtiff's fax decoder warns on a bad code or a row that does not add
    up and fills the row, and cv2 returns that; the port raises."""
    img = np.random.default_rng(9).integers(0, 2, (20, 40, 1)).astype(np.uint8)
    data = bytearray(tiff_bytes(img, bits=1, compression=compression, rows_per_strip=20,
                                t4options=1 if compression == "g3" else None))
    data[12:40] = b"\x00\xff" * 14  # the middle of the one strip
    capfd.readouterr()
    assert _cv2(bytes(data)) is not None
    assert "TIFF_Warning" in capfd.readouterr().err
    with pytest.raises(ValueError, match="damaged fax data"):
        image_io.imdecode(bytes(data))


def test_fax_decoder_raises_on_data_short_of_the_rows():
    from rcnn_ocr_tpu_torch.native import tiff_fax_decode
    from tests.torch_port_data.make_tiff_fixtures import fax_encode

    img = np.random.default_rng(10).integers(0, 2, (12, 30)).astype(np.uint8)
    coded = fax_encode(img, "g4")
    assert len(tiff_fax_decode(coded, 12, 30, 4)) == 12 * 4
    with pytest.raises(ValueError, match="damaged fax data"):
        tiff_fax_decode(coded, 13, 30, 4)  # EOFB before the 13th row
    with pytest.raises(ValueError, match="damaged fax data"):
        tiff_fax_decode(coded[: len(coded) // 2], 12, 30, 4)


# --- refusals and damage ----------------------------------------------------------------

def _pil_tiff(mode, **kw):
    img = np.random.default_rng(4).integers(0, 256, (10, 12, 3)).astype(np.uint8)
    bio = io.BytesIO()
    Image.fromarray(img).convert(mode).save(bio, format="TIFF", **kw)
    return bio.getvalue()


def _patched_compression(code):
    """An LZW file relabelled with another compression code."""
    data = bytearray(tiff_bytes(np.zeros((4, 5, 1), np.uint8), compression="lzw"))
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    for i in range(n):
        e = ifd + 2 + 12 * i
        if struct.unpack_from("<H", data, e)[0] == 259:
            struct.pack_into("<H", data, e + 8, code)
    return bytes(data)


def _logluv(bits):
    """An SGI LogLuv file (3 samples of ``bits``, 32-bit LogLuv words)."""
    return tiff_bytes(np.zeros((2, 3, 3), np.uint16), bits=bits, photometric=32845,
                      compression="sgilog", rows_per_strip=2, chunks=[bytes([3, 1, 2, 3] * 8)])


def _planar_ycbcr_jpeg():
    """A JPEG-in-TIFF relabelled planar YCbCr, its one strip three
    components (a planar file needs a strip a plane)."""
    img = np.random.default_rng(8).integers(0, 256, (8, 16, 3)).astype(np.uint8)
    data = bytearray(jpeg_tiff(img, 6, rows_per_strip=8))
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    for i in range(n):
        e = ifd + 2 + 12 * i
        if struct.unpack_from("<H", data, e)[0] == 284:
            struct.pack_into("<H", data, e + 8, 2)
    return bytes(data)


# kinds refused before they were ported
FORMERLY_REFUSED = {
    "CCITT Group 4 fax TIFF compression (4)": lambda: _pil_tiff("1", compression="group4"),
    "JPEG TIFF compression (7)": lambda: _pil_tiff("RGB", compression="jpeg"),
    "CCITT RLE TIFF compression (2)": lambda: _pil_tiff("1", compression="tiff_ccitt"),
    "YCbCr TIFF": lambda: _pil_tiff("YCbCr"),
    "BigTIFF": lambda: _pil_tiff("RGB", big_tiff=True, compression="tiff_lzw"),
    "signed-integer TIFF samples": lambda: tiff_bytes(
        np.arange(-60, 60, dtype=np.int64).reshape(8, 15, 1).astype(np.uint8),
        extra_tags=[(339, 3, [2])]),
    "planar YCbCr JPEG-in-TIFF": lambda: jpeg_tiff(
        _ycc(np.random.default_rng(8).integers(0, 256, (8, 16, 3)).astype(np.uint8)), 6,
        planar=2, rows_per_strip=8),
    "old-style (pre-TIFF 6.0) LZW": lambda: tiff_bytes(
        np.random.default_rng(9).integers(0, 256, (9, 11, 3)).astype(np.uint8), photometric=2,
        compression="lzw_old"),
    "CIELab TIFF": lambda: _pil_tiff("LAB"),
    "SGI LogL TIFF": lambda: tiff_bytes(
        np.random.default_rng(10).integers(0, 65536, (6, 9, 1)).astype(np.uint16), bits=16,
        photometric=32844, compression="sgilog"),
    "SGI LogLuv TIFF (16-bit": lambda: _logluv(16),
    "SGI LogLuv TIFF (8-bit": lambda: _logluv(8),
}


@pytest.mark.parametrize("kind", sorted(FORMERLY_REFUSED))
def test_formerly_refused_kinds_decode_bit_equal(kind):
    _assert_bit_equal(FORMERLY_REFUSED[kind]())


def _sample_format(fmt, bits=8, spp=1):
    return tiff_bytes(np.zeros((5, 6, spp), np.uint16 if bits == 16 else np.uint8), bits=bits,
                      photometric=2 if spp == 3 else 1, extra_tags=[(339, 3, [fmt] * spp)])


def _chunked(bits, photometric, compression, spp=1, **kw):
    """A file of ``bits`` samples whose strip holds stand-in bytes (cv2's
    refusal comes before it reads them)."""
    return tiff_bytes(np.zeros((4, 5, spp), np.uint16), bits=bits, photometric=photometric,
                      compression=compression, rows_per_strip=4, chunks=[bytes(64)], **kw)


# what cv2 gives None on; the first eight were refused as unsupported
# before the port held them to cv2's None
CV2_FAILS = {
    "ZSTD TIFF compression (50000)": lambda: _pil_tiff("L", compression="zstd"),
    "LZMA TIFF compression (34925)": lambda: _patched_compression(34925),
    "WebP TIFF compression (50001)": lambda: _patched_compression(50001),
    "old-style JPEG TIFF compression (6)": lambda: _patched_compression(6),
    "floating-point TIFF samples": lambda: _pil_tiff("F"),
    "32-bit TIFF samples": lambda: _pil_tiff("I"),
    "BigTIFF with no directory": lambda: b"II+\x00\x08\x00\x00\x00" + bytes(16),
    "planar YCbCr JPEG-in-TIFF without its planes' strips": _planar_ycbcr_jpeg,
    "LERC TIFF compression (34887)": lambda: _patched_compression(34887),
    "PixarLog TIFF compression (32909)": lambda: _patched_compression(32909),
    "JBIG TIFF compression (34661)": lambda: _patched_compression(34661),
    "untyped TIFF samples": lambda: _sample_format(4),
    "complex integer TIFF samples": lambda: _sample_format(5, 16),
    "16-bit floating-point TIFF samples": lambda: _sample_format(3, 16, 3),
    "8-bit floating-point TIFF samples": lambda: _sample_format(3),
    "ICCLab TIFF": lambda: tiff_bytes(np.zeros((5, 6, 3), np.uint8), photometric=9),
    "ITULab TIFF": lambda: tiff_bytes(np.zeros((5, 6, 3), np.uint8), photometric=10),
    "colour filter array TIFF": lambda: tiff_bytes(np.zeros((5, 6, 1), np.uint8),
                                                   photometric=32803),
    "planar CIELab": lambda: tiff_bytes(np.zeros((5, 6, 3), np.uint8), photometric=8, planar=2),
    "CIELab of 4 samples": lambda: tiff_bytes(np.zeros((5, 6, 4), np.uint8), photometric=8,
                                              extra_samples=0),
    "LogL TIFF without SGI LogL compression": lambda: tiff_bytes(
        np.zeros((4, 5, 1), np.uint16), bits=16, photometric=32844),
    "LogLuv at 32 bits": lambda: _chunked(32, 32845, "sgilog", spp=3),
    "ThunderScan 4-bit gray": lambda: _chunked(4, 1, "none",
                                               extra_tags=[(259, 3, [32809])]),
    "NeXT 2-bit gray": lambda: _chunked(2, 1, "none", extra_tags=[(259, 3, [32766])]),
    "planar YCbCr JPEG-in-TIFF subsampled 2x2": lambda: jpeg_tiff(
        np.zeros((8, 16, 3), np.uint8), 6, planar=2, subsampling_tag=False),

    "gray at 4 bits": lambda: tiff_bytes(np.zeros((5, 6, 1), np.uint8), bits=4),
    "gray at 2 bits": lambda: tiff_bytes(np.zeros((5, 6, 1), np.uint8), bits=2, photometric=0),
    "palette at 2 bits": lambda: tiff_bytes(np.zeros((5, 6, 1), np.uint8), bits=2, photometric=3,
                                            colormap=np.zeros((4, 3), np.uint16)),
    "RGB at 4 bits": lambda: tiff_bytes(np.zeros((5, 6, 3), np.uint8), bits=4, photometric=2),
    "truncated strip": lambda: tiff_bytes(np.ones((30, 40, 3), np.uint8), photometric=2)[:2000],
    "truncated header": lambda: b"II*\x00\x08\x00",
    "directory past the end": lambda: b"II*\x00\xff\x00\x00\x00" + bytes(8),
    "differing BitsPerSample": lambda: _patched_bits(),
}


def _patched_bits():
    data = bytearray(tiff_bytes(np.zeros((5, 6, 3), np.uint8), photometric=2))
    i = data.find(struct.pack("<HHH", 8, 8, 8))
    data[i + 4 : i + 6] = struct.pack("<H", 16)
    return bytes(data)


@pytest.mark.parametrize("kind", sorted(CV2_FAILS))
def test_value_error_where_cv2_fails(kind):
    data = CV2_FAILS[kind]()
    assert _cv2(data) is None
    with pytest.raises(ValueError) as err:
        image_io.imdecode(data)
    assert not isinstance(err.value, image_io.UnsupportedImageFormat)


@pytest.mark.parametrize("compression", ["lzw", "deflate", "packbits"])
def test_damaged_compressed_data_raises(compression):
    """A deliberate divergence: libtiff's RGBA reader does not stop on a
    strip that fails to decode, so cv2 returns what was decoded (and stale
    buffer contents); the port raises ``ValueError`` naming the damage."""
    img = np.random.default_rng(5).integers(0, 256, (20, 30, 3)).astype(np.uint8)
    data = bytearray(tiff_bytes(img, photometric=2, compression=compression, rows_per_strip=20))
    filler = {"lzw": b"\xff", "deflate": b"\x00", "packbits": b"\x80"}[compression]
    data[40:400] = filler * 360  # the middle of the one strip
    assert _cv2(bytes(data)) is not None
    with pytest.raises(ValueError):
        image_io.imdecode(bytes(data))


def _old_style_lzw_stub():
    """A new-style LZW strip whose first bytes say old style (Clear, least
    significant bit first): the rest is no old-style code stream."""
    img = np.zeros((4, 5, 1), np.uint8)
    data = bytearray(tiff_bytes(img, compression="lzw", rows_per_strip=4))
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    for i in range(n):
        e = ifd + 2 + 12 * i
        if struct.unpack_from("<H", data, e)[0] == 273:
            (off,) = struct.unpack_from("<I", data, e + 8)
            data[off : off + 2] = b"\x00\x01"
    return bytes(data)


# each file and the words of the port's ValueError
UNDECODABLE_STRIPS = {
    "damaged old-style LZW": (_old_style_lzw_stub, "damaged LZW data"),
    "damaged SGI LogL rows": (lambda: tiff_bytes(
        np.zeros((4, 5, 1), np.uint16), bits=16, photometric=32844, compression="sgilog",
        chunks=[bytes([3, 1, 2])]), "damaged SGI LogL data"),
    "an unknown compression": (lambda: _patched_compression(40000),
                               r"unknown TIFF compression \(40000\)"),
}


@pytest.mark.parametrize("kind", sorted(UNDECODABLE_STRIPS))
def test_strips_libtiff_fails_raise_where_cv2_returns_its_buffer(kind):
    """The same deliberate divergence for strips no codec decodes: libtiff
    fails each and its RGBA reader goes on, so cv2 returns its buffer as
    it was; the port raises ``ValueError``."""
    make, words = UNDECODABLE_STRIPS[kind]
    data = make()
    assert _cv2(data) is not None
    with pytest.raises(ValueError, match=words):
        image_io.imdecode(data)


@pytest.mark.parametrize("bits,spp,tile", [(8, 1, (16, 16)), (8, 3, (32, 48)), (16, 1, (48, 16)),
                                           (8, 1, (32, 32)), (16, 1, (16, 32)), (8, 3, (64, 16))])
def test_uncompressed_tiles_decode_where_cv2_does(bits, spp, tile):
    """libtiff 4.7.1 under OpenCV 5.0 fails every uncompressed tile whose
    byte size is not a multiple of 1024 ("Invalid tile byte count ...
    Expected 256, got 1024" for 16x16 gray): the port raises there, and
    decodes bit-equal where the size is one."""
    img = np.random.default_rng(6).integers(0, 1 << bits, (20, 21, spp))
    data = tiff_bytes(img.astype(np.uint16 if bits == 16 else np.uint8), bits=bits,
                      photometric=2 if spp == 3 else 1, tile=tile)
    if (tile[0] * tile[1] * spp * bits // 8) % 1024:
        assert _cv2(data) is None
        with pytest.raises(ValueError, match="multiple of 1024"):
            image_io.imdecode(data)
    else:
        _assert_bit_equal(data)


def test_lzw_round_trips_long_strings_and_a_full_table():
    """The host LZW decoder on 4094-entry tables (Clear mid-strip, 12-bit
    codes) and on strings longer than the output."""
    from rcnn_ocr_tpu_torch.native import tiff_lzw_decode

    rng = np.random.default_rng(7)
    raw = bytes(rng.integers(0, 256, 20000).astype(np.uint8)) + bytes(5000)
    assert tiff_lzw_decode(lzw(raw), len(raw)) == raw
    assert tiff_lzw_decode(lzw(raw), 12345) == raw[:12345]
    with pytest.raises(ValueError, match="short"):
        tiff_lzw_decode(lzw(raw), len(raw) + 1)


def test_threads_decode_alike():
    datas = [(FIXTURES / n).read_bytes() for n in NAMES]
    serial = [image_io.imdecode(d) for d in datas]
    start = threading.Barrier(8)

    def work(k):
        start.wait()
        return [image_io.imdecode(d) for d in datas[k::8]]

    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(work, range(8)))
    for k, part in enumerate(parts):
        for got, want in zip(part, serial[k::8]):
            np.testing.assert_array_equal(got, want)


# --- TIFF datasets through the entry points ---------------------------------------------

def test_run_training_reads_tiff_lines_as_their_pixels(tmp_path):
    """One epoch on TIFF lines (LZW and Deflate with the predictor, PackBits,
    16-bit) equals one on PNGs holding cv2's decode of them: the loader and
    the width buckets read the TIFFs to the same pixels and sizes."""
    from rcnn_ocr_tpu_torch.training.train import run_training
    from tests.helpers import render_text_image
    from tests.test_torch_port_train_loop import TOKENS, _cfg

    rng = np.random.default_rng(0)
    labels = ["".join(rng.choice(list("abcdefghij"), size=int(rng.integers(1, 5))))
              for _ in range(24)]
    (tmp_path / "charset.txt").write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    results = {}
    for ext in ("tif", "png"):
        root = tmp_path / ext
        root.mkdir()
        draw = np.random.default_rng(1)
        with open(root / "labels.csv", "w", newline="", encoding="utf-8") as f:
            for i, label in enumerate(labels):
                img = render_text_image(label, h=24, w=int(draw.integers(40, 160)), rng=draw)
                kind = i % 4
                if kind == 3:
                    data = tiff_bytes(img.astype(np.uint16) * 257, bits=16, photometric=2,
                                      compression="deflate", predictor=2)
                else:
                    data = tiff_bytes(img, photometric=2, predictor=2 if kind < 2 else 1,
                                      compression=("lzw", "deflate", "packbits")[kind],
                                      orientation=None)
                if ext == "png":  # the JAX package's decode of the same TIFF
                    data = image_io.png_encode(jax_tf.imdecode_cv2(data))
                (root / f"img_{i:04d}.{ext}").write_bytes(data)
                csv.writer(f).writerow([f"img_{i:04d}.{ext}", label])
        env = {"tmp": tmp_path, "charset": str(tmp_path / "charset.txt"),
               "csv": str(root / "labels.csv"), "root": str(root)}
        results[ext] = run_training(_cfg(env, f"run_{ext}", epochs=1, head="both"),
                                    device="cpu")
    assert np.isfinite(results["tif"]["val_loss"])
    assert results["tif"]["val_loss"] == results["png"]["val_loss"]
    assert results["tif"]["val_acc"] == results["png"]["val_acc"]


def test_the_card_smoke_holds_the_same_cv2_none_and_refused_files():
    import chip_smoke

    # no TIFF cv2 reads is refused any more
    assert chip_smoke.TIFF_CV2_NONE == CV2_NONE and not hasattr(chip_smoke, "TIFF_REFUSED")


# --- SGI LogLuv and the predictor on subsampled YCbCr -------------------------------------

@pytest.mark.parametrize("name", VARIANT_NAMES)
def test_variant_fixture_is_bit_equal_to_cv2(name):
    with np.load(VARIANTS / "expected.npz") as z:
        want = z[name]
    got = _assert_bit_equal((VARIANTS / name).read_bytes())
    np.testing.assert_array_equal(got, want)


def test_variant_fixtures_cover_the_paths():
    for kind in ("logluv32_16_strips", "logluv32_8_tiles_mm", "logluv24_8_strips",
                 "logluv24_16_tiles", "ycbcr22_pred2", "ycbcr42_pred2_deflate_strips",
                 "ycbcr44_pred2_lzw_tiles", "luv32_line", "luv24_line"):
        assert any(kind in n for n in VARIANT_NAMES), kind
    assert sum(p.stat().st_size for p in VARIANTS.iterdir()) < 64 * 1024


def _luv_kw(rng):
    tile = (16, 16) if rng.random() < 0.3 else None
    return dict(bits=int(rng.choice([1, 8, 16])), tile=tile,
                rows_per_strip=int(rng.integers(1, 9)), order=str(rng.choice(["<", ">"])))


@pytest.mark.parametrize("seed", range(4))
def test_logluv32_fuzz_is_bit_equal(seed):
    """Random 32-bit LogLuv values (mid luminances, black, negative signs,
    runs in each byte plane), 1, 8 or 16 bits a sample, strips or tiles."""
    rng = np.random.default_rng(2300 + seed)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        v = rng.integers(0, 1 << 32, (h, w), dtype=np.uint64).astype(np.uint32)
        mid = rng.random((h, w)) < 0.6
        v[mid] = (v[mid] & 0xFFFF) | (rng.integers(0x2800, 0x4900, mid.sum()).astype(np.uint32)
                                      << 16)
        if h > 1:
            v[1, : w // 2] = v[1, 0]  # a run
        _assert_bit_equal(logluv_tiff(v, **_luv_kw(rng)))


@pytest.mark.parametrize("group", range(4))
def test_logluv32_every_uv_byte_pair_is_bit_equal(group):
    """All 65,536 (u', v') byte pairs at four log luminances a group,
    spread from dark to past white."""
    les = np.linspace(0x2000, 0x4A00, 16).astype(np.uint32)[group::4]
    uv = np.arange(1 << 16, dtype=np.uint32)
    v = (les[:, None] << 16 | uv[None, :]).reshape(-1, 1024)
    _assert_bit_equal(logluv_tiff(v, rows_per_strip=64))


def test_logluv24_every_code_is_bit_equal():
    """All 2**24 LogLuv24 codes: every 10-bit log luminance with every
    14-bit (u', v') index, those past the table's 16,289 decoding neutral."""
    v = np.arange(1 << 24, dtype=np.uint32).reshape(4096, 4096)
    data = logluv_tiff(v, compression="sgilog24", bits=8, rows_per_strip=256)
    want = jax_tf.imdecode_cv2(data)
    got = image_io.imdecode(data)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(2))
def test_logluv24_fuzz_is_bit_equal(seed):
    rng = np.random.default_rng(2400 + seed)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        v = rng.integers(0, 1 << 24, (h, w)).astype(np.uint32)
        _assert_bit_equal(logluv_tiff(v, compression="sgilog24", **_luv_kw(rng)))


@pytest.mark.parametrize("compression", ["sgilog", "sgilog24"])
def test_logluv_short_data_raises(compression):
    """A strip short of its rows: libtiff fails the row ("Not enough data")
    and its RGBA reader goes on with the buffer as it was; the port raises
    ``ValueError``, as for the other damaged strips."""
    v = np.random.default_rng(3).integers(0, 1 << 24, (6, 9)).astype(np.uint32)
    data = logluv_tiff(v, compression=compression, rows_per_strip=6)
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    data = bytearray(data)
    for i in range(n):  # the strip's byte count halved
        e = ifd + 2 + 12 * i
        if struct.unpack_from("<H", data, e)[0] == 279:
            count = struct.unpack_from("<I", data, e + 8)[0]
            struct.pack_into("<I", data, e + 8, count // 2)
    with pytest.raises(ValueError, match="LogLuv"):
        image_io.imdecode(bytes(data))


@pytest.mark.parametrize("seed", range(4))
def test_ycbcr_predictor_fuzz_is_bit_equal(seed):
    """Subsampled YCbCr with the horizontal predictor: libtiff undoes it on
    the data-unit bytes, three apart, a scanline (strips) or a tile row
    (tiles) at a time, where those pieces are whole three-byte pixels and
    the strip or tile whole pieces; elsewhere it refuses and its RGBA
    reader converts the bytes as coded.  cv2 reads them all."""
    rng = np.random.default_rng(2500 + seed)
    for _ in range(15):
        h, w = (int(v) for v in rng.integers(1, 45, 2))
        hs, vs = [(2, 2), (2, 1), (1, 2), (4, 2), (4, 4), (4, 1)][int(rng.integers(0, 6))]
        data = tiff_bytes(_ycc_image(rng, h, w), photometric=6, predictor=2,
                          compression=str(rng.choice(["lzw", "deflate", "zip"])),
                          subsampling=(hs, vs),
                          tile=((int(rng.choice([16, 32])), int(rng.choice([16, 32])))
                                if rng.random() < 0.4 else None),
                          rows_per_strip=int(rng.integers(1, h + 1)),
                          order=str(rng.choice(["<", ">"])))
        _assert_bit_equal(data)


# --- JPEG-compressed gray + alpha: two-component frames ----------------------------------

GRAY_ALPHA = FIXTURES.parent / "tiff_gray_alpha"
GRAY_ALPHA_NAMES = sorted(p.name for p in GRAY_ALPHA.glob("*.tif"))


@pytest.mark.parametrize("name", [n for n in GRAY_ALPHA_NAMES if n.startswith("pil_la_jpeg")])
def test_fault_gray_alpha_jpeg_tiff_is_bit_equal_to_cv2(name):
    """PIL's ``LA`` TIFF with JPEG compression codes two-component frames;
    libtiff decodes them without colour conversion and cv2 shows the gray
    sample.  The port refused the frame ("2-component JPEG")."""
    with np.load(GRAY_ALPHA / "expected.npz") as z:
        want = z[name]
    got = _assert_bit_equal((GRAY_ALPHA / name).read_bytes())
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] == got[..., 1]).all() and (got[..., 1] == got[..., 2]).all()


@pytest.mark.parametrize("name", [n for n in GRAY_ALPHA_NAMES if not n.startswith("pil_la")])
def test_planar_gray_alpha_jpeg_tiff_is_bit_equal_to_cv2(name):
    with np.load(GRAY_ALPHA / "expected.npz") as z:
        want = z[name]
    np.testing.assert_array_equal(_assert_bit_equal((GRAY_ALPHA / name).read_bytes()), want)


def test_gray_alpha_fixtures_cover_the_edges():
    for kind in ("strips_", "strips8_", "tiles16_", "q20_", "8x8", "9x8", "8x9", "9x9", "planar"):
        assert any(kind in n for n in GRAY_ALPHA_NAMES), kind
    assert sum(p.stat().st_size for p in GRAY_ALPHA.iterdir()) < 64 * 1024


@pytest.mark.parametrize("seed", range(2))
def test_gray_alpha_jpeg_tiff_fuzz_is_bit_equal(seed):
    rng = np.random.default_rng(2600 + seed)
    for _ in range(8):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        la = rng.integers(0, 256, (h, w, 2)).astype(np.uint8)
        kw = dict(compression="jpeg", quality=int(rng.integers(5, 100)))
        if rng.random() < 0.4:
            kw["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
        else:
            kw["strip_size"] = int(rng.integers(1, h + 1)) * w * 2
        bio = io.BytesIO()
        Image.fromarray(la, "LA").save(bio, format="TIFF", **kw)
        _assert_bit_equal(bio.getvalue())


def test_standalone_two_component_jpeg_still_raises():
    """The frame of a gray + alpha strip, its tables spliced in, as a JPEG
    file: cv2 gives None (libjpeg has no colour conversion for it)."""
    data = (GRAY_ALPHA / "pil_la_jpeg_strips_23x61.tif").read_bytes()
    img = Image.open(io.BytesIO(data))
    tables = img.tag_v2[347]
    start, count = img.tag_v2[273][0], img.tag_v2[279][0]
    stream = tables[:-2] + data[start + 2 : start + count]
    assert stream[:2] == b"\xff\xd8"
    assert _cv2(stream) is None
    with pytest.raises(ValueError, match="2-component JPEG"):
        image_io.imdecode(stream)
