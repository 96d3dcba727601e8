"""The port's Netpbm decoder (``data/pnm.py``) vs the JAX package's
``imdecode_cv2``, on the CPU.

* Every fixture of ``tests/torch_port_data/pnm/`` (P1-P6 in ASCII and
  binary with comments and odd spacing, maxval 1, 15, 100, 255, 1000 and
  65535, samples over maxval, PAM gray, RGB, black-and-white, 16-bit,
  inferred and repeated tuple types, cv2's own files): bit-equal to
  ``imdecode_cv2`` and to the pixels the card's smoke reads.
* A seeded fuzz over every magic, ASCII spacing, comment placement and
  maxval, with truncated and padded files: bit-equal wherever cv2 decodes,
  ``ValueError`` where it returns ``None``.
* OpenCV's rules, pinned: binary samples raw (maxval 100 gives 0..100, a
  16-bit sample its high byte), ASCII samples scaled (maxval 15: 1 -> 17,
  5 -> 85), PBM's 1 black, PAM's RGB with red and blue swapped; sides
  over 1 << 20 or over 1 << 30 pixels fail, as in cv2.
* PAM's alpha tuple types raise ``UnsupportedImageFormat`` naming them:
  OpenCV's conversion of them reads memory it never wrote.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from rcnn_ocr_tpu.data import transforms as jax_tf  # noqa: E402
from rcnn_ocr_tpu_torch.data import image_io  # noqa: E402
from tests.torch_port_data.make_web_fixtures import pam_bytes, pnm_bytes  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "pnm"
NAMES = sorted(p.name for p in FIXTURES.iterdir() if p.suffix in (".pbm", ".pgm", ".ppm", ".pam"))


@pytest.fixture(scope="module")
def expected():
    with np.load(FIXTURES / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def _cv2(data):
    try:
        return jax_tf.imdecode_cv2(data)
    except (ValueError, cv2.error):
        return None


def _assert_as_cv2(data, info=""):
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


# --- fixtures ---------------------------------------------------------------------------

def test_fixtures_cover_the_paths(expected):
    kinds = ("p1_spaced_comments", "p1_packed", "p4_", "p5_over_maxval", "p2_over_maxval",
             "p7_gray", "p7_rgb_16bit", "p7_blackandwhite", "p7_inferred", "p7_two_tupltypes",
             "cv2_bin", "cv2_ascii", "pgm_line_")
    for kind in kinds:
        assert any(kind in n for n in NAMES), kind
    for magic in (2, 3, 5, 6):
        for maxval in (15, 100, 255, 1000, 65535):
            assert any(n.startswith(f"p{magic}_maxval{maxval}_") for n in NAMES), (magic, maxval)
    assert sorted(expected) == NAMES
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 64 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_bit_equal_to_cv2(name, expected):
    want = jax_tf.imread_cv2(str(FIXTURES / name))
    got = image_io.imread(str(FIXTURES / name))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, expected[name])


def test_image_size_falls_back_to_a_decode_as_jax_sizes_the_fixtures():
    for name in NAMES:
        path = str(FIXTURES / name)
        assert image_io.image_size(path) == jax_tf.image_size(path), name


# --- OpenCV's rules ---------------------------------------------------------------------

RULES = {  # file -> the gray (or RGB) values cv2 gives
    "binary maxval 100 is raw": (b"P5\n3 1\n100\n" + bytes([0, 50, 100]), [0, 50, 100]),
    "binary over maxval is raw": (b"P5\n3 1\n100\n" + bytes([0, 150, 200]), [0, 150, 200]),
    "binary 16-bit keeps the high byte": (b"P5\n2 1\n65535\n\x12\x34\xff\x01", [0x12, 0xFF]),
    "ASCII maxval 15 is scaled": (b"P2\n3 1\n15\n1 5 15\n", [17, 85, 255]),
    "ASCII over maxval is clamped": (b"P2\n3 1\n15\n1 5 20\n", [17, 85, 255]),
    "ASCII 16-bit keeps the high byte": (b"P2\n3 1\n1000\n1 500 1000\n", [0, 1, 3]),
    "PBM 1 is black": (b"P1\n4 1\n0 1 0 1\n", [255, 0, 255, 0]),
    "PBM digits need no spaces": (b"P1\n4 1\n0101", [255, 0, 255, 0]),
    "packed PBM": (b"P4\n10 1\n\xa0\xc0", [0, 255, 0] + [255] * 5 + [0, 0]),
    "one CR ends the maxval": (b"P5\r\n3 1\r\n255\r\n\x07\x08\x09", [10, 7, 8]),
    "a letter ends a number": (b"P2\n2 1\n255\n12a13\n", [12, 13]),
    "PAM gray maxval 1 is bits": (pam_bytes(np.array([[[160], [0], [0]]]), 1, b"GRAYSCALE"),
                                  [255, 0, 255]),
    "PAM RGB swaps red and blue": (pam_bytes(np.array([[[10, 20, 30]]]), 255, b"RGB"),
                                   [[30, 20, 10]]),
}


@pytest.mark.parametrize("case", sorted(RULES))
def test_samples_read_as_cv2_reads_them(case):
    data, values = RULES[case]
    want = np.array(values, np.uint8)
    want = np.repeat(want[:, None], 3, axis=1) if want.ndim == 1 else want
    np.testing.assert_array_equal(jax_tf.imdecode_cv2(data)[0], want)
    np.testing.assert_array_equal(image_io.imdecode(data)[0], want)


CV2_FAILS = {
    "ASCII ending on a digit": b"P2\n3 1\n15\n1 5 15",
    "ASCII with a comment, ending on a digit": b"P2\n3 1\n15\n1 5 # c\n15",
    "a comment inside the header's numbers": b"P5\n3# hi\n 1\n255\n\x07\x08\x09",
    "maxval 0": b"P5\n3 1\n0\n\x07\x08\x09",
    "maxval 65536": b"P5\n3 1\n65536\n" + bytes(6),
    "binary raster one byte short": b"P5\n3 1\n255\n\x07\x08",
    "PAM with an unknown tuple type": pam_bytes(np.zeros((1, 2, 1)), 255, b"FOO"),
    "PAM tuple type against its depth": pam_bytes(np.zeros((1, 2, 1)), 255, b"RGB"),
    "PAM depth 4 without a tuple type": pam_bytes(np.zeros((1, 2, 4)), 255, b""),
    "PAM lower-case keys": b"P7\nwidth 2\nheight 1\ndepth 1\nmaxval 255\nENDHDR\n\x01\x02",
    "PAM ENDHDR and a space": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR \n\x01\x02",
    "PAM number with a plus sign": b"P7\nWIDTH +2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x01\x02",
    "PAM without MAXVAL": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nENDHDR\n\x01\x02",
    "PAM magic and a space": b"P7 WIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x01\x02",
}


@pytest.mark.parametrize("kind", sorted(CV2_FAILS))
def test_value_error_where_cv2_fails(kind):
    data = CV2_FAILS[kind]
    assert _cv2(data) is None
    with pytest.raises(ValueError) as err:
        image_io.imdecode(data)
    assert not isinstance(err.value, image_io.UnsupportedImageFormat)


SIZE_LIMIT = {  # case: (file, whether cv2 decodes it)
    "P5 1 << 20 wide": (b"P5\n1048576 1\n255\n" + bytes(1 << 20), True),
    "P5 one pixel wider than 1 << 20": (b"P5\n1048577 1\n255\n" + bytes((1 << 20) + 1), False),
    "P1 one pixel taller than 1 << 20": (b"P1\n1 1048577\n" + b"0" * ((1 << 20) + 1) + b"\n",
                                          False),
    "P4 over 1 << 30 pixels": (b"P4\n32768 32769\n" + bytes(64), False),
    "PAM one pixel wider than 1 << 20": (pam_bytes(np.zeros((1, (1 << 20) + 1, 1)), 255,
                                                   b"GRAYSCALE"), False),
    "PAM over 1 << 30 pixels": (b"P7\nWIDTH 32768\nHEIGHT 32769\nDEPTH 1\nMAXVAL 255\n"
                                b"ENDHDR\n" + bytes(64), False),
}


@pytest.mark.parametrize("case", sorted(SIZE_LIMIT))
def test_sides_past_opencv_limit_raise_value_error(case):
    """OpenCV refuses sides over 1 << 20 and images over 1 << 30 pixels
    before it reads the raster; so does the port, a raster present or not."""
    data, decodes = SIZE_LIMIT[case]
    assert _assert_as_cv2(data, case) == decodes


@pytest.mark.parametrize("tupltype,depth", [(b"GRAYSCALE_ALPHA", 2), (b"RGB_ALPHA", 4),
                                            (b"BLACKANDWHITE_ALPHA", 2)])
def test_pam_alpha_tuple_types_are_refused_naming_them(tupltype, depth):
    data = pam_bytes(np.full((2, 3, depth), 7), 255 if depth != 2 or b"BLACK" not in tupltype
                     else 1, tupltype)
    with pytest.raises(image_io.UnsupportedImageFormat, match=tupltype.decode()):
        image_io.imdecode(data)


@pytest.mark.parametrize("cut", ["half", "last byte"])
@pytest.mark.parametrize("magic", [3, 5, 6])
def test_truncated_file_raises_value_error(magic, cut):
    img = np.random.default_rng(3).integers(0, 256, (6, 9, 3) if magic != 5 else (6, 9))
    data = pnm_bytes(img, magic, 255)
    data = data[: len(data) // 2] if cut == "half" else data[:-1]
    assert _cv2(data) is None
    with pytest.raises(ValueError) as err:
        image_io.imdecode(data)
    assert not isinstance(err.value, image_io.UnsupportedImageFormat)


# --- fuzz -------------------------------------------------------------------------------

def _random_pnm(rng):
    magic = int(rng.integers(1, 8))
    h, w = (int(v) for v in rng.integers(1, 12, 2))
    maxval = int(rng.choice([1, 15, 100, 255, 1000, 65535]))
    comment = (b"", b"# c\n", b"#x\r", b"  # a comment\n")[int(rng.integers(0, 4))]
    sep = (b" ", b"  ", b"\t", b"\n", b"\r\n")[int(rng.integers(0, 5))]
    if magic == 7:
        tupl = (b"GRAYSCALE", b"RGB", b"BLACKANDWHITE", b"")[int(rng.integers(0, 4))]
        depth = 3 if tupl == b"RGB" or (tupl == b"" and rng.random() < 0.5) else 1
        if tupl == b"BLACKANDWHITE" and rng.random() < 0.7:
            maxval = 1
        data = pam_bytes(rng.integers(0, maxval + 1, (h, w, depth)), maxval, tupl,
                         extra=comment if comment.endswith(b"\n") else b"")
    elif magic in (1, 4):
        data = pnm_bytes(rng.integers(0, 2, (h, w)), magic, sep=sep, comment=comment,
                         packed=bool(rng.random() < 0.3))
    else:
        if maxval == 1:
            maxval = 255
        top = maxval if rng.random() < 0.9 else min(65535, maxval * 2)
        img = rng.integers(0, top + 1, (h, w, 3) if magic in (3, 6) else (h, w))
        if magic in (5, 6) and maxval <= 255:
            img = np.minimum(img, 255)
        data = pnm_bytes(img, magic, maxval, sep=sep, comment=comment)
    r = rng.random()
    if r < 0.1:
        data = data[:-1]
    elif r < 0.15:
        data = data[: len(data) // 2]
    elif r < 0.2:
        data += b"trailing"
    return data, (magic, h, w, maxval, comment, sep)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_is_bit_equal(seed):
    rng = np.random.default_rng(1800 + seed)
    decoded = sum(_assert_as_cv2(*_random_pnm(rng)) for _ in range(60))
    assert decoded >= 40


@pytest.mark.parametrize("ext", [".pbm", ".pgm", ".ppm", ".pam", ".pnm"])
def test_cv2_written_files_are_bit_equal(ext):
    rng = np.random.default_rng(len(ext) + ord(ext[2]))
    for k in range(4):
        img = rng.integers(0, 256, (int(rng.integers(1, 30)), int(rng.integers(1, 30)), 3),
                           dtype=np.uint8)
        src = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if ext in (".pbm", ".pgm") else img
        for binary in (1, 0):
            ok, enc = cv2.imencode(ext, src, [cv2.IMWRITE_PXM_BINARY, binary])
            assert ok
            assert _assert_as_cv2(enc.tobytes(), (ext, k, binary))
