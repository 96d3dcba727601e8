"""The port's JPEG decoder vs the JAX package's ``imdecode_cv2``, on the CPU.

* Every fixture of ``tests/torch_port_data/jpeg/`` (4:4:4, 4:2:2, 4:2:0,
  4:4:0, 4:1:1, gray, restart markers, EXIF 3/6/8, PIL's optimized tables,
  Adobe RGB, a frame with no DHT, a damaged frame, 64 text lines;
  progressive from cv2, PIL and custom scan scripts, cut short after or
  inside a scan; arithmetic-coded sequential and progressive, with DAC;
  CMYK and YCCK): bit-equal to ``imdecode_cv2`` and to the cv2 pixels the
  card's smoke reads (``expected.npz``).
* A seeded fuzz of sizes (odd and even, 1 to 70 pixels a side), qualities
  and subsamplings written by ``cv2.imencode`` and by PIL: bit-equal; the
  same for progressive streams (cv2 and PIL at each subsampling, with
  restarts), progressive streams cut short after each scan or inside one
  (libjpeg's block smoothing), and, from ``jpeg_writer.c`` built against
  the system libjpeg (these skip only where no ``jpeglib.h`` is found),
  custom scan scripts, arithmetic coding and CMYK / YCCK; damaged
  progressive and arithmetic data decode as cv2 decodes it.
* Lossless frames (SOF3, written by the fixture script's own encoder):
  the fixtures and a seeded fuzz over predictors, point transforms,
  precisions, restart intervals, scans, sampling factors, markers and
  component ids, bit-equal where cv2 decodes and ``ValueError`` where it
  gives ``None`` (gray, YCbCr and YCCK frames, precisions over 8, restart
  intervals that are no whole number of rows).
* Where cv2 gives ``None`` the port raises ``ValueError`` naming the
  variant, as JAX's ``imdecode_cv2`` does: hierarchical, 12-bit and
  arithmetic-coded lossless frames, DNL heights, lossless gray and YCbCr
  (the ``none_*`` fixtures too); the variants this decoder used to refuse
  (progressive from cv2 and PIL, arithmetic, CMYK) decode bit-equal; a
  truncated stream raises ``ValueError`` as JAX's does, and one cut short
  but closed by an EOI decodes as cv2 does (zero-filled).
* Frames with no DHT segment (Motion-JPEG) decode with the standard
  tables, and a seeded fuzz of damaged entropy data (bytes changed, runs
  of garbage, restart markers renumbered or dropped) decodes bit-equal to
  cv2, which decodes it with warnings, or raises where cv2 fails.
* ``image_size`` equals the decoded shape and JAX's for EXIF 1-8.
* Decodes from eight threads at once equal the serial ones.
* JPEG datasets with no further change: ``OCRInference.predict`` on JPEG
  paths (progressive JPEG and TIFF lines among them) and the eval CLI give
  JAX's strings and report; ``run_training`` on JPEG lines equals a run on
  PNGs of the same (cv2-decoded) pixels.
"""

import csv
import io
import shutil
import struct
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rcnn_ocr_tpu.data import transforms as jax_tf  # noqa: E402
from rcnn_ocr_tpu_torch.data import image_io  # noqa: E402
from tests.test_torch_port_beam_engine import IMG_H, IMG_W, MAX_LEN, _images, files  # noqa: E402,F401
from tests.torch_port_data.make_jpeg_fixtures import (  # noqa: E402
    CV2_NONE, JFIF, adobe, lossless_jpeg)

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "jpeg"
NAMES = sorted(p.name for p in FIXTURES.glob("*.jpg") if p.name not in CV2_NONE)
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@pytest.fixture(scope="module")
def expected():
    with np.load(FIXTURES / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def _smooth(rng, h, w, channels=3):
    img = rng.integers(0, 256, (h, w, channels)).astype(np.uint8)
    if min(h, w) >= 3:
        img = cv2.GaussianBlur(img, (3, 3), 0).reshape(h, w, channels)
    return img[:, :, 0].copy() if channels == 1 else img


def _cv2_jpeg(img, quality=90, sampling="420", **flags):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    for key, val in flags.items():
        params += [getattr(cv2, key), val]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _pil_jpeg(img, mode="RGB", **kw):
    bio = io.BytesIO()
    Image.fromarray(img).convert(mode).save(bio, format="JPEG", **kw)
    return bio.getvalue()


def _has_jpeglib() -> bool:
    if shutil.which("gcc") is None:
        return False
    probe = subprocess.run(["gcc", "-E", "-x", "c", "-"], input="#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    return probe.returncode == 0


@pytest.fixture(scope="module")
def writer():
    """``jpeg_writer.c`` built against the system libjpeg."""
    if not _has_jpeglib():
        pytest.skip("no jpeglib.h to build tests/torch_port_data/jpeg_writer.c against")
    from tests.torch_port_data.make_jpeg_fixtures import CWriter

    w = CWriter()
    yield w
    w.close()


def _assert_bit_equal(data):
    got = image_io.imdecode(data)
    want = jax_tf.imdecode_cv2(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


# --- fixtures and fuzz ----------------------------------------------------------------

def test_fixtures_cover_the_paths():
    kinds = ("s444", "s422", "s420", "s440", "s411", "gray", "rst", "exif3", "exif6", "exif8",
             "q50", "q100", "optimized", "adobe_rgb", "nodht", "damaged", "progressive",
             "pil_progressive", "ni_dc", "al2", "cut_after", "cut_inside", "arith_s",
             "arith_progressive", "dac", "cmyk", "ycck", "prog_line", "arith_line", "cmyk_line",
             "lossless_p1", "lossless_p2", "lossless_p3", "lossless_p4", "lossless_p5",
             "lossless_p6", "lossless_p7", "pt2", "rst2rows", "separate", "sub221111",
             "sub112112", "adobe0", "rgb_ids", "lossless_cmyk", "prec5", "lossless_line")
    for kind in kinds:
        assert any(kind in n for n in NAMES), kind
    assert sum(n.startswith("line_") for n in NAMES) == 64
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 512 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_bit_equal_to_cv2(name, expected):
    data = (FIXTURES / name).read_bytes()
    got = _assert_bit_equal(data)
    np.testing.assert_array_equal(got, expected[name])
    assert image_io.imread(str(FIXTURES / name)).shape == got.shape


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cv2_fuzz_is_bit_equal(sampling, seed):
    rng = np.random.default_rng(100 * seed + int(sampling))
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 71, 2))
        quality = int(rng.choice([10, 50, 75, 90, 95, 100]))
        flags = {}
        if rng.random() < 0.3:
            flags["IMWRITE_JPEG_RST_INTERVAL"] = int(rng.integers(1, 4))
        if rng.random() < 0.3:
            flags["IMWRITE_JPEG_OPTIMIZE"] = 1
        _assert_bit_equal(_cv2_jpeg(_smooth(rng, h, w), quality, sampling, **flags))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_fuzz_is_bit_equal(subsampling):
    rng = np.random.default_rng(7 + subsampling)
    for _ in range(10):
        h, w = (int(v) for v in rng.integers(1, 71, 2))
        quality = int(rng.choice([20, 75, 95]))
        _assert_bit_equal(_pil_jpeg(_smooth(rng, h, w), quality=quality, subsampling=subsampling,
                                    optimize=bool(rng.random() < 0.5)))


def test_gray_fuzz_is_bit_equal():
    rng = np.random.default_rng(11)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 71, 2))
        img = _smooth(rng, h, w, channels=1)
        _assert_bit_equal(_cv2_jpeg(img, int(rng.choice([50, 90])),
                                    IMWRITE_JPEG_RST_INTERVAL=int(rng.integers(0, 3))))
        _assert_bit_equal(_pil_jpeg(img, mode="L", quality=80))


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411"])
def test_progressive_fuzz_is_bit_equal(sampling):
    """cv2's and PIL's progressive streams (jpeg_simple_progression), with
    and without restart intervals."""
    rng = np.random.default_rng(300 + int(sampling))
    for _ in range(10):
        h, w = (int(v) for v in rng.integers(1, 71, 2))
        img = _smooth(rng, h, w)
        rst = int(rng.integers(0, 3))
        _assert_bit_equal(_cv2_jpeg(img, int(rng.choice([50, 85, 95])), sampling,
                                    IMWRITE_JPEG_PROGRESSIVE=1, IMWRITE_JPEG_RST_INTERVAL=rst))
        if sampling in ("444", "422", "420"):
            sub = {"444": 0, "422": 1, "420": 2}[sampling]
            _assert_bit_equal(_pil_jpeg(img, quality=int(rng.choice([60, 90])), subsampling=sub,
                                        progressive=True))
    gray = _smooth(rng, int(rng.integers(1, 60)), int(rng.integers(1, 60)), channels=1)
    _assert_bit_equal(_cv2_jpeg(gray, 80, IMWRITE_JPEG_PROGRESSIVE=1))


def _cuts(data):
    """The stream closed by EOI after each of its scans but the last, and
    halfway into each."""
    from tests.torch_port_data.make_jpeg_fixtures import sos_offsets

    ss = sos_offsets(data)
    return ([data[: ss[k]] + b"\xff\xd9" for k in range(1, len(ss))]
            + [data[: (ss[k] + ss[k + 1]) // 2] + b"\xff\xd9" for k in range(len(ss) - 1)])


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "gray"])
def test_cut_short_progressive_is_bit_equal(sampling):
    """A progressive stream cut after any scan, or inside one, and closed by
    EOI: libjpeg decodes what arrived and, its first coefficients being
    incomplete, smooths the blocks (jdcoefct.c: a 5x5 window of DC values,
    the rows below an interrupted scan taking the status before it).  The
    port gives cv2's pixels, or raises where cv2 fails."""
    rng = np.random.default_rng(400 + len(sampling))
    decoded = 0
    for _ in range(3):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        img = _smooth(rng, h, w, channels=1 if sampling == "gray" else 3)
        data = (_cv2_jpeg(img, 85, IMWRITE_JPEG_PROGRESSIVE=1) if sampling == "gray" else
                _cv2_jpeg(img, 85, sampling, IMWRITE_JPEG_PROGRESSIVE=1,
                          IMWRITE_JPEG_RST_INTERVAL=int(rng.integers(0, 2))))
        for cut in _cuts(data):
            try:
                want = jax_tf.imdecode_cv2(cut)
            except ValueError:
                with pytest.raises(ValueError):
                    image_io.imdecode(cut)
                continue
            np.testing.assert_array_equal(image_io.imdecode(cut), want)
            decoded += 1
    assert decoded >= 15


SCRIPTS = ["ni_dc", "al2", "simple"]


@pytest.mark.parametrize("script", SCRIPTS)
@pytest.mark.parametrize("arith", [False, True], ids=["huffman", "arithmetic"])
def test_scan_scripts_are_bit_equal(writer, script, arith):
    """``jpeg_writer``'s progressive scan scripts (non-interleaved DC,
    successive approximation down to Al 2, restart intervals), Huffman and
    arithmetic-coded, whole and cut short."""
    from tests.torch_port_data.make_jpeg_fixtures import SCRIPTS as SCANS

    rng = np.random.default_rng(500 + SCRIPTS.index(script) + 10 * arith)
    for _ in range(4):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        factors = str(rng.choice(["1,1,1,1,1,1", "2,2,1,1,1,1", "2,1,1,1,1,1", "1,2,1,1,1,1"]))
        opts = ["-p", "-f", factors, "-r", int(rng.integers(0, 4))]
        if script != "simple":
            opts += ["-s", SCANS[script]]
        if arith:
            opts.append("-a")
        data = writer(_smooth(rng, h, w), *opts)
        _assert_bit_equal(data)
        for cut in _cuts(data)[:: 3]:
            try:
                want = jax_tf.imdecode_cv2(cut)
            except ValueError:
                with pytest.raises(ValueError):
                    image_io.imdecode(cut)
                continue
            np.testing.assert_array_equal(image_io.imdecode(cut), want)


@pytest.mark.parametrize("opts", [[], ["-p"], ["-a"]], ids=["sequential", "progressive",
                                                          "arithmetic"])
def test_a_component_no_scan_coded_decodes_as_cv2(writer, opts):
    """A multi-scan stream cut after its first, single-component scan: the
    other components keep zero coefficients and no quantization table, so
    libjpeg renders them mid-gray (the decoder raised on them before)."""
    from tests.torch_port_data.make_jpeg_fixtures import SCRIPTS as SCANS
    from tests.torch_port_data.make_jpeg_fixtures import cut_after

    script = SCANS["ni_dc"] if "-p" in opts else "0:0:63:0:0;1:0:63:0:0;2:0:63:0:0"
    data = writer(_smooth(np.random.default_rng(12), 20, 30), "-s", script, *opts)
    _assert_bit_equal(cut_after(data, 1))


@pytest.mark.parametrize("conditioning", [None, "0,1,5", "2,6,12", "1,3,30"])
def test_arithmetic_fuzz_is_bit_equal(writer, conditioning):
    """Arithmetic-coded sequential frames (DAC conditioning as given, or
    none: the defaults), gray and colour, with restarts."""
    rng = np.random.default_rng(600 + (len(conditioning) if conditioning else 0))
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        gray = rng.random() < 0.3
        img = _smooth(rng, h, w, channels=1 if gray else 3)
        opts = ["-a", "-q", int(rng.choice([50, 90])), "-r", int(rng.integers(0, 3))]
        if not gray:
            opts += ["-f", str(rng.choice(["1,1,1,1,1,1", "2,2,1,1,1,1", "2,1,1,1,1,1"]))]
        if conditioning:
            opts += ["-d", conditioning]
        _assert_bit_equal(writer(img, *opts))


@pytest.mark.parametrize("space", ["cmyk", "ycck"])
def test_four_component_fuzz_is_bit_equal(writer, space):
    """CMYK and YCCK (Adobe transform 0 and 2, and CMYK with no Adobe
    marker), 4:4:4 and with Y and K subsampled, and PIL's CMYK."""
    rng = np.random.default_rng(700 + len(space))
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        img = _smooth(rng, h, w, channels=4)
        factors = str(rng.choice(["1,1,1,1,1,1,1,1", "2,2,1,1,1,1,2,2", "2,1,1,1,1,1,1,1"]))
        opts = ["-c", space, "-f", factors, "-q", int(rng.choice([60, 95]))]
        if space == "cmyk" and rng.random() < 0.5:
            opts.append("-n")
        _assert_bit_equal(writer(img, *opts))
    bio = io.BytesIO()
    Image.frombytes("CMYK", (23, 17), _smooth(rng, 17, 23, channels=4).tobytes()).save(
        bio, format="JPEG", quality=80)
    _assert_bit_equal(bio.getvalue())


@pytest.mark.parametrize("kind", ["progressive", "arithmetic", "arithmetic progressive"])
def test_damaged_variant_data_decodes_as_cv2(writer, kind):
    """Bytes of progressive and arithmetic-coded entropy data changed: the
    port gives cv2's pixels, or raises where cv2 fails."""
    from tests.torch_port_data.make_jpeg_fixtures import sos_offsets

    rng = np.random.default_rng(800 + len(kind))
    opts = {"progressive": ["-p"], "arithmetic": ["-a"],
            "arithmetic progressive": ["-a", "-p"]}[kind]
    decoded = 0
    for _ in range(30):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        data = bytearray(writer(_smooth(rng, h, w), *opts, "-r", int(rng.integers(0, 3))))
        start = sos_offsets(bytes(data))[0] + 10
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(start, len(data) - 2))
            if data[p] != 0xFF and data[p - 1] != 0xFF:
                data[p] = int(rng.integers(0, 255))
        try:
            want = jax_tf.imdecode_cv2(bytes(data))
        except ValueError:
            with pytest.raises(ValueError):
                image_io.imdecode(bytes(data))
            continue
        np.testing.assert_array_equal(image_io.imdecode(bytes(data)), want)
        decoded += 1
    assert decoded >= 10


def _segments(data):
    """(marker, start, end) of each header segment up to and including SOS."""
    i, out = 2, []
    while True:
        m, n = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        out.append((m, i, i + 2 + n))
        if m == 0xDA:
            return out
        i += 2 + n


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "gray"])
def test_frames_without_dht_use_the_standard_tables(sampling):
    rng = np.random.default_rng(13)
    for _ in range(4):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        if sampling == "gray":
            data = _cv2_jpeg(_smooth(rng, h, w, channels=1), 85)
        else:
            data = _cv2_jpeg(_smooth(rng, h, w), 85, sampling)
        stripped, last = data[:2], 2
        for m, start, end in _segments(data):
            if m == 0xC4:
                stripped, last = stripped + data[last:start], end
        stripped += data[last:]
        assert b"\xff\xc4" not in stripped[: _segments(stripped)[-1][2]]
        _assert_bit_equal(stripped)


def _damage(data, kind, rng):
    entropy = _segments(data)[-1][2]
    b = bytearray(data)
    if kind == "bytes":
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(entropy, len(b) - 2))
            if b[p] != 0xFF and b[p - 1] != 0xFF:
                b[p] = int(rng.integers(0, 255))
    elif kind == "garbage":
        p = int(rng.integers(entropy, len(b) - 2))
        n = int(rng.integers(1, 6))
        b[p : p + n] = bytes(int(x) for x in rng.integers(0, 255, n))
    else:  # a restart marker renumbered or dropped
        rst = [i for i in range(entropy, len(b) - 1) if b[i] == 0xFF and 0xD0 <= b[i + 1] <= 0xD7]
        i = rst[int(rng.integers(len(rst)))]
        if rng.random() < 0.5:
            b[i + 1] = 0xD0 + int(rng.integers(8))
        else:
            del b[i : i + 2]
    return bytes(b)


@pytest.mark.parametrize("kind", ["bytes", "garbage", "restart"])
@pytest.mark.parametrize("seed", [0, 1])
def test_damaged_entropy_data_decodes_as_cv2(kind, seed):
    """libjpeg-turbo decodes damaged entropy data with warnings (a bad
    Huffman code gives a zero symbol, restart markers resynchronize, the
    IDCT's 16-bit lanes wrap and saturate on wild coefficients): the port
    gives the same pixels, and raises ``ValueError`` where cv2 fails."""
    rng = np.random.default_rng(1000 * seed + len(kind))
    decoded = 0
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        rst = int(rng.integers(1, 3)) if kind == "restart" or rng.random() < 0.5 else 0
        data = _cv2_jpeg(_smooth(rng, h, w), int(rng.choice([50, 90])),
                         str(rng.choice(["444", "422", "420", "440"])),
                         IMWRITE_JPEG_RST_INTERVAL=rst)
        if kind == "restart" and data.count(b"\xff\xd0") == 0:
            continue
        bad = _damage(data, kind, rng)
        try:
            want = jax_tf.imdecode_cv2(bad)
        except ValueError:
            with pytest.raises(ValueError):
                image_io.imdecode(bad)
            continue
        got = image_io.imdecode(bad)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        decoded += 1
    assert decoded >= 20


# --- refusals and damage --------------------------------------------------------------

def _patched_sof(data, marker=None, precision=None):
    buf = bytearray(data)
    i = buf.find(b"\xff\xc0")
    assert i > 0
    if marker is not None:
        buf[i + 1] = marker
    if precision is not None:
        buf[i + 4] = precision
    return bytes(buf)


def _with_dnl(data):
    """``data`` with its SOF's height zeroed, to be given by a DNL marker."""
    buf = bytearray(data)
    i = buf.find(b"\xff\xc0")
    buf[i + 5 : i + 7] = b"\x00\x00"
    return bytes(buf)


def _variant(kind):
    img = _smooth(np.random.default_rng(5), 20, 30)
    base = _cv2_jpeg(img)
    return {
        "progressive JPEG": lambda: _cv2_jpeg(img, IMWRITE_JPEG_PROGRESSIVE=1),
        "progressive JPEG (PIL)": lambda: _pil_jpeg(img, progressive=True),
        # a baseline stream relabelled SOF9: cv2 decodes its Huffman data as
        # arithmetic-coded (with a warning), and so does the port
        "arithmetic-coded JPEG": lambda: _patched_sof(base, marker=0xC9),
        "lossless JPEG (SOF3)": lambda: _patched_sof(base, marker=0xC3),
        "lossless JPEG (SOF11)": lambda: _patched_sof(base, marker=0xCB),
        "hierarchical JPEG (SOF5)": lambda: _patched_sof(base, marker=0xC5),
        "hierarchical JPEG (SOF13)": lambda: _patched_sof(base, marker=0xCD),
        "12-bit JPEG": lambda: _patched_sof(base, precision=12),
        "DNL marker": lambda: _with_dnl(base),
        "4-component JPEG (CMYK / YCCK)": lambda: _pil_jpeg(img, mode="CMYK"),
    }[kind]()


# what the port's ValueError names each variant by
_CV2_NONE_WORDS = {"lossless JPEG (SOF3)": "lossless JPEG scan parameters",
                   "lossless JPEG (SOF11)": "SOF11", "hierarchical JPEG (SOF5)": "SOF5",
                   "hierarchical JPEG (SOF13)": "SOF13", "12-bit JPEG": "12-bit",
                   "DNL marker": "DNL"}


@pytest.mark.parametrize("kind", list(_CV2_NONE_WORDS))
def test_variants_cv2_cannot_read_raise_value_error_naming_them(kind):
    """cv2 gives None on these (a baseline stream relabelled SOF3 has a DCT
    scan's parameters), so JAX quarantines such a row: the port's
    ``ValueError`` lets its datasets do the same."""
    data = _variant(kind)
    with pytest.raises(ValueError):
        jax_tf.imdecode_cv2(data)
    with pytest.raises(ValueError, match=_CV2_NONE_WORDS[kind]) as err:
        image_io.imdecode(data)
    assert not isinstance(err.value, NotImplementedError)


@pytest.mark.parametrize("name", sorted(CV2_NONE))
def test_cv2_none_fixtures_raise_value_error_naming_them(name):
    data = (FIXTURES / name).read_bytes()
    with pytest.raises(ValueError):
        jax_tf.imdecode_cv2(data)
    with pytest.raises(ValueError, match=CV2_NONE[name]):
        image_io.imread(str(FIXTURES / name))


def test_the_card_smoke_holds_the_same_cv2_none_files():
    import chip_smoke

    assert chip_smoke.JPEG_CV2_NONE == CV2_NONE


def _random_lossless(rng):
    """A random lossless JPEG: mostly RGB frames cv2 decodes, some it does
    not (gray, YCbCr, precisions over 8, restarts off a row's end)."""
    h, w = (int(v) for v in rng.integers(1, 24, 2))
    nc = int(rng.choice([3, 3, 3, 4, 1]))
    precision = int(rng.choice([8, 8, 8, 2, 5, 7, 12]))
    img = rng.integers(0, 1 << min(precision, 8), (h, w, nc))
    if rng.random() < 0.6:  # smooth rows, small differences
        img = np.cumsum(img // 8, axis=1) % (1 << min(precision, 8))
    sampling = None
    if nc >= 3 and rng.random() < 0.4:
        sampling = [tuple(int(v) for v in rng.choice([1, 2], 2)) for _ in range(nc)]
    separate = nc > 1 and rng.random() < 0.3
    hmax = max(f[0] for f in sampling) if sampling else 1
    restart = 0
    if rng.random() < 0.4:
        row = w if separate else -(-w // hmax)  # (a subsampled scan's rows are its own)
        restart = row * int(rng.integers(1, 3)) + (1 if rng.random() < 0.1 else 0)
        if separate and sampling:
            restart = 0
    return lossless_jpeg(
        img, predictor=int(rng.integers(1, 8)),
        pt=int(rng.integers(0, min(3, precision))) if rng.random() < 0.3 else 0,
        restart=restart, precision=precision, sampling=sampling, separate=separate,
        markers=[b"", b"", JFIF, adobe(0), adobe(1)][int(rng.integers(0, 5))],
        ids=(82, 71, 66) if nc == 3 and rng.random() < 0.2 else None,
        flat=rng.random() < 0.3)


@pytest.mark.parametrize("seed", range(4))
def test_lossless_fuzz_is_bit_equal(seed):
    rng = np.random.default_rng(seed)
    decoded = 0
    for _ in range(40):
        data = _random_lossless(rng)
        try:
            want = jax_tf.imdecode_cv2(data)
        except ValueError:
            with pytest.raises(ValueError):
                image_io.imdecode(data)
            continue
        np.testing.assert_array_equal(image_io.imdecode(data), want)
        decoded += 1
    assert decoded >= 15


@pytest.mark.parametrize("kind", ["progressive JPEG", "progressive JPEG (PIL)",
                                  "arithmetic-coded JPEG", "4-component JPEG (CMYK / YCCK)"])
def test_former_refusals_decode_bit_equal_to_cv2(kind):
    """The variants the decoder refused before progressive, arithmetic and
    four-component support: bit-equal now."""
    _assert_bit_equal(_variant(kind))


@pytest.mark.parametrize("cut", [0.5, 0.9, -1, -2])
def test_truncated_stream_raises_value_error_as_jax_does(cut):
    data = _cv2_jpeg(_smooth(np.random.default_rng(6), 40, 60))
    short = data[: int(len(data) * cut)] if cut > 0 else data[:cut]
    with pytest.raises(ValueError):
        jax_tf.imdecode_cv2(short)
    with pytest.raises(ValueError, match="truncated"):
        image_io.imdecode(short)


def test_stream_cut_short_but_closed_decodes_as_cv2():
    """A scan that ends at a marker before its data is complete: libjpeg
    zero-fills the rest (a warning), and so does the port."""
    data = _cv2_jpeg(_smooth(np.random.default_rng(8), 40, 60))
    _assert_bit_equal(data[: len(data) // 2] + b"\xff\xd9")


def test_damaged_header_raises_value_error():
    with pytest.raises(ValueError):
        image_io.imdecode(b"\xff\xd8\xff\xdb\x00")
    with pytest.raises(ValueError):
        image_io.imdecode(b"\xff\xd8" + bytes(range(40)))


# --- orientation, threads -------------------------------------------------------------

def _with_exif(data, orientation):
    import struct

    ifd = struct.pack("<H", 1) + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
    body = b"Exif\x00\x00" + b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0)
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_and_image_size_agree(orientation, tmp_path):
    data = _with_exif(_cv2_jpeg(_smooth(np.random.default_rng(9), 20, 50)), orientation)
    got = _assert_bit_equal(data)
    assert got.shape[:2] == ((50, 20) if orientation >= 5 else (20, 50))
    path = tmp_path / f"o{orientation}.jpg"
    path.write_bytes(data)
    assert image_io.image_size(str(path)) == got.shape[:2] == jax_tf.image_size(str(path))


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


# --- JPEG datasets through the entry points -------------------------------------------

@pytest.fixture(scope="module")
def jpeg_lines(tmp_path_factory):
    """Eight text lines as JPEGs (q 95, 4:2:0; lines 1 and 5 progressive)
    and TIFFs (lines 3 and 7: LZW with the predictor, and Deflate), and
    their labels CSV (with a header, as the eval CLI takes it)."""
    from tests.test_torch_port_eval_cli import LABELS, WIDTHS
    from tests.torch_port_data.make_tiff_fixtures import tiff_bytes

    root = tmp_path_factory.mktemp("jpeg_lines")
    rows = []
    for i, (img, label) in enumerate(zip(_images(8, seed=3, widths=WIDTHS), LABELS)):
        if i % 4 == 3:
            name, data = f"line{i}.tif", tiff_bytes(img, photometric=2, predictor=2,
                                                    compression=("lzw", "deflate")[i // 4])
        else:
            name = f"line{i}.jpg"
            data = _cv2_jpeg(img[:, :, ::-1], 95, IMWRITE_JPEG_PROGRESSIVE=int(i % 4 == 1))
        (root / name).write_bytes(data)
        rows.append((name, label))
    path = root / "labels.csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows([("filename", "text"), *rows])
    return str(path), str(root), [str(root / name) for name, _ in rows]


def test_predict_on_jpeg_paths_matches_jax(files, jpeg_lines):
    from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference
    from rcnn_ocr_tpu_torch.inference import OCRInference

    ckpt, charset, _ = files
    _, _, paths = jpeg_lines
    ours = OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, img_h=IMG_H,
                        img_w=IMG_W)
    theirs = JaxOCRInference(ckpt, charset, dtype=jnp.float32, img_h=IMG_H, img_w=IMG_W,
                             verbose=False)
    got = ours.predict(paths, max_length=MAX_LEN, batch_size=3)
    assert got == theirs.predict(paths, max_length=MAX_LEN, batch_size=3)
    assert len(set(got)) > 1
    assert ours.predict_ctc(paths, batch_size=3) == theirs.predict_ctc(paths, batch_size=3)


def test_eval_cli_on_jpeg_lines_matches_jax(files, jpeg_lines, tmp_path, monkeypatch):
    import evaluate_dataset
    from rcnn_ocr_tpu_torch import evaluate
    from tests.test_torch_port_eval_cli import _run_both

    ckpt, charset, _ = files
    csv_path, root, _ = jpeg_lines
    kw = dict(csv_path=csv_path, root_path=root, batch_size=3, img_h=32, img_w=64,
              decode="attention", max_length=5)
    (want, want_csv), (got, got_csv) = _run_both(
        tmp_path, monkeypatch,
        lambda: evaluate_dataset.evaluate_model(model_path=ckpt, charset_path=charset, **kw),
        lambda: evaluate.evaluate_model(ckpt, charset, device="cpu", dtype=torch.float32, **kw))
    assert got == want and got["n"] == 8
    assert list(got_csv.values()) == list(want_csv.values())


def test_run_training_reads_jpeg_lines_as_their_pixels(tmp_path):
    """One epoch on JPEG lines equals one on PNGs holding cv2's decode of
    them: the loader reads the JPEGs to the same pixels."""
    from rcnn_ocr_tpu_torch.training.train import run_training
    from tests.helpers import render_text_image
    from tests.test_torch_port_train_loop import TOKENS, _cfg

    rng = np.random.default_rng(0)
    labels = ["".join(rng.choice(list("abcdefghij"), size=int(rng.integers(1, 5))))
              for _ in range(24)]
    (tmp_path / "charset.txt").write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    results = {}
    for ext in ("jpg", "png"):
        root = tmp_path / ext
        root.mkdir()
        draw = np.random.default_rng(1)
        with open(root / "labels.csv", "w", newline="", encoding="utf-8") as f:
            for i, label in enumerate(labels):
                img = render_text_image(label, h=24, w=int(draw.integers(40, 160)), rng=draw)
                data = _cv2_jpeg(img[:, :, ::-1], 85)
                if ext == "png":  # the JAX package's decode of the same JPEG
                    data = image_io.png_encode(jax_tf.imdecode_cv2(data))
                (root / f"img_{i:04d}.{ext}").write_bytes(data)
                csv.writer(f).writerow([f"img_{i:04d}.{ext}", label])
        env = {"tmp": tmp_path, "charset": str(tmp_path / "charset.txt"),
               "csv": str(root / "labels.csv"), "root": str(root)}
        results[ext] = run_training(_cfg(env, f"run_{ext}", epochs=1, head="both"),
                                    device="cpu")
    assert np.isfinite(results["jpg"]["val_loss"])
    assert results["jpg"]["val_loss"] == results["png"]["val_loss"]
    assert results["jpg"]["val_acc"] == results["png"]["val_acc"]


def _with_app1(jpeg: bytes, block: bytes) -> bytes:
    app1 = b"Exif\x00\x00" + block
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + jpeg[2:]


def _orientation_block(order: bytes, entry_bytes: int = 12, before=b"") -> bytes:
    """A TIFF header of byte order ``order`` and an IFD whose entries are
    ``before`` then an Orientation of 6 cut to ``entry_bytes``."""
    e = "<" if order == b"II" else ">"
    n = len(before) // 12 + 1
    head = order + (b"*\x00" if order == b"II" else b"\x00*")
    return (head + struct.pack(e + "IH", 8, n) + before
            + struct.pack(e + "HHIHH", 0x112, 3, 1, 6, 0)[:entry_bytes])


EXIF_READS = {
    # OpenCV reads the entry's value at bytes 8-9: two bytes of padding may be missing
    "an Orientation entry cut to 10 bytes": _orientation_block(b"MM", 10),
    # two first bytes that differ read as Motorola order
    "byte order 'MI'": b"MI" + _orientation_block(b"MM")[2:],
    # a string entry whose data lies past the block stops the parse before it
    "a string past the block first": _orientation_block(
        b"MM", before=struct.pack(">HHII", 0x10E, 2, 100, 1000)),
    "a rational past the block first": _orientation_block(
        b"II", before=struct.pack("<HHII", 0x11A, 5, 1, 1000)),
}


@pytest.mark.parametrize("case", sorted(EXIF_READS))
def test_exif_orientation_is_read_as_opencv_reads_it(case):
    """The APP1 EXIF block read as OpenCV's ExifReader reads it (the port
    read 'MI' and a 10-byte entry as no orientation)."""
    jpeg = (FIXTURES / "arith_dac_s422_q90_20x31.jpg").read_bytes()
    data = _with_app1(jpeg, EXIF_READS[case])
    np.testing.assert_array_equal(image_io.imdecode(data), jax_tf.imdecode_cv2(data))


def _app1(body: bytes) -> bytes:
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


_XMP = _app1(b"http://ns.adobe.com/xap/1.0/\x00<x:xmpmeta/>")
EXIF_SEGMENTS = {
    "XMP before the EXIF": [_XMP, _app1(b"Exif\x00\x00" + _orientation_block(b"MM"))],
    "an EXIF without Orientation first": [
        _app1(b"Exif\x00\x00MM\x00*" + struct.pack(">IH", 8, 0) + bytes(4)),
        _app1(b"Exif\x00\x00" + _orientation_block(b"II"))],
    "an EXIF whose Orientation is cut first": [
        _app1(b"Exif\x00\x00" + _orientation_block(b"MM", 9)),
        _app1(b"Exif\x00\x00" + _orientation_block(b"MM"))],
    "an Orientation of 0 first": [
        _app1(b"Exif\x00\x00MM\x00*" + struct.pack(">IHHHIHH", 8, 1, 0x112, 3, 1, 0, 0)),
        _app1(b"Exif\x00\x00" + _orientation_block(b"MM"))],
    "an APP1 that is not EXIF first": [_app1(b"XXXX\x00\x00" + _orientation_block(b"MM")[:8]),
                                       _app1(b"Exif\x00\x00" + _orientation_block(b"II"))],
    "an empty APP1 first": [_app1(b""), _app1(b"Exif\x00\x00" + _orientation_block(b"MM"))],
}


@pytest.mark.parametrize("case", sorted(EXIF_SEGMENTS))
def test_exif_app1_segments_are_read_as_opencv_reads_them(case):
    """Every APP1 that starts "Exif\\0\\0" feeds OpenCV's one ExifReader map,
    where the first Orientation entry stays (the port read only the first
    APP1, whatever it held)."""
    jpeg = (FIXTURES / "arith_dac_s422_q90_20x31.jpg").read_bytes()
    data = jpeg[:2] + b"".join(EXIF_SEGMENTS[case]) + jpeg[2:]
    np.testing.assert_array_equal(image_io.imdecode(data), jax_tf.imdecode_cv2(data))
