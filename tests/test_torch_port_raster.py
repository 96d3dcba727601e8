"""The port's Sun raster, PFM and Radiance HDR decoders
(``data/sunras.py``, ``data/pfm.py``, ``data/hdr.py``) vs the JAX
package's ``imdecode_cv2`` / ``imread_cv2``, on the CPU.

* Every fixture of ``tests/torch_port_data/raster/`` (cv2's own files and
  hand-written ones: 1-, 8-, 24- and 32-bit rasters with and without
  colormaps, PFM in both byte orders with scales and values to round and
  saturate, HDR run-length encoded, flat and mixed): bit-equal to
  ``imdecode_cv2`` and to the pixels the card's smoke reads
  (``expected.npz``).
* Seeded fuzzes over sides, depths and values through cv2's writers and
  the fixture script's, clean and with bit flips and cuts: bit-equal
  wherever cv2 decodes, ``ValueError`` where it gives ``None`` or raises.
* Header cases probed against cv2: the Sun raster types cv2 never reads
  (RLE, RGB-format), PFM's field parsing, HDR's header lines and
  orientation; sides past OpenCV's size limit; gray PFM (``Pf``), which
  cv2 reads as one channel and the JAX path turns into three.
* A dataset over ``.ras``, ``.pfm`` and ``.hdr`` rows (a ``Pf`` and an RLE
  raster among them) and an eval-CLI run over such lines, against JAX's.
"""

import csv
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from rcnn_ocr_tpu.data import transforms as jax_tf  # noqa: E402
from rcnn_ocr_tpu_torch.data import image_io  # noqa: E402
from tests.test_torch_port_beam_engine import files  # noqa: E402,F401
from tests.test_torch_port_data import assert_datasets_agree  # noqa: E402
from tests.torch_port_data.make_raster_fixtures import (  # noqa: E402
    hdr_bytes, pfm_bytes, ras_bytes)

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "raster"
NAMES = sorted(p.name for p in FIXTURES.iterdir() if p.suffix in (".ras", ".pfm", ".hdr"))


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
    """Bit-equal to cv2 where it decodes, ValueError (not a refusal) where
    it gives None or raises.  Returns whether cv2 decoded."""
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


@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_bit_equal_to_cv2(name, expected):
    data = (FIXTURES / name).read_bytes()
    assert _assert_as_cv2(data, name)
    np.testing.assert_array_equal(image_io.imread(str(FIXTURES / name)), expected[name])


def test_every_fixture_has_expected_pixels(expected):
    assert sorted(expected) == NAMES


# --- fuzz -------------------------------------------------------------------------------

def _damage(data: bytes, rng, header: int):
    """A few bit flips (in the header or anywhere), or a cut."""
    data = bytearray(data)
    kind = rng.integers(0, 3)
    if kind == 0:
        return bytes(data[: int(rng.integers(0, len(data)))])
    span = header if kind == 1 else len(data)
    for _ in range(int(rng.integers(1, 4))):
        i = int(rng.integers(0, min(span, len(data))))
        data[i] ^= 1 << int(rng.integers(0, 8))
    return bytes(data)


def _ras_case(rng):
    h, w = int(rng.integers(1, 9)), int(rng.integers(1, 14))
    depth = int(rng.choice([1, 8, 24, 32]))
    if depth in (1, 8) and rng.random() < 0.3:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        src = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if depth == 8 else img[:, :, ::-1]
        return cv2.imencode(".ras", src)[1].tobytes()
    if depth <= 8:
        idx = rng.integers(0, 1 << depth, (h, w))
        cmap = (rng.integers(0, 256, (int(rng.integers(1, (1 << depth) + 1)), 3))
                if rng.random() < 0.6 else None)
        return ras_bytes(idx, depth, kind=int(rng.integers(0, 2)), cmap=cmap)
    return ras_bytes(rng.integers(0, 256, (h, w, 3)), depth, pad=int(rng.integers(0, 256)))


def _pfm_case(rng):
    h, w = int(rng.integers(1, 7)), int(rng.integers(1, 9))
    vals = rng.uniform(-50, 400, (h, w, 3)).astype(np.float32)
    if rng.random() < 0.3:
        vals.reshape(-1)[rng.integers(0, vals.size)] = rng.choice(
            [np.nan, np.inf, -np.inf, 2.0 ** 31, 2.0 ** 31 - 128, 0.5, 2.5])
    if rng.random() < 0.3:
        return cv2.imencode(".pfm", vals[:, :, ::-1])[1].tobytes()
    scale = float(rng.choice([-1.0, 1.0, -2.0, 0.5, -0.3, 3.0]))
    if rng.random() < 0.3:  # gray
        return b"Pf\n%d %d\n%r\n" % (w, h, scale) + np.ascontiguousarray(
            vals[::-1, :, 0] * abs(scale), "<f4" if scale < 0 else ">f4").tobytes()
    return pfm_bytes(vals * abs(scale), scale)


def _hdr_case(rng):
    h, w = int(rng.integers(1, 6)), int(rng.choice([3, 7, 8, 9, 20, 130]))
    rgbe = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[:, :, 3] = rng.integers(115, 140, (h, w))
    if rng.random() < 0.5:
        y = int(rng.integers(0, h))
        rgbe[y, : w // 2] = rgbe[y, 0]
    rgbe[rng.random((h, w)) < 0.05, 3] = rng.choice([0, 1, 200, 255])
    if rng.random() < 0.2:
        img = (rng.random((h, w, 3)) * 2).astype(np.float32)
        return cv2.imencode(".hdr", img)[1].tobytes()
    return hdr_bytes(rgbe, rle=rng.random() < 0.8,
                     flat_from=int(rng.integers(0, h)) if rng.random() < 0.2 else -1)


CASES = {"Sun raster": (_ras_case, 32), "PFM": (_pfm_case, 12), "HDR": (_hdr_case, 48)}


@pytest.mark.parametrize("damaged", [False, True])
@pytest.mark.parametrize("fmt", sorted(CASES))
def test_seeded_fuzz_agrees_with_cv2(fmt, damaged):
    make, header = CASES[fmt]
    rng = np.random.default_rng((sorted(CASES).index(fmt), damaged))
    decoded = 0
    for case in range(60):
        data = make(rng)
        if damaged:
            data = _damage(data, rng, header)
        decoded += _assert_as_cv2(data, (fmt, case))
    assert decoded >= (5 if damaged else 60), decoded


# --- header cases -------------------------------------------------------------------------

_PX = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
PFM_HEADERS = {  # case: header (the raster follows, little-endian unless the scale is positive)
    "tab between sides": b"PF\n2\t1\n-1\n",
    "CR before the raster": b"PF\n2 1\n-1\r",
    "space after PF": b"PF 2 1 -1\n",
    "CR LF after PF": b"PF\r\n2 1\r\n-1\r\n",
    "a comment": b"PF\n# c\n2 1\n-1\n",
    "leading zeros, a bare fraction": b"PF\n02 01\n-.5\n",
    "letters after the scale": b"PF\n2 1\n-1xyz\n",
    "letters after the width": b"PF\n2px 1\n-1\n",
    "a second line feed": b"PF\n2 1\n-1\n\n",
    "a plus sign": b"PF\n2 1\n+1\n",
    "scale 0": b"PF\n2 1\n0\n",
    "scale -0.0": b"PF\n2 1\n-0.0\n",
    "scale nan": b"PF\n2 1\nnan\n",
    "scale -inf": b"PF\n2 1\n-inf\n",
    "scale 1e-45": b"PF\n2 1\n1e-45\n",
    "scale 1e-320": b"PF\n2 1\n1e-320\n",
    "hex scale": b"PF\n2 1\n-0x1p1\n",
    "hex scale past float64": b"PF\n2 1\n0x1p99999\n",
    "width 0": b"PF\n0 1\n-1\n",
    "width -2": b"PF\n-2 1\n-1\n",
    "two spaces": b"PF\n2  1\n-1\n",
    "a byte past ASCII": b"PF\n2 1\n-1\xe9\n",
    "no raster": b"PF\n2 1\n-1\n",
}


@pytest.mark.parametrize("case", sorted(PFM_HEADERS))
def test_pfm_header_parses_as_cv2_parses_it(case):
    head = PFM_HEADERS[case]
    if case == "no raster":
        _assert_as_cv2(head, case)
        return
    order = ">" if b"+1" in head or b"1e-45" in head else "<"
    _assert_as_cv2(head + _PX.astype(order + "f4").tobytes() + bytes(8), case)


def test_gray_pfm_reads_as_the_jax_path_reads_it():
    """cv2 gives a gray (``Pf``) map one channel under ``IMREAD_COLOR``; the
    JAX path's BGR -> RGB conversion makes it three, the gray value on
    each, and so does the port."""
    data = b"Pf\n3 2\n-1\n" + np.array([0.5, 1.5, 2.5, 254.5, 300, np.nan], "<f4").tobytes()
    raw = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert raw is not None and raw.shape == (2, 3)
    assert _assert_as_cv2(data)
    np.testing.assert_array_equal(image_io.imdecode(data)[:, :, 0], [[254, 255, 0], [0, 2, 2]])


_RGBE = bytes([128, 64, 1, 129, 255, 255, 255, 128])
HDR_HEADERS = {
    "RADIANCE": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n",
    "RGBE": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n",
    "xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 1 +X 2\n",
    "+Y": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 1 +X 2\n",
    "-X": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 -X 2\n",
    "no spaces in the size": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y1+X2\n",
    "words after the size": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2 more\n",
    "lines before FORMAT": b"#?RADIANCE\nGAMMA=2\nSOFTWARE=x\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n",
    "blank line before FORMAT": b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n",
    "no blank line": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n-Y 1 +X 2\n",
    "CR LF": b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n-Y 1 +X 2\r\n",
    "FORMAT on the first line": b"#?RADIANCEFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n",
    "a 200-byte line": b"#?RADIANCE\n" + b"x" * 200 + b"\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n",
    "a NUL in a line": b"#?RADIANCE\nA\0B\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n",
    "a line starting NUL": b"#?RADIANCE\n\0B\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n",
    "height 0": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 0 +X 2\n",
    "no line feed after the size": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2",
}


@pytest.mark.parametrize("case", sorted(HDR_HEADERS))
def test_hdr_header_parses_as_cv2_parses_it(case):
    _assert_as_cv2(HDR_HEADERS[case] + _RGBE, case)


def _rle_line(rgbe):
    w = len(rgbe)
    return bytes([2, 2, w >> 8, w & 255]) + b"".join(
        bytes([w]) + rgbe[:, c].tobytes() for c in range(4))


HDR_SCANLINES = {  # case: (width, the pixel bytes after the header)
    "literal of 8": (8, lambda px: _rle_line(px)),
    "a run of 0 count": (8, lambda px: bytes([2, 2, 0, 8, 128, 5]) + bytes(40)),
    "a literal of 0": (8, lambda px: bytes([2, 2, 0, 8, 0, 5]) + bytes(40)),
    "a run past the line": (8, lambda px: bytes([2, 2, 0, 8, 137, 5]) + bytes(40)),
    "a wrong width": (8, lambda px: bytes([2, 2, 0, 9]) + _rle_line(px)[4:]),
    "third byte with its top bit": (8, lambda px: bytes([2, 2, 0x80, 8]) + px.tobytes()),
    "not 2 2: flat": (8, lambda px: px.tobytes()),
    "width 7 starting 2 2: flat": (7, lambda px: bytes([2, 2, 0, 7]) + px.tobytes()),
    "short by one byte": (8, lambda px: _rle_line(px)[:-1]),
}


@pytest.mark.parametrize("case", sorted(HDR_SCANLINES))
def test_hdr_scanlines_read_as_cv2_reads_them(case):
    w, body = HDR_SCANLINES[case]
    px = np.random.default_rng(4).integers(1, 256, (w, 4)).astype(np.uint8)
    px[:, 3] = 130
    _assert_as_cv2(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X %d\n" % w + body(px), case)


def _ras(typ, depth=8, maptype=0, maplength=0, w=3, h=2, extra=64, cmap=b""):
    import struct

    return struct.pack(">4sIIIIIII", b"\x59\xa6\x6a\x95", w, h, depth, 0, typ, maptype,
                       maplength) + cmap + bytes(i % 251 + 1 for i in range(extra))


RAS_HEADERS = {
    "type 0": _ras(0), "type 1": _ras(1), "RLE (type 2)": _ras(2), "RGB format (type 3)":
    _ras(3, 24), "type 5": _ras(5), "depth 4": _ras(1, 4), "depth 16": _ras(1, 16),
    "raw colormap (type 2)": _ras(1, 8, 2, 6, cmap=bytes(6)),
    "colormap type 1 of 0 bytes": _ras(1, 8, 1, 0),
    "colormap length without a type": _ras(1, 8, 0, 6, cmap=bytes(6)),
    "colormap on 24 bits": _ras(1, 24, 1, 6, cmap=bytes(6)),
    "colormap of 771 bytes": _ras(1, 8, 1, 771, cmap=bytes(771)),
    "1-bit colormap of 9 bytes": _ras(1, 1, 1, 9, cmap=bytes(9)),
    "1-bit colormap of 3 bytes": _ras(1, 1, 1, 3, cmap=b"\x01\x02\x03"),
    "negative width": _ras(1, 8, w=2 ** 32 - 3),
    "zero height": _ras(1, 8, h=0),
    "short of the last pad byte": _ras(1, 8, w=3, h=2, extra=7),
    "exact": _ras(1, 8, w=3, h=2, extra=8),
    "header only": _ras(1, 8, extra=0)[:32],
    "short header": _ras(1, 8)[:20],
}


@pytest.mark.parametrize("case", sorted(RAS_HEADERS))
def test_sun_raster_header_as_cv2_reads_it(case):
    decoded = _assert_as_cv2(RAS_HEADERS[case], case)
    assert decoded == (case in ("type 0", "type 1", "1-bit colormap of 3 bytes", "exact"))


SIZE_LIMIT = {  # case: (file, whether cv2 decodes it)
    "Sun raster 1 << 20 wide": (lambda: _ras(1, 8, w=1 << 20, h=1, extra=(1 << 20) + 2), True),
    "Sun raster one pixel wider": (lambda: _ras(1, 8, w=(1 << 20) + 1, h=1, extra=16), False),
    "PFM one pixel wider": (lambda: b"PF\n1048577 1\n-1\n" + bytes(16), False),
    "PFM 40000x40000 over one row": (lambda: b"PF\n40000 40000\n-1\n" + bytes(480000), False),
    "HDR one pixel taller": (lambda: b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1048577 +X 1\n"
                             + bytes(16), False),
    "HDR 1 << 15 wide over one RLE line": (
        lambda: b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 30000 +X 30000\n" + bytes([2, 2, 0x75, 0x30])
        + bytes(64), False),
}


@pytest.mark.parametrize("case", sorted(SIZE_LIMIT))
def test_sides_past_opencv_limit_raise_value_error(case):
    make, decodes = SIZE_LIMIT[case]
    assert _assert_as_cv2(make(), case) == decodes


# --- datasets and the eval CLI ----------------------------------------------------------

def _write_lines(root: Path, labels, extra: bool = False):
    """Lines as 8-bit colormapped and 24-bit Sun rasters, PFM and run-length
    encoded HDR, each its own extension; with ``extra`` a gray PFM row and
    a run-length encoded Sun raster, which cv2 does not read."""
    from tests.test_torch_port_beam_engine import _images
    from tests.test_torch_port_eval_cli import WIDTHS

    rows = []
    for i, (img, label) in enumerate(zip(_images(len(labels), seed=6, widths=WIDTHS), labels)):
        kind = i % 4
        if kind == 0:
            gray = img.mean(axis=2).astype(np.uint8)
            pal = np.repeat(np.arange(256)[:, None], 3, axis=1)[::-1]
            name, data = f"line{i}.ras", ras_bytes(255 - gray, 8, cmap=pal)
        elif kind == 1:
            name, data = f"line{i}.ras", cv2.imencode(".ras", img[:, :, ::-1])[1].tobytes()
        elif kind == 2:
            name, data = f"line{i}.pfm", pfm_bytes(img.astype(np.float32) / 255, -1 / 255)
        else:
            name, data = f"line{i}.hdr", cv2.imencode(
                ".hdr", (img[:, :, ::-1] / 255.0).astype(np.float32))[1].tobytes()
        (root / name).write_bytes(data)
        rows.append((name, label))
    if extra:
        gray = np.arange(32, dtype="<f4").reshape(4, 8) * 7
        (root / "gray.pfm").write_bytes(b"Pf\n8 4\n-1\n" + gray.tobytes())
        rows.insert(2, ("gray.pfm", "j"))
        (root / "rle.ras").write_bytes(RAS_HEADERS["RLE (type 2)"])
        rows.insert(5, ("rle.ras", "a"))
    return rows


def test_dataset_reads_raster_pfm_and_hdr_rows_as_the_jax_dataset(tmp_path):
    """Both datasets read every Sun raster, PFM (a gray one too) and HDR row
    to the same pixels; the run-length encoded Sun raster, which cv2 does
    not read, is quarantined in both, the same substitute served in its
    place."""
    root = tmp_path / "ds"
    root.mkdir()
    rows = _write_lines(root, list("abcdefghi"), extra=True)
    csv_path = root / "labels.csv"
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows(rows)
    assert assert_datasets_agree(csv_path, root, len(rows)) == [5]
    for name, _ in rows:
        if name != "rle.ras":
            np.testing.assert_array_equal(image_io.imread(str(root / name)),
                                          jax_tf.imread_cv2(str(root / name)))


def test_eval_cli_on_raster_pfm_and_hdr_lines_matches_jax(files, tmp_path, monkeypatch):  # noqa: F811
    import evaluate_dataset
    from rcnn_ocr_tpu_torch import evaluate
    from tests.test_torch_port_eval_cli import LABELS, _run_both

    ckpt, charset, _ = files
    root = tmp_path / "lines"
    root.mkdir()
    rows = _write_lines(root, LABELS)
    csv_path = root / "labels.csv"
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows([("filename", "text"), *rows])
    kw = dict(csv_path=str(csv_path), root_path=str(root), batch_size=3, img_h=32, img_w=64,
              decode="ctc_greedy", max_length=5)
    (want, want_csv), (got, got_csv) = _run_both(
        tmp_path, monkeypatch,
        lambda: evaluate_dataset.evaluate_model(model_path=ckpt, charset_path=charset, **kw),
        lambda: evaluate.evaluate_model(ckpt, charset, device="cpu", dtype=torch.float32, **kw))
    assert got == want and got["n"] == len(LABELS)
    assert list(got_csv.values()) == list(want_csv.values())
