"""The port's BMP decoder (``data/bmp.py``) vs the JAX package's
``imdecode_cv2``, on the CPU.

* Every fixture of ``tests/torch_port_data/bmp/`` (1/4/8-bit palettes,
  short palettes, 16-bit 5-5-5 and 5-6-5, 24/32-bit, 32-bit masks, RLE8 and
  RLE4 with every code, OS/2 core, V3, V4 and V5 headers, top-down, files
  from cv2 and PIL): bit-equal to ``imdecode_cv2`` and to the pixels the
  card's smoke reads (``expected.npz``).
* A seeded fuzz over bit depth x compression x header x top-down x odd
  widths x masks x random RLE streams: bit-equal wherever cv2 decodes,
  ``ValueError`` (never ``UnsupportedImageFormat``) where it returns
  ``None``.
* A fault of the port against the reference, repaired: the port's
  ``OCRDataset`` quarantined a 1-bit or an RLE8 BMP row (its decoder
  raised ``ValueError`` for them) where the JAX dataset trains on the row;
  both now give the same pixels with nothing quarantined.
* ``image_size`` equals JAX's on every fixture without decoding.
"""

import csv
import os
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from rcnn_ocr_tpu.data import dataset as jax_dataset  # noqa: E402
from rcnn_ocr_tpu.data import transforms as jax_tf  # noqa: E402
from rcnn_ocr_tpu_torch.data import dataset, image_io  # noqa: E402
from tests.test_torch_port_data import CS, JCS  # noqa: E402
from tests.torch_port_data.make_bmp_fixtures import (  # noqa: E402
    MASKS_555, MASKS_565, bmp_bytes, rle_random)

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "bmp"
NAMES = sorted(p.name for p in FIXTURES.glob("*.bmp"))


@pytest.fixture(scope="module")
def expected():
    with np.load(FIXTURES / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def _cv2(data):
    try:
        return jax_tf.imdecode_cv2(data)
    except (ValueError, cv2.error):
        return None


# --- fixtures ---------------------------------------------------------------------------

def test_fixtures_cover_the_paths(expected):
    kinds = ("pal1_", "pal4_", "pal8_", "short", "gray", "core", "_v5", "_v4", "_v3",
             "topdown", "rgb555", "rgb565", "bitfields", "rgb24", "rgb32", "rle8_", "rle4_",
             "codes", "gap", "pil_1_", "pil_", "cv2_", "bmp1_line", "rle8_line")
    for kind in kinds:
        assert any(kind in n for n in NAMES), kind
    assert sorted(expected) == NAMES
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 96 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_bit_equal_to_cv2(name, expected):
    data = (FIXTURES / name).read_bytes()
    want = jax_tf.imdecode_cv2(data)
    got = image_io.imread(str(FIXTURES / name))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, expected[name])


def test_image_size_reads_the_header_as_jax_sizes_the_fixtures(monkeypatch):
    want = {name: jax_tf.image_size(str(FIXTURES / name)) for name in NAMES}
    monkeypatch.setattr(image_io, "imread", lambda path: pytest.fail(f"decoded {path}"))
    assert {name: image_io.image_size(str(FIXTURES / name)) for name in NAMES} == want


# --- fuzz -------------------------------------------------------------------------------

def _random_bmp(rng):
    """A random BMP and a description of it."""
    h, w = (int(v) for v in rng.integers(1, 40, 2))
    kind = str(rng.choice(["pal1", "pal4", "pal8", "rle8", "rle4", "rgb16", "bf16", "rgb24",
                           "rgb32", "bf32"]))
    header = int(rng.choice([12, 40, 52, 56, 108, 124]))
    top_down = bool(rng.random() < 0.3)
    info = (kind, header, top_down, h, w)
    if kind.startswith(("pal", "rle")):
        bits = int(kind[3:])
        n = 1 << bits
        pal = rng.integers(0, 256, (int(rng.integers(1, n + 1)) if rng.random() < 0.3 else n, 3))
        if kind.startswith("rle"):
            header = max(header, 40)
            rle = (rle_random(rng, h, w, bits, n, dy=bool(rng.random() < 0.5),
                              early_end=bool(rng.random() < 0.5))
                   if rng.random() < 0.7 else None)
            raw = rng.integers(0, min(n, 6), (h, w)).astype(np.uint8)
            return bmp_bytes(raw, bits, kind, header=header, top_down=top_down, palette=pal,
                             rle=rle), info
        raw = rng.integers(0, n, (h, w)).astype(np.uint8)
        return bmp_bytes(raw, bits, header=header, top_down=top_down and header != 12,
                         palette=pal), info
    if kind in ("rgb16", "bf16"):
        header = max(header, 40)
        raw = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        if kind == "bf16":
            masks = (MASKS_555, MASKS_565, (0xF00, 0xF0, 0xF))[int(rng.integers(0, 3))]
            return bmp_bytes(raw, 16, "bitfields", header=header, top_down=top_down,
                             masks=masks, masks_after_header=True), info + (masks,)
        return bmp_bytes(raw, 16, header=header, top_down=top_down), info
    c = 3 if kind == "rgb24" else 4
    raw = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    if kind == "bf32":
        header = max(header, 40)
        masks = [int(rng.integers(0, 2 ** 32)) & int(rng.choice([0xFF, 0xFFFF, 0xFFFFFFFF]))
                 << int(rng.integers(0, 8)) & 0xFFFFFFFF for _ in range(3)]
        if rng.random() < 0.3:
            masks[int(rng.integers(0, 3))] = 0
        return bmp_bytes(raw, 32, "bitfields", header=header, top_down=top_down,
                         masks=masks), info + (masks,)
    return bmp_bytes(raw, c * 8, header=header, top_down=top_down and header != 12), info


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_is_bit_equal(seed):
    rng = np.random.default_rng(1200 + seed)
    decoded = 0
    for _ in range(60):
        data, info = _random_bmp(rng)
        want = _cv2(data)
        if want is None:
            with pytest.raises(ValueError) as err:
                image_io.imdecode(data)
            assert not isinstance(err.value, image_io.UnsupportedImageFormat), info
            continue
        np.testing.assert_array_equal(image_io.imdecode(data), want, err_msg=str(info))
        decoded += 1
    assert decoded >= 40


@pytest.mark.parametrize("masks", [MASKS_555, MASKS_565, None], ids=["555", "565", "bi_rgb"])
def test_every_16_bit_value_reaches_8_bits_as_cv2_takes_it(masks):
    """cv2 shifts 5- and 6-bit channels up with zero low bits."""
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    kw = dict(compression="bitfields", masks=masks) if masks else {}
    data = bmp_bytes(v, 16, **kw)
    np.testing.assert_array_equal(image_io.imdecode(data), jax_tf.imdecode_cv2(data))


@pytest.mark.parametrize("width", range(1, 33))
def test_32_bit_masks_scale_as_cv2(width):
    """OpenCV 5 reads a V3+ header's 32-bit masks and scales each channel
    by ``255.0f / max`` in float32 (a 3-bit channel tops out at 254)."""
    rng = np.random.default_rng(width)
    top = (1 << width) - 1
    vals = np.unique(np.concatenate([rng.integers(0, top + 1, 2000, dtype=np.uint64),
                                     [0, top, max(top - 1, 0)]]))
    raw = vals.astype(np.uint32).view(np.uint8).reshape(1, -1, 4)
    data = bmp_bytes(raw, 32, "bitfields", header=56,
                     masks=(top, 0x80000000 if width < 32 else 1, 0x40000000 if width < 31 else 2))
    np.testing.assert_array_equal(image_io.imdecode(data), jax_tf.imdecode_cv2(data))


_PAL = np.array([[10, 20, 30], [40, 50, 60], [70, 80, 90], [100, 110, 120]] + [[200, 0, 0]] * 12)


def _codes(*pairs):
    return b"".join(bytes(p) for p in pairs)


# (bits, codes, 3x5 palette indices bottom row first, or None where cv2 fails)
RLE_CASES = {
    "rle8_eol_after_a_full_row_is_skipped": (8, _codes((5, 1), (0, 0), (0, 0), (5, 3), (0, 1)),
                                             [[1] * 5, [0] * 5, [3] * 5]),
    "rle8_end_of_bitmap_fills_the_rest": (8, _codes((2, 1), (0, 1), (5, 2)),
                                          [[1, 1, 0, 0, 0], [0] * 5, [0] * 5]),
    "rle8_delta_skips_columns_and_rows": (8, _codes((1, 1), (0, 2), (2, 1), (2, 2), (0, 0),
                                                    (5, 3), (0, 1)),
                                          [[1, 0, 0, 0, 0], [0, 0, 0, 2, 2], [3] * 5]),
    "rle8_without_end_of_line": (8, _codes((5, 1), (5, 2), (5, 3)),
                                 [[1] * 5, [2] * 5, [3] * 5]),
    "rle8_run_past_the_row": (8, _codes((7, 1), (0, 1)), None),
    "rle8_absolute_run_then_a_run": (8, _codes((0, 5), (1, 2, 3, 1, 2, 0), (5, 2), (5, 3),
                                               (0, 1)), None),
    "rle4_end_of_bitmap_is_an_end_of_line": (4, _codes((2, 0x11), (0, 1)), None),
    "rle4_delta_ignores_its_rows": (4, _codes((1, 0x11), (0, 2), (2, 1), (2, 0x22), (0, 0),
                                              (5, 0x33), (0, 0), (5, 0x33), (0, 1)),
                                    [[1, 0, 0, 2, 2], [3] * 5, [3] * 5]),
    "rle4_without_end_of_line": (4, _codes((5, 0x11), (5, 0x22)), None),
    "rle4_absolute_nibbles": (4, _codes((0, 5), (0x12, 0x31, 0x20, 0), (0, 0), (5, 0x23),
                                        (0, 0), (4, 0x31), (0, 0)),
                              [[1, 2, 3, 1, 2], [2, 3, 2, 3, 2], [3, 1, 3, 1, 0]]),
}


@pytest.mark.parametrize("case", sorted(RLE_CASES))
def test_rle_codes_decode_as_cv2_runs_them(case):
    """OpenCV's RLE loops, pinned: what the escapes skip takes palette
    entry 0; RLE4 treats end-of-bitmap as end-of-line and ignores a delta's
    rows; a run past its row, or data that ends early, fails."""
    bits, codes, rows = RLE_CASES[case]
    data = bmp_bytes(np.zeros((3, 5), np.uint8), bits, f"rle{bits}", palette=_PAL, rle=codes)
    want = _cv2(data)
    if rows is None:
        assert want is None
        with pytest.raises(ValueError):
            image_io.imdecode(data)
        return
    np.testing.assert_array_equal(want, _PAL[np.array(rows)[::-1]])
    np.testing.assert_array_equal(image_io.imdecode(data), want)


def _patched(data: bytes, at: int, fmt: str, value) -> bytes:
    data = bytearray(data)
    struct.pack_into(fmt, data, at, value)
    return bytes(data)


_IMG = np.arange(60, dtype=np.uint8).reshape(4, 5, 3)
CV2_FAILS = {
    "2 bits a pixel": lambda: bmp_bytes(np.zeros((3, 5), np.uint8), 2, palette=_PAL[:4]),
    "BI_JPEG": lambda: _patched(bmp_bytes(_IMG, 24), 30, "<I", 4),
    "BI_PNG": lambda: _patched(bmp_bytes(_IMG, 24), 30, "<I", 5),
    "BI_ALPHABITFIELDS": lambda: _patched(bmp_bytes(_IMG, 32), 30, "<I", 6),
    "16-bit 4-4-4 masks": lambda: bmp_bytes(np.zeros((3, 5), np.uint16), 16, "bitfields",
                                            masks=(0xF00, 0xF0, 0xF)),
    "16-bit masks inside a V4 header only": lambda: bmp_bytes(
        np.zeros((3, 5), np.uint16) + 0x1234, 16, "bitfields", header=108, masks=MASKS_565),
    "24-bit BI_BITFIELDS": lambda: bmp_bytes(_IMG, 24, "bitfields", masks=MASKS_565),
    "RLE8 at 4 bits": lambda: _patched(bmp_bytes(np.zeros((3, 5), np.uint8), 4, "rle4",
                                                 palette=_PAL), 30, "<I", 1),
    "palette of 300 colours": lambda: bmp_bytes(np.zeros((3, 5), np.uint8), 8, palette=_PAL,
                                                n_colors=300),
    "width 0": lambda: _patched(bmp_bytes(_IMG, 24), 18, "<i", 0),
    "negative width": lambda: _patched(bmp_bytes(_IMG, 24), 18, "<i", -5),
    "height 0": lambda: _patched(bmp_bytes(_IMG, 24), 22, "<i", 0),
    "header of 20 bytes": lambda: _patched(bmp_bytes(_IMG, 24), 14, "<I", 20),
    "last row short of its padding": lambda: bmp_bytes(_IMG, 24)[:-1],
    "pixel offset past the end": lambda: _patched(bmp_bytes(_IMG, 24), 10, "<I", 10 ** 6),
    "RLE8 with no end": lambda: bmp_bytes(np.zeros((3, 5), np.uint8), 8, "rle8",
                                          palette=_PAL, rle=_codes((5, 1), (0, 0))),
    "a file header alone": lambda: b"BM" + bytes(12),
}


@pytest.mark.parametrize("kind", sorted(CV2_FAILS))
def test_value_error_where_cv2_fails(kind):
    """Where cv2 returns None the port raises ValueError (the datasets
    quarantine such a row in both packages), never UnsupportedImageFormat."""
    data = CV2_FAILS[kind]()
    assert _cv2(data) is None
    with pytest.raises(ValueError) as err:
        image_io.imdecode(data)
    assert not isinstance(err.value, image_io.UnsupportedImageFormat)


# --- the fault: BMP rows quarantined in the port's dataset ------------------------------

def test_dataset_reads_1_bit_and_rle8_bmp_rows_as_the_jax_dataset(tmp_path):
    """A line set saved as 1-bit (PIL mode "1", the usual bilevel scan) and
    RLE8 BMPs: the port's decoder raised ``ValueError`` for both, so its
    ``OCRDataset`` quarantined the rows and served random healthy ones in
    their place, where JAX's trains on them.  Both now give every row its
    own pixels and quarantine nothing."""
    from PIL import Image

    root = tmp_path / "ds"
    root.mkdir()
    rng = np.random.default_rng(11)
    rows = []
    for i in range(6):
        img = rng.integers(0, 256, (12, 30 + 7 * i), dtype=np.uint8)
        name = f"line_{i}.bmp"
        if i % 3 == 0:  # PIL's bilevel scan
            Image.fromarray(img).convert("1").save(root / name, format="BMP")
        elif i % 3 == 1:
            idx = (img // 64).astype(np.uint8)
            pal = np.repeat(np.array([[0], [90], [170], [255]]), 3, axis=1)
            (root / name).write_bytes(bmp_bytes(idx, 8, "rle8", palette=pal))
        else:
            cv2.imwrite(str(root / name), img)
        rows.append([name, "abcdef"[i]])
    csv_path = root / "labels.csv"
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows(rows)
    kw = dict(max_len=4, verbose=False)
    ours = dataset.OCRDataset(str(csv_path), str(root), CS.stoi, **kw)
    theirs = jax_dataset.OCRDataset(str(csv_path), str(root), JCS.stoi, **kw)
    assert len(ours) == len(theirs) == 6
    for i in range(6):
        got, label = ours[i]
        want, want_label = theirs[i]
        assert label == want_label == rows[i][1]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jax_tf.imread_cv2(os.path.join(root, rows[i][0])).astype(np.float32) / 255.0)
    assert not any(ours._invalid_mask), "the port quarantined a row JAX reads"
