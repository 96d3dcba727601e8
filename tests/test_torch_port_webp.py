"""The port's WebP decoder (``data/webp.py``, the bitstreams in
``csrc/host/webp_decode.cpp``) vs the JAX package's ``imdecode_cv2`` /
``imread_cv2``, on the CPU.

* Every fixture of ``tests/torch_port_data/webp/`` (cv2's and PIL's lossy,
  lossless, alpha and animated files; hand-written VP8 frames with
  segments, both loop filters, sharpness, filter deltas, 8 partitions and
  large coefficients; VP8L streams with all four transforms, every
  predictor mode, the colour cache, LZ77 and a meta prefix image; an
  animation's first frame inside a larger canvas; raw and VP8L-coded ALPH):
  bit-equal to ``imdecode_cv2`` and to the pixels the card's smoke reads
  (``expected.npz``).
* A seeded fuzz over quality, method, lossless, alpha and sides down to
  1x1, and one over hand-written VP8 and VP8L streams: bit-equal wherever
  cv2 decodes, ``ValueError`` where it returns ``None`` (truncated files,
  a damaged ALPH, a canvas past OpenCV's size limit).  The hand-written
  streams take RFC 6386's tables from the decoder's own source
  (``make_web_fixtures._table``); cv2's pixels, not the port's, are what
  they are held to, so a wrong table still fails.
* The refusal: AVIF raises ``UnsupportedImageFormat`` naming the format;
  the headers of JPEG 2000, Sun raster, PFM, Radiance HDR and OpenEXR
  files, once refused by name, are held to cv2 (``ValueError`` where it
  gives ``None``), as is garbage.
* The fault of the port against the reference, repaired: a CSV naming
  ``.webp``, ``.gif`` and ``.pgm`` lines trains and evaluates under JAX
  (its dataset and eval CLI read any file the CSV names through cv2); the
  port's dataset raised ``UnsupportedImageFormat`` on them.  Both datasets
  now read them to equal pixels, and the eval CLIs give equal rows.
"""

import csv
import io
import os
import re
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from rcnn_ocr_tpu.data import dataset as jax_dataset  # noqa: E402
from rcnn_ocr_tpu.data import transforms as jax_tf  # noqa: E402
from rcnn_ocr_tpu_torch.data import dataset, image_io  # noqa: E402
from tests.test_torch_port_beam_engine import files  # noqa: E402,F401
from tests.test_torch_port_data import CS, JCS  # noqa: E402
from tests.torch_port_data.make_web_fixtures import (  # noqa: E402
    anmf, chunk, gif_bytes, pnm_bytes, riff, vp8_frame, vp8l_bytes, vp8x, webp_chunks)

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "webp"
NAMES = sorted(p.name for p in FIXTURES.glob("*.webp"))


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


def _pil(img, **kw) -> bytes:
    from PIL import Image

    bio = io.BytesIO()
    Image.fromarray(img).save(bio, format="WEBP", **kw)
    return bio.getvalue()


# --- fixtures ---------------------------------------------------------------------------

def test_fixtures_cover_the_paths(expected):
    kinds = ("cv2_lossy", "cv2_lossless", "pil_lossy_m0", "pil_lossy_m6", "_1x1", "alpha_lossy",
             "alpha_lossless", "anim_lossy", "anim_lossless", "segments_rel", "segments_abs",
             "simple", "sharp", "lfdelta", "8parts", "skip", "bigcoeffs", "probupdate", "level0",
             "bpred", "all_transforms", "16_modes", "cache", "lz77", "meta", "bundle1",
             "bundle2", "bundle3", "anim_offset_vp8l", "anim_offset_vp8_alpha", "alph_raw_filter1",
             "alph_raw_filter2", "alph_raw_filter3", "alph_vp8l", "metadata", "webp_line_",
             "webpa_line_")
    for kind in kinds:
        assert any(kind in n for n in NAMES), kind
    assert sorted(expected) == NAMES
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 160 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_fixture_is_bit_equal_to_cv2(name, expected):
    want = jax_tf.imread_cv2(str(FIXTURES / name))
    got = image_io.imread(str(FIXTURES / name))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, expected[name])


def test_image_size_falls_back_to_a_decode_as_jax_sizes_the_fixtures():
    """JAX's ``image_size`` parses no WebP header (it decodes); the port's
    gives the same sides on every fixture, the animations' canvas too."""
    for name in NAMES:
        path = str(FIXTURES / name)
        assert image_io.image_size(path) == jax_tf.image_size(path), name


def test_colour_under_alpha_0_comes_out_as_coded():
    """cv2 drops alpha: nothing is composited or premultiplied, in lossless
    and (within the codec) lossy files alike."""
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (9, 14, 3), dtype=np.uint8)
    rgba = np.dstack([rgb, np.zeros((9, 14), np.uint8)])
    data = _pil(rgba, lossless=True, exact=True)
    np.testing.assert_array_equal(image_io.imdecode(data), rgb)
    np.testing.assert_array_equal(image_io.imdecode(data), jax_tf.imdecode_cv2(data))
    _assert_as_cv2(_pil(rgba, quality=90, exact=True))


def test_animation_gives_its_first_frame_on_a_black_canvas():
    frame = vp8l_bytes(np.full((5, 7), 0xFF336699, np.int64))
    data = riff(vp8x(20, 12, 0x02), chunk(b"ANIM", bytes(6)),
                anmf(6, 4, 7, 5, chunk(b"VP8L", frame)),
                anmf(0, 0, 7, 5, chunk(b"VP8L", vp8l_bytes(np.full((5, 7), 0xFFFFFFFF)))))
    got = image_io.imdecode(data)
    want = np.zeros((12, 20, 3), np.uint8)
    want[4:9, 6:13] = (0x33, 0x66, 0x99)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_tf.imdecode_cv2(data))


SIZE_LIMIT = {  # case: (canvas, animated, whether cv2 decodes it)
    "animation on a 2^24 x 2^24 canvas": ((1 << 24, 1 << 24), True, False),
    "animation on a canvas one pixel wider than 1 << 20": (((1 << 20) + 1, 1), True, False),
    "animation on a 32768x32769 canvas": ((32768, 32769), True, False),
    "animation on a canvas 1 << 20 wide": ((1 << 20, 1), True, True),
    "still image on a 2^24 x 2^24 canvas": ((1 << 24, 1 << 24), False, False),
}


@pytest.mark.parametrize("case", sorted(SIZE_LIMIT))
def test_canvas_past_opencv_limit_raises_value_error(case):
    """A VP8X canvas past OpenCV's limit (sides over 1 << 20, over 1 << 30
    pixels) around a 1x1 frame: cv2 refuses it before it allocates, and the
    port raises ``ValueError`` before it allocates the canvas."""
    (cw, ch), animated, decodes = SIZE_LIMIT[case]
    frame = chunk(b"VP8L", vp8l_bytes(np.full((1, 1), 0xFF336699, np.int64)))
    data = (riff(vp8x(cw, ch, 0x02), chunk(b"ANIM", bytes(6)), anmf(0, 0, 1, 1, frame))
            if animated else riff(vp8x(cw, ch), frame))
    assert _assert_as_cv2(data, case) == decodes


# --- fuzz -------------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_fuzz_of_encoder_output_is_bit_equal(seed):
    """cv2's and PIL's encoders over quality, method, lossless, alpha and
    sides (1x1 and odd ones among them); each file also cut short."""
    rng = np.random.default_rng(1400 + seed)
    decoded = 0
    for k in range(12):
        h, w = (1, 1) if k == 0 else (int(v) for v in rng.integers(1, 48, 2))
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx * 5 + yy, yy * 9, (xx * yy) % 256], axis=2) % 256
        img = np.clip(img + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
        if rng.random() < 0.3:
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        kw = dict(lossless=bool(rng.random() < 0.4), quality=int(rng.integers(0, 101)),
                  method=int(rng.integers(0, 7)))
        if rng.random() < 0.4:
            alpha = rng.integers(0, 256, (h, w), dtype=np.uint8)
            alpha[rng.random((h, w)) < 0.3] = 0
            data = _pil(np.dstack([img, alpha]), exact=bool(rng.random() < 0.5), **kw)
        elif rng.random() < 0.5:
            data = _pil(img, **kw)
        else:
            q = 101 if kw["lossless"] else kw["quality"]
            data = cv2.imencode(".webp", img[:, :, ::-1], [cv2.IMWRITE_WEBP_QUALITY, q])[1].tobytes()
        info = (seed, k, h, w, kw)
        decoded += _assert_as_cv2(data, info)
        _assert_as_cv2(data[: int(rng.integers(12, len(data)))], info + ("cut",))
    assert decoded == 12


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_of_hand_written_streams_is_bit_equal(seed):
    """VP8 frames with random headers (segments, filters, sharpness, deltas,
    partitions, skip flags, probability updates) and VP8L streams with
    random transforms, caches, LZ77 and meta prefix images."""
    rng = np.random.default_rng(1500 + seed)
    for k in range(4):
        w, h = (int(v) for v in rng.integers(1, 40, 2))
        kw = dict(q=int(rng.integers(0, 128)), simple=bool(rng.random() < 0.3),
                  level=int(rng.integers(0, 64)), sharpness=int(rng.integers(0, 8)),
                  segments=int(rng.random() < 0.5), absolute=bool(rng.random() < 0.5),
                  partitions=int(rng.integers(0, 4)), skip_prob=int(rng.choice([0, 60, 200])),
                  b_pred=float(rng.random()), update_probs=float(rng.choice([0, 0.05])),
                  quant_deltas=tuple(int(v) for v in rng.integers(-8, 8, 5)))
        if rng.random() < 0.5:
            kw["lf_deltas"] = tuple(tuple(None if rng.random() < 0.5 else int(v) for v in
                                          rng.integers(-30, 31, 4)) for _ in range(2))
        assert _assert_as_cv2(riff(chunk(b"VP8 ", vp8_frame(w, h, seed=int(seed * 10 + k), **kw))),
                              (w, h, kw))
        ncol = int(rng.integers(1, 40))
        pal = (rng.integers(0, 1 << 32, ncol)).astype(np.int64)
        argb = pal[rng.integers(0, ncol, (h, w))]
        order = [t for t in (("index",), ("predict", int(rng.integers(2, 5))),
                             ("color", int(rng.integers(2, 5))), ("green",)) if rng.random() < 0.6]
        opts = dict(transforms=order, cache_bits=int(rng.choice([0, 1, 4, 10])),
                    lz77=bool(rng.random() < 0.5), meta_bits=int(rng.choice([0, 2, 3])),
                    seed=int(seed * 10 + k))
        assert _assert_as_cv2(riff(chunk(b"VP8L", vp8l_bytes(argb, **opts))), (w, h, opts))


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_of_damaged_streams_is_bit_equal(seed):
    """One flipped bit in a lossy or lossless file, or the stream cut inside
    its chunk: libwebp's reader runs on past the chunk, its coder's
    invariant breaks (a first byte of 0xff), coefficients leave
    [-2048, 2047] for its SIMD transform; the port follows it through all of
    that, or raises where it fails."""
    rng = np.random.default_rng(1900 + seed)
    for k in range(4):
        h, w = (int(v) for v in rng.integers(8, 48, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        files = {"VP8 ": webp_chunks(_pil(img, quality=int(rng.integers(5, 95))))[0][1],
                 "VP8L": webp_chunks(_pil(img, lossless=True))[0][1]}
        for tag, body in files.items():
            for _ in range(40):
                flipped = bytearray(body)
                flipped[int(rng.integers(0, len(body)))] ^= 1 << int(rng.integers(0, 8))
                _assert_as_cv2(riff(chunk(tag.encode(), bytes(flipped))), (seed, k, tag, "flip"))
            cut = int(rng.integers(1, len(body)))
            _assert_as_cv2(riff(chunk(tag.encode(), body[:cut])), (seed, k, tag, "cut", cut))


def _lossy_with_alpha():
    rng = np.random.default_rng(9)
    rgba = rng.integers(0, 256, (13, 17, 4), dtype=np.uint8)
    data = _pil(rgba, quality=80)
    parts = dict(webp_chunks(data))
    return parts[b"ALPH"], parts[b"VP8 "]


ALPH_CASES = {
    "reserved bits set": lambda a: bytes([a[0] | 0x40]) + a[1:],
    "compression 2": lambda a: bytes([(a[0] & ~3) | 2]) + a[1:],
    "preprocessing 2": lambda a: bytes([(a[0] & 0xCF) | 0x20]) + a[1:],
    "VP8L stream cut in half": lambda a: a[: len(a) // 2],
    "raw data one byte short": lambda a: b"\x00" + bytes(17 * 13 - 1),
    "empty": lambda a: b"",
    "raw data, filter 3": lambda a: b"\x0c" + bytes(17 * 13),
}


@pytest.mark.parametrize("case", sorted(ALPH_CASES))
def test_alph_chunk_parses_as_cv2_parses_it(case):
    """A damaged ALPH fails the file in cv2 and in the port; a sound one
    decodes, its values never reaching the output."""
    alph, frame = _lossy_with_alpha()
    data = riff(vp8x(17, 13, 0x10), chunk(b"ALPH", ALPH_CASES[case](alph)), chunk(b"VP8 ", frame))
    assert _assert_as_cv2(data) == (case == "raw data, filter 3")


@pytest.mark.parametrize("cut", ["half", "last byte"])
@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha"])
def test_truncated_file_raises_value_error(kind, cut):
    img = np.random.default_rng(2).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    data = (_pil(img, quality=70) if kind == "lossy" else _pil(img, lossless=True)
            if kind == "lossless" else _pil(np.dstack([img, img[:, :, 0]]), quality=70))
    data = data[: len(data) // 2] if cut == "half" else data[:-1]
    assert _cv2(data) is None
    with pytest.raises(ValueError) as err:
        image_io.imdecode(data)
    assert not isinstance(err.value, image_io.UnsupportedImageFormat)


# --- refusal ----------------------------------------------------------------------------

REFUSED = {  # case: (the name the refusal gives, the file's first bytes)
    "AVIF": ("AVIF", b"\x00\x00\x00\x1cftypavif\x00\x00\x00\x00avifmif1miaf" + bytes(32)),
    "AVIF sequence": ("AVIF", b"\x00\x00\x00\x1cftypavis\x00\x00\x00\x00avismif1" + bytes(32)),
}
# headers the port refused by name until it read their formats (OpenEXR:
# this cv2 has none): each now held to cv2
HEADERS = {
    "JP2": b"\x00\x00\x00\x0cjP  \r\n\x87\n\x00\x00\x00\x14ftypjp2 " + bytes(32),
    "J2K": b"\xff\x4f\xff\x51\x00\x29" + bytes(48),
    "Sun raster": b"\x59\xa6\x6a\x95" + bytes(28),
    "PFM": b"PF\n2 1\n-1.0\n" + bytes(24),
    "PFM gray": b"Pf\n2 1\n-1.0\n" + bytes(8),
    "Radiance HDR": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n" + bytes(8),
    "Radiance HDR RGBE": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n" + bytes(8),
    "OpenEXR": b"\x76\x2f\x31\x01\x02\x00\x00\x00" + bytes(24),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_formats_still_refused_are_named(kind):
    name, data = REFUSED[kind]
    with pytest.raises(image_io.UnsupportedImageFormat, match=re.escape(f"cannot decode {name}:")):
        image_io.imdecode(data)


@pytest.mark.parametrize("kind", sorted(HEADERS))
def test_headers_of_formats_once_refused_are_held_to_cv2(kind):
    """PFM and HDR headers over zeros decode (to black); the others give
    cv2 ``None`` and the port ``ValueError``."""
    assert _assert_as_cv2(HEADERS[kind], kind) == kind.startswith(("PFM", "Radiance"))


def test_garbage_is_an_unknown_format():
    """Bytes cv2 reads as no image are a damaged sample (``ValueError``,
    which the datasets quarantine), not a format to refuse by name."""
    with pytest.raises(ValueError, match="not an image cv2 reads") as err:
        image_io.imdecode(b"not an image at all")
    assert not isinstance(err.value, image_io.UnsupportedImageFormat)
    assert _cv2(b"not an image at all") is None


# --- the fault: WebP, GIF and Netpbm rows under the datasets and the eval CLI --------

def _write_lines(root: Path, labels):
    """Lines as lossy and lossless WebP, interlaced GIF with a transparent
    index, binary and ASCII PGM, each its own extension; the CSV names
    them (JAX's dataset joins the name to the root whatever its
    extension)."""
    from tests.test_torch_port_beam_engine import _images
    from tests.test_torch_port_eval_cli import WIDTHS

    rows = []
    for i, (img, label) in enumerate(zip(_images(len(labels), seed=4, widths=WIDTHS), labels)):
        kind = i % 5
        if kind == 0:
            name, data = f"line{i}.webp", _pil(img, quality=90)
        elif kind == 1:
            name, data = f"line{i}.webp", _pil(np.dstack([img, img[:, :, 1]]), lossless=True,
                                                exact=True)
        elif kind == 2:
            gray = img.mean(axis=2).astype(np.uint8) // 16
            name, data = f"line{i}.gif", gif_bytes(
                [dict(idx=gray, interlace=True, transparent=int(gray[0, 0]), mcs=4)],
                (gray.shape[1], gray.shape[0]), np.repeat(np.arange(16)[:, None] * 17, 3, 1),
                bg=int(gray[0, 0]))
        else:
            gray = img.mean(axis=2).astype(np.uint8)
            name, data = f"line{i}.pgm", pnm_bytes(gray, 5 if kind == 3 else 2, 255)
        (root / name).write_bytes(data)
        rows.append((name, label))
    return rows


def test_dataset_reads_webp_gif_and_pgm_rows_as_the_jax_dataset(tmp_path):
    """The port's ``OCRDataset`` raised ``UnsupportedImageFormat`` on these
    rows where JAX's trains on them; both now give every row the same
    pixels and quarantine nothing."""
    root = tmp_path / "ds"
    root.mkdir()
    rows = _write_lines(root, list("abcdefghij"))
    csv_path = root / "labels.csv"
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows(rows)
    kw = dict(max_len=4, verbose=False)
    ours = dataset.OCRDataset(str(csv_path), str(root), CS.stoi, **kw)
    theirs = jax_dataset.OCRDataset(str(csv_path), str(root), JCS.stoi, **kw)
    assert len(ours) == len(theirs) == len(rows)
    for i in range(len(rows)):
        got, label = ours[i]
        want, want_label = theirs[i]
        assert label == want_label == rows[i][1]
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jax_tf.imread_cv2(os.path.join(root, rows[i][0])).astype(np.float32) / 255.0)
    assert not any(ours._invalid_mask), "the port quarantined a row JAX reads"


def test_eval_cli_on_webp_gif_and_pgm_lines_matches_jax(files, tmp_path, monkeypatch):  # noqa: F811
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


# --- EXIF orientation --------------------------------------------------------------------

def _exif_parts():
    from tests.torch_port_data.make_png_fixtures import exif_tiff

    rng = np.random.default_rng(21)
    px = rng.integers(0, 1 << 24, (9, 14)).astype(np.int64) | (0xFF << 24)
    image = chunk(b"VP8L", vp8l_bytes(px.astype(np.uint32), seed=4))
    return exif_tiff, image, 14, 9


@pytest.mark.parametrize("where", ["before", "after"])
@pytest.mark.parametrize("order", ["MM", "II"])
@pytest.mark.parametrize("o", range(10))
def test_exif_orientation_grid_matches_cv2(o, order, where):
    """An EXIF chunk of orientation 0-9, either byte order, before or
    after the image: the image turned as cv2 turns it."""
    from rcnn_ocr_tpu_torch.data import exif

    exif_tiff, image, w, h = _exif_parts()
    x = chunk(b"EXIF", exif_tiff(o, order))
    data = riff(vp8x(w, h, 0x08), *((x, image) if where == "before" else (image, x)))
    assert _assert_as_cv2(data, (o, order, where))
    plain = image_io.imdecode(riff(image))
    np.testing.assert_array_equal(image_io.imdecode(data),
                                  exif.apply(plain, o if 1 <= o <= 8 else 1))


def _exif_cases():
    exif_tiff, image, w, h = _exif_parts()
    x6, x3 = chunk(b"EXIF", exif_tiff(6)), chunk(b"EXIF", exif_tiff(3, "II"))
    lossy = chunk(b"VP8 ", vp8_frame(w, h, seed=5))
    return {
        "flag unset": riff(vp8x(w, h, 0), image, x6),
        "flag with alpha": riff(vp8x(w, h, 0x18), image, x6),
        "reserved flag": riff(vp8x(w, h, 0x09), image, x6),
        "Exif prefix": riff(vp8x(w, h, 0x08), image,
                            chunk(b"EXIF", exif_tiff(6, prefix=b"Exif\x00\x00"))),
        "two EXIF chunks": riff(vp8x(w, h, 0x08), image, x6, x3),
        "empty EXIF": riff(vp8x(w, h, 0x08), image, chunk(b"EXIF", b"")),
        "odd-sized EXIF": riff(vp8x(w, h, 0x08), image, chunk(b"EXIF", exif_tiff(6) + b"x")),
        "junk before EXIF": riff(vp8x(w, h, 0x08), image, b"\x01\x02\x03", x6),
        "EXIF cut by the file's end": riff(vp8x(w, h, 0x08), image, x6[:-4]),
        "EXIF past the RIFF size": riff(vp8x(w, h, 0x08), image, x6)[:-6],
        "unknown chunk before EXIF": riff(vp8x(w, h, 0x08), image, chunk(b"ABCD", b"xy"), x6),
        "ICCP before EXIF": riff(vp8x(w, h, 0x28), chunk(b"ICCP", bytes(10)), x6, image),
        "second image": riff(vp8x(w, h, 0x08), image, image, x6),
        "simple file, EXIF after": riff(image, x6),
        "lossy, EXIF before": riff(vp8x(w, h, 0x08), x6, lossy),
        "animation": riff(vp8x(w + 2, h + 4, 0x0A), chunk(b"ANIM", bytes(6)),
                          anmf(2, 4, w, h, image), x6),
        "animation, EXIF before ANIM": riff(vp8x(w, h, 0x0A), x6, chunk(b"ANIM", bytes(6)),
                                            anmf(0, 0, w, h, image)),
        "animation, flag unset": riff(vp8x(w, h, 0x02), chunk(b"ANIM", bytes(6)),
                                      anmf(0, 0, w, h, image), x6),
        "animation, reserved flag": riff(vp8x(w, h, 0x8A), chunk(b"ANIM", bytes(6)),
                                         anmf(0, 0, w, h, image), x6),
        "animation, image outside ANMF": riff(vp8x(w, h, 0x0A), chunk(b"ANIM", bytes(6)),
                                              anmf(0, 0, w, h, image), image),
        "VP8X image padded past the RIFF size": _odd_riff(riff(vp8x(w, h, 0x08), image)),
    }


def _odd_riff(data):
    """The RIFF size one short, so an odd image chunk's padding byte lies
    past it (libwebp's ParseOptionalChunks counts the padding)."""
    size = struct.unpack_from("<I", data, 4)[0]
    return data[:4] + struct.pack("<I", size - 1) + data[8:]


@pytest.mark.parametrize("case", sorted(_exif_cases()))
def test_exif_chunk_cases_match_cv2(case):
    """Where the EXIF chunk counts: libwebp's demuxer must accept the whole
    file (OpenCV reads the chunk through it, and decodes animations
    through it: a file it refuses is cv2's None there)."""
    _assert_as_cv2(_exif_cases()[case], case)


@pytest.mark.parametrize("seed", range(3))
def test_exif_container_fuzz_matches_cv2(seed):
    """EXIF, XMP, ICCP, unknown chunks and junk placed at random around a
    lossy or lossless image or animation frame, random VP8X flags, files
    cut or their RIFF size shortened."""
    from tests.torch_port_data.make_png_fixtures import exif_tiff

    rng = np.random.default_rng(2100 + seed)
    for k in range(60):
        h, w = (int(v) for v in rng.integers(4, 30, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        parts = webp_chunks(_pil(img, lossless=bool(rng.random() < 0.5), quality=80))
        frame = b"".join(chunk(t, b) for t, b in parts if t in (b"VP8 ", b"VP8L", b"ALPH"))
        pool = [chunk(b"EXIF", exif_tiff(int(rng.integers(0, 10)), str(rng.choice(["MM", "II"])))),
                chunk(b"XMP ", b"x" * int(rng.integers(0, 5))), chunk(b"ICCP", b"y" * 3),
                chunk(b"abcd", b"z"), b"\x01\x02\x03", chunk(b"EXIF", exif_tiff(6)),
                chunk(b"VP8L", b"\x2f\x00\x00\x00\x00")]
        extra = [pool[int(rng.choice(len(pool), p=[0.45, 0.1, 0.1, 0.1, 0.05, 0.15, 0.05]))]
                 for _ in range(int(rng.integers(0, 4)))]
        flags = int(rng.choice([0x08, 0x08, 0x08, 0x00, 0x18, 0x09, 0x28, 0x88]))
        if rng.random() < 0.2:
            body = [chunk(b"ANIM", bytes(6)), anmf(0, 0, w, h, frame)]
            for c in extra:
                body.insert(int(rng.integers(0, len(body) + 1)), c)
            data = riff(vp8x(w, h, flags | 0x02), *body)
        else:
            seq = [frame]
            for c in extra:
                seq.insert(int(rng.integers(0, len(seq) + 1)), c)
            data = riff(vp8x(w, h, flags), *seq)
        if rng.random() < 0.15:
            data = (data[: int(rng.integers(30, len(data)))] if rng.random() < 0.5 else
                    data[:4] + struct.pack("<I", struct.unpack_from("<I", data, 4)[0]
                                           - int(rng.integers(1, 8))) + data[8:])
        _assert_as_cv2(data, (seed, k))


def test_exif_fixtures_image_size_is_jaxs():
    """JAX's header probe decodes WebP, so its sides follow the
    orientation; the port's do too."""
    for name in NAMES:
        if name.startswith(("exif", "webpo")):
            path = str(FIXTURES / name)
            assert image_io.image_size(path) == jax_tf.image_size(path), name
