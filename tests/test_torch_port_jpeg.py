"""The port's JPEG decoder vs the JAX package's ``imdecode_cv2``, on the CPU.

* Every decodable fixture of ``tests/torch_port_data/jpeg/`` (4:4:4,
  4:2:2, 4:2:0, 4:4:0, 4:1:1, gray, restart markers, EXIF 3/6/8, PIL's
  optimized tables, Adobe RGB, a frame with no DHT, a damaged frame, 64
  text lines): bit-equal to ``imdecode_cv2`` and to the cv2 pixels the
  card's smoke reads (``expected.npz``).
* A seeded fuzz of sizes (odd and even, 1 to 70 pixels a side), qualities
  and subsamplings written by ``cv2.imencode`` and by PIL: bit-equal.
* Unsupported variants (progressive from cv2 and PIL, arithmetic,
  lossless, hierarchical, 12-bit, CMYK) raise ``UnsupportedImageFormat``
  naming the variant; a truncated stream raises ``ValueError`` as JAX's
  does (cv2 returns None), and one cut short but closed by an EOI decodes
  as cv2 does (zero-filled).
* Frames with no DHT segment (Motion-JPEG) decode with the standard
  tables, and a seeded fuzz of damaged entropy data (bytes changed, runs
  of garbage, restart markers renumbered or dropped) decodes bit-equal to
  cv2, which decodes it with warnings, or raises where cv2 fails.
* ``image_size`` equals the decoded shape and JAX's for EXIF 1-8.
* Decodes from eight threads at once equal the serial ones.
* JPEG datasets with no further change: ``OCRInference.predict`` on JPEG
  paths and the eval CLI give JAX's strings and report; ``run_training`` on
  JPEG lines equals a run on PNGs of the same (cv2-decoded) pixels.
"""

import csv
import io
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

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "jpeg"
NAMES = sorted(p.name for p in FIXTURES.glob("*.jpg") if not p.name.startswith("progressive"))
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


def _assert_bit_equal(data):
    got = image_io.imdecode(data)
    want = jax_tf.imdecode_cv2(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


# --- fixtures and fuzz ----------------------------------------------------------------

def test_fixtures_cover_the_paths():
    kinds = ("s444", "s422", "s420", "s440", "s411", "gray", "rst", "exif3", "exif6", "exif8",
             "q50", "q100", "optimized", "adobe_rgb", "nodht", "damaged")
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


def _variant(kind):
    img = _smooth(np.random.default_rng(5), 20, 30)
    base = _cv2_jpeg(img)
    return {
        "progressive JPEG": lambda: _cv2_jpeg(img, IMWRITE_JPEG_PROGRESSIVE=1),
        "progressive JPEG (PIL)": lambda: _pil_jpeg(img, progressive=True),
        "arithmetic-coded JPEG": lambda: _patched_sof(base, marker=0xC9),
        "lossless JPEG": lambda: _patched_sof(base, marker=0xC3),
        "hierarchical JPEG": lambda: _patched_sof(base, marker=0xC5),
        "12-bit JPEG": lambda: _patched_sof(base, precision=12),
        "4-component JPEG (CMYK / YCCK)": lambda: _pil_jpeg(img, mode="CMYK"),
    }[kind]()


@pytest.mark.parametrize("kind", ["progressive JPEG", "progressive JPEG (PIL)",
                                  "arithmetic-coded JPEG", "lossless JPEG", "hierarchical JPEG",
                                  "12-bit JPEG", "4-component JPEG (CMYK / YCCK)"])
def test_unsupported_variants_raise_naming_them(kind):
    with pytest.raises(image_io.UnsupportedImageFormat) as err:
        image_io.imdecode(_variant(kind))
    assert kind.replace(" (PIL)", "") in str(err.value)
    assert image_io.SUPPORTED in str(err.value)


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
    """Eight text lines as JPEGs (q 95, 4:2:0) and their labels CSV (with a
    header, as the eval CLI takes it)."""
    from tests.test_torch_port_eval_cli import LABELS, WIDTHS

    root = tmp_path_factory.mktemp("jpeg_lines")
    rows = []
    for i, (img, label) in enumerate(zip(_images(8, seed=3, widths=WIDTHS), LABELS)):
        (root / f"line{i}.jpg").write_bytes(_cv2_jpeg(img[:, :, ::-1], 95))
        rows.append((f"line{i}.jpg", label))
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
