"""The port's data path vs the JAX package's, on the CPU.

* Image files: the port's PNG/BMP decoder bit-equal to ``imread_cv2`` on
  files cv2 writes (gray, RGB, RGBA, 16-bit; 24/32-bit and gray BMP) and on
  hand-built PNGs (each filter type 0-4, palette and sub-byte depths,
  gray+alpha, Adam7); ``image_size`` equal to JAX's on PNG, BMP, GIF and
  JPEG headers (an EXIF-rotated JPEG too); a progressive JPEG or a GIF
  raises an error naming the supported formats (baseline JPEGs decode:
  ``tests/test_torch_port_jpeg.py``).
* ``OCRDataset`` on a CSV with missing files, foreign characters,
  too-long and empty labels: the same samples and skip counts.
* Samplers: index sequences equal for the same seeds; ``exact_quotas``,
  ``optimal_width_buckets`` and ``lift_buckets_for_ctc`` equal.
* Validation ``DataLoader`` batches: targets, ``valid`` and CTC labels
  equal; images within one uint8 step (the port's ``ResizeAndPad``).
* ``TransformCache`` round trip.
* Host augmentation: the generator state after a call equals JAX's (the
  same draws in the same order); the affine warp within one uint8 step of
  cv2's ``warpAffine`` on at most 0.1% of the pixels; the whole train
  transform within 4 uint8 steps (resize and warp steps, and the
  brightness/contrast truncation, stacked).
* Device augmentation ops vs JAX's on the same matrices and parameters
  within 1e-6 (the matrices' shift column, in pixels, within 1e-6 of the
  image size); apply shares and identities by semantics.
* Metrics equal; ``Config`` warnings equal except ``p_EdgeCrop`` (no
  warning in the port); the resume overlay equal.
"""

import csv
import os
import struct
import warnings
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcnn_ocr_tpu.data import cache as jax_cache
from rcnn_ocr_tpu.data import dataset as jax_dataset
from rcnn_ocr_tpu.data import loader as jax_loader
from rcnn_ocr_tpu.data import transforms as jax_tf
from rcnn_ocr_tpu.ops import augment as jax_aug
from rcnn_ocr_tpu.training import config as jax_config
from rcnn_ocr_tpu.training import metrics as jax_metrics
from rcnn_ocr_tpu.vocab.charset import Charset as JaxCharset
from rcnn_ocr_tpu_torch.data import cache, dataset, image_io, loader
from rcnn_ocr_tpu_torch.data import transforms as tf
from rcnn_ocr_tpu_torch.ops import augment
from rcnn_ocr_tpu_torch.training import config, metrics
from rcnn_ocr_tpu_torch.vocab.charset import Charset

TOKENS = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
CS, JCS = Charset.from_tokens(TOKENS), JaxCharset.from_tokens(TOKENS)


# --- a PNG writer with chosen row filters --------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack(samples, depth):
    h, w, _ = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.reshape(h, -1).astype(np.uint8)
    per = 8 // depth
    v = np.pad(samples.reshape(h, w).astype(np.uint8), ((0, 0), (0, (-w) % per)))
    return (v.reshape(h, -1, per) << np.arange(8 - depth, -1, -depth)).sum(-1).astype(np.uint8)


def _filter_rows(rows, bpp, ftypes):
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y, r in enumerate(rows.astype(np.int32)):
        f = ftypes[y % len(ftypes)]
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1, 4: _paeth(left, prev, upleft)}[f]
        out.append(bytes([f]) + ((r - pred) & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def png_bytes(samples, ctype, depth, ftypes=(0, 1, 2, 3, 4), palette=None, interlace=False):
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b"".join(_filter_rows(_pack(samples[y0::dy, x0::dx], depth), bpp, ftypes)
                       for x0, y0, dx, dy in _ADAM7 if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter_rows(_pack(samples, depth), bpp, ftypes)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                          int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


# --- image files ---------------------------------------------------------------------

CV2_FILES = {
    "gray.png": lambda r: r.integers(0, 256, (13, 37), dtype=np.uint8),
    "rgb.png": lambda r: r.integers(0, 256, (21, 50, 3), dtype=np.uint8),
    "rgba.png": lambda r: r.integers(0, 256, (9, 31, 4), dtype=np.uint8),
    "gray16.png": lambda r: r.integers(0, 65536, (11, 23), dtype=np.uint16),
    "rgb16.png": lambda r: r.integers(0, 65536, (7, 19, 3), dtype=np.uint16),
    "rgb.bmp": lambda r: r.integers(0, 256, (15, 33, 3), dtype=np.uint8),
    "gray.bmp": lambda r: r.integers(0, 256, (12, 29), dtype=np.uint8),
    "rgba.bmp": lambda r: r.integers(0, 256, (10, 17, 4), dtype=np.uint8),
}


@pytest.mark.parametrize("name", sorted(CV2_FILES))
def test_decoder_is_bit_equal_to_cv2_on_files_cv2_writes(tmp_path, name):
    path = str(tmp_path / name)
    assert cv2.imwrite(path, CV2_FILES[name](np.random.default_rng(len(name))))
    got, want = image_io.imread(path), jax_tf.imread_cv2(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert image_io.image_size(path) == jax_tf.image_size(path) == want.shape[:2]


# (color type, bit depth, filters, interlaced)
HAND_BUILT = ([(2, 8, (f,), False) for f in range(5)]
              + [(3, d, (0, 1, 2, 3, 4), False) for d in (1, 2, 4, 8)]
              + [(0, d, (4, 3, 2, 1, 0), False) for d in (1, 2, 4, 8, 16)]
              + [(4, 8, (3,), False), (6, 16, (4,), False), (2, 8, (0, 1, 2, 3, 4), True),
                 (0, 2, (4, 1), True), (3, 4, (3, 2), True)])


@pytest.mark.parametrize("ctype,depth,ftypes,interlace", HAND_BUILT)
def test_decoder_is_bit_equal_to_cv2_on_hand_built_pngs(ctype, depth, ftypes, interlace):
    rng = np.random.default_rng(ctype * 100 + depth * 10 + ftypes[0] + 50 * interlace)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    h, w = int(rng.integers(3, 23)), int(rng.integers(3, 41))
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (1 << depth, 3))
        samples = rng.integers(0, 1 << depth, (h, w, 1))
    else:
        samples = rng.integers(0, 1 << depth, (h, w, channels))
    data = png_bytes(samples.astype(np.uint16 if depth == 16 else np.uint8), ctype, depth,
                     ftypes, palette, interlace)
    np.testing.assert_array_equal(image_io.imdecode(data), jax_tf.imdecode_cv2(data))


def _exif_jpeg(data: bytes, orientation: int) -> bytes:
    ifd = struct.pack("<H", 1) + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
    tiff = b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0)
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


def test_image_size_matches_jax_on_headers(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (17, 45, 3), dtype=np.uint8)
    ok, jpg = cv2.imencode(".jpg", img)
    assert ok
    files = {
        "a.png": cv2.imencode(".png", img)[1].tobytes(),
        "a.bmp": cv2.imencode(".bmp", img)[1].tobytes(),
        "a.jpg": jpg.tobytes(),
        "rot6.jpg": _exif_jpeg(jpg.tobytes(), 6),
        "rot3.jpg": _exif_jpeg(jpg.tobytes(), 3),
        "a.gif": b"GIF89a" + struct.pack("<HH", 45, 17) + b"\x00" * 24,
    }
    for name, data in files.items():
        path = tmp_path / name
        path.write_bytes(data)
        assert image_io.image_size(str(path)) == jax_tf.image_size(str(path)), name
    assert image_io.image_size(str(tmp_path / "rot6.jpg")) == (45, 17)


def test_jpeg_decoding_raises_naming_the_supported_formats(tmp_path):
    path = tmp_path / "line.jpg"
    path.write_bytes(cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8),
                                  [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes())
    with pytest.raises(image_io.UnsupportedImageFormat, match="PNG, BMP and baseline JPEG"):
        image_io.imread(str(path))
    with pytest.raises(NotImplementedError, match="progressive JPEG"):
        tf.load_rgb_uint8(str(path))
    gif = tmp_path / "line.gif"
    gif.write_bytes(b"GIF89a" + struct.pack("<HH", 8, 8) + b"\x00" * 24)
    with pytest.raises(image_io.UnsupportedImageFormat, match="cannot decode GIF"):
        image_io.imread(str(gif))
    with pytest.raises(ValueError, match="truncated"):
        image_io.imdecode(png_bytes(np.zeros((2, 2, 3), np.uint8), 2, 8)[:-30])


# --- datasets and samplers -----------------------------------------------------------

def _write_dataset(root, labels, sizes=None, seed=0):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    csv_path = os.path.join(root, "labels.csv")
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        wr = csv.writer(f)
        for i, label in enumerate(labels):
            h, w = sizes[i] if sizes else (24, 96)
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(root, f"img_{i:04d}.png"), img)
            wr.writerow([f"img_{i:04d}.png", label])
    return csv_path


def test_ocr_dataset_screens_rows_like_jax(tmp_path):
    root = str(tmp_path / "ds")
    csv_path = _write_dataset(root, ["ab", "cd", "e f"])
    with open(csv_path, "a", newline="", encoding="utf-8") as f:
        wr = csv.writer(f)
        for row in (["missing.png", "ab"], ["img_0000.png", "XYZ"], ["img_0000.png", "abcdefghij"],
                    ["img_0000.png", ""], ["only-one-cell"], ["", "ab"], ["img_0001.png", "a b"]):
            wr.writerow(row)
    kw = dict(max_len=4, verbose=False)
    ours = dataset.OCRDataset(csv_path, root, CS.stoi, **kw)
    theirs = jax_dataset.OCRDataset(csv_path, root, JCS.stoi, **kw)
    assert ours.samples == theirs.samples and len(ours) == 4
    assert ours.skip_counts == theirs._reasons
    assert ours.skip_examples == theirs._examples
    assert ours.missing_chars == theirs._missing_chars
    img, label = ours[3]
    want_img, want_label = theirs[3]
    assert label == want_label == "a b"
    np.testing.assert_array_equal(img, want_img)


def _epochs(sampler, n=2):
    return [[list(b) if not isinstance(b, loader.BucketBatch) else (b.width, list(b.indices))
             for b in sampler] for _ in range(n)]


def _jax_epochs(sampler, n=2):
    return [[list(b) if not isinstance(b, jax_loader.BucketBatch) else (b.width, list(b.indices))
             for b in sampler] for _ in range(n)]


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def test_sampler_index_sequences_equal_jax():
    sets = [_Sized(37), _Sized(23), _Sized(50)]
    props = [0.5, 0.2, 0.3]
    for seed in (0, 7):
        assert _epochs(dataset.ShuffleBatchSampler(sets[0], 8, seed=seed)) == _jax_epochs(
            jax_dataset.ShuffleBatchSampler(sets[0], 8, seed=seed))
        assert _epochs(dataset.ProportionalBatchSampler(sets, 10, props, seed=seed)) == \
            _jax_epochs(jax_dataset.ProportionalBatchSampler(sets, 10, props, seed=seed))
        rng = np.random.default_rng(seed)
        bucket_of = [int(b) for b in rng.choice([32, 64, 96], size=61)]
        assert _epochs(loader.BucketedBatchSampler(bucket_of, 8, seed=seed)) == _jax_epochs(
            jax_loader.BucketedBatchSampler(bucket_of, 8, seed=seed))
        bucket_ofs = [[int(b) for b in rng.choice([32, 64, 96], size=len(s))] for s in sets]
        bucket_ofs[1] = [64] * len(sets[1])  # a dataset absent from two buckets
        for mode in ("expected", "batch"):
            ours = loader.BucketedProportionalBatchSampler(sets, 12, props, bucket_ofs, seed=seed,
                                                           quota_mode=mode)
            theirs = jax_loader.BucketedProportionalBatchSampler(sets, 12, props, bucket_ofs,
                                                                 seed=seed, quota_mode=mode)
            assert _epochs(ours, 3) == _jax_epochs(theirs, 3), mode
            assert ours.bucket_of == theirs.bucket_of


def test_quotas_and_bucket_choices_equal_jax():
    for bs, props in ((32, [1 / 3] * 3), (128, [0.5, 0.5]), (10, [0.7, 0.2, 0.1])):
        assert dataset.exact_quotas(bs, props) == jax_dataset.exact_quotas(bs, props)
    rng = np.random.default_rng(0)
    widths = [int(w) for w in rng.integers(10, 400, size=300)]
    for k in (1, 3, 5):
        for max_width in (None, 256):
            assert loader.optimal_width_buckets(widths, k, max_width=max_width) == \
                jax_loader.optimal_width_buckets(widths, k, max_width=max_width)
    labels = ["abc", "aaaa", "abcdefghij", "", "a b c", "jjjjjj"]

    class Labels:
        def __len__(self):
            return len(labels)

        def sample_label(self, i):
            return labels[i]

    buckets = [16, 32, 64, 96]
    bucket_of = [16] * len(labels)
    assert loader.lift_buckets_for_ctc(Labels(), bucket_of, CS, 8, buckets) == \
        jax_loader.lift_buckets_for_ctc(Labels(), bucket_of, JCS, 8, buckets)
    assert loader.assign_width_buckets([(20, 40), (40, 400)], 32, buckets) == \
        jax_loader.assign_width_buckets([(20, 40), (40, 400)], 32, buckets)


@pytest.fixture(scope="module")
def varied(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("varied"))
    rng = np.random.default_rng(4)
    labels = ["".join(rng.choice(list("abcdefghij"), size=int(rng.integers(1, 7))))
              for _ in range(21)]
    sizes = [(int(rng.integers(16, 48)), int(rng.integers(20, 200))) for _ in labels]
    return _write_dataset(root, labels, sizes), root


@pytest.mark.parametrize("bucketed", [False, True])
def test_validation_loader_batches_match_jax(varied, bucketed):
    csv_path, root = varied
    ours_ds = dataset.OCRDataset(csv_path, root, CS.stoi, max_len=6, verbose=False)
    jax_ds = jax_dataset.OCRDataset(csv_path, root, JCS.stoi, max_len=6, verbose=False)
    if bucketed:
        buckets = [32, 64, 96]
        bo = loader.probe_dataset_buckets(ours_ds, 32, buckets)
        assert bo == jax_loader.probe_dataset_buckets(jax_ds, 32, buckets)
        ours = loader.DataLoader(ours_ds, loader.BucketedBatchSampler(bo, 8, shuffle=False), CS,
                                 6, num_workers=2, static_batch_size=8, with_ctc=True,
                                 bucket_of=bo, transform_for_width=lambda w: tf.ResizeAndPad(32, w))
        theirs = jax_loader.DataLoader(
            jax_ds, jax_loader.BucketedBatchSampler(bo, 8, shuffle=False), JCS, 6,
            num_workers=2, static_batch_size=8, with_ctc=True, bucket_of=bo,
            transform_for_width=lambda w: jax_tf.ResizeAndPad(32, w))
    else:
        ours_ds.transform, jax_ds.transform = tf.ResizeAndPad(32, 128), jax_tf.ResizeAndPad(32, 128)
        ours = loader.DataLoader(ours_ds, dataset.ShuffleBatchSampler(ours_ds, 8, shuffle=False),
                                 CS, 6, num_workers=2, static_batch_size=8, with_ctc=True)
        theirs = jax_loader.DataLoader(
            jax_ds, jax_dataset.ShuffleBatchSampler(jax_ds, 8, shuffle=False), JCS, 6,
            num_workers=2, static_batch_size=8, with_ctc=True)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g["labels"] == w["labels"]
        for k in ("text_in", "target_y", "lengths", "valid", "ctc_labels", "ctc_paddings"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["image"].dtype == w["image"].dtype == np.uint8
        assert g["image"].shape == w["image"].shape
        assert np.abs(g["image"].astype(int) - w["image"]).max() <= 1


def test_loader_seeds_each_sample_and_raises_producer_errors(varied):
    csv_path, root = varied
    ds = dataset.OCRDataset(csv_path, root, CS.stoi, max_len=6, verbose=False)
    ds.transform = tf.get_train_transform({"p_ShiftScaleRotate": 1.0, "p_BrightnessContrast": 1.0},
                                          32, 64)

    def run(epoch):
        dl = loader.DataLoader(ds, dataset.ShuffleBatchSampler(ds, 8, seed=0), CS, 6,
                               num_workers=3, static_batch_size=8, seed=5)
        dl.set_epoch(epoch)
        return np.concatenate([b["image"] for b in dl])

    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError, match="seeded numpy Generator"):
        ds[0]

    class Boom:
        def __iter__(self):
            yield [0]
            raise RuntimeError("sampler broke")

        def __len__(self):
            return 2

    with pytest.raises(RuntimeError, match="sampler broke"):
        list(loader.DataLoader(ds, Boom(), CS, 6))


def test_transform_cache_round_trip(varied, tmp_path):
    csv_path, root = varied
    ds = dataset.OCRDataset(csv_path, root, CS.stoi, max_len=6, verbose=False)
    t = tf.ResizeAndPad(32, 64)
    tc = cache.TransformCache(ds, t, str(tmp_path / "c"))
    first = [tc.fetch(i, lambda i=i: ds.fetch(i, transform=t)) for i in range(len(ds))]
    assert tc.hits() == len(ds)
    again = cache.TransformCache(ds, t, str(tmp_path / "c"))
    served = [again.fetch(i, lambda: pytest.fail("served uncached")) for i in range(len(ds))]
    for (a, la), (b, lb) in zip(first, served):
        np.testing.assert_array_equal(a, b)
        assert la == lb
    # the same directory layout as JAX's: its cache serves the port's rows
    jax_ds = jax_dataset.OCRDataset(csv_path, root, JCS.stoi, max_len=6, verbose=False)
    jtc = jax_cache.TransformCache(jax_ds, jax_tf.ResizeAndPad(32, 64), str(tmp_path / "c"))
    assert jtc.hits() == len(ds)
    assert not cache.TransformCache(ds, tf.get_val_transform(32, 64), str(tmp_path / "d")).enabled


# --- host augmentation ---------------------------------------------------------------

def test_shift_scale_rotate_draws_like_jax_and_warps_like_cv2():
    worst, differing, total = 0, 0, 0
    for i in range(12):
        r = np.random.default_rng(100 + i)
        h, w = int(r.integers(20, 48)), int(r.integers(40, 300))
        img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 2:
            img = np.where(r.random((h, w, 1)) < 0.5, 0, 255).astype(np.uint8).repeat(3, 2)
        ours, theirs = np.random.default_rng(i), np.random.default_rng(i)
        got = tf.shift_scale_rotate(img, ours, 0.03, 0.08, 3)
        want = jax_tf.shift_scale_rotate(img, theirs, 0.03, 0.08, 3)
        assert ours.bit_generator.state == theirs.bit_generator.state
        d = np.abs(got.astype(int) - want)
        worst, differing, total = max(worst, d.max()), differing + (d > 0).sum(), total + d.size
    assert worst <= 1 and differing <= 1e-3 * total, (worst, differing / total)
    m = tf.rotation_matrix((10.5, 3.5), 2.0, 1.05)
    np.testing.assert_array_equal(m, cv2.getRotationMatrix2D((10.5, 3.5), 2.0, 1.05))


@pytest.mark.parametrize("p_edge", [0.0, 1.0])
def test_train_transform_draws_like_jax(p_edge):
    params = {"p_ShiftScaleRotate": 0.5, "p_BrightnessContrast": 0.5, "invert_p": 0.3,
              "scale_limit": 0.035, "contrast_limit": 0.215, "p_EdgeCrop": p_edge}
    ours, theirs = tf.get_train_transform(params, 32, 128), jax_tf.get_train_transform(params, 32, 128)
    img_rng = np.random.default_rng(1)
    for i in range(16):
        img = img_rng.integers(0, 256, (int(img_rng.integers(20, 60)), 200, 3), dtype=np.uint8)
        a, b = np.random.default_rng(i), np.random.default_rng(i)
        got, want = ours(img, a), theirs(img, b)
        assert a.bit_generator.state == b.bit_generator.state
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 4 * 2 / 255 + 1e-6
    np.testing.assert_array_equal(tf.normalize_unit(np.arange(256, dtype=np.uint8)),
                                  jax_tf.normalize_unit(np.arange(256, dtype=np.uint8)))
    img = np.arange(60, dtype=np.uint8).reshape(2, 10, 3)
    np.testing.assert_array_equal(tf.invert_img(img), jax_tf.invert_img(img))
    for seed in range(4):
        np.testing.assert_array_equal(
            tf.random_edge_crop(np.zeros((40, 200, 3)), np.random.default_rng(seed)),
            jax_tf.random_edge_crop(np.zeros((40, 200, 3)), np.random.default_rng(seed)))


# --- device augmentation ops ---------------------------------------------------------

def test_device_augment_ops_match_jax():
    rng = np.random.default_rng(2)
    b, h, w = 5, 12, 30
    angles = rng.uniform(-3, 3, b).astype(np.float32)
    scales = (1 + rng.uniform(-0.08, 0.08, b)).astype(np.float32)
    dx = (rng.uniform(-0.03, 0.03, b) * w).astype(np.float32)
    dy = (rng.uniform(-0.03, 0.03, b) * h).astype(np.float32)
    want_m = np.array(jax_aug.inverse_affine_matrices(*map(jnp.asarray, (angles, scales, dx, dy)),
                                                        h, w))
    got_m = augment.inverse_affine_matrices(*map(torch.from_numpy, (angles, scales, dx, dy)), h, w)
    # fp32 on both sides: the linear part within 1e-6, the shift (in pixels)
    # within 1e-6 of the image's size
    np.testing.assert_allclose(got_m[..., :2].numpy(), want_m[..., :2], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_m[..., 2].numpy(), want_m[..., 2], rtol=0, atol=1e-6 * max(h, w))
    images = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    want = np.asarray(jax_aug.affine_warp(jnp.asarray(images), jnp.asarray(want_m)))
    got = augment.affine_warp(torch.from_numpy(images), torch.from_numpy(want_m))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    # brightness/contrast: JAX's drawn (alpha, beta) read back off a mid-gray
    # ramp (no clipping), then the port's formula on them
    ramp = np.broadcast_to(np.linspace(0.4, 0.6, w, dtype=np.float32)[None, None, :, None],
                           (b, h, w, 3)).copy()
    out = np.asarray(jax_aug.brightness_contrast_batch(jnp.asarray(ramp), jax.random.PRNGKey(0),
                                                       p=1.0))
    alpha = (out[:, 0, -1, 0] - out[:, 0, 0, 0]) / (ramp[0, 0, -1, 0] - ramp[0, 0, 0, 0])
    beta = out[:, 0, 0, 0] - ramp[0, 0, 0, 0] * alpha - 0.5 * (1 - alpha)
    got = augment.apply_brightness_contrast(torch.from_numpy(ramp), torch.from_numpy(alpha),
                                            torch.from_numpy(beta))
    np.testing.assert_allclose(got.numpy(), out, rtol=1e-6, atol=1e-6)
    for p in (0.0, 1.0):
        g = torch.Generator().manual_seed(0)
        want = np.asarray(jax_aug.invert_batch(jnp.asarray(images), jax.random.PRNGKey(0), p=p))
        np.testing.assert_allclose(augment.invert_batch(torch.from_numpy(images), g, p=p).numpy(),
                                   want, rtol=1e-6, atol=1e-6)


def test_device_train_augment_semantics():
    rng = np.random.default_rng(3)
    u8 = torch.from_numpy(rng.integers(0, 256, (400, 8, 16, 3), dtype=np.uint8))
    off = {"p_ShiftScaleRotate": 0, "p_BrightnessContrast": 0, "invert_p": 0}
    out = augment.device_train_augment(u8, torch.Generator().manual_seed(0), off)
    np.testing.assert_allclose(out.numpy(), augment.device_normalize(u8).numpy(), atol=1e-6)
    inv = augment.device_train_augment(u8, torch.Generator().manual_seed(0), dict(off, invert_p=1))
    np.testing.assert_allclose(inv.numpy(), -out.numpy(), atol=1e-6)
    # apply shares: each image flips its own coin
    g = torch.Generator().manual_seed(1)
    x = u8.float() / 255
    changed = (augment.shift_scale_rotate_batch(x, g, p=0.3) != x).flatten(1).any(1).float().mean()
    assert abs(changed.item() - 0.3) < 5 * (0.3 * 0.7 / 400) ** 0.5
    a = augment.device_train_augment(u8, torch.Generator().manual_seed(7), {})
    b = augment.device_train_augment(u8, torch.Generator().manual_seed(7), {})
    assert torch.equal(a, b) and a.dtype == torch.float32
    with pytest.raises(ValueError, match="uint8"):
        augment.device_train_augment(u8.float(), torch.Generator(), {})


# --- metrics and config --------------------------------------------------------------

def test_metrics_equal_jax():
    rng = np.random.default_rng(5)
    alphabet = list("ab cdé")
    pairs = [("".join(rng.choice(alphabet, size=int(rng.integers(0, 12)))),
              "".join(rng.choice(alphabet, size=int(rng.integers(0, 12))))) for _ in range(200)]
    pairs += [("", ""), ("", "x"), ("abc", "")]
    for r, h in pairs:
        assert metrics.levenshtein(r, h) == jax_metrics.levenshtein(r, h)
        assert metrics.character_error_rate(r, h) == jax_metrics.character_error_rate(r, h)
        assert metrics.word_error_rate(r, h) == jax_metrics.word_error_rate(r, h)
        assert metrics.edit_ops(r, h) == jax_metrics.edit_ops(r, h)
    refs, hyps = [p[0] for p in pairs], [p[1] for p in pairs]
    assert metrics.compute_accuracy(refs, hyps) == jax_metrics.compute_accuracy(refs, hyps)
    assert metrics.batch_character_error_rate(refs, hyps) == \
        jax_metrics.batch_character_error_rate(refs, hyps)


def _warnings(cls, data):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cls(data)
    return [str(x.message) for x in w]


def test_config_warnings_and_resume_overlay_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    data = {"epochz": 3, "lr": 0.1, "exp_dir": "e"}
    assert _warnings(config.Config, data) == _warnings(jax_config.Config, data)
    edge = {"p_EdgeCrop": 0.5, "edge_crop_limit": 0.3, "exp_dir": "e"}
    assert _warnings(config.Config, edge) == []
    assert _warnings(jax_config.Config, edge)  # JAX's warns falsely
    assert config.Config({}).exp_dir == jax_config.Config({}).exp_dir == "exp1"

    exp = tmp_path / "run"
    exp.mkdir()
    (exp / "config.json").write_text('{"lr": 0.5, "epochs": 9, "img_h": 32}', encoding="utf-8")
    (exp / "best_acc_ckpt.msgpack").write_bytes(b"")
    (exp / "last_ckpt.msgpack").write_bytes(b"")
    user = {"resume_path": str(exp), "epochs": 12, "batch_size": None}
    ours, theirs = config.Config(user), jax_config.Config(user)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.resume_path.endswith("last_ckpt.msgpack") and ours.epochs == 12
    assert ours.get("batch_size") == theirs.get("batch_size") == 32
    with pytest.raises(FileNotFoundError):
        config.Config({"resume_path": str(tmp_path / "absent")})
