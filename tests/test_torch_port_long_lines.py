"""The port's long-line decodes vs the JAX package's, fp32 on the CPU.

Held (``rcnn_ocr_tpu_torch/long_lines.py`` against ``rcnn_ocr_tpu/long_lines.py``):

* every pure function equal to JAX's on seeded inputs: the junction spans
  (200 tilings, midpoint and blank-snap), segment spans (300 frame
  sequences), ``resolve_tiling`` (and its errors), ``plan_tiles``, the text
  and aligned merges, the frame stitchers and both stitched decodes (greedy
  and host beam, confidence), the tile extractors and
  ``hybrid_decode_driver`` over stub kernels (crops never wider than a
  tile);
* ``height_normalize`` (the port's ``resize_uint8``) within one uint8 step
  of cv2's;
* the engine on lines as high as the model's input (so height
  normalization is the identity on both sides) of 1-6 tiles:
  ``predict_ctc_long`` (greedy and beam, both snaps), ``predict_hybrid_long``
  (greedy and beam) and ``predict_long`` (attention with the ``align`` and
  ``text`` merges, attention beam): strings equal, confidences within 1e-4;
* a line that fits one tile decodes exactly as ``predict`` /
  ``predict_ctc`` decode it, and the ids fast path equals the top-k path.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rcnn_ocr_tpu import long_lines as J  # noqa: E402
from rcnn_ocr_tpu.data.transforms import ResizeAndPad as JaxResizeAndPad  # noqa: E402
from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference  # noqa: E402
from rcnn_ocr_tpu_torch import long_lines as L  # noqa: E402
from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad  # noqa: E402
from rcnn_ocr_tpu_torch.inference import OCRInference  # noqa: E402
from tests.test_torch_port_beam_engine import IMG_H, IMG_W, TOKENS, files  # noqa: E402,F401

TOL = dict(rtol=1e-4, atol=1e-4)
BLANK = 3  # <BLANK> in TOKENS: the CTC blank


def _tiling(rng):
    frames_t = int(rng.integers(4, 33))
    stride = int(rng.choice([2, 4, 8]))
    tile_w = frames_t * stride
    overlap = int(rng.integers(stride, tile_w - stride))
    new_w = int(rng.integers(tile_w + 1, tile_w * 5))
    starts = list(range(0, new_w - tile_w, tile_w - overlap))
    if starts[-1] != new_w - tile_w:
        starts.append(new_w - tile_w)
    return frames_t, tile_w, starts


def test_long_line_spans_fuzz_matches_jax():
    rng = np.random.default_rng(0)
    for trial in range(200):
        frames_t, tile_w, starts = _tiling(rng)
        blank = rng.standard_normal((len(starts), frames_t)) if trial % 2 else None
        got = L.long_line_spans(starts, tile_w, frames_t, blank_scores=blank)
        assert got == J.long_line_spans(starts, tile_w, frames_t, blank_scores=blank), trial
        assert got[0][1] == 0 and got[-1][2] == frames_t


def test_segment_spans_fuzz_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(300):
        ids = rng.choice([0, 0, 0, 4, 5], size=int(rng.integers(1, 120)))
        kw = dict(min_gap=int(rng.integers(1, 5)), margin=int(rng.integers(0, 4)),
                  max_frames=int(rng.integers(3, 40)) if rng.random() < 0.5 else None)
        spans = L.segment_spans(ids, 0, **kw)
        assert spans == J.segment_spans(ids, 0, **kw)
        if kw["max_frames"] is not None:
            assert all(e - s <= kw["max_frames"] for s, e in spans)
    ids = np.array([0] * 3 + [4] * 8 + [0] * 3)  # the cap includes the margin
    assert L.segment_spans(ids, 0, min_gap=3, margin=1, max_frames=8) == [(3, 11)]


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as err:
        fn(*args, **kw)
    return str(err.value)


def test_resolve_tiling_matches_jax():
    for args in ((128, None, None), (128, 25, None), (128, 64, 56), (512, 512, 504),
                 (64, 256, 32), (128, 100, None, False)):
        assert L.resolve_tiling(*args) == J.resolve_tiling(*args)
    for args, kw in (((128, 25, None), dict(require_frame_aligned=True)),
                     ((512, 512, 505), {}), ((128, 64, 0), {})):
        assert _message(L.resolve_tiling, *args, **kw) == _message(J.resolve_tiling, *args, **kw)


def test_merge_tile_texts_matches_jax():
    rng = np.random.default_rng(2)
    alphabet = list("abcdefgh")
    for _ in range(100):
        n = int(rng.integers(2, 5))
        texts = ["".join(rng.choice(alphabet, size=int(rng.integers(0, 12)))) for _ in range(n)]
        tile_w = 128
        starts = sorted(set([0] + [int(v) for v in rng.integers(1, 400, n - 1)]))
        texts = texts[: len(starts)] or [""]
        assert L.merge_tile_texts(texts, tile_w, starts) == J.merge_tile_texts(texts, tile_w,
                                                                               starts)
    assert L.merge_tile_texts(["abcdefgh", "ghijklmn", "mnopqrst"], 128, [0, 96, 192]) == \
        "abcdefghijklmnopqrst"


def test_stitch_aligned_rows_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(100):
        frames_t, tile_w, starts = _tiling(rng)
        tokens = rng.integers(0, len(TOKENS), size=(len(starts), 6))
        aligns = rng.integers(0, frames_t, size=(len(starts), 6))
        kw = dict(eos_id=2, skip_ids={0, 3}, itos=TOKENS)
        assert L.stitch_aligned_rows(tokens, aligns, starts, tile_w, frames_t, **kw) == \
            J.stitch_aligned_rows(tokens, aligns, starts, tile_w, frames_t, **kw)


def _frames(rng, plans_tiles, frames_t, k):
    """Seeded top-k frames [n, T, k] (log-probs, descending; ids distinct)."""
    logits = rng.standard_normal((plans_tiles, frames_t, len(TOKENS))) * 3
    logits[..., BLANK] += 2.0
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    idx = np.argsort(-lp, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(lp, idx, -1).astype(np.float32), idx.astype(np.int32)


@pytest.mark.parametrize("method,snap,confidence", [
    ("greedy", "midpoint", False), ("greedy", "blank", True), ("beam", "midpoint", True),
    ("beam", "blank", False)])
def test_stitched_decodes_match_jax(method, snap, confidence):
    rng = np.random.default_rng(4)
    tile_w, frames_t = 64, 8
    plans, n = [], 0
    for n_tiles in (1, 2, 4, 6):
        starts = list(range(0, 32 * (n_tiles - 1) + 1, 32))
        plans.append((n, starts))
        n += n_tiles
    vals, idx = _frames(rng, n, frames_t, 5)
    kw = dict(blank_id=BLANK, num_classes=len(TOKENS), itos=TOKENS, skip_ids={0, 1, 2, BLANK},
              method=method, beam_width=4, snap=snap, return_confidence=confidence)
    got = L.decode_stitched(vals, idx, plans, tile_w, **kw)
    want = J.decode_stitched(vals, idx, plans, tile_w, **kw)
    if confidence:
        assert [t for t, _ in got] == [t for t, _ in want]
        np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=1e-6)
    else:
        assert got == want
    assert len(set(t[0] if confidence else t for t in got)) > 1
    ids_kw = dict(blank_id=BLANK, itos=TOKENS, skip_ids={0, 1, 2, BLANK})
    maxp = np.exp(vals[..., 0])
    assert L.decode_stitched_ids(idx[..., 0], plans, tile_w, maxp=maxp, **ids_kw) == \
        J.decode_stitched_ids(idx[..., 0], plans, tile_w, maxp=maxp, **ids_kw)
    first, starts = plans[-1]
    for a, b in zip(L.stitch_frames(vals, idx, first, starts, tile_w, frames_t),
                    J.stitch_frames(vals, idx, first, starts, tile_w, frames_t)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        L.stitch_frame_ids(idx[..., 0], first, starts, tile_w, frames_t),
        J.stitch_frame_ids(idx[..., 0], first, starts, tile_w, frames_t))
    blanks = np.full(5, BLANK)
    assert L._emitted_frame_confidence(blanks, maxp[0, :5], BLANK) == \
        J._emitted_frame_confidence(blanks, maxp[0, :5], BLANK)


def _lines(widths, seed, height=IMG_H):
    """Flat colour lines crossed by colour bars."""
    rng = np.random.default_rng(seed)
    out = []
    for w in widths:
        img = np.full((height, w, 3), int(rng.integers(0, 256)), np.uint8)
        for _ in range(max(1, w // 24)):
            x0 = int(rng.integers(0, w - 4))
            img[:, x0 : x0 + int(rng.integers(4, 20))] = rng.integers(0, 256, size=3)
        out.append(img)
    return out


def test_plan_tiles_and_extractors_match_jax():
    images = _lines((40, 64, 100, 224, 230), seed=5)
    got = L.plan_tiles(images, IMG_H, 64, 32, ResizeAndPad(IMG_H, 64), keep_resized=True)
    want = J.plan_tiles(images, IMG_H, 64, 32, JaxResizeAndPad(IMG_H, 64), keep_resized=True)
    assert got[1] == want[1] and len(got[0]) == len(want[0]) == 1 + 1 + 3 + 6 + 7
    for a, b in zip(got[0] + got[2], want[0] + want[2]):
        np.testing.assert_array_equal(a, b)

    def run(batch):  # a stub frame kernel: per-tile mean pixel ranks
        score = batch.astype(np.float32).mean(axis=(1, 3))[:, ::8, None] + np.arange(3)
        return torch.from_numpy(score), torch.from_numpy(np.argsort(-score, -1).astype(np.int32))

    for a, b in zip(L.extract_tile_frames(got[0], 4, run),
                    J.extract_tile_frames(got[0], 4, lambda x: [t.numpy() for t in run(x)])):
        np.testing.assert_array_equal(a, b)
    ids = L.extract_tile_ids(got[0], 3, lambda x: run(x)[1][..., 0])
    np.testing.assert_array_equal(ids, J.extract_tile_ids(got[0], 3,
                                                          lambda x: run(x)[1][..., 0].numpy()))


def test_height_normalize_is_within_one_step_of_cv2():
    rng = np.random.default_rng(6)
    for h, w in ((20, 90), (48, 300), (33, 61), (32, 200), (64, 1000), (17, 17)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got, want = L.height_normalize(img, IMG_H), J.height_normalize(img, IMG_H)
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= 1


def test_hybrid_decode_driver_matches_jax_with_stub_kernels():
    """Every frame non-blank on a non-frame-aligned tile: ``hybrid_decode_driver`` emits
    spans of the cap and clamps each crop to ``tile_w``."""
    tile_w, frames_t, img_h = 514, 128, 32
    img = np.random.default_rng(7).integers(0, 256, (img_h, 4 * tile_w, 3)).astype(np.uint8)
    out = {}
    for name, mod in (("port", L), ("jax", J)):
        widths = []

        def pad_one(crop):
            widths.append(crop.shape[1])
            canvas = np.zeros((img_h, tile_w, 3), np.uint8)
            canvas[:, : crop.shape[1]] = crop[:, :tile_w]
            return canvas

        res = mod.hybrid_decode_driver(
            [img, img[:, :300]], img_h=img_h, tile_w=tile_w, overlap=64, batch_size=4,
            blank_id=0, min_gap=3, margin=1, pad_one=pad_one,
            tile_fn=lambda b: np.full((b.shape[0], frames_t), 7, np.int32),
            decode_fn=lambda b: (np.tile(b[:, 0, :3, 0].astype(np.int32), (1, 1)),
                                 np.full((b.shape[0], 3), 0.5, np.float32)),
            decode_row=lambda pred, aux: (f"<{pred[0]}>", float(aux[0])),
            return_confidence=True)
        out[name] = (res, widths)
    assert out["port"] == out["jax"]
    assert max(out["port"][1]) <= tile_w


@pytest.fixture(scope="module")
def engines(files):
    ckpt, charset, lm = files
    kw = dict(img_h=IMG_H, img_w=IMG_W)
    return (OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, lm=lm, **kw),
            JaxOCRInference(ckpt, charset, dtype=jnp.float32, lm=lm, verbose=False, **kw))


# 1, 1, 2, 3, 5 and 6 tiles of 64 px overlapping by 32
LINES = _lines((40, 64, 90, 128, 190, 200), seed=8)


def _same(got, want, confidence):
    if not confidence:
        assert got == want
        return
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], **TOL)


@pytest.mark.parametrize("method,snap,confidence", [
    ("greedy", "midpoint", True), ("greedy", "blank", False), ("beam", "midpoint", True),
    ("beam", "blank", True)])
def test_predict_ctc_long_matches_jax(engines, method, snap, confidence):
    ours, theirs = engines
    kw = dict(batch_size=4, method=method, beam_width=4, prune_k=5, snap=snap,
              return_confidence=confidence)
    got = ours.predict_ctc_long(LINES, **kw)
    _same(got, theirs.predict_ctc_long(LINES, **kw), confidence)
    assert len({t[0] if confidence else t for t in got}) > 1, "one string: the test proves little"


@pytest.mark.parametrize("beam,confidence", [(False, True), (True, False), (True, True)])
def test_predict_hybrid_long_matches_jax(engines, beam, confidence):
    ours, theirs = engines
    kw = dict(batch_size=4, max_length=5, beam=beam, beam_width=3, return_confidence=confidence)
    if beam:
        kw.update(length_penalty=0.6, lm_weight=0.5)
    got = ours.predict_hybrid_long(LINES, **kw)
    _same(got, theirs.predict_hybrid_long(LINES, **kw), confidence)
    assert ours.predict_long(LINES, method="hybrid_beam" if beam else "hybrid",
                             **{k: v for k, v in kw.items() if k != "beam"}) == got


@pytest.mark.parametrize("method,merge", [("attention", "align"), ("attention", "text"),
                                          ("attention_beam", "align"),
                                          ("attention_beam", "text")])
def test_predict_long_attention_matches_jax(engines, method, merge):
    ours, theirs = engines
    kw = dict(method=method, merge=merge, batch_size=4, max_length=5, beam_width=3)
    got = ours.predict_long(LINES, **kw)
    assert got == theirs.predict_long(LINES, **kw)
    assert len(set(got)) > 1, "one string: the test proves little"


def test_one_tile_lines_decode_as_predict(engines):
    ours, _ = engines
    short = _lines((20, 30, 40), seed=9, height=20) + _lines((64, 50), seed=10)
    assert ours.predict_ctc_long(short, return_confidence=True) == \
        ours.predict_ctc(short, return_confidence=True)
    assert ours.predict_long(short, method="attention", max_length=5) == \
        ours.predict(short, max_length=5)
    assert ours.predict_long(short, method="attention_beam", max_length=5, beam_width=3) == \
        ours.predict(short, max_length=5, beam_width=3)
    assert ours.predict_long(short, method="ctc_beam", beam_width=4) == \
        ours.predict_ctc(short, method="beam", beam_width=4, device_beam=False)
    assert ours.predict_ctc_long([]) == ours.predict_long([]) == ours.predict_hybrid_long([]) == []
    assert ours.predict_ctc_long(short[0]) == ours.predict_ctc(short[0])


def test_ids_fast_path_equals_the_top_k_path(engines):
    ours, _ = engines
    tile_w, overlap = L.resolve_tiling(IMG_W, None, None)
    tiles, plans = L.plan_tiles([ours._to_rgb(im) for im in LINES], IMG_H, tile_w, overlap,
                                ResizeAndPad(IMG_H, tile_w))
    vals, idx = L.extract_tile_frames(tiles, 4, lambda b: ours.tile_kernel(5)(
        ours._device_batch(b)))
    ids = L.extract_tile_ids(tiles, 4, lambda b: ours.tile_ids_kernel()(ours._device_batch(b)))
    np.testing.assert_array_equal(ids, idx[:, :, 0])
    kw = dict(blank_id=BLANK, itos=TOKENS, skip_ids=ours._ctc_skip())
    via_topk = L.decode_stitched(vals, idx, plans, tile_w, num_classes=len(TOKENS), **kw)
    assert L.decode_stitched_ids(ids, plans, tile_w, **kw) == via_topk
    assert ours.predict_ctc_long(LINES) == via_topk


def test_errors_are_jax_errors(engines):
    ours, theirs = engines
    img = LINES[3]
    for call in (lambda e: e.predict_ctc_long(img, overlap=0),
                 lambda e: e.predict_ctc_long(img, method="viterbi"),
                 lambda e: e.predict_ctc_long(img, snap="nearest", method="beam"),
                 lambda e: e.predict_long(img, method="viterbi"),
                 lambda e: e.predict_long(img, method="attention", merge="frames"),
                 lambda e: e.predict_long(img, method="attention", return_confidence=True),
                 lambda e: e.predict_long(img, method="attention", tile_w=100, overlap=32)):
        assert _message(lambda: call(ours)) == _message(lambda: call(theirs))
