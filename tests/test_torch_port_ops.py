"""The port's host and decode ops vs the JAX package, on the CPU.

* ``ctc_greedy_decode`` vs ``ctc_greedy_decode_jnp`` on random logits with
  empty decodes: tokens and counts equal, confidence at rtol/atol 1e-6;
* ``ResizeAndPad`` (numpy) vs the JAX package's (cv2) within one uint8 step;
* ``device_normalize`` bit-exact; charset and post-processing identical;
  ``load_rgb_uint8`` of arrays and PNG paths equal to JAX's.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcnn_ocr_tpu import postprocess as jax_post
from rcnn_ocr_tpu.data.transforms import ResizeAndPad as Cv2ResizeAndPad
from rcnn_ocr_tpu.data.transforms import load_rgb_uint8 as cv2_load_rgb_uint8
from rcnn_ocr_tpu.ops.augment import device_normalize as jax_device_normalize
from rcnn_ocr_tpu.ops.ctc import ctc_greedy_decode_jnp, ids_to_text as jax_ids_to_text
from rcnn_ocr_tpu.vocab.charset import Charset as JaxCharset
from rcnn_ocr_tpu_torch import postprocess
from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad, load_rgb_uint8
from rcnn_ocr_tpu_torch.ops.augment import device_normalize
from rcnn_ocr_tpu_torch.ops.ctc import ctc_greedy_decode, ids_to_text
from rcnn_ocr_tpu_torch.vocab.charset import Charset


def _ctc_logits(seed, blank=0, batch=16, t=12, v=7):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(batch, t, v)).astype(np.float32)
    logits[:3, :, blank] += 10.0  # all-blank rows: empty decodes
    logits[3, :, 4] += 10.0  # one long repeat: a single symbol
    return logits


@pytest.mark.parametrize("blank", [0, 5])
def test_ctc_greedy_decode_matches_jax(blank):
    logits = _ctc_logits(blank + 1, blank=blank)
    jt, jv, jc = ctc_greedy_decode_jnp(jnp.asarray(logits), blank, return_confidence=True)
    tt, tv, tc = ctc_greedy_decode(torch.from_numpy(logits), blank, return_confidence=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    assert (tv.numpy()[:3] == 0).all() and tv.numpy()[3] == 1
    t2, v2 = ctc_greedy_decode(torch.from_numpy(logits), blank)
    np.testing.assert_array_equal(t2.numpy(), tt.numpy())


def test_ids_to_text_matches_jax():
    itos = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abc")
    rows = [[4, 5, 0, 6], [], [1, 3, 2, 4]]
    assert ids_to_text(rows, itos, skip_ids={0, 1, 2}) == jax_ids_to_text(rows, itos, {0, 1, 2})


# (src_h, src_w) onto a 32x128 canvas: shrink, grow, identity, one side equal
SIZES = [(64, 300), (48, 97), (100, 40), (17, 50), (20, 33), (32, 128), (32, 64), (8, 200),
         (32, 500), (1, 1), (5, 128), (31, 127), (90, 90)]


@pytest.mark.parametrize("size", SIZES)
def test_resize_and_pad_matches_cv2(size):
    rng = np.random.default_rng(size[0] * 1000 + size[1])
    img = rng.integers(0, 256, size=(*size, 3), dtype=np.uint8)
    got = ResizeAndPad(32, 128)(img)
    want = Cv2ResizeAndPad(32, 128)(img)
    assert got.dtype == np.uint8 and got.shape == want.shape == (32, 128, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"max uint8 step {diff.max()}"


@pytest.mark.parametrize("align", [("left", "center"), ("right", "bottom"), ("center", "top")])
def test_resize_and_pad_alignment_matches_cv2(align):
    img = np.random.default_rng(11).integers(0, 256, size=(20, 40, 3), dtype=np.uint8)
    got = ResizeAndPad(32, 128, *align)(img)
    want = Cv2ResizeAndPad(32, 128, *align)(img)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    np.testing.assert_array_equal(got == 255, want == 255)


@pytest.mark.parametrize("kind", ["gray", "gray1", "rgba", "float"])
def test_load_rgb_uint8_matches_jax(kind):
    rng = np.random.default_rng(12)
    img = {
        "gray": rng.integers(0, 256, (9, 13), dtype=np.uint8),
        "gray1": rng.integers(0, 256, (9, 13, 1), dtype=np.uint8),
        "rgba": rng.integers(0, 256, (9, 13, 4), dtype=np.uint8),
        "float": rng.uniform(-10, 300, (9, 13, 3)),
    }[kind]
    np.testing.assert_array_equal(load_rgb_uint8(img), cv2_load_rgb_uint8(img))


def test_paths_and_pil_inputs_wait_for_a_later_slice(tmp_path):
    """A path reads like JAX's ``load_rgb_uint8`` (PNG: bit-equal); PIL
    objects still wait for the serving slice."""

    class FakePIL:
        def convert(self, mode):
            return self

    img = np.random.default_rng(13).integers(0, 256, (9, 21, 3), dtype=np.uint8)
    path = str(tmp_path / "line.png")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(load_rgb_uint8(path), cv2_load_rgb_uint8(path))
    with pytest.raises(FileNotFoundError):
        load_rgb_uint8(str(tmp_path / "absent.png"))
    with pytest.raises(NotImplementedError, match="serving slice"):
        load_rgb_uint8(FakePIL())


def test_device_normalize_is_bit_exact():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1).repeat(3, axis=3)
    want = np.asarray(jax_device_normalize(jnp.asarray(u8)))
    got = device_normalize(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    f = torch.zeros(1, 2, 2, 3)
    assert device_normalize(f) is f


def test_charset_matches_jax(tmp_path):
    path = tmp_path / "cs.txt"
    path.write_text("<PAD>\n<SOS>\n<EOS>\n \na\n\nb\n<BLANK>\n", encoding="utf-8")
    ours, theirs = Charset.from_file(str(path)), JaxCharset.from_file(str(path))
    assert ours.itos == theirs.itos and ours.num_classes == theirs.num_classes == 7
    for name in ("pad_id", "sos_id", "eos_id", "blank_id", "ctc_blank_id"):
        assert getattr(ours, name) == getattr(theirs, name), name
    ids = [4, 6, 3, 0, 5, 2, 4]
    assert ours.decode(ids) == theirs.decode(ids) == "a b"
    no_blank = Charset.from_tokens(["<PAD>", "<SOS>", "<EOS>", "x"])
    assert no_blank.blank_id is None and no_blank.ctc_blank_id == 0


def test_postprocess_matches_jax():
    rows = [np.zeros(2), np.ones(2)]
    assert postprocess.pad_rows(rows, 4)[1] == jax_post.pad_rows(rows, 4)[1] == 2
    assert len(postprocess.pad_rows(rows, 4)[0]) == 4
    with pytest.raises(ValueError):
        postprocess.pad_rows([], 2)
    groups = {None: list(range(5)), 64: [7, 8]}
    assert postprocess.chunk_indices(groups, 2) == jax_post.chunk_indices(groups, 2)
    assert postprocess.ctc_skip_ids(0, 1, 2, 0) == jax_post.ctc_skip_ids(0, 1, 2, 0)
    itos = ["<PAD>", "<SOS>", "<EOS>", "a", "b"]
    pred = np.array([3, 0, 4, 2, 3])
    maxp = np.array([0.9, 0.5, 0.7, 0.8, 0.1], np.float32)
    for conf in (False, True):
        assert postprocess.decode_attention_row(pred, maxp, itos, 0, 2, None, conf) == \
            jax_post.decode_attention_row(pred, maxp, itos, 0, 2, None, conf)
