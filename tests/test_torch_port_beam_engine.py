"""The port's ``OCRInference`` beam decodes vs the JAX engine's, fp32 on the CPU.

One checkpoint (seeded weights, both heads, a ``<BLANK>`` token) read by
both engines; line images 32 high, so that resize-pad only pads on both
sides.  Held:

* ``predict`` with beams, length penalty and bigram fusion (``lm=`` an
  ``.npz`` path), and ``predict_ctc`` with the device and the host beam,
  with and without fusion: strings equal, confidences within 1e-5;
* ``width_buckets="auto:K"``: the same widths and strings as JAX's;
* PIL images (duck-typed by the port, which never imports PIL);
* misuse raises JAX's errors with JAX's messages;
* a path is decoded once per call, bucketed by its header.
"""

import numpy as np
import pytest
import torch
from PIL import Image

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference  # noqa: E402
from rcnn_ocr_tpu_torch.data import transforms  # noqa: E402
from rcnn_ocr_tpu_torch.inference import OCRInference  # noqa: E402
from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables  # noqa: E402
from rcnn_ocr_tpu_torch.lm import save_lm, train_bigram_lm  # noqa: E402
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_train_params  # noqa: E402
from rcnn_ocr_tpu_torch.vocab.charset import Charset  # noqa: E402

TOKENS = ["<PAD>", "<SOS>", "<EOS>", "<BLANK>", "a", "b", "c"]
HIDDEN, WIDTH, IMG_H, IMG_W, MAX_LEN = 16, 0.25, 32, 64, 5
TOL = dict(rtol=1e-5, atol=1e-5)


def sharpen(model):
    """Random weights give the decoder's attention context little of the
    image (a mean over frames): a stronger context weight and weaker
    recurrent ones, and sharper heads, make the strings differ per image."""
    with torch.no_grad():
        model.attn.w_ctx.mul_(10.0)
        model.attn.w_emb.mul_(0.1)
        model.attn.w_hh.mul_(0.1)
        model.attn.w_gen.mul_(4.0)
        model.ctc_proj.weight.mul_(3.0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded weights (flax's distributions, sharpened) written as a flax
    msgpack, the charset and a bigram LM file."""
    cs = Charset.from_tokens(TOKENS)
    model = RCNN(num_classes=len(TOKENS), hidden_size=HIDDEN, width_mult=WIDTH,
                 with_ctc_head=True, sos_id=cs.sos_id, eos_id=cs.eos_id, pad_id=cs.pad_id,
                 blank_id=cs.blank_id).eval()
    init_train_params(model, torch.Generator().manual_seed(10))
    sharpen(model)
    root = tmp_path_factory.mktemp("beam_engine")
    ckpt = root / "w_weights.msgpack"
    ckpt.write_bytes(serialization.msgpack_serialize(to_jax_variables(model)))
    charset = root / "cs.txt"
    charset.write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    lm = root / "lm.npz"
    save_lm(str(lm), train_bigram_lm(["abc", "cab", "bca", "aab", "cc", "ba"], cs), TOKENS)
    return str(ckpt), str(charset), str(lm)


@pytest.fixture(scope="module")
def engines(files):
    ckpt, charset, lm = files
    kw = dict(img_h=IMG_H, img_w=IMG_W)
    return (OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, lm=lm, **kw),
            JaxOCRInference(ckpt, charset, dtype=jnp.float32, lm=lm, verbose=False, **kw))


def _images(n, seed=0, widths=(IMG_W,)):
    """Flat colour lines crossed by a few colour bars: unlike noise, whose
    height means are alike, they move a random model's decodes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = int(widths[i % len(widths)])
        img = np.full((IMG_H, w, 3), int(rng.integers(0, 256)), np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            x0 = int(rng.integers(0, w - 4))
            img[:, x0 : x0 + int(rng.integers(4, 24))] = rng.integers(0, 256, size=3)
        out.append(img)
    return out


def _assert_same(got, want, confidence=True):
    if not confidence:
        assert got == want
        return
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], **TOL)


@pytest.mark.parametrize("beam_width,penalty,lm_weight", [(3, 0.0, 0.0), (4, 0.6, 0.5),
                                                          (8, 0.0, 0.3)])
def test_predict_beam_matches_jax(engines, beam_width, penalty, lm_weight):
    ours, theirs = engines
    imgs = _images(8, seed=3)
    kw = dict(max_length=MAX_LEN, batch_size=3, beam_width=beam_width,
              length_penalty=penalty, lm_weight=lm_weight)
    got = ours.predict(imgs, return_confidence=True, **kw)
    _assert_same(got, theirs.predict(imgs, return_confidence=True, **kw))
    if beam_width < len(TOKENS):  # the widest beam reads every line as empty
        assert len({t for t, _ in got}) > 1, "the images give one string: the test proves little"
    assert ours.predict(imgs, **kw) == [t for t, _ in got]


def test_lm_weight_zero_is_the_plain_beam(engines):
    ours, _ = engines
    imgs = _images(4, seed=5)
    kw = dict(max_length=MAX_LEN, return_confidence=True)
    assert ours.predict(imgs, beam_width=3, lm_weight=0.0, **kw) == \
        ours.predict(imgs, beam_width=3, **kw)
    assert ours.predict_ctc(imgs, method="beam", lm_weight=0.0, return_confidence=True) == \
        ours.predict_ctc(imgs, method="beam", return_confidence=True)


@pytest.mark.parametrize("device_beam,prune_k,lm_weight", [
    (True, 16, 0.0), (True, 3, 0.8), (False, 16, 0.0), (False, 3, 0.0), (True, 0, 0.0)])
def test_predict_ctc_beam_matches_jax(engines, device_beam, prune_k, lm_weight):
    ours, theirs = engines
    imgs = _images(8, seed=3)
    kw = dict(batch_size=3, method="beam", beam_width=4, prune_k=prune_k,
              device_beam=device_beam, lm_weight=lm_weight)
    got = ours.predict_ctc(imgs, return_confidence=True, **kw)
    _assert_same(got, theirs.predict_ctc(imgs, return_confidence=True, **kw))
    assert len({t for t, _ in got}) > 1, "the images give one string: the test proves little"
    assert ours.predict_ctc(imgs, **kw) == [t for t, _ in got]


def test_auto_width_buckets_match_jax(files):
    ckpt, charset, _ = files
    widths = (18, 24, 40, 44, 64, 30)
    imgs = _images(6, seed=3, widths=widths)
    ours = OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, img_h=IMG_H,
                        img_w=IMG_W, width_buckets="auto:2")
    theirs = JaxOCRInference(ckpt, charset, dtype=jnp.float32, img_h=IMG_H, img_w=IMG_W,
                             width_buckets="auto:2", verbose=False)
    assert ours.predict(imgs[0], max_length=MAX_LEN) == theirs.predict(imgs[0], max_length=MAX_LEN)
    assert ours.width_buckets is None  # one image fixes nothing
    kw = dict(max_length=MAX_LEN, batch_size=2, beam_width=3, return_confidence=True)
    _assert_same(ours.predict(imgs, **kw), theirs.predict(imgs, **kw))
    assert ours.width_buckets == theirs.width_buckets and len(ours.width_buckets) == 2
    assert ours.width_buckets[-1] == IMG_W
    assert ours.predict_ctc(imgs, batch_size=2, method="beam") == \
        theirs.predict_ctc(imgs, batch_size=2, method="beam")
    with pytest.raises(ValueError, match="unknown spec"):
        OCRInference(ckpt, charset, device="cpu", width_buckets="wide")


def test_pil_images(engines):
    ours, theirs = engines
    arrays = _images(3, seed=21, widths=(40, 64))
    pil = [Image.fromarray(a) for a in arrays[:2]] + [Image.fromarray(arrays[2][:, :, 0])]
    want_arrays = arrays[:2] + [np.repeat(arrays[2][:, :, :1], 3, axis=2)]
    np.testing.assert_array_equal(transforms.load_rgb_uint8(pil[2]), want_arrays[2])
    got = ours.predict(pil, max_length=MAX_LEN, beam_width=3)
    assert got == theirs.predict(pil, max_length=MAX_LEN, beam_width=3)
    assert got == ours.predict(want_arrays, max_length=MAX_LEN, beam_width=3)
    assert ours._probe_hw(pil[0]) == (IMG_H, 40)
    assert ours.predict_ctc(pil[0], method="beam") == theirs.predict_ctc(pil[0], method="beam")


def _message(call):
    with pytest.raises(ValueError) as err:
        call()
    return str(err.value)


def test_errors_are_jax_errors(engines, files):
    ours, theirs = engines
    img = _images(1)[0]
    for call in (
        lambda e: e.predict(img, max_length=MAX_LEN, lm_weight=0.5),
        lambda e: e.predict(img, max_length=MAX_LEN, beam_width=1, lm_weight=0.5),
        lambda e: e.predict(img, max_length=MAX_LEN, length_penalty=0.6),
        lambda e: e.predict_ctc(img, method="beam", device_beam=False, lm_weight=0.5),
        lambda e: e.predict_ctc(img, lm_weight=0.5),
        lambda e: e.predict_ctc(img, method="nope"),
    ):
        assert _message(lambda: call(ours)) == _message(lambda: call(theirs))
    ckpt, charset, _ = files
    bare = OCRInference(ckpt, charset, device="cpu", img_h=IMG_H, img_w=IMG_W)
    for call in (lambda: bare.predict(img, beam_width=3, lm_weight=0.5),
                 lambda: bare.predict_ctc(img, method="beam", lm_weight=0.5)):
        assert "lm_weight > 0 needs a bigram table: pass lm= to OCRInference" in _message(call)
    bad = np.zeros((3, 3), np.float32)
    kw = dict(img_h=IMG_H, img_w=IMG_W, lm=bad)
    assert _message(lambda: OCRInference(ckpt, charset, device="cpu", **kw)) == \
        _message(lambda: JaxOCRInference(ckpt, charset, verbose=False, **kw))
    other = str(files[2]).replace("lm.npz", "lm_other.npz")
    save_lm(other, np.zeros((6, 6), np.float32), TOKENS[:-1])
    assert "LM charset mismatch" in _message(
        lambda: OCRInference(ckpt, charset, device="cpu", **dict(kw, lm=other)))


def test_each_path_is_decoded_once(files, tmp_path, monkeypatch):
    """Paths are bucketed by their headers: one decode per image and call."""
    import cv2

    ckpt, charset, _ = files
    paths = []
    for i, img in enumerate(_images(5, seed=4, widths=(20, 36, 64, 50, 28))):
        paths.append(str(tmp_path / f"{i}.png"))
        assert cv2.imwrite(paths[-1], img[:, :, ::-1])
    decoded = []
    real = transforms.imread
    monkeypatch.setattr(transforms, "imread", lambda p: decoded.append(p) or real(p))
    for buckets in ([32, 64], "auto:2"):
        ours = OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, img_h=IMG_H,
                            img_w=IMG_W, width_buckets=buckets)
        theirs = JaxOCRInference(ckpt, charset, dtype=jnp.float32, img_h=IMG_H, img_w=IMG_W,
                                 width_buckets=buckets, verbose=False)
        decoded.clear()
        got = ours.predict(paths, max_length=MAX_LEN, batch_size=2, beam_width=2)
        assert sorted(decoded) == sorted(paths)
        assert got == theirs.predict(paths, max_length=MAX_LEN, batch_size=2, beam_width=2)
