"""The port's serving path (``predict_serving`` and the engine's kernel
accessors) vs the JAX engine's, fp32 on the CPU.

One checkpoint (seeded weights, both heads, a ``<BLANK>`` token; the beam
engine tests' ``files``) read by both engines, at 32x64.  The line images
are 12-60 high and 16-200 wide, so that the device resize both shrinks and
grows them.  Held:

* the two device resize-pads of the chosen images give the same uint8
  pixels (JAX's float normalize in XLA may differ from the port's lookup in
  the last float bit, 1.2e-7), so the decodes see the same batch;
* ``predict_serving`` for ``attention``, ``attention_beam`` (length penalty,
  fusion), ``ctc_greedy`` and ``ctc_beam`` (pruning, fusion), with and
  without ``return_confidence``, with a fixed canvas, ``canvas="auto"`` and
  width buckets: strings equal, confidences within 1e-4;
* ``predict_serving`` equals ``predict`` / ``predict_ctc`` (its rows are
  bit-equal to theirs);
* ``serving_kernel``, ``decode_kernel`` (greedy, beam, both alignment
  flavours), ``tile_kernel`` and ``tile_ids_kernel`` on the same uint8 batch
  as JAX's: token and id rows equal, scores and log-probs within 1e-4;
* the knob refusals raise JAX's errors with JAX's messages; an empty list
  gives ``[]``; a canvas smaller than the data crops, warns, and still
  decodes as JAX's does.

Most calls run three chunks, so each of the two host buffers is refilled.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference  # noqa: E402
from rcnn_ocr_tpu.ops import preprocess as jax_pre  # noqa: E402
from rcnn_ocr_tpu_torch.inference import OCRInference  # noqa: E402
from rcnn_ocr_tpu_torch.ops import preprocess as pre  # noqa: E402
from tests.test_torch_port_beam_engine import IMG_H, IMG_W, MAX_LEN, files  # noqa: E402,F401

TOL = dict(rtol=1e-4, atol=1e-4)
CANVAS = (64, 224)
METHODS = {  # method -> predict_serving knobs
    "attention": {},
    "attention_beam": dict(beam_width=3, length_penalty=0.6, lm_weight=0.5),
    "ctc_greedy": {},
    "ctc_beam": dict(beam_width=4, prune_k=3, lm_weight=0.8),
}


@pytest.fixture(scope="module")
def engines(files):
    ckpt, charset, lm = files
    kw = dict(img_h=IMG_H, img_w=IMG_W)
    return (OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, lm=lm, **kw),
            JaxOCRInference(ckpt, charset, dtype=jnp.float32, lm=lm, verbose=False, **kw))


def lines(n, seed):
    """Flat colour lines crossed by colour bars, 12-60 high, 16-200 wide."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = int(rng.integers(12, 61)), int(rng.integers(16, 201))
        img = np.full((h, w, 3), int(rng.integers(0, 256)), np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            x0 = int(rng.integers(0, w - 4))
            img[:, x0 : x0 + int(rng.integers(4, 24))] = rng.integers(0, 256, size=3)
        out.append(img)
    return out


IMAGES = lines(7, seed=22)


def _same(got, want, confidence):
    if not confidence:
        assert got == want
        return
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], **TOL)


def test_the_two_device_resizes_give_the_same_pixels():
    raw, sizes = pre.host_letterbox(IMAGES, *CANVAS)
    sizes = np.concatenate([sizes, pre.host_resize_geometry(sizes, IMG_H, IMG_W)], axis=1)
    got = pre.resize_pad_normalize(torch.from_numpy(raw), torch.from_numpy(sizes), IMG_H,
                                   IMG_W).numpy()
    want = np.asarray(jax_pre.resize_pad_normalize(jnp.asarray(raw), jnp.asarray(sizes),
                                                   IMG_H, IMG_W))
    assert np.abs(got - want).max() < 1e-6


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("canvas,confidence", [(CANVAS, True), ("auto", False)])
def test_predict_serving_matches_jax(engines, method, canvas, confidence):
    ours, theirs = engines
    kw = dict(max_length=MAX_LEN, batch_size=3, canvas=canvas, method=method,
              return_confidence=confidence, **METHODS[method])
    got = ours.predict_serving(IMAGES, **kw)
    _same(got, theirs.predict_serving(IMAGES, **kw), confidence)
    assert len({t[0] if confidence else t for t in got}) > 1, "one string: the test proves little"


@pytest.mark.parametrize("method", ["attention_beam", "ctc_greedy"])
def test_predict_serving_width_buckets_match_jax(files, method):
    ckpt, charset, lm = files
    kw = dict(img_h=IMG_H, img_w=IMG_W, width_buckets=[32, 48, 64], lm=lm)
    ours = OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, **kw)
    theirs = JaxOCRInference(ckpt, charset, dtype=jnp.float32, verbose=False, **kw)
    call = dict(max_length=MAX_LEN, batch_size=2, canvas="auto", method=method,
                return_confidence=True, **METHODS[method])
    _same(ours.predict_serving(IMAGES, **call), theirs.predict_serving(IMAGES, **call), True)
    assert ours.predict_serving(IMAGES[0], **call) == theirs.predict_serving(IMAGES[0], **call)


@pytest.mark.parametrize("method", list(METHODS))
def test_predict_serving_equals_predict(engines, method):
    ours, _ = engines
    kw = METHODS[method]
    served = ours.predict_serving(IMAGES, max_length=MAX_LEN, batch_size=4, canvas="auto",
                                  method=method, return_confidence=True, **kw)
    if method.startswith("ctc"):
        want = ours.predict_ctc(IMAGES, batch_size=4, return_confidence=True,
                                method="beam" if method == "ctc_beam" else "greedy", **kw)
    else:
        want = ours.predict(IMAGES, max_length=MAX_LEN, batch_size=4, return_confidence=True,
                            **kw)
    assert served == want


def _u8_batch(n=4, seed=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, IMG_H, IMG_W, 3), dtype=np.uint8)


def _close(got, want):
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("beam_width,alignment", [(0, False), (0, True), (3, False), (3, True)])
def test_decode_kernel_matches_jax(engines, beam_width, alignment):
    ours, theirs = engines
    batch = _u8_batch()
    kw = dict(max_length=MAX_LEN, beam_width=beam_width, with_alignment=alignment)
    if beam_width:
        kw.update(length_penalty=0.6, lm_weight=0.5)
    got = ours.decode_kernel(**kw)(torch.from_numpy(batch))
    want = theirs.decode_kernel(**kw)(theirs.variables, jnp.asarray(batch))
    assert len(got) == len(want) == (2 + (beam_width > 0) if alignment else 2)
    _close(got, want)


def test_tile_kernels_match_jax(engines):
    ours, theirs = engines
    batch = _u8_batch(seed=13)
    got = ours.tile_kernel(prune_k=3)(torch.from_numpy(batch))
    want = theirs.tile_kernel(prune_k=3)(theirs.variables, jnp.asarray(batch))
    assert got[1].dtype == torch.int32 and got[0].shape == (4, IMG_W // 8, 3)
    _close(got, want)
    ids = ours.tile_ids_kernel()(torch.from_numpy(batch))
    np.testing.assert_array_equal(ids.numpy(), got[1][:, :, 0].numpy())
    got = ours.tile_ids_kernel(with_maxp=True)(torch.from_numpy(batch))
    _close(got, theirs.tile_ids_kernel(with_maxp=True)(theirs.variables, jnp.asarray(batch)))


@pytest.mark.parametrize("method", list(METHODS))
def test_serving_kernel_matches_jax(engines, method):
    ours, theirs = engines
    raw, sizes = pre.host_letterbox(IMAGES[:4], *CANVAS)
    sizes = np.concatenate([sizes, pre.host_resize_geometry(sizes, IMG_H, IMG_W)], axis=1)
    kw = dict(method=method, max_length=MAX_LEN, **METHODS[method])
    if method.startswith("ctc"):
        kw["with_confidence"] = True
    got = ours.serving_kernel(**kw)(torch.from_numpy(raw), torch.from_numpy(sizes))
    want = theirs.serving_kernel(**kw)(theirs.variables, jnp.asarray(raw), jnp.asarray(sizes))
    assert len(got) == len(want)
    _close(got, want)


def _message(call):
    with pytest.raises(ValueError) as err:
        call()
    return str(err.value)


def test_refusals_are_jax_refusals(engines):
    ours, theirs = engines
    imgs = IMAGES[:2]
    for call in (
        lambda e: e.predict_serving(imgs, canvas=CANVAS, method="attention_beam", beam_width=0),
        lambda e: e.predict_serving(imgs, canvas=CANVAS, method="ctc_beam", beam_width=1),
        lambda e: e.predict_serving(imgs, canvas=CANVAS, method="attention", lm_weight=0.5),
        lambda e: e.predict_serving(imgs, canvas=CANVAS, method="ctc_greedy",
                                    length_penalty=0.5),
        lambda e: e.predict_serving(imgs, canvas=CANVAS, method="beam"),
        lambda e: e.predict_serving(imgs, canvas="fit"),
        lambda e: e.serving_kernel(method="attention_beam", beam_width=1),
        lambda e: e.serving_kernel(method="attention", lm_weight=0.5),
        lambda e: e.serving_kernel(method="ctc_beam", beam_width=4, length_penalty=1.0),
        lambda e: e.serving_kernel(method="viterbi"),
        lambda e: e.decode_kernel(beam_width=0, lm_weight=0.5),
        lambda e: e.decode_kernel(beam_width=1, length_penalty=2.0),
    ):
        assert _message(lambda: call(ours)) == _message(lambda: call(theirs))
    assert ours.predict_serving([], canvas=CANVAS) == []
    # prune_k <= 0 is the whole vocabulary, as is any k >= V
    kw = dict(max_length=MAX_LEN, batch_size=2, canvas=CANVAS, method="ctc_beam", beam_width=4)
    assert ours.predict_serving(imgs, prune_k=0, **kw) == ours.predict_serving(imgs, prune_k=99,
                                                                               **kw)


def test_a_crop_warns_and_matches_jax(engines, monkeypatch):
    ours, theirs = engines
    kw = dict(max_length=MAX_LEN, batch_size=4, canvas=(32, 64), method="ctc_greedy")
    monkeypatch.setattr(pre, "_warned_crop", False)
    with pytest.warns(UserWarning, match="CROPPED"):
        got = ours.predict_serving(IMAGES, **kw)
    assert got == theirs.predict_serving(IMAGES, **kw)
