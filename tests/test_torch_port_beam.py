"""The port's beam searches vs the JAX package's, in fp32 on the CPU.

* attention beam: ``AttentionDecoder.beam_search`` vs JAX's
  ``models/attention.py:_beam_search`` on the same encoder states, over
  beam widths 1, 3 and V + 1 (wider than the vocabulary: -1e30 ties),
  length penalty 0 and 0.6, bigram fusion off and on, with the alignment,
  and ``RCNN.beam_decode`` vs JAX's from the images: tokens and alignment
  equal, scores within rtol 1e-5 / atol 1e-4; width 1 is greedy through
  the first EOS;
* device CTC prefix beam: ``ctc_beam_search_device`` vs
  ``ctc_beam_search_jax`` on ``tests/test_ctc_ops.py``'s frames (per-row
  lengths with a 0), the exact-tie fusion case of ``test_lm_fusion.py``
  and the posterior: labels and lengths equal, log-probs and posteriors
  within 1e-5; ``ctc_beam_from_logits`` vs JAX's from the same logits;
* host beam: the port's C++ build vs JAX's ``ctc_beam_search`` (its own
  native build) and both ``_ctc_beam_py`` twins: labels equal, log-probs
  and totals within 1e-5;
* the two-channel rolling hash in int64 vs JAX's uint32 arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcnn_ocr_tpu.lm import train_bigram_lm as jax_train_lm
from rcnn_ocr_tpu.models import RCNN as JaxRCNN
from rcnn_ocr_tpu.models.attention import AttentionDecoder as JaxAttention
from rcnn_ocr_tpu.ops import ctc as jax_ctc
from rcnn_ocr_tpu.vocab.charset import Charset as JaxCharset
from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_train_params
from rcnn_ocr_tpu_torch.ops import ctc
from tests.test_torch_port_beam_engine import sharpen

TOKENS = ["<PAD>", "<SOS>", "<EOS>", "<BLANK>", "a", "b", "c"]
PAD, SOS, EOS, BLANK = range(4)
V, HIDDEN, WIDTH, MAX_LEN = len(TOKENS), 16, 0.25, 5
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """A tiny model (both heads, blank masked) with seeded port weights, its
    JAX twin, both encoders' states of seeded images, and a bigram table."""
    tm = RCNN(num_classes=V, hidden_size=HIDDEN, width_mult=WIDTH, with_ctc_head=True,
              sos_id=SOS, eos_id=EOS, pad_id=PAD, blank_id=BLANK).eval()
    init_train_params(tm, torch.Generator().manual_seed(11))
    sharpen(tm)
    variables = to_jax_variables(tm)
    jm = JaxRCNN(num_classes=V, hidden_size=HIDDEN, width_mult=WIDTH, with_ctc_head=True,
                 sos_id=SOS, eos_id=EOS, pad_id=PAD, blank_id=BLANK, ctc_blank_id=BLANK,
                 dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(4, 32, 64, 3)).astype(np.float32)
    enc = np.array(jm.apply(variables, x, method=jm.encode))
    with torch.no_grad():
        np.testing.assert_allclose(tm.encode(torch.from_numpy(x)).numpy(), enc,
                                   rtol=1e-4, atol=2e-4)
    lm = jax_train_lm(["abc", "cab", "bca", "aab", "cc"], JaxCharset.from_tokens(TOKENS))
    return jm, variables, tm, x, enc, lm


# (beam width, length penalty, fusion, alignment): each factor on and off
BEAM_CASES = [(1, 0.0, False, False), (1, 0.6, True, True), (3, 0.0, False, True),
              (3, 0.6, True, False), (V + 1, 0.0, True, True), (V + 1, 0.6, False, False)]


def _beam_kwargs(k, penalty, fused, align, lm):
    kw = dict(beam_width=k, batch_max_length=MAX_LEN, length_penalty=penalty,
              return_alignment=align)
    if fused:
        kw.update(lm_logp=lm, lm_weight=0.8)
    return kw


def _assert_beams_equal(got, want, align):
    assert len(got) == len(want) == (3 if align else 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-4)
    if align:
        np.testing.assert_array_equal(got[2], want[2])
    assert (got[0] != BLANK).all()


@pytest.mark.parametrize("k,penalty,fused,align", BEAM_CASES)
def test_attention_beam_matches_jax(pair, k, penalty, fused, align):
    """The decoder alone, on the same encoder states."""
    jm, variables, tm, _, enc, lm = pair
    kw = _beam_kwargs(k, penalty, fused, align, lm)
    attn = JaxAttention(num_classes=V, hidden_size=HIDDEN, sos_id=SOS, eos_id=EOS, pad_id=PAD,
                        blank_id=BLANK, dtype=jnp.float32)
    want = attn.apply({"params": variables["params"]["attn"]}, enc, train=False, **kw)
    kw.pop("beam_width")
    with torch.no_grad():
        got = tm.attn.beam_search(torch.from_numpy(enc), k, **kw)
    _assert_beams_equal([t.numpy() for t in got], [np.asarray(a) for a in want], align)


def test_rcnn_beam_decode_matches_jax(pair):
    """The whole model: images in, beams out."""
    jm, variables, tm, x, _, lm = pair
    kw = _beam_kwargs(3, 0.6, True, True, lm)
    want = jm.apply(variables, x, method=jm.beam_decode, **kw)
    with torch.no_grad():
        got = tm.beam_decode(torch.from_numpy(x), **kw)
    _assert_beams_equal([t.numpy() for t in got], [np.asarray(a) for a in want], True)


def test_beam_width_one_is_greedy(pair):
    _, _, tm, x, _, _ = pair
    with torch.no_grad():
        tokens, _ = tm.beam_decode(torch.from_numpy(x), beam_width=1, batch_max_length=MAX_LEN)
        greedy = tm(torch.from_numpy(x), batch_max_length=MAX_LEN).argmax(-1)
    for row_b, row_g in zip(tokens.numpy(), greedy.numpy()):
        n = int(np.argmax(row_g == EOS)) + 1 if EOS in row_g else len(row_g)
        np.testing.assert_array_equal(row_b[:n], row_g[:n])


def test_attention_beam_refuses_a_table_of_another_size(pair):
    _, _, tm, x, _, _ = pair
    with pytest.raises(ValueError, match=r"lm_logp must be \[V, V\]"):
        tm.beam_decode(torch.from_numpy(x), beam_width=2, lm_logp=np.zeros((3, 3)),
                       lm_weight=1.0)


def _pruned_frames(seed, B, T, Vc, K):
    """``tests/test_ctc_ops.py``'s frames: log-softmax of 2 x normal logits,
    each frame's K best."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, Vc)).astype(np.float32) * 2.0
    m = logits.max(-1, keepdims=True)
    lp = logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))
    order = np.argsort(-lp, axis=-1)[..., :K]
    vals = np.take_along_axis(lp, order, -1).astype(np.float32)
    return logits, lp, vals, order.astype(np.int32)


def _tie_frames():
    """``tests/test_lm_fusion.py``'s two frames where classes 3 and 4 tie."""
    vals = np.log(np.asarray([[[0.4, 0.3, 0.3], [0.4, 0.3, 0.3]]], np.float32))
    idx = np.asarray([[[0, 3, 4], [0, 3, 4]]], np.int32)
    return vals, idx


def _lm(kind, vocab):
    if kind == "none":
        return {}
    if kind == "zero":
        return dict(lm_logp=np.zeros((vocab, vocab), np.float32), lm_weight=0.0, sos_id=SOS)
    if kind in ("prefer3", "prefer4"):
        lm = np.full((vocab, vocab), -5.0, np.float32)
        lm[:, int(kind[-1])] = 0.0
        return dict(lm_logp=lm, lm_weight=1.0, sos_id=SOS)
    lm = np.random.default_rng(9).normal(size=(vocab, vocab)).astype(np.float32)
    return dict(lm_logp=lm, lm_weight=0.7, sos_id=SOS)


CTC_CASES = [  # (frames, beam width, lengths, fusion)
    ("ops", 4, None, "none"), ("ops", 4, None, "random"), ("lengths", 4, [10, 7, 3, 0], "none"),
    ("lengths", 4, [10, 7, 3, 0], "random"), ("ties", 8, None, "none"), ("ties", 8, None, "zero"),
    ("ties", 8, None, "prefer3"), ("ties", 8, None, "prefer4"), ("wide", 9, [9, 0, 5], "random"),
]


@pytest.mark.parametrize("frames,w,lengths,fusion", CTC_CASES)
def test_device_ctc_beam_matches_jax(frames, w, lengths, fusion):
    if frames == "ties":
        vals, idx = _tie_frames()
        vocab = 6
    else:
        shape = {"ops": (6, 12, 20, 5), "lengths": (4, 10, 12, 5), "wide": (3, 9, 7, 3)}[frames]
        _, _, vals, idx = _pruned_frames({"ops": 0, "lengths": 1, "wide": 2}[frames], *shape)
        vocab = shape[2]
    kw = dict(blank_id=0, beam_width=w, return_posterior=True, **_lm(fusion, vocab))
    n = None if lengths is None else np.asarray(lengths, np.int32)
    want = jax_ctc.ctc_beam_search_jax(jnp.asarray(vals), jnp.asarray(idx),
                                       lengths=None if n is None else jnp.asarray(n), **kw)
    got = ctc.ctc_beam_search_device(torch.from_numpy(vals), torch.from_numpy(idx),
                                     lengths=None if n is None else torch.from_numpy(n), **kw)
    want = [np.asarray(a) for a in want]
    got = [t.numpy() for t in got]
    np.testing.assert_array_equal(got[0], want[0])  # labels, padded with blank
    np.testing.assert_array_equal(got[1], want[1])  # lengths
    np.testing.assert_allclose(got[2], want[2], **TOL)  # log-probs
    np.testing.assert_allclose(got[3], want[3], **TOL)  # posteriors
    if n is not None:
        assert (got[1][n == 0] == 0).all()
    if fusion in ("prefer3", "prefer4"):
        assert got[0][0, : got[1][0]].tolist() == [int(fusion[-1])]


@pytest.mark.parametrize("fused,confidence", [(False, True), (True, False), (True, True)])
def test_ctc_beam_from_logits_matches_jax(fused, confidence):
    logits, _, _, _ = _pruned_frames(3, 5, 11, V, 1)
    kw = dict(blank_id=BLANK, beam_width=5, prune_k=6, sos_id=SOS,
              return_confidence=confidence)
    if fused:
        kw.update(lm_logp=_lm("random", V)["lm_logp"], lm_weight=0.5)
    want = [np.asarray(a) for a in jax_ctc.ctc_beam_from_logits(jnp.asarray(logits), **kw)]
    got = [t.numpy() for t in ctc.ctc_beam_from_logits(torch.from_numpy(logits), **kw)]
    assert len(got) == len(want) == (3 if confidence else 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if confidence:
        np.testing.assert_allclose(got[2], want[2], **TOL)
    with pytest.raises(ValueError, match="prune_k"):
        ctc.ctc_beam_from_logits(torch.from_numpy(logits), blank_id=BLANK, beam_width=4,
                                 prune_k=0)


@pytest.mark.parametrize("pruned", [False, True])
@pytest.mark.parametrize("lengths", [None, [12, 5, 0, 1, 12, 9]])
def test_host_ctc_beam_matches_jax(pruned, lengths):
    W = 4
    logits, lp, vals, idx = _pruned_frames(4, 6, 12, 20, W + 1)
    frames = lp
    if pruned:  # the engine's dense -1e30 rebuild of the shipped top-k frames
        frames = np.full(lp.shape, -1e30, np.float32)
        np.put_along_axis(frames, idx, vals, -1)
    n = None if lengths is None else np.asarray(lengths)
    got = ctc.ctc_beam_search(frames, 0, W, lengths=n, already_log_probs=True,
                              return_totals=True)
    want = jax_ctc.ctc_beam_search(frames, 0, W, lengths=n, already_log_probs=True,
                                   return_totals=True)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_allclose(got[2], want[2], **TOL)
    for b in range(frames.shape[0]):
        t = frames.shape[1] if n is None else int(n[b])
        if t == 0:
            assert got[0][b] == [] and got[1][b] == 0.0
            continue
        ours = ctc._ctc_beam_py(frames[b, :t], 0, W)
        theirs = jax_ctc._ctc_beam_py(frames[b, :t], 0, W)
        assert ours[0] == theirs[0] == got[0][b]
        np.testing.assert_allclose(ours[1:], theirs[1:], **TOL)
        np.testing.assert_allclose(ours[1:], [got[1][b], got[2][b]], **TOL)
    # from raw logits, without totals, serial
    two = ctc.ctc_beam_search(logits, 0, W)
    assert two[0] == jax_ctc.ctc_beam_search(logits, 0, W)[0] and len(two) == 2


def test_host_ctc_beam_refuses_bad_arguments():
    from rcnn_ocr_tpu_torch import native

    lp = np.zeros((2, 3, 5), np.float32)
    with pytest.raises(RuntimeError, match="failed"):
        native.ctc_beam_search_batch(lp, blank=7, beam_width=4)
    with pytest.raises(ValueError, match="lengths"):
        native.ctc_beam_search_batch(lp, blank=0, beam_width=4, lengths=[1, 2, 3])
    labels, _ = native.ctc_beam_search_batch(lp, blank=0, beam_width=4, threads=1)
    assert len(labels) == 2


def test_rolling_hash_matches_jax_uint32():
    h = np.array([0, 1, 2, 0xFFFFFFFF, 123456789, 3_000_000_000, 0x9E3779B9], np.uint32)
    c = np.array([0, 5, 191, 3, 1, 0, 192], np.int32)
    m1, m2 = jnp.uint32(2654435761), jnp.uint32(2246822519)
    cc = (jnp.asarray(c) + 2).astype(jnp.uint32)
    want1 = np.asarray(jnp.asarray(h) * m1 + cc).astype(np.int64)
    want2 = np.asarray(jnp.asarray(h) * m2 + cc).astype(np.int64)
    t = torch.from_numpy(h.astype(np.int64))
    got1, got2 = ctc._child_hash(t, t, torch.from_numpy(c.astype(np.int64)))
    np.testing.assert_array_equal(got1.numpy(), want1)
    np.testing.assert_array_equal(got2.numpy(), want2)
    assert int(got1.max()) < 2 ** 32 and int(got1.min()) >= 0


def test_greedy_collapse_lengths_match_jax():
    pred = np.array([[0, 1, 1, 0, 2, 2, 2, 1], [1, 0, 2, 2, 0, 0, 3, 3]])
    for lengths in (None, np.array([8, 3]), np.array([0, 8])):
        assert ctc.ctc_greedy_collapse_np(pred, 0, lengths=lengths) == \
            jax_ctc.ctc_greedy_collapse_np(pred, 0, lengths=lengths)
