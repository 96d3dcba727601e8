"""The port's model modules vs the JAX package, in fp32 on the CPU.

The same numpy weights (a JAX-initialized tree with perturbed batch-norm
statistics) and inputs go through both.  Tolerances are those the repo
holds JAX-vs-torch work to (tests/test_torch_parity.py:88,110,126):
rtol 1e-4 / atol 2e-4 on encoder states and feature maps, rtol 1e-3 /
atol 5e-4 on logits with equal argmaxes.  The BiLSTM module is held at
1e-5 like its kernel.

The space-to-depth stem (``rcnn_ocr_tpu_torch/ops/stem.py``) mirrors
``tests/test_stem_s2d.py`` against the JAX functions: the rewritten conv
within rtol 1e-5 of the plain one (atol 1e-5 / 1e-4 for the 27- and
144-term sums), its pieces equal to JAX's, the backbone with ``stem_s2d``
against JAX's default and s2d backbones, train mode unchanged, odd sizes
falling back to the plain conv, and ``RCNN(stem_s2d=True)``'s greedy and CTC
tokens equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcnn_ocr_tpu.models import RCNN as JaxRCNN
from rcnn_ocr_tpu.models.attention import AttentionDecoder as JaxAttention
from rcnn_ocr_tpu.models.lstm import BiLSTM as JaxBiLSTM
from rcnn_ocr_tpu.models.seresnet31 import SEResNet31 as JaxSEResNet31
from rcnn_ocr_tpu.ops import stem as jax_stem
from rcnn_ocr_tpu_torch.interop.jax_params import load_jax_variables
from rcnn_ocr_tpu_torch.models.attention import AttentionDecoder
from rcnn_ocr_tpu_torch.models.lstm import BiLSTM
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, TIME_DOWNSAMPLE
from rcnn_ocr_tpu_torch.models.seresnet31 import ConvBN, SEResNet31
from rcnn_ocr_tpu_torch.ops import stem as port_stem

ENC = dict(rtol=1e-4, atol=2e-4)
LOGITS = dict(rtol=1e-3, atol=5e-4)
V, HIDDEN, WIDTH, MAX_LEN = 14, 32, 0.125, 5


def _numpy_tree(variables, seed=1):
    """JAX variables as numpy, with BN scales/shifts/statistics moved off
    their identity init so eval batch norm is exercised."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))

    def bump(path, a):
        names = [getattr(k, "key", "") for k in path]
        if names[-1] in ("scale", "mean"):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if names[-1] == "var":
            return (a * rng.uniform(0.5, 1.5, size=a.shape)).astype(np.float32)
        if names[-1] == "bias" and "bn" in names:
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(bump, tree)


@pytest.fixture(scope="module")
def rcnn_pair():
    jm = JaxRCNN(num_classes=V, hidden_size=HIDDEN, width_mult=WIDTH, with_ctc_head=True,
                 dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 32, 64, 3)).astype(np.float32)
    variables = jm.init(
        {"params": jax.random.PRNGKey(0)}, x, text=jnp.zeros((2, MAX_LEN + 1), jnp.int32),
        batch_max_length=MAX_LEN, method=jm.init_all,
    )
    variables = _numpy_tree(variables)
    tm = RCNN(num_classes=V, hidden_size=HIDDEN, width_mult=WIDTH, with_ctc_head=True).eval()
    load_jax_variables(tm, variables)
    return jm, tm, variables, x


def test_encode_matches_jax(rcnn_pair):
    jm, tm, variables, x = rcnn_pair
    want = np.asarray(jm.apply(variables, x, train=False, method=jm.encode))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64 // TIME_DOWNSAMPLE, HIDDEN)
    np.testing.assert_allclose(got, want, **ENC)


def test_teacher_forced_logits_match_jax(rcnn_pair):
    jm, tm, variables, x = rcnn_pair
    text = np.random.default_rng(2).integers(3, V, size=(2, MAX_LEN + 1)).astype(np.int32)
    text[:, 0] = 1
    want = np.asarray(jm.apply(variables, x, text=text, train=False, batch_max_length=MAX_LEN))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), text=torch.from_numpy(text),
                 batch_max_length=MAX_LEN).numpy()
    np.testing.assert_allclose(got, want, **LOGITS)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_greedy_logits_and_alignment_match_jax(rcnn_pair):
    jm, tm, variables, x = rcnn_pair
    want, want_align = jm.apply(variables, x, batch_max_length=MAX_LEN,
                                method=jm.greedy_decode_aligned)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), batch_max_length=MAX_LEN).numpy()
        got2, got_align = tm.greedy_decode_aligned(torch.from_numpy(x), batch_max_length=MAX_LEN)
    np.testing.assert_allclose(got, np.asarray(want), **LOGITS)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))
    np.testing.assert_array_equal(got2.numpy(), got)
    np.testing.assert_array_equal(got_align.numpy(), np.asarray(want_align))


def test_ctc_logits_match_jax(rcnn_pair):
    jm, tm, variables, x = rcnn_pair
    want = np.asarray(jm.apply(variables, x, train=False, method=jm.ctc_logits))
    with torch.no_grad():
        got = tm.ctc_logits(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **LOGITS)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_eval_outputs_match_single_heads(rcnn_pair):
    jm, tm, variables, x = rcnn_pair
    text = np.random.default_rng(3).integers(3, V, size=(2, MAX_LEN + 1)).astype(np.int32)
    want = jm.apply(variables, x, text=text, batch_max_length=MAX_LEN, with_ctc=True,
                    method=jm.eval_outputs)
    with torch.no_grad():
        got = tm.eval_outputs(torch.from_numpy(x), text=torch.from_numpy(text),
                              batch_max_length=MAX_LEN, with_ctc=True)
    assert set(got) == set(want) == {"tf_logits", "greedy_logits", "ctc_logits"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **LOGITS)


@pytest.mark.parametrize("width,shape", [(0.125, (2, 32, 128, 3)), (1.0, (2, 32, 64, 3))])
def test_seresnet31_features_match_jax(width, shape):
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    jm = JaxSEResNet31(width_mult=width, dtype=jnp.float32)
    variables = _numpy_tree(jm.init({"params": jax.random.PRNGKey(1)}, x, train=False), seed=5)
    want = np.asarray(jm.apply(variables, x, train=False))
    tm = SEResNet31(width_mult=width).eval()
    load_jax_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 1, shape[2] // 8, max(8, round(512 * width)))
    np.testing.assert_allclose(got, want, **ENC)


def test_bilstm_module_matches_jax():
    x = np.random.default_rng(6).normal(size=(3, 7, 12)).astype(np.float32)
    jm = JaxBiLSTM(hidden_size=8, out_size=10)
    variables = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.PRNGKey(2), x)))
    variables["params"]["bias"] = np.random.default_rng(7).normal(size=(2, 32)).astype(np.float32)
    want = np.asarray(jm.apply(variables, x))
    tm = BiLSTM(12, 8, 10)
    load_jax_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_attention_decoder_blank_mask_matches_jax():
    """A charset with <BLANK>: its logit is -1e4 and greedy never feeds it back."""
    v, c, h, steps = 9, 12, 16, 6
    blank = 3
    bh = np.random.default_rng(8).normal(size=(2, 5, c)).astype(np.float32)
    text = np.random.default_rng(9).integers(0, v, size=(2, steps + 1)).astype(np.int32)
    jm = JaxAttention(num_classes=v, hidden_size=h, blank_id=blank, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jm.init(jax.random.PRNGKey(3), bh, text=text, train=False,
                                 batch_max_length=steps)))
    tm = AttentionDecoder(v, c, h, blank_id=blank)
    load_jax_variables(tm, variables)
    want_tf = np.asarray(jm.apply(variables, bh, text=text, train=False, batch_max_length=steps))
    want_gr = np.asarray(jm.apply(variables, bh, train=False, batch_max_length=steps))
    with torch.no_grad():
        got_tf = tm(torch.from_numpy(bh), text=torch.from_numpy(text), batch_max_length=steps)
        got_gr = tm(torch.from_numpy(bh), batch_max_length=steps)
    np.testing.assert_allclose(got_tf.numpy(), want_tf, **LOGITS)
    np.testing.assert_allclose(got_gr.numpy(), want_gr, **LOGITS)
    assert (got_gr[..., blank] == -1e4).all()
    assert (got_gr.argmax(-1) != blank).all()


def test_eval_only_flags_raise():
    """stem_s2d with the int8 stem raises ValueError in both packages (the
    int8 conv would bypass the rewrite); quantize_stem without quantize and
    stem_s2d alone build; train mode is the ``train`` argument, as in JAX, so
    nn.Module's training flag changes nothing."""
    assert SEResNet31(quantize=True, width_mult=0.125).quantize
    x0 = jnp.zeros((1, 32, 16, 3))
    for build in (lambda: SEResNet31(width_mult=0.125, quantize=True, quantize_stem=True,
                                     stem_s2d=True),
                  lambda: JaxSEResNet31(width_mult=0.125, quantize=True, quantize_stem=True,
                                        stem_s2d=True).init(jax.random.PRNGKey(0), x0)):
        with pytest.raises(ValueError, match="stem_s2d composes with the fp/bf16 stem only"):
            build()
    assert SEResNet31(width_mult=0.125, stem_s2d=True).stem0.s2d
    assert not SEResNet31(width_mult=0.125, quantize_stem=True).stem0.quantize
    assert SEResNet31(width_mult=0.125, quantize=True, quantize_stem=True).stem1.quantize
    tm = SEResNet31(width_mult=0.125)  # nn.Module starts in training mode
    x = torch.randn(2, 32, 16, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(tm(x), tm.eval()(x))
        stats = tm.stem0.bn.running_mean.clone()
        tm(x, train=True)
    assert not torch.equal(tm.stem0.bn.running_mean, stats)


# --- the space-to-depth stem -------------------------------------------------------

def _conv3x3_p1(x, k):
    return jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding=((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape,cout,atol", [((2, 8, 12, 3), 5, 1e-5),
                                             ((1, 6, 10, 16), 8, 1e-4)])
def test_s2d_conv_exact(shape, cout, atol):
    """tests/test_stem_s2d.py's two op cases (C=3, and wide channels): the
    port's rewrite against JAX's plain conv, and each piece equal to JAX's."""
    rng = np.random.default_rng(shape[-1])
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(3, 3, shape[-1], cout)).astype(np.float32)
    want = np.asarray(_conv3x3_p1(jnp.asarray(x), jnp.asarray(k)))
    w = torch.from_numpy(k).permute(3, 2, 0, 1)  # HWIO -> OIHW
    got = port_stem.conv3x3_s2d(_nchw(x), w).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(port_stem.s2d_kernel(w).permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jax_stem.s2d_kernel(jnp.asarray(k))))
    xs = port_stem.space_to_depth_pad1(_nchw(x))
    np.testing.assert_array_equal(xs.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jax_stem.space_to_depth_pad1(jnp.asarray(x))))
    y = rng.normal(size=(2, 3, 5, 4 * cout)).astype(np.float32)
    np.testing.assert_array_equal(port_stem.depth_to_space(_nchw(y)).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jax_stem.depth_to_space(jnp.asarray(y))))
    with pytest.raises(ValueError, match="3x3"):
        port_stem.s2d_kernel(torch.zeros(4, 3, 2, 2))


@pytest.fixture(scope="module")
def backbone_vars():
    x = np.random.default_rng(2).normal(size=(2, 32, 64, 3)).astype(np.float32)
    v = JaxSEResNet31(width_mult=0.25, dtype=jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)
    return _numpy_tree(v), x


def _port_backbone(v, **kw):
    holder = torch.nn.Module()
    holder.cnn = SEResNet31(width_mult=0.25, **kw).eval()
    load_jax_variables(holder, {col: {"cnn": tree} for col, tree in v.items()})
    return holder.cnn


def test_backbone_stem_s2d_matches_default(backbone_vars):
    """SEResNet31(stem_s2d=True) in fp32 at inference: JAX's default and s2d
    backbones on the same variables, within the feature-map tolerance."""
    v, x = backbone_vars
    tm = _port_backbone(v, stem_s2d=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    for kw in ({}, {"stem_s2d": True}):
        want = np.asarray(JaxSEResNet31(width_mult=0.25, dtype=jnp.float32, **kw).apply(
            v, jnp.asarray(x), train=False))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **ENC)


def test_backbone_stem_s2d_train_mode_unchanged(backbone_vars):
    """The rewrite is inference-only: with train=True the s2d backbone's
    output and batch-norm updates equal the default's bit for bit."""
    v, x = backbone_vars
    base, s2d = _port_backbone(v), _port_backbone(v, stem_s2d=True)
    with torch.no_grad():
        want = base(torch.from_numpy(x), train=True)
        got = s2d(torch.from_numpy(x), train=True)
    assert torch.equal(got, want)
    for (name, a), (_, b) in zip(base.named_buffers(), s2d.named_buffers()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("hw", [(9, 12), (10, 13), (10, 12)])
def test_s2d_conv_bn_falls_back_on_odd_sizes(hw):
    """ConvBN(s2d=True) takes the rewrite only on even H and W (JAX's
    conditions); an odd side runs the plain conv, bit for bit."""
    torch.manual_seed(0)
    plain, s2d = ConvBN(3, 8).eval(), ConvBN(3, 8, s2d=True).eval()
    s2d.load_state_dict(plain.state_dict())
    x = torch.randn(2, 3, *hw)
    assert s2d._takes_s2d(x, train=False) == (hw == (10, 12))
    assert not s2d._takes_s2d(x, train=True)
    with torch.no_grad():
        if hw == (10, 12):
            torch.testing.assert_close(s2d(x), plain(x), rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(s2d(x), plain(x))
    strided = ConvBN(3, 8, stride=(2, 2), s2d=True)
    assert not strided._takes_s2d(torch.zeros(1, 3, 10, 12), train=False)


def test_rcnn_stem_s2d_tokens_match_jax(rcnn_pair):
    """RCNN(stem_s2d=True): the encoder states, greedy tokens and CTC argmax
    of JAX's RCNN(stem_s2d=True) on the same variables."""
    _, _, variables, x = rcnn_pair
    kw = dict(num_classes=V, hidden_size=HIDDEN, width_mult=WIDTH, with_ctc_head=True)
    jm = JaxRCNN(**kw, dtype=jnp.float32, stem_s2d=True)
    tm = load_jax_variables(RCNN(**kw, stem_s2d=True).eval(), variables)
    want_enc = np.asarray(jm.apply(variables, x, train=False, method=jm.encode))
    want_greedy = np.asarray(jm.apply(variables, x, train=False, batch_max_length=MAX_LEN))
    want_ctc = np.asarray(jm.apply(variables, x, train=False, method=jm.ctc_logits))
    with torch.no_grad():
        got_enc = tm.encode(torch.from_numpy(x)).numpy()
        got_greedy = tm(torch.from_numpy(x), batch_max_length=MAX_LEN).numpy()
        got_ctc = tm.ctc_logits(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_enc, want_enc, **ENC)
    np.testing.assert_array_equal(got_greedy.argmax(-1), want_greedy.argmax(-1))
    np.testing.assert_array_equal(got_ctc.argmax(-1), want_ctc.argmax(-1))
