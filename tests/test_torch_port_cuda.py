"""The port's CUDA kernels and main path on the card (marker ``cuda``).

Run on a machine with an NVIDIA card (sm_90a) and nvcc:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -p no:xdist --noconftest

(``--noconftest``: this file needs nothing of tests/conftest.py, which
sets up JAX; ``tests/ -m cuda`` would also collect the JAX test files,
which need flax.)

The kernels launch as thread-block clusters, which needs Hopper (sm_90a).
Without a card every test here skips; the skip is decided in the
``cuda_device`` fixture, never at import.  Each kernel is held against its
plain PyTorch version on the same inputs: fp32 at rtol/atol 1e-5 (only the
summation order differs), bf16 outputs at one bf16 ulp (rtol 8e-3).
"""

import os

import numpy as np
import pytest
import torch

from rcnn_ocr_tpu_torch.ops import kernels
from rcnn_ocr_tpu_torch.ops.bilstm_scan import bilstm_scan, route as lstm_route, scan_reference
from rcnn_ocr_tpu_torch.ops.se_scale import route as se_route, se_scale, se_scale_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest tests/test_torch_port_cuda.py -m cuda "
                    "-p no:xdist --noconftest)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(3, 5, 7, 40), (4, 8, 32, 256), (2, 4, 16, 512), (1, 1, 1, 16),
                                   (2048, 4, 16, 512), (5, 4, 16, 512), (2, 3, 3, 20),
                                   (2, 1, 1, 1024), (2, 16, 64, 1024), (1, 64, 64, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_se_scale_kernel_matches_plain(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    c = shape[-1]
    s = max(1, c // 16)
    x = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    w1 = torch.randn(c, s, device=cuda_device, generator=g) / c ** 0.5
    w2 = torch.randn(s, c, device=cuda_device, generator=g) / s ** 0.5
    before = kernels.SE_SCALE.launches
    got = se_scale(x, w1, w2)
    torch.cuda.synchronize()
    assert kernels.SE_SCALE.launches == before + 1
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=8e-3, atol=1e-6)
    torch.testing.assert_close(got.float(), se_scale_reference(x, w1, w2).float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_se_scale_unaligned_input_takes_scalar_copies(cuda_device, dtype):
    """x one element past a 16-byte boundary: the kernel copies element by
    element instead of with 16-byte vectors, and gives the same result."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    flat = torch.randn(1 + 3 * 8 * 32 * 256, device=cuda_device, generator=g).to(dtype)
    x = flat[1:].view(3, 8, 32, 256)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    w1 = torch.randn(256, 16, device=cuda_device, generator=g) / 16
    w2 = torch.randn(16, 256, device=cuda_device, generator=g) / 4
    got = se_scale(x, w1, w2)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=8e-3, atol=1e-6)
    torch.testing.assert_close(got.float(), se_scale_reference(x, w1, w2).float(), **tol)


@pytest.mark.parametrize("shape,dtype,cluster,samples", [
    ((256, 8, 32, 256), torch.bfloat16, 8, 2), ((256, 8, 32, 256), torch.float32, 8, 1),
    ((2048, 4, 16, 512), torch.bfloat16, 8, 4), ((2048, 4, 16, 512), torch.float32, 8, 2),
])
def test_se_scale_main_path_shapes_take_the_cluster_route(cuda_device, shape, dtype, cluster,
                                                          samples):
    plan = se_route(shape, shape[-1] // 16, dtype)
    assert (plan["route"], plan["cluster"], plan["samples"]) == ("cluster", cluster, samples)


@pytest.mark.parametrize("shape", [(2, 16, 64, 1024), (1, 64, 64, 256)])
def test_se_scale_large_slabs_stream(cuda_device, shape):
    """Slabs whose channel run per CTA exceeds 48 KiB take the streaming route."""
    assert se_route(shape, shape[-1] // 16, torch.bfloat16)["route"] == "streaming"


def test_se_scale_kernel_refuses_other_layouts(cuda_device):
    x = torch.randn(2, 4, 4, 16, device=cuda_device).permute(0, 3, 1, 2).permute(0, 2, 3, 1)
    x = x.transpose(1, 2)  # not contiguous NHWC
    w1, w2 = torch.randn(16, 1, device=cuda_device), torch.randn(1, 16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        se_scale(x, w1, w2)


@pytest.mark.parametrize("t,b,h", [(16, 5, 256), (3, 1, 32), (16, 33, 64)])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_bilstm_scan_kernel_matches_plain(cuda_device, t, b, h, w_dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    xs = torch.randn(t, 2, b, 4 * h, device=cuda_device, generator=g)
    w_hh = (torch.randn(2, h, 4 * h, device=cuda_device, generator=g) / h ** 0.5).to(w_dtype)
    before = kernels.BILSTM_SCAN.launches
    got = bilstm_scan(xs, w_hh, h)
    torch.cuda.synchronize()
    assert kernels.BILSTM_SCAN.launches == before + 1
    torch.testing.assert_close(got, scan_reference(xs, w_hh, h), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h", [32, 64, 256, 512])
@pytest.mark.parametrize("b", [1, 5, 33, 256])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_bilstm_scan_routes_match_plain(cuda_device, h, b, w_dtype):
    """Both routes (H=512 fp32 streams w_hh; the rest keep it resident) with
    ragged batch tiles, against the plain version at rtol/atol 1e-5."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    xs = torch.randn(16, 2, b, 4 * h, device=cuda_device, generator=g)
    w_hh = (torch.randn(2, h, 4 * h, device=cuda_device, generator=g) / h ** 0.5).to(w_dtype)
    want_route = "streaming" if (h, w_dtype) == (512, torch.float32) else "resident"
    assert lstm_route(b, h, w_dtype)["route"] == want_route
    got = bilstm_scan(xs, w_hh, h)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, scan_reference(xs, w_hh, h), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [256, 2048])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_bilstm_scan_main_path_shape_is_resident(cuda_device, b, w_dtype):
    plan = lstm_route(b, 256, w_dtype)
    assert (plan["route"], plan["cluster"]) == ("resident", 8)
    assert plan["rows"] % 8 == 0 and plan["active_clusters"] >= 1
    if b == 256:  # one wave: every cluster runs at once
        assert 2 * -(-b // plan["rows"]) <= plan["active_clusters"]


def test_plain_only_skips_the_kernels(cuda_device):
    xs = torch.randn(2, 2, 3, 32, device=cuda_device)
    w_hh = torch.randn(2, 8, 32, device=cuda_device)
    before = kernels.launch_counts()
    with kernels.plain_only():
        bilstm_scan(xs, w_hh, 8)
    assert kernels.launch_counts() == before


def test_main_path_goes_through_the_kernels(cuda_device):
    """A small seeded model through OCRInference on the card: 11 SE and 2
    BiLSTM launches per encoded batch; fp32 kernels vs plain versions agree."""
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_params
    from rcnn_ocr_tpu_torch.ops.augment import device_normalize

    tokens = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
    model = RCNN(num_classes=len(tokens), hidden_size=64, width_mult=0.25, with_ctc_head=True)
    init_params(model, torch.Generator().manual_seed(0))
    variables = dict(to_jax_variables(model), itos=tokens)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, size=(int(rng.integers(10, 60)), int(rng.integers(20, 300)), 3),
                         dtype=np.uint8) for _ in range(6)]
    for dtype in (torch.bfloat16, torch.float32):
        engine = OCRInference(variables, device="cuda", img_h=32, img_w=128, dtype=dtype)
        kernels.reset_launch_counts()
        texts = engine.predict(imgs, max_length=8, batch_size=4)
        assert kernels.launch_counts() == {"se_scale": 22, "bilstm_scan": 4}
        kernels.reset_launch_counts()
        ctc = engine.predict_ctc(imgs, batch_size=4)
        assert kernels.launch_counts() == {"se_scale": 22, "bilstm_scan": 4}
        assert len(texts) == len(ctc) == 6
    with torch.inference_mode():
        for _, _, batch in engine._batches(imgs, 4):
            x = device_normalize(engine._device_batch(batch))
            enc = engine.model.encode(x)
            with kernels.plain_only():
                enc_plain = engine.model.encode(x)
            torch.testing.assert_close(enc, enc_plain, rtol=1e-4, atol=2e-4)


def _grads(fn, inputs, dout):
    ins = [t.detach().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*ins), ins, dout)


@pytest.mark.parametrize("shape", [(128, 8, 32, 256), (128, 4, 16, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_se_scale_gradients_through_the_kernel_match_plain(cuda_device, shape, dtype):
    """Train-step shapes (bs 128): the Function's output (the kernel's) and
    gradients (hand VJP) vs autograd through the plain version in fp32;
    bf16 results within one bf16 ulp."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    c = shape[-1]
    x = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    w1 = (torch.randn(c, c // 16, device=cuda_device, generator=g) / c ** 0.5).to(dtype)
    w2 = (torch.randn(c // 16, c, device=cuda_device, generator=g) / 4).to(dtype)
    dout = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    rtol = 1e-5 if dtype == torch.float32 else 8e-3
    before = kernels.SE_SCALE.launches
    out = se_scale(x, w1, w2)
    assert kernels.SE_SCALE.launches == before + 1
    torch.testing.assert_close(out.float(), se_scale_reference(x, w1, w2).float(), rtol=rtol,
                               atol=1e-5 if dtype == torch.float32 else 1e-6)
    got = _grads(se_scale, (x, w1, w2), dout)
    want = _grads(se_scale_reference, (x.float(), w1.float(), w2.float()), dout.float())
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b, rtol=rtol, atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_bilstm_scan_gradients_through_the_kernel_match_plain(cuda_device, w_dtype):
    """Train-step shape (T=16, B=128, H=256): the Function's output (the
    kernel's; the backward recomputes through the plain version and never
    sees it) and gradients vs autograd through the plain version, at
    rtol/atol 1e-5."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    t, b, h = 16, 128, 256
    xs = torch.randn(t, 2, b, 4 * h, device=cuda_device, generator=g)
    w_hh = (torch.randn(2, h, 4 * h, device=cuda_device, generator=g) / h ** 0.5).to(w_dtype)
    dys = torch.randn(t, 2, b, h, device=cuda_device, generator=g)
    before = kernels.BILSTM_SCAN.launches
    torch.testing.assert_close(bilstm_scan(xs, w_hh, h), scan_reference(xs, w_hh, h),
                               rtol=1e-5, atol=1e-5)
    assert kernels.BILSTM_SCAN.launches == before + 1
    got = _grads(lambda a, w: bilstm_scan(a, w, h), (xs, w_hh), dys)
    want = _grads(lambda a, w: scan_reference(a, w, h), (xs, w_hh), dys)
    assert got[1].dtype == w_dtype
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a.float(), b_.float(), rtol=1e-5,
                                   atol=1e-5 * b_.abs().max().item())


# Per-leaf relative L2 error of the gradients through the kernels against
# plain_only()'s, as chip_smoke.py holds them.  Not elementwise: the
# kernels' ~5e-7 forward differences flip a few ReLUs that sit within ~1e-6
# of their kink, and each flip moves single gradient entries by up to a few
# percent of the leaf's max.  The limit stands on two full-width readings on
# the card: the kernels' worst leaf at 6.1e-3, and the plain path's own
# 9.7e-3 when its images are nudged by 1e-6.
GRAD_REL_L2 = 2e-2


def test_train_step_through_the_kernels_matches_plain_only(cuda_device):
    """A small fp32 model, dropout off: one make_train_step step (SGD at lr
    0) through the kernels and under plain_only() from the same statistics
    gives the same loss and running statistics, every backbone weight a
    gradient, and every leaf's gradient within a relative L2 error of
    ``GRAD_REL_L2``."""
    from rcnn_ocr_tpu_torch.data.loader import collate_batch
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_params
    from rcnn_ocr_tpu_torch.training.optim import build_optimizer
    from rcnn_ocr_tpu_torch.training.train_step import create_train_state, make_train_step
    from rcnn_ocr_tpu_torch.vocab.charset import Charset

    cs = Charset.from_tokens(["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij"))
    model = RCNN(num_classes=cs.num_classes, hidden_size=64, width_mult=0.25,
                 with_ctc_head=True, enc_dropout_p=0.0)
    init_params(model, torch.Generator().manual_seed(0))
    model.attn.dropout_p = 0.0
    model.to(cuda_device)
    rng = np.random.default_rng(0)
    items = [(rng.uniform(-1, 1, size=(32, 128, 3)).astype(np.float32),
              "".join(rng.choice(list("abcdefghij"), size=5))) for _ in range(8)]
    batch = collate_batch(items, cs, 8, with_ctc=True)
    sgd0 = build_optimizer("SGD", 0.0, momentum=0.0)
    step = make_train_step(model, sgd0, 8, cs.pad_id, head="both", ctc_blank_id=cs.ctc_blank_id)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}

    def run():
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(stats0[n])
        loss = float(step(create_train_state(model, sgd0), batch)["loss"])
        return (loss, {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: b.clone() for n, b in model.named_buffers()})

    kernels.reset_launch_counts()
    loss_k, grads_k, stats_k = run()
    assert kernels.launch_counts() == {"se_scale": 11, "bilstm_scan": 2}
    with kernels.plain_only():
        loss_p, grads_p, stats_p = run()
    assert loss_k == pytest.approx(loss_p, rel=1e-5)
    for n, gp in grads_p.items():
        if n.startswith(("cnn.", "enc_rnn")):
            assert grads_k[n].abs().max() > 0, n
        rel_l2 = ((grads_k[n] - gp).norm() / gp.norm()).item()
        assert rel_l2 <= GRAD_REL_L2, (n, rel_l2)
    for n, sp in stats_p.items():
        if sp.is_floating_point():
            torch.testing.assert_close(stats_k[n], sp, rtol=1e-4, atol=1e-6, msg=n)


def test_device_train_augment_on_the_card_matches_the_cpu(cuda_device):
    """The augmentation ops on the card vs the same functions on the CPU with
    the same parameters (matrices, brightness/contrast, invert coins) within
    1e-5; the whole pipeline is seeded by its generator and normalizes
    exactly with every probability 0."""
    from rcnn_ocr_tpu_torch.ops import augment

    rng = np.random.default_rng(0)
    b, h, w = 16, 32, 128
    u8 = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
    params = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.uniform(-3, 3, b), 1 + rng.uniform(-0.08, 0.08, b),
        rng.uniform(-0.03, 0.03, b) * w, rng.uniform(-0.03, 0.03, b) * h)]
    alpha = torch.from_numpy(1 + rng.uniform(-0.2, 0.2, b).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(-0.2, 0.2, b).astype(np.float32))

    def pipeline(x, dev):
        m = augment.inverse_affine_matrices(*(p.to(dev) for p in params), h, w)
        y = augment.affine_warp(x.to(dev).float() / 255, m)
        return augment.apply_brightness_contrast(y, alpha.to(dev), beta.to(dev))

    torch.testing.assert_close(pipeline(u8, cuda_device).cpu(), pipeline(u8, "cpu"), rtol=1e-5,
                               atol=1e-5)
    off = {"p_ShiftScaleRotate": 0, "p_BrightnessContrast": 0, "invert_p": 0}
    x = u8.to(cuda_device)
    out = augment.device_train_augment(x, torch.Generator(device=cuda_device).manual_seed(0), off)
    torch.testing.assert_close(out, augment.device_normalize(x), rtol=0, atol=1e-6)
    runs = [augment.device_train_augment(x, torch.Generator(device=cuda_device).manual_seed(3),
                                         {"invert_p": 0.5}) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0].device.type == "cuda"
    assert torch.isfinite(runs[0]).all() and not torch.equal(runs[0], out)


def test_run_training_two_epochs_on_the_card_with_a_resume(cuda_device, tmp_path):
    """A small model trains two epochs on the card through both kernels
    (launch counts per step and per validation batch), then a resume from
    its experiment dir continues the counters for a third."""
    import csv

    from chip_smoke import png_bytes
    from rcnn_ocr_tpu_torch.training.checkpoint import load_checkpoint_blob
    from rcnn_ocr_tpu_torch.training.config import Config
    from rcnn_ocr_tpu_torch.training.train import run_training

    tokens = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
    (tmp_path / "charset.txt").write_text("\n".join(tokens) + "\n", encoding="utf-8")
    rng = np.random.default_rng(0)
    root = tmp_path / "data"
    root.mkdir()
    with open(root / "labels.csv", "w", newline="", encoding="utf-8") as f:
        wr = csv.writer(f)
        for i in range(48):
            label = "".join(rng.choice(list("abcdefghij"), size=int(rng.integers(1, 6))))
            (root / f"{i}.png").write_bytes(
                png_bytes(rng.integers(0, 256, (int(rng.integers(24, 40)), 96), dtype=np.uint8)))
            wr.writerow([f"{i}.png", label])
    cfg = {"train_csvs": [str(root / "labels.csv")], "train_roots": [str(root)],
           "charset_path": str(tmp_path / "charset.txt"), "img_h": 32, "img_w": 128,
           "max_len": 8, "hidden_size": 64, "width_mult": 0.25, "batch_size": 16, "epochs": 2,
           "val_size": 16, "head": "both", "exp_dir": str(tmp_path / "exp"), "num_workers": 2,
           "progress": False, "seed": 0}
    kernels.reset_launch_counts()
    result = run_training(Config(cfg))
    steps, val_batches = result["global_step"], 2 * 1
    assert steps == 4 and np.isfinite(result["val_loss"])
    assert kernels.launch_counts() == {"se_scale": 11 * (steps + val_batches),
                                       "bilstm_scan": 2 * (steps + val_batches)}
    resumed = run_training(Config({"resume_path": str(tmp_path / "exp"), "epochs": 3,
                                   "progress": False}))
    assert resumed["start_epoch"] == 3 and resumed["global_step"] == 6
    assert load_checkpoint_blob(str(tmp_path / "exp" / "last_ckpt.msgpack"))["epoch"] == 3


def test_logaddexp_of_two_minus_infinities_is_minus_infinity(cuda_device):
    """The CTC beam folds dead (-inf) candidates with torch.logaddexp."""
    inf = float("inf")
    a = torch.tensor([-inf, -inf, 0.0, -1.5], device=cuda_device)
    b = torch.tensor([-inf, 2.0, -inf, -1.5], device=cuda_device)
    got = torch.logaddexp(a, b).cpu()
    assert got[0].item() == -inf and not torch.isnan(got).any()
    torch.testing.assert_close(got, torch.logaddexp(a.cpu(), b.cpu()), rtol=0, atol=0)


def _beam_model(num_classes=12, hidden=32):
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_train_params

    model = RCNN(num_classes=num_classes, hidden_size=hidden, width_mult=0.25,
                 with_ctc_head=True, blank_id=3).eval()
    init_train_params(model, torch.Generator().manual_seed(5))
    with torch.no_grad():
        model.attn.w_gen.mul_(4.0)
    return model


@pytest.mark.parametrize("k,fused,penalty", [(1, False, 0.0), (5, True, 0.6), (13, False, 0.0)])
def test_attention_beam_on_the_card_matches_the_cpu(cuda_device, k, fused, penalty):
    """The same fp32 encoder states through the beam on the card and on the
    CPU (top-k ties, gathers and the LM row gather on CUDA)."""
    model = _beam_model()
    enc = torch.randn(64, 16, 32, generator=torch.Generator().manual_seed(1))
    lm = torch.randn(12, 12, generator=torch.Generator().manual_seed(2)) if fused else None
    kw = dict(batch_max_length=10, length_penalty=penalty, lm_logp=lm,
              lm_weight=0.5 if fused else 0.0, return_alignment=True)
    with torch.no_grad():
        want = model.attn.beam_search(enc, k, **kw)
        got = model.to(cuda_device).attn.beam_search(enc.to(cuda_device), k, **kw)
    rows = (got[0].cpu() == want[0]).all(dim=1)
    assert rows.float().mean() >= 0.99, f"{int(rows.sum())}/{len(rows)} rows equal"
    torch.testing.assert_close(got[1].cpu()[rows], want[1][rows], rtol=1e-5, atol=1e-4)
    assert (got[2].cpu()[rows] == want[2][rows]).all()


@pytest.mark.parametrize("w,k,fused", [(16, 16, False), (16, 16, True), (5, 6, False),
                                       (8, 3, True)])
def test_ctc_beam_on_the_card_matches_the_cpu(cuda_device, w, k, fused):
    """The same fp32 pruned frames through the device prefix beam on the card
    and on the CPU: every row equal, log-probs within 1e-5."""
    from rcnn_ocr_tpu_torch.ops.ctc import ctc_beam_search_device, ctc_top_frames

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(256, 16, 194, generator=g) * 3.0
    logits[:8, :, :] = 0.0  # exact ties everywhere
    vals, idx = ctc_top_frames(logits, k)
    lengths = torch.randint(0, 17, (256,), generator=g)
    lm = torch.randn(194, 194, generator=g) if fused else None
    kw = dict(blank_id=3, beam_width=w, lm_logp=lm, lm_weight=0.7 if fused else 0.0,
              sos_id=1, return_posterior=True)
    want = ctc_beam_search_device(vals, idx, lengths=lengths, **kw)
    got = ctc_beam_search_device(vals.to(cuda_device), idx.to(cuda_device),
                                 lengths=lengths.to(cuda_device), **kw)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[3].cpu(), want[3], rtol=1e-5, atol=1e-5)
    v_cuda, i_cuda = ctc_top_frames(logits.to(cuda_device), k)
    assert torch.equal(i_cuda.cpu(), idx)


def test_host_beam_library_builds_and_runs_here(cuda_device):
    from rcnn_ocr_tpu_torch import native
    from rcnn_ocr_tpu_torch.ops.ctc import _ctc_beam_py, ctc_beam_search

    native.load()
    assert native.library_path().exists()
    lp = torch.log_softmax(torch.randn(4, 12, 20, generator=torch.Generator().manual_seed(4)),
                           -1).numpy()
    labels, lps, totals = ctc_beam_search(lp, 0, 5, already_log_probs=True, return_totals=True)
    for b in range(4):
        ref = _ctc_beam_py(lp[b], 0, 5)
        assert labels[b] == ref[0]
        np.testing.assert_allclose([lps[b], totals[b]], ref[1:], rtol=1e-5, atol=1e-5)


def test_beam_batches_launch_the_kernels(cuda_device):
    """Every beam decode of OCRInference encodes through 11 se_scale and 2
    bilstm_scan launches per batch."""
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables

    tokens = ["<PAD>", "<SOS>", "<EOS>", "<BLANK>"] + list("abcdefgh")
    variables = dict(to_jax_variables(_beam_model()), itos=tokens)
    lm = np.random.default_rng(0).normal(size=(12, 12)).astype(np.float32)
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, size=(32, int(rng.integers(40, 128)), 3), dtype=np.uint8)
            for _ in range(6)]
    engine = OCRInference(variables, device="cuda", img_h=32, img_w=128, lm=lm)
    for call in (lambda: engine.predict(imgs, max_length=8, batch_size=4, beam_width=3),
                 lambda: engine.predict(imgs, max_length=8, batch_size=4, beam_width=3,
                                        lm_weight=0.5, length_penalty=0.6),
                 lambda: engine.predict_ctc(imgs, batch_size=4, method="beam"),
                 lambda: engine.predict_ctc(imgs, batch_size=4, method="beam", lm_weight=0.5,
                                            return_confidence=True),
                 lambda: engine.predict_ctc(imgs, batch_size=4, method="beam",
                                            device_beam=False)):
        kernels.reset_launch_counts()
        out = call()
        assert kernels.launch_counts() == {"se_scale": 22, "bilstm_scan": 4}
        assert len(out) == 6


def _serving_engine(dtype=torch.float32):
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables

    tokens = ["<PAD>", "<SOS>", "<EOS>", "<BLANK>"] + list("abcdefgh")
    variables = dict(to_jax_variables(_beam_model()), itos=tokens)
    return OCRInference(variables, device="cuda", img_h=32, img_w=128, dtype=dtype)


def _mixed_lines(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(int(rng.integers(12, 80)), int(rng.integers(16, 500)), 3),
                         dtype=np.uint8) for _ in range(n)]


def test_device_resize_pad_matches_the_cpu_and_ignores_tf32(cuda_device):
    """The same canvas batch resized on the card and on the CPU: every pixel
    within one uint8 step (equal on >= 99.9%), and the card's output equal
    with TF32 on and off (the products are float64)."""
    from rcnn_ocr_tpu_torch.ops import preprocess as pre

    imgs = _mixed_lines(64, seed=0)
    raw, sizes = pre.host_letterbox(imgs, 80, 500)
    sizes = np.concatenate([sizes, pre.host_resize_geometry(sizes, 32, 128)], axis=1)
    raw_t, sizes_t = torch.from_numpy(raw), torch.from_numpy(sizes)
    want = pre.resize_pad_u8(raw_t, sizes_t, 32, 128)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        outs = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            outs.append(pre.resize_pad_u8(raw_t.to(cuda_device), sizes_t.to(cuda_device),
                                          32, 128).cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert torch.equal(outs[0], outs[1])
    diff = (outs[0].int() - want.int()).abs()
    assert diff.max() <= 1 and (diff == 0).float().mean() >= 0.999


def test_letterbox_into_pinned_memory(cuda_device):
    from rcnn_ocr_tpu_torch.ops import preprocess as pre

    imgs = [np.ascontiguousarray(im) for im in _mixed_lines(70, seed=1)]
    buf = torch.empty((70, 80, 500, 3), dtype=torch.uint8, pin_memory=True)
    assert buf.is_pinned()
    _, sizes = pre.host_letterbox(imgs, 80, 500, out=buf.numpy())
    twin, twin_sizes = pre._letterbox_py(imgs, 80, 500)
    assert np.array_equal(buf.numpy(), twin) and np.array_equal(sizes, twin_sizes)
    on_card = buf.to(cuda_device, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(on_card.cpu(), buf)


@pytest.mark.parametrize("method", ["attention", "attention_beam", "ctc_greedy", "ctc_beam"])
def test_predict_serving_launches_the_kernels(cuda_device, method):
    """11 se_scale and 2 bilstm_scan per served batch; one string per image,
    each equal to predict / predict_ctc's (the rows are bit-equal)."""
    engine = _serving_engine()
    imgs = _mixed_lines(6, seed=2)
    kw = {"attention_beam": dict(beam_width=3), "ctc_beam": dict(beam_width=4)}.get(method, {})
    kernels.reset_launch_counts()
    out = engine.predict_serving(imgs, max_length=8, batch_size=4, canvas="auto", method=method,
                                 **kw)
    assert kernels.launch_counts() == {"se_scale": 22, "bilstm_scan": 4}
    if method.startswith("ctc"):
        want = engine.predict_ctc(imgs, batch_size=4,
                                  method="beam" if method == "ctc_beam" else "greedy", **kw)
    else:
        want = engine.predict(imgs, max_length=8, batch_size=4, **kw)
    assert out == want


def test_long_lines_on_the_card(cuda_device):
    """A line that fits one tile decodes as predict / predict_ctc decode it;
    a long one launches 11 + 2 per tile batch."""
    engine = _serving_engine()
    short = _mixed_lines(5, seed=3)
    short = [np.ascontiguousarray(im[:, : 2 * im.shape[0]]) for im in short]  # <= 64 px wide
    assert engine.predict_ctc_long(short) == engine.predict_ctc(short)
    assert engine.predict_long(short, max_length=8) == engine.predict(short, max_length=8)
    wide = np.random.default_rng(4).integers(0, 256, (32, 128 + 64 * 8, 3), dtype=np.uint8)
    kernels.reset_launch_counts()
    out = engine.predict_long([wide, short[0]], method="ctc_greedy", batch_size=16)
    assert len(out) == 2 and kernels.launch_counts() == {"se_scale": 11, "bilstm_scan": 2}


def test_daemon_on_the_card_answers_png_and_jpeg_and_reloads(cuda_device, tmp_path):
    """The port's OCRServer over an engine on the card: a PNG and a JPEG
    request get the in-process predict_serving strings (each dispatch 11 + 2
    launches), and a SIGHUP swaps in a second engine on the card that answers
    alike."""
    import json
    import signal
    import threading
    import time
    import urllib.request

    from rcnn_ocr_tpu_torch.data.image_io import imdecode, png_encode
    from rcnn_ocr_tpu_torch.serving import OCRServer, install_hot_reload, serving_predict_fn

    knobs = dict(method="ctc_greedy", batch_size=4, canvas=(80, 500), max_length=8)
    engine = _serving_engine()
    imgs = _mixed_lines(2, seed=5)
    with open(os.path.join(os.path.dirname(__file__), "torch_port_data", "jpeg",
                           "line_03.jpg"), "rb") as f:
        jpeg = f.read()
    bodies = [("image/png", png_encode(imgs[0])), ("image/jpeg", jpeg)]
    want = engine.predict_serving([imdecode(b) for _, b in bodies], **knobs)
    server = OCRServer(serving_predict_fn(engine, **knobs), host="127.0.0.1", port=0,
                       max_batch=4, max_wait_ms=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d/predict" % server.address[:2]

    def ask():
        out = []
        for ctype, body in bodies:
            req = urllib.request.Request(base, data=body, headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=60) as resp:
                out += json.loads(resp.read())["texts"]
        return out

    old = signal.getsignal(signal.SIGHUP)
    try:
        kernels.reset_launch_counts()
        assert ask() == want
        assert kernels.launch_counts() == {"se_scale": 22, "bilstm_scan": 4}
        install_hot_reload(server, lambda: serving_predict_fn(_serving_engine(), **knobs))
        signal.raise_signal(signal.SIGHUP)
        deadline = time.monotonic() + 60
        while server.batcher.engine_swaps < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.batcher.engine_swaps == 1
        assert ask() == want
    finally:
        signal.signal(signal.SIGHUP, old)
        server.close()
        thread.join(timeout=10)


@pytest.mark.parametrize("shape,cout,kernel,stride,padding", [
    ((64, 16, 64, 128), 256, 3, 2, ((1, 1), (1, 1))),  # layer1_block0.conv1
    ((64, 8, 32, 256), 256, 3, 1, ((1, 1), (1, 1))),  # layer2
    ((64, 4, 16, 512), 512, 3, 1, ((1, 1), (1, 1))),  # layer4
    ((64, 4, 16, 512), 512, 2, (2, 1), ((0, 0), (1, 1))),  # out0
    ((64, 2, 17, 512), 512, 2, 1, "VALID"),  # out1
    ((2, 5, 7, 12), 20, 3, 2, ((1, 1), (1, 1))),  # 8 rows, channels not multiples of 8
])
def test_int8_accumulators_on_the_card_equal_the_cpu(cuda_device, shape, cout, kernel, stride,
                                                     padding):
    """The int32 accumulators of the same int8 codes, card against CPU:
    exactly equal (integer sums)."""
    from rcnn_ocr_tpu_torch.ops.quant import int8_conv_accumulate

    g = np.random.default_rng(0)
    xq = torch.from_numpy(g.integers(-127, 128, shape, dtype=np.int8))
    wq = torch.from_numpy(g.integers(-127, 128, (kernel, kernel, shape[-1], cout),
                                     dtype=np.int8))
    strides = (stride, stride) if isinstance(stride, int) else stride
    got = int8_conv_accumulate(xq.to(cuda_device), wq.to(cuda_device), strides, padding)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), int8_conv_accumulate(xq, wq, strides, padding))


@pytest.mark.parametrize("exported_on", ["cuda", "cpu"])
@pytest.mark.parametrize("method,quantize", [("ctc_greedy", True), ("attention", False)])
def test_artifact_on_the_card_equals_the_live_engine(cuda_device, tmp_path, exported_on, method,
                                                     quantize):
    """An artifact exported on the card (or on the CPU, listing both
    platforms, and moved) answers as the live engine on the card, its
    programs launching 11 se_scale and 2 bilstm_scan per batch."""
    from rcnn_ocr_tpu_torch.export import ServingArtifact, export_serving_artifact
    from rcnn_ocr_tpu_torch.inference import OCRInference
    from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables

    tokens = ["<PAD>", "<SOS>", "<EOS>", "<BLANK>"] + list("abcdefgh")
    variables = dict(to_jax_variables(_beam_model()), itos=tokens)
    imgs = _mixed_lines(6, seed=5)
    live = OCRInference(variables, device="cuda", img_h=32, img_w=128, quantize=quantize)
    if quantize:
        live.calibrate(imgs, batch_size=4)
    source = live
    if exported_on == "cpu":  # the same weights and scales, on the CPU
        source = OCRInference(dict(live.variables, itos=tokens), device="cpu", img_h=32,
                              img_w=128, quantize=quantize)
    out_dir = str(tmp_path / "art")
    export_serving_artifact(source, out_dir, method=method, batch_size=4, canvas=(80, 500),
                            max_length=8, platforms=("cuda", "cpu"))
    art = ServingArtifact.load(out_dir)
    assert art.device.type == "cuda"
    kernels.reset_launch_counts()
    got = art.predict(imgs)
    assert kernels.launch_counts() == {"se_scale": 22, "bilstm_scan": 4}
    assert got == live.predict_serving(imgs, max_length=8, batch_size=4, canvas=(80, 500),
                                       method=method)


def _small_engine_variables():
    from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables
    from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_params

    tokens = ["<PAD>", "<SOS>", "<EOS>", " "] + list("abcdefghij")
    model = RCNN(num_classes=len(tokens), hidden_size=64, width_mult=0.25, with_ctc_head=True)
    init_params(model, torch.Generator().manual_seed(0))
    return dict(to_jax_variables(model), itos=tokens)


def test_two_replicas_on_one_card_launch_per_block_and_match(cuda_device):
    """``mesh=["cuda:0", "cuda:0"]``: each replica runs its half of every
    batch on its own stream and thread, launching 11 + 2 kernels; fp32 CTC
    strings equal the engine without a mesh, as do ``mesh=True``'s."""
    from rcnn_ocr_tpu_torch.inference import OCRInference

    variables = _small_engine_variables()
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, size=(int(rng.integers(10, 60)), int(rng.integers(20, 300)), 3),
                         dtype=np.uint8) for _ in range(6)]
    kw = dict(device="cuda", img_h=32, img_w=128, dtype=torch.float32)
    single = OCRInference(variables, **kw)
    want = single.predict_ctc(imgs, batch_size=4)
    for mesh in (True, ["cuda:0", "cuda:0"]):
        engine = OCRInference(variables, mesh=mesh, **kw)
        kernels.reset_launch_counts()
        assert engine.predict_ctc(imgs, batch_size=4) == want
        encodes = -(-6 // engine._round_batch(4)) * len(engine._replicas)  # one per block
        assert kernels.launch_counts() == {"se_scale": 11 * encodes, "bilstm_scan": 2 * encodes}
        served = engine.predict_serving(imgs, method="ctc_greedy", batch_size=4,
                                        canvas=(64, 320))
        assert served == single.predict_serving(imgs, method="ctc_greedy", batch_size=4,
                                                canvas=(64, 320))


def test_kernels_launch_on_the_tensors_card_from_another_current_card(cuda_device):
    """Both kernels on cuda:1 from a thread whose current card is cuda:0
    (the plan caches are per card, so cuda:1's first launch of a shape sets
    its own shared-memory attribute), held against the plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: launches a kernel on cuda:1 while cuda:0 is current")
    dev = torch.device("cuda", 1)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(256, 8, 32, 256, device=dev, generator=g).to(torch.bfloat16)
    w1 = torch.randn(256, 16, device=dev, generator=g) / 16
    w2 = torch.randn(16, 256, device=dev, generator=g) / 4
    xs = torch.randn(16, 2, 256, 1024, device=dev, generator=g)
    w_hh = (torch.randn(2, 256, 1024, device=dev, generator=g) / 16).to(torch.bfloat16)
    torch.cuda.synchronize(dev)
    out = {}

    def launch():
        torch.cuda.set_device(0)
        out["se"] = se_scale(x, w1, w2)
        out["lstm"] = bilstm_scan(xs, w_hh, 256)
        out["route"] = lstm_route(256, 256, torch.bfloat16, device=dev)
        torch.cuda.synchronize(dev)

    import threading

    thread = threading.Thread(target=launch)
    thread.start()
    thread.join()
    assert out["route"]["route"] == "resident"
    torch.testing.assert_close(out["se"].float(), se_scale_reference(x, w1, w2).float(),
                               rtol=8e-3, atol=1e-6)
    torch.testing.assert_close(out["lstm"], scan_reference(xs, w_hh, 256), rtol=1e-5,
                               atol=1e-5)
