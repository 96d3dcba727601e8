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
        for _, _, x in engine._batches(imgs, 4):
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


def test_train_step_through_the_kernels_matches_plain_only(cuda_device):
    """A small fp32 model, dropout off: one make_train_step step (SGD at lr
    0) through the kernels and under plain_only() from the same statistics
    gives the same loss, gradients (every backbone weight has one) and
    running statistics."""
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
        torch.testing.assert_close(grads_k[n], gp, rtol=1e-3, atol=1e-5 * gp.abs().max().item(),
                                   msg=n)
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
