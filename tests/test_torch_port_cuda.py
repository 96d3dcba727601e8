"""The port's CUDA kernels and main path on the card (marker ``cuda``).

Run on a machine with an NVIDIA card (sm_90a) and nvcc:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -p no:xdist --noconftest

(``--noconftest``: this file needs nothing of tests/conftest.py, which
sets up JAX; ``tests/ -m cuda`` would also collect the JAX test files,
which need flax.)

Without a card every test here skips; the skip is decided in the
``cuda_device`` fixture, never at import.  Each kernel is held against its
plain PyTorch version on the same inputs: fp32 at rtol/atol 1e-5 (only the
summation order differs), bf16 outputs at one bf16 ulp (rtol 8e-3).
"""

import numpy as np
import pytest
import torch

from rcnn_ocr_tpu_torch.ops import kernels
from rcnn_ocr_tpu_torch.ops.bilstm_scan import bilstm_scan, scan_reference
from rcnn_ocr_tpu_torch.ops.se_scale import se_scale, se_scale_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest tests/test_torch_port_cuda.py -m cuda "
                    "-p no:xdist --noconftest)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(3, 5, 7, 40), (4, 8, 32, 256), (2, 4, 16, 512), (1, 1, 1, 16)])
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
