"""The port's two kernel modules on the CPU: plain versions vs JAX.

``se_scale`` and ``bilstm_scan`` take their plain PyTorch versions on a CPU
tensor; these tests hold those against the JAX references and the Pallas
kernels (interpret mode on the CPU), in fp32 at rtol/atol 1e-5, the
tolerance of tests/test_pallas_kernels.py.  The CUDA kernels themselves are
held against the plain versions in tests/test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcnn_ocr_tpu.ops.lstm_pallas import _scan_reference, bilstm_scan as jax_bilstm_scan
from rcnn_ocr_tpu.ops.se_pallas import se_scale as jax_se_scale, se_scale_reference as jax_se_ref
from rcnn_ocr_tpu_torch.ops import kernels
from rcnn_ocr_tpu_torch.ops.bilstm_scan import bilstm_scan, scan_reference
from rcnn_ocr_tpu_torch.ops.se_scale import se_scale, se_scale_reference

TOL = dict(rtol=1e-5, atol=1e-5)


def _se_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    s = max(1, c // 4)
    x = rng.normal(size=shape).astype(np.float32)
    w1 = rng.normal(size=(c, s)).astype(np.float32)
    w2 = rng.normal(size=(s, c)).astype(np.float32)
    return x, w1, w2


@pytest.mark.parametrize("shape", [(4, 3, 5, 16), (2, 8, 32, 32), (3, 4, 16, 64)])
def test_se_scale_plain_matches_jax_reference(shape):
    x, w1, w2 = _se_inputs(0, shape)
    want = np.asarray(jax_se_ref(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2)))
    got = se_scale_reference(*map(torch.from_numpy, (x, w1, w2))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_se_scale_plain_matches_pallas_interpret():
    x, w1, w2 = _se_inputs(1, (4, 3, 5, 16))
    want = np.asarray(jax_se_scale(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2)))
    got = se_scale(*map(torch.from_numpy, (x, w1, w2))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _lstm_inputs(seed, t, b, h):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(t, 2, b, 4 * h)).astype(np.float32)
    w_hh = (rng.normal(size=(2, h, 4 * h)) * 0.2).astype(np.float32)
    return xs, w_hh


@pytest.mark.parametrize("t,b,h", [(5, 4, 8), (16, 3, 32), (1, 1, 4)])
def test_scan_plain_matches_jax_reference(t, b, h):
    xs, w_hh = _lstm_inputs(2, t, b, h)
    want = np.asarray(_scan_reference(jnp.asarray(xs), jnp.asarray(w_hh), h))
    got = scan_reference(torch.from_numpy(xs), torch.from_numpy(w_hh), h).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_scan_plain_matches_pallas_interpret():
    xs, w_hh = _lstm_inputs(3, 5, 4, 8)
    want = np.asarray(jax_bilstm_scan(jnp.asarray(xs), jnp.asarray(w_hh), 8))
    got = bilstm_scan(torch.from_numpy(xs), torch.from_numpy(w_hh), 8).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_scan_bf16_weights_compute_in_fp32():
    """bf16 w_hh: the plain version upcasts the weights and keeps h in fp32,
    as the Pallas kernel does (lstm_pallas.py:69-76)."""
    xs, w_hh = _lstm_inputs(4, 4, 2, 8)
    w_bf16 = torch.from_numpy(w_hh).to(torch.bfloat16)
    got = scan_reference(torch.from_numpy(xs), w_bf16, 8)
    want = scan_reference(torch.from_numpy(xs), w_bf16.float(), 8)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_without_counting():
    kernels.reset_launch_counts()
    x, w1, w2 = _se_inputs(5, (2, 2, 3, 8))
    xs, w_hh = _lstm_inputs(5, 3, 2, 4)
    se_scale(*map(torch.from_numpy, (x, w1, w2)))
    bilstm_scan(torch.from_numpy(xs), torch.from_numpy(w_hh), 4)
    assert kernels.launch_counts() == {"se_scale": 0, "bilstm_scan": 0}


def test_plain_only_nests_and_restores():
    t = torch.zeros(1)
    assert kernels.use_kernel(t) is False
    with kernels.plain_only():
        with kernels.plain_only():
            pass
        assert getattr(kernels._plain_forced, "on") is True
    assert getattr(kernels._plain_forced, "on") is False


def test_other_devices_raise():
    with pytest.raises(RuntimeError, match="no kernel for device"):
        kernels.use_kernel(torch.zeros(1, device="meta"))


def test_kernel_sources_and_build_flags():
    replaces = {"se_scale": ("rcnn_ocr_tpu/ops/se_pallas.py", "_se_forward"),
                "bilstm_scan": ("rcnn_ocr_tpu/ops/lstm_pallas.py", "_bilstm_pallas")}
    assert set(replaces) == set(kernels.KERNELS)
    for k in kernels.KERNELS.values():
        src = k.source.read_text()
        assert "extern \"C\"" in src and k.symbol in src and k.plan_symbol in src
        assert "#include <torch" not in src and "ATen" not in src
        assert "cudaGetLastError" in src
        # the note beside every kernel: the TPU kernel it replaces, and its bound
        assert "Replaces the Pallas TPU kernel" in src
        assert all(part in src for part in replaces[k.name])
        assert "Bound on the H100:" in src
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert kernels.BUILD_DIR.parts[-2:] == ("build", "rcnn_ocr_tpu_torch")
