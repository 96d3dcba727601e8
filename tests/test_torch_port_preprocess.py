"""The port's device resize-pad and host letterbox vs the JAX package's, on the CPU.

Held (``rcnn_ocr_tpu_torch/ops/preprocess.py`` against
``rcnn_ocr_tpu/ops/preprocess.py``):

* ``_coverage_weights`` / ``_bilinear_weights``, built batched: each row
  within 1e-6 of JAX's matrix for that image when both are built in
  float32, within 1e-5 (JAX's float32 error) when the port builds them in
  float64 as its resize does;
* ``host_resize_geometry``: equal on the half-boundary sizes and on a
  seeded fuzz of 200 sizes;
* ``resize_pad_normalize`` on the same canvas batch as JAX's jitted one,
  with 5- and 2-column sizes, images shrinking and growing: every pixel
  within one uint8 step (2/255 after the normalize) and equal on >= 99.9% of
  the pixels (the products run in float64 here, float32 in JAX).  It is
  also within one step of the port's ``ResizeAndPad`` (equal on >= 99.9%)
  and, with the 5-column sizes, bit-equal to it on every pixel, which makes
  a served row bit-equal to ``predict``'s;
* ``resize_pad_normalize(method="linear")`` (JAX's
  ``scale_and_translate`` triangle kernel over the whole canvas, unrounded)
  within 1e-5 of JAX's on seeded canvases, images shrinking and growing,
  smaller than their canvas, with 2- and 5-column sizes; ``resize_pad_u8``
  refuses ``"linear"`` (it has no uint8 form) and both refuse an unknown
  method;
* ``host_letterbox``: the C++ copy equals the numpy twin and JAX's output,
  crop included, and warns of a crop once per process.
"""

import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rcnn_ocr_tpu.ops import preprocess as jax_pre  # noqa: E402
from rcnn_ocr_tpu_torch.data.transforms import ResizeAndPad  # noqa: E402
from rcnn_ocr_tpu_torch.ops import preprocess as pre  # noqa: E402
from rcnn_ocr_tpu_torch.ops.augment import device_normalize  # noqa: E402

STEP = 2.0 / 255.0  # one uint8 step after the [-1, 1] normalize
HALF_BOUNDARY = [(11, 88), (22, 176), (3, 24), (17, 300), (40, 100), (1, 1)]


def _images(seed=0):
    """The cases of the JAX package's test: 8 that mostly shrink onto 32x64,
    8 that grow."""
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, size=(rng.integers(20, 60), rng.integers(40, 160), 3),
                        dtype=np.uint8) for _ in range(8)]
    imgs += [rng.integers(0, 256, size=(rng.integers(12, 24), rng.integers(20, 50), 3),
                         dtype=np.uint8) for _ in range(8)]
    return imgs


@pytest.mark.parametrize("kind", ["coverage", "bilinear"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6), (torch.float64, 1e-5)])
def test_weight_matrices_match_jax(kind, dtype, atol):
    """Built from float32 geometry, as JAX builds them: within 1e-6.  In
    float64, as the port's resize builds them: within 1e-5, JAX's own float32
    error (the coordinates reach 60, where a float32 ulp is 3.8e-6)."""
    rng = np.random.default_rng(1)
    n_out, n_src = 32, 60
    src = rng.integers(1, n_src + 1, size=12).astype(np.float64)
    dst = rng.integers(1, n_out + 1, size=12).astype(np.float64)
    origin = np.floor((n_out - dst) / 2)
    got = getattr(pre, f"_{kind}_weights")(n_out, n_src, *(torch.from_numpy(a).to(dtype)
                                                           for a in (src, dst, origin)))
    assert got.shape == (12, n_out, n_src) and got.dtype == dtype
    fn = getattr(jax_pre, f"_{kind}_weights")
    for b in range(12):
        want = np.asarray(fn(n_out, n_src, jnp.float32(src[b]), jnp.float32(dst[b]),
                             jnp.float32(origin[b])))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=atol)


def test_host_resize_geometry_matches_jax():
    rng = np.random.default_rng(2)
    fuzz = np.stack([rng.integers(1, 400, 200), rng.integers(1, 4000, 200)], axis=1)
    for sizes in (np.array(HALF_BOUNDARY), fuzz):
        for ih, iw in ((32, 100), (32, 128), (64, 256)):
            got = pre.host_resize_geometry(sizes, ih, iw)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, jax_pre.host_resize_geometry(sizes, ih, iw))


def test_half_boundary_rects_match_resize_and_pad():
    """The 5-column path places the rect exactly where ResizeAndPad does on
    the sizes whose float32 geometry rounds the other way (11x88 -> 13 rows)."""
    ih, iw = 32, 100
    imgs = [np.zeros((h, w, 3), np.uint8) for h, w in HALF_BOUNDARY]
    raw, sizes = pre.host_letterbox(imgs, 40, 300)
    sizes5 = np.concatenate([sizes, pre.host_resize_geometry(sizes, ih, iw)], axis=1)
    got = pre.resize_pad_u8(torch.from_numpy(raw), torch.from_numpy(sizes5), ih, iw).numpy()
    want = np.stack([ResizeAndPad(ih, iw)(im) for im in imgs])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("columns", [5, 2])
def test_resize_pad_normalize_matches_jax(columns):
    ih, iw = 32, 64
    imgs = _images()
    raw, sizes = pre.host_letterbox(imgs, 60, 160)
    if columns == 5:
        sizes = np.concatenate([sizes, pre.host_resize_geometry(sizes, ih, iw)], axis=1)
    got = pre.resize_pad_normalize(torch.from_numpy(raw), torch.from_numpy(sizes), ih, iw)
    assert got.dtype == torch.float32 and got.shape == (16, ih, iw, 3)
    got = got.numpy()
    want = np.asarray(jax_pre.resize_pad_normalize(jnp.asarray(raw), jnp.asarray(sizes), ih, iw,
                                                   method="area"))
    diff = np.abs(got - want)
    assert diff.max() <= STEP + 1e-6, diff.max()
    # JAX's normalize in XLA may differ from the lookup in the last float bit:
    # "equal" is equal to within that bit, i.e. the same uint8 pixel
    same = diff < 1e-6
    assert same.mean() >= 0.999, same.mean()
    host = np.stack([ResizeAndPad(ih, iw)(im) for im in imgs])
    host_norm = device_normalize(torch.from_numpy(host)).numpy()
    to_host = np.abs(got - host_norm)
    assert to_host.max() <= STEP + 1e-6 and (to_host == 0).mean() >= 0.999
    if columns == 5:
        np.testing.assert_array_equal(got, host_norm)  # bit-equal: predict's batch


def test_unknown_and_linear_methods_raise():
    """An unknown method raises in both functions; "linear" has no uint8
    form and raises in resize_pad_u8, while resize_pad_normalize computes it
    (JAX's value on this canvas: a white pad around the linear resize)."""
    raw = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    sizes = torch.tensor([[8, 8]])
    for fn in (pre.resize_pad_normalize, pre.resize_pad_u8):
        with pytest.raises(ValueError, match="method"):
            fn(raw, sizes, 8, 8, method="aera")
    with pytest.raises(ValueError, match="no uint8 form"):
        pre.resize_pad_u8(raw, sizes, 8, 8, method="linear")
    got = pre.resize_pad_normalize(raw, torch.tensor([[4, 6]]), 8, 8, method="linear").numpy()
    want = np.asarray(jax_pre.resize_pad_normalize(jnp.asarray(raw.numpy()),
                                                   jnp.asarray([[4, 6]]), 8, 8, method="linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("columns", [5, 2])
@pytest.mark.parametrize("canvas,model", [((60, 160), (32, 64)), ((24, 50), (32, 100)),
                                          ((80, 300), (32, 128))])
def test_linear_resize_matches_jax(columns, canvas, model):
    """method="linear" against JAX's on seeded canvases: images that shrink
    and grow, all but one smaller than their canvas, so the canvas's zeros
    beyond them enter the bottom and right edges of the resize (JAX's
    weights span the whole canvas); the one that fills its canvas reads
    other edges on a larger canvas."""
    ih, iw = model
    rng = np.random.default_rng(canvas[0])
    imgs = [rng.integers(0, 256, size=(int(rng.integers(4, canvas[0] + 1)),
                                       int(rng.integers(4, canvas[1] + 1)), 3), dtype=np.uint8)
            for _ in range(11)]
    imgs.append(rng.integers(0, 256, size=(*canvas, 3), dtype=np.uint8))  # fills its canvas
    raw, sizes = pre.host_letterbox(imgs, *canvas)
    if columns == 5:
        sizes = np.concatenate([sizes, pre.host_resize_geometry(sizes, ih, iw)], axis=1)
    got = pre.resize_pad_normalize(torch.from_numpy(raw), torch.from_numpy(sizes), ih, iw,
                                   method="linear")
    assert got.dtype == torch.float32 and got.shape == (12, ih, iw, 3)
    want = np.asarray(jax_pre.resize_pad_normalize(jnp.asarray(raw), jnp.asarray(sizes), ih, iw,
                                                   method="linear"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the canvas matters: on a larger one, zeros enter the last image's edges
    bigger, _ = pre.host_letterbox(imgs, canvas[0] + 8, canvas[1] + 8)
    again = pre.resize_pad_normalize(torch.from_numpy(bigger), torch.from_numpy(sizes), ih, iw,
                                     method="linear")
    want_bigger = np.asarray(jax_pre.resize_pad_normalize(
        jnp.asarray(bigger), jnp.asarray(sizes), ih, iw, method="linear"))
    np.testing.assert_allclose(again.numpy(), want_bigger, rtol=0, atol=1e-5)
    assert not torch.equal(again[-1], got[-1])


def test_host_letterbox_matches_the_twin_and_jax(monkeypatch):
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, size=(int(rng.integers(1, 50)), int(rng.integers(1, 90)), 3),
                         dtype=np.uint8) for _ in range(70)]  # >= 64 rows: the thread pool
    imgs.append(np.ascontiguousarray(rng.integers(0, 256, (48, 130, 3), dtype=np.uint8)))
    monkeypatch.setattr(pre, "_warned_crop", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, sizes = pre.host_letterbox(imgs, 40, 80)
        pre.host_letterbox(imgs, 40, 80)
    assert sum("CROPPED" in str(w.message) for w in caught) == 1
    twin, twin_sizes = pre._letterbox_py(imgs, 40, 80)
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(sizes, twin_sizes)
    want, want_sizes = jax_pre.host_letterbox(imgs, 40, 80)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sizes, want_sizes)
    assert sizes[-1].tolist() == [40, 80]  # cropped to the canvas


def test_host_letterbox_fills_a_given_buffer_and_refuses_bad_inputs():
    from rcnn_ocr_tpu_torch import native

    imgs = [np.full((3, 5, 3), 7, np.uint8), np.full((6, 2, 3), 9, np.uint8)]
    buf = torch.full((2, 8, 8, 3), 200, dtype=torch.uint8)
    out, sizes = pre.host_letterbox(imgs, 8, 8, out=buf.numpy())
    assert out.ctypes.data == buf.data_ptr()
    np.testing.assert_array_equal(buf.numpy(), pre._letterbox_py(imgs, 8, 8)[0])
    assert sizes.tolist() == [[3, 5], [6, 2]]
    with pytest.raises(ValueError, match="contiguous HWC uint8"):
        native.letterbox_u8([imgs[0][:, ::2]], 8, 8)
    with pytest.raises(ValueError, match="contiguous HWC uint8"):
        native.letterbox_u8([imgs[0].astype(np.float32)], 8, 8)
    with pytest.raises(ValueError, match="out must be"):
        native.letterbox_u8(imgs, 8, 8, out=np.zeros((2, 8, 4, 3), np.uint8))
    empty, empty_sizes = native.letterbox_u8([], 4, 4)
    assert empty.shape == (0, 4, 4, 3) and empty_sizes.shape == (0, 2)
