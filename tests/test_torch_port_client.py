"""The port's client puts the JAX client's pixels on the wire, on the CPU.

JAX's ``client.py:_encode_image`` hands arrays to ``cv2.imencode``, which
reads them as BGR(A); the port's encodes with ``image_io.png_encode`` in
that channel order.  For the same array both clients' bytes decode
(through JAX's ``imdecode_cv2`` and through the port's ``imdecode``) to
equal pixels: RGB, RGBA, gray and ``[H, W, 1]`` arrays at odd sizes, the
PNG lossless both ways.  Bytes and paths pass through unchanged, and a
non-uint8 array raises in both.  ``png_encode`` itself round-trips through
cv2, every row with filter None.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from rcnn_ocr_tpu import client as jax_client  # noqa: E402
from rcnn_ocr_tpu.data.transforms import imdecode_cv2  # noqa: E402
from rcnn_ocr_tpu_torch import client as port_client  # noqa: E402
from rcnn_ocr_tpu_torch.data.image_io import imdecode, png_encode  # noqa: E402


def _array(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("shape", [(7, 13, 3), (32, 95, 3), (9, 4, 4), (11, 17), (6, 5, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_both_clients_put_the_same_pixels_on_the_wire(shape):
    arr = _array(shape, seed=sum(shape))
    ours, theirs = port_client._encode_image(arr), jax_client._encode_image(arr)
    want = imdecode_cv2(theirs)
    for decode in (imdecode_cv2, imdecode):
        np.testing.assert_array_equal(decode(ours), want)
    if len(shape) == 3 and shape[2] == 3:  # taken as BGR: the server reads it reversed
        np.testing.assert_array_equal(want, arr[:, :, ::-1])


def test_bytes_and_paths_pass_through(tmp_path):
    data = png_encode(_array((5, 6, 3), seed=1))
    path = tmp_path / "a.png"
    path.write_bytes(data)
    for item in (data, bytearray(data), str(path), path):
        assert port_client._encode_image(item) == jax_client._encode_image(item) == data


def test_non_uint8_arrays_raise_in_both():
    arr = np.zeros((4, 4, 3), np.float32)
    for client in (jax_client, port_client):
        with pytest.raises(TypeError, match="uint8"):
            client._encode_image(arr)


@pytest.mark.parametrize("shape", [(9, 14), (9, 14, 3), (8, 3, 4), (1, 5, 3), (12, 1), (5, 7, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_png_encode_round_trips_through_cv2(shape):
    import struct
    import zlib

    arr = _array(shape, seed=7)
    data = png_encode(arr)
    flat = arr[:, :, 0] if arr.ndim == 3 and arr.shape[2] == 1 else arr
    want = np.repeat(flat[:, :, None], 3, axis=2) if flat.ndim == 2 else flat[:, :, :3]
    np.testing.assert_array_equal(imdecode(data), want)
    np.testing.assert_array_equal(imdecode_cv2(data), want)
    (n,) = struct.unpack(">I", data[33:37])  # the IDAT chunk after the 8-byte signature and IHDR
    rows = np.frombuffer(zlib.decompress(data[41 : 41 + n]), np.uint8).reshape(shape[0], -1)
    np.testing.assert_array_equal(rows[:, 0], 0)  # filter None on every row


def test_png_encode_refuses_other_arrays():
    with pytest.raises(TypeError):
        png_encode(np.zeros((2, 2), np.uint16))
    with pytest.raises(ValueError):
        png_encode(np.zeros((2, 2, 2), np.uint8))
