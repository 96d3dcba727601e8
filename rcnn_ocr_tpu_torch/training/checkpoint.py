"""Read and write the JAX package's msgpack checkpoints without flax or msgpack.

Counterpart of ``rcnn_ocr_tpu/training/checkpoint.py``: the reading side
(``load_checkpoint_blob``, ``load_variables``) and ``save_weights``.  Those
files are written by ``flax.serialization.msgpack_serialize``: plain msgpack
maps, arrays, strings, binaries, ints, floats, nil and booleans, plus
flax's extension types 1 (an ndarray, itself msgpack ``(shape, dtype name,
raw bytes)``) and 3 (a numpy scalar in the same encoding), with arrays over
1 GiB split into ``__msgpack_chunked_array__`` maps.  This module decodes
exactly that, in pure Python and numpy (bfloat16 arrays come back as
float32: numpy has no bfloat16), and :func:`msgpack_serialize` encodes the
same types as flax does, byte for byte (maps with their keys sorted, as
flax's pass through ``jax.tree_util`` leaves them; arrays over 1 GiB are
refused, not chunked).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables

CHECKPOINT_FORMAT_VERSION = 1

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# msgpack type bytes beyond the fix* ranges
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {  # type byte -> (length format, reader method)
    0xC4: (">B", "binary"), 0xC5: (">H", "binary"), 0xC6: (">I", "binary"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xD9: (">B", "text"), 0xDA: (">H", "text"), 0xDB: (">I", "text"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"), 0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.text(b & 0x1F)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _SIZED:
            fmt, method = _SIZED[b]
            return getattr(self, method)(self.unpack(fmt))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def binary(self, n: int) -> bytes:
        return bytes(self.take(n))

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack_restore(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """Decode one msgpack document as ``flax.serialization.msgpack_restore`` does."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack document")
    return _unchunk(out)


def load_checkpoint_blob(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        blob = msgpack_restore(f.read())
    version = int(blob.get("format_version", 1)) if isinstance(blob, dict) else 1
    if version > CHECKPOINT_FORMAT_VERSION:
        raise ValueError(
            f"{path} is checkpoint format {version}, newer than this loader "
            f"({CHECKPOINT_FORMAT_VERSION})"
        )
    return blob


def load_variables(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Model variables ``{"params", "batch_stats"}`` from a weights or full
    checkpoint file, and the whole blob (``itos``, ``config``, ...)."""
    blob = load_checkpoint_blob(path)
    if "params" not in blob:
        raise ValueError(f"{path} holds no model parameters")
    return {"params": blob["params"], "batch_stats": blob.get("batch_stats", {})}, blob


def _header(small: int, fix_limit: int, sized: Tuple[int, int, int], n: int) -> bytes:
    """A fix* byte for ``n < fix_limit`` (``small | n``), else the 8/16/32-bit
    length form from ``sized`` (the 8-bit one may be 0: not offered)."""
    if n < fix_limit:
        return bytes([small | n])
    for code, fmt, limit in zip(sized, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack item of length {n} is too long")


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15), (0xD2, ">i", 2**31),
                                 (0xD3, ">q", 2**63)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixext[n]]) if n in fixext else _header(0, 0, (0xC7, 0xC8, 0xC9), n)
    return head + struct.pack(">b", code) + payload


def _pack_ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.nbytes > 2**30:
        raise ValueError(f"cannot write an array of {arr.dtype} and {arr.nbytes} bytes")
    return _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(v: Any) -> bytes:
    if v is None:
        return b"\xc0"
    if v is True or v is False:
        return b"\xc3" if v else b"\xc2"
    if isinstance(v, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _pack_ndarray(v))
    if isinstance(v, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _pack_ndarray(np.asarray(v)))
    if isinstance(v, int):
        return _pack_int(v)
    if isinstance(v, float):
        return b"\xcb" + struct.pack(">d", v)
    if isinstance(v, str):
        raw = v.encode("utf-8")
        return _header(0xA0, 32, (0xD9, 0xDA, 0xDB), len(raw)) + raw
    if isinstance(v, bytes):
        return _header(0, 0, (0xC4, 0xC5, 0xC6), len(v)) + v
    if isinstance(v, (list, tuple)):
        return _header(0x90, 16, (0, 0xDC, 0xDD), len(v)) + b"".join(_pack(x) for x in v)
    if isinstance(v, dict):
        items = sorted(v.items())
        return _header(0x80, 16, (0, 0xDE, 0xDF), len(items)) + b"".join(
            _pack(k) + _pack(x) for k, x in items)
    raise TypeError(f"cannot write {type(v).__name__} to msgpack")


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a tree of dicts (string keys), lists, strings, bytes, numbers,
    booleans, None and numpy arrays / scalars as
    ``flax.serialization.msgpack_serialize`` does."""
    return _pack(tree)


def save_weights(path: str, state) -> None:
    """Write a train state's model variables as the JAX package's bare
    weights file ``{"format_version", "params", "batch_stats"}``: the EMA
    parameters when the state keeps them (as JAX's ``_weights_blob`` does),
    else the model's.  Written to ``path + ".tmp"`` and moved into place, so
    an interrupted write never leaves a torn file."""
    variables = to_jax_variables(state.model, state.ema_params)
    blob = {"format_version": CHECKPOINT_FORMAT_VERSION, **variables}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(blob))
    os.replace(tmp, path)
