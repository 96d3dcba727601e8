"""Read the JAX package's msgpack checkpoints without flax or msgpack.

Counterpart of the reading side of ``rcnn_ocr_tpu/training/checkpoint.py``
(``load_checkpoint_blob``, ``load_variables``).  Those files are written by
``flax.serialization.msgpack_serialize``: plain msgpack maps, arrays,
strings, binaries, ints, floats, nil and booleans, plus flax's extension
types 1 (an ndarray, itself msgpack ``(shape, dtype name, raw bytes)``) and 3
(a numpy scalar in the same encoding), with arrays over 1 GiB split into
``__msgpack_chunked_array__`` maps.  This module decodes exactly that, in
pure Python and numpy.  bfloat16 arrays come back as float32 (numpy has no
bfloat16).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

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
