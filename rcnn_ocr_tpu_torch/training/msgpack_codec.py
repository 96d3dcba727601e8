"""The JAX package's msgpack checkpoint format, without flax, msgpack or torch.

Those files are written by ``flax.serialization.msgpack_serialize``: plain
msgpack maps, arrays, strings, binaries, ints, floats, nil and booleans,
plus flax's extension types 1 (an ndarray, itself msgpack ``(shape, dtype
name, raw bytes)``) and 3 (a numpy scalar in the same encoding), with arrays
over 1 GiB split into ``__msgpack_chunked_array__`` maps.  This module
decodes exactly that, in pure Python and numpy (bfloat16 arrays come back as
float32: numpy has no bfloat16; with ``keep_bfloat16=True`` they come back as
:class:`BFloat16Array`, their stored bits), and :func:`msgpack_serialize`
encodes the same types as flax does, byte for byte (maps with their keys
sorted, as flax's pass through ``jax.tree_util`` leaves them; arrays over
1 GiB are refused, not chunked; a :class:`BFloat16Array` is written back as
bfloat16).  It also holds the format-version refusal
(:func:`load_checkpoint_blob`) and the atomic write every slot goes
through.  It imports no torch, so the checkpoint tools
(:mod:`rcnn_ocr_tpu_torch.ckpt_info`, :mod:`rcnn_ocr_tpu_torch.average_checkpoints`)
start quickly; :mod:`rcnn_ocr_tpu_torch.training.checkpoint` re-exports it.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

CHECKPOINT_FORMAT_VERSION = 1

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class BFloat16Array:
    """A stored bfloat16 array (or numpy scalar, ``scalar=True``) as its raw
    bits, ``uint16``: what ``msgpack_restore(keep_bfloat16=True)`` returns
    for one, and what :func:`msgpack_serialize` writes back as bfloat16."""

    dtype_name = "bfloat16"

    def __init__(self, bits: np.ndarray, scalar: bool = False):
        self.bits = np.asarray(bits, dtype=np.uint16)
        self.scalar = scalar

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.bits.shape

    @property
    def size(self) -> int:
        return int(self.bits.size)

    @property
    def nbytes(self) -> int:
        return int(self.bits.nbytes)

    def to_float32(self) -> np.ndarray:
        """The values, exact in float32."""
        return (self.bits.astype(np.uint32) << 16).view(np.float32)

    @classmethod
    def from_float64(cls, values: np.ndarray) -> "BFloat16Array":
        """``values`` rounded to bfloat16 as numpy's cast to ``ml_dtypes``'
        bfloat16 rounds them: to float32, then to the nearest bfloat16 with
        ties to even; NaN becomes the quiet NaN of its sign."""
        with np.errstate(over="ignore"):  # beyond float32's range: inf, as ml_dtypes
            f32 = np.asarray(values, dtype=np.float64).astype(np.float32)
        bits = f32.view(np.uint32)
        nan = np.isnan(f32)
        safe = np.where(nan, np.uint32(0), bits)
        rounded = (safe + np.uint32(0x7FFF) + ((safe >> np.uint32(16)) & np.uint32(1)))
        out = (rounded >> np.uint32(16)).astype(np.uint16)
        quiet = np.where(bits >> np.uint32(31), np.uint16(0xFFC0), np.uint16(0x7FC0))
        return cls(np.where(nan, quiet, out).astype(np.uint16))


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
    """``keep_bfloat16``: bfloat16 arrays as :class:`BFloat16Array`;
    ``views``: binaries as views of ``data``, not copies (an array's raw
    bytes: the array then shares the document's buffer)."""

    def __init__(self, data, keep_bfloat16: bool = False, views: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.keep_bfloat16 = keep_bfloat16
        self.views = views

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

    def binary(self, n: int):
        return self.take(n) if self.views else bytes(self.take(n))

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
        payload = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            return _ndarray(payload, code == _EXT_NPSCALAR, self.keep_bfloat16)
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(payload: memoryview, scalar: bool, keep_bfloat16: bool) -> Any:
    reader = _Reader(payload, views=True)
    shape, dtype_name, buf = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after an array's msgpack document")
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bf16 = BFloat16Array(np.frombuffer(buf, dtype="<u2").reshape(shape), scalar)
        if keep_bfloat16:
            return bf16
        arr = bf16.to_float32()
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
    return arr[()] if scalar else arr


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes, keep_bfloat16: bool = False) -> Any:
    """Decode one msgpack document as ``flax.serialization.msgpack_restore``
    does; bfloat16 arrays as float32, or as :class:`BFloat16Array` with
    ``keep_bfloat16``."""
    reader = _Reader(data, keep_bfloat16)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack document")
    return _unchunk(out)


def load_checkpoint_blob(path: str, keep_bfloat16: bool = False) -> Dict[str, Any]:
    with open(path, "rb") as f:
        blob = msgpack_restore(f.read(), keep_bfloat16)
    version = int(blob.get("format_version", 1)) if isinstance(blob, dict) else 1
    if version > CHECKPOINT_FORMAT_VERSION:
        raise ValueError(
            f"{path} is checkpoint format {version}, newer than this loader "
            f"({CHECKPOINT_FORMAT_VERSION})"
        )
    return blob


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


def _ext_head(code: int, n: int) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixext[n]]) if n in fixext else _header(0, 0, (0xC7, 0xC8, 0xC9), n)
    return head + struct.pack(">b", code)


def _pack_ndarray(code: int, arr: np.ndarray, out: List, dtype_name: str = "") -> None:
    """An ndarray (or numpy scalar) as flax's extension: ``(shape, dtype
    name, raw bytes)`` inside an ext of type ``code``; the raw bytes go in
    as a view, not a copy.  ``dtype_name`` overrides the array's own (a
    bfloat16 array's bits)."""
    if arr.dtype.hasobject or arr.nbytes > 2**30:
        raise ValueError(f"cannot write an array of {arr.dtype} and {arr.nbytes} bytes")
    meta: List = []
    _pack_into([list(arr.shape), dtype_name or arr.dtype.name], meta)
    raw = memoryview(np.ascontiguousarray(arr)).cast("B")
    inner = [b"\x93", *meta[1:], _header(0, 0, (0xC4, 0xC5, 0xC6), raw.nbytes), raw]
    out.append(_ext_head(code, sum(len(c) for c in inner)))
    out.extend(inner)


def _pack_into(v: Any, out: List) -> None:
    """Append the msgpack encoding of ``v`` to ``out`` as chunks (a tree of
    arrays is encoded without copying it level by level)."""
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, np.ndarray):
        _pack_ndarray(_EXT_NDARRAY, v, out)
    elif isinstance(v, np.generic):
        _pack_ndarray(_EXT_NPSCALAR, np.asarray(v), out)
    elif isinstance(v, BFloat16Array):
        code = _EXT_NPSCALAR if v.scalar else _EXT_NDARRAY
        _pack_ndarray(code, v.bits.astype("<u2"), out, BFloat16Array.dtype_name)
    elif isinstance(v, int):
        out.append(_pack_int(v))
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(_header(0xA0, 32, (0xD9, 0xDA, 0xDB), len(raw)) + raw)
    elif isinstance(v, bytes):
        out.append(_header(0, 0, (0xC4, 0xC5, 0xC6), len(v)) + v)
    elif isinstance(v, (list, tuple)):
        out.append(_header(0x90, 16, (0, 0xDC, 0xDD), len(v)))
        for x in v:
            _pack_into(x, out)
    elif isinstance(v, dict):
        items = sorted(v.items())
        out.append(_header(0x80, 16, (0, 0xDE, 0xDF), len(items)))
        for k, x in items:
            _pack_into(k, out)
            _pack_into(x, out)
    else:
        raise TypeError(f"cannot write {type(v).__name__} to msgpack")


def _chunks(tree: Any) -> List:
    out: List = []
    _pack_into(tree, out)
    return out


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a tree of dicts (string keys), lists, strings, bytes, numbers,
    booleans, None, numpy arrays / scalars and :class:`BFloat16Array` as
    ``flax.serialization.msgpack_serialize`` does."""
    return b"".join(_chunks(tree))


def _atomic_write(path: str, tree: Any) -> int:
    """Encode ``tree`` into ``path + ".tmp"`` and move it into place: an
    interrupted write never leaves a torn slot.  Returns the bytes written."""
    tmp = path + ".tmp"
    chunks = _chunks(tree)
    with open(tmp, "wb") as f:
        f.writelines(chunks)
        size = f.tell()
    os.replace(tmp, path)
    return size
