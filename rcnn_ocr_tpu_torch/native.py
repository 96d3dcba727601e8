"""ctypes bindings of the port's host C++: the CTC prefix beam search, the
serving letterbox and the JPEG decoder.

The sources are ``rcnn_ocr_tpu_torch/csrc/host/ctc_beam.cpp`` (the search of
the JAX package's ``native/ctc_beam.cpp``), ``csrc/host/letterbox.cpp`` (its
``native/letterbox.cpp``), kept as the port's own copies, and
``csrc/host/jpeg_decode.cpp`` (the port's own: JAX decodes with cv2).  At
first use each is compiled with ``g++ -O3 -std=c++17 -fPIC -shared -pthread`` into
``build/rcnn_ocr_tpu_torch/`` under a name that carries a hash of the source
and flags, so an edited source is rebuilt, and loaded with ``ctypes``.  A
failed build raises with the compiler's output; nothing falls back to
Python.  Bound: the batched beam entry points
``rcnn_ctc_beam_search_batch[_mt][_v2]``, ``rcnn_letterbox_u8``,
``rcnn_jpeg_header`` and ``rcnn_jpeg_decode_u8``.  A ctypes call releases
the interpreter lock, so threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from rcnn_ocr_tpu_torch.ops.kernels import BUILD_DIR

HOST_DIR = Path(__file__).resolve().parent / "csrc" / "host"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_F, _I64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
_P64, _P32 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
# log_probs, B, T, V, lengths, blank, beam_width, out_labels, max_out, out_lens, out_log_probs
_BATCH_ARGS = [_F, _I64, _I64, _I64, _P64, _I64, _I64, _P32, _I64, _P64, _F]
# library -> {entry point: argtypes}; every entry returns int64 (< 0: error)
ENTRIES = {
    "ctc_beam": {"rcnn_ctc_beam_search_batch": _BATCH_ARGS,
                 "rcnn_ctc_beam_search_batch_mt": _BATCH_ARGS + [_I64],
                 "rcnn_ctc_beam_search_batch_v2": _BATCH_ARGS + [_F],
                 "rcnn_ctc_beam_search_batch_mt_v2": _BATCH_ARGS + [_F, _I64]},
    # srcs, src_h, src_w, n, out, canvas_h, canvas_w, threads
    "letterbox": {"rcnn_letterbox_u8": [ctypes.POINTER(ctypes.c_void_p), _P64, _P64, _I64,
                                        ctypes.POINTER(ctypes.c_uint8), _I64, _I64, _I64]},
    # data, n, out_hw | out, h, w; then msg, msg_len
    "jpeg_decode": {"rcnn_jpeg_header": [ctypes.c_char_p, _I64, _P64, ctypes.c_char_p, _I64],
                    "rcnn_jpeg_decode_u8": [ctypes.c_char_p, _I64, ctypes.POINTER(ctypes.c_uint8),
                                            _I64, _I64, ctypes.c_char_p, _I64]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def source(name: str = "ctc_beam") -> Path:
    return HOST_DIR / f"{name}.cpp"


def library_path(name: str = "ctc_beam") -> Path:
    digest = hashlib.sha1(source(name).read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (g++) found to build the port's host C++")
    return found


def load(name: str = "ctc_beam") -> ctypes.CDLL:
    """The bound library ``name`` (a key of :data:`ENTRIES`), building it
    first when it is missing."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src, path = source(name), library_path(name)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            out = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(src)],
                                 capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                raise RuntimeError(f"building {src} failed (exit {out.returncode}):\n"
                                   f"{out.stdout}{out.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int64
        _libs[name] = lib
        return lib


def ctc_beam_search_batch(log_probs: np.ndarray, blank: int, beam_width: int,
                          lengths: Optional[np.ndarray] = None, threads: int = 0,
                          want_totals: bool = False):
    """Beam-search a batch of CTC log-prob frames ``[B, T, V]`` (float32).

    Returns ``(label lists, log-probs [B])``, plus each row's logsumexp over
    its final beams with ``want_totals``.  Rows run on a thread pool
    (``threads=0``: the hardware concurrency; 1: serial).  Raises when the
    search reports an error (a bad blank id or beam width).
    """
    lib = load("ctc_beam")
    lp = np.ascontiguousarray(log_probs, dtype=np.float32)
    if lp.ndim != 3:
        raise ValueError(f"log_probs must be [B, T, V], got shape {lp.shape}")
    batch, t_steps, vocab = lp.shape
    out_labels = np.zeros((batch, max(t_steps, 1)), dtype=np.int32)
    out_lens = np.zeros((batch,), dtype=np.int64)
    out_lp = np.zeros((batch,), dtype=np.float32)
    out_totals = np.zeros((batch,), dtype=np.float32)
    lens_arr = None
    if lengths is not None:
        lens_arr = np.ascontiguousarray(lengths, dtype=np.int64)
        if lens_arr.shape != (batch,):
            raise ValueError(f"lengths must be [{batch}], got shape {lens_arr.shape}")
    args = (
        lp.ctypes.data_as(_F), batch, t_steps, vocab,
        None if lens_arr is None else lens_arr.ctypes.data_as(_P64),
        int(blank), int(beam_width),
        out_labels.ctypes.data_as(_P32), out_labels.shape[1],
        out_lens.ctypes.data_as(_P64), out_lp.ctypes.data_as(_F),
    )
    totals = (out_totals.ctypes.data_as(_F),) if want_totals else ()
    if threads != 1:
        name = "rcnn_ctc_beam_search_batch_mt_v2" if want_totals else "rcnn_ctc_beam_search_batch_mt"
        res = getattr(lib, name)(*args, *totals, int(threads))
    else:
        name = "rcnn_ctc_beam_search_batch_v2" if want_totals else "rcnn_ctc_beam_search_batch"
        res = getattr(lib, name)(*args, *totals)
    if res < 0:
        raise RuntimeError(f"{name} failed (blank {blank}, beam width {beam_width}, V {vocab})")
    labels = [out_labels[i, : out_lens[i]].tolist() for i in range(batch)]
    if want_totals:
        return labels, out_lp, out_totals
    return labels, out_lp


def letterbox_u8(images: Sequence[np.ndarray], canvas_h: int, canvas_w: int,
                 out: Optional[np.ndarray] = None, threads: int = 0):
    """Paste contiguous HWC uint8 RGB images into a uint8 canvas batch
    ``[N, canvas_h, canvas_w, 3]`` on a thread pool (``threads=0``: the
    hardware concurrency); larger images are cropped.  ``out`` is the buffer
    to fill, else one is allocated.  Returns ``(canvas, sizes [N, 2] int32)``.
    Raises on an image that is not contiguous HWC uint8 with 3 channels (the
    caller makes them so) and on a wrong ``out``."""
    lib = load("letterbox")
    n = len(images)
    shape = (n, int(canvas_h), int(canvas_w), 3)
    if out is None:
        out = np.empty(shape, dtype=np.uint8)
    elif out.shape != shape or out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a contiguous uint8 array of shape {shape}, "
                         f"got {out.dtype} {out.shape}")
    for i, img in enumerate(images):
        if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim == 3
                and img.shape[2] == 3 and img.flags["C_CONTIGUOUS"]):
            raise ValueError(f"image {i} is not a contiguous HWC uint8 RGB array: "
                             f"{getattr(img, 'dtype', type(img))} {getattr(img, 'shape', '')}")
    hs = np.array([img.shape[0] for img in images], dtype=np.int64)
    ws = np.array([img.shape[1] for img in images], dtype=np.int64)
    sizes = np.stack([np.minimum(hs, canvas_h), np.minimum(ws, canvas_w)],
                     axis=1).astype(np.int32).reshape(n, 2)
    if n == 0:
        return out, sizes
    ptrs = (ctypes.c_void_p * n)(*[img.ctypes.data for img in images])
    res = lib.rcnn_letterbox_u8(ptrs, hs.ctypes.data_as(_P64), ws.ctypes.data_as(_P64), n,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                int(canvas_h), int(canvas_w), int(threads))
    if res < 0:
        raise RuntimeError(f"rcnn_letterbox_u8 failed (canvas {canvas_h}x{canvas_w}, {n} images)")
    return out, sizes


def jpeg_decode_u8(data: bytes) -> np.ndarray:
    """A baseline or extended-sequential JPEG stream -> RGB uint8 ``[H, W, 3]``,
    bit-equal to ``cv2.imdecode(data, IMREAD_COLOR)`` then BGR -> RGB (EXIF
    orientation applied).  Raises ``NotImplementedError`` naming a variant it
    does not decode (progressive, arithmetic, lossless, 12-bit, CMYK) and
    ``ValueError`` on damaged or truncated data."""
    lib = load("jpeg_decode")
    data = bytes(data)
    msg = ctypes.create_string_buffer(256)
    hw = np.zeros(2, dtype=np.int64)
    res = lib.rcnn_jpeg_header(data, len(data), hw.ctypes.data_as(_P64), msg, len(msg))
    if res == 0:
        out = np.empty((int(hw[0]), int(hw[1]), 3), dtype=np.uint8)
        res = lib.rcnn_jpeg_decode_u8(data, len(data),
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                      int(hw[0]), int(hw[1]), msg, len(msg))
        if res == 0:
            return out
    text = msg.value.decode("utf-8", "replace")
    if res == -2:
        raise NotImplementedError(text)
    raise ValueError(f"damaged JPEG data: {text}")
