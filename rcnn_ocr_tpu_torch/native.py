"""ctypes bindings of the port's host C++: the CTC prefix beam search, the
serving letterbox, the JPEG decoder, TIFF's LZW and CCITT fax decoders,
GIF's LZW decoder, WebP's VP8 and VP8L decoders, the JPEG 2000
codestream decoder, and the synthetic generator's JPEG encoder and
TrueType reader.

The sources are ``rcnn_ocr_tpu_torch/csrc/host/ctc_beam.cpp`` (the search of
the JAX package's ``native/ctc_beam.cpp``), ``csrc/host/letterbox.cpp`` (its
``native/letterbox.cpp``), kept as the port's own copies, and
``csrc/host/jpeg_decode.cpp``, ``csrc/host/tiff_decode.cpp``,
``csrc/host/gif_decode.cpp``, ``csrc/host/webp_decode.cpp``,
``csrc/host/j2k_decode.cpp``, ``csrc/host/jpeg_encode.cpp`` and
``csrc/host/truetype.cpp`` (the port's own: JAX uses cv2 and PIL).  At
first use each is compiled with ``g++ -O3 -std=c++17 -fPIC -shared -pthread
-ffp-contract=off`` (no fused multiply-add, so the JPEG 2000 decoder's float
wavelet rounds as OpenJPEG's) into
``build/rcnn_ocr_tpu_torch/`` under a name that carries a hash of the source,
the files it includes from its own folder (``ht_tables.inc``, HTJ2K's VLC
tables) and the flags, so an edited source is rebuilt, and loaded with
``ctypes``.  A
failed build raises with the compiler's output; nothing falls back to
Python.  Bound: the batched beam entry points
``rcnn_ctc_beam_search_batch[_mt][_v2]``, ``rcnn_letterbox_u8``,
``rcnn_jpeg_header``, ``rcnn_jpeg_decode_u8``, ``rcnn_jpeg_frame``,
``rcnn_jpeg_decode_frame``, ``rcnn_tiff_lzw_decode``, ``rcnn_tiff_sgilog16_decode``,
``rcnn_tiff_fax_decode``,
``rcnn_gif_lzw_decode``, ``rcnn_webp_vp8l_decode``, ``rcnn_webp_vp8_decode``,
``rcnn_j2k_header``, ``rcnn_j2k_decode``, ``rcnn_jpeg_encode_gray`` and the
``rcnn_tt_*`` font entry points (``data/truetype.py`` wraps them).
:func:`build_all` builds every missing library at once, one g++ per source
(``chip_smoke.py``'s build phase, beside nvcc).  A ctypes call releases
the interpreter lock, so threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from rcnn_ocr_tpu_torch.ops.kernels import BUILD_DIR

HOST_DIR = Path(__file__).resolve().parent / "csrc" / "host"
# -ffp-contract=off: no multiply-add is fused, so float code (the JPEG 2000
# 9/7 wavelet) rounds as the reference decoders' does
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-ffp-contract=off"]

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
                                            _I64, _I64, ctypes.c_char_p, _I64],
                    # data, n, info[7] | mode, out, h, w, c; then msg, msg_len
                    "rcnn_jpeg_frame": [ctypes.c_char_p, _I64, _P64, ctypes.c_char_p, _I64],
                    "rcnn_jpeg_decode_frame": [ctypes.c_char_p, _I64, _I64,
                                               ctypes.POINTER(ctypes.c_uint8), _I64, _I64, _I64,
                                               ctypes.c_char_p, _I64]},
    # data, n, out, out_len, old_style, msg, msg_len
    "tiff_decode": {"rcnn_tiff_lzw_decode": [ctypes.c_char_p, _I64, ctypes.POINTER(ctypes.c_uint8),
                                             _I64, _I64, ctypes.c_char_p, _I64],
                    # data, n, out, rows, cols, msg, msg_len
                    "rcnn_tiff_sgilog16_decode": [ctypes.c_char_p, _I64,
                                                  ctypes.POINTER(ctypes.c_int16), _I64, _I64,
                                                  ctypes.c_char_p, _I64],
                    "rcnn_tiff_sgilog32_decode": [ctypes.c_char_p, _I64,
                                                  ctypes.POINTER(ctypes.c_uint32), _I64, _I64,
                                                  ctypes.c_char_p, _I64],
                    # data, n, out, rows, cols, compression, options, msg, msg_len
                    "rcnn_tiff_fax_decode": [ctypes.c_char_p, _I64, ctypes.POINTER(ctypes.c_uint8),
                                             _I64, _I64, _I64, _I64, ctypes.c_char_p, _I64]},
    # data, n, min_code_size, out, out_len, msg, msg_len
    "gif_decode": {"rcnn_gif_lzw_decode": [ctypes.c_char_p, _I64, _I64, ctypes.POINTER(ctypes.c_uint8),
                                           _I64, ctypes.c_char_p, _I64]},
    # data, n, width, height, header, out, msg, msg_len
    "webp_decode": {"rcnn_webp_vp8l_decode": [ctypes.c_char_p, _I64, _I64, _I64, _I64,
                                              ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p, _I64],
                    # data, n, width, height, out, msg, msg_len
                    "rcnn_webp_vp8_decode": [ctypes.c_char_p, _I64, _I64, _I64,
                                             ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, _I64]},
    # image, h, w, quality, out, cap, msg, msg_len
    "jpeg_encode": {"rcnn_jpeg_encode_gray": [ctypes.POINTER(ctypes.c_uint8), _I64, _I64, _I64,
                                              ctypes.POINTER(ctypes.c_uint8), _I64, ctypes.c_char_p,
                                              _I64]},
    # data, n, handle | handle, size, text, n, ...; then msg, msg_len
    "truetype": {"rcnn_tt_open": [ctypes.c_char_p, _I64, _P64, ctypes.c_char_p, _I64],
                 "rcnn_tt_close": [_I64],
                 # handle, size, text, n, ids, advances, offsets, cap
                 "rcnn_tt_shape": [_I64, _I64, ctypes.POINTER(ctypes.c_uint32), _I64, _P32, _P64,
                                   _P64, _I64, ctypes.c_char_p, _I64],
                 # handle, size, text, n, box[6]
                 "rcnn_tt_text_box": [_I64, _I64, ctypes.POINTER(ctypes.c_uint32), _I64, _P64,
                                      ctypes.c_char_p, _I64],
                 # handle, size, text, n, canvas, h, w, x, y, ink
                 "rcnn_tt_draw": [_I64, _I64, ctypes.POINTER(ctypes.c_uint32), _I64,
                                  ctypes.POINTER(ctypes.c_uint8), _I64, _I64, _I64, _I64, _I64,
                                  ctypes.c_char_p, _I64]},
    # data, n, info | out, total; then msg, msg_len
    "j2k_decode": {"rcnn_j2k_header": [ctypes.c_char_p, _I64, _P64, ctypes.c_char_p, _I64],
                   "rcnn_j2k_decode": [ctypes.c_char_p, _I64, _P32, _I64, ctypes.c_char_p, _I64]},
}

# one lock per library, so build_all's compiles run side by side
_locks = {name: threading.Lock() for name in ENTRIES}
_libs: Dict[str, ctypes.CDLL] = {}


def source(name: str = "ctc_beam") -> Path:
    return HOST_DIR / f"{name}.cpp"


def library_path(name: str = "ctc_beam") -> Path:
    text = source(name).read_bytes()
    digest = hashlib.sha1(text + " ".join(CXX_FLAGS).encode())
    for inc in re.findall(rb'^#include "([^"]+)"', text, re.M):  # tables beside the source
        digest.update((HOST_DIR / inc.decode()).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (g++) found to build the port's host C++")
    return found


def _compile(name: str) -> float:
    """Build library ``name`` when it is missing (the caller holds its lock);
    the seconds g++ took, 0.0 when it was found built."""
    src, path = source(name), library_path(name)
    if path.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    out = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"building {src} failed (exit {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    return time.perf_counter() - t0


def _build(name: str) -> float:
    with _locks[name]:
        return _compile(name)


def load(name: str = "ctc_beam") -> ctypes.CDLL:
    """The bound library ``name`` (a key of :data:`ENTRIES`), building it
    first when it is missing."""
    with _locks[name]:
        if name in _libs:
            return _libs[name]
        _compile(name)
        lib = ctypes.CDLL(str(library_path(name)))
        for entry, argtypes in ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int64
        _libs[name] = lib
        return lib


def build_all() -> Dict[str, float]:
    """Build every host library that is missing, one g++ per source, all
    started together, then load each.  Returns each build's seconds (0.0 for
    a library found built); raises with the compiler's output when one
    fails."""
    with ThreadPoolExecutor(len(ENTRIES)) as pool:
        futures = {name: pool.submit(_build, name) for name in ENTRIES}
    failed = [str(f.exception()) for f in futures.values() if f.exception()]
    if failed:
        raise RuntimeError("building the host C++ failed:\n" + "\n".join(failed))
    for name in ENTRIES:
        load(name)
    return {name: f.result() for name, f in futures.items()}


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
    """A JPEG stream (sequential or progressive, Huffman or arithmetic,
    gray, YCbCr, RGB, CMYK or YCCK; lossless RGB or CMYK) -> RGB uint8
    ``[H, W, 3]``, bit-equal to ``cv2.imdecode(data, IMREAD_COLOR)`` then
    BGR -> RGB (EXIF orientation applied).  Raises ``ValueError`` where
    that gives ``None``: damaged or truncated data, and the frames
    libjpeg-turbo refuses under OpenCV (hierarchical, arithmetic-coded
    lossless, 12-bit, a DNL height, lossless gray or YCbCr), naming them."""
    from rcnn_ocr_tpu_torch.data.size_limit import check_size

    lib = load("jpeg_decode")
    data = bytes(data)
    msg = ctypes.create_string_buffer(256)
    hw = np.zeros(2, dtype=np.int64)
    res = lib.rcnn_jpeg_header(data, len(data), hw.ctypes.data_as(_P64), msg, len(msg))
    if res == 0:
        check_size(int(hw[1]), int(hw[0]), "JPEG")
        out = np.empty((int(hw[0]), int(hw[1]), 3), dtype=np.uint8)
        res = lib.rcnn_jpeg_decode_u8(data, len(data),
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                      int(hw[0]), int(hw[1]), msg, len(msg))
        if res == 0:
            return out
    raise ValueError(f"damaged JPEG data: {msg.value.decode('utf-8', 'replace')}")


def jpeg_frame(data: bytes) -> tuple:
    """A JPEG stream's frame as a TIFF strip reads it: ``(height, width,
    components, (h, v) sampling of the first component, the largest (h, v)
    of the others)``.  Raises as :func:`jpeg_decode_u8` does."""
    lib = load("jpeg_decode")
    data = bytes(data)
    msg = ctypes.create_string_buffer(256)
    info = np.zeros(7, dtype=np.int64)
    res = lib.rcnn_jpeg_frame(data, len(data), info.ctypes.data_as(_P64), msg, len(msg))
    if res == 0:
        h, w, c, h0, v0, ho, vo = (int(v) for v in info)
        return h, w, c, (h0, v0), (ho, vo)
    raise ValueError(f"damaged JPEG data: {msg.value.decode('utf-8', 'replace')}")


def jpeg_decode_frame(data: bytes, ycbcr: bool, fancy: bool = True) -> np.ndarray:
    """A JPEG-in-TIFF strip or tile (its tables spliced in) as libtiff has
    libjpeg decode it, at the SOF's size and with no EXIF orientation:
    ``ycbcr`` converts YCbCr to RGB (``[h, w, 3]``) whatever the markers say,
    else the components come as coded (``[h, w, components]``, each
    upsampled).  ``fancy=False`` replicates the chroma instead of libjpeg's
    fancy upsampling (for tests that show a fixture tells them apart).
    Raises as :func:`jpeg_decode_u8` does."""
    lib = load("jpeg_decode")
    data = bytes(data)
    h, w, c, _, _ = jpeg_frame(data)
    c = 3 if ycbcr else c
    out = np.empty((h, w, c), dtype=np.uint8)
    msg = ctypes.create_string_buffer(256)
    res = lib.rcnn_jpeg_decode_frame(data, len(data), (2 if fancy else 3) if ycbcr else 1,
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
                                     msg, len(msg))
    if res == 0:
        return out
    raise ValueError(f"damaged JPEG data: {msg.value.decode('utf-8', 'replace')}")


def jpeg_encode_gray(img: np.ndarray, quality: int) -> bytes:
    """A gray uint8 ``[H, W]`` image as a baseline JPEG, the bytes
    ``cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])`` gives
    (libjpeg-turbo's defaults: JFIF, the quality-scaled standard table, the
    standard Huffman tables, the ISLOW DCT)."""
    lib = load("jpeg_encode")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"jpeg_encode_gray takes a [H, W] image, got shape {img.shape}")
    msg = ctypes.create_string_buffer(256)
    out = np.empty(img.size + 1024, np.uint8)
    for _ in range(2):
        n = lib.rcnn_jpeg_encode_gray(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                      img.shape[0], img.shape[1], int(quality),
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
                                      msg, len(msg))
        if n < 0:
            raise ValueError(msg.value.decode("utf-8", "replace"))
        if n <= out.size:
            return out[:n].tobytes()
        out = np.empty(n, np.uint8)
    raise RuntimeError("rcnn_jpeg_encode_gray changed its length between two calls")


def tiff_lzw_decode(data: bytes, size: int, old_style: bool = False) -> bytes:
    """One LZW-compressed TIFF strip or tile -> its first ``size`` bytes, as
    libtiff decodes it (``old_style``: as its LZWDecodeCompat does).
    Raises ``ValueError`` on damaged data or data short of ``size`` bytes."""
    lib = load("tiff_decode")
    data = bytes(data)
    out = np.empty(int(size), dtype=np.uint8)
    msg = ctypes.create_string_buffer(256)
    res = lib.rcnn_tiff_lzw_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                   out.size, int(old_style), msg, len(msg))
    if res == out.size:
        return out.tobytes()
    raise ValueError(msg.value.decode("utf-8", "replace"))


def tiff_sgilog16_decode(data: bytes, rows: int, cols: int) -> np.ndarray:
    """One SGI LogL strip or tile -> its ``rows`` x ``cols`` 16-bit LogL
    values (int16), as libtiff's LogL16Decode reads them.  Raises
    ``ValueError`` where libtiff fails a row."""
    lib = load("tiff_decode")
    data = bytes(data)
    out = np.empty((int(rows), int(cols)), dtype=np.int16)
    msg = ctypes.create_string_buffer(256)
    res = lib.rcnn_tiff_sgilog16_decode(data, len(data),
                                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                                        int(rows), int(cols), msg, len(msg))
    if res != out.size:
        raise ValueError(f"damaged SGI LogL data: {msg.value.decode('utf-8', 'replace')}")
    return out


def tiff_sgilog32_decode(data: bytes, rows: int, cols: int) -> np.ndarray:
    """One SGI LogLuv32 strip or tile (compression 34676) -> its ``rows`` x
    ``cols`` 32-bit LogLuv values (uint32), as libtiff's LogLuvDecode32
    reads them.  Raises ``ValueError`` where libtiff fails a row."""
    lib = load("tiff_decode")
    data = bytes(data)
    out = np.empty((int(rows), int(cols)), dtype=np.uint32)
    msg = ctypes.create_string_buffer(256)
    res = lib.rcnn_tiff_sgilog32_decode(data, len(data),
                                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                                        int(rows), int(cols), msg, len(msg))
    if res != out.size:
        raise ValueError(f"damaged SGI LogLuv data: {msg.value.decode('utf-8', 'replace')}")
    return out


def tiff_fax_decode(data: bytes, rows: int, cols: int, compression: int, options: int = 0) -> bytes:
    """One CCITT-coded TIFF strip or tile (compression 2, 3, 4 or 32771;
    ``options`` the T4Options of Group 3) -> ``rows`` rows of ``cols``
    1-bit pixels, ``(cols + 7) // 8`` bytes a row, black runs as 1 bits, as
    libtiff's fax decoder gives them.  Raises ``ValueError`` on damaged
    data (where libtiff warns and fills the row)."""
    lib = load("tiff_decode")
    data = bytes(data)
    out = np.empty(int(rows) * ((int(cols) + 7) // 8), dtype=np.uint8)
    msg = ctypes.create_string_buffer(256)
    res = lib.rcnn_tiff_fax_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                   int(rows), int(cols), int(compression), int(options), msg,
                                   len(msg))
    if res == out.size:
        return out.tobytes()
    raise ValueError(msg.value.decode("utf-8", "replace"))


def gif_lzw_decode(data: bytes, min_code_size: int, size: int) -> np.ndarray:
    """One GIF frame's LZW data (its sub-blocks joined) -> ``size`` colour
    indices, as OpenCV's GIF reader decodes them.  Raises ``ValueError``
    where OpenCV fails the frame."""
    lib = load("gif_decode")
    data = bytes(data)
    out = np.empty(int(size), dtype=np.uint8)
    msg = ctypes.create_string_buffer(256)
    res = lib.rcnn_gif_lzw_decode(data, len(data), int(min_code_size),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size, msg,
                                  len(msg))
    if res < 0:
        raise ValueError(f"damaged GIF data: {msg.value.decode('utf-8', 'replace')}")
    return out


def webp_decode_vp8l(data: bytes, width: int, height: int, header: bool = True) -> np.ndarray:
    """A VP8L stream (``header``: with its 5-byte header, else an ALPH
    chunk's headerless one) of a ``width`` x ``height`` image -> its ARGB
    words ``[height, width]`` uint32, as libwebp decodes them.  Raises
    ``ValueError`` where libwebp fails."""
    lib = load("webp_decode")
    data = bytes(data)
    out = np.empty((int(height), int(width)), dtype=np.uint32)
    msg = ctypes.create_string_buffer(256)
    res = lib.rcnn_webp_vp8l_decode(data, len(data), int(width), int(height), int(bool(header)),
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), msg,
                                    len(msg))
    if res < 0:
        raise ValueError(f"damaged WebP data: {msg.value.decode('utf-8', 'replace')}")
    return out


def webp_decode_vp8(data: bytes, width: int, height: int) -> np.ndarray:
    """A VP8 key frame (a ``VP8 `` chunk's payload) of a ``width`` x
    ``height`` image -> RGB uint8 ``[height, width, 3]``, as libwebp decodes
    it to BGR (fancy upsampling).  Raises ``ValueError`` where libwebp
    fails."""
    lib = load("webp_decode")
    data = bytes(data)
    out = np.empty((int(height), int(width), 3), dtype=np.uint8)
    msg = ctypes.create_string_buffer(256)
    res = lib.rcnn_webp_vp8_decode(data, len(data), int(width), int(height),
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), msg, len(msg))
    if res < 0:
        raise ValueError(f"damaged WebP data: {msg.value.decode('utf-8', 'replace')}")
    return out


def j2k_header(data: bytes) -> tuple:
    """A JPEG 2000 codestream's main header -> ``((x0, y0, x1, y1), comps)``,
    each component ``(dx, dy, width, height, x0, y0, precision, signed)``.
    Raises ``ValueError`` where OpenJPEG fails the header."""
    lib = load("j2k_decode")
    data = bytes(data)
    info = np.zeros(5 + 8 * 16384, dtype=np.int64)  # SIZ holds at most 16384 components
    msg = ctypes.create_string_buffer(256)
    res = lib.rcnn_j2k_header(data, len(data), info.ctypes.data_as(_P64), msg, len(msg))
    _j2k_raise(res, msg)
    comps = [tuple(int(v) for v in info[5 + 8 * c : 13 + 8 * c]) for c in range(int(info[4]))]
    return tuple(int(v) for v in info[:4]), comps


def j2k_decode(data: bytes, comps) -> list:
    """Decode a JPEG 2000 codestream into one int32 ``[height, width]`` plane
    a component (``comps`` as :func:`j2k_header` gives them), the samples
    OpenJPEG gives: DC-shifted and clamped to each component's range."""
    lib = load("j2k_decode")
    data = bytes(data)
    sizes = [int(c[2]) * int(c[3]) for c in comps]
    out = np.empty(sum(sizes), dtype=np.int32)
    msg = ctypes.create_string_buffer(256)
    res = lib.rcnn_j2k_decode(data, len(data), out.ctypes.data_as(_P32), out.size, msg, len(msg))
    _j2k_raise(res, msg)
    planes, pos = [], 0
    for c, size in zip(comps, sizes):
        planes.append(out[pos : pos + size].reshape(int(c[3]), int(c[2])))
        pos += size
    return planes


def _j2k_raise(res: int, msg) -> None:
    if res < 0:
        raise ValueError(msg.value.decode("utf-8", "replace"))
