"""ctypes binding of the port's host CTC prefix beam search.

The C++ source is ``rcnn_ocr_tpu_torch/csrc/host/ctc_beam.cpp`` (the search
of the JAX package's ``native/ctc_beam.cpp``, kept as the port's own copy).
At first use it is compiled with ``g++ -O3 -std=c++17 -fPIC -shared
-pthread`` into ``build/rcnn_ocr_tpu_torch/`` under a name that carries a
hash of the source and flags, so an edited source is rebuilt, and loaded
with ``ctypes``.  A failed build raises with the compiler's output; nothing
falls back to Python.  Only the batched beam entry points are bound:
``rcnn_ctc_beam_search_batch[_mt][_v2]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from rcnn_ocr_tpu_torch.ops.kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / "ctc_beam.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_F, _I64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
_P64, _P32 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
# log_probs, B, T, V, lengths, blank, beam_width, out_labels, max_out, out_lens, out_log_probs
_BATCH_ARGS = [_F, _I64, _I64, _I64, _P64, _I64, _I64, _P32, _I64, _P64, _F]


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libctc_beam_{digest.hexdigest()[:12]}.so"


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler (g++) found to build the host CTC beam search")
    return found


def load() -> ctypes.CDLL:
    """The bound library, building it first when it is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            out = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                 capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                raise RuntimeError(f"building {SOURCE} failed (exit {out.returncode}):\n"
                                   f"{out.stdout}{out.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for name, extra in (("rcnn_ctc_beam_search_batch", []),
                            ("rcnn_ctc_beam_search_batch_mt", [_I64]),
                            ("rcnn_ctc_beam_search_batch_v2", [_F]),
                            ("rcnn_ctc_beam_search_batch_mt_v2", [_F, _I64])):
            fn = getattr(lib, name)
            fn.argtypes = _BATCH_ARGS + extra
            fn.restype = ctypes.c_int64
        _lib = lib
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
    lib = load()
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
