"""Build and bind the hand-written CUDA kernels of the port.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point and a
plan function that says which launch the entry point picks for a shape.  At
first use every source is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together) into a shared library under
``build/rcnn_ocr_tpu_torch/`` at the repository root and loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds.  The
library's file name carries a hash of its source, so an edited source is
rebuilt and an unchanged one is reused.

Every wrapper launches through :meth:`CudaKernel.launch` on its tensor's
own card and that card's current stream, whatever card the calling thread
has current (a serving replica's thread works on one card of several), and
counts its launches on its :class:`CudaKernel` (``launches``), adding one
exactly where it launches.  :func:`plain_only` forces the
wrappers onto their plain PyTorch versions; it exists so that one run on a
card can compare a kernel with its plain version, and the main path never
enters it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rcnn_ocr_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_build_lock = threading.Lock()
_plain_forced = threading.local()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class CudaKernel:
    """One ``csrc/<name>.cu`` source, its built library and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: List[type], plan_symbol: str,
                 plan_argtypes: List[type]):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.plan_symbol = plan_symbol
        self.plan_argtypes = plan_argtypes
        self.launches = 0
        self._count_lock = threading.Lock()  # the serving daemon launches from two threads
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._fn = None
        self._plan_fn = None

    @property
    def source(self) -> Path:
        return CSRC_DIR / f"{self.name}.cu"

    @property
    def library(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{digest.hexdigest()[:12]}.so"

    def fn(self):
        """The bound C entry point, building every kernel on first use."""
        if self._fn is None:
            build_all()
        return self._fn

    def plan(self, device: torch.device, *args: int) -> List[int]:
        """The launch plan the C entry point picks for a shape on ``device``
        (the source's ``*_plan`` function fills four ints; the source says
        what each is).  Asked with ``device`` current: a plan is per card."""
        if self._plan_fn is None:
            build_all()
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            self.check(self._plan_fn(*args, out))
        return list(out)

    def launch(self, device: torch.device, *args) -> None:
        """Call the C entry point with ``args`` and the current stream of
        ``device``, with ``device`` current for the call, whatever card the
        calling thread has current; count the launch."""
        fn = self.fn()
        with torch.cuda.device(device):
            self.check(fn(*args, stream_ptr(device)))
        self.count_launch()

    def _bind(self) -> None:
        lib = ctypes.CDLL(str(self.library))
        for attr, symbol, argtypes in (("_fn", self.symbol, self.argtypes),
                                       ("_plan_fn", self.plan_symbol, self.plan_argtypes)):
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, attr, fn)

    def count_launch(self) -> None:
        with self._count_lock:
            self.launches += 1

    def check(self, err: int) -> None:
        """Raise on a non-zero ``cudaError_t`` returned by the library."""
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA call failed with cudaError_t {err}")


_P, _I = ctypes.c_void_p, ctypes.c_int
SE_SCALE = CudaKernel("se_scale", "se_scale_forward", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                      "se_scale_plan", [_I, _I, _I, _I, _I, _P])
BILSTM_SCAN = CudaKernel("bilstm_scan", "bilstm_scan_forward", [_P, _P, _P, _I, _I, _I, _I, _P],
                         "bilstm_scan_plan", [_I, _I, _I, _P])
KERNELS: Dict[str, CudaKernel] = {k.name: k for k in (SE_SCALE, BILSTM_SCAN)}


def build_all(force: bool = False) -> Dict[str, CudaKernel]:
    """Compile every kernel whose library is missing (in parallel) and bind it.

    Raises ``RuntimeError`` with the compiler's output when a build fails.
    """
    import time

    with _build_lock:
        pending = [k for k in KERNELS.values() if force or not k.library.exists()]
        if pending:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for k in pending:
                tmp = k.library.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
                procs.append((k, tmp, time.perf_counter(), subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )))
            failed = []
            for k, tmp, t0, proc in procs:
                out, _ = proc.communicate()
                k.build_seconds = time.perf_counter() - t0
                k.build_log = out
                if proc.returncode != 0:
                    failed.append(f"--- {k.source} (exit {proc.returncode})\n{out}")
                else:
                    os.replace(tmp, k.library)
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for k in KERNELS.values():
            if k._fn is None:
                k._bind()
    return KERNELS


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


@contextlib.contextmanager
def plain_only() -> Iterator[None]:
    """Run every wrapper's plain PyTorch version, on any device (tests and
    ``chip_smoke.py`` only: it lets one run compare kernel and plain)."""
    prev = getattr(_plain_forced, "on", False)
    _plain_forced.on = True
    try:
        yield
    finally:
        _plain_forced.on = prev


def plain_forced() -> bool:
    """True inside :func:`plain_only` on this thread (a serving replica's
    thread takes its caller's setting)."""
    return getattr(_plain_forced, "on", False)


def use_kernel(t: torch.Tensor) -> bool:
    """True when a wrapper must launch its kernel for ``t``.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel
    unless :func:`plain_only` is active; any other device raises.
    """
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    return not plain_forced()


def stream_ptr(device: torch.device) -> int:
    """The handle of ``device``'s current stream on this thread (not of the
    thread's current device's)."""
    return torch.cuda.current_stream(device).cuda_stream
