"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface under ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), at first use; the library is
loaded with ``ctypes``.  Nothing here runs when the module is imported,
and nothing falls back: a missing ``nvcc`` or a failed build raises.

Each C entry point takes device pointers, sizes and the CUDA stream,
launches its kernel(s) on that stream and returns ``cudaGetLastError()``.
A :class:`Kernel` wraps one entry point; its ``launches`` counter counts
the launches made through it, so a run can show it went through the
kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("binning", "hash_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: loaded libraries by source name, and the build log of each
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names=SOURCES) -> dict[str, float]:
    """Compile the stale sources, all ``nvcc`` processes at once.

    Returns the seconds each build took (0.0 when the library was
    current).  The ``-Xptxas -v`` report of each build is kept in
    :data:`BUILD_LOGS`.  Raises with the compiler's output on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


class Kernel:
    """One C entry point of a kernel library, with its launch counter."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]   # + the stream
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        """Launch on the current stream; tensors pass as device pointers."""
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                        for a in args), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = library(self.source).kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


#: every kernel of the port by name (registered by the kernel modules)
KERNELS: dict[str, Kernel] = {}


def register(name: str, kernel: Kernel) -> Kernel:
    KERNELS[name] = kernel
    return kernel


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
