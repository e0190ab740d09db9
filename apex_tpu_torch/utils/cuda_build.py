"""Build the CUDA sources under ``apex_tpu_torch/csrc`` with ``nvcc`` and
bind them through ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"``; no
PyTorch headers, so one source compiles in seconds) and is built at
first use into ``csrc/build/lib<name>-<digest>.so``, where the digest
covers the source and the flags: an edited source never loads a stale
library. Nothing is compiled when a module is imported.

A :class:`Kernel` is one C entry point. Calling it launches the kernel
on the current stream, raises if the launch returned a CUDA error, and
only then adds one to its ``launches`` count — the count a run reads to
show that its main path went through the kernel.
"""

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Iterable, List, Optional, Sequence

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (CUDA_HOME unset and no nvcc on "
            "PATH); the port's kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaLibrary:
    """One ``csrc/<name>.cu`` built into a shared library and loaded
    with ``ctypes``. Each source also exports
    ``const char* apx_error_string(int)`` for error messages."""

    def __init__(self, name: str):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu")
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def path(self) -> str:
        h = hashlib.sha256()
        with open(self.source, "rb") as f:
            h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def _start(self) -> Optional[subprocess.Popen]:
        """Start nvcc unless the library is built already."""
        out = self.path
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        proc.apx_tmp = tmp
        proc.apx_t0 = time.perf_counter()
        return proc

    def _finish(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:  # built already, by this process or earlier
            if self.build_seconds is None:
                self.build_seconds = 0.0
            return
        self.build_log, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - proc.apx_t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source} (exit {proc.returncode}):"
                f"\n{self.build_log}")
        os.replace(proc.apx_tmp, self.path)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self._finish(self._start())
            lib = ctypes.CDLL(self.path)
            lib.apx_error_string.argtypes = [ctypes.c_int]
            lib.apx_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


def build_all(libs: Iterable[CudaLibrary]) -> None:
    """Build every library at once, one nvcc process each, then load
    them. Waits for every process it started, on error too."""
    libs = list(libs)
    started: List = []
    errors: List[RuntimeError] = []
    try:
        for lib in libs:
            started.append((lib, lib._start()))
    finally:
        for lib, proc in started:
            try:
                lib._finish(proc)
            except RuntimeError as e:
                errors.append(e)
    if errors:
        raise errors[0]
    for lib in libs:
        lib.load()


class Kernel:
    """One C entry point of a :class:`CudaLibrary`; the C function
    launches on the stream it is given and returns
    ``cudaGetLastError()``. ``launches`` counts successful launches."""

    def __init__(self, lib: CudaLibrary, symbol: str,
                 argtypes: Sequence):
        self.lib = lib
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(self.lib.load(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = self.lib.load().apx_error_string(err).decode()
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} at launch: {msg}")
        self.launches += 1
