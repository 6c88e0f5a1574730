"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries land in
``paddle_tpu_torch/_build/`` (gitignored) under a name that carries a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.

Nothing builds at import: the first CUDA call of a kernel wrapper builds
its library (``load``), and ``build_all`` builds every source at once, one
``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "sources", "load",
           "build_all"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs = {}
_lock = threading.Lock()


def sources():
    """Kernel names (source stems) under csrc/."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of paddle_tpu_torch are built "
            "from source on first use and need the CUDA toolkit")
    return path


def _lib_path(name):
    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name):
    """Start nvcc for one source; returns (proc, tmp, out) or None when
    the library is already built."""
    src, out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name, started):
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=None):
    """Compile every kernel source in parallel (one nvcc each). Returns
    {name: (seconds, ptxas log)} for the ones that were built."""
    names = sources() if names is None else list(names)
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in names}
        logs = {n: _finish(n, s) for n, s in started.items()
                if s is not None}
    wall = time.perf_counter() - t0
    return {n: (wall, log) for n, log in logs.items()}


def load(name, argtypes, symbol=None):
    """The C entry point ``symbol`` (default: ``name``) of kernel library
    ``name``, built and loaded on first use and typed once: it takes
    ``argtypes`` and returns ``cudaGetLastError()`` as an int."""
    key = (name, symbol or name)
    fn = _libs.get(key)
    if fn is not None:
        return fn
    build_all([name])
    with _lock:
        fn = _libs.get(key)
        if fn is None:
            fn = getattr(ctypes.CDLL(_lib_path(name)[1]), key[1])
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            _libs[key] = fn
    return fn
