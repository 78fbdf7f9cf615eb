"""Build and load the CUDA kernels (csrc/*.cu) at first use.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled
with ``nvcc`` for Hopper (sm_90a) into ``_build/lib<name>.so``, then
loaded with ctypes — the pattern hypo_tpu.native.host_api uses for its
g++ libraries.  A library is rebuilt when its source is newer.  A
failed build raises with the compiler's output: there is no fallback.
Different libraries may be built from several threads at once.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()                      # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}    # one build at a time each
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, ptxas/compiler output) of builds made by this process
build_log: Dict[str, tuple] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of hypo_tpu_torch cannot be built")


def _compile(name: str, src: str, lib: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, src, "-o", tmp]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, lib)
    build_log[name] = (time.time() - t0, r.stdout + r.stderr)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing or
    older than its source."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(SRC_DIR, f"{name}.cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            _compile(name, src, so)
        lib = ctypes.CDLL(so)
        lib.hypo_cuda_error_string.restype = ctypes.c_char_p
        lib.hypo_cuda_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code (its launch's
    cudaGetLastError())."""
    if rc != 0:
        msg = lib.hypo_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def expect(what: str, device, **tensors) -> None:
    """Validate the arguments of a kernel wrapper: each value is
    (tensor, dtype, shape); every tensor must lie on ``device`` and be
    contiguous.  Raises ValueError naming the first offending argument."""
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}, "
                             f"expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
