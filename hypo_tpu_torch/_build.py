"""Build and load the port's native code at first use, into the
git-ignored ``_build/`` directory.

Each CUDA kernel ``csrc/<name>.cu`` exports a plain C interface and is
compiled with ``nvcc`` for Hopper (sm_90a) into ``_build/lib<name>.so``,
then loaded with ctypes.  A library is rebuilt when its source, or a
header of ``csrc/``, is newer.  A failed nvcc build raises with the compiler's output: there is
no fallback.  Different libraries may be built from several threads at
once.

``build_host`` compiles the host libraries of ``native/`` with g++ the
same way; a process holds a file lock while it builds, so processes
started together build each library once.  A failed g++ build returns
False, and the caller takes its NumPy path (``native.*.available()``).

``count_launch`` is how a kernel wrapper counts the launches of its
kernel: launches made while the thread captures a CUDA graph are not
counted then, but gathered by ``recording`` for the graph's replays to
add (poa.device_full).
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()                      # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}    # one build at a time each
_libs: Dict[str, ctypes.CDLL] = {}
_capture = threading.local()                  # .launches: see recording()
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


def load(name: str, src: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (or of ``src``, under
    ``name``), built first if missing or older than its source."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = src or os.path.join(SRC_DIR, f"{name}.cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        headers = [os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                   if f.endswith(".h")]
        if (not os.path.exists(so) or os.path.getmtime(so)
                < max(map(os.path.getmtime, [src, *headers]))):
            _compile(name, src, so)
        lib = ctypes.CDLL(so)
        lib.hypo_cuda_error_string.restype = ctypes.c_char_p
        lib.hypo_cuda_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
        return lib


def build_host(src: str, lib_name: str, flags: List[str],
               libs: List[str]) -> Optional[str]:
    """``g++ flags src -o _build/lib_name libs`` unless that library is
    newer than ``src``; returns its path, or None when g++ fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, lib_name)
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (os.path.exists(lib)
                and os.path.getmtime(lib) >= os.path.getmtime(src)):
            return lib
        tmp = f"{lib}.{os.getpid()}.tmp"
        t0 = time.time()
        try:
            subprocess.run(["g++", *flags, src, "-o", tmp, *libs],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, lib)
        except Exception:
            return None
        build_log[lib_name] = (time.time() - t0, "")
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


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: ``wrapper.launches`` counts
    it, unless the current CUDA stream is capturing a graph.  A launch
    under capture runs only when the graph is replayed; it is added to
    the dict of the thread's ``recording()``, if one is open, for the
    replays to count."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1
        return
    rec = getattr(_capture, "launches", None)
    if rec is not None:
        rec[wrapper] = rec.get(wrapper, 0) + 1


@contextlib.contextmanager
def recording():
    """Yields a dict {wrapper: launches} that gathers this thread's
    kernel launches made under stream capture (``count_launch``) until
    the block ends: the launches one replay of the captured graph
    makes."""
    _capture.launches = rec = {}
    try:
        yield rec
    finally:
        _capture.launches = None
