"""Kernel 1: the graph-vs-arm DP (csrc/poa_dp.cu), replacing the Pallas
kernel of hypo_tpu/poa/pallas_poa.py.

``poa_dp_batch`` takes the plain version (poa.dp.poa_dp_batch_ref) only
for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``poa_dp_batch.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .dp import poa_dp_batch_ref

_P_MAX = 8          # predecessor slots the kernel keeps in registers
_MAX_COLS = 2048    # columns L + 1: up to 2 per thread, 1024 threads


def _load():
    lib = _build.load("poa_dp")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hypo_poa_dp.restype = ci
        lib.hypo_poa_dp.argtypes = [vp] * 11 + [ci] * 7 + [vp]
        lib._typed = True
    return lib


def poa_dp_batch(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm,
                 arm_len, mode, *, N: int, L: int, P: int, m: int, n: int,
                 g: int):
    """Returns (bp int8 [B,N+1,L+1], max_row int32 [B]); the contract of
    poa.dp.poa_dp_batch_ref, except that bp rows above a window's
    n_nodes are unspecified on CUDA."""
    B = node_code.shape[0]
    dev = node_code.device
    i32 = torch.int32
    _build.expect(
        "poa_dp_batch", dev,
        node_code=(node_code, i32, (B, N)),
        pred_rows=(pred_rows, i32, (B, N, P)),
        pred_cnt=(pred_cnt, i32, (B, N)),
        is_end=(is_end, torch.bool, (B, N)),
        n_nodes=(n_nodes, i32, (B,)),
        arm=(arm, i32, (B, L)),
        arm_len=(arm_len, i32, (B,)),
        mode=(mode, i32, (B,)))
    if dev.type == "cpu":
        return poa_dp_batch_ref(node_code, pred_rows, pred_cnt, is_end,
                                n_nodes, arm, arm_len, mode, N=N, L=L,
                                P=P, m=m, n=n, g=g)
    if dev.type != "cuda":
        raise ValueError(f"poa_dp_batch: no kernel for device {dev}")
    if not 1 <= P <= _P_MAX or L + 1 > _MAX_COLS:
        raise ValueError(f"poa_dp_batch: kernel needs 1 <= P <= {_P_MAX} "
                         f"and L < {_MAX_COLS} (P={P}, L={L})")
    lib = _load()
    bp = torch.empty((B, N + 1, L + 1), dtype=torch.int8, device=dev)
    max_row = torch.empty((B,), dtype=i32, device=dev)
    H = torch.empty((B, N + 1, L + 1), dtype=i32, device=dev)
    p = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hypo_poa_dp(
            p(node_code), p(pred_rows), p(pred_cnt), p(is_end), p(n_nodes),
            p(arm), p(arm_len), p(mode), p(bp), p(max_row), p(H),
            B, N, L, P, m, n, g, ctypes.c_void_p(stream))
    _build.check(lib, rc, "poa_dp_batch launch")
    poa_dp_batch.launches += 1
    return bp, max_row


poa_dp_batch.launches = 0
