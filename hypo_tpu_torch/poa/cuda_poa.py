"""Kernel 1: the graph-vs-arm DP (csrc/poa_dp.cu), replacing the Pallas
kernel of hypo_tpu/poa/pallas_poa.py.

``poa_dp_batch`` takes the plain version (poa.dp.poa_dp_batch_ref) only
for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``poa_dp_batch.launches`` counts kernel launches that ran: one
captured in a CUDA graph counts at each replay (_build.count_launch).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import NEG16
from .dp import poa_dp_batch_ref

_P_MAX = 8          # predecessor slots the kernel keeps in registers
_MAX_COLS = 2048    # columns L + 1: 1024 threads of 2 columns
_CELL_RANGE = 32767  # |cell| bound that keeps int16 cells clear of wrap
_SMEM_BYTES = 227 * 1024
RING = 16           # rows the kernel keeps in shared memory (kRing)


def _load():
    lib = _build.load("poa_dp")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hypo_poa_dp.restype = ci
        lib.hypo_poa_dp.argtypes = [vp] * 11 + [ci] * 9 + [vp]
        lib._typed = True
    return lib


def columns_per_thread(L: int) -> int:
    """Columns a thread owns: 4 (one warp up to 128 columns), 2 beyond
    512 columns, so that 1024 threads cover 2048 columns."""
    return 2 if L + 1 > 512 else 4


def launch_threads(L: int) -> int:
    """Threads of a CTA: whole warps covering the L + 1 columns."""
    per = columns_per_thread(L)
    return -(-(L + 1) // (32 * per)) * 32


def smem_bytes(Wp: int, N: int, P: int) -> int:
    """Shared memory of a launch (csrc/poa_dp.cu:smem_bytes): the ring,
    warp totals, far-row bits, column arm_len's cells and the window's
    staged rows."""
    return RING * Wp * 2 + 256 + 4 * (N // 32 + 1) + N * (8 + 2 * P + 2)


def check_scores(m: int, n: int, g: int, N: int, L: int) -> None:
    """Raises ValueError unless int16 cells hold every DP cell at (N, L):
    while each row has a predecessor (the DP's contract) every cell is a
    path's score, within max(|m|, |n|, |g|) * (N + L) of 0; a sentinel
    candidate only ever raises a cell."""
    if max(abs(m), abs(n), abs(g)) * (N + L) > _CELL_RANGE:
        raise ValueError(f"poa_dp_batch: int16 cells need max(|m|, |n|, "
                         f"|g|) * (N + L) <= {_CELL_RANGE} (m={m}, n={n}, "
                         f"g={g}, N={N}, L={L})")


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
    check_scores(m, n, g, N, L)
    per = columns_per_thread(L)
    Wp = launch_threads(L) * per
    if smem_bytes(Wp, N, P) > _SMEM_BYTES:
        raise ValueError(f"poa_dp_batch: N={N}, L={L}, P={P} needs "
                         f"{smem_bytes(Wp, N, P)} B of shared memory a CTA")
    lib = _load()
    bp = torch.empty((B, N + 1, L + 1), dtype=torch.int8, device=dev)
    max_row = torch.empty((B,), dtype=i32, device=dev)
    # int16 copy of the rows read from beyond the ring
    Hg = torch.empty((B, N + 1, Wp), dtype=torch.int16, device=dev)
    # can a sentinel candidate (NEG16 + m, n or g) win or tie against a
    # real one (>= -max(|m|, |n|, |g|) * (N + L) when every row has a
    # predecessor)?  The kernel adds rows without one itself.
    sent = int(max(abs(m), abs(n), abs(g)) * (N + L) + max(m, n, g)
               >= -NEG16)
    p = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hypo_poa_dp(
            p(node_code), p(pred_rows), p(pred_cnt), p(is_end), p(n_nodes),
            p(arm), p(arm_len), p(mode), p(bp), p(max_row), p(Hg),
            B, N, L, P, m, n, g, per, sent, ctypes.c_void_p(stream))
    _build.check(lib, rc, "poa_dp_batch launch")
    _build.count_launch(poa_dp_batch)
    return bp, max_row


poa_dp_batch.launches = 0
