"""Kernel 3: the backpointer traceback (csrc/poa_tb.cu), one walk with
two emitters.  ``poa_tb_batch`` (exact mode's emitter) replaces the XLA
while_loop of hypo_tpu/poa/jax_poa.py:poa_dp_tb_batch (:85-116);
``poa_tb_matched`` (the tile program's walk) replaces
hypo_tpu/poa/device_full.py:_traceback_matched_batch (:247-307).
``poa_dp_tb_batch`` is exact mode's device call: kernel 1 (the DP,
poa.cuda_poa) then kernel 3.

Each wrapper takes its plain version (poa.dp.poa_tb_batch_ref,
poa.dp.poa_tb_matched_ref) only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.  Each counts its kernel launches in
its ``launches`` attribute (one captured in a CUDA graph at each
replay: _build.count_launch).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .cuda_poa import poa_dp_batch
from .dp import poa_tb_batch_ref, poa_tb_matched_ref

# bound on one launch's DP scratch (H int32 + bp int8, 5 bytes a cell);
# a larger batch is cut into launches of at most this much
MAX_CHUNK_BYTES = 1 << 31


def _load():
    lib = _build.load("poa_tb")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hypo_poa_tb.restype = ci
        lib.hypo_poa_tb.argtypes = [vp] * 8 + [ci] * 4 + [vp]
        lib.hypo_poa_tb_matched.restype = ci
        lib.hypo_poa_tb_matched.argtypes = [vp] * 7 + [ci] * 4 + [vp]
        lib._typed = True
    return lib


def poa_tb_batch(bp, pred_rows, max_row, arm_len, mode, *, N: int, L: int,
                 P: int):
    """Returns (ti int16 [B,S], tj int16 [B,S], steps int32 [B]),
    S = N + L + 1; the contract of poa.dp.poa_tb_batch_ref."""
    B = bp.shape[0]
    dev = bp.device
    i32 = torch.int32
    _build.expect(
        "poa_tb_batch", dev,
        bp=(bp, torch.int8, (B, N + 1, L + 1)),
        pred_rows=(pred_rows, i32, (B, N, P)),
        max_row=(max_row, i32, (B,)),
        arm_len=(arm_len, i32, (B,)),
        mode=(mode, i32, (B,)))
    if dev.type == "cpu":
        return poa_tb_batch_ref(bp, pred_rows, max_row, arm_len, mode, N=N,
                                L=L, P=P)
    if dev.type != "cuda":
        raise ValueError(f"poa_tb_batch: no kernel for device {dev}")
    lib = _load()
    S = N + L + 1
    ti = torch.empty((B, S), dtype=torch.int16, device=dev)
    tj = torch.empty((B, S), dtype=torch.int16, device=dev)
    steps = torch.empty((B,), dtype=i32, device=dev)
    p = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hypo_poa_tb(p(bp), p(pred_rows), p(max_row), p(arm_len),
                             p(mode), p(ti), p(tj), p(steps), B, N, L, P,
                             ctypes.c_void_p(stream))
    _build.check(lib, rc, "poa_tb_batch launch")
    _build.count_launch(poa_tb_batch)
    return ti, tj, steps


poa_tb_batch.launches = 0


def poa_tb_matched(bp, pred_rows, arm_len, mode, max_row, active, *, N: int,
                   L: int, P: int):
    """Returns matched int32 [B, L]: the rank of the graph node arm base
    j aligned to, or -1; the contract of poa.dp.poa_tb_matched_ref."""
    B = bp.shape[0]
    dev = bp.device
    i32 = torch.int32
    _build.expect(
        "poa_tb_matched", dev,
        bp=(bp, torch.int8, (B, N + 1, L + 1)),
        pred_rows=(pred_rows, i32, (B, N, P)),
        arm_len=(arm_len, i32, (B,)),
        mode=(mode, i32, (B,)),
        max_row=(max_row, i32, (B,)),
        active=(active, torch.bool, (B,)))
    if dev.type == "cpu":
        return poa_tb_matched_ref(bp, pred_rows, arm_len, mode, max_row,
                                  active, N=N, L=L, P=P)
    if dev.type != "cuda":
        raise ValueError(f"poa_tb_matched: no kernel for device {dev}")
    lib = _load()
    matched = torch.empty((B, L), dtype=i32, device=dev)
    p = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hypo_poa_tb_matched(p(bp), p(pred_rows), p(arm_len),
                                     p(mode), p(max_row), p(active),
                                     p(matched), B, N, L, P,
                                     ctypes.c_void_p(stream))
    _build.check(lib, rc, "poa_tb_matched launch")
    _build.count_launch(poa_tb_matched)
    return matched


poa_tb_matched.launches = 0


def poa_dp_tb_batch(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm,
                    arm_len, mode, *, N: int, L: int, P: int, m: int, n: int,
                    g: int):
    """DP (kernel 1) then traceback (kernel 3) for a batch of windows, the
    counterpart of jax_poa.poa_dp_tb_batch: returns (ti, tj, steps,
    max_row).  Windows are independent, so a batch whose DP scratch
    exceeds MAX_CHUNK_BYTES runs as several launches of each kernel with
    the same results."""
    B = node_code.shape[0]
    chunk = max(1, MAX_CHUNK_BYTES // (5 * (N + 1) * (L + 1)))
    if B <= chunk:
        return _dp_tb(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm,
                      arm_len, mode, N=N, L=L, P=P, m=m, n=n, g=g)
    parts = [_dp_tb(*(x[lo:lo + chunk] for x in (
        node_code, pred_rows, pred_cnt, is_end, n_nodes, arm, arm_len,
        mode)), N=N, L=L, P=P, m=m, n=n, g=g)
        for lo in range(0, B, chunk)]
    return tuple(torch.cat(out) for out in zip(*parts))


def _dp_tb(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm, arm_len,
           mode, *, N, L, P, m, n, g):
    bp, max_row = poa_dp_batch(node_code, pred_rows, pred_cnt, is_end,
                               n_nodes, arm, arm_len, mode, N=N, L=L, P=P,
                               m=m, n=n, g=g)
    ti, tj, steps = poa_tb_batch(bp, pred_rows, max_row, arm_len, mode, N=N,
                                 L=L, P=P)
    return ti, tj, steps, max_row
