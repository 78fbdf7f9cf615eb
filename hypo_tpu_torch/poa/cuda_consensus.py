"""Kernel 2: heaviest-bundle consensus (csrc/consensus.cu), replacing
the Pallas kernel of hypo_tpu/poa/pallas_consensus.py: one warp per
window, the window's tables in shared memory (the source's header says
why).

``heaviest_bundle`` takes the plain version
(poa.device_full._consensus_wavefront) only for tensors on the CPU; for
CUDA tensors it launches the kernel, or raises (also for a shape the
kernel does not hold).  ``heaviest_bundle.launches`` counts kernel
launches (one captured in a CUDA graph at each replay:
_build.count_launch).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_P_MAX = 8            # slots in the kernel's flag byte
_N_MAX = 32767        # ranks held as int16
_SMEM_BYTES = 227 * 1024


def _load():
    lib = _build.load("consensus")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hypo_heaviest_bundle.restype = ci
        lib.hypo_heaviest_bundle.argtypes = [vp] * 11 + [ci] * 3 + [vp]
        lib.hypo_heaviest_bundle_occupancy.restype = ci
        lib.hypo_heaviest_bundle_occupancy.argtypes = [ci, ci]
        lib._typed = True
    return lib


def _align16(v: int) -> int:
    return (v + 15) & ~15


def smem_bytes(N: int, P: int) -> int:
    """Shared memory of one window (csrc/consensus.cu: window_bytes; a
    block holds one or two): ranks int16 and weights int32 [N, P],
    scores int32, chosen predecessors int16 and flag bytes [N]."""
    return (_align16(2 * N * P) + _align16(4 * N * P) + _align16(4 * N)
            + _align16(2 * N) + _align16(N))


def check_shape(N: int, P: int) -> None:
    """Raises ValueError unless the kernel holds a window of (N, P)."""
    if not (1 <= P <= _P_MAX and 1 <= N <= _N_MAX
            and smem_bytes(N, P) <= _SMEM_BYTES):
        raise ValueError(f"heaviest_bundle: the kernel needs 1 <= P <= "
                         f"{_P_MAX}, N <= {_N_MAX} and a window within "
                         f"{_SMEM_BYTES} B of shared memory (N={N}, P={P}: "
                         f"{smem_bytes(N, P)} B)")


def occupancy(N: int, P: int) -> int:
    """Windows resident on one SM of the current card at (N, P), at
    the launch's windows a block, from the CUDA occupancy
    calculator."""
    return _load().hypo_heaviest_bundle_occupancy(N, P)


def heaviest_bundle(pred_ranks, pred_w_r, pred_cnt_r, is_end_r,
                    node_code_r, node_sup_r, n_nodes, rank0, *, N: int,
                    P: int):
    """Returns (codes_bwd [B,N], sups_bwd [B,N], cons_len [B]), all
    int32: the consensus emitted BACKWARD (the caller reverses), 0 past
    cons_len.  Inputs are in rank space (device_full._rank_arrays_batch):
    pred_ranks [B,N,P] (-1 empty, each below its node's rank),
    pred_w_r [B,N,P], pred_cnt_r [B,N] (>= 1), is_end_r [B,N] bool,
    node_code_r / node_sup_r [B,N], n_nodes [B], rank0 [B] (rank of
    node id 0)."""
    B = pred_ranks.shape[0]
    dev = pred_ranks.device
    i32 = torch.int32
    _build.expect(
        "heaviest_bundle", dev,
        pred_ranks=(pred_ranks, i32, (B, N, P)),
        pred_w_r=(pred_w_r, i32, (B, N, P)),
        pred_cnt_r=(pred_cnt_r, i32, (B, N)),
        is_end_r=(is_end_r, torch.bool, (B, N)),
        node_code_r=(node_code_r, i32, (B, N)),
        node_sup_r=(node_sup_r, i32, (B, N)),
        n_nodes=(n_nodes, i32, (B,)),
        rank0=(rank0, i32, (B,)))
    if dev.type == "cpu":
        from .device_full import _consensus_wavefront
        return _consensus_wavefront(
            pred_ranks, pred_w_r, pred_cnt_r, is_end_r, node_code_r,
            node_sup_r, n_nodes, rank0, N=N, P=P)
    if dev.type != "cuda":
        raise ValueError(f"heaviest_bundle: no kernel for device {dev}")
    check_shape(N, P)
    lib = _load()
    codes_bwd = torch.empty((B, N), dtype=i32, device=dev)
    sups_bwd = torch.empty((B, N), dtype=i32, device=dev)
    cons_len = torch.empty((B,), dtype=i32, device=dev)
    p = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hypo_heaviest_bundle(
            p(pred_ranks), p(pred_w_r), p(pred_cnt_r), p(is_end_r),
            p(node_code_r), p(node_sup_r), p(n_nodes), p(rank0),
            p(codes_bwd), p(sups_bwd), p(cons_len), B, N, P,
            ctypes.c_void_p(stream))
    _build.check(lib, rc, "heaviest_bundle launch")
    _build.count_launch(heaviest_bundle)
    return codes_bwd, sups_bwd, cons_len


heaviest_bundle.launches = 0
