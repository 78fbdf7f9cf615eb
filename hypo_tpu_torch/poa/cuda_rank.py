"""Kernel 4: the topological rank of every window's graph and its rank
arrays (csrc/poa_rank.cu), replacing the XLA code of
hypo_tpu/poa/device_full.py:_rank_arrays_batch (:144-193): one block per
window, ranks by counting (the source's header says why that equals the
sort).

``rank_arrays`` takes the plain version (poa.device_full
._rank_arrays_batch) only for tensors on the CPU; for CUDA tensors it
launches the kernel, or raises.  ``leaves`` names the RankArrays fields
to compute: the kernel writes only those, and the others are None in the
result on every device (STEP_LEAVES for an arm step, CONS_LEAVES for the
finish).  ``rank_arrays.launches`` counts kernel launches (one captured
in a CUDA graph at each replay: _build.count_launch).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import NCODES

# RankArrays' fields in order; field k is bit k of the kernel's ``leaves``
FIELDS = ("order", "rank_of", "node_code_r", "node_col_r", "node_sup_r",
          "pred_nd_r", "pred_ranks", "pred_rows", "pred_cnt_r", "pred_w_r",
          "is_end_r")
LEAF_BITS = {f: 1 << k for k, f in enumerate(FIELDS)}
# what kernel 1, kernel 3 and the merge read in an arm step
STEP_LEAVES = ("node_code_r", "node_col_r", "pred_rows", "pred_cnt_r",
               "is_end_r")
# what kernel 2 reads in the finish (rank0 is rank_of[:, 0])
CONS_LEAVES = ("rank_of", "node_code_r", "node_sup_r", "pred_ranks",
               "pred_cnt_r", "pred_w_r", "is_end_r")
_SMEM_BYTES = 48 * 1024


def _load():
    lib = _build.load("poa_rank")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hypo_poa_rank.restype = ci
        lib.hypo_poa_rank.argtypes = [vp] * 22 + [ci] * 4 + [vp]
        lib._typed = True
    return lib


def smem_bytes(N: int) -> int:
    """Shared memory of one block (csrc/poa_rank.cu: smem_ints)."""
    return 4 * (3 * N + 32)


def rank_arrays(st, N: int, leaves=FIELDS):
    """The RankArrays of every window of ``st`` (a device_full.PoaState
    with leading batch dim B), with only the fields named in ``leaves``
    computed (the others None); the contract of
    device_full._rank_arrays_batch."""
    from .device_full import RankArrays, _rank_arrays_batch
    B, P = st.pred_nd.shape[0], st.pred_nd.shape[2]
    dev = st.node_code.device
    unknown = set(leaves) - set(FIELDS)
    if unknown:
        raise ValueError(f"rank_arrays: no leaf {sorted(unknown)}")
    i32 = torch.int32
    _build.expect(
        "rank_arrays", dev,
        **{f: (getattr(st, f), i32, (B, N)) for f in (
            "node_code", "node_col", "node_sup", "pred_cnt", "out_cnt",
            "col_pos")},
        pred_nd=(st.pred_nd, i32, (B, N, P)),
        pred_w=(st.pred_w, i32, (B, N, P)),
        col_node=(st.col_node, i32, (B, N, NCODES)),
        n_nodes=(st.n_nodes, i32, (B,)), n_cols=(st.n_cols, i32, (B,)))
    if dev.type == "cpu":
        ra = _rank_arrays_batch(st, N)
        return RankArrays(*(x if f in leaves else None
                            for f, x in zip(FIELDS, ra)))
    if dev.type != "cuda":
        raise ValueError(f"rank_arrays: no kernel for device {dev}")
    if smem_bytes(N) > _SMEM_BYTES:
        raise ValueError(f"rank_arrays: the kernel needs N <= "
                         f"{(_SMEM_BYTES // 4 - 32) // 3} (N={N})")
    lib = _load()

    def out(f):
        if f not in leaves:
            return None
        shape = (B, N, P) if f in ("pred_nd_r", "pred_ranks", "pred_rows",
                                   "pred_w_r") else (B, N)
        dtype = torch.bool if f == "is_end_r" else i32
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = [out(f) for f in FIELDS]
    bits = sum(LEAF_BITS[f] for f in set(leaves))
    p = lambda t: None if t is None else _build.ptr(t)  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hypo_poa_rank(
            p(st.node_code), p(st.node_col), p(st.node_sup), p(st.pred_nd),
            p(st.pred_w), p(st.pred_cnt), p(st.out_cnt), p(st.col_pos),
            p(st.col_node), p(st.n_nodes), p(st.n_cols), *map(p, outs), B,
            N, P, bits, ctypes.c_void_p(stream))
    _build.check(lib, rc, "rank_arrays launch")
    _build.count_launch(rank_arrays)
    return RankArrays(*outs)


rank_arrays.launches = 0
