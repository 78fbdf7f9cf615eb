"""Kernel 4: the topological rank of every window's graph and its rank
arrays (csrc/poa_rank.cu), replacing the XLA code of
hypo_tpu/poa/device_full.py:_rank_arrays_batch (:144-193): a group of
warps a window, ranks by counting (the source's header says why that
equals the sort, and how the launch is chosen: csrc/poa_rank_launch.h,
``launch_shape``).  The same source has the tile program's step head
(``step_head``): step k's arm fetch (hypo_tpu device_full.py:756-765,
with act and nn_eff of :444-445) and the rank, in one launch.

``rank_arrays`` and ``step_head`` take the plain versions
(poa.device_full._rank_arrays_batch, _step_head_batch) only for tensors
on the CPU; for CUDA tensors they launch the kernel, or raise.
``leaves`` names the RankArrays fields to compute: the kernel writes
only those, and the others are None in the result on every device
(STEP_LEAVES for an arm step, CONS_LEAVES for the finish).
``rank_arrays.launches`` and ``step_head.launches`` count kernel
launches (one captured in a CUDA graph at each replay:
_build.count_launch); kernel 4's launches are their sum.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
PRED_FIELDS = ("pred_nd_r", "pred_ranks", "pred_rows", "pred_w_r")


class Shape(NamedTuple):
    """A launch of kernel 4 (csrc/poa_rank_launch.h: Shape)."""
    warps: int     # warps a window
    windows: int   # windows a block
    threads: int   # threads a block
    smem: int      # dynamic shared bytes a block
    ok: bool       # whether the kernel takes it


def _load():
    lib = _build.load("poa_rank")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hypo_poa_rank.restype = ci
        lib.hypo_poa_rank.argtypes = [vp] * 22 + [ci] * 4 + [vp]
        lib.hypo_poa_step_head.restype = ci
        lib.hypo_poa_step_head.argtypes = [vp] * 16 + [ci] * 7 + [vp]
        lib.hypo_poa_rank_shape.restype = ci
        lib.hypo_poa_rank_shape.argtypes = [ci, ci,
                                            ctypes.POINTER(ctypes.c_int)]
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=64)
def launch_shape(B: int, N: int) -> Shape:
    """The launch kernel 4 makes over B windows of N nodes, from the built
    library (so only where nvcc is)."""
    out = (ctypes.c_int * 4)()
    ok = _load().hypo_poa_rank_shape(B, N, out)
    return Shape(*out, bool(ok))


def leaf_shape(f: str, B: int, N: int, P: int) -> tuple:
    return (B, N, P) if f in PRED_FIELDS else (B, N)


def leaf_dtype(f: str) -> torch.dtype:
    return torch.bool if f == "is_end_r" else torch.int32


def _check_state(what, st, N):
    """Validate the state a rank reads; returns (B, P, device)."""
    B, P = st.pred_nd.shape[0], st.pred_nd.shape[2]
    dev = st.node_code.device
    i32 = torch.int32
    _build.expect(
        what, dev,
        **{f: (getattr(st, f), i32, (B, N)) for f in (
            "node_code", "node_col", "node_sup", "pred_cnt", "out_cnt",
            "col_pos")},
        pred_nd=(st.pred_nd, i32, (B, N, P)),
        pred_w=(st.pred_w, i32, (B, N, P)),
        col_node=(st.col_node, i32, (B, N, NCODES)),
        n_nodes=(st.n_nodes, i32, (B,)), n_cols=(st.n_cols, i32, (B,)))
    return B, P, dev


def _cuda_lib(what, dev, B, N):
    """The loaded library for a launch on ``dev``, or raise."""
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    lib = _load()
    if B and not launch_shape(B, N).ok:
        raise ValueError(f"{what}: the kernel takes no launch at N={N} "
                         f"(a window past 48 KB of shared memory)")
    return lib


def _p(t):
    return None if t is None else _build.ptr(t)


def rank_arrays(st, N: int, leaves=FIELDS):
    """The RankArrays of every window of ``st`` (a device_full.PoaState
    with leading batch dim B), with only the fields named in ``leaves``
    computed (the others None); the contract of
    device_full._rank_arrays_batch."""
    from .device_full import RankArrays, _rank_arrays_batch
    unknown = set(leaves) - set(FIELDS)
    if unknown:
        raise ValueError(f"rank_arrays: no leaf {sorted(unknown)}")
    B, P, dev = _check_state("rank_arrays", st, N)
    if dev.type == "cpu":
        ra = _rank_arrays_batch(st, N)
        return RankArrays(*(x if f in leaves else None
                            for f, x in zip(FIELDS, ra)))
    lib = _cuda_lib("rank_arrays", dev, B, N)
    outs = [torch.empty(leaf_shape(f, B, N, P), dtype=leaf_dtype(f),
                        device=dev) if f in leaves else None
            for f in FIELDS]
    bits = sum(LEAF_BITS[f] for f in set(leaves))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hypo_poa_rank(*map(_p, st[:11]), *map(_p, outs), B, N, P,
                               bits, ctypes.c_void_p(stream))
    _build.check(lib, rc, "rank_arrays launch")
    _build.count_launch(rank_arrays)
    return RankArrays(*outs)


rank_arrays.launches = 0


def step_head(st, pool, plen, idx, amode, aw, narms, k, out, *, N: int):
    """The head of the tile program's arm step for step ``k`` (int32 [1]
    on the device, never written): each window's arm fetch from the
    tile's inputs (pool int8 [A, L], plen int32 [A], idx int32 [B, K],
    amode int8 [B, K], aw int32 [B, K], narms int32 [B]) and the
    STEP_LEAVES rank arrays of ``st``, written into ``out`` (a
    device_full.StepHead of fixed buffers, device_full.head_buffers)
    and returned: the contract of device_full._step_head_batch.  On a
    CUDA device one launch, which allocates nothing, so that a CUDA
    graph may hold it."""
    from .device_full import _step_head_batch
    B, P, dev = _check_state("step_head", st, N)
    A, L = pool.shape
    K = idx.shape[1]
    i32, b8 = torch.int32, torch.bool
    _build.expect(
        "step_head", dev, pool=(pool, torch.int8, (A, L)),
        plen=(plen, i32, (A,)), idx=(idx, i32, (B, K)),
        amode=(amode, torch.int8, (B, K)), aw=(aw, i32, (B, K)),
        narms=(narms, i32, (B,)), k=(k, i32, (1,)),
        arm=(out.arm, i32, (B, L)), arm_len=(out.arm_len, i32, (B,)),
        mode=(out.mode, i32, (B,)), w=(out.w, i32, (B,)),
        active=(out.active, b8, (B,)), act=(out.act, b8, (B,)),
        nn_eff=(out.nn_eff, i32, (B,)),
        **{f: (getattr(out.ra, f), leaf_dtype(f), leaf_shape(f, B, N, P))
           for f in STEP_LEAVES})
    if dev.type == "cpu":
        want = _step_head_batch(st, pool, plen, idx, amode, aw, narms, k,
                                N=N)
        for f in out._fields[:-1]:
            getattr(out, f).copy_(getattr(want, f))
        for f in STEP_LEAVES:
            getattr(out.ra, f).copy_(getattr(want.ra, f))
        return out
    lib = _cuda_lib("step_head", dev, B, N)
    state = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in st[:11]))
    ranks = (ctypes.c_void_p * 11)(*(
        getattr(out.ra, f).data_ptr() if f in STEP_LEAVES else None
        for f in FIELDS))
    bits = sum(LEAF_BITS[f] for f in STEP_LEAVES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hypo_poa_step_head(
            state, *map(_p, (pool, plen, idx, amode, aw, narms, k)),
            *map(_p, out[:-1]), ranks, B, N, P, L, K, A, bits,
            ctypes.c_void_p(stream))
    _build.check(lib, rc, f"step_head launch at N={N}, L={L}")
    _build.count_launch(step_head)
    return out


step_head.launches = 0
