"""Kernel 5: the merge of one aligned arm into every window's graph, in
place (csrc/poa_merge.cu), replacing the XLA code of
hypo_tpu/poa/device_full.py:_merge (:309-424) and the state selection of
its _arm_step_batch (:473-483): a group of warps a window, several
windows a block, the window's col_pos row and its bases' predecessor
slots staged in shared memory (the source's header says how).  The
source picks its launch from (N, L) (csrc/poa_merge_launch.h:
merge_shape) and refuses L > 512 or a window past 48 KB of shared
memory; ``launch_shape`` asks the built library which launch that is.

``merge_arm`` updates the state it is given and returns it.  For tensors
on the CPU it computes the plain version (poa.device_full._merge_step)
and copies it into the state; for CUDA tensors it launches the kernel,
or raises.  ``merge_arm.launches`` counts kernel launches (one captured
in a CUDA graph at each replay: _build.count_launch).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from . import NCODES


class Shape(NamedTuple):
    """A launch of kernel 5 (csrc/poa_merge_launch.h: Shape)."""
    per: int       # arm bases a thread
    warps: int     # warps a window: the fewest that cover L
    windows: int   # windows a block
    threads: int   # threads a block
    smem: int      # dynamic shared bytes a block
    ok: bool       # whether the kernel takes it


def _load():
    lib = _build.load("poa_merge")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hypo_poa_merge.restype = ci
        lib.hypo_poa_merge.argtypes = [vp] * 18 + [ci] * 4 + [vp]
        lib.hypo_poa_merge_shape.restype = ci
        lib.hypo_poa_merge_shape.argtypes = [ci, ci,
                                             ctypes.POINTER(ctypes.c_int)]
        lib._typed = True
    return lib


def launch_shape(N: int, L: int) -> Shape:
    """The launch ``hypo_poa_merge`` makes at (N, L), from the built
    library (so only where nvcc is)."""
    out = (ctypes.c_int * 5)()
    ok = _load().hypo_poa_merge_shape(N, L, out)
    return Shape(*out, bool(ok))


def smem_bytes(N: int, L: int) -> int:
    """Shared memory of one block of the launch at (N, L)."""
    return launch_shape(N, L).smem


def merge_arm(st, node_col_r, matched, arm, arm_len, w, active, *, N: int,
              L: int, P: int):
    """Merge arm b (codes ``arm`` [B, L], length ``arm_len``, weight
    ``w``) along ``matched`` [B, L] (the rank base j aligned to, or -1)
    into window b's graph of ``st`` (a device_full.PoaState, leading
    batch dim B), where ``active``; ``node_col_r`` [B, N] is the column
    of each rank.  Updates ``st`` in place and returns it: the contract
    of device_full._merge_step (a window whose merge does not apply keeps
    every leaf; one that overflows now gets ovf)."""
    B = arm.shape[0]
    dev = arm.device
    i32 = torch.int32
    _build.expect(
        "merge_arm", dev,
        **{f: (getattr(st, f), i32, (B, N)) for f in (
            "node_code", "node_col", "node_sup", "pred_cnt", "out_cnt",
            "col_pos")},
        pred_nd=(st.pred_nd, i32, (B, N, P)),
        pred_w=(st.pred_w, i32, (B, N, P)),
        col_node=(st.col_node, i32, (B, N, NCODES)),
        n_nodes=(st.n_nodes, i32, (B,)), n_cols=(st.n_cols, i32, (B,)),
        ovf=(st.ovf, torch.bool, (B,)),
        node_col_r=(node_col_r, i32, (B, N)),
        matched=(matched, i32, (B, L)),
        arm=(arm, i32, (B, L)),
        arm_len=(arm_len, i32, (B,)),
        w=(w, i32, (B,)),
        active=(active, torch.bool, (B,)))
    if dev.type == "cpu":
        from .device_full import _merge_step
        new = _merge_step(st, node_col_r, matched, arm, arm_len, w, active,
                          N=N, L=L, P=P)
        for leaf, v in zip(st, new):
            leaf.copy_(v)
        return st
    if dev.type != "cuda":
        raise ValueError(f"merge_arm: no kernel for device {dev}")
    lib = _load()
    p = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hypo_poa_merge(
            *map(p, st), p(node_col_r), p(matched), p(arm), p(arm_len),
            p(w), p(active), B, N, L, P, ctypes.c_void_p(stream))
    _build.check(lib, rc, f"merge_arm launch at N={N}, L={L}")
    _build.count_launch(merge_arm)
    return st


merge_arm.launches = 0
