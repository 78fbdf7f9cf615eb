"""The on-device column-POA tile program in PyTorch: counterpart of
hypo_tpu.poa.device_full, tie-exact with it and with its NumPy spec
hypo_tpu.poa.colpoa_ref.

A tile of B windows carries one fixed-shape graph state per window
(``PoaState``, leading batch dimension B).  Each arm step ranks every
graph (kernel 4, poa.cuda_rank; in the tile program the step head,
which also fetches the step's arms), runs the graph-vs-arm DP (kernel 1,
poa.cuda_poa), walks the backpointers (kernel 3, poa.cuda_tb) and merges
the arm into the state in place (kernel 5, poa.cuda_merge); after the
last step the graphs are ranked again and the heaviest-bundle consensus
(kernel 2, poa.cuda_consensus: one warp per window, the window's tables
in shared memory) is curated and packed into nibbles.  Windows that
overflow a cap get a sticky ``ovf`` flag and are re-run on the host
engine by the runner.

The plain versions of kernels 4, 5 and 2 are ``_rank_arrays_batch``
(and ``_step_head_batch`` for the step head), ``_merge_step``
(``_merge`` and the state selection) and ``_consensus_wavefront``
below.  Where the JAX package expressed irregular indexing as one-hot
compares and f32 matmuls (a TPU workaround, device_full.py:24-28,
105-142), they use integer gather / scatter: every scatter target is
unique per window (an alignment path visits each column, node and edge
at most once), except a dummy slot past the end that absorbs masked
writes and is dropped.  The plain rank order is a sort by (column
position, node id) where JAX and kernel 4 count; the two are equal.

Everything runs on the device of the tensors it is given; the kernel
wrappers take their plain versions only for CPU tensors.  The tile
program (``build_tile_program``) splits its B windows into one
contiguous block of rows per device, as the JAX package's shard_map
does (device_full.py:733-779), and runs a tile on each block's fixed
buffers as begin, step x kmax, finish: on a CUDA device as replays of
three CUDA graphs, where the JAX package runs one jitted program.
``run_arm_steps`` and ``run_tile_eager``, the same steps as eager
launches, are its plain reference.  ``poa_full_batch`` is the JAX
package's whole-batch entry point: K eager arm steps of weight 1 on a
fresh state, then the consensus with each base's support, neither
curated nor packed.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..utils import trace
from . import BIG, NCODES, NEG
from .cuda_consensus import heaviest_bundle
from .cuda_merge import merge_arm
from .cuda_poa import poa_dp_batch
from .cuda_rank import (CONS_LEAVES, FIELDS, STEP_LEAVES, leaf_dtype,
                        leaf_shape, rank_arrays, step_head)
from .cuda_tb import poa_tb_matched

_I32 = torch.int32


class PoaState(NamedTuple):
    """Per-window graph state; every leaf has a leading batch dim B."""
    node_code: torch.Tensor   # [B, N] i32
    node_col: torch.Tensor    # [B, N] i32
    node_sup: torch.Tensor    # [B, N] i32
    pred_nd: torch.Tensor     # [B, N, P] i32 (node ids, -1 empty)
    pred_w: torch.Tensor      # [B, N, P] i32 (sequence counts)
    pred_cnt: torch.Tensor    # [B, N] i32
    out_cnt: torch.Tensor     # [B, N] i32
    col_pos: torch.Tensor     # [B, N] i32 (column -> topo position)
    col_node: torch.Tensor    # [B, N, NCODES] i32 (-1 empty)
    n_nodes: torch.Tensor     # [B] i32
    n_cols: torch.Tensor      # [B] i32
    ovf: torch.Tensor         # [B] bool


# the value every leaf of a fresh state holds
_FRESH = PoaState(node_code=0, node_col=0, node_sup=0, pred_nd=-1, pred_w=0,
                  pred_cnt=0, out_cnt=0, col_pos=0, col_node=-1, n_nodes=0,
                  n_cols=0, ovf=False)


def _reset_state(st: PoaState) -> None:
    """Make ``st`` a fresh state again, in place."""
    for leaf, v in zip(st, _FRESH):
        leaf.fill_(v)


def clone_state(st: PoaState) -> PoaState:
    """A copy of ``st`` that an in-place arm step does not change."""
    return PoaState(*(leaf.clone() for leaf in st))


def init_state(N: int, P: int, B: int, device) -> PoaState:
    e = lambda *s: torch.empty(s, dtype=_I32, device=device)  # noqa: E731
    st = PoaState(
        node_code=e(B, N), node_col=e(B, N), node_sup=e(B, N),
        pred_nd=e(B, N, P), pred_w=e(B, N, P), pred_cnt=e(B, N),
        out_cnt=e(B, N), col_pos=e(B, N), col_node=e(B, N, NCODES),
        n_nodes=e(B), n_cols=e(B),
        ovf=torch.empty(B, dtype=torch.bool, device=device))
    _reset_state(st)
    return st


class RankArrays(NamedTuple):
    """Per-rank views of the graph (leading batch dim B everywhere).
    Rows r >= n_nodes hold the JAX package's padding: zeros, so
    pred_cnt_r = 1, is_end_r = True and pred_rows = 1 there."""
    order: torch.Tensor        # [B, N] node id at rank r (0 past n_nodes)
    rank_of: torch.Tensor      # [B, N] rank of node v (BIG invalid)
    node_code_r: torch.Tensor  # [B, N]
    node_col_r: torch.Tensor   # [B, N]
    node_sup_r: torch.Tensor   # [B, N]
    pred_nd_r: torch.Tensor    # [B, N, P] node ids (-1 empty)
    pred_ranks: torch.Tensor   # [B, N, P] pred ranks (-1 empty)
    pred_rows: torch.Tensor    # [B, N, P] pred rank + 1 (0 empty)
    pred_cnt_r: torch.Tensor   # [B, N] (clamped >= 1)
    pred_w_r: torch.Tensor     # [B, N, P]
    is_end_r: torch.Tensor     # [B, N] bool


class StepHead(NamedTuple):
    """The head of an arm step (poa.cuda_rank.step_head): step k's arm of
    every window and what kernels 1, 3 and 5 read of it, and the rank
    arrays (the tile program's fixed buffers: head_buffers)."""
    arm: torch.Tensor      # [B, L] i32: pool[rr], rr = max(idx[:, k], 0)
    arm_len: torch.Tensor  # [B] i32: plen[rr] where active, else 0
    mode: torch.Tensor     # [B] i32: amode[:, k]
    w: torch.Tensor        # [B] i32: aw[:, k]
    active: torch.Tensor   # [B] bool: k < narms and idx[:, k] >= 0
    act: torch.Tensor      # [B] bool: active, an arm and a graph
    nn_eff: torch.Tensor   # [B] i32: n_nodes where act, else 0
    ra: RankArrays         # STEP_LEAVES (every leaf in _step_head_batch)


def head_buffers(B: int, N: int, L: int, P: int, device) -> StepHead:
    """Buffers for a step head of B windows (rank leaves: STEP_LEAVES,
    the others None)."""
    e = lambda *s, dtype=_I32: torch.empty(  # noqa: E731
        s, dtype=dtype, device=device)
    b8 = torch.bool
    ra = RankArrays(*(e(*leaf_shape(f, B, N, P), dtype=leaf_dtype(f))
                      if f in STEP_LEAVES else None for f in FIELDS))
    return StepHead(arm=e(B, L), arm_len=e(B), mode=e(B), w=e(B),
                    active=e(B, dtype=b8), act=e(B, dtype=b8), nn_eff=e(B),
                    ra=ra)


def _take(x, idx):
    """x[b, idx[b, ...]] along dim 1 for x [B, M] and any idx [B, ...]."""
    B = x.shape[0]
    return x.gather(1, idx.reshape(B, -1).long()).reshape(idx.shape)


def _put(x, idx, val, mask, add=False):
    """Copy of x [B, M] with x[b, idx] = val (or += val with ``add``)
    where mask.  Masked-out and out-of-range writes go to a dummy slot
    that is dropped.  Plain writes that are kept must not collide unless
    they write the same value."""
    B, M = x.shape
    ok = mask & (idx >= 0) & (idx < M)
    out = torch.cat([x, x.new_zeros(B, 1)], dim=1)
    index = torch.where(ok, idx, M).reshape(B, -1).long()
    src = val.to(x.dtype).expand_as(idx).reshape(B, -1)
    if add:
        out.scatter_add_(1, index, src)
    else:
        out.scatter_(1, index, src)
    return out[:, :M]


def _rank_arrays_batch(st: PoaState, N: int) -> RankArrays:
    """Topological order (column position, node id) over valid nodes,
    plus the graph arrays permuted into rank order
    (hypo_tpu device_full._rank_arrays_batch)."""
    B = st.node_code.shape[0]
    P = st.pred_nd.shape[2]
    dev = st.node_code.device
    idx = torch.arange(N, dtype=_I32, device=dev)
    # [B, N]: node ids below n_nodes are valid, and so are ranks
    nvalid = idx[None, :] < st.n_nodes[:, None]
    pos = _take(st.col_pos, st.node_col.clamp(0, N - 1)).long()
    key = torch.where(nvalid, pos * N + idx, N * N + N)
    order_all = torch.argsort(key, dim=1)                       # [B, N]
    rank_all = torch.empty_like(order_all).scatter_(
        1, order_all, torch.arange(N, device=dev).expand(B, N))
    rank_of = torch.where(nvalid, rank_all.to(_I32), BIG)
    order = torch.where(nvalid, order_all.to(_I32), 0)
    pn = st.pred_nd
    pred_rank_un = torch.where(pn >= 0, _take(rank_of, pn.clamp(min=0)),
                               -1)

    def perm(x):
        if x.dim() == 2:
            g = x.gather(1, order_all)
            return torch.where(nvalid, g, 0)
        g = x.gather(1, order_all[:, :, None].expand(B, N, x.shape[2]))
        return torch.where(nvalid[:, :, None], g, 0)

    pred_nd_r = perm(pn)
    pred_ranks = perm(pred_rank_un)
    return RankArrays(
        order=order, rank_of=rank_of,
        node_code_r=perm(st.node_code), node_col_r=perm(st.node_col),
        node_sup_r=perm(st.node_sup), pred_nd_r=pred_nd_r,
        pred_ranks=pred_ranks,
        pred_rows=torch.where(pred_nd_r >= 0, pred_ranks + 1, 0),
        pred_cnt_r=perm(st.pred_cnt).clamp(min=1),
        pred_w_r=perm(st.pred_w), is_end_r=perm(st.out_cnt) == 0)


def _traceback_matched_batch(bp, pred_rows, arm_len, mode, max_row, *,
                             active, N, L, P):
    """The backpointer walk of the whole batch: kernel 3's tile emitter
    (poa.cuda_tb.poa_tb_matched, one launch; its plain version for CPU
    tensors).  Returns matched [B, L] i32: the rank of the graph node
    arm base j aligned to, or -1 (insertion / unaligned head)."""
    return poa_tb_matched(bp, pred_rows, arm_len, mode, max_row, active,
                          N=N, L=L, P=P)


def _merge(st: PoaState, node_col_r, matched, arm, arm_len, w, *, N, L, P):
    """Batched merge of one aligned arm with multiplicity weight w into
    every window's graph (hypo_tpu device_full._merge; colpoa_ref
    ColPoa.add).  Returns (new state, overflowed [B] bool); the new
    state's ovf is the old one (the caller makes it sticky)."""
    B = arm.shape[0]
    dev = arm.device
    jj = torch.arange(L, dtype=_I32, device=dev)[None, :]
    valid_j = jj < arm_len[:, None]
    is_match = (matched >= 0) & valid_j
    mi = matched.clamp(min=0)
    c_match = torch.where(is_match, _take(node_col_r, mi), 0)
    arm_c = arm.clamp(0, NCODES - 1)
    cn_flat = st.col_node.reshape(B, N * NCODES)
    exist = torch.where(is_match, _take(cn_flat, c_match * NCODES + arm_c),
                        -1)
    creates_node = valid_j & (~is_match | (exist < 0))
    new_ord = torch.cumsum(creates_node, dim=1, dtype=_I32)
    node_j = torch.where(creates_node, st.n_nodes[:, None] - 1 + new_ord,
                         torch.where(is_match, exist, -1))
    is_ins = valid_j & ~is_match
    newcol_ord = torch.cumsum(is_ins, dim=1, dtype=_I32)
    new_col_id = st.n_cols[:, None] - 1 + newcol_ord
    col_j = torch.where(is_match, c_match, new_col_id)
    n_new_nodes = new_ord[:, L - 1]
    n_new_cols = newcol_ord[:, L - 1]
    ovf = ((st.n_nodes + n_new_nodes > N)
           | (st.n_cols + n_new_cols > N))

    # column renumbering, arithmetically: every inserted run of columns
    # is anchored after the last matched column position ("lastpos");
    # an existing column at position p shifts by the number of
    # insertions anchored strictly before p, and inserted column t of
    # the run anchored at q lands at q + shift(q) + t (positions of the
    # state before this arm)
    mpos = torch.where(is_match, _take(st.col_pos, c_match), -BIG)
    lastpos = torch.cummax(mpos, dim=1).values.clamp(min=-1)
    lastj = torch.cummax(torch.where(is_match, jj, -1), dim=1).values
    hist = _put(torch.zeros(B, N + 1, dtype=_I32, device=dev), lastpos + 1,
                torch.ones_like(lastpos), is_ins, add=True)
    cs = torch.cumsum(hist, dim=1, dtype=_I32)  # cs[q+1] = #ins at <= q
    cidx = torch.arange(N, dtype=_I32, device=dev)[None, :]
    col_pos_exist = torch.where(
        cidx < st.n_cols[:, None],
        st.col_pos + _take(cs, st.col_pos.clamp(0, N)), st.col_pos)
    anchor_shift = torch.where(lastpos >= 0,
                               _take(cs, lastpos.clamp(min=0)), 0)
    pos_new = lastpos + anchor_shift + (jj - lastj)
    col_pos = _put(col_pos_exist, new_col_id, pos_new, is_ins)

    # node updates
    node_code = _put(st.node_code, node_j, arm, creates_node)
    node_col = _put(st.node_col, node_j, col_j, creates_node)
    wl = w[:, None].expand(B, L)
    node_sup = _put(st.node_sup, node_j, wl, valid_j, add=True)
    col_node = _put(cn_flat, col_j * NCODES + arm_c, node_j,
                    creates_node & (col_j >= 0) & (col_j < N)
                    ).reshape(B, N, NCODES)

    # edge upserts between consecutive emitted bases
    u = torch.cat([torch.full((B, 1), -1, dtype=_I32, device=dev),
                   node_j[:, :-1]], dim=1)
    v = node_j
    edge_valid = valid_j & (jj >= 1)
    v_ok = edge_valid & (v >= 0) & (v < N)
    vc = v.clamp(0, N - 1)
    pnd_flat = st.pred_nd.reshape(B, N * P)
    slots = vc[:, :, None] * P + torch.arange(P, device=dev)
    pv = torch.where(v_ok[:, :, None], _take(pnd_flat, slots), 0)
    vcnt = torch.where(v_ok, _take(st.pred_cnt, vc), 0)
    hit = (pv == u[:, :, None]) & edge_valid[:, :, None]
    has = hit.any(dim=2) & edge_valid
    slot = torch.where(has, hit.to(_I32).argmax(dim=2).to(_I32), vcnt)
    ovf = ovf | (edge_valid & ~has & (slot >= P)).any(dim=1)
    slot_c = slot.clamp(max=P - 1)
    flat_vs = v * P + slot_c
    pred_w = _put(st.pred_w.reshape(B, N * P), flat_vs, wl,
                  v_ok, add=True).reshape(B, N, P)
    newslot = edge_valid & ~has
    pred_nd = _put(pnd_flat, flat_vs, u, newslot & v_ok).reshape(B, N, P)
    pred_cnt = _put(st.pred_cnt, v, torch.ones_like(v), newslot, add=True)
    out_cnt = _put(st.out_cnt, u, torch.ones_like(u), newslot, add=True)

    new_st = PoaState(
        node_code=node_code, node_col=node_col, node_sup=node_sup,
        pred_nd=pred_nd, pred_w=pred_w, pred_cnt=pred_cnt,
        out_cnt=out_cnt, col_pos=col_pos, col_node=col_node,
        n_nodes=st.n_nodes + n_new_nodes, n_cols=st.n_cols + n_new_cols,
        ovf=st.ovf)
    return new_st, ovf


def _merge_step(st: PoaState, node_col_r, matched, arm, arm_len, w, active,
                *, N, L, P) -> PoaState:
    """The plain version of kernel 5 (poa.cuda_merge.merge_arm), which
    works in place where this returns a new state: the merge of
    ``_merge`` where it applies (the window is active, has an arm and has
    not overflowed, before or now), the old state elsewhere, and a sticky
    ovf (hypo_tpu device_full._arm_step_batch, :470-483).  An empty graph
    takes every base as an insertion, whatever ``matched`` holds."""
    matched = torch.where((st.n_nodes == 0)[:, None], -1, matched)
    new_st, ovf = _merge(st, node_col_r, matched, arm, arm_len, w, N=N, L=L,
                         P=P)
    apply = active & (arm_len > 0) & ~st.ovf & ~ovf

    def sel(old, new):
        keep = apply.reshape(apply.shape + (1,) * (new.dim() - 1))
        return torch.where(keep, new, old)

    out = PoaState(*(sel(a, b) for a, b in zip(st, new_st)))
    return out._replace(ovf=st.ovf | (active & (arm_len > 0) & ovf))


def _dp_rows(st: PoaState, arm_len, active):
    """(act, nn_eff): windows done with their arms (or empty this round)
    skip the DP (n_nodes -> 0) and start the traceback stopped."""
    act = active & (arm_len > 0) & (st.n_nodes > 0)
    return act, torch.where(act, st.n_nodes, 0)


def _arm_step_batch(st: PoaState, arm, arm_len, mode, active, w=None, *,
                    N, L, P, m, n, g) -> PoaState:
    """One arm round for the whole window batch: rank (kernel 4), DP
    (kernel 1), traceback (kernel 3), merge (kernel 5).  st leaves carry
    a leading batch dim B; arm [B, L]; arm_len, mode, active, w [B].
    The merge updates ``st`` in place; returns it."""
    ra = rank_arrays(st, N, STEP_LEAVES)
    act, nn_eff = _dp_rows(st, arm_len, active)
    w = torch.ones_like(arm_len) if w is None else w.contiguous()
    return _arm_step_tail(st, ra, arm, arm_len, mode, w, active, act,
                          nn_eff, N=N, L=L, P=P, m=m, n=n, g=g)


def _arm_step_tail(st: PoaState, ra, arm, arm_len, mode, w, active, act,
                   nn_eff, *, N, L, P, m, n, g) -> PoaState:
    """The arm step after its rank: DP (kernel 1), traceback (kernel 3),
    merge (kernel 5, in place; returns ``st``), on the step's rank
    arrays ``ra`` and arm, as _arm_step_batch and the step head
    (_step_head_batch) give them."""
    bp, max_row = poa_dp_batch(
        ra.node_code_r, ra.pred_rows, ra.pred_cnt_r, ra.is_end_r, nn_eff,
        arm, arm_len, mode, N=N, L=L, P=P, m=m, n=n, g=g)
    matched = _traceback_matched_batch(bp, ra.pred_rows, arm_len, mode,
                                       max_row, active=act, N=N, L=L, P=P)
    return merge_arm(st, ra.node_col_r, matched, arm, arm_len, w, active,
                     N=N, L=L, P=P)


def _step_head_batch(st: PoaState, pool, plen, idx, amode, aw, narms, k, *,
                     N) -> StepHead:
    """The plain version of the step head (poa.cuda_rank.step_head): the
    arm fetch of the tile program's step k (``k`` int32 [1]; hypo_tpu
    device_full.py:756-765), act and nn_eff as _arm_step_batch computes
    them, then every rank leaf (_rank_arrays_batch)."""
    col = k.long().expand(idx.shape[0], 1)
    rows = idx.gather(1, col)[:, 0]
    active = (k < narms) & (rows >= 0)
    rr = rows.clamp(min=0).long()
    al = torch.where(active, plen[rr], 0)
    act, nn_eff = _dp_rows(st, al, active)
    return StepHead(arm=pool[rr].to(_I32), arm_len=al,
                    mode=amode.gather(1, col)[:, 0].to(_I32),
                    w=aw.gather(1, col)[:, 0], active=active, act=act,
                    nn_eff=nn_eff, ra=_rank_arrays_batch(st, N))


def _consensus_wavefront(pred_ranks, pred_w_r, pred_cnt_r, is_end_r,
                         node_code_r, node_sup_r, n_nodes, rank0, *, N, P,
                         with_rounds=False):
    """Plain heaviest-bundle consensus (the reference version of kernel 2;
    hypo_tpu device_full._consensus_wavefront): every node relaxes from
    its predecessors' current scores at once, iterated to the fixpoint,
    which on a DAG equals the sequential result.  Branch completion runs
    at most N rounds, as the kernel does.  Same arguments and results as
    cuda_consensus.heaviest_bundle; codes and supports past cons_len are
    0.  ``with_rounds`` appends each window's number of branch-completion
    rounds (int32 [B])."""
    B = pred_ranks.shape[0]
    dev = pred_ranks.device
    parange = torch.arange(P, dtype=_I32, device=dev)
    narange = torch.arange(N, dtype=_I32, device=dev)
    nn = n_nodes
    valid_r = narange[None, :] < nn[:, None]
    slot_base = ((parange[None, None, :] < pred_cnt_r[:, :, None])
                 & (pred_ranks >= 0))
    prf = pred_ranks.clamp(min=0).reshape(B, N * P).long()

    def relax_all(scores, banned: bool):
        sc_p = scores.gather(1, prf).reshape(B, N, P)
        slot_ok = slot_base & (sc_p != -1) if banned else slot_base
        best_w = torch.full((B, N), -1, dtype=_I32, device=dev)
        best_pr = torch.full((B, N), -1, dtype=_I32, device=dev)
        best_sc = torch.full((B, N), NEG, dtype=_I32, device=dev)
        for p in range(P):
            wp = pred_w_r[:, :, p]
            sp = sc_p[:, :, p]
            take = slot_ok[:, :, p] & (
                (best_w < wp) | ((best_w == wp) & (best_sc <= sp)))
            best_w = torch.where(take, wp, best_w)
            best_pr = torch.where(take, pred_ranks[:, :, p], best_pr)
            best_sc = torch.where(take, sp, best_sc)
        return torch.where(best_pr >= 0, best_w + best_sc, -1), best_pr

    def wavefront(scores, preds, banned: bool, upd):
        for _ in range(N + 2):
            ns, npr = relax_all(scores, banned)
            ns = torch.where(upd, ns, scores)
            npr = torch.where(upd, npr, preds)
            changed = bool(((ns != scores) | (npr != preds)).any())
            scores, preds = ns, npr
            if not changed:
                break
        return scores, preds

    scores = torch.full((B, N), -1, dtype=_I32, device=dev)
    preds = torch.full((B, N), -1, dtype=_I32, device=dev)
    scores, preds = wavefront(scores, preds, False, valid_r)
    max_r = torch.where(valid_r, scores, NEG).argmax(dim=1).to(_I32)

    rounds = torch.zeros_like(nn)
    for _ in range(N):
        ie = _take(is_end_r, max_r.clamp(0, N - 1)[:, None])[:, 0]
        act = (nn > 0) & ~ie
        if not bool(act.any()):
            break
        rounds += act.to(_I32)
        mr = max_r[:, None, None]
        succ = ((pred_ranks == mr) & slot_base).any(dim=2)       # [B, N]
        ban = succ[:, :, None] & slot_base & (pred_ranks != mr)
        banned = _put(torch.zeros(B, N, dtype=torch.bool, device=dev),
                      pred_ranks.reshape(B, N * P),
                      torch.ones((), dtype=torch.bool, device=dev),
                      ban.reshape(B, N * P))
        scores = torch.where(banned & act[:, None], -1, scores)
        upd = (narange[None, :] > max_r[:, None]) & valid_r & act[:, None]
        scores = torch.where(upd, -1, scores)
        preds = torch.where(upd, -1, preds)
        scores, preds = wavefront(scores, preds, True, upd)
        masked = torch.where(upd, scores, NEG)
        cand = torch.where(masked.amax(dim=1) > 0,
                           masked.argmax(dim=1).to(_I32), rank0)
        max_r = torch.where(act, cand, max_r)

    r = torch.where(nn > 0, max_r, -1)
    codes = torch.zeros((B, N), dtype=_I32, device=dev)
    sups = torch.zeros((B, N), dtype=_I32, device=dev)
    cons_len = torch.zeros((B,), dtype=_I32, device=dev)
    for t in range(N):
        alive = r >= 0
        if not bool(alive.any()):
            break
        rr = r.clamp(0, N - 1)[:, None]
        codes[:, t] = torch.where(alive, _take(node_code_r, rr)[:, 0], 0)
        sups[:, t] = torch.where(alive, _take(node_sup_r, rr)[:, 0], 0)
        cons_len += alive.to(_I32)
        r = torch.where(alive, _take(preds, rr)[:, 0], r)
    if with_rounds:
        return codes, sups, cons_len, rounds
    return codes, sups, cons_len


def _consensus_batch(st: PoaState, *, N, P):
    """Heaviest-bundle consensus of every window (kernels 4 and 2 on
    CUDA, their plain versions on the CPU), reversed into forward order.
    Returns (cons_codes [B, N], cons_sup [B, N], cons_len [B])."""
    ra = rank_arrays(st, N, CONS_LEAVES)
    codes_bwd, sups_bwd, cons_len = heaviest_bundle(
        ra.pred_ranks, ra.pred_w_r, ra.pred_cnt_r, ra.is_end_r,
        ra.node_code_r, ra.node_sup_r, st.n_nodes,
        ra.rank_of[:, 0].contiguous(), N=N, P=P)
    narange = torch.arange(N, dtype=_I32, device=codes_bwd.device)
    ridx = (cons_len[:, None] - 1 - narange[None, :]).clamp(min=0)
    return _take(codes_bwd, ridx), _take(sups_bwd, ridx), cons_len


def _finish_packed(st: PoaState, th, *, N, P):
    """Consensus + curation against the per-window threshold th [B]
    (0 keeps every base) + nibble packing.  Output int8 [B, N//2 + 4]:
    nibble-packed codes | len lo | len hi | ovf | 0."""
    cc, cs, cl = _consensus_batch(st, N=N, P=P)
    B = cc.shape[0]
    idx = torch.arange(N, dtype=_I32, device=cc.device)[None, :]
    keep = (idx < cl[:, None]) & (cs >= th[:, None])
    dst = torch.cumsum(keep, dim=1, dtype=_I32) - 1
    clen = dst[:, -1] + 1
    curated = _put(torch.zeros(B, N, dtype=_I32, device=cc.device), dst, cc,
                   keep)
    packed = curated[:, 0::2] | (curated[:, 1::2] << 4)
    meta = torch.stack([clen & 0xFF, (clen >> 8) & 0xFF, st.ovf.to(_I32),
                        torch.zeros_like(clen)], dim=1)
    return torch.cat([packed, meta], dim=1).to(torch.uint8).view(torch.int8)


def _staged(x, device, keep, dtype=None) -> torch.Tensor:
    """Numpy array ``x`` (as ``dtype`` when given) as a CPU tensor that a
    copy to ``device`` takes without waiting for the device: in pinned
    memory, appended to ``keep`` when given, for a CUDA device (a copy
    from pageable memory ends in a stream synchronize)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))
    if device.type != "cuda":
        return t
    t = t.pin_memory()
    if keep is not None:
        keep.append(t)
    return t


def upload(x, device, keep=None) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``device``; a numpy array
    bound for a CUDA device goes up through pinned memory with
    non_blocking=True (``_staged``: its pinned buffer is appended to
    ``keep`` when given, for the caller to hold until it has read what
    the device computed from it)."""
    device = torch.device(device)
    if torch.is_tensor(x):
        return x.to(device)
    return _staged(x, device, keep).to(device, non_blocking=True)


def run_arm_steps(pool, plen, idx, amode, aw, narms, *, N, L, P, m, n, g,
                  device, kmax=None) -> PoaState:
    """Merge every window's arms into a fresh graph state on ``device``,
    one eager arm step at a time (the plain reference of the tile
    program's ``step``).  pool [A, L] arm codes; plen [A]; idx [B, K]
    pool row of arm k of window b (-1 none); amode [B, K]; aw [B, K]
    weights; narms [B] (numpy arrays are uploaded with ``upload``).
    The arm loop runs ``kmax`` steps, by default the largest of narms
    (read back from the device when narms lies there); a window's result
    does not depend on it as long as it is at least that window's
    narms, since a window past its arms is inactive."""
    pool, plen, idx, amode, aw, narms = (
        upload(x, device).to(_I32)
        for x in (pool, plen, idx, amode, aw, narms))
    B = idx.shape[0]
    st = init_state(N, P, B, device)
    if kmax is None:
        kmax = int(narms.max()) if B else 0
    for k in range(kmax):
        rows = idx[:, k]
        active = (k < narms) & (rows >= 0)
        rr = rows.clamp(min=0).long()
        arm = pool[rr]
        al = torch.where(active, plen[rr], 0)
        st = _arm_step_batch(st, arm, al, amode[:, k].contiguous(), active,
                             aw[:, k].contiguous(), N=N, L=L, P=P, m=m, n=n,
                             g=g)
    return st


def run_tile_eager(pool, plen, idx, amode, aw, narms, th, *, N, L, P, m, n,
                   g, device) -> torch.Tensor:
    """One tile on one device as eager launches: ``run_arm_steps`` then
    ``_finish_packed``.  The plain reference of the tile program, with
    its arguments and output."""
    st = run_arm_steps(pool, plen, idx, amode, aw, narms, N=N, L=L, P=P,
                       m=m, n=n, g=g, device=device)
    return _finish_packed(st, upload(th, device).to(_I32), N=N, P=P)


def poa_full_batch(arms, arm_len, arm_mode, n_arms, *, N: int, L: int,
                   K: int, P: int, m: int, n: int, g: int, device=None):
    """Full POA for a batch of windows (hypo_tpu device_full
    .poa_full_batch, less ``dp_impl``): a fresh graph state, then the K
    arm steps (kernels 4, 1, 3, 5), window b active at step k while
    k < n_arms[b], every arm with weight 1, then the consensus (kernels 4
    and 2).

    arms [B, K, L] global codes (A C G T J O = 0..5; int32 as in the JAX
    package, or int8 as in the tile program's pool); arm_len [B, K];
    arm_mode [B, K] (NW/LOV/ROV); n_arms [B]: numpy arrays or tensors.
    Runs on ``device``, by default the device of ``arms`` when it is a
    tensor, else the current CUDA device.  Returns (cons_codes int32
    [B, N], cons_sup int32 [B, N], cons_len int32 [B], ovf bool [B]) on
    that device; codes and supports past cons_len are those of position
    0 of the backward consensus, as in the JAX package.  The inputs are
    copied, once, into new int32 tensors in step-major order, so the
    caller's arrays never change.  Every one of the K steps runs, as the
    JAX package's lax.scan does: a step with no active window skips its
    DP and walk rows and merges nothing."""
    if device is None:
        if torch.is_tensor(arms):
            device = arms.device
        elif torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            raise RuntimeError("poa_full_batch: no CUDA device; pass "
                               "device='cpu' for the plain versions")
    device = torch.device(device)
    arms, arm_len, arm_mode, n_arms = (
        torch.as_tensor(x) for x in (arms, arm_len, arm_mode, n_arms))
    B = arms.shape[0]
    want = dict(arms=(B, K, L), arm_len=(B, K), arm_mode=(B, K),
                n_arms=(B,))
    for name, x in zip(want, (arms, arm_len, arm_mode, n_arms)):
        if tuple(x.shape) != want[name] or x.is_floating_point():
            raise ValueError(f"poa_full_batch: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected integers of shape "
                             f"{want[name]}")

    def steps_first(x):
        # a new contiguous int32 tensor on the device, step k at [k]
        out = torch.empty((K,) + tuple(x.shape[:1]) + tuple(x.shape[2:]),
                          dtype=_I32, device=device)
        return out.copy_(x.transpose(0, 1))

    arms_k, len_k, mode_k = (steps_first(x)
                             for x in (arms, arm_len, arm_mode))
    narms = torch.empty(B, dtype=_I32, device=device).copy_(n_arms)
    st = init_state(N, P, B, device)
    for k in range(K):
        _arm_step_batch(st, arms_k[k], len_k[k], mode_k[k], k < narms, N=N,
                        L=L, P=P, m=m, n=n, g=g)
    cons_codes, cons_sup, cons_len = _consensus_batch(st, N=N, P=P)
    return cons_codes, cons_sup, cons_len, st.ovf


def as_devices(devices) -> List[torch.device]:
    """A device (or its name) or a sequence of them, as a list."""
    if isinstance(devices, (list, tuple)):
        return [torch.device(d) for d in devices]
    return [torch.device(devices)]


# a tile's inputs in the order the program takes them, with the dtype
# of each one's fixed buffer
_TILE_INPUTS = (("pool", np.int8), ("plen", np.int32), ("idx", np.int32),
                ("amode", np.int8), ("aw", np.int32), ("narms", np.int32),
                ("th", np.int32))


def _on(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _replay(graph, launches) -> None:
    """Replay ``graph``; each kernel wrapper counts the launches the
    graph recorded at capture."""
    graph.replay()
    for wrapper, count in launches.items():
        wrapper.launches += count


class _Block:
    """One device block of a tile program: fixed buffers for its rows of
    the tile's inputs (the whole arm pool), the graph state, the step
    head's outputs, the arm counter ``k`` (a device int32) and the
    packed output, and the three parts of a tile that work on them in
    place: ``begin``, ``step`` and ``finish``.  On a CUDA device each part is captured once in a CUDA
    graph, at the block's first run, and replayed; elsewhere the parts
    are called as they are."""

    def __init__(self, dev: torch.device, rows: int, *, N, L, K, P, m, n, g,
                 A):
        self.dev = dev
        self.kw = dict(N=N, L=L, P=P, m=m, n=n, g=g)
        shapes = dict(pool=(A, L), plen=(A,), idx=(rows, K),
                      amode=(rows, K), aw=(rows, K), narms=(rows,),
                      th=(rows,))
        self.inputs = [torch.from_numpy(np.zeros(shapes[name], dt)).to(dev)
                       for name, dt in _TILE_INPUTS]
        self.st = init_state(N, P, rows, dev)
        self.head = head_buffers(rows, N, L, P, dev)
        self.k = torch.zeros(1, dtype=_I32, device=dev)
        self.out = torch.zeros((rows, N // 2 + 4), dtype=torch.int8,
                               device=dev)
        self._parts = None
        # CUDA: the capture's seconds, and torch.cuda.memory_reserved
        # before it (the cache emptied) and after it: the growth is the
        # graphs' private memory pool
        self.capture_stats: Optional[dict] = None

    def load(self, arrays, keep) -> None:
        """Copy a tile's arrays (this block's rows) into the input
        buffers, on the current stream, without waiting."""
        for buf, x, (_name, dt) in zip(self.inputs, arrays, _TILE_INPUTS):
            src = (x.to(buf.dtype) if torch.is_tensor(x)
                   else _staged(x, self.dev, keep, dt))
            buf.copy_(src, non_blocking=True)

    def begin(self) -> None:
        """A fresh graph state, and k = 0."""
        _reset_state(self.st)
        self.k.zero_()

    def step(self) -> None:
        """One arm step (run_arm_steps' loop body) with the arm index k
        read on the device: the step head (arm k of every window and the
        rank, into the head's buffers), then the DP, walk and merge of
        arm k into every graph (the state's buffers updated in place),
        then k += 1."""
        h = step_head(self.st, *self.inputs[:6], self.k, self.head,
                      N=self.kw["N"])
        _arm_step_tail(self.st, h.ra, h.arm, h.arm_len, h.mode, h.w,
                       h.active, h.act, h.nn_eff, **self.kw)
        self.k += 1

    def finish(self) -> None:
        """Consensus, curation and packing of every window into out."""
        self.out.copy_(_finish_packed(self.st, self.inputs[6],
                                      N=self.kw["N"], P=self.kw["P"]))

    def parts(self):
        """(begin, step, finish) as this block runs them: on CUDA, the
        replays of each part's graph (captured at the first call, in a
        ``tiles.capture`` span with ``capture_stats``' seconds and the
        reserved bytes' growth)."""
        if self._parts is None and self.dev.type == "cuda":
            with trace.span("tiles.capture") as sp:
                self._parts = self._capture()
                st = self.capture_stats
                sp.set(seconds=st["seconds"], reserved_growth=(
                    st["reserved_after"] - st["reserved_before"]))
        elif self._parts is None:
            self._parts = (self.begin, self.step, self.finish)
        return self._parts

    def _capture(self):
        """Each part captured in a CUDA graph, all three in one private
        memory pool (they never run at once: one stream replays them in
        turn), after one eager call of each on the capture stream, so
        that every first-call setting is made outside the capture.  The
        capture is thread-local: another thread may use the card
        meanwhile."""
        t0 = time.perf_counter()
        torch.cuda.empty_cache()      # as every capture below does
        before = torch.cuda.memory_reserved(self.dev)
        side = torch.cuda.Stream(self.dev)
        cur = torch.cuda.current_stream(self.dev)
        side.wait_stream(cur)
        fns = (self.begin, self.step, self.finish)
        with torch.cuda.stream(side):
            for fn in fns:
                fn()
        cur.wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        parts = []
        for fn in fns:
            graph = torch.cuda.CUDAGraph()
            with _build.recording() as launches, torch.cuda.graph(
                    graph, pool=pool, stream=side,
                    capture_error_mode="thread_local"):
                fn()
            parts.append(functools.partial(_replay, graph, launches))
        self.capture_stats = dict(
            seconds=time.perf_counter() - t0, reserved_before=before,
            reserved_after=torch.cuda.memory_reserved(self.dev))
        return tuple(parts)

    def run(self, kmax: int) -> None:
        """The tile whose inputs were loaded: begin, step x kmax,
        finish."""
        begin, step, finish = self.parts()
        begin()
        for _ in range(kmax):
            step()
        finish()


class TileProgram:
    """The tile program of one shape class over a list of devices (see
    build_tile_program).  Its device blocks are made at the first
    call.  With the recorder on (``utils.trace``) each call counts every
    block's window steps, and those of them in which a row had an arm,
    from the host's narms."""

    def __init__(self, *, N, L, K, P, m, n, g, B, A, devices):
        self.devices = as_devices(devices)
        ndev = len(self.devices)
        if not ndev or B % ndev:
            raise ValueError(f"build_tile_program: B={B} rows do not split "
                             f"into {ndev} equal device blocks")
        self.B = B
        self.blk = B // ndev
        self.kw = dict(N=N, L=L, K=K, P=P, m=m, n=n, g=g, A=A)
        self.blocks: Optional[List[_Block]] = None

    def __call__(self, pool, plen, idx, amode, aw, narms, th, keep=None):
        A, L, K, B = self.kw["A"], self.kw["L"], self.kw["K"], self.B
        if tuple(pool.shape) != (A, L) or tuple(idx.shape) != (B, K):
            raise ValueError(f"tile: pool {tuple(pool.shape)} / idx "
                             f"{tuple(idx.shape)}, expected {(A, L)} / "
                             f"{(B, K)}")
        if self.blocks is None:
            self.blocks = [_Block(dev, self.blk, **self.kw)
                           for dev in self.devices]
        narms_h = (narms.cpu().numpy() if torch.is_tensor(narms)
                   else np.asarray(narms))
        blk = self.blk
        outs = []
        for d, block in enumerate(self.blocks):
            r = slice(d * blk, (d + 1) * blk)
            kmax = int(narms_h[r].max()) if blk else 0
            if trace.active():
                # every row runs kmax arm steps; a row's step does work
                # while the row has an arm left
                trace.count("tiles.window_steps", blk * kmax)
                trace.count("tiles.active_window_steps",
                            np.minimum(narms_h[r], kmax).sum())
            with _on(block.dev):
                block.load((pool, plen, idx[r], amode[r], aw[r], narms[r],
                            th[r]), keep)
                block.run(kmax)
                # the next tile's run overwrites block.out
                outs.append(block.out.clone())
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(self.devices[0], non_blocking=True)
                          for o in outs])


def build_tile_program(*, N: int, L: int, K: int, P: int, m: int, n: int,
                       g: int, B: int, A: int, devices) -> TileProgram:
    """The tile program of one shape class over ``devices`` (a device or
    a list; hypo_tpu device_full.build_tile_program with ndev =
    len(devices)): ``tile(pool i8 [A, L], plen i32 [A], idx i32 [B, K],
    amode i8 [B, K], aw i32 [B, K], narms i32 [B], th i32 [B], keep=None)
    -> int8 [B, N//2 + 4]`` (see _finish_packed), equal to
    ``run_tile_eager`` on the same tile.  Arguments may be numpy arrays
    or tensors; numpy arrays go up through pinned memory without a host
    sync, their pinned buffers appended to the list ``keep`` when one is
    given.  The output is not read back: a call returns once its work is
    queued on the devices.

    The B rows split into len(devices) contiguous blocks of B // ndev
    (B must divide by ndev, as in the JAX package); the arm pool goes to
    every device.  Each block holds fixed buffers for its inputs, graph
    state and output, and runs a tile as begin, step x kmax and finish
    on them (``_Block``), kmax being the block's largest arm count from
    the host's narms: on a CUDA device as replays of the three CUDA
    graphs it captures at its first tile, the counterpart of the JAX
    package's one jitted program a tile (fori_loop over the arm steps,
    then the finish).  A block's work stays on its device's current
    stream, so tiles queued back to back reuse the buffers in order;
    each tile's output is a copy.  With several devices the blocks'
    outputs are concatenated in row order on the first device
    (device-to-device copies, which do not wait on the host)."""
    return TileProgram(N=N, L=L, K=K, P=P, m=m, n=n, g=g, B=B, A=A,
                       devices=devices)
