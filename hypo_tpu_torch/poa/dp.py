"""Plain PyTorch graph-vs-arm DP and traceback: the reference versions
of the CUDA kernels csrc/poa_dp.cu (poa.cuda_poa.poa_dp_batch) and
csrc/poa_tb.cu (poa.cuda_tb.poa_tb_batch and poa_tb_matched, the
traceback's two emitters), plus the host-side helpers of exact mode
(hypo_tpu.poa.jax_poa:40-41, 184-228, 231-254, copied because jax_poa
imports jax).

Counterpart of hypo_tpu.poa.jax_poa.poa_dp_batch / _dp_one (:44-65,
122-181), jax_poa.poa_dp_tb_batch (:68-119),
hypo_tpu.poa.device_full._dp (:196-244) and
device_full._traceback_matched_batch (:247-307).  The vmap over windows
is the batch dimension written out; the lax.scan over rows is a Python
loop that stops at the largest graph of the batch, and each traceback's
while_loop a lockstep loop over the batch.

Cells are int32 with the NEG16 sentinel of the Pallas kernel, so every
cell equals the JAX versions' (int16 in jax_poa, int32 with NEG = -2**30
in device_full._dp).  For the tile classes a sentinel-derived value
never ties a reachable one, because |cell| <= |g| * (N + L) < 16384.
Exact mode's largest short-score bucket (N = L = 1024, |g| = 8) reaches
that bound; there int16 still cannot wrap (every cell is >= the
all-gap path's -16384), so the port and jax_poa agree cell for cell
(tests/test_torch_tb.py holds them equal at that bucket).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import GLOBAL_CODE, LOV, NEG16, NW, ROV

# ASCII byte -> global code; 255 marks a byte outside the alphabet
_GLOBAL_LUT = np.full(256, 255, np.uint8)
for _c, _v in GLOBAL_CODE.items():
    _GLOBAL_LUT[ord(_c)] = _v


def encode_global(seq: str) -> np.ndarray:
    """Global codes (A C G T J O -> 0..5) of ``seq`` as int32; raises
    KeyError on any other letter, as jax_poa.encode_global does."""
    codes = _GLOBAL_LUT[np.frombuffer(seq.encode("latin1"), np.uint8)]
    if len(codes) and codes.max() == 255:
        raise KeyError(next(c for c in seq if c not in GLOBAL_CODE))
    return codes.astype(np.int32)


def alignment_from_steps(ti: np.ndarray, tj: np.ndarray, steps: int,
                         rank_ids: np.ndarray) -> List[Tuple[int, int]]:
    """Convert a device traceback (backward order, ranks) into the
    alignment pair list (forward order, node ids)."""
    ti = ti[:steps][::-1].astype(np.int64)
    tj = tj[:steps][::-1].astype(np.int64)
    nodes = np.where(ti < 0, -1, rank_ids[np.maximum(ti, 0)])
    return list(zip(nodes.tolist(), tj.tolist()))


def traceback_from_bp(bp: np.ndarray, pred_rows: np.ndarray,
                      rank_to_node_id: List[int], arm_len: int, mode: int,
                      max_row: int, P: int) -> List[Tuple[int, int]]:
    """Host pointer walk of one window's backpointer plane bp [N+1, L+1]
    from (max_row, arm_len); mirrors the oracle traceback loop structure
    (row 0 can only move horizontally, H[0,j] = j*g).  Returns the
    alignment pairs (node id or -1, arm position or -1) in forward order.
    Copied from hypo_tpu.poa.jax_poa.traceback_from_bp (:194-228)."""
    i = int(max_row)
    j = int(arm_len)
    alignment: List[Tuple[int, int]] = []
    while True:
        if mode in (NW, LOV):
            if i == 0 and j == 0:
                break
        else:  # ROV
            if i == 0 or j == 0:
                break
        if i == 0:
            alignment.append((-1, j - 1))
            j -= 1
            continue
        code = int(bp[i, j])
        if code < P:          # diagonal
            prev_i = int(pred_rows[i - 1, code])
            prev_j = j - 1
        elif code < 2 * P:    # vertical
            prev_i = int(pred_rows[i - 1, code - P])
            prev_j = j
        else:                 # horizontal
            prev_i = i
            prev_j = j - 1
        alignment.append((
            -1 if prev_i == i else rank_to_node_id[i - 1],
            -1 if prev_j == j else j - 1))
        i, j = prev_i, prev_j
    alignment.reverse()
    return alignment


def extract_graph_arrays(graph, N: int, P: int):
    """Flatten a host ``poa.graph.Graph`` into the fixed-shape arrays
    the DP consumes: (node_code, pred_rows, pred_cnt, is_end, n_nodes),
    or None if the graph exceeds the (N, P) caps."""
    nn = len(graph.rank_to_node_id)
    if nn > N:
        return None
    rank_of = {nid: r for r, nid in enumerate(graph.rank_to_node_id)}
    node_code = np.zeros(N, dtype=np.int32)
    pred_rows = np.zeros((N, P), dtype=np.int32)
    pred_cnt = np.ones(N, dtype=np.int32)
    is_end = np.zeros(N, dtype=bool)
    for r, nid in enumerate(graph.rank_to_node_id):
        node = graph.nodes[nid]
        node_code[r] = GLOBAL_CODE[graph.decoder[node.code]]
        if node.in_edges:
            if len(node.in_edges) > P:
                return None
            pred_cnt[r] = len(node.in_edges)
            for p, e in enumerate(node.in_edges):
                pred_rows[r, p] = rank_of[e.begin] + 1
        is_end[r] = not node.out_edges
    return node_code, pred_rows, pred_cnt, is_end, nn


def poa_dp_batch_ref(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm,
                     arm_len, mode, *, N: int, L: int, P: int, m: int,
                     n: int, g: int):
    """One DP round for a batch of windows.

    node_code [B,N] i32 (rank order, global codes); pred_rows [B,N,P] i32
    (H-row of each predecessor = rank + 1, 0 = the virtual start row);
    pred_cnt [B,N] i32 (>= 1); is_end [B,N] bool; n_nodes [B] i32
    (0 = window inactive); arm [B,L] i32; arm_len [B] i32; mode [B] i32
    (NW / LOV / ROV).

    Returns (bp int8 [B,N+1,L+1], max_row int32 [B]).  bp codes:
    0..P-1 diagonal via predecessor p, P..2P-1 vertical via p, 2P
    horizontal; the first hit in that order wins.  Rows above a window's
    n_nodes are left 0 (callers read only rows <= n_nodes).  max_row is
    1 + the first row with the highest score in column arm_len among the
    eligible rows (end nodes for NW/ROV, every valid node for LOV), and 1
    when no row is eligible.
    """
    B = node_code.shape[0]
    dev = node_code.device
    i32 = torch.int32
    jjg = torch.arange(L + 1, dtype=i32, device=dev) * g
    H = torch.full((B, N + 1, L + 1), NEG16, dtype=i32, device=dev)
    H[:, 0] = jjg
    bp = torch.zeros((B, N + 1, L + 1), dtype=torch.int8, device=dev)
    parange = torch.arange(P, dtype=i32, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    rov = mode == ROV
    nmax = int(n_nodes.max()) if B else 0
    for r in range(nmax):
        Hp = H[bidx, pred_rows[:, r].long()]                    # [B,P,L+1]
        pvalid = parange[None, :] < pred_cnt[:, r, None]
        Hp = torch.where(pvalid[:, :, None], Hp, NEG16)
        prof = torch.where(arm == node_code[:, r, None], m, n).to(i32)
        diag = Hp[:, :, :-1] + prof[:, None, :]
        vert = Hp[:, :, 1:] + g
        tmp = torch.maximum(diag, vert).amax(dim=1)             # [B,L]
        col0 = torch.where(rov, 0, Hp[:, :, 0].amax(dim=1) + g).to(i32)
        val = torch.cat([col0[:, None], tmp], dim=1)
        row = torch.cummax(val - jjg, dim=1).values + jjg
        H[:, r + 1] = row
        h = row[:, 1:]
        bp_j = torch.full((B, L), 2 * P, dtype=torch.int8, device=dev)
        for p in range(P - 1, -1, -1):
            bp_j = torch.where(vert[:, p] == h, P + p, bp_j)
        for p in range(P - 1, -1, -1):
            bp_j = torch.where(diag[:, p] == h, p, bp_j)
        # column 0: vertical via the first predecessor that produced col0
        vert0 = (Hp[:, :, 0] + g) == col0[:, None]              # [B,P]
        bp0 = torch.where(vert0.any(dim=1),
                          P + vert0.to(i32).argmax(dim=1), P)
        bp[:, r + 1, 0] = bp0.to(torch.int8)
        bp[:, r + 1, 1:] = bp_j
    col = arm_len.clamp(0, L).long()[:, None, None].expand(B, N, 1)
    at_L = H[:, 1:].gather(2, col)[:, :, 0]                     # [B,N]
    valid_row = (torch.arange(N, device=dev)[None, :]
                 < n_nodes[:, None])
    elig = torch.where((mode == LOV)[:, None], valid_row,
                       valid_row & is_end)
    masked = torch.where(elig, at_L, NEG16)
    max_row = (masked.argmax(dim=1) + 1).to(i32)
    return bp, max_row


# the lockstep traceback checks "every window stopped" (a host sync)
# only every this many steps; extra steps are no-ops for stopped windows
_TB_CHECK_EVERY = 32


def poa_tb_batch_ref(bp, pred_rows, max_row, arm_len, mode, *, N: int,
                     L: int, P: int):
    """Backpointer walk of every window, from (max_row, arm_len) to the
    stop cell: (0, 0) for NW / LOV, row 0 or column 0 for ROV.  Row 0
    moves only horizontally; a diagonal move emits (i-1, j-1), a
    vertical one (i-1, -1), a horizontal one (-1, j-1).

    bp int8 [B,N+1,L+1] and max_row [B] as poa_dp_batch returns them;
    pred_rows [B,N,P], arm_len [B], mode [B] i32.  Returns (ti int16
    [B,S], tj int16 [B,S], steps int32 [B]), S = N + L + 1: the emitted
    graph rank (or -1) and query index (or -1) of each step in backward
    order, -2 past ``steps``.  Every index read is clamped into its
    array, so no input reads out of bounds."""
    B = bp.shape[0]
    dev = bp.device
    S = N + L + 1
    W = L + 1
    ti = torch.full((B, S), -2, dtype=torch.int16, device=dev)
    tj = torch.full((B, S), -2, dtype=torch.int16, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    bpf = bp.reshape(B, -1)
    prf = pred_rows.reshape(B, -1)
    rov = mode == ROV
    i = max_row.clamp(0, N).long()
    j = arm_len.clamp(0, L).long()
    for t in range(S):
        live = ~torch.where(rov, (i == 0) | (j == 0), (i == 0) & (j == 0))
        if t % _TB_CHECK_EVERY == 0 and not bool(live.any()):
            break
        code = bpf.gather(1, (i * W + j.clamp(0, L))[:, None])[:, 0].long()
        is_vert = (code >= P) & (code < 2 * P)
        is_horiz = code == 2 * P
        pidx = torch.where(code < P, code, code - P).clamp(0, P - 1)
        pred = prf.gather(1, ((i - 1).clamp(min=0) * P + pidx)[:, None])
        pred = pred[:, 0].long().clamp(0, N)
        top = i == 0
        prev_i = torch.where(top, 0, torch.where(is_horiz, i, pred))
        prev_j = torch.where(top | ~is_vert, j - 1, j)
        er = torch.where(prev_i == i, -1, i - 1)
        ej = torch.where(prev_j == j, -1, j - 1)
        ti[:, t] = torch.where(live, er, -2).to(torch.int16)
        tj[:, t] = torch.where(live, ej, -2).to(torch.int16)
        steps += live.to(torch.int32)
        i = torch.where(live, prev_i, i)
        j = torch.where(live, prev_j, j)
    return ti, tj, steps


def poa_tb_matched_ref(bp, pred_rows, arm_len, mode, max_row, active, *,
                       N: int, L: int, P: int):
    """The tile program's backpointer walk, the same walk as
    poa_tb_batch_ref with another emitter: returns matched int32 [B, L],
    the rank of the graph node arm base j aligned to, or -1 (insertion /
    unaligned head).  A step emits when it consumes a base (its column
    changes, j >= 1): the rank i - 1 if it is diagonal (the row changes
    too, i > 0), else -1.  Windows not ``active`` (bool [B]) start
    stopped, so their rows are all -1 whatever their bp holds."""
    B = bp.shape[0]
    dev = bp.device
    bpf = bp.reshape(B, -1)
    prf = pred_rows.reshape(B, -1)
    ncell = (N + 1) * (L + 1)
    rov = mode == ROV

    def stop_of(i, j):
        return torch.where(rov, (i == 0) | (j == 0), (i == 0) & (j == 0))

    def take(x, idx):
        return x.gather(1, idx[:, None].long())[:, 0]

    i, j = max_row, arm_len
    stopped = stop_of(i, j) | ~active
    # column L parks the writes of steps that consume no arm base
    matched = torch.full((B, L + 1), -1, dtype=torch.int32, device=dev)
    for t in range(N + L + 1):
        if t % _TB_CHECK_EVERY == 0 and bool(stopped.all()):
            break
        code = take(bpf, (i * (L + 1) + j).clamp(0, ncell - 1)).to(
            torch.int32)
        is_vert = (code >= P) & (code < 2 * P)
        is_horiz = code == 2 * P
        pidx = torch.where(code < P, code, code - P).clamp(0, P - 1)
        pred = take(prf, (i - 1).clamp(min=0) * P + pidx)
        prev_i = torch.where(is_horiz, i, pred)
        prev_j = torch.where(is_vert, j, j - 1)
        prev_i = torch.where(i == 0, 0, prev_i)
        prev_j = torch.where(i == 0, j - 1, prev_j)
        emit = (prev_j != j) & ~stopped & (j >= 1)     # a base consumed
        diag = emit & (prev_i != i) & (i > 0)          # aligned to i-1
        rec_j = torch.where(emit, j - 1, L)
        rec_r = torch.where(diag, i - 1, -1).to(torch.int32)
        matched.scatter_(1, rec_j[:, None].long(), rec_r[:, None])
        i = torch.where(stopped, i, prev_i)
        j = torch.where(stopped, j, prev_j)
        stopped = stopped | stop_of(i, j)
    return matched[:, :L].contiguous()


def poa_dp_tb_batch_ref(node_code, pred_rows, pred_cnt, is_end, n_nodes,
                        arm, arm_len, mode, *, N: int, L: int, P: int,
                        m: int, n: int, g: int):
    """The DP then the traceback, plainly (jax_poa.poa_dp_tb_batch):
    returns (ti, tj, steps, max_row)."""
    bp, max_row = poa_dp_batch_ref(node_code, pred_rows, pred_cnt, is_end,
                                   n_nodes, arm, arm_len, mode, N=N, L=L,
                                   P=P, m=m, n=n, g=g)
    ti, tj, steps = poa_tb_batch_ref(bp, pred_rows, max_row, arm_len, mode,
                                     N=N, L=L, P=P)
    return ti, tj, steps, max_row
