"""Plain PyTorch graph-vs-arm DP: the reference version of the CUDA DP
kernel (csrc/poa_dp.cu, wrapped by poa.cuda_poa.poa_dp_batch).

Counterpart of hypo_tpu.poa.jax_poa.poa_dp_batch / _dp_one (:44-65,
122-181) and hypo_tpu.poa.device_full._dp (:196-244).  The vmap over
windows is the batch dimension written out; the lax.scan over rows is
a Python loop that stops at the largest graph of the batch.

Cells are int32 with the NEG16 sentinel of the Pallas kernel, so every
reachable cell equals the JAX versions' (int16 in jax_poa, int32 with
NEG = -2**30 in device_full._dp): a sentinel-derived value never ties a
reachable one, because |cell| <= |g| * (N + L) < 16384 for both shape
classes.
"""
from __future__ import annotations

import torch

from . import LOV, NEG16, ROV


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
