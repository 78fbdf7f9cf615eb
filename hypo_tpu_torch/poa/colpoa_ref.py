"""Executable NumPy specification of the column-POA algorithm that the
on-device full POA kernel (hypo_tpu.poa.device_full) implements.

This is the tie-exact host twin of the device kernel: the kernel's
results must equal this module's results bit-for-bit, and the tests
enforce that.  It is NOT the spoa-semantics oracle (hypo_tpu.poa.graph)
— column-POA makes two deliberately different (but deterministic)
tie-breaking choices, documented here:

1. Topological order.  spoa re-runs a DFS per added sequence
   (reference external/spoa/src/graph.cpp:293-353); column-POA instead
   assigns every node to an alignment *column* and orders nodes by
   (column position, node creation id).  Column positions are kept
   sorted with one integer-key argsort per merge: an inserted run of
   bases between matched columns cp and cn gets keys
   ``pos(cp)*(L+2) + q`` (q = offset within the run), existing columns
   keep ``pos*(L+2)``; sorting and renumbering restores 0..C-1.
   This is a valid topological order because an alignment path visits
   columns in strictly increasing position order and no edge ever
   connects two nodes of the same column.

2. Edge weights count sequences (spoa counts 2 per sequence for
   interior edges with unit base weights — reference
   external/spoa/src/graph.cpp:154-271 via add_edge(prev+cur);
   the factor 2 cancels in every comparison the consensus makes).

Everything else mirrors the adapted spoa semantics: node/edge fusion on
alignment (graph.cpp:206-265), heaviest-bundle consensus with spoa's
tie rule and branch completion (graph.cpp:610-705), and per-node
support counts serving generate_consensus_custom (graph.cpp:533-568,
the count of sequences whose aligned base equals the consensus base).

Copied from hypo_tpu/poa/colpoa_ref.py.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

NW, LOV, ROV = 0, 1, 2
NEG = -(2 ** 30)
NCODES = 6  # A C G T J O


class ColPoa:
    """Single-window column-POA state, plain Python/NumPy loops."""

    def __init__(self, m: int, n: int, g: int):
        self.m, self.n, self.g = m, n, g
        self.node_code: List[int] = []
        self.node_col: List[int] = []
        self.node_sup: List[int] = []
        self.pred_nd: List[List[int]] = []   # per node: pred node ids
        self.pred_w: List[List[int]] = []    # per node: edge seq counts
        self.out_cnt: List[int] = []
        self.col_pos: List[int] = []         # column -> position
        self.col_node: List[List[int]] = []  # column -> node per code
        self.n_seqs = 0

    # -- derived ----------------------------------------------------------
    def order(self) -> List[int]:
        """Node ids in topological (rank) order."""
        return sorted(range(len(self.node_code)),
                      key=lambda i: (self.col_pos[self.node_col[i]], i))

    def _new_node(self, code: int, col: int) -> int:
        nid = len(self.node_code)
        self.node_code.append(code)
        self.node_col.append(col)
        self.node_sup.append(0)
        self.pred_nd.append([])
        self.pred_w.append([])
        self.out_cnt.append(0)
        self.col_node[col][code] = nid
        return nid

    def _new_col(self) -> int:
        cid = len(self.col_pos)
        self.col_pos.append(-1)
        self.col_node.append([-1] * NCODES)
        return cid

    # -- DP (tie-exact with jax_poa._dp_one given the same order) ---------
    def align(self, arm: List[int], mode: int
              ) -> Tuple[List[int], int]:
        """Returns (matched_rank per arm pos: rank or -1, j_stop).
        j_stop = number of leading arm bases left unaligned (ROV only)."""
        order = self.order()
        N = len(order)
        if N == 0:
            return [-1] * len(arm), 0
        rank_of = {nid: r for r, nid in enumerate(order)}
        L = len(arm)
        m, n, g = self.m, self.n, self.g
        H = np.full((N + 1, L + 1), NEG, dtype=np.int64)
        H[0] = np.arange(L + 1) * g
        # bp codes: 0..P-1 diag via pred p, P..2P-1 vert, 2P horiz
        P = max(1, max((len(p) for p in self.pred_nd), default=1))
        bp = np.zeros((N + 1, L + 1), dtype=np.int32)
        for r, nid in enumerate(order):
            preds = self.pred_nd[nid]
            prows = ([rank_of[p] + 1 for p in preds] if preds else [0])
            code = self.node_code[nid]
            Hp = H[prows]                       # [np, L+1]
            prof = np.where(np.array(arm) == code, m, n)
            diag = Hp[:, :-1] + prof[None, :]
            vert = Hp[:, 1:] + g
            tmp = np.max(np.maximum(diag, vert), axis=0)
            col0 = 0 if mode == ROV else int(Hp[:, 0].max()) + g
            row = np.empty(L + 1, dtype=np.int64)
            row[0] = col0
            run = col0
            for j in range(1, L + 1):
                run = max(tmp[j - 1], run + g)
                row[j] = run
            h = row[1:]
            bprow = np.full(L, 2 * P, dtype=np.int32)
            for p in range(len(prows) - 1, -1, -1):
                bprow[vert[p] == h] = P + p
            for p in range(len(prows) - 1, -1, -1):
                bprow[diag[p] == h] = p
            bp0 = P
            if len(prows) > 1:
                vert0 = (Hp[:, 0] + g == col0)
                bp0 = P + (int(np.argmax(vert0)) if vert0.any() else 0)
            bp[r + 1, 0] = bp0
            bp[r + 1, 1:] = bprow
            H[r + 1] = row
        # start cell
        at_L = H[1:, L]
        elig = np.ones(N, dtype=bool)
        if mode != LOV:
            elig = np.array([self.out_cnt[nid] == 0 for nid in order])
        masked = np.where(elig, at_L, NEG)
        i = int(np.argmax(masked)) + 1
        j = L
        matched = [-1] * L
        while True:
            if mode == ROV:
                if i == 0 or j == 0:
                    break
            elif i == 0 and j == 0:
                break
            if i == 0:
                j -= 1
                matched[j] = -1
                continue
            code = bp[i, j]
            nid = order[i - 1]
            preds = self.pred_nd[nid]
            prows = ([rank_of[p] + 1 for p in preds] if preds else [0])
            if code < P:
                matched[j - 1] = i - 1
                i, j = prows[code], j - 1
            elif code < 2 * P:
                i = prows[code - P]
            else:
                matched[j - 1] = -1
                j -= 1
        return matched, j

    # -- merge ------------------------------------------------------------
    def add(self, arm: List[int], mode: int, w: int = 1) -> None:
        """Align and merge one sequence (the oracle's add_alignment with
        the column formulation).  ``w`` merges the arm with multiplicity
        w in one step — equivalent to w sequential adds of an identical
        arm, since the DP never depends on weights and an identical copy
        re-aligns onto its own path (device_full._merge)."""
        L = len(arm)
        if L == 0:
            self.n_seqs += w
            return
        if not self.node_code:
            matched: List[int] = [-1] * L
        else:
            matched, _j_stop = self.align(arm, mode)
        order = self.order()
        Lpad = L + 2
        # per-j resolution
        node_j: List[int] = []
        new_col_keys: List[Tuple[int, int]] = []  # (col id, key)
        last_pos, last_j = -1, -1
        for j in range(L):
            base = arm[j]
            if matched[j] >= 0:
                n0 = order[matched[j]]
                c = self.node_col[n0]
                nid = self.col_node[c][base]
                if nid < 0:
                    nid = self._new_node(base, c)
                last_pos, last_j = self.col_pos[c], j
            else:
                c = self._new_col()
                key = last_pos * Lpad + (j - last_j)
                new_col_keys.append((c, key))
                nid = self._new_node(base, c)
            self.node_sup[nid] += w
            node_j.append(nid)
        # edges
        for j in range(1, L):
            u, v = node_j[j - 1], node_j[j]
            if u in self.pred_nd[v]:
                self.pred_w[v][self.pred_nd[v].index(u)] += w
            else:
                self.pred_nd[v].append(u)
                self.pred_w[v].append(w)
                self.out_cnt[u] += 1
        # renumber columns
        keys = {c: self.col_pos[c] * Lpad for c in range(len(self.col_pos))
                if self.col_pos[c] >= 0}
        for c, k in new_col_keys:
            keys[c] = k
        for pos, c in enumerate(sorted(keys, key=lambda c: keys[c])):
            self.col_pos[c] = pos
        self.n_seqs += w

    # -- consensus (spoa heaviest bundle, graph.cpp:610-705) --------------
    def consensus(self) -> Tuple[List[int], List[int]]:
        """Returns (consensus codes, per-base support counts)."""
        order = self.order()
        nn = len(order)
        if nn == 0:
            return [], []
        scores = {nid: -1 for nid in order}
        scores[-1] = NEG  # defensive; preds[nid] == -1 is unreachable in
        # the tie branch because scores[nid] == w implies an earlier edge
        # already set preds[nid] (w >= 1 > -1 initial score)
        preds: dict = {nid: -1 for nid in order}

        def relax(nid, banned) -> None:
            for p, w in zip(self.pred_nd[nid], self.pred_w[nid]):
                if banned is not None and scores[p] == -1:
                    continue
                if (scores[nid] < w
                        or (scores[nid] == w
                            and scores[preds[nid]] <= scores[p])):
                    scores[nid] = w
                    preds[nid] = p
            if preds[nid] != -1:
                scores[nid] += scores[preds[nid]]

        max_id = order[0]
        for nid in order:
            relax(nid, None)
            if scores[max_id] < scores[nid]:
                max_id = nid
        rank_of = {nid: r for r, nid in enumerate(order)}
        while self.out_cnt[max_id] > 0:
            rank = rank_of[max_id]
            nid0 = max_id
            succs = [v for v in range(len(self.node_code))
                     if nid0 in self.pred_nd[v]]
            for v in succs:
                for p in self.pred_nd[v]:
                    if p != nid0:
                        scores[p] = -1
            max_score = 0
            max_id = 0  # spoa inits to node id 0 (graph.cpp:661)
            for r in range(rank + 1, nn):
                nid = order[r]
                scores[nid] = -1
                preds[nid] = -1
                relax(nid, banned=True)
                if max_score < scores[nid]:
                    max_score = scores[nid]
                    max_id = nid
        out: List[int] = []
        sup: List[int] = []
        while max_id != -1:
            out.append(self.node_code[max_id])
            sup.append(self.node_sup[max_id])
            max_id = preds[max_id]
        out.reverse()
        sup.reverse()
        return out, sup
