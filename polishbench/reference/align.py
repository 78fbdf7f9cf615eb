"""Sequence-to-graph alignment, linear gap (NumPy oracle).

Matches the reference engine's linear DP exactly (reference
external/spoa/src/sisd_alignment_engine.cpp:263-439), including HyPo's
added alignment modes:

- NW  : global/global
- LOV : global start, best score forced in the last query column on any
        graph row (sisd_alignment_engine.cpp:338-339), NW-style backtrack
- ROV : free graph start (first column zeroed, :237-239), best at last
        query column on terminal nodes (:332-334), OV-style backtrack
- OV / SW : stock spoa modes (kept for completeness/tests)

Row recurrences are vectorized over the query dimension; the in-row
horizontal dependency H[j] = max(H[j-1]+g, H[j]) is solved with the
running-max identity H[j] = j*g + cummax(val[j'] - j'*g) — exact in
integer arithmetic.  Traceback reproduces spoa's first-predecessor-wins
tie order (diag pred0, diag others, vertical pred0, vertical others,
horizontal).

HyPo always constructs linear engines (3-arg createAlignmentEngine =>
e==g => kLinear, alignment_engine.cpp:52-61), so linear is the parity
path; affine/convex are not implemented.

Frozen copy of hypo_tpu_torch/poa/align.py (the port's copy of
hypo_tpu/poa/align.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .graph import Alignment, Graph

NW, LOV, ROV, OV, SW = range(5)

NEG_INF = -(2 ** 31)  # effectively -inf for int64 accumulation


class PoaAligner:
    def __init__(self, match: int, mismatch: int, gap: int):
        assert gap <= 0, "gap penalty must be non-positive"
        self.m = match
        self.n = mismatch
        self.g = gap

    def align(self, seq: str, graph: Graph, mode: int) -> Alignment:
        if not graph.nodes or not seq:
            return []
        g = self.g
        L = len(seq)
        width = L + 1
        nodes = graph.nodes
        rank_of = [0] * len(nodes)
        for r, nid in enumerate(graph.rank_to_node_id):
            rank_of[nid] = r

        # profile[code][j+1] = match/mismatch score of seq[j] vs code
        seq_arr = np.frombuffer(seq.encode("latin1"), dtype=np.uint8)
        prof = np.empty((graph.num_codes, width), dtype=np.int64)
        prof[:, 0] = 0
        for code in range(graph.num_codes):
            ch = ord(graph.decoder[code])
            prof[code, 1:] = np.where(seq_arr == ch, self.m, self.n)

        H = np.empty((len(nodes) + 1, width), dtype=np.int64)
        jj = np.arange(width, dtype=np.int64)
        # -- initialization (sisd_alignment_engine.cpp:165-243) -----------
        H[0, 0] = 0
        if mode in (NW, LOV, OV, ROV):
            H[0, 1:] = jj[1:] * g
        else:  # SW
            H[0, 1:] = 0
        if mode in (NW, LOV):
            for nid in graph.rank_to_node_id:
                i = rank_of[nid] + 1
                edges = nodes[nid].in_edges
                if not edges:
                    penalty = 0
                else:
                    penalty = max(H[rank_of[e.begin] + 1, 0] for e in edges)
                H[i, 0] = penalty + g
        else:  # SW, OV, ROV: free graph start
            H[1:, 0] = 0

        # -- row sweep ----------------------------------------------------
        max_score = 0 if mode == SW else NEG_INF
        max_i = -1
        max_j = -1
        for nid in graph.rank_to_node_id:
            node = nodes[nid]
            i = rank_of[nid] + 1
            cp = prof[node.code]
            preds = ([0] if not node.in_edges
                     else [rank_of[e.begin] + 1 for e in node.in_edges])
            Hp = H[preds[0]]
            row = np.maximum(Hp[:-1] + cp[1:], Hp[1:] + g)
            for p in preds[1:]:
                Hp = H[p]
                np.maximum(row, Hp[:-1] + cp[1:], out=row)
                np.maximum(row, Hp[1:] + g, out=row)
            # horizontal pass
            if mode == SW:
                h = H[i, 0]
                out = H[i]
                for j in range(1, width):
                    h = max(row[j - 1], h + g, 0)
                    out[j] = h
                    if max_score < h:
                        max_score, max_i, max_j = h, i, j
            else:
                val = np.empty(width, dtype=np.int64)
                val[0] = H[i, 0]
                val[1:] = row
                run = np.maximum.accumulate(val - jj * g)
                H[i, 1:] = run[1:] + jj[1:] * g
                if mode in (NW, ROV):
                    if not node.out_edges and H[i, L] > max_score:
                        max_score, max_i, max_j = H[i, L], i, L
                elif mode == LOV:
                    if H[i, L] > max_score:
                        max_score, max_i, max_j = H[i, L], i, L
                elif mode == OV:
                    if not node.out_edges:
                        jbest = int(np.argmax(H[i, 1:])) + 1
                        if H[i, jbest] > max_score:
                            max_score, max_i, max_j = H[i, jbest], i, jbest

        return self._backtrack(H, graph, rank_of, mode, max_i, max_j, prof,
                               width)

    # -- traceback (sisd_alignment_engine.cpp:344-438) --------------------
    def _backtrack(self, H, graph: Graph, rank_of, mode: int, max_i: int,
                   max_j: int, prof, width: int) -> Alignment:
        g = self.g
        nodes = graph.nodes
        rank_to_node_id = graph.rank_to_node_id
        alignment: List[Tuple[int, int]] = []
        i = max(0, max_i)
        j = max(0, max_j)

        def keep_going() -> bool:
            if mode == SW:
                return H[i, j] != 0
            if mode in (NW, LOV):
                return not (i == 0 and j == 0)
            return not (i == 0 or j == 0)  # OV, ROV

        while keep_going():
            h_ij = H[i, j]
            prev_i = prev_j = 0
            found = False
            if i != 0 and j != 0:
                node = nodes[rank_to_node_id[i - 1]]
                match_cost = prof[node.code, j]
                preds = ([0] if not node.in_edges else
                         [rank_of[e.begin] + 1 for e in node.in_edges])
                for p in preds:
                    if h_ij == H[p, j - 1] + match_cost:
                        prev_i, prev_j, found = p, j - 1, True
                        break
            if not found and i != 0:
                node = nodes[rank_to_node_id[i - 1]]
                preds = ([0] if not node.in_edges else
                         [rank_of[e.begin] + 1 for e in node.in_edges])
                for p in preds:
                    if h_ij == H[p, j] + g:
                        prev_i, prev_j, found = p, j, True
                        break
            if not found and h_ij == H[i, j - 1] + g:
                prev_i, prev_j, found = i, j - 1, True
            alignment.append((
                -1 if i == prev_i else rank_to_node_id[i - 1],
                -1 if j == prev_j else j - 1))
            i, j = prev_i, prev_j

        alignment.reverse()
        return alignment
