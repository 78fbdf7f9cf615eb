"""Partial-order alignment graph with heaviest-bundle consensus.

A from-scratch implementation matching the semantics of the adapted spoa
graph used by the reference (reference external/spoa/src/graph.cpp):

- ``add_alignment``: node/edge fusion with aligned-node groups
  (graph.cpp:154-271)
- ``topological_sort``: stack DFS honoring aligned groups
  (graph.cpp:293-353); rank order determines DP row order, MSA column
  ids and all downstream tie-breaking, so it is reproduced exactly
- ``generate_consensus``: heaviest-bundle traversal with spoa's tie rule
  (graph.cpp:610-705)
- ``generate_consensus_custom``: per-consensus-base count of agreeing
  sequences (the reference's addition, graph.cpp:533-568)

Frozen copy of hypo_tpu_torch/poa/graph.py (the port's copy of
hypo_tpu/poa/graph.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# Alignment: list of (node_id or -1, seq_index or -1)
Alignment = List[Tuple[int, int]]


class Edge:
    __slots__ = ("begin", "end", "labels", "total_weight")

    def __init__(self, begin: int, end: int, label: int, weight: int):
        self.begin = begin
        self.end = end
        self.labels = [label]
        self.total_weight = weight

    def add_sequence(self, label: int, weight: int) -> None:
        self.labels.append(label)
        self.total_weight += weight


class Node:
    __slots__ = ("id", "code", "in_edges", "out_edges", "aligned_ids")

    def __init__(self, nid: int, code: int):
        self.id = nid
        self.code = code
        self.in_edges: List[Edge] = []
        self.out_edges: List[Edge] = []
        self.aligned_ids: List[int] = []

    def successor(self, label: int) -> Optional[int]:
        for edge in self.out_edges:
            if label in edge.labels:
                return edge.end
        return None


class Graph:
    def __init__(self):
        self.num_sequences = 0
        self.num_codes = 0
        self.coder: Dict[str, int] = {}
        self.decoder: List[str] = []
        self.nodes: List[Node] = []
        self.rank_to_node_id: List[int] = []
        self.sequences_begin_nodes_ids: List[int] = []
        self.consensus_ids: List[int] = []

    # -- construction -----------------------------------------------------
    def add_node(self, code: int) -> int:
        nid = len(self.nodes)
        self.nodes.append(Node(nid, code))
        return nid

    def add_edge(self, begin: int, end: int, weight: int) -> None:
        for edge in self.nodes[begin].out_edges:
            if edge.end == end:
                edge.add_sequence(self.num_sequences, weight)
                return
        edge = Edge(begin, end, self.num_sequences, weight)
        self.nodes[begin].out_edges.append(edge)
        self.nodes[end].in_edges.append(edge)

    def _add_stretch(self, seq: str, weights: List[int], begin: int,
                     end: int) -> int:
        """Add an unaligned run of bases as a simple chain; returns the
        first node id or -1 (graph.cpp add_sequence, :273-291)."""
        if begin == end:
            return -1
        first = self.add_node(self.coder[seq[begin]])
        prev = first
        for i in range(begin + 1, end):
            nid = self.add_node(self.coder[seq[i]])
            self.add_edge(nid - 1, nid, weights[i - 1] + weights[i])
            prev = nid
        return first

    def add_alignment(self, alignment: Alignment, seq: str,
                      weight: int = 1) -> None:
        n = len(seq)
        if n == 0:
            return
        weights = [weight] * n
        for ch in seq:
            if ch not in self.coder:
                self.coder[ch] = self.num_codes
                self.decoder.append(ch)
                self.num_codes += 1

        if not alignment:
            begin_id = self._add_stretch(seq, weights, 0, n)
            self.num_sequences += 1
            self.sequences_begin_nodes_ids.append(begin_id)
            self.topological_sort()
            return

        valid = [j for (_i, j) in alignment if j != -1]
        tmp = len(self.nodes)
        begin_id = self._add_stretch(seq, weights, 0, valid[0])
        head_id = -1 if tmp == len(self.nodes) else len(self.nodes) - 1
        tail_id = self._add_stretch(seq, weights, valid[-1] + 1, n)

        new_id = -1
        prev_weight = 0 if head_id == -1 else weights[valid[0] - 1]
        for (node_id, j) in alignment:
            if j == -1:
                continue
            letter = seq[j]
            if node_id == -1:
                new_id = self.add_node(self.coder[letter])
            else:
                nd = self.nodes[node_id]
                if self.decoder[nd.code] == letter:
                    new_id = node_id
                else:
                    aligned_to = -1
                    for aid in nd.aligned_ids:
                        if self.decoder[self.nodes[aid].code] == letter:
                            aligned_to = aid
                            break
                    if aligned_to == -1:
                        new_id = self.add_node(self.coder[letter])
                        for aid in nd.aligned_ids:
                            self.nodes[new_id].aligned_ids.append(aid)
                            self.nodes[aid].aligned_ids.append(new_id)
                        self.nodes[new_id].aligned_ids.append(node_id)
                        nd.aligned_ids.append(new_id)
                    else:
                        new_id = aligned_to
            if begin_id == -1:
                begin_id = new_id
            if head_id != -1:
                self.add_edge(head_id, new_id, prev_weight + weights[j])
            head_id = new_id
            prev_weight = weights[j]

        if tail_id != -1:
            self.add_edge(head_id, tail_id,
                          prev_weight + weights[valid[-1] + 1])
        self.num_sequences += 1
        self.sequences_begin_nodes_ids.append(begin_id)
        self.topological_sort()

    # -- ordering ---------------------------------------------------------
    def topological_sort(self) -> None:
        """Stack DFS with aligned-group interleaving (graph.cpp:293-353).
        The rank order this produces is load-bearing for parity."""
        self.rank_to_node_id = []
        n = len(self.nodes)
        marks = [0] * n  # 0 unmarked, 1 temporary, 2 permanent
        check_aligned = [True] * n
        for i in range(n):
            if marks[i] != 0:
                continue
            stack = [i]
            while stack:
                nid = stack[-1]
                valid = True
                if marks[nid] != 2:
                    for edge in self.nodes[nid].in_edges:
                        if marks[edge.begin] != 2:
                            stack.append(edge.begin)
                            valid = False
                    if check_aligned[nid]:
                        for aid in self.nodes[nid].aligned_ids:
                            if marks[aid] != 2:
                                stack.append(aid)
                                check_aligned[aid] = False
                                valid = False
                    assert valid or marks[nid] != 1, "graph is not a DAG"
                    if valid:
                        marks[nid] = 2
                        if check_aligned[nid]:
                            self.rank_to_node_id.append(nid)
                            for aid in self.nodes[nid].aligned_ids:
                                self.rank_to_node_id.append(aid)
                    else:
                        marks[nid] = 1
                if valid:
                    stack.pop()

    def init_msa_ids(self) -> Tuple[List[int], int]:
        """node_id -> msa column id; aligned groups share a column
        (graph.cpp:371-388)."""
        ids = [0] * len(self.nodes)
        msa_id = 0
        i = 0
        r = self.rank_to_node_id
        while i < len(r):
            nid = r[i]
            ids[nid] = msa_id
            for _ in self.nodes[nid].aligned_ids:
                i += 1
                ids[r[i]] = msa_id
            msa_id += 1
            i += 1
        return ids, msa_id

    # -- consensus --------------------------------------------------------
    def _traverse_heaviest_bundle(self) -> None:
        n = len(self.nodes)
        predecessors = [-1] * n
        scores = [-1] * n
        max_score_id = 0
        for nid in self.rank_to_node_id:
            for edge in self.nodes[nid].in_edges:
                if (scores[nid] < edge.total_weight
                        or (scores[nid] == edge.total_weight
                            and scores[predecessors[nid]]
                            <= scores[edge.begin])):
                    scores[nid] = edge.total_weight
                    predecessors[nid] = edge.begin
            if predecessors[nid] != -1:
                scores[nid] += scores[predecessors[nid]]
            if scores[max_score_id] < scores[nid]:
                max_score_id = nid

        if self.nodes[max_score_id].out_edges:
            node_id_to_rank = [0] * n
            for r, nid in enumerate(self.rank_to_node_id):
                node_id_to_rank[nid] = r
            while self.nodes[max_score_id].out_edges:
                max_score_id = self._branch_completion(
                    scores, predecessors, node_id_to_rank[max_score_id])

        self.consensus_ids = []
        while predecessors[max_score_id] != -1:
            self.consensus_ids.append(max_score_id)
            max_score_id = predecessors[max_score_id]
        self.consensus_ids.append(max_score_id)
        self.consensus_ids.reverse()

    def _branch_completion(self, scores: List[int],
                           predecessors: List[int], rank: int) -> int:
        node_id = self.rank_to_node_id[rank]
        for edge in self.nodes[node_id].out_edges:
            for o_edge in self.nodes[edge.end].in_edges:
                if o_edge.begin != node_id:
                    scores[o_edge.begin] = -1
        max_score = 0
        max_score_id = 0
        for i in range(rank + 1, len(self.rank_to_node_id)):
            nid = self.rank_to_node_id[i]
            scores[nid] = -1
            predecessors[nid] = -1
            for edge in self.nodes[nid].in_edges:
                if scores[edge.begin] == -1:
                    continue
                if (scores[nid] < edge.total_weight
                        or (scores[nid] == edge.total_weight
                            and scores[predecessors[nid]]
                            <= scores[edge.begin])):
                    scores[nid] = edge.total_weight
                    predecessors[nid] = edge.begin
            if predecessors[nid] != -1:
                scores[nid] += scores[predecessors[nid]]
            if max_score < scores[nid]:
                max_score = scores[nid]
                max_score_id = nid
        return max_score_id

    def generate_consensus(self) -> str:
        self._traverse_heaviest_bundle()
        return "".join(self.decoder[self.nodes[nid].code]
                       for nid in self.consensus_ids)

    def generate_consensus_custom(self) -> Tuple[str, List[int]]:
        """Consensus plus, per consensus base, the number of sequences
        whose aligned base agrees (graph.cpp:533-568)."""
        consensus_str = self.generate_consensus()
        dst = [0] * len(self.consensus_ids)
        msa_ids, _ = self.init_msa_ids()
        cons_msa = [msa_ids[nid] for nid in self.consensus_ids]
        for i in range(self.num_sequences):
            node_id = self.sequences_begin_nodes_ids[i]
            if node_id == -1:
                continue
            c = 0
            while True:
                while (c < len(self.consensus_ids)
                       and cons_msa[c] < msa_ids[node_id]):
                    c += 1
                if c >= len(self.consensus_ids):
                    break
                if cons_msa[c] == msa_ids[node_id]:
                    letter = self.decoder[self.nodes[node_id].code]
                    if letter == consensus_str[c]:
                        dst[c] += 1
                nxt = self.nodes[node_id].successor(i)
                if nxt is None:
                    break
                node_id = nxt
        return consensus_str, dst

    def generate_consensus_custom2(self, interesting: List[int]
                                   ) -> Tuple[str, List[int]]:
        """Like generate_consensus_custom but counting only the sequence
        labels in ``interesting`` (HyPo-added spoa graph.cpp:571-606;
        defined for subset-curated long windows)."""
        consensus_str = self.generate_consensus()
        dst = [0] * len(self.consensus_ids)
        msa_ids, _ = self.init_msa_ids()
        cons_msa = [msa_ids[nid] for nid in self.consensus_ids]
        for i in interesting:
            node_id = self.sequences_begin_nodes_ids[i]
            if node_id == -1:
                continue
            c = 0
            while True:
                while (c < len(self.consensus_ids)
                       and cons_msa[c] < msa_ids[node_id]):
                    c += 1
                if c >= len(self.consensus_ids):
                    break
                if cons_msa[c] == msa_ids[node_id]:
                    letter = self.decoder[self.nodes[node_id].code]
                    if letter == consensus_str[c]:
                        dst[c] += 1
                nxt = self.nodes[node_id].successor(i)
                if nxt is None:
                    break
                node_id = nxt
        return consensus_str, dst

    def generate_msa_custom(self, interesting: List[int]) -> List[str]:
        """MSA rows for the sequence labels in ``interesting`` only
        (HyPo-added spoa graph.cpp:391-427)."""
        msa_ids, msa_len = self.init_msa_ids()
        out = []
        for i in interesting:
            row = ["-"] * msa_len
            nid = self.sequences_begin_nodes_ids[i]
            if nid != -1:
                while True:
                    row[msa_ids[nid]] = self.decoder[self.nodes[nid].code]
                    nxt = self.nodes[nid].successor(i)
                    if nxt is None:
                        break
                    nid = nxt
            out.append("".join(row))
        return out

    def generate_msa(self, include_consensus: bool = False) -> List[str]:
        """Multiple sequence alignment strings (graph.cpp:429-465)."""
        msa_ids, msa_len = self.init_msa_ids()
        out = []
        for i in range(self.num_sequences):
            row = ["-"] * msa_len
            nid = self.sequences_begin_nodes_ids[i]
            if nid != -1:
                while True:
                    row[msa_ids[nid]] = self.decoder[self.nodes[nid].code]
                    nxt = self.nodes[nid].successor(i)
                    if nxt is None:
                        break
                    nid = nxt
            out.append("".join(row))
        if include_consensus:
            self._traverse_heaviest_bundle()
            row = ["-"] * msa_len
            for nid in self.consensus_ids:
                row[msa_ids[nid]] = self.decoder[self.nodes[nid].code]
            out.append("".join(row))
        return out
