"""Exact mode (``--device-poa-mode exact``): window consensus with the
graph-vs-arm DP and traceback on a PyTorch device and the graph merges
on the host; the port of hypo_tpu.poa.batch.

All windows advance in lockstep arm rounds.  Round r groups the r-th
sequence of every still-active window into (scores, N, L, P) buckets
and runs one device call per bucket (poa.cuda_tb.poa_dp_tb_batch:
kernel 1, the DP, then kernel 3, the traceback), then merges each
traceback into its window's host graph (native.NativeGraph, or the
Python poa.graph.Graph without the native library).  The first sequence of a
window needs no DP.  Windows whose graph outgrows the largest bucket
finish on the host aligner, so the consensus always equals the host
engine's.  LONG windows run their two curated rounds (long1, long2) on
the device like short ones: this is the path that puts them there.

Unlike the JAX runner, a group is launched at its exact size: padding
to a power of two served only XLA's shape cache, and no window's result
depends on it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ScoreParams
from ..dna import decode
from . import LOV, NW, ROV
from .align import PoaAligner
from .cuda_poa import check_scores
from .cuda_tb import poa_dp_tb_batch
from .dp import alignment_from_steps, encode_global, extract_graph_arrays
from .engine import CURATE_THRESH, HEAD, TAIL
from .graph import Graph

N_CAPS = (64, 128, 256, 512, 1024)
L_CAPS = (64, 128, 256, 512, 1024)
P_CAPS = (1, 2, 4, 8)
P_CAP = 8


def _cap_for(v: int, caps) -> Optional[int]:
    for c in caps:
        if v <= c:
            return c
    return None


class _Job:
    __slots__ = ("window", "seqs", "scores", "graph", "cursor", "kind",
                 "ext")

    def __init__(self, window, seqs, scores, kind, use_native: bool):
        self.window = window
        self.seqs = seqs          # list of (seq_str, mode)
        self.scores = scores      # (m, n, g)
        if use_native:
            from ..native import NativeGraph
            self.graph = NativeGraph()
        else:
            self.graph = Graph()
        self.cursor = 0
        self.kind = kind          # "short" | "long1" | "long2"
        self.ext = None           # cached graph arrays for this round


class DeviceConsensusRunner:
    """Exact-mode runner computing on ``device`` (a CUDA device; CPU
    tensors in tests).  ``fix_long_align_type`` aligns a LONG window's
    prefix arms LOV and its suffix arms ROV, in both of its rounds (the
    reference aligns them NW: README, "Reference quirks");
    ``use_native`` picks the host graphs, NativeGraph or the Python
    Graph (None: NativeGraph when the native library is available), as
    in hypo_tpu's runner.  ``stats``: device_rounds (device calls),
    device_aligns (arms aligned on the device), long_aligns (those of
    them from LONG windows) and host_fallbacks (windows finished on the
    host aligner)."""

    # kernels warm() builds
    KERNELS: Tuple[str, ...] = ("poa_dp", "poa_tb")

    def __init__(self, sp: ScoreParams, device,
                 fix_long_align_type: bool = False, use_native: bool = None):
        self.sp = sp
        self.device = torch.device(device)
        self.short_scores = (sp.sr_match, sp.sr_mismatch, sp.sr_gap)
        self.long_scores = (sp.lr_match, sp.lr_mismatch, sp.lr_gap)
        self.fix_long = fix_long_align_type
        if use_native is None:
            # NativeGraph unless HYPO_TPU_NO_NATIVE or no library
            from ..native import available
            use_native = available()
        self.use_native = use_native
        self.stats = {"device_rounds": 0, "device_aligns": 0,
                      "long_aligns": 0, "host_fallbacks": 0}

    @classmethod
    def check_scores(cls, sp: ScoreParams, long_reads: bool) -> None:
        """Raises ValueError unless the DP kernel's int16 cells hold the
        scores this runner launches at its largest bucket: the short-read
        scores, and the long-read ones when there are long reads."""
        sets = [(sp.sr_match, sp.sr_mismatch, sp.sr_gap)]
        if long_reads:
            sets.append((sp.lr_match, sp.lr_mismatch, sp.lr_gap))
        for m, n, g in sets:
            check_scores(m, n, g, N_CAPS[-1], L_CAPS[-1])

    def warm(self) -> None:
        """Build (or load) the kernels on a CUDA device, so the first
        call pays no build cost.  Build errors propagate."""
        if self.device.type == "cuda":
            from .. import _build
            for name in self.KERNELS:
                _build.load(name)

    # -- job construction (mirrors engine.ConsensusEngine) ----------------
    def _build_job(self, w) -> Optional[_Job]:
        non_empty = w.num_internal + w.num_pre + w.num_suf
        if w.num_empty > non_empty:
            w.consensus = ""
            return None
        if non_empty < 2:
            w.consensus = decode(w.draft)
            return None
        if w.wtype == 0:
            seqs: List[Tuple[str, int]] = []
            if not w.internal_arms:
                seqs.append((HEAD + decode(w.draft) + TAIL, NW))
            arms_added = False
            for a in w.internal_arms:
                if len(a):
                    seqs.append((HEAD + decode(a) + TAIL, NW))
                    arms_added = True
            for a in reversed(w.pre_arms):
                if len(a):
                    seqs.append((HEAD + decode(a), LOV))
                    arms_added = True
            for a in w.suf_arms:
                if len(a):
                    seqs.append((decode(a) + TAIL, ROV))
                    arms_added = True
            if not arms_added:
                w.consensus = decode(w.draft)
                return None
            return _Job(w, seqs, self.short_scores, "short",
                        self.use_native)
        return self._build_long_job(w, backbone=decode(w.draft),
                                    kind="long1")

    def _build_long_job(self, w, backbone: str, kind: str
                        ) -> Optional[_Job]:
        # by default every long arm aligns NW: the reference's quirk
        # (README, "Reference quirks")
        mode_pre = LOV if self.fix_long else NW
        mode_suf = ROV if self.fix_long else NW
        seqs: List[Tuple[str, int]] = []
        if backbone:
            seqs.append((backbone, NW))
        arms_added = False
        for a in w.internal_arms:
            if len(a):
                seqs.append((decode(a), NW))
                arms_added = True
        for a in w.pre_arms:
            if len(a):
                seqs.append((decode(a), mode_pre))
                arms_added = True
        for a in w.suf_arms:
            if len(a):
                seqs.append((decode(a), mode_suf))
                arms_added = True
        if not arms_added:
            w.consensus = decode(w.draft)
            return None
        return _Job(w, seqs, self.long_scores, kind, self.use_native)

    # -- finalization ------------------------------------------------------
    def _finalize(self, job: _Job) -> Optional[_Job]:
        w = job.window
        if job.kind == "short":
            w.consensus = job.graph.generate_consensus()[1:-1]
            return None
        cons, dst = job.graph.generate_consensus_custom()
        th = math.floor(w.num_internal * CURATE_THRESH)
        curated = "".join(c for c, d in zip(cons, dst) if d >= th)
        w.consensus = curated
        if job.kind == "long1":
            return self._build_long_job(w, backbone=curated, kind="long2")
        return None

    # -- host fallback ------------------------------------------------------
    def _host_finish(self, job: _Job) -> Optional[_Job]:
        self.stats["host_fallbacks"] += 1
        if job.cursor == 0:
            # first sequence needs no alignment (empty graph)
            seq, _mode = job.seqs[0]
            job.graph.add_alignment([], seq)
            job.cursor = 1
        if isinstance(job.graph, Graph):
            aligner = PoaAligner(*job.scores)
            while job.cursor < len(job.seqs):
                seq, mode = job.seqs[job.cursor]
                job.graph.add_alignment(
                    aligner.align(seq, job.graph, mode), seq)
                job.cursor += 1
        else:  # native graph aligns natively
            m, n, g = job.scores
            while job.cursor < len(job.seqs):
                seq, mode = job.seqs[job.cursor]
                job.graph.add_alignment(
                    job.graph.align(seq, mode, m, n, g), seq)
                job.cursor += 1
        return self._finalize(job)

    @staticmethod
    def _graph_size(graph) -> int:
        if isinstance(graph, Graph):
            return len(graph.nodes)
        return graph.num_nodes()

    # -- main loop ----------------------------------------------------------
    def run_windows(self, windows) -> int:
        jobs: List[_Job] = []
        count = 0
        for w in windows:
            if w is None:
                continue
            count += 1
            j = self._build_job(w)
            if j is not None:
                jobs.append(j)
        active = jobs
        while active:
            nxt: List[_Job] = []
            groups: Dict[tuple, List[_Job]] = {}
            for job in active:
                if job.cursor >= len(job.seqs):
                    spawned = self._finalize(job)
                    if spawned is not None:
                        nxt.append(spawned)
                    continue
                if job.cursor == 0:
                    seq, _mode = job.seqs[0]
                    job.graph.add_alignment([], seq)
                    job.cursor = 1
                    nxt.append(job)
                    continue
                seq, _mode = job.seqs[job.cursor]
                ncap = _cap_for(self._graph_size(job.graph), N_CAPS)
                lcap = _cap_for(len(seq), L_CAPS)
                job.ext = (None if ncap is None
                           else self._extract(job, ncap))
                if lcap is None or job.ext is None:
                    spawned = self._host_finish(job)
                    if spawned is not None:
                        nxt.append(spawned)
                    continue
                pcap = _cap_for(int(job.ext[2].max()), P_CAPS)
                groups.setdefault((job.scores, ncap, lcap, pcap),
                                  []).append(job)
            for (scores, ncap, lcap, pcap), grp in groups.items():
                nxt.extend(self._run_group(grp, scores, ncap, lcap, pcap))
            active = nxt
        return count

    @staticmethod
    def _extract(job: _Job, N: int):
        """Flatten the job's graph to DP arrays (node_code, pred_rows,
        pred_cnt, is_end, n_nodes, rank_ids) or None on N/P overflow."""
        if isinstance(job.graph, Graph):
            ext = extract_graph_arrays(job.graph, N, P_CAP)
            if ext is None:
                return None
            return ext + (np.array(job.graph.rank_to_node_id,
                                   dtype=np.int32),)
        ext = job.graph.extract(N, P_CAP)
        if ext is None:
            return None
        nc0, pr0, pc0, ie0, nn0, rid0 = ext
        return (nc0, pr0, pc0, ie0, nn0, rid0[:nn0])

    def run_contig(self, contig, _engine=None) -> int:
        return self.run_windows(contig.windows)

    def _run_group(self, grp: List[_Job], scores, N: int, L: int,
                   Pb: int) -> List[_Job]:
        B = len(grp)
        node_code = np.zeros((B, N), dtype=np.int32)
        pred_rows = np.zeros((B, N, Pb), dtype=np.int32)
        pred_cnt = np.ones((B, N), dtype=np.int32)
        is_end = np.zeros((B, N), dtype=bool)
        n_nodes = np.zeros(B, dtype=np.int32)
        arm = np.zeros((B, L), dtype=np.int32)
        arm_len = np.ones(B, dtype=np.int32)
        mode = np.zeros(B, dtype=np.int32)
        rank_ids: List[np.ndarray] = [None] * B
        for b, job in enumerate(grp):
            nc, pr, pc, ie, nn, rid = job.ext
            job.ext = None
            rank_ids[b] = rid
            node_code[b] = nc
            pred_rows[b] = pr[:, :Pb]
            pred_cnt[b] = pc
            is_end[b] = ie
            n_nodes[b] = nn
            seq, md = job.seqs[job.cursor]
            codes = encode_global(seq)
            arm[b, :len(codes)] = codes
            arm_len[b] = len(codes)
            mode[b] = md
        m, n, g = scores
        dev = self.device
        ti, tj, steps, _max_row = poa_dp_tb_batch(
            *(torch.from_numpy(x).to(dev) for x in (
                node_code, pred_rows, pred_cnt, is_end, n_nodes, arm,
                arm_len, mode)),
            N=N, L=L, P=Pb, m=m, n=n, g=g)
        ti, tj, steps = (x.cpu().numpy() for x in (ti, tj, steps))
        self.stats["device_rounds"] += 1
        self.stats["device_aligns"] += B
        out: List[_Job] = []
        for b, job in enumerate(grp):
            seq, _md = job.seqs[job.cursor]
            alignment = alignment_from_steps(ti[b], tj[b], int(steps[b]),
                                             rank_ids[b])
            job.graph.add_alignment(alignment, seq)
            job.cursor += 1
            if job.kind != "short":
                self.stats["long_aligns"] += 1
            out.append(job)
        return out
