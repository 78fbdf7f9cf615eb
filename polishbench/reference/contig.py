"""Per-contig state machine: solid positions -> strong regions ->
minimizer-cut windows -> arm filling -> consensus assembly.

Port of reference src/Contig.cpp / include/Contig.hpp with sdsl
bit-vectors replaced by sorted position arrays and the mutexed counters
replaced by the batch updates in hypo_tpu.segment.support.

Frozen copy of hypo_tpu_torch/pipeline/contig.py (the port's copy of
hypo_tpu/pipeline/contig.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .config import ARMS_SETTINGS, WindowSettings
from .dna import decode, encode
from .solid import SolidKmers
from .minimizers import build_mw_minimizer_info
from .regions import RegionBuilder, RegionType, divide
from .solid_pos import find_solid_pos
from .sr import find_strong_regions
from .window import LONG, SHORT, Window


class Contig:
    def __init__(self, cid: int, name: str, seq):
        self.id = cid
        self.name = name
        self.codes = seq if isinstance(seq, np.ndarray) else encode(seq)
        self.length = len(self.codes)
        # populated by the pipeline stages below
        self.solid_pos: Optional[np.ndarray] = None
        self.kids: Optional[np.ndarray] = None
        self.kmer_coverage: Optional[np.ndarray] = None
        self.kmer_support: Optional[np.ndarray] = None
        self.anchor_kmers: Optional[np.ndarray] = None
        self.num_sr = 0
        self.len_sr = 0
        self.is_win_even = True
        self.stage1_starts: Optional[np.ndarray] = None
        # flat per-MegaWindow minimizer store (see _build_mw_minimizers)
        self.mw_off: Optional[np.ndarray] = None
        self.mw_vals: Optional[np.ndarray] = None
        self.mw_pos: Optional[np.ndarray] = None
        self.mw_cov: Optional[np.ndarray] = None
        self.mw_sup: Optional[np.ndarray] = None
        self.reg_starts: Optional[np.ndarray] = None
        self.reg_type: Optional[List[int]] = None
        self.reg_info: Optional[List[int]] = None
        self.windows: List[Optional[Window]] = []
        self.pseudo_starts: Optional[np.ndarray] = None
        self.pseudo_types: Optional[List[int]] = None
        self.true_reg_id: Optional[List[int]] = None

    # -- stage: solid positions (Contig.cpp:40-74) ------------------------
    def find_solid_pos(self, sk: SolidKmers) -> None:
        self.solid_pos, self.kids = find_solid_pos(self.codes, sk)
        n = len(self.solid_pos)
        self.kmer_coverage = np.zeros(n, dtype=np.int64)
        self.kmer_support = np.zeros(n, dtype=np.int64)

    # -- stage: SR + MegaWindows (Contig.cpp:75-185) ----------------------
    def prepare_for_division(self, k: int, ws: WindowSettings) -> None:
        sr = find_strong_regions(self.solid_pos, self.kids,
                                 self.kmer_coverage, self.kmer_support, k)
        self.anchor_kmers = sr.anchor_kmers
        self.num_sr = sr.num_sr
        self.len_sr = sr.len_sr
        clen = self.length
        sr_pos = sr.sr_pos
        sr_len = sr.sr_len
        self.is_win_even = not (sr.num_sr > 0 and int(sr_pos[0]) == 0)

        starts: List[int] = [0]
        mw_begs: List[int] = [0] if self.is_win_even else []
        mw_ends: List[int] = ([int(sr_pos[0]) if sr.num_sr else clen]
                              if self.is_win_even else [])
        for i in range(sr.num_sr):
            s = int(sr_pos[i])
            e = s + int(sr_len[i])
            starts.append(s)
            starts.append(e)
            mw_begs.append(e)
            mw_ends.append(int(sr_pos[i + 1]) if i + 1 < sr.num_sr
                           else clen)
        starts.append(clen)
        self._build_mw_minimizers(np.array(mw_begs, np.int64),
                                  np.array(mw_ends, np.int64), ws)
        uniq = sorted(set(starts))
        self.stage1_starts = np.array(uniq, dtype=np.int64)
        # free solid-position state (reference does the same)
        self.solid_pos = None
        self.kids = None
        self.kmer_coverage = None
        self.kmer_support = None

    def _build_mw_minimizers(self, begs: np.ndarray, ends: np.ndarray,
                             ws: WindowSettings) -> None:
        """Per-MegaWindow minimizer tables as ONE flat store
        (mw_off/mw_vals/mw_pos with contig-absolute positions +
        mw_cov/mw_sup accumulators) — the initialise_minimserinfo role
        (Contig.cpp:455-524) without ~1M per-MW Python objects.  MWs
        not longer than the ideal window get empty tables."""
        off = np.zeros(len(begs) + 1, np.int64)
        vs: List[np.ndarray] = []
        ps: List[np.ndarray] = []
        for i in range(len(begs)):
            b, e = int(begs[i]), int(ends[i])
            if e - b > ws.ideal_swind_size:
                mi = build_mw_minimizer_info(self.codes[b:e])
                vs.append(mi.minimisers)
                ps.append(b + np.cumsum(mi.rel_pos))
            off[i + 1] = off[i] + (len(vs[-1]) if e - b >
                                   ws.ideal_swind_size else 0)
        vals = (np.concatenate(vs) if vs else np.zeros(0, np.int64))
        pos = (np.concatenate(ps) if ps else np.zeros(0, np.int64))
        self.mw_off = off
        self.mw_vals = vals
        self.mw_pos = pos
        self.mw_cov = np.zeros(len(vals), np.int32)
        self.mw_sup = np.zeros(len(vals), np.int32)

    # -- stage: region division (Contig.cpp:187-245) ----------------------
    def divide_into_regions(self, ws: WindowSettings) -> None:
        clen = self.length
        builder = RegionBuilder()
        sr_rank = 1
        s1 = self.stage1_starts
        for j in range(len(s1) - 1):
            s, e = int(s1[j]), int(s1[j + 1])
            if (j % 2 == 0) == self.is_win_even:  # a MegaWindow
                pvs = "n" if j == 0 else "s"
                nxt = "n" if e == clen else "s"
                minfoidx = j // 2 if self.is_win_even else (j - 1) // 2
                o0 = int(self.mw_off[minfoidx])
                o1 = int(self.mw_off[minfoidx + 1])
                divide(builder, self.codes, self.mw_vals[o0:o1],
                       self.mw_pos[o0:o1], self.mw_cov[o0:o1],
                       self.mw_sup[o0:o1], s, e, pvs, nxt, ws)
            else:  # an SR
                builder.add(s, RegionType.SR, sr_rank)
                sr_rank += 1
        self.reg_starts = np.array(builder.starts + [clen], dtype=np.int64)
        self.reg_type = builder.types + [RegionType.SR]
        self.reg_info = builder.infos
        self.mw_off = None
        self.mw_vals = None
        self.mw_pos = None
        self.mw_cov = None
        self.mw_sup = None
        self.windows = []
        for i, t in enumerate(self.reg_type[:-1]):
            if t in (RegionType.SR, RegionType.MSR):
                self.windows.append(None)
            else:
                dr = self.codes[self.reg_starts[i]:self.reg_starts[i + 1]]
                self.windows.append(Window(dr, SHORT))
        self.windows.append(None)  # dummy

    def num_regions(self) -> int:
        return len(self.reg_type) - 1

    # -- stage: short-arm fill + pruning (Contig.cpp:249-289) -------------
    def fill_short_windows(self, alignments) -> None:
        for aln in alignments:
            aln.add_arms(self)
        A = ARMS_SETTINGS
        for i in range(self.num_regions()):
            t = self.reg_type[i]
            if t in (RegionType.SR, RegionType.MSR):
                continue
            w = self.windows[i]
            if w is None:
                continue
            discarded = False
            internal_contrib = w.get_num_internal()
            if internal_contrib < A.min_short_num:
                win_len = int(self.reg_starts[i + 1] - self.reg_starts[i])
                covered = (w.longest_pre_len + w.longest_suf_len
                           >= win_len)
                sufficient = (w.num_pre >= A.min_short_num
                              and w.num_suf >= A.min_short_num)
                if not (covered and sufficient):
                    self.windows[i] = None
                    discarded = True
            if not discarded:
                contrib = w.get_num_total()
                cond0 = internal_contrib > A.min_internal_num1
                cond1 = (contrib >= A.min_contrib and internal_contrib
                         >= math.floor(A.min_internal_contrib * contrib))
                cond2 = (t in (RegionType.SWS, RegionType.SW, RegionType.WS,
                               RegionType.MWS, RegionType.SWM)
                         and internal_contrib >= A.min_internal_num2)
                if cond0 or cond1 or cond2:
                    w.clear_pre_suf()

    # -- stage: long pseudo-windows (Contig.cpp:292-343) ------------------
    def prepare_long_windows(self, ws: WindowSettings) -> None:
        starts: List[int] = []
        ptypes: List[int] = []
        true_id: List[int] = []
        pvs_iswin = True
        cur_len = 0
        num_reg = len(self.reg_type)  # including the dummy
        for i in range(num_reg):
            pos = int(self.reg_starts[i])
            if (self.reg_type[i] in (RegionType.SR, RegionType.MSR)
                    or self.windows[i] is not None):
                if pvs_iswin or i == num_reg - 1:
                    starts.append(pos)
                    ptypes.append(RegionType.SR)
                    true_id.append(i)
                    cur_len = 0
                pvs_iswin = False
            else:  # a window with no short arms
                winlen = int(self.reg_starts[i + 1]) - pos
                if (pos == 0 or cur_len + winlen > ws.ideal_lwind_size
                        or not pvs_iswin):
                    starts.append(pos)
                    ptypes.append(RegionType.LONG)
                    true_id.append(i)
                    self.reg_type[i] = RegionType.LONG
                    cur_len = winlen
                else:
                    cur_len += winlen
                pvs_iswin = True
        self.pseudo_starts = np.array(starts, dtype=np.int64)
        self.pseudo_types = ptypes
        self.true_reg_id = true_id
        for j in range(len(ptypes) - 1):  # excluding dummy
            if ptypes[j] == RegionType.LONG:
                dr = self.codes[self.pseudo_starts[j]:
                                self.pseudo_starts[j + 1]]
                self.windows[true_id[j]] = Window(dr, LONG)

    # -- stage: long-arm fill (Contig.hpp:91-113) -------------------------
    def fill_long_windows(self, alignments) -> None:
        for aln in alignments:
            aln.add_arms(self)
        A = ARMS_SETTINGS
        for i in range(self.num_regions()):
            if self.reg_type[i] == RegionType.LONG:
                w = self.windows[i]
                if w is not None and (w.get_num_internal()
                                      > A.min_internal_num3):
                    w.clear_pre_suf()
        self.pseudo_starts = None
        self.pseudo_types = None
        self.true_reg_id = None

    # -- output (Contig.cpp:345-366) --------------------------------------
    def polished_seq(self, no_long_reads: bool) -> str:
        parts: List[str] = []
        cur = int(self.reg_starts[0])
        for i in range(self.num_regions()):
            nxt = int(self.reg_starts[i + 1])
            t = self.reg_type[i]
            if t in (RegionType.SR, RegionType.MSR):
                parts.append(decode(self.codes[cur:nxt]))
            elif self.windows[i] is not None:
                parts.append(self.windows[i].consensus or "")
            elif no_long_reads:
                parts.append(decode(self.codes[cur:nxt]))
            cur = nxt
        return "".join(parts)
