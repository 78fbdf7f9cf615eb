"""Per-contig state machine: solid positions -> strong regions ->
minimizer-cut windows -> arm filling -> consensus assembly.

Port of reference src/Contig.cpp / include/Contig.hpp with sdsl
bit-vectors replaced by sorted position arrays and the mutexed counters
replaced by the batch updates in hypo_tpu.segment.support.

The region map is flat arrays from the strong-region scan to the
output: ``reg_starts`` (int64, with the contig's end as a dummy last
entry), ``reg_type`` (uint8, ``RegionType``) and ``reg_info`` (int64),
with ``windows`` holding a Window for each weak region and None for the
rest.  Where the host library loaded, the scan and the division are one
native call a contig each (native.host_api.strong_regions,
divide_regions); otherwise segment.sr and segment.regions walk them in
Python, with the same result.  Both count the regions they divide
(counters ``pipeline.regions_native`` and ``pipeline.regions_python``).
The prune after the short arms is one rule over counter arrays
(``_prune_short_windows``), fed from the native arm table
(``fill_short_windows_from_table``) or from the windows' own counters
(``fill_short_windows``); the output is one decode of the contig, cut
between the windows' consensus.

Copied from hypo_tpu/pipeline/contig.py.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import ARMS_SETTINGS, MINIMIZER_SETTINGS, WindowSettings
from ..dna import decode, encode
from ..kmers.solid import SolidKmers
from ..native import host_api
from ..segment.minimizers import build_mw_minimizer_info
from ..segment.regions import RegionBuilder, RegionType, divide
from ..segment.solid_pos import find_solid_pos
from ..segment.sr import StrongRegions, scan_strong_regions, sr_tiers
from ..utils import trace
from .window import LONG, Window

# a window beside an SR clears its prefix and suffix arms from
# min_internal_num2 internal ones on (Contig.cpp:279-281)
_NEAR_STRONG = (RegionType.SWS, RegionType.SW, RegionType.WS,
                RegionType.MWS, RegionType.SWM)


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
        self.reg_type: Optional[np.ndarray] = None
        self.reg_info: Optional[np.ndarray] = None
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
        scan = (host_api.strong_regions if host_api.available()
                else scan_strong_regions)
        sr = StrongRegions(*scan(
            self.solid_pos, self.kids,
            sr_tiers(self.kmer_coverage, self.kmer_support), k))
        self.anchor_kmers = sr.anchor_kmers
        self.num_sr = sr.num_sr
        self.len_sr = sr.len_sr
        clen = self.length
        sr_beg = sr.sr_pos
        sr_end = sr.sr_pos + sr.sr_len
        self.is_win_even = not (sr.num_sr > 0 and int(sr_beg[0]) == 0)
        # MegaWindows: the stretches before, between and after the SRs
        if self.is_win_even:
            mw_begs = np.concatenate(([0], sr_end))
            mw_ends = np.concatenate((sr_beg, [clen]))
        else:
            mw_begs = sr_end
            mw_ends = np.concatenate((sr_beg[1:], [clen]))
        self._build_mw_minimizers(mw_begs.astype(np.int64),
                                  mw_ends.astype(np.int64), ws)
        edges = np.empty(2 * sr.num_sr + 2, np.int64)
        edges[0] = 0
        edges[1:-1:2] = sr_beg
        edges[2:-1:2] = sr_end
        edges[-1] = clen
        self.stage1_starts = np.unique(edges)
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
        from ..config import MINIMIZER_SETTINGS as MS
        from ..segment.minimizers import _POLY
        if host_api.available() and len(begs):
            off, vals, pos = host_api.mw_minimizer_build(
                self.codes, begs, ends, MS.k, MS.w,
                ws.ideal_swind_size, np.array(_POLY, np.int64))
        else:
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
        MS = MINIMIZER_SETTINGS
        clen = self.length
        if host_api.available():
            cov = self.mw_cov.astype(np.int64)
            keep = ((cov >= MS.cov_th)
                    & (self.mw_sup.astype(np.int64)
                       >= (MS.supp_frac * cov).astype(np.int64)))
            starts, types, infos = host_api.divide_regions(
                self.codes, self.stage1_starts, self.is_win_even,
                self.mw_off, self.mw_vals, self.mw_pos, keep, MS.k,
                ws.ideal_swind_size, ws.wind_size_search_th)
            trace.count("pipeline.regions_native", len(types))
        else:
            starts, types, infos = self._divide_python(ws)
            trace.count("pipeline.regions_python", len(types))
        self.reg_starts = np.append(starts, clen).astype(np.int64)
        self.reg_type = np.append(types, RegionType.SR).astype(np.uint8)
        self.reg_info = infos
        self.mw_off = None
        self.mw_vals = None
        self.mw_pos = None
        self.mw_cov = None
        self.mw_sup = None
        # a window for each weak region; None for SRs, MSRs and the dummy
        n = len(types)
        weak = np.nonzero((types != RegionType.SR)
                          & (types != RegionType.MSR))[0]
        rs = self.reg_starts
        codes = self.codes
        windows: List[Optional[Window]] = [None] * (n + 1)
        for i, a, b in zip(weak.tolist(), rs[weak].tolist(),
                           rs[weak + 1].tolist()):
            windows[i] = Window(codes[a:b])
        self.windows = windows

    def _divide_python(self, ws: WindowSettings):
        """The division's Python walk (segment.regions), twin of
        native.host_api.divide_regions: (starts, types, infos)."""
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
        return (np.array(builder.starts, np.int64),
                np.array(builder.types, np.uint8),
                np.array(builder.infos, np.int64))

    def num_regions(self) -> int:
        return len(self.reg_type) - 1

    # -- stage: short-arm fill + pruning (Contig.cpp:249-289) -------------
    def add_arm_table(self, alignments, table) -> None:
        """Feed windows from a native arm table (aln_idx, windex, qb,
        qe, armtype arrays in (alignment, emission) order) — exactly the
        order the per-alignment add_arms drain produces, so POA
        tie-breaking is unchanged.  ``alignments`` is either a list of
        Alignment objects or a flat AlignmentView."""
        aln_idx, windex, qb, qe, armtype = table
        get_codes = (alignments.codes if hasattr(alignments, "codes")
                     else lambda a, b, e: alignments[a].codes[b:e])
        windows = self.windows
        for i in range(len(aln_idx)):
            w = windows[windex[i]]
            if w is None:
                continue
            t = armtype[i]
            if t == 3:  # EMPTY
                w.add_empty()
                continue
            codes = get_codes(aln_idx[i], qb[i], qe[i])
            if t == 1:  # PREFIX
                w.add_prefix(codes)
            elif t == 2:  # SUFFIX
                w.add_suffix(codes)
            else:
                w.add_internal(codes)

    def fill_short_windows_from_table(self, table) -> None:
        """Counters-only twin of add_arm_table + fill_short_windows for
        the tile path: each window's arm counters and longest-pre/suf
        lengths from the native arm table, without per-window arm
        arrays (the tile builder reads arms straight from the flat
        table, native.host_api.tile_jobs), then the prune.  Only the
        windows that survive are touched.  For the SHORT pass on the
        windows as divide_into_regions left them: long pseudo-windows
        apply the per-arm filter and go through add_arm_table."""
        _aln_idx, windex, qb, qe, armtype = table
        nreg = self.num_regions()
        # one key a (region, arm type): internal, prefix, suffix, empty;
        # a region's counters count only where it holds a window
        key = np.asarray(windex, np.intp) * 4 + np.asarray(armtype)
        by_type = np.bincount(key, minlength=4 * (nreg + 1))
        longest = np.zeros(4 * (nreg + 1), np.int64)
        np.maximum.at(longest, key,
                      np.asarray(qe, np.int64) - np.asarray(qb, np.int64))
        counts = np.concatenate(
            (by_type.reshape(-1, 4).T, longest.reshape(-1, 4).T[1:3]))
        counts = counts[:, :nreg]
        live = self._live_windows()
        keep, clear = self._prune_short_windows(live, counts)
        ni, npre, nsuf, nemp, lp, ls = counts[:, keep]
        npre[clear[keep]] = 0
        nsuf[clear[keep]] = 0
        windows = self.windows
        for i, a, b, c, d, e, f in zip(
                np.nonzero(keep)[0].tolist(), ni.tolist(), npre.tolist(),
                nsuf.tolist(), nemp.tolist(), lp.tolist(), ls.tolist()):
            w = windows[i]
            w.num_internal = a
            w.num_pre = b
            w.num_suf = c
            w.num_empty = d
            w.longest_pre_len = e
            w.longest_suf_len = f

    def fill_short_windows(self, alignments) -> None:
        """Each alignment's arms into its windows, then the prune over
        the windows' own counters."""
        for aln in alignments:
            aln.add_arms(self)
        live = self._live_windows()
        idx = np.nonzero(live)[0]
        windows = self.windows
        counts = np.zeros((6, self.num_regions()), np.int64)
        if len(idx):
            counts[:, idx] = np.array(
                [(w.num_internal, w.num_pre, w.num_suf, w.num_empty,
                  w.longest_pre_len, w.longest_suf_len)
                 for w in (windows[i] for i in idx.tolist())],
                np.int64).T
        _keep, clear = self._prune_short_windows(live, counts)
        for i in np.nonzero(clear)[0].tolist():
            windows[i].clear_pre_suf()

    def _live_windows(self) -> np.ndarray:
        """Regions (the dummy left out) that hold a window."""
        n = self.num_regions()
        return np.fromiter((w is not None for w in self.windows[:n]),
                           bool, n)

    def _prune_short_windows(self, live: np.ndarray, counts: np.ndarray):
        """The short pass's prune (Contig.cpp:249-289) as one array rule
        over every region: ``live`` marks the regions with a window,
        ``counts`` holds their (internal, prefix, suffix, empty, longest
        prefix, longest suffix) counters by region.  Drops the windows
        with too little evidence (set to None) and returns (keep,
        clear): the regions whose window survives, and those among them
        whose prefix and suffix arms are to be cleared."""
        A = ARMS_SETTINGS
        ni, npre, nsuf, nemp, lp, ls = counts
        t = self.reg_type[:-1]
        live = live & (t != RegionType.SR) & (t != RegionType.MSR)
        internal = ni + nemp
        total = internal + npre + nsuf
        covered = lp + ls >= np.diff(self.reg_starts)
        sufficient = (npre >= A.min_short_num) & (nsuf >= A.min_short_num)
        drop = live & (internal < A.min_short_num) & ~(covered & sufficient)
        keep = live & ~drop
        clear = keep & ((internal > A.min_internal_num1)
                        | ((total >= A.min_contrib)
                           & (internal >= np.floor(
                               A.min_internal_contrib * total)))
                        | (np.isin(t, _NEAR_STRONG)
                           & (internal >= A.min_internal_num2)))
        windows = self.windows
        for i in np.nonzero(drop)[0].tolist():
            windows[i] = None
        return keep, clear

    # -- stage: long pseudo-windows (Contig.cpp:292-343) ------------------
    def prepare_long_windows(self, ws: WindowSettings) -> None:
        starts: List[int] = []
        ptypes: List[int] = []
        true_id: List[int] = []
        pvs_iswin = True
        cur_len = 0
        num_reg = len(self.reg_type)  # including the dummy
        types = self.reg_type.tolist()
        rs = self.reg_starts.tolist()
        for i in range(num_reg):
            pos = rs[i]
            if (types[i] in (RegionType.SR, RegionType.MSR)
                    or self.windows[i] is not None):
                if pvs_iswin or i == num_reg - 1:
                    starts.append(pos)
                    ptypes.append(RegionType.SR)
                    true_id.append(i)
                    cur_len = 0
                pvs_iswin = False
            else:  # a window with no short arms
                winlen = rs[i + 1] - pos
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
        long_ids = np.nonzero(self.reg_type[:-1] == RegionType.LONG)[0]
        for i in long_ids.tolist():
            w = self.windows[i]
            if w is not None and (w.get_num_internal()
                                  > A.min_internal_num3):
                w.clear_pre_suf()
        self.pseudo_starts = None
        self.pseudo_types = None
        self.true_reg_id = None

    # -- inspection artifacts (Contig.cpp:368-453) -------------------------
    def write_bed(self, fh) -> None:
        """Append this contig's region map as BED lines
        (reference generate_inspect_file writes aux/regions.bed)."""
        for i in range(self.num_regions()):
            fh.write(f"{self.name}\t{int(self.reg_starts[i])}\t"
                     f"{int(self.reg_starts[i + 1])}\t"
                     f"{RegionType.NAMES[self.reg_type[i]]}\n")

    def write_window_dump(self, fh) -> None:
        """Per-window dump: range, type, arm counts, draft, consensus
        (reference generate_inspect_file's second artifact)."""
        for i in range(self.num_regions()):
            t = self.reg_type[i]
            s, e = int(self.reg_starts[i]), int(self.reg_starts[i + 1])
            w = self.windows[i]
            if w is None:
                fh.write(f"#{i}\t{self.name}:{s}-{e}\t"
                         f"{RegionType.NAMES[t]}\t-\n")
                continue
            fh.write(f"#{i}\t{self.name}:{s}-{e}\t{RegionType.NAMES[t]}\t"
                     f"int={w.num_internal} pre={w.num_pre} "
                     f"suf={w.num_suf} empty={w.num_empty}\n")
            fh.write(f"  draft\t{decode(w.draft)}\n")
            if w.consensus is not None:
                fh.write(f"  cons\t{w.consensus}\n")

    # -- output (Contig.cpp:345-366) --------------------------------------
    def polished_seq(self, no_long_reads: bool) -> str:
        """The draft's text for SRs, MSRs and (with ``no_long_reads``)
        regions whose window was dropped, each maximal run of them one
        slice of the contig decoded once; each window's consensus
        between the runs; nothing for a dropped window's region when
        long reads were given (a LONG window covers it)."""
        n = self.num_regions()
        t = self.reg_type[:n]
        win = self._live_windows()
        draft = (t == RegionType.SR) | (t == RegionType.MSR)
        if no_long_reads:
            draft |= ~win
        win &= ~draft
        first = np.nonzero(draft & ~np.concatenate(([False], draft[:-1])))[0]
        last = np.nonzero(draft & ~np.concatenate((draft[1:], [False])))[0]
        text = decode(self.codes)
        rs = self.reg_starts
        windows = self.windows
        parts = np.full(n, "", object)
        parts[first] = [text[a:b] for a, b in zip(rs[first].tolist(),
                                                  rs[last + 1].tolist())]
        parts[win] = [windows[i].consensus or ""
                      for i in np.nonzero(win)[0].tolist()]
        return "".join(parts.tolist())
