"""Coverage/support accumulation from alignments.

Replaces the reference's mutex-guarded per-kmer / per-minimizer counters
(reference include/Contig.hpp:39-53, src/Alignment.cpp:65-220) with
range-diff arrays and sorted-join match scans:

- k-mer coverage is a range increment per alignment -> difference array;
- k-mer support joins read k-mers with in-range contig solid k-mers by
  value (sorted searchsorted join) and replays the reference's sequential
  adjacent-kmer insertion heuristic over band-passing matches;
- minimizer coverage/support use the same join on per-MegaWindow tables.

Frozen copy of hypo_tpu_torch/segment/support.py (the port's copy of
hypo_tpu/segment/support.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

from .config import MINIMIZER_SETTINGS as MS
from .dna import kmer_codes, minimizer_scan


def update_solidkmers_support(contig, alignments: Iterable, k: int) -> None:
    """Accumulate contig.kmer_coverage / contig.kmer_support in place."""
    positions = contig.solid_pos
    kids = contig.kids
    npos = len(positions)
    cov_diff = np.zeros(npos + 1, dtype=np.int64)
    support = contig.kmer_support

    for aln in alignments:
        rb, re = aln.rb, aln.re
        first = int(np.searchsorted(positions, rb, side="left"))
        last0 = int(np.searchsorted(positions, re, side="left"))
        fit = int(np.searchsorted(positions, re - k, side="right"))
        last = fit if fit > first else last0
        if last <= first:
            continue
        cov_diff[first] += 1
        cov_diff[last] -= 1

        # join read k-mers against contig solid k-mers in [first, last)
        rk, _ = kmer_codes(aln.codes, k)
        if len(rk) == 0:
            continue
        order_r = np.argsort(rk, kind="stable")
        rk_sorted = rk[order_r]
        ckids = kids[first:last]
        lo = np.searchsorted(rk_sorted, ckids, side="left")
        hi = np.searchsorted(rk_sorted, ckids, side="right")
        nmatch = hi - lo
        if nmatch.sum() == 0:
            continue
        cs = np.repeat(np.arange(last - first), nmatch)
        js = np.concatenate([order_r[l:h] for l, h in zip(lo, hi)
                             if h > l]) if nmatch.sum() else np.zeros(0, int)
        # band filter (vectorized)
        c_dist = positions[first + cs] - rb
        left = np.maximum(c_dist - k, 0)
        num_cbases = re - rb
        right = np.minimum(num_cbases, c_dist + k)
        ok = (js >= left) & (js <= right)
        cs, js = cs[ok], js[ok]
        if len(cs) == 0:
            continue
        # replay in (read-kmer asc, contig-index asc) order with the
        # adjacent-kmer insertion heuristic (Alignment.cpp:116-127)
        order = np.lexsort((cs, js))
        sp_arr = positions[first + cs[order]].tolist()
        j_arr = js[order].tolist()
        c_arr = (first + cs[order]).tolist()
        pvs_kpos = -1
        pvs_rbind = 0
        for sp, j, c in zip(sp_arr, j_arr, c_arr):
            should = True
            if pvs_kpos > -1 and sp <= k + pvs_kpos:
                if (j - pvs_rbind) != (sp - pvs_kpos):
                    should = False
            if should:
                pvs_kpos = sp
                pvs_rbind = j
                support[c] += 1

    contig.kmer_coverage += np.cumsum(cov_diff[:-1])


def update_minimisers_support(contig, alignments: Iterable) -> None:
    """Accumulate mw_cov / mw_sup for every MegaWindow overlapped by
    each alignment (reference Alignment.cpp:134-220), over the contig's
    flat minimizer store (mw_off/mw_vals/mw_pos)."""
    mk, mw = MS.k, MS.w
    starts = contig.stage1_starts     # region boundary positions
    is_win_even = contig.is_win_even
    nreg = len(starts) - 1            # excluding the dummy
    mw_off = contig.mw_off
    n_mw = len(mw_off) - 1

    for aln in alignments:
        rb, re = aln.rb, aln.re
        first = int(np.searchsorted(starts, rb + 1, side="left")) - 1
        last = int(np.searchsorted(starts, re, side="left"))
        first_w = first if ((first % 2 == 0) == is_win_even) else first + 1
        last_w = last if ((last % 2 == 0) == is_win_even) else last - 1
        if last_w < first_w:
            continue
        rvals, rposs = minimizer_scan(aln.codes, mk, mw, canonical=False)
        if len(rvals):
            ro = np.argsort(rvals, kind="stable")
            rv_sorted = rvals[ro]
            rp_by_val = rposs[ro]
        num_cbases = re - rb
        for i in range(first_w, last_w + 1, 2):
            if i >= nreg:
                break
            minfoidx = i // 2 if is_win_even else (i - 1) // 2
            if minfoidx >= n_mw:
                break
            o0, o1 = int(mw_off[minfoidx]), int(mw_off[minfoidx + 1])
            if o0 == o1:
                continue
            abs_pos = contig.mw_pos[o0:o1]
            within = (abs_pos >= rb) & (abs_pos < re)
            idxs = np.nonzero(within)[0]
            np.add.at(contig.mw_cov, o0 + idxs, 1)
            if len(rvals) == 0 or len(idxs) == 0:
                continue
            vals = contig.mw_vals[o0 + idxs]
            c_dist = abs_pos[idxs] - rb
            r_left = np.maximum(c_dist - 2 * mk, 0)
            r_right = np.minimum(num_cbases, c_dist + 3 * mk)
            lo = np.searchsorted(rv_sorted, vals, side="left")
            hi = np.searchsorted(rv_sorted, vals, side="right")
            for t in range(len(idxs)):
                if hi[t] > lo[t]:
                    pp = rp_by_val[lo[t]:hi[t]]
                    contig.mw_sup[o0 + idxs[t]] += int(
                        ((pp >= r_left[t]) & (pp <= r_right[t])).sum())
