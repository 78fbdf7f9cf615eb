"""Region division: cutting MegaWindows into windows at supported
minimizers, with homopolymer-safe force cuts for oversized stretches.

Port of reference Contig::divide (src/Contig.cpp:526-628) and
Contig::force_divide (src/Contig.cpp:630-711), including the reference's
region-typing quirks (the unreachable WM branch in force_divide's
single-window case, src/Contig.cpp:687, is preserved: (n,m) -> OTHER).

Frozen copy of hypo_tpu_torch/segment/regions.py (the port's copy of
hypo_tpu/segment/regions.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .config import MINIMIZER_SETTINGS as MS
from .config import WindowSettings


class RegionType:
    """Region kinds; values match the reference enum order
    (globalDefs.hpp:95-108)."""
    SWS = 0
    SW = 1
    WS = 2
    MWM = 3
    MW = 4
    WM = 5
    SWM = 6
    MWS = 7
    OTHER = 8
    LONG = 9
    SR = 10
    MSR = 11

    NAMES = ["SWS", "SW", "WS", "MWM", "MW", "WM", "SWM", "MWS", "OTH",
             "LNG", "SR", "MSR"]


class RegionBuilder:
    """Accumulates (start, type, info) triples in scan order."""

    def __init__(self):
        self.starts: List[int] = []
        self.types: List[int] = []
        self.infos: List[int] = []

    def add(self, start: int, rtype: int, info: int = 0) -> None:
        self.starts.append(int(start))
        self.types.append(int(rtype))
        self.infos.append(int(info))


def divide(builder: RegionBuilder, codes: np.ndarray, m_vals, m_pos,
           m_cov, m_sup, beg: int, end: int, pvs: str, nxt: str,
           ws: WindowSettings) -> None:
    """Divide MegaWindow [beg, end) at supported minimizers.  The MW's
    minimizer table arrives as flat array slices (values, contig-
    absolute positions, coverage, support)."""
    ideal = ws.ideal_swind_size
    mk = MS.k
    too_large = 2 * ideal

    # collect supported minimizers (cov>=th, supp >= floor(0.8*cov),
    # not adjacent to the next SR) — vectorized over the MW's table
    if len(m_vals):
        cov64 = m_cov.astype(np.int64)
        keep = ((cov64 >= MS.cov_th)
                & (m_sup.astype(np.int64)
                   >= (MS.supp_frac * cov64).astype(np.int64))
                & (m_pos + mk < end))
        supp_pos = m_pos[keep].tolist()
        supp_min = m_vals[keep].tolist()
    else:
        supp_pos = []
        supp_min = []

    # pick cutting minimizers greedily at <= ideal spacing
    remaining = end - beg
    start = beg
    cuts: List[int] = []
    for mi in range(len(supp_pos)):
        if remaining <= ideal:
            break
        should_break = (mi == len(supp_pos) - 1
                        or supp_pos[mi + 1] > ideal + start)
        if should_break and supp_pos[mi] > start:
            cuts.append(mi)
            start = supp_pos[mi] + mk
            remaining = end - start

    if not cuts:
        if end > beg + too_large:
            force_divide(builder, codes, beg, end, pvs, nxt, ws)
        else:
            if pvs == "s" and nxt == "s":
                t = RegionType.SWS
            elif pvs == "s":
                t = RegionType.SW
            elif nxt == "s":
                t = RegionType.WS
            else:
                t = RegionType.OTHER
            builder.add(beg, t)
        return

    # first window
    win_end = supp_pos[cuts[0]]
    if win_end > beg + too_large:
        force_divide(builder, codes, beg, win_end, pvs, "m", ws)
    else:
        builder.add(beg,
                    RegionType.SWM if pvs == "s" else RegionType.WM)
    # internal: MSR at each cut minimizer, then window to the next cut
    for cmi in range(1, len(cuts)):
        pvs_mi = cuts[cmi - 1]
        builder.add(supp_pos[pvs_mi], RegionType.MSR, supp_min[pvs_mi])
        win_start = supp_pos[pvs_mi] + mk
        win_end = supp_pos[cuts[cmi]]
        if win_end > too_large + win_start:
            force_divide(builder, codes, win_start, win_end, "m", "m", ws)
        else:
            builder.add(win_start, RegionType.MWM)
    # last: MSR then closing window to `end`
    pvs_mi = cuts[-1]
    builder.add(supp_pos[pvs_mi], RegionType.MSR, supp_min[pvs_mi])
    win_start = supp_pos[pvs_mi] + mk
    if end > too_large + win_start:
        force_divide(builder, codes, win_start, end, "m", nxt, ws)
    else:
        builder.add(win_start,
                    RegionType.MWS if nxt == "s" else RegionType.MW)


def force_divide(builder: RegionBuilder, codes: np.ndarray, beg: int,
                 end: int, pvs: str, nxt: str, ws: WindowSettings) -> None:
    """Cut [beg, end) at homopolymer-safe breakpoints
    (----AAAB || CDDDD rule, reference src/Contig.cpp:645)."""
    ideal = ws.ideal_swind_size
    search_th = ws.wind_size_search_th
    start = beg
    remaining = end - start
    cut_pos: List[int] = []
    while remaining > ideal:
        search = start + search_th
        while search < end:
            base = codes[search]
            if base == codes[search - 1]:
                search += 1
            elif search + 1 < end and base == codes[search + 1]:
                search += 2
            elif search + 2 < end and codes[search + 2] == codes[search + 1]:
                search += 3
            else:
                break
        if search < end:
            cut_pos.append(start)
            start = search + 1
            remaining = end - start
        else:
            break
    if start < end:
        cut_pos.append(start)

    if len(cut_pos) == 1:
        key = (pvs, nxt)
        t = {("s", "s"): RegionType.SWS, ("s", "m"): RegionType.SWM,
             ("s", "n"): RegionType.SW, ("m", "s"): RegionType.MWS,
             ("m", "m"): RegionType.MWM, ("m", "n"): RegionType.MW,
             ("n", "s"): RegionType.WS,
             # (n,m) falls through to OTHER in the reference (the WM branch
             # at Contig.cpp:687 tests `nxt=='n' && nxt=='m'`: unreachable)
             }.get(key, RegionType.OTHER)
        builder.add(beg, t)
    else:
        if pvs == "s":
            t = RegionType.SW
        elif pvs == "m":
            t = RegionType.MW
        else:
            t = RegionType.OTHER
        builder.add(beg, t)
        for i in range(1, len(cut_pos) - 1):
            builder.add(cut_pos[i], RegionType.OTHER)
        if nxt == "s":
            t = RegionType.WS
        elif nxt == "m":
            t = RegionType.WM
        else:
            t = RegionType.OTHER
        builder.add(cut_pos[-1], t)
