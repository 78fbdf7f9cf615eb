"""Window consensus engine (the reference's Window::generate_consensus
paths, src/Window.cpp:44-254).

Short windows: internal arms are flanked with marker letters J/O and
aligned kNW; prefix arms ("J"+seq, added in REVERSE order since the BAM
is coordinate-sorted and the last prefix is the longest) kLOV; suffix
arms (seq+"O") kROV; consensus = heaviest bundle minus the two marker
columns (set_marked_consensus strips one char from each end
unconditionally, Window.hpp:144).

Long windows: draft (round 1) or previous consensus (round 2) as
backbone, arms un-marked; per-base agreeing-sequence counts curate the
consensus at floor(0.4*num_internal); a second round re-POAs the arms
against the round-1 consensus.  NOTE the reference quirk (Window.cpp:166,
189,199): changeAlignType is called on the *short* engine while aligning
with the *long* engine, so every long-path arm is effectively aligned
kNW.  We reproduce that by default; ``fix_long_align_type=True`` applies
the presumably-intended LOV/ROV modes.

Copied from hypo_tpu_torch/poa/engine.py, its native paths removed and
the batch path's identical-arm shortcut put in the dispatch.
"""
from __future__ import annotations

import math
from typing import Optional

from .config import ScoreParams
from .dna import decode
from .align import LOV, NW, ROV, PoaAligner
from .graph import Graph

HEAD = "J"
TAIL = "O"
CURATE_THRESH = 0.4  # Window::_cThresh

# 2-bit code bytes -> ASCII letters, for bytes.translate
_CODE2ASCII = bytes.maketrans(bytes(range(5)), b"ACGTN")


class ConsensusEngine:
    """Window consensus on the plain Python oracle (the copy keeps no
    native engine): the empty / too-few-arms rules, the exact
    identical-arm shortcut of the port's batch path, then the POA."""

    def __init__(self, sp: ScoreParams, fix_long_align_type: bool = False):
        self.sp = sp
        self.short_aligner = PoaAligner(sp.sr_match, sp.sr_mismatch,
                                        sp.sr_gap)
        self.long_aligner = PoaAligner(sp.lr_match, sp.lr_mismatch,
                                       sp.lr_gap)
        self.fix_long_align_type = fix_long_align_type

    # -- dispatch (Window.cpp:44-61) --------------------------------------
    def generate_consensus(self, window) -> None:
        num_non_empty = (window.num_internal + window.num_pre
                         + window.num_suf)
        if window.num_empty > num_non_empty:
            window.consensus = ""  # deletion wins
        elif num_non_empty >= 2:
            trivial = self._trivial_consensus(window)
            if trivial is not None:
                window.consensus = trivial
            elif window.wtype == 0:  # SHORT
                window.consensus = self._short(window)
            else:
                window.consensus = self._long(window, initial=True,
                                              prev=None)
        else:
            window.consensus = decode(window.draft)

    def _trivial_consensus(self, w) -> Optional[str]:
        """Exact shortcut: when every sequence the window would POA is
        identical, the graph is a chain and the consensus is that
        sequence — the dominant case at short-read coverage (the median
        window's arms deduplicate to ONE distinct sequence).  For long
        windows every base's agreeing-count equals the sequence count,
        so curation keeps all bases (guarded below); round 2 re-POAs
        the same identical set and returns the same string."""
        if w.wtype == 0:
            arms = [a for a in w.internal_arms if len(a)]
            if not arms:
                return None
            if (any(len(a) for a in w.pre_arms)
                    or any(len(a) for a in w.suf_arms)):
                return None
            first = arms[0].tobytes()
            if all(a.tobytes() == first for a in arms[1:]):
                return decode(arms[0])
            return None
        if not len(w.draft):
            return None
        first = w.draft.tobytes()
        nseq = 1
        for group in (w.internal_arms, w.pre_arms, w.suf_arms):
            for a in group:
                if len(a):
                    if a.tobytes() != first:
                        return None
                    nseq += 1
        if nseq < 2:
            return None
        if nseq < math.floor(w.num_internal * CURATE_THRESH):
            return None  # curation would drop bases; run the full path
        return decode(w.draft)

    # -- short path (Window.cpp:87-154) -----------------------------------
    def _short(self, window) -> str:
        graph = Graph()
        eng = self.short_aligner
        arms_added = False
        if not window.internal_arms:
            s = HEAD + decode(window.draft) + TAIL
            graph.add_alignment(eng.align(s, graph, NW), s)
        for arm in window.internal_arms:
            if len(arm):
                s = HEAD + decode(arm) + TAIL
                arms_added = True
                graph.add_alignment(eng.align(s, graph, NW), s)
        for arm in reversed(window.pre_arms):
            if len(arm):
                s = HEAD + decode(arm)
                arms_added = True
                graph.add_alignment(eng.align(s, graph, LOV), s)
        for arm in window.suf_arms:
            if len(arm):
                s = decode(arm) + TAIL
                arms_added = True
                graph.add_alignment(eng.align(s, graph, ROV), s)
        if arms_added:
            consensus = graph.generate_consensus()
            return consensus[1:-1]  # strip markers (unconditional)
        return decode(window.draft)

    # -- long path (Window.cpp:156-236) -----------------------------------
    def _long(self, window, initial: bool, prev: Optional[str]) -> str:
        graph = Graph()
        eng = self.long_aligner
        arms_added = False
        mode_int = NW
        mode_pre = LOV if self.fix_long_align_type else NW
        mode_suf = ROV if self.fix_long_align_type else NW

        if not initial:
            if prev:
                graph.add_alignment(eng.align(prev, graph, mode_int), prev)
        else:
            s = decode(window.draft)
            graph.add_alignment(eng.align(s, graph, mode_int), s)
        for arm in window.internal_arms:
            if len(arm):
                s = decode(arm)
                arms_added = True
                graph.add_alignment(eng.align(s, graph, mode_int), s)
        for arm in window.pre_arms:
            if len(arm):
                s = decode(arm)
                arms_added = True
                graph.add_alignment(eng.align(s, graph, mode_pre), s)
        for arm in window.suf_arms:
            if len(arm):
                s = decode(arm)
                arms_added = True
                graph.add_alignment(eng.align(s, graph, mode_suf), s)
        if not arms_added:
            return decode(window.draft)
        consensus, dst = graph.generate_consensus_custom()
        curated = self._curate(consensus, dst, window.num_internal)
        if initial:
            window.consensus = curated
            return self._long(window, initial=False, prev=curated)
        return curated

    @staticmethod
    def _curate(con: str, dst, num_internal: int) -> str:
        th = math.floor(num_internal * CURATE_THRESH)
        return "".join(c for c, d in zip(con, dst) if d >= th)
