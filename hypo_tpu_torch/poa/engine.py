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

Copied from hypo_tpu/poa/engine.py.
"""
from __future__ import annotations

import math
from typing import Optional

from ..config import ScoreParams
from ..dna import decode
from .align import LOV, NW, ROV, PoaAligner
from .graph import Graph

HEAD = "J"
TAIL = "O"
CURATE_THRESH = 0.4  # Window::_cThresh

# 2-bit code bytes -> ASCII letters, for bytes.translate
_CODE2ASCII = bytes.maketrans(bytes(range(5)), b"ACGTN")


class ConsensusEngine:
    """Per-thread/engine-free consensus generator for windows.

    Prefers the native (C++) engine when its shared library is
    available; results are identical to the Python oracle (tested)."""

    def __init__(self, sp: ScoreParams, fix_long_align_type: bool = False,
                 use_native: bool = None):
        self.sp = sp
        self.short_aligner = PoaAligner(sp.sr_match, sp.sr_mismatch,
                                        sp.sr_gap)
        self.long_aligner = PoaAligner(sp.lr_match, sp.lr_mismatch,
                                       sp.lr_gap)
        self.fix_long_align_type = fix_long_align_type
        if use_native is None:
            from ..native import available
            use_native = available()
        self.use_native = use_native

    # -- dispatch (Window.cpp:44-61) --------------------------------------
    def generate_consensus(self, window) -> None:
        num_non_empty = (window.num_internal + window.num_pre
                         + window.num_suf)
        if window.num_empty > num_non_empty:
            window.consensus = ""  # deletion wins
        elif num_non_empty >= 2:
            if self.use_native:
                out = self._native(window)
                if out is not None:
                    window.consensus = out
                    return
            if window.wtype == 0:  # SHORT
                window.consensus = self._short(window)
            else:
                window.consensus = self._long(window, initial=True,
                                              prev=None)
        else:
            window.consensus = decode(window.draft)

    def generate_consensus_batch(self, windows, nthreads: int = 0) -> int:
        """Consensus for many windows in one native OpenMP dispatch (the
        reference's per-window OMP loop, Hypo.cpp:237-247).  Windows the
        dispatch rules settle without POA are handled inline.  Returns
        the number of windows processed; falls back to the serial path
        when the native library is missing."""
        if not self.use_native:
            for w in windows:
                self.generate_consensus(w)
            return len(windows)
        from ..dna import decode
        from ..native.api import (INTERNAL_KIND, PREFIX_KIND, SUFFIX_KIND,
                                  native_window_consensus_batch)
        jobs = []
        poa_windows = []
        for w in windows:
            num_non_empty = w.num_internal + w.num_pre + w.num_suf
            if w.num_empty > num_non_empty:
                w.consensus = ""
            elif num_non_empty >= 2:
                trivial = self._trivial_consensus(w)
                if trivial is not None:
                    w.consensus = trivial
                    continue
                arms = ([(a.tobytes(), INTERNAL_KIND)
                         for a in w.internal_arms]
                        + [(a.tobytes(), PREFIX_KIND) for a in w.pre_arms]
                        + [(a.tobytes(), SUFFIX_KIND) for a in w.suf_arms])
                # codes 0..3 -> ASCII via translate (C-speed)
                arms = [(ab.translate(_CODE2ASCII), k) for ab, k in arms]
                jobs.append((w.wtype, w.draft.tobytes().translate(
                    _CODE2ASCII), arms, w.num_internal, w.num_empty))
                poa_windows.append(w)
            else:
                w.consensus = decode(w.draft)
        if jobs:
            sp = self.sp
            res = native_window_consensus_batch(
                jobs, (sp.sr_match, sp.sr_mismatch, sp.sr_gap),
                (sp.lr_match, sp.lr_mismatch, sp.lr_gap),
                self.fix_long_align_type, nthreads)
            for w, cons in zip(poa_windows, res):
                if cons is None:  # overflow: serial fallback
                    self.generate_consensus(w)
                else:
                    w.consensus = cons
        return len(windows)

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

    def _native(self, window):
        from ..native import native_window_consensus
        from ..native.api import (INTERNAL_KIND, PREFIX_KIND, SUFFIX_KIND)
        sp = self.sp
        scores = ((sp.sr_match, sp.sr_mismatch, sp.sr_gap)
                  if window.wtype == 0 else
                  (sp.lr_match, sp.lr_mismatch, sp.lr_gap))
        arms = ([(a, INTERNAL_KIND) for a in window.internal_arms]
                + [(a, PREFIX_KIND) for a in window.pre_arms]
                + [(a, SUFFIX_KIND) for a in window.suf_arms])
        return native_window_consensus(
            window.wtype, window.draft, arms, window.num_internal,
            window.num_empty, scores, self.fix_long_align_type)

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
