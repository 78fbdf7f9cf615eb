"""Window: draft slice + arm lists + consensus state.

Port of reference include/Window.hpp / src/Window.cpp.  The POA itself
lives in hypo_tpu.poa; this class holds arms (as code arrays), applies
the long-window arm filter, and exposes the counters the pruning rules
read (note get_num_internal counts EMPTY arms too, Window.hpp:107).

Copied from hypo_tpu/pipeline/window.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..poa.filter import LongArmFilter

SHORT, LONG = 0, 1


class Window:
    """A window's arm lists start as the shared empty tuple and become
    lists at their first arm: a contig holds one window a weak region
    (~100,000 on a 4.6 Mbp draft), most of which the tile path never
    gives a list."""

    __slots__ = ("wtype", "draft", "internal_arms", "pre_arms", "suf_arms",
                 "num_internal", "num_pre", "num_suf", "num_empty",
                 "longest_pre_len", "longest_suf_len", "consensus",
                 "_filter")

    def __init__(self, draft_codes: np.ndarray, wtype: int = SHORT):
        self.wtype = wtype
        self.draft = draft_codes
        self.internal_arms = self.pre_arms = self.suf_arms = ()
        self.num_internal = self.num_pre = self.num_suf = 0
        self.num_empty = self.longest_pre_len = self.longest_suf_len = 0
        self.consensus: Optional[str] = None
        self._filter = LongArmFilter(draft_codes) if wtype == LONG else None

    def _passes_filter(self, codes: np.ndarray) -> bool:
        if self.wtype == LONG:
            return self._filter.is_good(codes)
        return True

    def add_prefix(self, codes: np.ndarray) -> None:
        if self._passes_filter(codes):
            self.num_pre += 1
            self.longest_pre_len = max(self.longest_pre_len, len(codes))
            if self.pre_arms:
                self.pre_arms.append(codes)
            else:
                self.pre_arms = [codes]

    def add_suffix(self, codes: np.ndarray) -> None:
        if self._passes_filter(codes):
            self.num_suf += 1
            self.longest_suf_len = max(self.longest_suf_len, len(codes))
            if self.suf_arms:
                self.suf_arms.append(codes)
            else:
                self.suf_arms = [codes]

    def add_internal(self, codes: np.ndarray) -> None:
        if self._passes_filter(codes):
            self.num_internal += 1
            if self.internal_arms:
                self.internal_arms.append(codes)
            else:
                self.internal_arms = [codes]

    def add_empty(self) -> None:
        self.num_empty += 1

    def get_num_internal(self) -> int:
        # empty arms count as internal evidence (Window.hpp:107)
        return self.num_internal + self.num_empty

    def get_num_total(self) -> int:
        return (self.num_internal + self.num_empty + self.num_pre
                + self.num_suf)

    def clear_arms(self) -> None:
        """Drop the arm code arrays once the FINAL consensus is set (the
        counters survive for --inspect dumps).  The reference keeps
        every window's PackedSeq arms alive until the contig is
        destroyed after output — a large share of its 380 GB human-run
        footprint; freeing them per consensus caps our per-batch RSS."""
        self.internal_arms = self.pre_arms = self.suf_arms = ()

    def clear_pre_suf(self) -> None:
        self.num_pre = 0
        self.num_suf = 0
        self.pre_arms = self.suf_arms = ()

    def window_len(self) -> int:
        return len(self.draft)
