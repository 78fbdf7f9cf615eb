"""Per-MegaWindow minimizer tables.

Port of reference Contig::initialise_minimserinfo (src/Contig.cpp:455-524):
forward-strand minimizers (k=10, w=10) of the MegaWindow draft, keeping
only minimizers whose value is unique within the MW and is not a
poly-base 10-mer; positions stored as deltas from the previous kept one.

Frozen copy of hypo_tpu_torch/segment/minimizers.py (the port's copy of
hypo_tpu/segment/minimizers.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .config import MINIMIZER_SETTINGS as MS
from .dna import minimizer_scan


@dataclasses.dataclass
class MWMinimizerInfo:
    minimisers: np.ndarray  # int64 values
    rel_pos: np.ndarray     # int64 deltas (first is relative to MW start)
    support: np.ndarray     # int32
    coverage: np.ndarray    # int32

    @property
    def abs_pos(self) -> np.ndarray:
        return np.cumsum(self.rel_pos)


_POLY = (MS.poly_a, MS.poly_c, MS.poly_g, MS.poly_t)


def build_mw_minimizer_info(codes: np.ndarray) -> MWMinimizerInfo:
    """codes: the MegaWindow slice of the draft."""
    vals, poss = minimizer_scan(codes, MS.k, MS.w, canonical=False)
    if len(vals):
        _, counts = np.unique(vals, return_counts=True)
        uniq_vals = set(np.unique(vals)[counts == 1].tolist())
        keep = np.fromiter(((int(v) in uniq_vals) and (int(v) not in _POLY)
                            for v in vals), dtype=bool, count=len(vals))
        vals, poss = vals[keep], poss[keep]
    rel = np.diff(np.concatenate([[0], poss])) if len(poss) else poss
    n = len(vals)
    return MWMinimizerInfo(vals.astype(np.int64), rel.astype(np.int64),
                           np.zeros(n, dtype=np.int32),
                           np.zeros(n, dtype=np.int32))
