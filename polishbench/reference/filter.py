"""Long-arm sanity filter: canonical-minimizer sharing with the window
draft (port of reference include/Filter.hpp:30-110; accepts an arm iff it
shares at least one draft minimizer per 50 bp).

Frozen copy of hypo_tpu_torch/poa/filter.py (the port's copy of
hypo_tpu/poa/filter.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

import numpy as np

from .dna import minimizer_scan

_K = 10
_W = 10
_THRESHOLD_BP = 50


class LongArmFilter:
    def __init__(self, draft_codes: np.ndarray):
        vals, _pos = minimizer_scan(draft_codes, _K, _W, canonical=True)
        self._draft_minimizers = set(vals.tolist())

    def is_good(self, arm_codes: np.ndarray) -> bool:
        vals, _pos = minimizer_scan(arm_codes, _K, _W, canonical=True)
        found = sum(1 for v in vals.tolist() if v in self._draft_minimizers)
        return found * _THRESHOLD_BP >= len(arm_codes)
