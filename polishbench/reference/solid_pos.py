"""Solid-position discovery on a draft contig.

Vectorized equivalent of reference Contig::find_solid_pos
(src/Contig.cpp:40-74): mark each position where a solid k-mer starts,
excluding k-mers whose terminals extend a homopolymer (the last base
equals the next base, or the first base equals the previous base).

Frozen copy of hypo_tpu_torch/segment/solid_pos.py (the port's copy of
hypo_tpu/segment/solid_pos.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .dna import kmer_codes
from .solid import SolidKmers


def find_solid_pos(codes: np.ndarray, sk: SolidKmers
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (positions int64[], kids int64[]) sorted by position."""
    k = sk.k
    n = len(codes)
    km, valid = kmer_codes(codes, k)
    if len(km) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    keep = valid & sk.is_solid(np.where(valid, km, 0))
    # k-mer with start s covers [s, s+k); end base index e = s+k-1.
    # Exclude if the base after the kmer equals its last base, or the
    # base before equals its first base (homopolymer-terminal rule).
    keep[:-1] &= codes[k:] != codes[k - 1:-1]
    keep[1:] &= codes[:n - k] != codes[1:n - k + 1]
    pos = np.flatnonzero(keep)
    return pos, km[pos]
