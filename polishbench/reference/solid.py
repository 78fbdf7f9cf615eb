"""Solid-kmer set as a flat 4^k bitmask.

Replaces reference external/suk (SolidKmers over an sdsl bit_vector,
suk/include/suk/SolidKmers.hpp + src/SolidKmers.cpp).  Selection rule
(SolidKmers.cpp:166-190): canonical kmers whose count lies in
[lower, upper] and whose canonical form has no homopolymer pair at either
terminal (first two or last two bases equal — a strand-symmetric test);
bits set for BOTH forward and revcomp packings.

Frozen copy of hypo_tpu_torch/kmers/solid.py (the port's copy of
hypo_tpu/kmers/solid.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .dna import revcomp_kmers
from .counting import count_reads, table_items
from .cutoffs import CutOffs, find_cutoffs


class Bitset:
    """Bit array over uint64 words with vectorized get/set."""

    def __init__(self, nbits: int, words: Optional[np.ndarray] = None):
        self.nbits = nbits
        if words is None:
            self.words = np.zeros((nbits + 63) // 64, dtype=np.uint64)
        else:
            assert len(words) == (nbits + 63) // 64
            self.words = words

    def set_many(self, idx: np.ndarray) -> None:
        w = idx >> 6
        b = np.uint64(1) << (idx.astype(np.uint64) & np.uint64(63))
        np.bitwise_or.at(self.words, w, b)

    def test(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx)
        w = idx >> 6
        sh = (idx.astype(np.uint64) & np.uint64(63))
        return ((self.words[w] >> sh) & np.uint64(1)).astype(bool)

    def count(self) -> int:
        return int(np.unpackbits(self.words.view(np.uint8)).sum())


class SolidKmers:
    """Solid k-mer membership with HyPo's selection semantics."""

    def __init__(self, k: int):
        self.k = k
        self.bitset = Bitset(1 << (2 * k))
        self.num_solid = 0  # canonical count (reference _num_Solid_kmers)
        self.cutoffs: Optional[CutOffs] = None

    # -- construction -----------------------------------------------------
    def initialise(self, filenames: List[str], coverage: int,
                   exclude_hp: bool = True) -> "SolidKmers":
        """Count reads, find cutoffs, and fill the bitmask.
        Mirrors SolidKmers::initialise minus the KMC subprocess."""
        codes, counts = count_reads(filenames, self.k, cap=4 * coverage + 1)
        return self.initialise_from_counts(codes, counts, coverage,
                                           exclude_hp)

    def initialise_from_table(self, table: np.ndarray, coverage: int,
                              exclude_hp: bool = True) -> "SolidKmers":
        """As ``initialise``, from a dense table of canonical counts."""
        codes, counts = table_items(table, 4 * coverage + 1)
        return self.initialise_from_counts(codes, counts, coverage,
                                           exclude_hp)

    def initialise_from_counts(self, codes: np.ndarray,
                               counts: np.ndarray, coverage: int,
                               exclude_hp: bool = True) -> "SolidKmers":
        """Cutoffs + bitmask from a (possibly merged-across-hosts)
        global canonical k-mer count table.  The selection semantics
        apply to GLOBAL counts, matching the reference where KMC sees
        every read file (SolidKmers.cpp:104-190)."""
        hist_freq = 4 * coverage
        counts = np.minimum(counts, hist_freq + 1)
        # KMC is invoked with -ci2: singletons never enter the database
        keep = counts >= 2
        codes, counts = codes[keep], counts[keep]
        sel = counts <= hist_freq
        hist = np.bincount(counts[sel].astype(np.int64),
                           minlength=hist_freq + 1)[:hist_freq + 1]
        self.cutoffs = find_cutoffs(hist)
        self.fill(codes, counts, self.cutoffs.lower, self.cutoffs.upper,
                  exclude_hp)
        return self

    def fill(self, codes: np.ndarray, counts: np.ndarray, lower: int,
             upper: int, exclude_hp: bool = True) -> None:
        sel = (counts >= lower) & (counts <= upper)
        kmers = codes[sel]
        if exclude_hp and len(kmers):
            k = self.k
            first = (kmers >> (2 * (k - 1))) & 3
            second = (kmers >> (2 * (k - 2))) & 3
            last = kmers & 3
            second_last = (kmers >> 2) & 3
            ok = (first != second) & (last != second_last)
            kmers = kmers[ok]
        if len(kmers):
            rc = revcomp_kmers(kmers, self.k)
            self.bitset.set_many(kmers)
            self.bitset.set_many(rc)
        self.num_solid += len(kmers)

    # -- queries ----------------------------------------------------------
    def is_solid(self, kmer_codes: np.ndarray) -> np.ndarray:
        return self.bitset.test(kmer_codes)

    def get_num_solid_kmers(self) -> int:
        return self.num_solid
