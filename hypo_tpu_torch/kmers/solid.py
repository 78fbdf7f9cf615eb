"""Solid-kmer set as a flat 4^k bitmask.

Replaces reference external/suk (SolidKmers over an sdsl bit_vector,
suk/include/suk/SolidKmers.hpp + src/SolidKmers.cpp).  Selection rule
(SolidKmers.cpp:166-190): canonical kmers whose count lies in
[lower, upper] and whose canonical form has no homopolymer pair at either
terminal (first two or last two bases equal — a strand-symmetric test);
bits set for BOTH forward and revcomp packings.

Copied from hypo_tpu/kmers/solid.py, with the counter's thread count
(``threads``) passed through.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..dna import revcomp_kmers
from .counting import KmerCounter, count_files
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
                   exclude_hp: bool = True,
                   counter: Optional[KmerCounter] = None,
                   threads: int = 0) -> "SolidKmers":
        """Count reads, find cutoffs, and fill the bitmask.
        Mirrors SolidKmers::initialise minus the KMC subprocess.
        ``threads``: the native counter's (0: OpenMP's default)."""
        hist_freq = 4 * coverage
        if counter is None:
            counter = count_files(filenames, self.k, cap=hist_freq + 1,
                                  threads=threads)
        codes, counts = counter.items()
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

    # -- persistence (replaces sdsl serialize; reference SKFILE) ----------
    def store(self, path: str) -> None:
        np.savez_compressed(path, k=self.k, words=self.bitset.words,
                            num_solid=self.num_solid)

    @classmethod
    def load(cls, path: str) -> "SolidKmers":
        with np.load(path) as z:
            sk = cls(int(z["k"]))
            sk.bitset = Bitset(1 << (2 * sk.k), z["words"])
            sk.num_solid = int(z["num_solid"])
        return sk

    # -- reference-format interop ------------------------------------------
    def store_sdsl(self, path: str) -> None:
        """Write the bitmask in the reference's aux/solid_kmers.bvsd
        format — an sdsl::bit_vector serialization: uint64 bit count
        followed by raw little-endian uint64 words (sdsl int_vector<1>,
        reference external/sdsl-lite/include/sdsl/int_vector.hpp:
        1563-1578).  Lets the reference binary resume from our solid-
        kmer stage (-i), which the differential end-to-end test uses to
        bypass its KMC subprocess dependency."""
        with open(path, "wb") as fh:
            fh.write(np.uint64(self.bitset.nbits).tobytes())
            fh.write(self.bitset.words.astype("<u8").tobytes())

    @classmethod
    def load_sdsl(cls, path: str, k: int) -> "SolidKmers":
        """Read the reference's aux/solid_kmers.bvsd (see store_sdsl)."""
        with open(path, "rb") as fh:
            nbits = int(np.frombuffer(fh.read(8), "<u8")[0])
            words = np.frombuffer(fh.read(), "<u8").copy()
        assert nbits == 1 << (2 * k), (nbits, k)
        sk = cls(k)
        sk.bitset = Bitset(nbits, words[:(nbits + 63) // 64])
        sk.num_solid = -1  # canonical count is not stored in the format
        return sk
