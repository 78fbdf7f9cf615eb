"""Canonical k-mer counting over read sets (the KMC3 role).

The reference forks the external KMC3 binary and re-reads its database
(reference external/suk/src/SolidKmers.cpp:104-190).  Here counting is an
in-process vectorized pipeline over packed code arrays:

- reads are concatenated with single-``N`` separators so one rolling
  k-mer pass handles all read boundaries;
- canonical form = numeric min of forward/revcomp 2-bit packings
  (equivalent to KMC's lexicographic canonicalization under A<C<G<T);
- a dense ``bincount`` accumulator is used when 4**k fits comfortably in
  memory, otherwise a sorted sparse (codes, counts) accumulator that is
  periodically compacted.

Counts saturate at ``cap`` (KMC ``-cs``): we clamp instead of dropping
kmers above ``-cx`` since downstream only reads counts within
``[2, 4*coverage]`` anyway.

Copied from hypo_tpu/kmers/counting.py.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from ..dna import canonical_kmers, encode, kmer_codes
from ..io.fasta import read_fastx

DENSE_LIMIT = 1 << 26  # use a dense bincount table when 4^k <= 64M entries


class KmerCounter:
    """Streaming canonical k-mer counter with dense/sparse backends."""

    def __init__(self, k: int, cap: int = 0xFFFF):
        self.k = k
        self.cap = cap
        self.size = 1 << (2 * k)
        self.dense = self.size <= DENSE_LIMIT
        self._native_sparse = None
        if self.dense:
            self._table = np.zeros(self.size, dtype=np.uint32)
        else:
            from ..native import host_api
            if host_api.available():
                # the KMC3-scale path: radix-partitioned native
                # accumulator, memory bounded by distinct kmers
                self._native_sparse = host_api.SparseCounterNative(k)
            self._codes = np.zeros(0, dtype=np.int64)
            self._counts = np.zeros(0, dtype=np.uint32)
            self._pending: List[np.ndarray] = []
            self._pending_n = 0

    def add_codes(self, codes: np.ndarray) -> None:
        """Add every valid canonical k-mer of a code array (N breaks runs)."""
        if self.dense:
            from ..native import host_api
            if host_api.available():
                host_api.count_kmers_dense(codes, self.k, self._table)
                return
        elif self._native_sparse is not None:
            self._native_sparse.add(codes)
            return
        km, valid = kmer_codes(codes, self.k)
        km = km[valid]
        if len(km) == 0:
            return
        can = canonical_kmers(km, self.k)
        if self.dense:
            np.add.at(self._table, can, 1)
        else:
            self._pending.append(can)
            self._pending_n += len(can)
            if self._pending_n > 32_000_000:
                self._compact()

    def add_reads(self, seqs: Iterable[str], chunk_bases: int = 8_000_000
                  ) -> None:
        """Add reads, batching them into big code arrays joined by N."""
        buf: List[np.ndarray] = []
        total = 0
        sep = np.array([4], dtype=np.uint8)
        for s in seqs:
            buf.append(encode(s))
            buf.append(sep)
            total += len(s) + 1
            if total >= chunk_bases:
                self.add_codes(np.concatenate(buf))
                buf, total = [], 0
        if buf:
            self.add_codes(np.concatenate(buf))

    def _compact(self) -> None:
        parts = [self._codes] + self._pending
        weights = [self._counts] + [None] * len(self._pending)
        allc = np.concatenate(parts)
        w = np.concatenate([
            wt if wt is not None else np.ones(len(p), dtype=np.uint32)
            for p, wt in zip(parts, weights)])
        order = np.argsort(allc, kind="stable")
        allc = allc[order]
        w = w[order]
        uniq, start = np.unique(allc, return_index=True)
        sums = np.add.reduceat(w.astype(np.uint64), start)
        self._codes = uniq
        self._counts = np.minimum(sums, self.cap).astype(np.uint32)
        self._pending = []
        self._pending_n = 0

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(codes, counts) of all canonical kmers with count >= 1,
        counts clamped at cap."""
        if self.dense:
            nz = np.nonzero(self._table)[0]
            return nz.astype(np.int64), np.minimum(self._table[nz], self.cap)
        if self._native_sparse is not None:
            codes, counts = self._native_sparse.items()
            return codes, np.minimum(counts, self.cap).astype(np.uint32)
        self._compact()
        return self._codes, self._counts

    def histogram(self, max_freq: int) -> np.ndarray:
        """hist[c] = number of distinct canonical kmers with count c, for
        c in [0, max_freq]; counts above max_freq are ignored, matching the
        reference histogram fill (SolidKmers.cpp:148-149)."""
        _, counts = self.items()
        sel = counts <= max_freq
        return np.bincount(counts[sel], minlength=max_freq + 1
                           ).astype(np.int64)[:max_freq + 1]


def count_files(filenames: List[str], k: int, cap: int = 0xFFFF,
                stride: int = 1, offset: int = 0) -> KmerCounter:
    """Count canonical kmers of the given files.  stride/offset select
    every stride-th read starting at offset — the distributed counting
    path uses this to shard READS across ranks when there are fewer
    read files than ranks."""
    import itertools
    counter = KmerCounter(k, cap)
    from ..native import host_api
    for fn in filenames:
        if stride == 1 and host_api.available():
            # native gz->codes stream: no per-read python strings
            for chunk in host_api.FastxCodeStream(fn):
                counter.add_codes(chunk)
            continue
        seqs = (seq for _name, seq in read_fastx(fn))
        if stride > 1:
            seqs = itertools.islice(seqs, offset, None, stride)
        counter.add_reads(seqs)
    return counter
