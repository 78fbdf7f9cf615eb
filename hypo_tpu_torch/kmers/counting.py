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

With the native host library a file's gzip inflate and FASTA/FASTQ parse
run on a thread of their own (``decoded_chunks``), one chunk ahead of
the native counter, which counts on the caller's thread: the two
overlap instead of taking turns.  Counts are sums, so the table is the
one the chunks give in any order.

Copied from hypo_tpu/kmers/counting.py, with ``decoded_chunks`` and the
counter's OpenMP thread count (``threads``) added.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List, Tuple

import numpy as np

from ..dna import canonical_kmers, encode, kmer_codes
from ..io.fasta import read_fastx
from ..utils import trace

DENSE_LIMIT = 1 << 26  # use a dense bincount table when 4^k <= 64M entries
# codes in one decoded chunk: small enough that the count of the last
# chunk, which nothing hides, is short; a line must fit in one
FASTX_CHUNK = 8 << 20
FASTX_DEPTH = 3         # decoded chunks in flight: one counted, two ahead


class KmerCounter:
    """Streaming canonical k-mer counter with dense/sparse backends."""

    def __init__(self, k: int, cap: int = 0xFFFF, threads: int = 0):
        self.k = k
        self.cap = cap
        self.threads = threads  # the native counter's; 0: OpenMP's default
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
                host_api.count_kmers_dense(codes, self.k, self._table,
                                           self.threads)
                return
        elif self._native_sparse is not None:
            self._native_sparse.add(codes, self.threads)
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
            codes, counts = self._native_sparse.items(self.threads)
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


def decoded_chunks(path: str) -> Iterator[np.ndarray]:
    """The read codes of ``path`` in chunks (``host_api.FastxCodeStream``),
    inflated and parsed on a producer thread while the caller works on
    the chunk before.  The producer fills a ring of ``FASTX_DEPTH``
    buffers of ``FASTX_CHUNK`` codes; each chunk is a view of one, which
    goes back to the producer when the caller asks for the next chunk,
    so a chunk stays valid until then.  Each chunk's decode is a
    ``pipeline.fastq_decode`` span on the producer's thread, under the
    span open here.  A file that cannot be opened raises here, as the
    stream does; the thread has ended when the generator has."""
    from ..native import host_api
    stream = host_api.FastxCodeStream(path, FASTX_CHUNK)
    free: "queue.Queue" = queue.Queue()
    full: "queue.Queue" = queue.Queue()
    for _ in range(FASTX_DEPTH):
        free.put(np.empty(FASTX_CHUNK, np.uint8))
    stop = threading.Event()
    errors: List[BaseException] = []
    parent = trace.current()

    def produce() -> None:
        try:
            with trace.under(parent):
                while not stop.is_set():
                    buf = free.get()
                    if buf is None:
                        break
                    with trace.span("pipeline.fastq_decode"):
                        n = stream.read(buf)
                    if n == 0:
                        break
                    full.put((buf, n))
        except BaseException as e:  # raised on the caller's thread
            errors.append(e)
        finally:
            stream.close()
            full.put(None)

    thread = threading.Thread(target=produce, daemon=True,
                              name="hypo-fastq-decode")
    thread.start()
    try:
        while True:
            item = full.get()
            if item is None:
                break
            buf, n = item
            yield buf[:n]
            free.put(buf)
        if errors:
            raise errors[0]
    finally:
        stop.set()
        free.put(None)
        thread.join()


def count_files(filenames: List[str], k: int, cap: int = 0xFFFF,
                stride: int = 1, offset: int = 0,
                threads: int = 0) -> KmerCounter:
    """Count canonical kmers of the given files.  stride/offset select
    every stride-th read starting at offset — the distributed counting
    path uses this to shard READS across ranks when there are fewer
    read files than ranks.  ``threads``: the native counter's OpenMP
    threads (0: OpenMP's default)."""
    import itertools
    counter = KmerCounter(k, cap, threads)
    from ..native import host_api
    for fn in filenames:
        if stride == 1 and host_api.available():
            # native gz->codes stream, decoded on its own thread while
            # the chunk before is counted: no per-read python strings
            for chunk in decoded_chunks(fn):
                counter.add_codes(chunk)
            continue
        seqs = (seq for _name, seq in read_fastx(fn))
        if stride > 1:
            seqs = itertools.islice(seqs, offset, None, stride)
        counter.add_reads(seqs)
    return counter
