"""Canonical k-mer counts over the short reads, for the solid k-mer set.

The port counts with ``hypo_tpu_torch.kmers.counting.KmerCounter``
(reads joined by single ``N`` separators, one rolling k-mer pass, N
breaks a k-mer, canonical = numeric min of the forward and reverse
complement 2-bit packings, counts clamped at ``cap``).  This is the
same count done plainly: the FASTA / FASTQ file read whole, the reads
joined by ``N`` and counted with one ``np.bincount`` per block of reads
into a dense 4^k table.
"""
from __future__ import annotations

import gzip
from typing import List, Tuple

import numpy as np

from .dna import _ENC_LUT

BLOCK_BASES = 16_000_000


def read_seqs(path: str) -> List[bytes]:
    """Every sequence of a FASTA or FASTQ file, plain or gzipped."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    lines = raw.split(b"\n")
    if raw[:1] == b"@":
        return lines[1::4]
    if raw[:1] != b">":
        raise ValueError(f"{path}: not FASTA/FASTQ")
    seqs: List[bytes] = []
    cur: List[bytes] = []
    for line in lines[1:]:
        if line.startswith(b">"):
            seqs.append(b"".join(cur))
            cur = []
        else:
            cur.append(line.strip())
    seqs.append(b"".join(cur))
    return seqs


def _packings(c: np.ndarray, k: int, fwd: bool) -> np.ndarray:
    """The 2-bit packing of each k-mer of ``c`` (codes 0..3): forward,
    big-endian (``dna.kmer_codes``), or of its reverse complement
    (``dna.revcomp_kmers``), built by doubling the packed length."""
    cur = c if fwd else 3 - c
    ln = 1
    out = None
    out_ln = 0
    rem = k
    while rem:
        if rem & 1:
            m = len(c) - (out_ln + ln) + 1
            if out is None:
                out = cur[:m].copy()
            elif fwd:
                out = (out[:m] << np.uint32(2 * ln)) | cur[out_ln:out_ln + m]
            else:
                out = out[:m] | (cur[out_ln:out_ln + m] << np.uint32(2 * out_ln))
            out_ln += ln
        rem >>= 1
        if rem:
            m = len(cur) - ln
            if fwd:
                cur = (cur[:m] << np.uint32(2 * ln)) | cur[ln:ln + m]
            else:
                cur = cur[:m] | (cur[ln:ln + m] << np.uint32(2 * ln))
            ln *= 2
    return out


def _canonical_block(codes: np.ndarray, k: int) -> np.ndarray:
    """The canonical packing of every k-mer of ``codes`` that holds no N
    (``dna.canonical_kmers`` of ``dna.kmer_codes``' valid k-mers), in
    uint32 arithmetic (4^k <= 2^32)."""
    c = (codes & 3).astype(np.uint32)
    can = np.minimum(_packings(c, k, True), _packings(c, k, False))
    bad = np.concatenate(([0], np.cumsum(codes > 3)))
    return can[(bad[k:] - bad[:-k]) == 0]


def read_blocks(paths: List[str], block_bases: int = BLOCK_BASES
                ) -> List[bytes]:
    """The reads of ``paths`` joined by ``N`` (one after each read) into
    blocks of about ``block_bases``, cut between reads."""
    blocks: List[bytes] = []
    for path in paths:
        seqs = read_seqs(path)
        lo = 0
        while lo < len(seqs):
            hi, n = lo, 0
            while hi < len(seqs) and n < block_bases:
                n += len(seqs[hi]) + 1
                hi += 1
            blocks.append(b"N".join(seqs[lo:hi]) + b"N")
            lo = hi
    return blocks


def count_block(block: bytes, k: int) -> np.ndarray:
    """The dense 4^k table of one block's canonical k-mer counts (int32:
    a block holds fewer than 2^31 k-mers)."""
    if k > 16:
        raise ValueError(f"k = {k}: the dense table holds k <= 16")
    codes = _ENC_LUT[np.frombuffer(block, np.uint8)]
    if len(codes) < k:
        return np.zeros(1 << (2 * k), np.int32)
    return np.bincount(_canonical_block(codes, k),
                       minlength=1 << (2 * k)).astype(np.int32)


def table_items(table: np.ndarray,
                cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, counts) of every canonical k-mer seen at least once,
    counts clamped at ``cap``."""
    nz = np.flatnonzero(table)
    return nz.astype(np.int64), np.minimum(table[nz], cap).astype(np.uint32)


def count_reads(paths: List[str], k: int,
                cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, counts) of every canonical k-mer seen at least once,
    counts clamped at ``cap``."""
    table = np.zeros(1 << (2 * k), np.int64)
    for block in read_blocks(paths):
        table += count_block(block, k)
    return table_items(table, cap)
