"""DNA encoding and k-mer/minimizer primitives (host side, vectorized numpy).

Replaces the reference's PackedSeq/MinimizerDeque machinery
(reference include/PackedSeq.hpp, include/MinimizerDeque.hpp) with flat
uint8 code arrays and vectorized scans.  Codes: A=0 C=1 G=2 T=3 N/other=4
(reference globalDefs.hpp:161-178 cNt4Table).

The minimizer scan reproduces the reference's deque semantics
(reference src/Contig.cpp:455-524 and include/Filter.hpp:33-62):
windows of w k-mers, leftmost minimum wins ties, consecutive duplicate
positions deduplicated.

Frozen copy of hypo_tpu_torch/dna.py (the port's copy of
hypo_tpu/dna.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Encoding

_ENC_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _ENC_LUT[ord(_c)] = _i
    _ENC_LUT[ord(_c.lower())] = _i
_ENC_LUT[ord("U")] = 3  # cNt4Table maps 'U'/'u' to T as well
_ENC_LUT[ord("u")] = 3

_DEC_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)

# htslib 4-bit nibble -> 2-bit code (A=1,C=2,G=4,T=8 one-hot; else N)
HTS_NIBBLE_TO_CODE = np.full(16, 4, dtype=np.uint8)
HTS_NIBBLE_TO_CODE[1] = 0  # A
HTS_NIBBLE_TO_CODE[2] = 1  # C
HTS_NIBBLE_TO_CODE[4] = 2  # G
HTS_NIBBLE_TO_CODE[8] = 3  # T


def encode(seq: str) -> np.ndarray:
    """ASCII string -> uint8 code array."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENC_LUT[raw]


def decode(codes: np.ndarray) -> str:
    return _DEC_LUT[np.minimum(codes, 4)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (N stays N)."""
    out = codes[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out


# ---------------------------------------------------------------------------
# 2-bit packing (the PackedSeq<2> role, reference
# include/PackedSeq.hpp:80-160): 4 bases per byte, base i at bits
# (i & 3) * 2 of byte i >> 2.  N-free codes only (callers drop
# N-containing reads, matching reference copy_data Alignment.cpp:557).

def pack2(codes: np.ndarray) -> np.ndarray:
    """uint8 codes (0..3) -> packed uint8 array of ceil(n/4) bytes."""
    n = len(codes)
    padded = np.zeros((n + 3) & ~3, dtype=np.uint8)
    padded[:n] = codes
    q = padded.reshape(-1, 4).astype(np.uint16)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
            | (q[:, 3] << 6)).astype(np.uint8)


def unpack2(packed: np.ndarray, start: int, length: int) -> np.ndarray:
    """Base slice [start, start+length) of a 2-bit packed buffer."""
    if length <= 0:
        return np.zeros(0, dtype=np.uint8)
    b0 = start >> 2
    b1 = (start + length + 3) >> 2
    chunk = packed[b0:b1]
    out = np.empty(4 * len(chunk), dtype=np.uint8)
    out[0::4] = chunk & 3
    out[1::4] = (chunk >> 2) & 3
    out[2::4] = (chunk >> 4) & 3
    out[3::4] = (chunk >> 6) & 3
    o = start - 4 * b0
    return out[o:o + length]


# ---------------------------------------------------------------------------
# K-mer codes

def kmer_codes(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """All k-mer 2-bit packings of `codes`, plus a validity mask.

    Returns (kmers int64[n-k+1], valid bool[n-k+1]); kmers[i] packs
    codes[i:i+k] big-endian 2 bits per base; valid[i] iff no N in window.
    Empty arrays if n < k.
    """
    n = len(codes)
    if n < k:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool))
    c = codes.astype(np.int64)
    np.bitwise_and(c, 3, out=c)
    bad = (codes > 3)
    # k shifted ORs instead of an int64 matvec (numpy integer matmul has
    # no BLAS path and is ~100x slower at genome scale); one reused
    # temp keeps the allocation high-water at 2 arrays
    m = n - k + 1
    kmers = np.zeros(m, dtype=np.int64)
    tmp = np.empty(m, dtype=np.int64)
    for j in range(k):
        np.left_shift(c[j:j + m], np.int64(2 * (k - 1 - j)), out=tmp)
        np.bitwise_or(kmers, tmp, out=kmers)
    if bad.any():
        badcum = np.concatenate([[0], np.cumsum(bad)])
        valid = (badcum[k:] - badcum[:-k]) == 0
    else:
        valid = np.ones(n - k + 1, dtype=bool)
    return kmers, valid


def revcomp_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of packed k-mers (vectorized)."""
    out = np.zeros_like(kmers)
    x = kmers.copy()
    for _ in range(k):
        out = (out << 2) | (3 - (x & 3))
        x >>= 2
    return out


def canonical_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Canonical = numeric min of fwd/rc packing (== lexicographic min)."""
    return np.minimum(kmers, revcomp_kmers(kmers, k))


import functools


@functools.lru_cache(maxsize=65536)
def kmer_to_bytes(val: int, k: int) -> bytes:
    """Packed k-mer value -> its k-byte code pattern (codes 0..3).

    Byte-wise equality with a code array's ``tobytes()`` view is exactly
    the reference's PackedSeq::check_kmer / find_kmer match (N bases have
    code 4 and can never equal a pattern byte, reproducing the validity
    mask for free)."""
    out = bytearray(k)
    for i in range(k - 1, -1, -1):
        out[i] = val & 3
        val >>= 2
    return bytes(out)


def check_kmer(codes: np.ndarray, target: int, k: int, ind: int) -> bool:
    """Does the k-mer equal to `target` END anywhere while scanning
    codes[ind:ind+k]?  Faithful to reference PackedSeq::check_kmer
    (src/PackedSeq.cpp:264-289): a rolling scan over exactly k bases, so
    with all-ACGT input this is just codes[ind:ind+k] == target.
    """
    kmers, valid = kmer_codes(codes[ind:ind + k], k)
    return bool(len(kmers) and valid[0] and kmers[0] == target)


def find_kmer(codes: np.ndarray, target: int, k: int, left: int, right: int,
              first: bool):
    """Find first/last occurrence start of `target` k-mer with the k-mer
    fully inside [left, right).  Returns start index or None.
    Faithful to reference PackedSeq::find_kmer (src/PackedSeq.cpp:291-320).
    """
    if right <= left:
        return None
    sub = codes[left:right]
    kmers, valid = kmer_codes(sub, k)
    hits = np.nonzero((kmers == target) & valid)[0]
    if len(hits) == 0:
        return None
    return int(left + (hits[0] if first else hits[-1]))


# ---------------------------------------------------------------------------
# Minimizers

def minimizer_scan_ref(codes: np.ndarray, k: int, w: int,
                       canonical: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Deque-faithful minimizer scan (oracle).

    Reproduces the reference loop structure exactly, including its
    handling of N bases (count_not_N resets; the deque and processed_kmer
    counter do not): reference src/Contig.cpp:474-502 (forward-only) and
    include/Filter.hpp:40-61 (canonical).

    Returns (values, positions): minimizer k-mer values and the 0-based
    start position of each recorded minimizer (deduplicated by position).
    """
    n = len(codes)
    mask = (1 << (2 * k)) - 1
    shift = 2 * (k - 1)
    fwd = 0
    rc = 0
    count_not_n = 0
    processed = 0
    last_pos = n + 1  # sentinel meaning "no minimizer recorded yet"
    deque: List[Tuple[int, int]] = []  # (kmer, end_pos)
    vals: List[int] = []
    poss: List[int] = []
    for i in range(n):
        c = int(codes[i])
        if c < 4:
            count_not_n += 1
            fwd = ((fwd << 2) | c) & mask
            if canonical:
                rc = (rc >> 2) | ((3 ^ c) << shift)
                km = fwd if fwd < rc else rc
            else:
                km = fwd
            if count_not_n >= k:
                while deque and deque[-1][0] > km:
                    deque.pop()
                deque.append((km, i))
                while deque[0][1] + w <= i:
                    deque.pop(0)
                processed += 1
                if processed >= w:
                    pos = deque[0][1] - k + 1
                    if pos != last_pos:
                        vals.append(deque[0][0])
                        poss.append(pos)
                    last_pos = pos
        else:
            count_not_n = 0
    return (np.array(vals, dtype=np.int64), np.array(poss, dtype=np.int64))


def minimizer_scan(codes: np.ndarray, k: int, w: int,
                   canonical: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized minimizer scan; equals minimizer_scan_ref on N-free
    input (falls back to the oracle when N present)."""
    n = len(codes)
    if n < k + w - 1:
        # fewer than w k-mers -> reference records nothing
        if (codes > 3).any() or n < k:
            return minimizer_scan_ref(codes, k, w, canonical)
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
    if (codes > 3).any():
        return minimizer_scan_ref(codes, k, w, canonical)
    kmers, _ = kmer_codes(codes, k)
    if canonical:
        kmers = np.minimum(kmers, revcomp_kmers(kmers, k))
    winv = np.lib.stride_tricks.sliding_window_view(kmers, w)
    arg = np.argmin(winv, axis=1)  # first occurrence of min = leftmost
    pos = arg + np.arange(len(arg))
    # dedup consecutive equal positions (positions are non-decreasing)
    keep = np.empty(len(pos), dtype=bool)
    keep[0] = True
    np.not_equal(pos[1:], pos[:-1], out=keep[1:])
    pos = pos[keep]
    vals = kmers[pos]
    return vals.astype(np.int64), pos.astype(np.int64)


# ---------------------------------------------------------------------------
# Rank/select over sorted position arrays (replaces sdsl bit_vector use)

def rank(positions: np.ndarray, p) -> int:
    """Number of marked positions < p  (sdsl rank semantics)."""
    return int(np.searchsorted(positions, p, side="left"))


def select(positions: np.ndarray, i: int) -> int:
    """Position of the i-th (1-based) marked position (sdsl select)."""
    return int(positions[i - 1])
