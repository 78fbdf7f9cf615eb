"""Small alignment utilities used by the simulator and QV evaluation.

These are support tools (test-data generation and accuracy metrics), not
part of the polishing path.

Copied from hypo_tpu/utils/alnutil.py.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..io.bam import OP_D, OP_I, OP_M


def semiglobal_align(query: np.ndarray, ref: np.ndarray, match: int = 2,
                     mismatch: int = -4, gap: int = -3
                     ) -> Tuple[int, np.ndarray, np.ndarray, int, int]:
    """Align full query against a ref window with free ref start/end.

    Returns (score, cigar_ops, cigar_lens, ref_start, nm).  Linear gap;
    rows vectorized with the cummax trick; traceback prefers diag, then
    up (query gap / deletion-from-ref... ref-consuming), then left.
    """
    q = query.astype(np.int64)
    r = ref.astype(np.int64)
    nq, nr = len(q), len(r)
    H = np.zeros((nq + 1, nr + 1), dtype=np.int64)
    H[0, :] = 0                      # free ref start
    H[1:, 0] = np.arange(1, nq + 1) * gap
    jj = np.arange(nr + 1, dtype=np.int64)
    for i in range(1, nq + 1):
        sub = np.where(r == q[i - 1], match, mismatch)
        tmp = np.maximum(H[i - 1, :-1] + sub, H[i - 1, 1:] + gap)
        val = np.empty(nr + 1, dtype=np.int64)
        val[0] = H[i, 0]
        val[1:] = tmp
        run = np.maximum.accumulate(val - jj * gap)
        H[i, 1:] = run[1:] + jj[1:] * gap
    j = int(np.argmax(H[nq]))
    score = int(H[nq, j])
    i = nq
    ops = []
    nm = 0
    while i > 0:
        sub = match if (j > 0 and q[i - 1] == r[j - 1]) else mismatch
        if j > 0 and H[i, j] == H[i - 1, j - 1] + sub:
            ops.append(OP_M)
            if sub == mismatch:
                nm += 1
            i -= 1
            j -= 1
        elif H[i, j] == H[i - 1, j] + gap:
            ops.append(OP_I)  # query base not in ref
            nm += 1
            i -= 1
        else:
            ops.append(OP_D)  # ref base skipped
            nm += 1
            j -= 1
    ref_start = j
    ops.reverse()
    # run-length encode
    rl_ops = []
    rl_lens = []
    for op in ops:
        if rl_ops and rl_ops[-1] == op:
            rl_lens[-1] += 1
        else:
            rl_ops.append(op)
            rl_lens.append(1)
    return (score, np.array(rl_ops, dtype=np.uint8),
            np.array(rl_lens, dtype=np.uint32), ref_start, nm)


def edit_distance(a: str, b: str, band: int = 0) -> int:
    """Banded Levenshtein distance (for QV evaluation).  band=0 picks
    2*|len difference|+64 automatically.  Uses the native twin when
    available (the Python row loop takes tens of minutes at chromosome
    scale); both implement the identical DP (parity-tested)."""
    if a == b:
        return 0
    try:
        from ..native.host_api import edit_distance_banded
        r = edit_distance_banded(a.encode("latin1"), b.encode("latin1"),
                                 band)
        if r is not None:
            return r
    except Exception:
        pass
    x = np.frombuffer(a.encode(), dtype=np.uint8).astype(np.int64)
    y = np.frombuffer(b.encode(), dtype=np.uint8).astype(np.int64)
    if len(x) > len(y):
        x, y = y, x
    n, m = len(x), len(y)
    if band <= 0:
        band = 2 * (m - n) + 64
    band = min(band, m)
    INF = 1 << 40
    prev = np.full(2 * band + 1, INF, dtype=np.int64)
    # dp over offset d = j - i in [-band, band]
    prev[band:] = np.arange(band + 1)  # row 0: cost = j
    for i in range(1, n + 1):
        cur = np.full(2 * band + 1, INF, dtype=np.int64)
        lo = max(0, i - band)
        hi = min(m, i + band)
        js = np.arange(lo, hi + 1)
        ks = js - i + band
        sub = np.full(len(js), 1, dtype=np.int64)
        valid = js >= 1
        sub[valid] = (y[js[valid] - 1] != x[i - 1]).astype(np.int64)
        diag = prev[ks]  # prev row, j-1 => offset (j-1)-(i-1) = k
        up = np.full(len(js), INF, dtype=np.int64)
        up_ok = ks + 1 <= 2 * band
        up[up_ok] = prev[ks[up_ok] + 1]  # prev row, same j
        cand = np.minimum(diag + sub, up + 1)
        if js[0] == 0:
            cand[0] = i  # column 0: cost = i
        cur[ks] = cand
        # left moves within the row (j-1, same i): prefix scan
        # min over t'<=t of cur[t'] + (t - t'); the t'==t term is a no-op
        tt = np.arange(len(ks))
        left = np.minimum.accumulate(cur[ks] - tt)
        cur[ks] = np.minimum(cur[ks], left + tt)
        prev = cur
    k_final = m - n + band
    return int(prev[k_final])
