"""ctypes bindings for the native host runtime (host_native.cpp).

Built on demand with g++ (OpenMP).  Callers check ``available()`` and
fall back to the pure-NumPy implementations in hypo_tpu.segment.support
and hypo_tpu.kmers.counting when the toolchain is missing.

Copied from hypo_tpu/native/host_api.py; it builds its library with
g++ into hypo_tpu_torch/_build/ (_build.build_host), not beside its source.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from .. import _build as _port_build

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host_native.cpp")
_LIB = os.path.join(_port_build.BUILD_DIR, "libhypo_host.so")
_lock = threading.Lock()
_lib = None
_tried = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _build() -> bool:
    return _port_build.build_host(
        _SRC, "libhypo_host.so",
        ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", "-march=native"],
        ["-lz"]) is not None


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        need_build = (not os.path.exists(_LIB)
                      or os.path.getmtime(_LIB) < os.path.getmtime(_SRC))
        if need_build and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.hypo_count_kmers_dense.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int, _u32p, ctypes.c_int]
        lib.hypo_sparse_counter_new.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int64]
        lib.hypo_sparse_counter_new.restype = ctypes.c_void_p
        lib.hypo_sparse_counter_add.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_int64, ctypes.c_int]
        lib.hypo_sparse_counter_finalize.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.hypo_sparse_counter_finalize.restype = ctypes.c_int64
        lib.hypo_sparse_counter_items.argtypes = [
            ctypes.c_void_p, _i64p, _u32p]
        lib.hypo_sparse_counter_free.argtypes = [ctypes.c_void_p]
        lib.hypo_skmer_support.argtypes = [
            _i64p, _i64p, ctypes.c_int64, ctypes.c_int,
            _u8p, _i64p, _i64p, _i64p, ctypes.c_int64,
            _i64p, _i64p, ctypes.c_int]
        lib.hypo_minimizer_support.argtypes = [
            _i64p, ctypes.c_int64, ctypes.c_int,
            _i64p, ctypes.c_int64, _i64p, _i64p,
            _u8p, _i64p, _i64p, _i64p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, _i32p, _i32p, ctypes.c_int]
        lib.hypo_mw_minimizer_build.restype = ctypes.c_void_p
        lib.hypo_mw_minimizer_build.argtypes = [
            _u8p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, _i64p, ctypes.c_int,
            ctypes.c_int]
        lib.hypo_mw_min_total.restype = ctypes.c_int64
        lib.hypo_mw_min_total.argtypes = [ctypes.c_void_p]
        for nm in ("hypo_mw_min_off", "hypo_mw_min_vals",
                   "hypo_mw_min_pos"):
            getattr(lib, nm).restype = _i64p
            getattr(lib, nm).argtypes = [ctypes.c_void_p]
        lib.hypo_mw_min_free.argtypes = [ctypes.c_void_p]
        lib.hypo_sim_reads.restype = ctypes.c_void_p
        lib.hypo_sim_reads.argtypes = [
            _u8p, ctypes.c_int64, _u8p, _i64p, _i64p,
            _i64p, _u8p, _i64p, _i64p,
            _i64p, _u8p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
            _i64p, _i64p, _u8p, _u8p, ctypes.c_int]
        for nm in ("hypo_sim_bam_size", "hypo_sim_fastq_size",
                   "hypo_sim_nrec"):
            getattr(lib, nm).restype = ctypes.c_int64
            getattr(lib, nm).argtypes = [ctypes.c_void_p]
        lib.hypo_sim_bam.restype = _u8p
        lib.hypo_sim_bam.argtypes = [ctypes.c_void_p]
        lib.hypo_sim_fastq.restype = ctypes.POINTER(ctypes.c_char)
        lib.hypo_sim_fastq.argtypes = [ctypes.c_void_p]
        lib.hypo_sim_rec_pos.restype = _i64p
        lib.hypo_sim_rec_pos.argtypes = [ctypes.c_void_p]
        lib.hypo_sim_rec_off.restype = _i64p
        lib.hypo_sim_rec_off.argtypes = [ctypes.c_void_p]
        lib.hypo_sim_free.argtypes = [ctypes.c_void_p]
        _u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.hypo_find_solid_pos.restype = ctypes.c_void_p
        lib.hypo_find_solid_pos.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int, _u64p, ctypes.c_int]
        lib.hypo_solid_pos_count.restype = ctypes.c_int64
        lib.hypo_solid_pos_count.argtypes = [ctypes.c_void_p]
        lib.hypo_solid_pos_pos.restype = _i64p
        lib.hypo_solid_pos_pos.argtypes = [ctypes.c_void_p]
        lib.hypo_solid_pos_kid.restype = _i64p
        lib.hypo_solid_pos_kid.argtypes = [ctypes.c_void_p]
        lib.hypo_solid_pos_free.argtypes = [ctypes.c_void_p]
        lib.hypo_fastx_open.restype = ctypes.c_void_p
        lib.hypo_fastx_open.argtypes = [ctypes.c_char_p]
        lib.hypo_fastx_codes.restype = ctypes.c_int64
        lib.hypo_fastx_codes.argtypes = [ctypes.c_void_p, _u8p,
                                         ctypes.c_int64]
        lib.hypo_fastx_close.argtypes = [ctypes.c_void_p]
        lib.hypo_strong_regions.restype = ctypes.c_int64
        lib.hypo_strong_regions.argtypes = [
            _i64p, _i64p, _u8p, ctypes.c_int64, ctypes.c_int,
            _i64p, _i64p, _i64p]
        lib.hypo_divide_regions.restype = ctypes.c_void_p
        lib.hypo_divide_regions.argtypes = [
            _u8p, ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int,
            _i64p, _i64p, _i64p, _u8p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64]
        lib.hypo_regions_count.restype = ctypes.c_int64
        lib.hypo_regions_count.argtypes = [ctypes.c_void_p]
        for nm, restype in (("hypo_regions_starts", _i64p),
                            ("hypo_regions_types", _u8p),
                            ("hypo_regions_infos", _i64p)):
            getattr(lib, nm).restype = restype
            getattr(lib, nm).argtypes = [ctypes.c_void_p]
        lib.hypo_regions_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    if os.environ.get("HYPO_TPU_NO_NATIVE"):
        return False
    return _load() is not None


def _ptr(a: np.ndarray, ctp):
    return a.ctypes.data_as(ctp)


def count_kmers_dense(codes: np.ndarray, k: int, table: np.ndarray,
                      nthreads: int = 0) -> None:
    """Accumulate canonical k-mer counts of `codes` into `table`
    (uint32, length 4^k, modified in place)."""
    lib = _load()
    assert table.dtype == np.uint32 and table.flags.c_contiguous
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lib.hypo_count_kmers_dense(_ptr(codes, _u8p), len(codes), k,
                               _ptr(table, _u32p), nthreads)


class SparseCounterNative:
    """Stateful radix-partitioned canonical k-mer counter (the k >= 15
    KMC3-scale path; see host_native.cpp).  Same accumulate/items
    contract as the NumPy sparse backend in kmers.counting."""

    def __init__(self, k: int, pbits: int = 8,
                 pending_limit: int = 48 << 20):
        self._lib = _load()
        assert self._lib is not None
        self.k = k
        self._h = self._lib.hypo_sparse_counter_new(
            k, pbits, pending_limit)

    def add(self, codes: np.ndarray, nthreads: int = 0) -> None:
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        self._lib.hypo_sparse_counter_add(
            self._h, _ptr(codes, _u8p), len(codes), nthreads)

    def items(self, nthreads: int = 0):
        total = self._lib.hypo_sparse_counter_finalize(self._h, nthreads)
        codes = np.empty(total, np.int64)
        counts = np.empty(total, np.uint32)
        if total:
            self._lib.hypo_sparse_counter_items(
                self._h, _ptr(codes, _i64p), _ptr(counts, _u32p))
        return codes, counts

    def close(self) -> None:
        if self._h:
            self._lib.hypo_sparse_counter_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


_PACK_CACHE: dict = {}


def _pack_alignments(alignments: List):
    """Flatten (codes, offsets, rb, re) for the native calls.  The same
    alignment list flows through three stages (k-mer support, minimizer
    support, arm finding), so the flattened buffer is cached per list
    identity — one transient copy per contig batch instead of three."""
    key = id(alignments)
    hit = _PACK_CACHE.get(key)
    if hit is not None and hit[0] is alignments:
        return hit[1]
    lens = np.array([len(a.codes) for a in alignments], dtype=np.int64)
    off = np.zeros(len(alignments) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    buf = np.empty(int(off[-1]), dtype=np.uint8)
    for a, o0, o1 in zip(alignments, off[:-1], off[1:]):
        buf[o0:o1] = a.codes
    from ..dna import pack2
    buf = pack2(buf)     # 2-bit, matching the AlignmentView store
    rb = np.array([a.rb for a in alignments], dtype=np.int64)
    re = np.array([a.re for a in alignments], dtype=np.int64)
    packed = (buf, off, rb, re)
    _PACK_CACHE.clear()  # keep at most one contig's buffer alive
    _PACK_CACHE[key] = (alignments, packed)
    return packed


def clear_pack_cache() -> None:
    """Drop the cached flattened buffer (call once a contig's native
    stages are done, so the copy does not outlive the batch)."""
    _PACK_CACHE.clear()


def _flat(alignments):
    """(codes_buf, offsets, rb, re) for the native calls — zero-copy
    from an AlignmentView (the flat batch store), or packed+cached from
    a list of Alignment objects (legacy/python paths)."""
    from .bam_api import AlignmentView
    if isinstance(alignments, AlignmentView):
        return (alignments.seq, alignments.seq_off, alignments.rb,
                alignments.re)
    return _pack_alignments(alignments)


def _flat_cigars(alignments):
    from .bam_api import AlignmentView
    if isinstance(alignments, AlignmentView):
        return alignments.cig, alignments.cig_off
    return _pack_cigars(alignments)


def skmer_support(contig, alignments: List, k: int,
                  nthreads: int = 0) -> None:
    """Native twin of segment.support.update_solidkmers_support."""
    lib = _load()
    positions = np.ascontiguousarray(contig.solid_pos, dtype=np.int64)
    kids = np.ascontiguousarray(contig.kids, dtype=np.int64)
    npos = len(positions)
    cov_diff = np.zeros(npos + 1, dtype=np.int64)
    support = np.zeros(npos, dtype=np.int64)
    if len(alignments):
        buf, off, rb, re = _flat(alignments)
        lib.hypo_skmer_support(
            _ptr(positions, _i64p), _ptr(kids, _i64p), npos, k,
            _ptr(buf, _u8p), _ptr(off, _i64p), _ptr(rb, _i64p),
            _ptr(re, _i64p), len(alignments),
            _ptr(cov_diff, _i64p), _ptr(support, _i64p), nthreads)
    contig.kmer_coverage += np.cumsum(cov_diff[:-1])
    contig.kmer_support += support


def mw_minimizer_build(codes: np.ndarray, begs: np.ndarray,
                       ends: np.ndarray, mk: int, mw: int,
                       min_len: int, poly, nthreads: int = 0):
    """Flat per-MegaWindow minimizer tables (native twin of
    segment.minimizers.build_mw_minimizer_info over every MW at once).
    Returns (off [n_mw+1], vals, pos) with contig-absolute positions."""
    lib = _load()
    begs = np.ascontiguousarray(begs, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    polyarr = np.ascontiguousarray(poly, np.int64)
    h = lib.hypo_mw_minimizer_build(
        _ptr(codes, _u8p), _ptr(begs, _i64p), _ptr(ends, _i64p),
        len(begs), mk, mw, min_len, _ptr(polyarr, _i64p), len(polyarr),
        nthreads)
    try:
        total = int(lib.hypo_mw_min_total(h))
        off = np.ctypeslib.as_array(lib.hypo_mw_min_off(h),
                                    (len(begs) + 1,)).copy()
        vals = np.ctypeslib.as_array(lib.hypo_mw_min_vals(h),
                                     (total,)).copy() if total else \
            np.zeros(0, np.int64)
        pos = np.ctypeslib.as_array(lib.hypo_mw_min_pos(h),
                                    (total,)).copy() if total else \
            np.zeros(0, np.int64)
    finally:
        lib.hypo_mw_min_free(h)
    return off, vals, pos


def strong_regions(positions: np.ndarray, kids: np.ndarray,
                   tier: np.ndarray, k: int):
    """Native twin of segment.sr.scan_strong_regions: (sr_pos, sr_len,
    anchor_kmers), int64, from the solid positions, their k-mer ids and
    their tiers (segment.sr.sr_tiers)."""
    lib = _load()
    pos = np.ascontiguousarray(positions, np.int64)
    kid = np.ascontiguousarray(kids, np.int64)
    tier = np.ascontiguousarray(tier, np.uint8)
    n = len(pos)
    if len(kid) != n or len(tier) != n:
        raise ValueError(f"{n} solid positions, {len(kid)} k-mer ids and "
                         f"{len(tier)} tiers")
    sr_pos = np.empty(n, np.int64)
    sr_len = np.empty(n, np.int64)
    anchors = np.empty(2 * n + 1, np.int64)
    nsr = int(lib.hypo_strong_regions(
        _ptr(pos, _i64p), _ptr(kid, _i64p), _ptr(tier, _u8p), n, k,
        _ptr(sr_pos, _i64p), _ptr(sr_len, _i64p), _ptr(anchors, _i64p)))
    return (sr_pos[:nsr].copy(), sr_len[:nsr].copy(),
            anchors[:2 * nsr + 1].copy())


def divide_regions(codes: np.ndarray, stage1_starts: np.ndarray,
                   is_win_even: bool, mw_off: np.ndarray,
                   mw_vals: np.ndarray, mw_pos: np.ndarray,
                   mw_keep: np.ndarray, mk: int, ideal: int,
                   search_th: int):
    """Native twin of a contig's walk over its MegaWindows and SRs with
    segment.regions.divide / force_divide: (starts int64, types uint8,
    infos int64) of its regions in order, without the end dummy.
    ``mw_keep`` marks the minimizers whose coverage and support pass."""
    lib = _load()
    codes = np.ascontiguousarray(codes, np.uint8)
    s1 = np.ascontiguousarray(stage1_starts, np.int64)
    off = np.ascontiguousarray(mw_off, np.int64)
    vals = np.ascontiguousarray(mw_vals, np.int64)
    pos = np.ascontiguousarray(mw_pos, np.int64)
    keep = np.ascontiguousarray(mw_keep, np.uint8)
    n_mw = (len(s1) - 1 + int(bool(is_win_even))) // 2
    if (len(off) < n_mw + 1 or len(vals) != len(pos)
            or len(keep) != len(pos) or int(off[n_mw]) > len(pos)):
        raise ValueError("the MegaWindows' minimizer tables do not match "
                         "the stage-1 boundaries")
    h = lib.hypo_divide_regions(
        _ptr(codes, _u8p), len(codes), _ptr(s1, _i64p), len(s1),
        int(is_win_even), _ptr(off, _i64p), _ptr(vals, _i64p),
        _ptr(pos, _i64p), _ptr(keep, _u8p), mk, ideal, search_th)
    try:
        n = int(lib.hypo_regions_count(h))
        if n == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.uint8),
                    np.zeros(0, np.int64))
        as_arr = np.ctypeslib.as_array
        return (as_arr(lib.hypo_regions_starts(h), (n,)).copy(),
                as_arr(lib.hypo_regions_types(h), (n,)).copy(),
                as_arr(lib.hypo_regions_infos(h), (n,)).copy())
    finally:
        lib.hypo_regions_free(h)


def minimizer_support(contig, alignments: List, mk: int, mw: int,
                      nthreads: int = 0) -> None:
    """Native twin of segment.support.update_minimisers_support."""
    lib = _load()
    starts = np.ascontiguousarray(contig.stage1_starts, dtype=np.int64)
    mw_off = np.ascontiguousarray(contig.mw_off, dtype=np.int64)
    n_mw = len(mw_off) - 1
    m_vals = np.ascontiguousarray(contig.mw_vals, dtype=np.int64)
    m_abs = np.ascontiguousarray(contig.mw_pos, dtype=np.int64)
    total = len(m_vals)
    cov = np.zeros(total, dtype=np.int32)
    sup = np.zeros(total, dtype=np.int32)
    if len(alignments) and total:
        buf, off, rb, re = _flat(alignments)
        lib.hypo_minimizer_support(
            _ptr(starts, _i64p), len(starts), int(contig.is_win_even),
            _ptr(mw_off, _i64p), n_mw, _ptr(m_vals, _i64p),
            _ptr(m_abs, _i64p),
            _ptr(buf, _u8p), _ptr(off, _i64p), _ptr(rb, _i64p),
            _ptr(re, _i64p), len(alignments), mk, mw,
            _ptr(cov, _i32p), _ptr(sup, _i32p), nthreads)
    contig.mw_cov += cov
    contig.mw_sup += sup


def _register_arms(lib):
    if getattr(lib, "_arms_registered", False):
        return
    _u8pp = ctypes.POINTER(ctypes.c_uint8)
    lib.hypo_find_arms.restype = ctypes.c_void_p
    lib.hypo_find_arms.argtypes = [
        _i64p, _u8pp, _i64p, _i64p, _i64p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _u8pp, _i64p, _u32p, _i64p, _i64p, _i64p,
        ctypes.c_int64, ctypes.c_int]
    lib.hypo_arms_count.restype = ctypes.c_int64
    lib.hypo_arms_count.argtypes = [ctypes.c_void_p]
    for name, restype in [("hypo_arms_aln", _i32p),
                          ("hypo_arms_windex", _i32p),
                          ("hypo_arms_qb", _i32p),
                          ("hypo_arms_qe", _i32p),
                          ("hypo_arms_type", _u8pp)]:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p]
    lib.hypo_arms_free.argtypes = [ctypes.c_void_p]
    lib._arms_registered = True


def _pack_cigars(alignments: List):
    parts = []
    for a in alignments:
        raw = getattr(a, "cig_raw", None)
        if raw is None:
            raw = ((a.cigar_lens.astype(np.uint32) << 4)
                   | a.cigar_ops.astype(np.uint32))
        parts.append(raw)
    lens = np.array([len(p) for p in parts], dtype=np.int64)
    off = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    buf = (np.concatenate(parts).astype(np.uint32, copy=False)
           if parts else np.zeros(0, dtype=np.uint32))
    return np.ascontiguousarray(buf), off


def edit_distance_banded(a: bytes, b: bytes, band: int = 0):
    """Native twin of utils.alnutil.edit_distance (same band rule);
    returns None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_ed_registered", False):
        lib.hypo_edit_distance_banded.restype = ctypes.c_int64
        lib.hypo_edit_distance_banded.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64]
        lib._ed_registered = True
    if len(a) > len(b):
        a, b = b, a
    n, m = len(a), len(b)
    if band <= 0:
        band = 2 * (m - n) + 64
    band = min(band, m)
    return int(lib.hypo_edit_distance_banded(a, n, b, m, band))


def _register_tiles(lib):
    if getattr(lib, "_tiles_registered", False):
        return
    _i8p = ctypes.POINTER(ctypes.c_int8)
    lib.hypo_tile_jobs.restype = ctypes.c_void_p
    lib.hypo_tile_jobs.argtypes = [
        _u8p, _i64p, ctypes.c_int64, _u8p, _u8p,
        _i32p, _i32p, _i32p, _i32p, _u8p, ctypes.c_int64,
        _u8p, _i64p]
    for name, restype in [
            ("hypo_tile_njobs", ctypes.c_int64),
            ("hypo_tile_next", ctypes.c_int64),
            ("hypo_tile_cons_len", ctypes.c_int64),
            ("hypo_tile_flag", _u8p),
            ("hypo_tile_cons_off", _i64p),
            ("hypo_tile_cons_buf", _u8p),
            ("hypo_tile_job_windex", _i64p),
            ("hypo_tile_job_next", _i32p),
            ("hypo_tile_job_maxlen", _i32p),
            ("hypo_tile_job_ext_off", _i64p),
            ("hypo_tile_ext_len", _i32p),
            ("hypo_tile_ext_mode", _i8p),
            ("hypo_tile_ext_w", _i32p),
            ("hypo_tile_ext_off", _i64p),
            ("hypo_tile_ext_buf", _i8p)]:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p]
    lib.hypo_tile_jobs_free.argtypes = [ctypes.c_void_p]
    lib.hypo_tile_pack.restype = ctypes.c_int64
    lib.hypo_tile_pack.argtypes = [
        _i64p, ctypes.c_int64, ctypes.c_int64,
        _i32p, _i64p, _i32p, _i8p, _i32p, _i64p, _i8p, _i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int,
        _i8p, _i32p, _i32p, _i8p, _i32p, _i32p, _i32p, _i32p]
    lib.hypo_tile_finalize.argtypes = [
        _i8p, ctypes.c_int, ctypes.c_int, _i32p, ctypes.c_int64,
        ctypes.c_int, _u8p, ctypes.c_int64, _i32p]
    lib._tiles_registered = True


class TileJobs:
    """Result of the native phase-A job build for one contig (see
    host_native.cpp hypo_tile_jobs).  Arrays are COPIED out so the
    native handle can be freed eagerly."""

    def __init__(self, lib, h, n_reg: int):
        as_arr = np.ctypeslib.as_array
        self.n_jobs = int(lib.hypo_tile_njobs(h))
        n_ext = int(lib.hypo_tile_next(h))
        conslen = int(lib.hypo_tile_cons_len(h))
        self.flag = as_arr(lib.hypo_tile_flag(h), (n_reg,)).copy()
        self.cons_off = as_arr(lib.hypo_tile_cons_off(h),
                               (n_reg + 1,)).copy()
        self.cons_buf = (as_arr(lib.hypo_tile_cons_buf(h),
                                (conslen,)).copy()
                         if conslen else np.zeros(0, np.uint8))
        nj = self.n_jobs
        z64 = np.zeros(0, np.int64)
        z32 = np.zeros(0, np.int32)
        self.job_windex = (as_arr(lib.hypo_tile_job_windex(h),
                                  (nj,)).copy() if nj else z64)
        self.job_next = (as_arr(lib.hypo_tile_job_next(h),
                                (nj,)).copy() if nj else z32)
        self.job_maxlen = (as_arr(lib.hypo_tile_job_maxlen(h),
                                  (nj,)).copy() if nj else z32)
        self.job_ext_off = as_arr(lib.hypo_tile_job_ext_off(h),
                                  (nj + 1,)).copy()
        self.ext_len = (as_arr(lib.hypo_tile_ext_len(h),
                               (n_ext,)).copy() if n_ext else z32)
        self.ext_mode = (as_arr(lib.hypo_tile_ext_mode(h),
                                (n_ext,)).copy() if n_ext
                         else np.zeros(0, np.int8))
        self.ext_w = (as_arr(lib.hypo_tile_ext_w(h),
                             (n_ext,)).copy() if n_ext else z32)
        self.ext_off = as_arr(lib.hypo_tile_ext_off(h),
                              (n_ext + 1,)).copy()
        extlen = int(self.ext_off[-1])
        self.ext_buf = (as_arr(lib.hypo_tile_ext_buf(h),
                               (extlen,)).copy() if extlen
                        else np.zeros(0, np.int8))


def tile_jobs(contig_codes: np.ndarray, reg_starts: np.ndarray,
              wflag: np.ndarray, use_presuf: np.ndarray,
              table, abuf: np.ndarray, aoff: np.ndarray) -> TileJobs:
    """Native phase-A device job build for one contig."""
    lib = _load()
    _register_tiles(lib)
    aln_idx, windex, qb, qe, at = table
    n_reg = len(reg_starts) - 1
    codes = np.ascontiguousarray(contig_codes, dtype=np.uint8)
    rs = np.ascontiguousarray(reg_starts, dtype=np.int64)
    wi32 = np.ascontiguousarray(windex, dtype=np.int32)
    al32 = np.ascontiguousarray(aln_idx, dtype=np.int32)
    qb32 = np.ascontiguousarray(qb, dtype=np.int32)
    qe32 = np.ascontiguousarray(qe, dtype=np.int32)
    at8 = np.ascontiguousarray(at, dtype=np.uint8)
    h = lib.hypo_tile_jobs(
        _ptr(codes, _u8p), _ptr(rs, _i64p), n_reg,
        _ptr(np.ascontiguousarray(wflag, np.uint8), _u8p),
        _ptr(np.ascontiguousarray(use_presuf, np.uint8), _u8p),
        _ptr(wi32, _i32p), _ptr(al32, _i32p), _ptr(qb32, _i32p),
        _ptr(qe32, _i32p), _ptr(at8, _u8p), len(wi32),
        _ptr(np.ascontiguousarray(abuf, np.uint8), _u8p),
        _ptr(np.ascontiguousarray(aoff, np.int64), _i64p))
    res = TileJobs(lib, h, n_reg)
    lib.hypo_tile_jobs_free(h)
    return res


_i8p_t = ctypes.POINTER(ctypes.c_int8)


def tile_pack(order: np.ndarray, lo: int, jobs, job_th: np.ndarray,
              B: int, K: int, A: int, L: int, ndev: int):
    """Pack one tile from jobs order[lo:]; returns (hi, pool, plen,
    idxt, amode, aw, narms, th, row_of)."""
    lib = _load()
    _register_tiles(lib)
    pool = np.empty((A, L), np.int8)
    plen = np.empty(A, np.int32)
    idxt = np.empty((B, K), np.int32)
    amode = np.empty((B, K), np.int8)
    aw = np.empty((B, K), np.int32)
    narms = np.empty(B, np.int32)
    th = np.empty(B, np.int32)
    row_of = np.empty(B, np.int32)
    hi = lib.hypo_tile_pack(
        _ptr(order, _i64p), lo, len(order),
        _ptr(jobs.job_next, _i32p), _ptr(jobs.job_ext_off, _i64p),
        _ptr(jobs.ext_len, _i32p), _ptr(jobs.ext_mode, _i8p_t),
        _ptr(jobs.ext_w, _i32p), _ptr(jobs.ext_off, _i64p),
        _ptr(jobs.ext_buf, _i8p_t), _ptr(job_th, _i32p),
        B, K, A, L, ndev,
        _ptr(pool.reshape(-1), _i8p_t), _ptr(plen, _i32p),
        _ptr(idxt.reshape(-1), _i32p),
        _ptr(amode.reshape(-1), _i8p_t), _ptr(aw.reshape(-1), _i32p),
        _ptr(narms, _i32p), _ptr(th, _i32p), _ptr(row_of, _i32p))
    return int(hi), pool, plen, idxt, amode, aw, narms, th, row_of


def tile_finalize(packed: np.ndarray, row_of: np.ndarray, cnt: int,
                  kind: int, outcap: int):
    """Unpack device tile output rows into (out bytes [cnt, outcap],
    out_len [cnt]; -1 = overflow)."""
    lib = _load()
    _register_tiles(lib)
    packed = np.ascontiguousarray(packed, dtype=np.int8)
    B, rowlen = packed.shape
    out = np.empty((cnt, outcap), np.uint8)
    out_len = np.empty(cnt, np.int32)
    lib.hypo_tile_finalize(
        _ptr(packed.reshape(-1), _i8p_t), B, rowlen,
        _ptr(np.ascontiguousarray(row_of, np.int32), _i32p), cnt, kind,
        _ptr(out.reshape(-1), _u8p), outcap, _ptr(out_len, _i32p))
    return out, out_len


def find_arms(contig, alignments: List, k: int, mk: int, is_long: bool,
              short_arm_coef: int, nthreads: int = 0):
    """Native twin of Alignment.find_short_arms / find_long_arms over
    all alignments of one contig.  Returns (aln_idx, windex, qb, qe,
    armtype) int arrays in (alignment, emission) order."""
    lib = _load()
    _register_arms(lib)
    if is_long:
        starts = np.ascontiguousarray(contig.pseudo_starts,
                                      dtype=np.int64)
        rtype = np.ascontiguousarray(
            np.array(contig.pseudo_types, dtype=np.uint8))
        true_id = np.ascontiguousarray(
            np.array(contig.true_reg_id, dtype=np.int64))
        rinfo = np.zeros(len(starts) + 1, dtype=np.int64)
        anchors = np.zeros(2, dtype=np.int64)
    else:
        starts = np.ascontiguousarray(contig.reg_starts, dtype=np.int64)
        rtype = np.ascontiguousarray(contig.reg_type, dtype=np.uint8)
        rinfo = np.zeros(len(starts) + 1, dtype=np.int64)
        ri = np.asarray(contig.reg_info, dtype=np.int64)
        rinfo[:len(ri)] = ri
        anchors = np.ascontiguousarray(contig.anchor_kmers,
                                       dtype=np.int64)
        if len(anchors) == 0:
            anchors = np.zeros(2, dtype=np.int64)
        true_id = np.zeros(len(starts), dtype=np.int64)
    buf, off, rb, re = _flat(alignments)
    cig, cig_off = _flat_cigars(alignments)
    h = lib.hypo_find_arms(
        _ptr(starts, _i64p), _ptr(rtype, _u8p), _ptr(rinfo, _i64p),
        _ptr(anchors, _i64p), _ptr(true_id, _i64p), len(starts),
        k, mk, short_arm_coef, 1 if is_long else 0,
        _ptr(buf, _u8p), _ptr(off, _i64p), _ptr(cig, _u32p),
        _ptr(cig_off, _i64p), _ptr(rb, _i64p), _ptr(re, _i64p),
        len(alignments), nthreads)
    n = int(lib.hypo_arms_count(h))
    if n == 0:
        lib.hypo_arms_free(h)
        z = np.zeros(0, dtype=np.int32)
        return z, z, z, z, np.zeros(0, dtype=np.uint8)
    aln = np.ctypeslib.as_array(lib.hypo_arms_aln(h), (n,)).copy()
    windex = np.ctypeslib.as_array(lib.hypo_arms_windex(h), (n,)).copy()
    qb = np.ctypeslib.as_array(lib.hypo_arms_qb(h), (n,)).copy()
    qe = np.ctypeslib.as_array(lib.hypo_arms_qe(h), (n,)).copy()
    at = np.ctypeslib.as_array(lib.hypo_arms_type(h), (n,)).copy()
    lib.hypo_arms_free(h)
    return aln, windex, qb, qe, at


def sim_reads(g, dbase, t2d, ins_dpos, ev_t, ev_kind, d_lo, d_hi,
              starts, revs, rlen: int, tid: int, prefix: str,
              name0: int, qoff, q_t, q_kind, q_base,
              nthreads: int = 0):
    """Native simulator read composer (twin of sim._compose_read + BAM/
    FASTQ serialization).  Returns (bam_blob bytes, fastq bytes,
    rec_pos int64[n_rec], rec_off int64[n_rec+1])."""
    lib = _load()
    a64 = lambda a: np.ascontiguousarray(a, np.int64)
    a8 = lambda a: np.ascontiguousarray(a, np.uint8)
    g = a8(g); dbase = a8(dbase)
    t2d = a64(t2d); ins_dpos = a64(ins_dpos)
    ev_t = a64(ev_t); ev_kind = a8(ev_kind)
    d_lo = a64(d_lo); d_hi = a64(d_hi)
    starts = a64(starts); revs = a8(revs)
    qoff = a64(qoff); q_t = a64(q_t)
    q_kind = a8(q_kind); q_base = a8(q_base)
    h = lib.hypo_sim_reads(
        _ptr(g, _u8p), len(g), _ptr(dbase, _u8p), _ptr(t2d, _i64p),
        _ptr(ins_dpos, _i64p), _ptr(ev_t, _i64p), _ptr(ev_kind, _u8p),
        _ptr(d_lo, _i64p), _ptr(d_hi, _i64p), _ptr(starts, _i64p),
        _ptr(revs, _u8p), len(starts), rlen, tid, prefix.encode(),
        name0, _ptr(qoff, _i64p), _ptr(q_t, _i64p), _ptr(q_kind, _u8p),
        _ptr(q_base, _u8p), nthreads)
    try:
        # NOT ctypes.string_at: its size argument truncates to a
        # SIGNED 32-bit int (silently for >4 GB, SystemError for
        # 2-4 GB) — a 2M-read chunk's record blob exceeds both
        nb = int(lib.hypo_sim_bam_size(h))
        bam = np.ctypeslib.as_array(lib.hypo_sim_bam(h),
                                    (nb,)).tobytes() if nb else b""
        nf = int(lib.hypo_sim_fastq_size(h))
        fq = np.ctypeslib.as_array(
            ctypes.cast(lib.hypo_sim_fastq(h), _u8p),
            (nf,)).tobytes() if nf else b""
        nrec = int(lib.hypo_sim_nrec(h))
        pos = np.ctypeslib.as_array(lib.hypo_sim_rec_pos(h),
                                    (nrec,)).copy() if nrec else \
            np.zeros(0, np.int64)
        off = np.ctypeslib.as_array(lib.hypo_sim_rec_off(h),
                                    (nrec + 1,)).copy()
    finally:
        lib.hypo_sim_free(h)
    return bam, fq, pos, off


def find_solid_pos_native(codes: np.ndarray, k: int,
                          words: np.ndarray, nthreads: int = 0):
    """Native solid-position scan (twin of segment.solid_pos
    .find_solid_pos).  words = the solid-kmer Bitset's uint64 words."""
    lib = _load()
    codes = np.ascontiguousarray(codes, np.uint8)
    words = np.ascontiguousarray(words, np.uint64)
    h = lib.hypo_find_solid_pos(
        _ptr(codes, _u8p), len(codes), k,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), nthreads)
    try:
        n = int(lib.hypo_solid_pos_count(h))
        if n:
            pos = np.ctypeslib.as_array(lib.hypo_solid_pos_pos(h),
                                        (n,)).copy()
            kid = np.ctypeslib.as_array(lib.hypo_solid_pos_kid(h),
                                        (n,)).copy()
        else:
            pos = np.zeros(0, np.int64)
            kid = np.zeros(0, np.int64)
    finally:
        lib.hypo_solid_pos_free(h)
    return pos, kid


class FastxCodeStream:
    """Streamed read codes from a FASTA/FASTQ(.gz): uint8 0..3 with a
    `4` separator after each read (the kseq role, reference
    include/kseq.h)."""

    def __init__(self, path: str, chunk: int = 64 << 20):
        self._lib = _load()
        self._h = self._lib.hypo_fastx_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path}")
        self._chunk = chunk

    def read(self, buf: np.ndarray) -> int:
        """Decode the next codes into ``buf`` (uint8, C-contiguous, at
        most its length); returns how many, 0 at the end.  Any buffer
        will do, so a caller can keep several in flight."""
        if not self._h:
            return 0
        return max(0, int(self._lib.hypo_fastx_codes(
            self._h, _ptr(buf, _u8p), len(buf))))

    def __iter__(self):
        """Chunks as views of one buffer, which the next chunk
        overwrites."""
        buf = np.empty(self._chunk, np.uint8)
        while True:
            n = self.read(buf)
            if n == 0:
                break
            yield buf[:n]
        self.close()

    def close(self) -> None:
        if self._h:
            self._lib.hypo_fastx_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
