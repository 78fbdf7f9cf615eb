"""ctypes bindings for the native POA engine (poa_native.cpp).

The shared library is built on demand with g++ into this directory;
callers check ``available()`` and fall back to the pure-Python oracle
when the toolchain is missing.

Copied from hypo_tpu/native/api.py; it builds its library with
g++ into hypo_tpu_torch/_build/ (_build.build_host), not beside its source.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from .. import _build as _port_build

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "poa_native.cpp")
_LIB = os.path.join(_port_build.BUILD_DIR, "libhypo_poa.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    return _port_build.build_host(
        _SRC, "libhypo_poa.so",
        ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", "-march=native"],
        []) is not None


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
        c = ctypes.c_void_p
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.hypo_graph_new.restype = c
        lib.hypo_graph_free.argtypes = [c]
        lib.hypo_graph_add_alignment.argtypes = [
            c, i32p, i32p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.hypo_graph_align.restype = ctypes.c_int
        lib.hypo_graph_align.argtypes = [
            c, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, i32p, i32p, ctypes.c_int]
        lib.hypo_graph_num_nodes.restype = ctypes.c_int
        lib.hypo_graph_num_nodes.argtypes = [c]
        lib.hypo_graph_consensus.restype = ctypes.c_int
        lib.hypo_graph_consensus.argtypes = [c, ctypes.c_char_p,
                                             ctypes.c_int]
        lib.hypo_graph_consensus_custom.restype = ctypes.c_int
        lib.hypo_graph_consensus_custom.argtypes = [
            c, ctypes.c_char_p, i32p, ctypes.c_int]
        lib.hypo_graph_extract.restype = ctypes.c_int
        lib.hypo_graph_extract.argtypes = [
            c, ctypes.c_int, ctypes.c_int, i32p, i32p, i32p,
            ctypes.POINTER(ctypes.c_uint8), i32p]
        lib.hypo_window_consensus.restype = ctypes.c_int
        lib.hypo_window_consensus.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            i32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        i64p = ctypes.POINTER(ctypes.c_int64)
        ci = ctypes.c_int
        lib.hypo_window_consensus_batch.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_char_p, i64p, i32p, i32p,
            i64p, i32p, i32p, i32p, ctypes.c_int64,
            ci, ci, ci, ci, ci, ci, ci,
            ctypes.c_char_p, i64p, i64p, i64p, ci]
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.hypo_jobs_consensus.restype = c
        lib.hypo_jobs_consensus.argtypes = [
            ctypes.c_int64, i64p, i32p, i8p, i32p, i64p, i8p,
            ci, ci, ci, ci]
        lib.hypo_jobs_cons_size.restype = ctypes.c_int64
        lib.hypo_jobs_cons_size.argtypes = [c]
        lib.hypo_jobs_cons_off.restype = i64p
        lib.hypo_jobs_cons_off.argtypes = [c]
        lib.hypo_jobs_cons_buf.restype = ctypes.POINTER(ctypes.c_char)
        lib.hypo_jobs_cons_buf.argtypes = [c]
        lib.hypo_jobs_cons_free.argtypes = [c]
        _lib = lib
        return _lib


def available() -> bool:
    if os.environ.get("HYPO_TPU_NO_NATIVE"):
        return False
    return _load() is not None


def _i32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeGraph:
    """Host-side graph with native merge/align/consensus — the
    per-window state holder for the device POA runner."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.hypo_graph_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hypo_graph_free(self._h)
            self._h = None

    def num_nodes(self) -> int:
        return self._lib.hypo_graph_num_nodes(self._h)

    def add_alignment(self, alignment: List[Tuple[int, int]],
                      seq: str) -> None:
        n = len(alignment)
        if n:
            anode = np.fromiter((a for a, _ in alignment), np.int32, n)
            aseq = np.fromiter((b for _, b in alignment), np.int32, n)
        else:
            anode = np.zeros(0, np.int32)
            aseq = np.zeros(0, np.int32)
        self._lib.hypo_graph_add_alignment(
            self._h, _i32(anode), _i32(aseq), n, seq.encode("latin1"),
            len(seq))

    def align(self, seq: str, mode: int, m: int, n: int, g: int
              ) -> List[Tuple[int, int]]:
        cap = self.num_nodes() + len(seq) + 8
        out_n = np.zeros(cap, np.int32)
        out_s = np.zeros(cap, np.int32)
        ln = self._lib.hypo_graph_align(
            self._h, seq.encode("latin1"), len(seq), mode, m, n, g,
            _i32(out_n), _i32(out_s), cap)
        assert ln >= 0
        return list(zip(out_n[:ln].tolist(), out_s[:ln].tolist()))

    def consensus(self) -> str:
        cap = self.num_nodes() + 8
        buf = ctypes.create_string_buffer(cap)
        ln = self._lib.hypo_graph_consensus(self._h, buf, cap)
        assert ln >= 0
        return buf.raw[:ln].decode("latin1")

    # python-Graph-compatible aliases (used by the device runner)
    generate_consensus = consensus

    def consensus_custom(self) -> Tuple[str, List[int]]:
        cap = self.num_nodes() + 8
        buf = ctypes.create_string_buffer(cap)
        dst = np.zeros(cap, np.int32)
        ln = self._lib.hypo_graph_consensus_custom(self._h, buf,
                                                   _i32(dst), cap)
        assert ln >= 0
        return buf.raw[:ln].decode("latin1"), dst[:ln].tolist()

    generate_consensus_custom = consensus_custom

    def extract(self, N: int, P: int):
        """-> (node_code, pred_rows, pred_cnt, is_end, n_nodes, rank_ids)
        or None on capacity overflow."""
        node_code = np.zeros(N, np.int32)
        pred_rows = np.zeros((N, P), np.int32)
        pred_cnt = np.ones(N, np.int32)
        is_end = np.zeros(N, np.uint8)
        rank_ids = np.zeros(N, np.int32)
        nn = self._lib.hypo_graph_extract(
            self._h, N, P, _i32(node_code), _i32(pred_rows),
            _i32(pred_cnt),
            is_end.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _i32(rank_ids))
        if nn < 0:
            return None
        return (node_code, pred_rows, pred_cnt, is_end.astype(bool), nn,
                rank_ids)


INTERNAL_KIND, PREFIX_KIND, SUFFIX_KIND = 0, 1, 2


def native_window_consensus(wtype: int, draft_codes: np.ndarray,
                            arms: List[Tuple[np.ndarray, int]],
                            num_internal: int, num_empty: int,
                            scores: Tuple[int, int, int],
                            fix_modes: bool = False) -> Optional[str]:
    """Full window consensus in native code.  arms = [(codes, kind)] in
    window order (internal, then prefix in ORIGINAL order, then suffix;
    the native side applies the prefix reversal)."""
    lib = _load()
    if lib is None:
        return None
    from ..dna import decode
    draft = decode(draft_codes).encode("latin1")
    blobs = []
    lens = np.zeros(len(arms), np.int32)
    kinds = np.zeros(len(arms), np.int32)
    for i, (codes, kind) in enumerate(arms):
        s = decode(codes).encode("latin1")
        blobs.append(s)
        lens[i] = len(s)
        kinds[i] = kind
    cat = b"".join(blobs)
    m, n, g = scores
    total_arm = int(lens.sum())
    cap = 2 * (len(draft) + total_arm) + 64
    buf = ctypes.create_string_buffer(cap)
    ln = lib.hypo_window_consensus(
        wtype, draft, len(draft), cat, _i32(lens), _i32(kinds),
        len(arms), num_internal, num_empty, m, n, g,
        1 if fix_modes else 0, buf, cap)
    if ln < 0:
        return None
    return buf.raw[:ln].decode("latin1")


def native_window_consensus_batch(jobs, sr_scores, lr_scores,
                                  fix_modes: bool = False,
                                  nthreads: int = 0):
    """Batched window consensus, OpenMP over windows.

    jobs: list of (wtype, draft_bytes, [(arm_bytes, kind)], num_internal,
    num_empty).  Returns list of consensus strings (None per overflow).
    """
    lib = _load()
    if lib is None:
        return None
    nw = len(jobs)
    d_off = np.zeros(nw + 1, dtype=np.int64)
    win_arm_off = np.zeros(nw + 1, dtype=np.int64)
    for i, (wt, draft, arms, ni, ne) in enumerate(jobs):
        d_off[i + 1] = d_off[i] + len(draft)
        win_arm_off[i + 1] = win_arm_off[i] + len(arms)
    n_arms = int(win_arm_off[-1])
    arm_lens = np.zeros(max(n_arms, 1), dtype=np.int32)
    arm_kinds = np.zeros(max(n_arms, 1), dtype=np.int32)
    a_off = np.zeros(n_arms + 1, dtype=np.int64)
    drafts = bytearray()
    armbuf = bytearray()
    wtypes = np.zeros(nw, dtype=np.int32)
    num_internal = np.zeros(nw, dtype=np.int32)
    num_empty = np.zeros(nw, dtype=np.int32)
    out_off = np.zeros(nw, dtype=np.int64)
    out_cap = np.zeros(nw, dtype=np.int64)
    ai = 0
    total_out = 0
    for i, (wt, draft, arms, ni, ne) in enumerate(jobs):
        drafts += draft
        wtypes[i] = wt
        num_internal[i] = ni
        num_empty[i] = ne
        tot_arm = 0
        for ab, kind in arms:
            armbuf += ab
            arm_lens[ai] = len(ab)
            arm_kinds[ai] = kind
            a_off[ai + 1] = a_off[ai] + len(ab)
            tot_arm += len(ab)
            ai += 1
        out_off[i] = total_out
        out_cap[i] = 2 * (len(draft) + tot_arm) + 64
        total_out += int(out_cap[i])
    out = ctypes.create_string_buffer(max(total_out, 1))
    out_len = np.zeros(nw, dtype=np.int64)
    i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    ms, ns, gs = sr_scores
    ml, nl, gl = lr_scores
    lib.hypo_window_consensus_batch(
        bytes(drafts), i64(d_off), bytes(armbuf), i64(a_off),
        _i32(arm_lens), _i32(arm_kinds), i64(win_arm_off),
        _i32(wtypes), _i32(num_internal), _i32(num_empty), nw,
        ms, ns, gs, ml, nl, gl, 1 if fix_modes else 0,
        out, i64(out_off), i64(out_cap), i64(out_len), nthreads)
    res = []
    raw = out.raw
    for i in range(nw):
        ln = int(out_len[i])
        if ln < 0:
            res.append(None)
        else:
            o = int(out_off[i])
            res.append(raw[o:o + ln].decode("latin1"))
    return res


def native_jobs_consensus(jobs, scores, nthreads: int = 0):
    """Consensus for a flat TileJobs stream (hypo_tpu.native.host_api
    .TileJobs — the same job/ext arrays the device tile path consumes)
    entirely in C with OpenMP.  Returns (cons_bytes, off) where job j's
    consensus is cons_bytes[off[j]:off[j+1]] (ASCII, markers stripped).
    The host-engine twin of the device tile dispatch; reference analog
    src/Hypo.cpp:237-247."""
    lib = _load()
    m, n, g = scores
    i64 = lambda a: np.ascontiguousarray(a, np.int64).ctypes.data_as(
        ctypes.POINTER(ctypes.c_int64))
    i8 = lambda a: np.ascontiguousarray(a, np.int8).ctypes.data_as(
        ctypes.POINTER(ctypes.c_int8))
    jeo = np.ascontiguousarray(jobs.job_ext_off, np.int64)
    elen = np.ascontiguousarray(jobs.ext_len, np.int32)
    emode = np.ascontiguousarray(jobs.ext_mode, np.int8)
    ew = np.ascontiguousarray(jobs.ext_w, np.int32)
    eoff = np.ascontiguousarray(jobs.ext_off, np.int64)
    ebuf = np.ascontiguousarray(jobs.ext_buf, np.int8)
    h = lib.hypo_jobs_consensus(
        int(jobs.n_jobs),
        jeo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _i32(elen), i8(emode), _i32(ew),
        eoff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        i8(ebuf), m, n, g, nthreads)
    try:
        total = lib.hypo_jobs_cons_size(h)
        off = np.ctypeslib.as_array(
            lib.hypo_jobs_cons_off(h), shape=(int(jobs.n_jobs) + 1,)
        ).copy()
        # ctypes.string_at truncates its size to int32; the 1 Gbp-scale
        # consensus buffer exceeds it
        buf = np.ctypeslib.as_array(
            ctypes.cast(lib.hypo_jobs_cons_buf(h),
                        ctypes.POINTER(ctypes.c_uint8)),
            (int(total),)).tobytes() if total else b""
    finally:
        lib.hypo_jobs_cons_free(h)
    return buf, off
