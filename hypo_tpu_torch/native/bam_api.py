"""ctypes bindings for the native BAM reader (bam_native.cpp).

``NativeBamStream`` mirrors pipeline.polish._BamStream.records_until()
but parses blocks, records and alignment positions in C++, returning
ready Alignment objects.  Falls back transparently (callers check
``available()``) to the pure-Python reader.

Copied from hypo_tpu/native/bam_api.py; it builds its library with
g++ into hypo_tpu_torch/_build/ (_build.build_host), not beside its source.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import _build as _port_build

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bam_native.cpp")
_LIB = os.path.join(_port_build.BUILD_DIR, "libhypo_bam.so")
_lock = threading.Lock()
_lib = None
_tried = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _build() -> bool:
    return _port_build.build_host(
        _SRC, "libhypo_bam.so",
        ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native", "-fopenmp"],
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
        lib.hypo_bam_open.restype = ctypes.c_void_p
        lib.hypo_bam_open.argtypes = [ctypes.c_char_p]
        lib.hypo_bam_close.argtypes = [ctypes.c_void_p]
        lib.hypo_bam_nrefs.argtypes = [ctypes.c_void_p]
        lib.hypo_bam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_char_p, ctypes.c_int]
        lib.hypo_bam_ref_len.restype = ctypes.c_int64
        lib.hypo_bam_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.hypo_bam_read_until.restype = ctypes.c_int64
        lib.hypo_bam_read_until.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        for name, restype in [
                ("hypo_bam_n_invalid", ctypes.c_int64),
                ("hypo_bam_n_filtered", ctypes.c_int64),
                ("hypo_bam_get_tid", _i32p), ("hypo_bam_get_flag", _i32p),
                ("hypo_bam_get_mapq", _i32p), ("hypo_bam_get_nm", _i32p),
                ("hypo_bam_get_rb", _i64p), ("hypo_bam_get_re", _i64p),
                ("hypo_bam_get_cig_off", _i64p),
                ("hypo_bam_get_cig", _u32p),
                ("hypo_bam_get_seq_off", _i64p),
                ("hypo_bam_get_seq", _u8p)]:
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    if os.environ.get("HYPO_TPU_NO_NATIVE"):
        return False
    return _load() is not None


FUNMAP, FSECONDARY, FQCFAIL, FDUP = 0x4, 0x100, 0x200, 0x400
DEFAULT_EXCLUDE = FUNMAP | FSECONDARY | FQCFAIL | FDUP


class AlignmentView:
    """Flat per-contig slice of one batch's alignments — the zero-object
    representation the native pipeline stages consume directly.  At
    human scale the per-record Python object model costs ~1 KB and ~10us
    per alignment (20M alignments -> ~20 GB RSS and minutes of loop
    time); this view is six numpy arrays regardless of record count.

    ``seq``/``cig`` are the WHOLE batch buffers; ``seq_off``/``cig_off``
    hold ABSOLUTE offsets into them ([n+1] each), so slicing a contig's
    view is O(1) and copy-free.  ``seq`` is 2-BIT PACKED (4 bases/byte,
    the PackedSeq<2> role, reference include/PackedSeq.hpp:80-160);
    ``seq_off`` is in BASES."""

    __slots__ = ("seq", "seq_off", "cig", "cig_off", "rb", "re")

    def __init__(self, seq, seq_off, cig, cig_off, rb, re):
        self.seq = seq
        self.seq_off = seq_off
        self.cig = cig
        self.cig_off = cig_off
        self.rb = rb
        self.re = re

    def __len__(self) -> int:
        return len(self.rb)

    def codes(self, a: int, qb: int, qe: int) -> np.ndarray:
        """The aligned-query code slice [qb, qe) of alignment a.
        qb/qe may be numpy int32 scalars (the arm table is int32);
        offsets into the batch buffer need python ints (> 2^31 bases
        per long-read batch)."""
        from ..dna import unpack2
        qb = int(qb)
        return unpack2(self.seq, int(self.seq_off[a]) + qb,
                       int(qe) - qb)

    @staticmethod
    def empty() -> "AlignmentView":
        z8 = np.zeros(0, np.uint8)
        z64 = np.zeros(1, np.int64)
        return AlignmentView(z8, z64, np.zeros(0, np.uint32), z64,
                             np.zeros(0, np.int64), np.zeros(0, np.int64))


class NativeBamStream:
    """Streaming contig-batched alignment loader (native twin of
    pipeline.polish._BamStream + Alignment.from_record)."""

    def __init__(self, path: str, cname_to_id: Dict[str, int]):
        lib = _load()
        self.lib = lib
        self.h = lib.hypo_bam_open(path.encode())
        if not self.h:
            raise IOError(f"cannot open BAM {path}")
        nrefs = lib.hypo_bam_nrefs(self.h)
        buf = ctypes.create_string_buffer(4096)
        self.tid_to_cid = np.full(nrefs, -1, dtype=np.int64)
        monotone = True
        prev = -1
        for t in range(nrefs):
            lib.hypo_bam_ref_name(self.h, t, buf, 4096)
            name = buf.value.decode()
            cid = cname_to_id.get(name, -1)
            self.tid_to_cid[t] = cid
            if cid != -1:
                if cid < prev:
                    monotone = False
                prev = cid
        # the tid<final_tid boundary rule requires BAM refs in draft
        # contig order (the reference requires this too, Hypo.cpp:320)
        if not monotone:
            raise ValueError("BAM reference order does not match draft")

    def _final_tid(self, final_cid: int) -> int:
        hits = np.nonzero(self.tid_to_cid >= final_cid)[0]
        return int(hits[0]) if len(hits) else len(self.tid_to_cid)

    def load_until(self, final_cid: int, min_mapq: int,
                   norm_edit_th: Optional[int] = None
                   ) -> Tuple[List[tuple], int, int]:
        """Returns (records, n_valid, n_invalid) where records is a list
        of (cid, rb, re, codes_view, cigar_view) tuples in stream order.
        """
        lib, h = self.lib, self.h
        n = lib.hypo_bam_read_until(
            h, self._final_tid(final_cid), DEFAULT_EXCLUDE, min_mapq,
            -1 if norm_edit_th is None else int(norm_edit_th))
        if n < 0:
            raise IOError("BAM stream error")
        n = int(n)
        n_invalid = int(lib.hypo_bam_n_invalid(h))
        if n == 0:
            return [], 0, n_invalid
        tid = np.ctypeslib.as_array(lib.hypo_bam_get_tid(h), (n,)).copy()
        rb = np.ctypeslib.as_array(lib.hypo_bam_get_rb(h), (n,)).copy()
        re = np.ctypeslib.as_array(lib.hypo_bam_get_re(h), (n,)).copy()
        cig_off = np.ctypeslib.as_array(
            lib.hypo_bam_get_cig_off(h), (n + 1,)).copy()
        cig = np.ctypeslib.as_array(
            lib.hypo_bam_get_cig(h), (int(cig_off[-1]),)).copy()
        seq_off = np.ctypeslib.as_array(
            lib.hypo_bam_get_seq_off(h), (n + 1,)).copy()
        seq = np.ctypeslib.as_array(
            lib.hypo_bam_get_seq(h),
            ((int(seq_off[-1]) + 3) // 4,)).copy()
        cids = self.tid_to_cid[tid]
        if (cids < 0).any():
            bad = int(tid[cids < 0][0])
            raise ValueError(
                f"contig id {bad} in BAM not present in draft")
        from ..dna import unpack2
        ops = (cig & 0xF).astype(np.uint8)
        lens = (cig >> 4).astype(np.uint32)
        recs = []
        for i in range(n):
            o0, o1 = int(seq_off[i]), int(seq_off[i + 1])
            c0, c1 = cig_off[i], cig_off[i + 1]
            recs.append((int(cids[i]), int(rb[i]), int(re[i]),
                         unpack2(seq, o0, o1 - o0), ops[c0:c1],
                         lens[c0:c1], cig[c0:c1]))
        return recs, n, n_invalid

    def load_store(self, final_cid: int, min_mapq: int,
                   norm_edit_th: Optional[int] = None
                   ) -> Tuple[Dict[int, AlignmentView], int, int]:
        """Flat-array twin of load_until: returns ({cid: AlignmentView},
        n_valid, n_invalid) with NO per-record Python objects.  Relies
        on the BAM being draft-contig-ordered (checked in __init__), so
        each contig's records are one contiguous range."""
        lib, h = self.lib, self.h
        n = lib.hypo_bam_read_until(
            h, self._final_tid(final_cid), DEFAULT_EXCLUDE, min_mapq,
            -1 if norm_edit_th is None else int(norm_edit_th))
        if n < 0:
            raise IOError("BAM stream error")
        n = int(n)
        n_invalid = int(lib.hypo_bam_n_invalid(h))
        if n == 0:
            return {}, 0, n_invalid
        tid = np.ctypeslib.as_array(lib.hypo_bam_get_tid(h), (n,)).copy()
        rb = np.ctypeslib.as_array(lib.hypo_bam_get_rb(h), (n,)).copy()
        re = np.ctypeslib.as_array(lib.hypo_bam_get_re(h), (n,)).copy()
        cig_off = np.ctypeslib.as_array(
            lib.hypo_bam_get_cig_off(h), (n + 1,)).copy()
        cig = np.ctypeslib.as_array(
            lib.hypo_bam_get_cig(h), (int(cig_off[-1]),)).copy()
        seq_off = np.ctypeslib.as_array(
            lib.hypo_bam_get_seq_off(h), (n + 1,)).copy()
        seq = np.ctypeslib.as_array(
            lib.hypo_bam_get_seq(h),
            ((int(seq_off[-1]) + 3) // 4,)).copy()
        cids = self.tid_to_cid[tid]
        if (cids < 0).any():
            bad = int(tid[cids < 0][0])
            raise ValueError(
                f"contig id {bad} in BAM not present in draft")
        store: Dict[int, AlignmentView] = {}
        bounds = np.nonzero(np.diff(cids))[0] + 1
        los = np.concatenate(([0], bounds))
        his = np.concatenate((bounds, [n]))
        for lo, hi in zip(los, his):
            lo, hi = int(lo), int(hi)
            store[int(cids[lo])] = AlignmentView(
                seq, seq_off[lo:hi + 1], cig, cig_off[lo:hi + 1],
                rb[lo:hi], re[lo:hi])
        return store, n, n_invalid

    def close(self) -> None:
        if self.h:
            self.lib.hypo_bam_close(self.h)
            self.h = None
