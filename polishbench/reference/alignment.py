"""Per-read alignment processing: position bookkeeping, CIGAR
break-point walking and arm extraction.

Ports of reference src/Alignment.cpp:
- ``Alignment.from_record``      <- ctors + initialise_pos + copy_data
  (Alignment.cpp:29-63, 514-571)
- ``find_bp``                    <- Alignment.cpp:321-406
- ``find_short_arms``            <- Alignment.cpp:222-259
- ``prepare_short_arm``          <- Alignment.cpp:408-511
- ``find_long_arms``             <- Alignment.cpp:262-299
- ``add_arms``                   <- Alignment.cpp:301-318

Frozen copy of hypo_tpu_torch/pipeline/alignment.py (the port's copy of
hypo_tpu/pipeline/alignment.py), pure Python and NumPy: the benchmark's plain reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .config import ARMS_SETTINGS, MINIMIZER_SETTINGS
from .dna import kmer_to_bytes
from .bam import OP_H, OP_S, BamRecord, cigar_consumes

# per-op (consumes-query | consumes-ref<<1) table, plain tuple for speed
_CONSUMES = tuple(cigar_consumes(op) for op in range(9))
_CONSUMES_ARR = np.array(_CONSUMES, dtype=np.int64)
from .regions import RegionType

INTERNAL, PREFIX, SUFFIX, EMPTY = range(4)


@dataclasses.dataclass
class Arm:
    windex: int
    codes: Optional[np.ndarray]  # None for EMPTY
    armtype: int


class Alignment:
    __slots__ = ("rb", "re", "qab", "qae", "codes", "_cbytes",
                 "cigar_ops", "cigar_lens", "cig_raw", "is_valid", "arms",
                 "qname")

    def __init__(self):
        self.arms: List[Arm] = []
        self.is_valid = True
        self.cig_raw = None  # BAM-encoded u32 CIGAR (native loader)
        self._cbytes = None

    @property
    def cbytes(self) -> bytes:
        """Lazy bytes view of the aligned codes for the Python arm
        anchor searches (bytes.find/rfind).  Built on first use only —
        the native arm path never touches it, so read memory stays one
        byte per base instead of two (the reference packs 2-bit,
        PackedSeq.hpp:80-160; our native batch buffers are transient)."""
        if self._cbytes is None:
            self._cbytes = self.codes.tobytes()
        return self._cbytes

    # -- construction -----------------------------------------------------
    @classmethod
    def from_record(cls, rec: BamRecord, contig_len: int,
                    norm_edit_th: Optional[int] = None) -> "Alignment":
        """norm_edit_th=None -> short-read ctor; else long-read ctor with
        the normalized-edit-distance gate (integer percent, floor division
        like the reference's INT64*100/UINT32)."""
        a = cls()
        a.qname = rec.qname
        ops = rec.cigar_ops
        lens = rec.cigar_lens.astype(np.int64)
        ctype = _CONSUMES_ARR[ops]
        a.rb = int(rec.pos)
        a.re = a.rb + int(lens[(ctype & 2) != 0].sum())
        q_len = int(lens[(ctype & 1) != 0].sum())
        qab = 0
        i = 0
        while i < len(ops) and int(ops[i]) in (OP_S, OP_H):
            if int(ops[i]) == OP_S:
                qab += int(lens[i])
            i += 1
        trailing = int(lens[i:][ops[i:] == OP_S].sum())
        qae = q_len - trailing
        if a.rb >= contig_len or a.re > contig_len:
            raise ValueError(
                f"alignment {rec.qname} out of contig bounds "
                f"(rb={a.rb} re={a.re} clen={contig_len}); is the BAM "
                "against this draft?")
        if norm_edit_th is not None and rec.nm is not None:
            rlen = a.re - a.rb
            if rlen > 0 and (rec.nm * 100) // rlen > norm_edit_th:
                a.is_valid = False
                return a
        codes = rec.seq_codes[qab:qae]
        if (codes > 3).any():
            a.is_valid = False  # reads containing N are dropped
            return a
        a.codes = np.ascontiguousarray(codes)

        a.qab = 0
        a.qae = qae - qab
        a.cigar_ops = ops
        a.cigar_lens = rec.cigar_lens
        return a

    @classmethod
    def from_parsed(cls, rb: int, re: int, codes: np.ndarray,
                    ops: np.ndarray, lens: np.ndarray,
                    cig_raw: Optional[np.ndarray] = None) -> "Alignment":
        """Construct from the native BAM reader's pre-computed fields
        (flag/mapq/NM/N filtering and clip trimming already applied)."""
        a = cls()
        a.qname = None
        a.rb = rb
        a.re = re
        a.codes = codes

        a.qab = 0
        a.qae = len(codes)
        a.cigar_ops = ops
        a.cigar_lens = lens
        a.cig_raw = cig_raw
        return a

    # -- break-point walk -------------------------------------------------
    def find_bp(self, reg_starts: np.ndarray, reg_type, beg_ind: int,
                end_ind: int) -> List[int]:
        """Walk the CIGAR against region boundaries, emitting the query
        position of each region edge crossed.  reg_starts[i] is the start
        of region i (select(i+1) in sdsl terms)."""
        results: List[int] = []
        cur_ref = self.rb
        cpi = beg_ind + 1  # current_processed_index
        next_ref = int(reg_starts[cpi])
        cur_q = 0
        is_corner = False
        ops = self.cigar_ops.tolist()
        lens = self.cigar_lens.tolist()
        for idx in range(len(ops)):
            op = ops[idx]
            oplen = lens[idx]
            if op == OP_S or op == OP_H:
                continue
            ctype = _CONSUMES[op]
            if ctype == 3:  # consumes query and reference
                if is_corner:
                    results.append(cur_q)
                    is_corner = False
                    cpi += 1
                    next_ref = int(reg_starts[cpi])
                while cur_ref + oplen >= next_ref and not is_corner:
                    diff = next_ref - cur_ref
                    cur_ref = next_ref
                    cur_q += diff
                    oplen -= diff
                    if oplen > 0:
                        results.append(cur_q)
                        cpi += 1
                        next_ref = int(reg_starts[cpi])
                    else:
                        is_corner = True
                if oplen > 0:
                    cur_ref += oplen
                    cur_q += oplen
            elif ctype & 2:  # consumes reference only (D/N)
                if is_corner:
                    results.append(cur_q)
                    is_corner = False
                    cpi += 1
                    next_ref = int(reg_starts[cpi])
                while cur_ref + oplen >= next_ref and not is_corner:
                    diff = next_ref - cur_ref
                    cur_ref = next_ref
                    oplen -= diff
                    if oplen > 0:
                        results.append(cur_q)
                        cpi += 1
                        next_ref = int(reg_starts[cpi])
                    else:
                        is_corner = True
                if oplen > 0:
                    cur_ref += oplen
            elif ctype & 1:  # consumes query only (I)
                if is_corner:
                    # insertion at a region corner: if the finished region
                    # is an SR, the inserted bases go to the right window
                    if reg_type[cpi - 1] in (RegionType.SR, RegionType.MSR):
                        results.append(cur_q)
                    else:
                        results.append(cur_q + oplen)
                    cpi += 1
                    next_ref = int(reg_starts[cpi])
                    is_corner = False
                cur_q += oplen
            if cpi == end_ind:
                break
        return results

    # -- short arms -------------------------------------------------------
    def find_short_arms(self, k: int, contig) -> None:
        reg_starts = contig.reg_starts
        reg_type = contig.reg_type
        b_ind = int(np.searchsorted(reg_starts, self.rb, side="left"))
        if b_ind >= len(reg_starts) or reg_starts[b_ind] != self.rb:
            b_ind -= 1  # read starts inside a region
        e_ind = int(np.searchsorted(reg_starts, self.re, side="left"))
        if e_ind - b_ind <= 1:
            return  # whole read inside one region
        bp = self.find_bp(reg_starts, reg_type, b_ind, e_ind)
        armtype = SUFFIX if reg_starts[b_ind] != self.rb else INTERNAL
        if reg_type[b_ind] not in (RegionType.SR, RegionType.MSR):
            self.prepare_short_arm(k, b_ind, self.qab, bp[0], armtype,
                                   contig)
        bp_ind = 0
        for ind in range(b_ind + 1, e_ind - 1):
            if reg_type[ind] not in (RegionType.SR, RegionType.MSR):
                if bp[bp_ind + 1] == bp[bp_ind]:
                    self.arms.append(Arm(ind, None, EMPTY))
                else:
                    self.prepare_short_arm(k, ind, bp[bp_ind],
                                           bp[bp_ind + 1], INTERNAL, contig)
            bp_ind += 1
        armtype = (INTERNAL if self._pos_marked(reg_starts, self.re)
                   else PREFIX)
        if reg_type[e_ind - 1] not in (RegionType.SR, RegionType.MSR):
            self.prepare_short_arm(k, e_ind - 1, bp[bp_ind], self.qae,
                                   armtype, contig)

    def prepare_short_arm(self, k: int, windex: int, qb: int, qe: int,
                          armtype: int, contig) -> None:
        ms = MINIMIZER_SETTINGS
        mk = ms.k
        reg_starts = contig.reg_starts
        cur_pos = int(reg_starts[windex])
        next_pos = int(reg_starts[windex + 1])
        if (next_pos - cur_pos) > ARMS_SETTINGS.short_arm_coef * (qe - qb):
            return  # arm far too short for the window
        wtype = contig.reg_type[windex]
        reg_info = contig.reg_info
        anchors = contig.anchor_kmers
        valid = True
        q_beg, q_end = qb, qe
        R = RegionType
        cb = self.cbytes
        # re-anchor on the preceding SR's last kmer
        if (wtype in (R.SWS, R.SW, R.SWM)) and armtype != SUFFIX:
            if q_beg < k:
                valid = False
            else:
                rank_sr = int(reg_info[windex - 1])
                pat = kmer_to_bytes(int(anchors[2 * rank_sr]), k)
                if cb[q_beg - k:q_beg] != pat:
                    s0 = 0 if q_beg < 2 * k else q_beg - 2 * k
                    s1 = q_end if q_end < q_beg + k else q_beg + k
                    hit = cb.rfind(pat, s0, s1)
                    if hit >= 0:
                        q_beg = hit + k
                    else:
                        valid = False
        # re-anchor on the succeeding SR's first kmer
        if valid and (wtype in (R.SWS, R.WS, R.MWS)) and armtype != PREFIX:
            if q_end + k > self.qae:
                valid = False
            else:
                rank_sr = int(reg_info[windex + 1])
                pat = kmer_to_bytes(int(anchors[2 * rank_sr - 1]), k)
                if cb[q_end:q_end + k] != pat:
                    s0 = q_beg if q_end < q_beg + k else q_end - k
                    s1 = min(self.qae, q_end + 2 * k)
                    hit = cb.find(pat, s0, s1)
                    if hit >= 0:
                        q_end = hit
                    else:
                        valid = False
        # re-anchor on the preceding minimizer
        if valid and (wtype in (R.MWM, R.MW, R.MWS)) and armtype != SUFFIX:
            if q_beg < mk:
                valid = False
            else:
                pat = kmer_to_bytes(int(reg_info[windex - 1]), mk)
                if cb[q_beg - mk:q_beg] != pat:
                    s0 = 0 if q_beg < 3 * mk else q_beg - 3 * mk
                    s1 = q_end if q_end < q_beg + 2 * mk else q_beg + 2 * mk
                    hit = cb.rfind(pat, s0, s1)
                    if hit >= 0:
                        q_beg = hit + mk
                    else:
                        valid = False
        # re-anchor on the succeeding minimizer
        if valid and (wtype in (R.MWM, R.WM, R.SWM)) and armtype != PREFIX:
            if q_end + mk > self.qae:
                valid = False
            else:
                pat = kmer_to_bytes(int(reg_info[windex + 1]), mk)
                if cb[q_end:q_end + mk] != pat:
                    s0 = q_beg if q_end < q_beg + 2 * mk else q_end - 2 * mk
                    s1 = min(self.qae, q_end + 3 * mk)
                    hit = cb.find(pat, s0, s1)
                    if hit >= 0:
                        q_end = hit
                    else:
                        valid = False
        if valid and q_beg < q_end:
            self.arms.append(Arm(windex,
                                 np.ascontiguousarray(
                                     self.codes[q_beg:q_end]),
                                 armtype))

    # -- long arms --------------------------------------------------------
    def find_long_arms(self, contig) -> None:
        starts = contig.pseudo_starts
        ptype = contig.pseudo_types
        true_id = contig.true_reg_id
        b_ind = int(np.searchsorted(starts, self.rb, side="left"))
        if b_ind >= len(starts) or starts[b_ind] != self.rb:
            b_ind -= 1
        e_ind = int(np.searchsorted(starts, self.re, side="left"))
        if e_ind - b_ind <= 1:
            return
        bp = self.find_bp(starts, ptype, b_ind, e_ind)
        armtype = SUFFIX if starts[b_ind] != self.rb else INTERNAL
        if ptype[b_ind] != RegionType.SR:
            self.arms.append(Arm(int(true_id[b_ind]),
                                 np.ascontiguousarray(
                                     self.codes[self.qab:bp[0]]), armtype))
        bp_ind = 0
        for ind in range(b_ind + 1, e_ind - 1):
            if ptype[ind] != RegionType.SR:
                if bp[bp_ind + 1] == bp[bp_ind]:
                    self.arms.append(Arm(int(true_id[ind]), None, EMPTY))
                else:
                    self.arms.append(Arm(
                        int(true_id[ind]),
                        np.ascontiguousarray(
                            self.codes[bp[bp_ind]:bp[bp_ind + 1]]),
                        INTERNAL))
            bp_ind += 1
        armtype = INTERNAL if self._pos_marked(starts, self.re) else PREFIX
        if ptype[e_ind - 1] != RegionType.SR:
            self.arms.append(Arm(int(true_id[e_ind - 1]),
                                 np.ascontiguousarray(
                                     self.codes[bp[bp_ind]:self.qae]),
                                 armtype))

    @staticmethod
    def _pos_marked(starts: np.ndarray, pos: int) -> bool:
        i = int(np.searchsorted(starts, pos, side="left"))
        return i < len(starts) and starts[i] == pos

    # -- filling ----------------------------------------------------------
    def add_arms(self, contig) -> None:
        for a in self.arms:
            w = contig.windows[a.windex]
            if w is None:
                continue
            if a.armtype == PREFIX:
                w.add_prefix(a.codes)
            elif a.armtype == SUFFIX:
                w.add_suffix(a.codes)
            elif a.armtype == INTERNAL:
                w.add_internal(a.codes)
            else:
                w.add_empty()
        self.arms = []
