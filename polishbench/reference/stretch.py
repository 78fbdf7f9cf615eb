"""HyPo's polish of one stretch of a draft contig, on the plain copy.

A stretch [a, b) of contig ``cid`` is polished as a contig of its own:
its draft is draft[a:b], its alignments are the BAM records that lie
wholly inside it (shifted by -a), and the solid k-mer set is the whole
read set's.  Every quantity the polish derives at a position p (solid
k-mer coverage and support, minimizer support, arms) comes from the
alignments that cover p, so it is exact wherever every alignment that
covers p lies inside the stretch: from ``margin`` bp after a to
``margin`` bp before b, with ``margin`` at least the longest
alignment's reference span.  The scans that carry state along the
contig (strong regions, long pseudo-windows) agree with the whole
contig's once they have closed a strong region inside that zone, so the
trusted interior runs from the start of the third strong region that
begins ``margin`` bp or more after a to the end of the third-last that
ends ``margin`` bp or more before b.  Both ends are strong regions,
which the polished contig keeps as draft.

``segment`` does the stages up to window fill (the port's
``Polisher._polish_batch`` on its pure-Python path) and returns the
interior's regions, with the consensus of every window the identical-
arm rules settle; ``stitch`` joins the interior's polished text once the
other windows' consensus (``ConsensusEngine.generate_consensus``) is in.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .alignment import Alignment
from .bam import (_NIB_TO_CODE, FDUP, FQCFAIL, FSECONDARY, FUNMAP, BamRecord,
                  _parse_nm)
from .config import ScoreParams, WindowSettings
from .contig import Contig
from .dna import decode
from .engine import ConsensusEngine
from .regions import RegionType
from .solid import SolidKmers
from .support import update_minimisers_support, update_solidkmers_support

_CORE = struct.Struct("<iiBBHHHiiii")
_STRONG = (RegionType.SR, RegionType.MSR)
# reference-consuming CIGAR ops (M, D, N, =, X)
_REF_OPS = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], bool)


def parse_records(buf: bytes) -> List[BamRecord]:
    """BAM records (each with its block_size prefix) from ``buf``, as
    ``hypo_tpu_torch.io.bam._read_bam`` decodes them."""
    out: List[BamRecord] = []
    off = 0
    n = len(buf)
    while off < n:
        (block_size,) = struct.unpack_from("<i", buf, off)
        data = buf[off + 4:off + 4 + block_size]
        off += 4 + block_size
        (refid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         _nrid, _npos, _tlen) = _CORE.unpack_from(data, 0)
        o = 32
        qname = data[o:o + l_read_name - 1].decode("ascii")
        o += l_read_name
        cig = np.frombuffer(data, dtype="<u4", count=n_cigar, offset=o)
        o += 4 * n_cigar
        ops = (cig & 0xF).astype(np.uint8)
        lens = (cig >> 4).astype(np.uint32)
        nbytes = (l_seq + 1) // 2
        packed = np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=o)
        o += nbytes
        nibs = np.empty(nbytes * 2, dtype=np.uint8)
        nibs[0::2] = packed >> 4
        nibs[1::2] = packed & 0xF
        o += l_seq  # qual
        out.append(BamRecord(qname, flag, refid, pos, mapq, ops, lens,
                             _NIB_TO_CODE[nibs[:l_seq]], _parse_nm(data, o)))
    return out


def load_alignments(buf: bytes, cid: int, a: int, b: int, min_mapq: int,
                    norm_edit_th: Optional[int]) -> List[Alignment]:
    """The valid alignments of ``buf`` (records in BAM order) that lie in
    [a, b) of contig ``cid``, in stretch coordinates; the stream's and
    the loader's filters as in ``pipeline.polish._BamStream``."""
    alns: List[Alignment] = []
    for rec in parse_records(buf):
        if rec.flag & (FUNMAP | FSECONDARY | FQCFAIL | FDUP):
            continue
        if rec.tid != cid or rec.mapq < min_mapq or rec.pos < a:
            continue
        end = rec.pos + int(rec.cigar_lens[_REF_OPS[rec.cigar_ops]].sum())
        if end > b:
            continue
        rec.pos -= a
        aln = Alignment.from_record(rec, b - a, norm_edit_th=norm_edit_th)
        if aln.is_valid:
            alns.append(aln)
    return alns


def _interior(ctg: Contig, margin: int) -> Optional[Tuple[int, int]]:
    """(first, last) region index of the trusted interior, both strong
    regions, or None when the stretch has too few strong regions."""
    starts = ctg.reg_starts
    strong = [i for i in range(ctg.num_regions())
              if ctg.reg_type[i] in _STRONG]
    left = [i for i in strong if starts[i] >= margin]
    right = [i for i in strong if starts[i + 1] <= ctg.length - margin]
    if len(left) < 3 or len(right) < 3:
        return None
    first, last = left[2], right[-3]
    if last < first:
        return None
    return first, last


def segment(draft: np.ndarray, name: str, tid: int, a: int, b: int,
            sk: SolidKmers, k: int, sr_buf: bytes, lr_buf: Optional[bytes],
            margin: int, min_mapq: int, norm_edit_th: int) -> dict:
    """Segment stretch [a, b) of the contig that is reference ``tid`` of
    both BAMs, and fill its windows.  Returns a dict:
    ``regions`` [(start, end, type)] of the interior in contig
    coordinates, ``cons`` {region: consensus} of the windows settled
    without a POA, ``jobs`` {region: Window} of those that need one,
    and ``no_long_reads``; or None when the stretch has no interior."""
    ws = WindowSettings()
    ctg = Contig(0, name, np.ascontiguousarray(draft[a:b]))
    alns = load_alignments(sr_buf, tid, a, b, min_mapq, None)
    ctg.find_solid_pos(sk)
    update_solidkmers_support(ctg, alns, k)
    ctg.prepare_for_division(k, ws)
    update_minimisers_support(ctg, alns)
    ctg.divide_into_regions(ws)
    for aln in alns:
        aln.find_short_arms(k, ctg)
    ctg.fill_short_windows(alns)
    if lr_buf is not None:
        lalns = load_alignments(lr_buf, tid, a, b, min_mapq, norm_edit_th)
        ctg.prepare_long_windows(ws)
        for aln in lalns:
            aln.find_long_arms(ctg)
        ctg.fill_long_windows(lalns)
    span = _interior(ctg, margin)
    if span is None:
        return None
    first, last = span
    regions, cons, jobs = [], {}, {}
    for i in range(first, last + 1):
        s, e = int(ctg.reg_starts[i]), int(ctg.reg_starts[i + 1])
        regions.append((a + s, a + e, int(ctg.reg_type[i])))
        w = ctg.windows[i]
        if ctg.reg_type[i] in _STRONG or w is None:
            continue
        settled = settle(w)
        if settled is None:
            jobs[i - first] = w
        else:
            cons[i - first] = settled
    return {"regions": regions, "cons": cons, "jobs": jobs,
            "no_long_reads": lr_buf is None}


def settle(w) -> Optional[str]:
    """A window's consensus where the dispatch rules give it without a
    POA (``ConsensusEngine.generate_consensus``), else None."""
    non_empty = w.num_internal + w.num_pre + w.num_suf
    if w.num_empty > non_empty:
        return ""
    if non_empty < 2:
        return decode(w.draft)
    return ConsensusEngine(ScoreParams())._trivial_consensus(w)


def stitch(draft: np.ndarray, seg: dict, cons: Dict[int, str]) -> str:
    """The polished text of the interior (``Contig.polished_seq`` over its
    regions), with ``cons`` the consensus of each window by its index in
    ``seg["regions"]``."""
    parts: List[str] = []
    for j, (s, e, t) in enumerate(seg["regions"]):
        if t in _STRONG:
            parts.append(decode(draft[s:e]))
        elif j in cons:
            parts.append(cons[j] or "")
        elif seg["no_long_reads"]:
            parts.append(decode(draft[s:e]))
    return "".join(parts)
