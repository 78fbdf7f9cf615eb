"""The comparison that decides ``correct``: each polished FASTA of the
window against the plain reference (``polishbench.reference``), over
stretches of the draft drawn from the seed.

The reference polishes each stretch as a contig of its own
(``reference.stretch``), with the solid k-mer set counted over every
read, and joins its trusted interior's polished text.  A polish is
right on a stretch when that text occurs exactly once in its polished
contig, after the previous stretch's; the text begins and ends with a
strong region of the draft and is tens of kbp long, so it occurs in a
wrong polish only where that polish is right over the whole interior.

Numbers compared (each with its limit in ``LIMITS``):

- ``stretches_wrong``: stretches, over every polish of the window, whose
  text is not found once and in order (an exact comparison);
- ``polishes_wrong``: polishes with a stretch wrong or an unreadable
  FASTA;
- ``stretches_unchecked``: stretches too short to hold a trusted
  interior (then nothing of them was compared).

The reference runs in a pool of processes (spawn) after the window has
closed: the stretches' segmentation first, then the POA of every window
the identical-arm rules do not settle, spread over the pool.
"""
from __future__ import annotations

import multiprocessing
import os
import struct
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LIMITS = {"stretches_wrong": 0, "polishes_wrong": 0,
          "stretches_unchecked": 0}

_POOL_STATE: dict = {}


# -- inputs ---------------------------------------------------------------------

def read_fasta(path: str) -> List[Tuple[str, str]]:
    """(name, sequence) of every record of a FASTA file."""
    out: List[Tuple[str, str]] = []
    name, chunks = None, []
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                name = line[1:].split()[0] if line[1:].split() else ""
                chunks = []
            else:
                chunks.append(line.strip())
    if name is not None:
        out.append((name, "".join(chunks)))
    return out


def bgzf_decompress(data: bytes) -> bytes:
    """The payload of a BGZF file: its blocks' deflate streams inflated
    one by one, each found by its BSIZE field (``gzip.decompress`` copies
    the rest of the file at every member, quadratic in the blocks)."""
    out = []
    off = 0
    n = len(data)
    while off < n:
        if data[off:off + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError("not a BGZF block")
        (xlen,) = struct.unpack_from("<H", data, off + 10)
        bsize = None
        x = off + 12
        while x < off + 12 + xlen:
            si1, si2, slen = struct.unpack_from("<BBH", data, x)
            if si1 == 66 and si2 == 67:
                (bsize,) = struct.unpack_from("<H", data, x + 4)
            x += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BSIZE")
        end = off + bsize + 1
        out.append(zlib.decompress(data[off + 12 + xlen:end - 8], -15))
        off = end
    return b"".join(out)


class BamIndex:
    """A BAM file decompressed in memory, with each record's offset,
    reference id and position."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            self.buf = bgzf_decompress(fh.read())
        buf = self.buf
        if buf[:4] != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack_from("<i", buf, 4)
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", buf, off)
        off += 4
        self.refs: List[str] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", buf, off)
            self.refs.append(buf[off + 4:off + 3 + l_name].decode("ascii"))
            off += 8 + l_name
        offs, tids, poss = [], [], []
        unpack = struct.Struct("<iii").unpack_from
        n = len(buf)
        while off < n:
            size, tid, pos = unpack(buf, off)
            offs.append(off)
            tids.append(tid)
            poss.append(pos)
            off += 4 + size
        offs.append(off)
        self.offs = np.array(offs, np.int64)
        self.tid = np.array(tids, np.int64)
        self.pos = np.array(poss, np.int64)

    def slice(self, tid: int, a: int, b: int) -> bytes:
        """The records of reference ``tid`` that start in [a, b), as one
        buffer in file order (the BAM is sorted by reference and
        position)."""
        sel = np.flatnonzero((self.tid == tid) & (self.pos >= a)
                             & (self.pos < b))
        if not len(sel):
            return b""
        lo, hi = int(sel[0]), int(sel[-1]) + 1
        return self.buf[self.offs[lo]:self.offs[hi]]


# -- the stretches --------------------------------------------------------------

def plan_stretches(seed: int, length: int, spec: dict,
                   zones: Sequence[Tuple[int, int]] = ()) -> List[Tuple[int,
                                                                        int]]:
    """Sorted, disjoint stretches of a contig of ``length`` bp: one that
    covers each zone [lo, hi) with ``margin`` + ``pad`` bp on both
    sides, and ``count`` of ``bp`` each placed from the seed on slots of
    ``bp`` that overlap none of those."""
    margin, pad, bp = spec["margin"], spec["pad"], spec["bp"]
    taken: List[Tuple[int, int]] = []
    for lo, hi in zones:
        taken.append((max(0, lo - margin - pad),
                      min(length, hi + margin + pad)))
    slots = [s for s in range(0, length - bp + 1, bp)
             if all(s + bp <= a or s >= b for a, b in taken)]
    rng = np.random.default_rng([seed % (1 << 63), 0x5EED])
    n = min(spec["count"], len(slots))
    picked = rng.choice(len(slots), size=n, replace=False) if n else []
    out = taken + [(slots[i], slots[i] + bp) for i in picked]
    return sorted(out)


def plan(seed: int, length: int, mix: dict) -> List[Tuple[int, int]]:
    """The stretches a run of ``mix`` checks on a contig of ``length``
    bp: ``plan_stretches`` with the mix's ``check``, and the short-read
    dropout as a zone where the mix asks for it."""
    chk = mix["check"]
    zones = []
    dropout = mix["reads"].get("dropout")
    if chk.get("dropout_zone") and dropout:
        zones.append((int(dropout[0] * length), int(dropout[1] * length)))
    return plan_stretches(seed, length, chk, zones)


def _pool_init(state: dict) -> None:
    _POOL_STATE.update(state)


def _count(block: bytes):
    from .reference.counting import count_block
    return count_block(block, _POOL_STATE["k"])


def _segment(task):
    from .reference.stretch import segment
    st = _POOL_STATE
    a, b, sr_buf, lr_buf, sk = task
    return segment(st["draft"], st["name"], st["tid"], a, b, sk, st["k"],
                   sr_buf, lr_buf, st["margin"], st["min_mapq"],
                   st["norm_edit_th"])


def _consensus(task):
    from .reference.config import ScoreParams
    from .reference.engine import ConsensusEngine
    key, w = task
    if _POOL_STATE.get("control"):
        from .control import control_engine
        engine = control_engine(ScoreParams())
    else:
        engine = ConsensusEngine(ScoreParams())
    engine.generate_consensus(w)
    return key, w.consensus


class Reference:
    """The reference's polished text of each stretch of contig 0."""

    def __init__(self, inputs: Dict[str, Optional[str]], k: int, cov: int,
                 spec: dict, stretches: List[Tuple[int, int]],
                 min_mapq: int = 2, norm_edit_th: int = 20,
                 control: bool = False, workers: int = 0):
        self.inputs = inputs
        self.k = k
        self.cov = cov
        self.spec = spec
        self.stretches = stretches
        self.min_mapq = min_mapq
        self.norm_edit_th = norm_edit_th
        self.control = control
        self.workers = workers or min(8, os.cpu_count() or 1)
        self.texts: List[Optional[str]] = []
        # each interior's span [start, end) on the draft, or None
        self.spans: List[Optional[Tuple[int, int]]] = []
        self.stats: Dict[str, float] = {}

    def run(self) -> List[Optional[str]]:
        from .reference.counting import read_blocks
        from .reference.dna import encode
        from .reference.solid import SolidKmers
        t0 = time.perf_counter()
        name, seq = read_fasta(self.inputs["draft"])[0]
        draft = encode(seq)
        sr = BamIndex(self.inputs["sr_bam"])
        lr = BamIndex(self.inputs["lr_bam"]) if self.inputs.get("lr_bam") \
            else None
        tid = sr.refs.index(name)
        if lr is not None and lr.refs.index(name) != tid:
            raise ValueError("the two BAMs order the contigs differently")
        slices = [(a, b, sr.slice(tid, a, b),
                   lr.slice(tid, a, b) if lr is not None else None)
                  for a, b in self.stretches]
        del sr, lr
        state = {"draft": draft, "name": name, "tid": tid, "k": self.k,
                 "margin": self.spec["margin"], "min_mapq": self.min_mapq,
                 "norm_edit_th": self.norm_edit_th,
                 "control": self.control}
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(self.workers, initializer=_pool_init,
                      initargs=(state,)) as pool:
            # a block of reads a worker
            blocks = read_blocks([self.inputs["reads"]],
                                 max(1 << 20, len(seq) * self.cov
                                     // self.workers + 1))
            table = sum(t.astype(np.int64)
                        for t in pool.imap_unordered(_count, blocks))
            del blocks
            sk = SolidKmers(self.k).initialise_from_table(table, self.cov)
            t1 = time.perf_counter()
            segs = pool.map(_segment, [s + (sk,) for s in slices],
                            chunksize=1)
            t2 = time.perf_counter()
            jobs = [((si, j), w) for si, seg in enumerate(segs)
                    if seg is not None for j, w in seg["jobs"].items()]
            # the longest windows first, so that no worker ends alone
            jobs.sort(key=lambda kw: -len(kw[1].draft) * (
                1 + kw[1].num_internal + kw[1].num_pre + kw[1].num_suf))
            done = dict(pool.imap_unordered(_consensus, jobs, chunksize=1))
            pool.close()
            pool.join()
        t3 = time.perf_counter()
        self.texts = []
        self.spans = []
        from .reference.stretch import stitch
        n_win = n_long = 0
        for si, seg in enumerate(segs):
            if seg is None:
                self.texts.append(None)
                self.spans.append(None)
                continue
            self.spans.append((seg["regions"][0][0], seg["regions"][-1][1]))
            cons = dict(seg["cons"])
            for j in seg["jobs"]:
                cons[j] = done[(si, j)]
            n_win += sum(1 for _s, _e, t in seg["regions"] if t not in
                         (10, 11))
            n_long += sum(1 for _s, _e, t in seg["regions"] if t == 9)
            self.texts.append(stitch(draft, seg, cons))
        self.stats = {
            "inputs_s": t1 - t0, "segment_s": t2 - t1, "poa_s": t3 - t2,
            "stretches": len(self.stretches),
            "interiors": sum(t is not None for t in self.texts),
            "interior_bp": sum(len(t) for t in self.texts if t is not None),
            "windows": n_win, "long_windows": n_long, "poa_windows": len(jobs),
        }
        return self.texts


def judge(path: str, name: str, texts: List[Optional[str]]) -> int:
    """Stretches of ``texts`` that the polished FASTA at ``path`` does not
    hold exactly once and in order in contig ``name``; every stretch
    when the FASTA cannot be read or lacks the contig."""
    try:
        seqs = dict(read_fasta(path))
    except (OSError, UnicodeDecodeError, ValueError):
        return len(texts)
    seq = seqs.get(name)
    if seq is None:
        return len(texts)
    wrong = 0
    prev = 0
    for t in texts:
        if t is None:
            continue
        at = seq.find(t)
        if at < prev or seq.find(t, at + 1) >= 0:
            wrong += 1
            continue
        prev = at + len(t)
    return wrong


def verdict(paths: Sequence[str], name: str, texts: List[Optional[str]],
            stats: Dict[str, float]) -> Tuple[Dict[str, dict], bool]:
    """Each number compared, with its limit, over the polished FASTAs at
    ``paths`` (one a polish), and whether every one keeps its limit."""
    wrong = [judge(p, name, texts) for p in paths]
    checks = {
        "stretches_wrong": {"value": sum(wrong),
                            "limit": LIMITS["stretches_wrong"]},
        "polishes_wrong": {"value": sum(1 for w in wrong if w),
                           "limit": LIMITS["polishes_wrong"]},
        "stretches_unchecked": {
            "value": stats["stretches"] - stats["interiors"],
            "limit": LIMITS["stretches_unchecked"]},
    }
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def splice(draft: str, spans: Sequence[Optional[Tuple[int, int]]],
           texts: Sequence[Optional[str]]) -> str:
    """The draft with each interior's span replaced by its text: a
    polished contig that holds those texts where a polish holds its
    own."""
    parts, at = [], 0
    for span, text in zip(spans, texts):
        if span is None:
            continue
        parts += [draft[at:span[0]], text]
        at = span[1]
    parts.append(draft[at:])
    return "".join(parts)
