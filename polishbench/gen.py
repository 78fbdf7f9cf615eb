"""The benchmark's input generator: a frozen copy of the NumPy path of
``hypo_tpu_torch.sim`` (truth, draft FASTA, short reads FASTQ.gz and
the sorted BAMs of short and long reads against the draft, from a seed).

The random draws are the original's, in its order, so a seed gives the
files ``HYPO_SIM_PYTHON=1 python -m hypo_tpu_torch.sim`` writes (the
same bytes once decompressed).  Only the work after the draws is
spread: each read's edit script (``_compose_read``, copied as it is)
and its BAM record are made in a pool of processes, in chunks of reads
of ``CHUNK_BASES`` bases,
and the BAM's 60,000-byte BGZF blocks are compressed there too.  The
short reads' FASTQ is gzipped at level 1 (the original: level 9).
"""
from __future__ import annotations

import gzip
import multiprocessing
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .reference.bam import FREVERSE, _bgzf_block, _BGZF_EOF, _CODE_TO_NIB
from .reference.dna import decode, revcomp

CHUNK_BASES = 3_000_000
BGZF_PAYLOAD = 60_000

_CONTIGS: list = []


def _mutation_events(rng, codes: np.ndarray, rate: float):
    """Draw one event per position: (snp, ins, dele) masks + replacement/
    inserted base values.  ins inserts one random base BEFORE position i
    (i itself still emitted); dele drops position i."""
    n = len(codes)
    ev = rng.random(n) < rate
    kind = rng.integers(0, 3, size=n)
    snp = ev & (kind == 0)
    ins = ev & (kind == 1)
    dele = ev & (kind == 2)
    out = np.empty(n, dtype=np.uint8)
    out[:] = codes
    nsnp = int(snp.sum())
    if nsnp:
        out[snp] = (codes[snp] + rng.integers(1, 4, size=nsnp)) % 4
    return snp, ins, dele, out


def _apply_events(codes, snp, ins, dele, out_bases, rng=None,
                  ins_bases=None):
    """Materialize the mutated sequence.  Returns (seq, t2d, ins_dpos):
    t2d[i] = output coordinate of truth base i (or -1 if deleted);
    ins_dpos[i] = output coordinate of the base inserted before i (or -1).
    """
    n = len(codes)
    emit = ~dele
    emit_count = ins.astype(np.int64) + emit
    start = np.cumsum(emit_count) - emit_count
    total = int(start[-1] + emit_count[-1]) if n else 0
    seq = np.empty(total, dtype=np.uint8)
    nins = int(ins.sum())
    if nins:
        if ins_bases is None:
            ins_bases = rng.integers(0, 4, size=nins).astype(np.uint8)
        seq[start[ins]] = ins_bases
    tdst = start + ins
    seq[tdst[emit]] = out_bases[emit]
    t2d = np.where(emit, tdst, -1)
    ins_dpos = np.where(ins, start, -1)
    return seq, t2d, ins_dpos


M_OP, I_OP, D_OP = 0, 1, 2


def _compose_read(s, e, g, dbase, t2d, ins_dpos, d_ev_t, d_kind,
                  q_ev_t, q_kind, q_base):
    """Compose truth->draft events with truth->read events over the truth
    window [s, e) into (read_codes, pos, cigar ops/lens, exact NM)."""
    cols = {}
    for t, k in zip(d_ev_t, d_kind):
        cols.setdefault(int(t), [None, None])[0] = int(k)
    for t, k, b in zip(q_ev_t, q_kind, q_base):
        cols.setdefault(int(t), [None, None])[1] = (int(k), int(b))
    ops: List[int] = []
    lens: List[int] = []
    segs: List[np.ndarray] = []
    one = np.empty(1, np.uint8)

    def emit(op, ln):
        if ops and ops[-1] == op:
            lens[-1] += ln
        else:
            ops.append(op)
            lens.append(ln)

    nm = 0
    pos = -1
    prev = s
    for t in sorted(cols):
        if t >= e:
            break
        if t > prev:  # event-free gap: exact match run
            if pos < 0:
                pos = int(t2d[prev])
            emit(M_OP, t - prev)
            segs.append(g[prev:t])
        dk, q = cols[t]
        if dk == 1:  # draft insertion before t -> ref-only base
            if pos < 0:
                pos = int(ins_dpos[t])
            emit(D_OP, 1)
            nm += 1
        if q is not None and q[0] == 1:  # read insertion before t
            emit(I_OP, 1)
            nm += 1
            seg = one.copy()
            seg[0] = q[1]
            segs.append(seg)
        q_emits = q is None or q[0] != 2
        r_emits = dk != 2
        if q_emits:
            bq = g[t] if (q is None or q[0] != 0) else q[1]
        if q_emits and r_emits:
            if pos < 0:
                pos = int(t2d[t])
            emit(M_OP, 1)
            nm += int(bq != dbase[t])
            seg = one.copy()
            seg[0] = bq
            segs.append(seg)
        elif r_emits:
            if pos < 0:
                pos = int(t2d[t])
            emit(D_OP, 1)
            nm += 1
        elif q_emits:
            emit(I_OP, 1)
            nm += 1
            seg = one.copy()
            seg[0] = bq
            segs.append(seg)
        prev = t + 1
    if prev < e:
        if pos < 0:
            pos = int(t2d[prev])
        emit(M_OP, e - prev)
        segs.append(g[prev:e])
    # real aligners never emit boundary deletions: trim them (adjusting
    # pos and NM), so downstream CIGAR walkers see realistic records
    while ops and ops[0] == D_OP:
        pos += lens[0]
        nm -= lens[0]
        ops.pop(0)
        lens.pop(0)
    while ops and ops[-1] == D_OP:
        nm -= lens[-1]
        ops.pop()
        lens.pop()
    read = (np.concatenate(segs) if segs
            else np.empty(0, np.uint8))
    return (read, pos, np.array(ops, dtype=np.uint8),
            np.array(lens, dtype=np.uint32), nm)


def bam_record(qname: str, flag: int, tid: int, pos: int, mapq: int,
               ops: np.ndarray, lens: np.ndarray, codes: np.ndarray,
               nm: Optional[int]) -> bytes:
    """One BAM record with its block_size prefix, as
    ``hypo_tpu_torch.io.bam.write_bam`` encodes it."""
    qn = qname.encode("ascii") + b"\x00"
    l_seq = len(codes)
    cig = ((lens.astype(np.uint32) << 4)
           | ops.astype(np.uint32)).astype("<u4").tobytes()
    nibs = _CODE_TO_NIB[np.minimum(codes, 4)]
    if l_seq % 2:
        nibs = np.concatenate([nibs, np.zeros(1, dtype=np.uint8)])
    packed = ((nibs[0::2] << 4) | nibs[1::2]).astype(np.uint8).tobytes()
    aux = b"" if nm is None else b"NMi" + struct.pack("<i", nm)
    data = struct.pack("<iiBBHHHiiii", tid, pos, len(qn), mapq, 0,
                       len(ops), flag, l_seq, -1, -1, 0) + qn + cig + \
        packed + b"\xff" * l_seq + aux
    return struct.pack("<i", len(data)) + data


def bam_header(refs: Sequence[Tuple[str, int]]) -> bytes:
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in refs)
    body = bytearray(b"BAM\x01")
    body += struct.pack("<i", len(text)) + text.encode("ascii")
    body += struct.pack("<i", len(refs))
    for name, ln in refs:
        nb = name.encode("ascii") + b"\x00"
        body += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return bytes(body)


# -- pool workers ---------------------------------------------------------------

def _init(contigs) -> None:
    _CONTIGS[:] = contigs


def _reads_chunk(task):
    """Compose reads [lo, hi) of one contig: (pos of each record, the
    records, the FASTQ text or b"")."""
    (c, lo, starts, revs, qoff, q_t, q_kind, q_base, d_lo, d_hi, rlen,
     prefix, want_fq) = task
    g, dbase, t2d, ins_dpos, ev_t, ev_kind = _CONTIGS[c]
    poss: List[int] = []
    recs: List[bytes] = []
    fq: List[str] = []
    for i in range(len(starts)):
        s = int(starts[i])
        read, pos, ops, lens, nm = _compose_read(
            s, s + rlen, g, dbase, t2d, ins_dpos,
            ev_t[d_lo[i]:d_hi[i]], ev_kind[d_lo[i]:d_hi[i]],
            q_t[qoff[i]:qoff[i + 1]], q_kind[qoff[i]:qoff[i + 1]],
            q_base[qoff[i]:qoff[i + 1]])
        if len(read) == 0 or len(ops) == 0:
            continue
        name = f"{prefix}{c}_{lo + i}"
        rev = bool(revs[i])
        if want_fq:
            seq = decode(revcomp(read) if rev else read)
            fq.append(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
        recs.append(bam_record(name, FREVERSE if rev else 0, c, pos, 60, ops,
                               lens, read, nm))
        poss.append(pos)
    return np.array(poss, np.int64), recs, "".join(fq).encode("ascii")


def _gzip1(data: bytes) -> bytes:
    return gzip.compress(data, compresslevel=1, mtime=0)


# -- the generator --------------------------------------------------------------

def _draw_reads(rng, genomes, dmaps, cov: int, rlen: int, err: float,
                dropout):
    """The random draws of ``make_reads`` for each contig, in its order."""
    out = []
    for c, g in enumerate(genomes):
        _dbase, _t2d, _ins_dpos, ev_t, _ev_kind = dmaps[c]
        n_reads = (len(g) * cov) // rlen
        starts = rng.integers(0, max(1, len(g) - rlen), size=n_reads)
        if dropout is not None:
            ds = int(dropout[0] * len(g))
            de = int(dropout[1] * len(g))
            for _ in range(50):
                bad = (starts + rlen > ds) & (starts < de)
                if not bad.any():
                    break
                starts[bad] = rng.integers(
                    0, max(1, len(g) - rlen), size=int(bad.sum()))
        revs = rng.integers(0, 2, size=n_reads).astype(bool)
        counts = rng.binomial(rlen, err, size=n_reads)
        qoff = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        total_q = int(qoff[-1])
        q_rel = rng.integers(0, rlen, size=total_q)
        q_kind = rng.integers(0, 3, size=total_q)
        q_t = np.repeat(starts, counts) + q_rel
        q_base = np.where(
            q_kind == 0,
            (g[q_t].astype(np.int64) + rng.integers(1, 4, size=total_q)) % 4,
            rng.integers(0, 4, size=total_q)).astype(np.uint8)
        d_lo = np.searchsorted(ev_t, starts)
        d_hi = np.searchsorted(ev_t, starts + rlen)
        out.append((starts, revs, qoff, q_t, q_kind, q_base, d_lo, d_hi))
    return out


def _make_reads(pool, draws, rlen: int, prefix: str, want_fq: bool):
    """(BAM records sorted by (contig, pos), stably, and the FASTQ text
    in generation order)."""
    tasks = []
    chunk = max(1, CHUNK_BASES // rlen)
    for c, (starts, revs, qoff, q_t, q_kind, q_base, d_lo,
            d_hi) in enumerate(draws):
        for lo in range(0, len(starts), chunk):
            hi = min(lo + chunk, len(starts))
            q0, q1 = int(qoff[lo]), int(qoff[hi])
            tasks.append((c, lo, starts[lo:hi], revs[lo:hi],
                          qoff[lo:hi + 1] - q0, q_t[q0:q1], q_kind[q0:q1],
                          q_base[q0:q1], d_lo[lo:hi], d_hi[lo:hi], rlen,
                          prefix, want_fq))
    parts = pool.map(_reads_chunk, tasks, chunksize=1)
    tid = np.concatenate([np.full(len(p), t[0], np.int64)
                          for p, t in zip((p for p, _r, _f in parts), tasks)])
    pos = np.concatenate([p for p, _r, _f in parts])
    recs = [r for _p, rs, _f in parts for r in rs]
    order = np.lexsort((pos, tid))
    fq = b"".join(f for _p, _r, f in parts)
    return [recs[i] for i in order], fq


def _write_bam(pool, path: str, refs, recs: List[bytes]) -> None:
    blob = bam_header(refs) + b"".join(recs)
    blocks = [blob[i:i + BGZF_PAYLOAD]
              for i in range(0, len(blob), BGZF_PAYLOAD)]
    with open(path, "wb") as fh:
        for blk in pool.imap(_bgzf_block, blocks, chunksize=16):
            fh.write(blk)
        fh.write(_BGZF_EOF)


def _write_fasta(path: str, records) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")


def simulate(out_dir: str, seed: int, genome_size: int, num_contigs: int = 1,
             draft_error_rate: float = 0.01, short_cov: int = 30,
             short_len: int = 150, short_err: float = 0.002,
             long_cov: int = 0, long_len: int = 1200, long_err: float = 0.08,
             dropout: Optional[Tuple[float, float]] = None,
             workers: int = 0) -> dict:
    """Write truth.fa, draft.fa, reads.fq.gz, sr.bam and (with
    ``long_cov``) lr.bam into ``out_dir``; returns their paths, as
    ``hypo_tpu_torch.sim.simulate`` with ``SimConfig`` of these fields."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    truths, drafts, genomes, dmaps = [], [], [], []
    per_contig = genome_size // num_contigs
    for c in range(num_contigs):
        g = rng.integers(0, 4, size=per_contig).astype(np.uint8)
        snp, ins, dele, dbase = _mutation_events(rng, g, draft_error_rate)
        d, t2d, ins_dpos = _apply_events(g, snp, ins, dele, dbase, rng)
        ev_t = np.flatnonzero(snp | ins | dele)
        ev_kind = np.where(snp[ev_t], 0, np.where(ins[ev_t], 1, 2))
        genomes.append(g)
        dmaps.append((dbase, t2d, ins_dpos, ev_t, ev_kind))
        truths.append((f"ctg{c}", decode(g)))
        drafts.append((f"ctg{c}", decode(d)))
    paths = {k: os.path.join(out_dir, f) for k, f in (
        ("truth", "truth.fa"), ("draft", "draft.fa"),
        ("reads", "reads.fq.gz"), ("sr_bam", "sr.bam"))}
    _write_fasta(paths["truth"], truths)
    _write_fasta(paths["draft"], drafts)
    refs = [(n, len(s)) for n, s in drafts]
    contigs = [(g,) + tuple(m) for g, m in zip(genomes, dmaps)]
    sr_draws = _draw_reads(rng, genomes, dmaps, short_cov, short_len,
                           short_err, dropout)
    lr_draws = (_draw_reads(rng, genomes, dmaps, long_cov, long_len,
                            long_err, None) if long_cov > 0 else None)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers or min(8, os.cpu_count() or 1), initializer=_init,
                  initargs=(contigs,)) as pool:
        recs, fq = _make_reads(pool, sr_draws, short_len, "sr", True)
        fq_gz = pool.apply_async(_gzip1, (fq,))
        del fq
        _write_bam(pool, paths["sr_bam"], refs, recs)
        del recs
        if lr_draws is not None:
            recs, _ = _make_reads(pool, lr_draws, long_len, "lr", False)
            paths["lr_bam"] = os.path.join(out_dir, "lr.bam")
            _write_bam(pool, paths["lr_bam"], refs, recs)
            del recs
        with open(paths["reads"], "wb") as fh:
            fh.write(fq_gz.get())
        pool.close()
        pool.join()
    paths.setdefault("lr_bam", None)
    return paths


def simulate_cell(out_dir: str, seed: int, cfg: dict, mix: dict) -> dict:
    """``simulate`` with a configuration's genome and a mix's reads; any
    whole number seeds it (taken modulo 2^64)."""
    reads = dict(mix["reads"])
    if reads.get("dropout") is not None:
        reads["dropout"] = tuple(reads["dropout"])
    return simulate(out_dir, seed % (1 << 64), **cfg["genome"], **reads)
