"""Synthetic polishing dataset generator (test/bench support tool).

Generates: a truth genome, an error-laden draft assembly of it, short
(and optionally long) reads sampled from the truth, and coordinate-sorted
BAMs of those reads aligned to the draft — everything the polisher
consumes.  Replaces the reference's reliance on external real datasets
for its smoke tests (it ships none).

Run as a module:  python -m hypo_tpu_torch.sim --out DIR --genome-size 20000

Copied from hypo_tpu/sim.py.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import os
from typing import List, Optional, Tuple

import numpy as np

from .dna import decode, revcomp
from .io.bam import FREVERSE, BamRecord
from .io.bam import write_bam as _write_bam
from .io.fasta import write_fasta


@dataclasses.dataclass
class SimConfig:
    genome_size: int = 20_000
    num_contigs: int = 1
    draft_error_rate: float = 0.01   # SNP+indel rate genome -> draft
    short_cov: int = 30
    short_len: int = 150
    short_err: float = 0.002
    long_cov: int = 0                # 0 = no long reads
    long_len: int = 1200
    long_err: float = 0.08
    # short reads are not sampled inside [dropout_start, dropout_end) of
    # each contig -> forces arm-less windows -> the long-read path
    dropout: Optional[Tuple[float, float]] = None  # fractions of length
    seed: int = 0


def _mutate(rng, codes: np.ndarray, rate: float) -> np.ndarray:
    """Apply SNPs/insertions/deletions at ~rate per base (vectorized)."""
    snp, ins, dele, out = _mutation_events(rng, codes, rate)
    seq, _t2d, _ins_dpos = _apply_events(codes, snp, ins, dele, out)
    return seq


# -- event-based mutation + edit-script composition --------------------------
#
# The simulator never runs an aligner: both truth->draft and truth->read
# are generated as explicit event lists (SNP / 1-base insertion / 1-base
# deletion at a truth coordinate), and the read-vs-draft CIGAR + exact NM
# come from composing the two scripts through truth coordinates.  This
# is what makes >=1 Mbp bench datasets and >=100 Mbp RSS runs feasible
# (the previous per-read semiglobal DP needed ~10 min per Mbp).

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
    window [s, e) into (read_codes, pos, cigar ops/lens, exact NM).

    d_ev_t/d_kind: truth coords + kinds (0 snp, 1 ins, 2 del) of draft
    events inside the window; q_ev_t/q_kind/q_base likewise for the read
    (q_base = replacement or inserted base).  dbase[t] is the draft's
    base at truth coord t (SNP-applied; meaningless where deleted)."""
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


def simulate(cfg: SimConfig, out_dir: str) -> dict:
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)
    truths: List[Tuple[str, str]] = []
    drafts: List[Tuple[str, str]] = []
    genomes: List[np.ndarray] = []
    dmaps: List[tuple] = []   # (dbase, t2d, ins_dpos, ev_t, ev_kind)
    per_contig = cfg.genome_size // cfg.num_contigs
    for c in range(cfg.num_contigs):
        g = rng.integers(0, 4, size=per_contig).astype(np.uint8)
        snp, ins, dele, dbase = _mutation_events(rng, g,
                                                 cfg.draft_error_rate)
        d, t2d, ins_dpos = _apply_events(g, snp, ins, dele, dbase, rng)
        ev_t = np.flatnonzero(snp | ins | dele)
        ev_kind = np.where(snp[ev_t], 0, np.where(ins[ev_t], 1, 2))
        genomes.append(g)
        dmaps.append((dbase, t2d, ins_dpos, ev_t, ev_kind))
        truths.append((f"ctg{c}", decode(g)))
        drafts.append((f"ctg{c}", decode(d)))
    write_fasta(os.path.join(out_dir, "truth.fa"), truths)
    write_fasta(os.path.join(out_dir, "draft.fa"), drafts)
    refs = [(n, len(s)) for n, s in drafts]

    def make_reads(cov: int, rlen: int, err: float, prefix: str,
                   dropout=None
                   ) -> Tuple[List[BamRecord], List[Tuple[str, str]]]:
        recs: List[BamRecord] = []
        fastas: List[Tuple[str, str]] = []
        for c, g in enumerate(genomes):
            dbase, t2d, ins_dpos, ev_t, ev_kind = dmaps[c]
            n_reads = (len(g) * cov) // rlen
            starts = rng.integers(0, max(1, len(g) - rlen),
                                  size=n_reads)
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
            # per-read error events, drawn in one global batch
            counts = rng.binomial(rlen, err, size=n_reads)
            qoff = np.concatenate(
                [[0], np.cumsum(counts)]).astype(np.int64)
            total_q = int(qoff[-1])
            q_rel = rng.integers(0, rlen, size=total_q)
            q_kind = rng.integers(0, 3, size=total_q)
            q_t = np.repeat(starts, counts) + q_rel
            q_base = np.where(
                q_kind == 0,
                (g[q_t].astype(np.int64)
                 + rng.integers(1, 4, size=total_q)) % 4,
                rng.integers(0, 4, size=total_q)).astype(np.uint8)
            d_lo = np.searchsorted(ev_t, starts)
            d_hi = np.searchsorted(ev_t, starts + rlen)
            for i in range(n_reads):
                s = int(starts[i])
                read, pos, ops, lens, nm = _compose_read(
                    s, s + rlen, g, dbase, t2d, ins_dpos,
                    ev_t[d_lo[i]:d_hi[i]], ev_kind[d_lo[i]:d_hi[i]],
                    q_t[qoff[i]:qoff[i + 1]],
                    q_kind[qoff[i]:qoff[i + 1]],
                    q_base[qoff[i]:qoff[i + 1]])
                if len(read) == 0 or len(ops) == 0:
                    continue
                name = f"{prefix}{c}_{i}"
                rev = bool(revs[i])
                fastas.append((name,
                               decode(revcomp(read) if rev else read)))
                # BAM stores the draft-forward orientation
                flag = FREVERSE if rev else 0
                recs.append(BamRecord(name, flag, c, pos, 60, ops, lens,
                                      read, nm))
        recs.sort(key=lambda r: (r.tid, r.pos))
        return recs, fastas

    def make_reads_native(cov: int, rlen: int, err: float, prefix: str,
                          bam_path: str, fq_path, dropout=None) -> None:
        """Native-composed twin of make_reads writing BAM (+ optionally
        FASTQ) directly: per-read composition + record serialization in
        C (hypo_sim_reads, OpenMP), chunked so a 1 Gbp / 30x dataset
        (300M reads) streams in bounded memory; chunks are merged into
        exact global (tid, pos) order (stable), byte-identical to the
        python path."""
        import heapq
        import tempfile

        from .io.bam import BgzfWriter, bam_header_bytes
        from .native import host_api
        # level 1: sims are write-once scratch data; at 1 Gbp the
        # compressor, not the composer, would otherwise dominate
        bw = BgzfWriter(bam_path, level=1)
        bw.write(bam_header_bytes(refs))
        fq = gzip.open(fq_path, "wb", compresslevel=1) if fq_path \
            else None
        CHUNK = int(os.environ.get("HYPO_SIM_CHUNK", 2_000_000))
        # beyond this many reads per contig the exact generation-order
        # record merge (a per-record python heap) is replaced by
        # sorting the sampled starts: each chunk is then exactly
        # pos-sorted internally and chunk boundaries overlap by at most
        # ~rlen bp of leading-deletion trim — fine for the polisher,
        # which only needs contig-grouped records
        EXACT_LIMIT = 8_000_000
        for c, g in enumerate(genomes):
            dbase, t2d, ins_dpos, ev_t, ev_kind = dmaps[c]
            n_reads = (len(g) * cov) // rlen
            starts = rng.integers(0, max(1, len(g) - rlen),
                                  size=n_reads)
            if dropout is not None:
                ds = int(dropout[0] * len(g))
                de = int(dropout[1] * len(g))
                for _ in range(50):
                    bad = (starts + rlen > ds) & (starts < de)
                    if not bad.any():
                        break
                    starts[bad] = rng.integers(
                        0, max(1, len(g) - rlen), size=int(bad.sum()))
            exact = n_reads <= EXACT_LIMIT
            if not exact:
                starts = np.sort(starts)
            revs = rng.integers(0, 2, size=n_reads).astype(np.uint8)
            counts = rng.binomial(rlen, err, size=n_reads)
            qoff = np.concatenate(
                [[0], np.cumsum(counts)]).astype(np.int64)
            total_q = int(qoff[-1])
            q_rel = rng.integers(0, rlen, size=total_q)
            q_kind = rng.integers(0, 3, size=total_q)
            q_t = np.repeat(starts, counts) + q_rel
            q_base = np.where(
                q_kind == 0,
                (g[q_t].astype(np.int64)
                 + rng.integers(1, 4, size=total_q)) % 4,
                rng.integers(0, 4, size=total_q)).astype(np.uint8)
            # the native merge walks events in coordinate order; sort
            # each read's error events by t (stable: the python dict's
            # last-entry-wins semantics survive)
            read_idx = np.repeat(np.arange(n_reads), counts)
            o = np.lexsort((np.arange(total_q), q_t, read_idx))
            q_t = q_t[o]
            q_kind = q_kind[o].astype(np.uint8)
            q_base = q_base[o]
            d_lo = np.searchsorted(ev_t, starts)
            d_hi = np.searchsorted(ev_t, starts + rlen)
            if not exact:
                # pos-sorted chunk stream: compose, append, free
                for lo in range(0, n_reads, CHUNK):
                    hi = min(lo + CHUNK, n_reads)
                    blob, fq_txt, _pos, _off = host_api.sim_reads(
                        g, dbase, t2d, ins_dpos, ev_t, ev_kind,
                        d_lo[lo:hi], d_hi[lo:hi], starts[lo:hi],
                        revs[lo:hi], rlen, c, prefix, lo,
                        qoff[lo:hi + 1] - qoff[lo],
                        q_t[qoff[lo]:qoff[hi]],
                        q_kind[qoff[lo]:qoff[hi]],
                        q_base[qoff[lo]:qoff[hi]])
                    if fq is not None:
                        fq.write(fq_txt)
                    bw.write(blob)
                continue
            chunks = []      # (tmpfile | bytes, pos int64[], off [])
            n_chunks = (n_reads + CHUNK - 1) // CHUNK
            for lo in range(0, n_reads, CHUNK):
                hi = min(lo + CHUNK, n_reads)
                blob, fq_txt, pos, off = host_api.sim_reads(
                    g, dbase, t2d, ins_dpos, ev_t, ev_kind,
                    d_lo[lo:hi], d_hi[lo:hi], starts[lo:hi],
                    revs[lo:hi], rlen, c, prefix, lo,
                    qoff[lo:hi + 1] - qoff[lo],
                    q_t[qoff[lo]:qoff[hi]], q_kind[qoff[lo]:qoff[hi]],
                    q_base[qoff[lo]:qoff[hi]])
                if fq is not None:
                    fq.write(fq_txt)
                if n_chunks == 1:
                    chunks.append((blob, pos, off))
                else:
                    tf = tempfile.TemporaryFile(dir=out_dir)
                    tf.write(blob)
                    tf.seek(0)
                    chunks.append((tf, pos, off))
            # exact global stable merge by pos (ties: chunk order =
            # generation order, matching python's stable sort)
            heap = []
            for ci_, (src, pos, off) in enumerate(chunks):
                if len(pos):
                    heapq.heappush(heap, (int(pos[0]), ci_, 0))
            while heap:
                _p, ci_, ri = heapq.heappop(heap)
                src, pos, off = chunks[ci_]
                o0, o1 = int(off[ri]), int(off[ri + 1])
                bw.write(src[o0:o1] if isinstance(src, bytes)
                         else src.read(o1 - o0))
                if ri + 1 < len(pos):
                    heapq.heappush(heap, (int(pos[ri + 1]), ci_, ri + 1))
            for src, _pos, _off in chunks:
                if not isinstance(src, bytes):
                    src.close()
        bw.close()
        if fq is not None:
            fq.close()

    from .native import host_api as _host_api
    use_native_sim = (_host_api.available()
                      and not os.environ.get("HYPO_SIM_PYTHON"))
    if use_native_sim:
        make_reads_native(cfg.short_cov, cfg.short_len, cfg.short_err,
                          "sr", os.path.join(out_dir, "sr.bam"),
                          os.path.join(out_dir, "reads.fq.gz"),
                          cfg.dropout)
    else:
        sr_recs, sr_fastas = make_reads(cfg.short_cov, cfg.short_len,
                                        cfg.short_err, "sr", cfg.dropout)
        with gzip.open(os.path.join(out_dir, "reads.fq.gz"), "wt") as fh:
            for name, seq in sr_fastas:
                fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
        _write_bam(os.path.join(out_dir, "sr.bam"), refs, sr_recs)

    out = {
        "truth": os.path.join(out_dir, "truth.fa"),
        "draft": os.path.join(out_dir, "draft.fa"),
        "reads": os.path.join(out_dir, "reads.fq.gz"),
        "sr_bam": os.path.join(out_dir, "sr.bam"),
        "lr_bam": None,
        "genome_size": cfg.genome_size,
        "short_cov": cfg.short_cov,
    }
    if cfg.long_cov > 0:
        if use_native_sim:
            make_reads_native(cfg.long_cov, cfg.long_len, cfg.long_err,
                              "lr", os.path.join(out_dir, "lr.bam"),
                              None)
        else:
            lr_recs, _ = make_reads(cfg.long_cov, cfg.long_len,
                                    cfg.long_err, "lr")
            _write_bam(os.path.join(out_dir, "lr.bam"), refs, lr_recs)
        out["lr_bam"] = os.path.join(out_dir, "lr.bam")
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--genome-size", type=int, default=20_000)
    ap.add_argument("--num-contigs", type=int, default=1)
    ap.add_argument("--short-cov", type=int, default=30)
    ap.add_argument("--long-cov", type=int, default=0)
    ap.add_argument("--draft-error", type=float, default=0.01)
    ap.add_argument("--dropout", default=None,
                    help="start,end fractions of each contig with no "
                         "short-read sampling (forces the long-read "
                         "path), e.g. 0.3,0.45")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dropout = None
    if args.dropout:
        a, b = args.dropout.split(",")
        dropout = (float(a), float(b))
    cfg = SimConfig(genome_size=args.genome_size,
                    num_contigs=args.num_contigs,
                    short_cov=args.short_cov, long_cov=args.long_cov,
                    draft_error_rate=args.draft_error, dropout=dropout,
                    seed=args.seed)
    paths = simulate(cfg, args.out)
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
