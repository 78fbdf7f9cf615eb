"""Host-native window consensus over the flat tile-jobs stream.

The host twin of poa.full_runner.FullDeviceRunner: the SAME native job
builder (hypo_tile_jobs — dispatch rules, weighted arm dedup, trivial
settlement, all in C from the flat arm table) feeds the native POA
engine (hypo_jobs_consensus, OpenMP over jobs) instead of device tiles.
No per-window Python objects or arm materialization on the hot path;
Python only assigns the finished consensus strings.

This is the production HOST engine for short windows; it replaces the
per-window materialize-then-batch path (engine.generate_consensus_batch)
which remains for LONG windows and pre-fallbacks.  Reference analog: the
OMP per-window POA loop over spoa, src/Hypo.cpp:237-247.

``finish_leftovers`` is both runners' host-engine route: short windows
that have a job (FullDeviceRunner's classless and overflowed ones) go
to the native jobs engine, pre-fallbacks and LONG windows to the
classic engine.  The route needs both native libraries;
``missing_native_libs`` names those that did not load.

Copied from hypo_tpu/poa/host_runner.py, with spans (``utils.trace``):
``runner.jobs_native`` around each native job build, and in
``HostTileRunner`` ``runner.jobs``, ``runner.jobs_consensus`` and
``runner.leftovers`` (``runner.materialize``, ``runner.engine``,
``runner.fallback_jobs``), whose seconds the ``HYPO_POA_DEBUG`` lines
print.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..config import ScoreParams
from ..native import api as poa_api
from ..native import host_api
from ..utils import trace
from .engine import ConsensusEngine


def missing_native_libs() -> List[str]:
    """The native libraries the flat-table route (the job builder, then
    device tiles or the native jobs engine) needs that did not load:
    ``libhypo_host`` (native.host_api) and ``libhypo_poa``
    (native.api).  The route is available when none is missing."""
    return [name for name, lib in (("libhypo_host", host_api),
                                   ("libhypo_poa", poa_api))
            if not lib.available()]


def merge_tile_jobs(parts):
    """Concatenate per-contig TileJobs into one flat job store,
    shifting the ext offsets."""
    if len(parts) == 1:
        return parts[0]
    out = host_api.TileJobs.__new__(host_api.TileJobs)
    out.n_jobs = sum(p.n_jobs for p in parts)
    out.job_next = np.concatenate([p.job_next for p in parts])
    out.job_maxlen = np.concatenate([p.job_maxlen for p in parts])
    eo = [parts[0].job_ext_off]
    base = parts[0].job_ext_off[-1]
    for p in parts[1:]:
        eo.append(p.job_ext_off[1:] + base)
        base += p.job_ext_off[-1]
    out.job_ext_off = np.concatenate(eo)
    out.ext_len = np.concatenate([p.ext_len for p in parts])
    out.ext_mode = np.concatenate([p.ext_mode for p in parts])
    out.ext_w = np.concatenate([p.ext_w for p in parts])
    xo = [parts[0].ext_off]
    base = parts[0].ext_off[-1]
    for p in parts[1:]:
        xo.append(p.ext_off[1:] + base)
        base += p.ext_off[-1]
    out.ext_off = np.concatenate(xo)
    out.ext_buf = np.concatenate([p.ext_buf for p in parts])
    return out


def _gather_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Indices of the ranges [starts[i], starts[i] + lens[i]), in
    order, concatenated."""
    ends = np.cumsum(lens)
    return (np.arange(int(ends[-1]) if len(ends) else 0, dtype=np.int64)
            + np.repeat(starts - (ends - lens), lens))


def take_jobs(jobs, idx):
    """The jobs ``idx`` of a merged TileJobs (indices, in that order) as
    a TileJobs of their own: each job's ext entries and their codes
    gathered as they are, nothing rebuilt."""
    idx = np.asarray(idx, np.int64)
    out = host_api.TileJobs.__new__(host_api.TileJobs)
    out.n_jobs = len(idx)
    out.job_next = jobs.job_next[idx]
    out.job_maxlen = jobs.job_maxlen[idx]
    jeo = jobs.job_ext_off
    ne = jeo[idx + 1] - jeo[idx]
    out.job_ext_off = np.concatenate(([0], np.cumsum(ne))).astype(np.int64)
    e = _gather_ranges(jeo[idx], ne)
    out.ext_len = jobs.ext_len[e]
    out.ext_mode = jobs.ext_mode[e]
    out.ext_w = jobs.ext_w[e]
    xo = jobs.ext_off
    nb = xo[e + 1] - xo[e]
    out.ext_off = np.concatenate(([0], np.cumsum(nb))).astype(np.int64)
    out.ext_buf = jobs.ext_buf[_gather_ranges(xo[e], nb)]
    return out


def materialize_arms_bulk(ctg, wis: List[int]) -> None:
    """Rebuild the Python arm lists of the given windows from the flat
    table (the tile fast path keeps arms unmaterialized) so the classic
    engine can polish them.  ONE pass over the table for all windows;
    respects clear_pre_suf (num_pre/num_suf == 0)."""
    table, abuf, aoff = ctg._device_arm_data
    aln_idx, windex, qb, qe, at = table
    windex = np.asarray(windex)
    want = [wi for wi in wis
            if not (ctg.windows[wi].internal_arms
                    or ctg.windows[wi].pre_arms
                    or ctg.windows[wi].suf_arms)]
    if not want:
        return
    from ..dna import unpack2
    for wi in want:
        w = ctg.windows[wi]
        w.internal_arms, w.pre_arms, w.suf_arms = [], [], []
    rows = np.nonzero(np.isin(windex, np.array(want)))[0]
    for r in rows:
        t = at[r]
        if t == 3:
            continue
        w = ctg.windows[int(windex[r])]
        keep_presuf = w.num_pre > 0 or w.num_suf > 0
        codes = unpack2(abuf, int(aoff[aln_idx[r]]) + int(qb[r]),
                        int(qe[r]) - int(qb[r]))
        if t == 0:
            w.internal_arms.append(codes)
        elif t == 1 and keep_presuf:
            w.pre_arms.append(codes)
        elif t == 2 and keep_presuf:
            w.suf_arms.append(codes)


def build_batch_jobs(contigs, stats=None):
    """Run the native job builder over a contig batch.  Returns
    (merged TileJobs or None, job_refs [(ctg, windex)], fallback
    [(ctg, windex)], host_windows [LONG Window], count).  Direct
    consensus (trivial + dispatch-rule windows) is assigned inline."""
    count = 0
    host_windows = []
    fallback = []
    merged = []
    job_refs: List = []
    for ctg in contigs:
        table, abuf, aoff = ctg._device_arm_data
        windows = ctg.windows
        n_reg = len(ctg.reg_starts) - 1
        wflag = np.zeros(n_reg, np.uint8)
        presuf = np.zeros(n_reg, np.uint8)
        for i in range(n_reg):
            w = windows[i]
            if w is None:
                continue
            count += 1
            if w.wtype != 0:
                host_windows.append(w)
                continue
            wflag[i] = 1
            presuf[i] = 1 if (w.num_pre > 0 or w.num_suf > 0) else 0
        with trace.span("runner.jobs_native"):
            jobs = host_api.tile_jobs(ctg.codes, ctg.reg_starts, wflag,
                                      presuf, table, abuf, aoff)
        consbuf = jobs.cons_buf.tobytes().decode("latin1")
        direct = np.nonzero(jobs.flag == 1)[0]
        off = jobs.cons_off
        for i in direct:
            windows[i].consensus = consbuf[off[i]:off[i + 1]]
        if stats is not None:
            stats["trivial_windows"] = (stats.get("trivial_windows", 0)
                                        + len(direct))
        for i in np.nonzero(jobs.flag == 3)[0]:
            fallback.append((ctg, int(i)))
        for j in range(jobs.n_jobs):
            job_refs.append((ctg, int(jobs.job_windex[j])))
        merged.append(jobs)
    nj = sum(j.n_jobs for j in merged)
    return (merge_tile_jobs(merged) if nj else None, job_refs, fallback,
            host_windows, count)


def jobs_consensus(sp: ScoreParams, jobs, refs, threads: int) -> None:
    """Each job's consensus from one native_jobs_consensus call over
    ``jobs``, assigned to its window ``refs[j]`` (contig, windex)."""
    from ..native.api import native_jobs_consensus
    buf, off = native_jobs_consensus(
        jobs, (sp.sr_match, sp.sr_mismatch, sp.sr_gap), threads)
    for j, (ctg, wi) in enumerate(refs):
        ctg.windows[wi].consensus = buf[off[j]:off[j + 1]].decode("latin1")


def finish_leftovers(engine: ConsensusEngine, threads: int, fallback,
                     host_windows, jobs=None, job_refs=(), left=()) -> None:
    """Consensus for the windows a runner leaves to the host, assigned in
    place.  The jobs ``left`` (indices) of ``jobs``, short windows in
    job form whose (contig, windex) are ``job_refs[j]``, go to one
    native_jobs_consensus call (span ``runner.fallback_jobs``); then the
    pre-fallbacks ``fallback`` [(contig, windex)], which have no job,
    with their arms rebuilt (``runner.materialize``), and the LONG
    windows ``host_windows`` to one classic-engine call
    (``runner.engine``)."""
    if left:
        with trace.span("runner.fallback_jobs"):
            trace.count("runner.fallback_jobs", len(left))
            jobs_consensus(engine.sp, take_jobs(jobs, left),
                           [job_refs[j] for j in left], threads)
    classic = list(host_windows)
    with trace.span("runner.materialize"):
        by_ctg: Dict[int, List[int]] = {}
        ctg_of = {}
        for ctg, wi in fallback:
            by_ctg.setdefault(id(ctg), []).append(wi)
            ctg_of[id(ctg)] = ctg
        for key, wis in by_ctg.items():
            ctg = ctg_of[key]
            materialize_arms_bulk(ctg, wis)
            classic.extend(ctg.windows[wi] for wi in wis)
    trace.count("runner.fallback_materialized", len(fallback))
    if classic:
        with trace.span("runner.engine"):
            engine.generate_consensus_batch(classic, threads)


class HostTileRunner:
    """run_polish_batch-compatible host engine over native tile jobs."""

    def __init__(self, sp: ScoreParams, fix_long_align_type: bool = False,
                 threads: int = 0):
        self.sp = sp
        self.threads = threads
        self.host_engine = ConsensusEngine(sp, fix_long_align_type)
        self.stats = {"trivial_windows": 0, "native_jobs": 0,
                      "host_long_windows": 0, "fallbacks": 0}

    def run_polish_batch(self, contigs) -> int:
        debug = bool(os.environ.get("HYPO_POA_DEBUG"))
        with trace.span("runner.jobs", timed=debug) as span:
            jobs, job_refs, fallback, host_windows, count = \
                build_batch_jobs(contigs, self.stats)
        if debug:
            nj = jobs.n_jobs if jobs is not None else 0
            print(f"[poa] native jobs: {span.seconds:.2f}s "
                  f"({nj} jobs, {len(host_windows)} host long, "
                  f"{len(fallback)} pre-fallbacks)", flush=True)
        with trace.span("runner.jobs_consensus", timed=debug) as span:
            if jobs is not None:
                jobs_consensus(self.sp, jobs, job_refs, self.threads)
                self.stats["native_jobs"] += jobs.n_jobs
        if debug:
            print(f"[poa] jobs consensus: {span.seconds:.2f}s",
                  flush=True)
        self.stats["fallbacks"] += len(fallback)
        self.stats["host_long_windows"] += len(host_windows) + len(fallback)
        with trace.span("runner.leftovers", timed=debug) as span:
            finish_leftovers(self.host_engine, self.threads, fallback,
                             host_windows)
        if debug and (fallback or host_windows):
            print(f"[poa] host leftovers: {span.seconds:.2f}s "
                  f"({len(fallback)} fallbacks) stats={self.stats}",
                  flush=True)
        return count
