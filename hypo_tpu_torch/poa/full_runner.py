"""Window consensus through the tile program on a PyTorch device: the
port of hypo_tpu.poa.full_runner.FullDeviceRunner (``--device-poa``,
mode ``full``), with both of its paths.

``run_polish_batch`` (the native tile path): the native job builder
(native.host_api.tile_jobs, via host_runner.build_batch_jobs) settles
trivial windows and deduplicates arms, host_api.tile_pack packs B
windows into a tile, host_api.tile_finalize unpacks the tile's output.

``run_windows`` (the path without the native host library, which the
orchestrator takes when host_api.available() is false): the Python job
model of poa.batch, with arms deduplicated (``_dedup``) and packed into
tiles here; the tile program computes every tile on the device as
before.  Long windows that reach it run their curated second round as a
new job.

Each tile is one call of the tile program (poa.device_full.
build_tile_program; one a class and scores, kept by the runner, whose
CUDA graphs are captured at its first tile) over this runner's devices:
on a CUDA device a tile is a few input copies and graph replays.  With
ndev devices the tile's B rows split into ndev blocks of B // ndev, one
a device, and the runner stripes a tile's windows across the blocks
(window t of a tile in row (t % ndev) * (B // ndev) + t // ndev, as the
JAX package does), so each block gets a like mix of arm counts.
``stats["rows_per_device"]`` counts the windows each block got, on both
paths (a list of ints; the JAX package counts them in run_polish_batch
only, with ndev > 1).
``HYPO_POA_NDEV`` caps ndev at its value, which must not exceed the
devices the runner is given.  LONG windows (wtype != 0),
windows that fit no shape class and windows that overflow a class cap
on the device go to the host, as in the JAX package: that routing is
part of the algorithm.  In ``run_polish_batch`` the classless and
overflowed windows keep their jobs, which the native jobs engine
finishes (host_runner.finish_leftovers; the same consensus as the
classic engine's), and LONG windows and the job builder's pre-fallbacks
go to the classic engine (engine.ConsensusEngine).  ``stats`` counts
them: ``run_polish_batch`` puts LONG windows under host_long_windows and
the rest under host_fallbacks (the JAX package adds both to
host_long_windows); ``run_windows`` counts as the JAX package does,
LONG windows under host_long_windows and each job finished on the host
aligner under host_fallbacks.

Both paths dispatch every tile of a call (of a wave, in run_windows)
before they read the first one back, as the JAX package does: the tile
program queues its work without a host sync (pinned uploads, the arm
loop's bound from the host's narms), then the runner drains the devices
(``_drain``) and reads the tiles back in order (``_readback``).  Both
open spans (``utils.trace``: ``runner.*`` and ``tiles.*``; the warm-up
thread's under the span that called ``warm``).  With
``HYPO_POA_DEBUG`` set, both print the JAX runner's stage lines
(``[poa] ...``) to stdout, with the seconds of those spans.
``warm()`` builds kernels 1-3 and runs the tile program (which builds
kernels 4 and 5 at their first launch) once on a zero tile in a
background thread, as the JAX package does, so that both (and the
capture of the program's graphs) overlap the host stages; the first
dispatch waits for the thread and raises the error it met, if any.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ScoreParams
from ..native import host_api
from ..utils import trace
from . import GLOBAL_ALPHABET, GLOBAL_CODE, NW
from .batch import DeviceConsensusRunner, _Job
from .cuda_poa import check_scores
from .device_full import TileProgram, as_devices, build_tile_program
from .engine import CURATE_THRESH, ConsensusEngine
# materialize_arms_bulk stays importable here: polishbench's traced run
# wraps it by this module's name
from .host_runner import (build_batch_jobs, finish_leftovers,  # noqa: F401
                          materialize_arms_bulk)

# shape classes: (L arm-length cap, N node/column cap, K distinct-arm
# cap, B batch tile, A arm-pool cap) — hypo_tpu full_runner.CLASSES
CLASSES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (126, 256, 16, 2048, 4096),
    (510, 1024, 16, 256, 512),
)
P_FULL = 8
# CPU tensors (tests only): padded windows are real compute, so the
# tile shrinks as in the JAX package off-TPU (full_runner.py:167-174),
# where B = max(8 * ndev, 64): 64 up to the 8 devices allowed here
_CPU_TILE_B = 64
_CPU_MAX_NDEV = 8


def runner_devices(device) -> List:
    """The devices of a FullDeviceRunner given ``device`` (a device or a
    list): the first HYPO_POA_NDEV of them when that is set.  Raises if
    HYPO_POA_NDEV exceeds them, or for more than 8 CPU devices."""
    devs = as_devices(device)
    env = os.environ.get("HYPO_POA_NDEV")
    if env:
        n = int(env)
        if not 1 <= n <= len(devs):
            raise ValueError(f"HYPO_POA_NDEV={n}, but the runner has "
                             f"{len(devs)} device(s): {devs}")
        devs = devs[:n]
    if devs[0].type == "cpu" and len(devs) > _CPU_MAX_NDEV:
        raise ValueError(f"FullDeviceRunner: at most {_CPU_MAX_NDEV} CPU "
                         f"devices (the CPU tile has {_CPU_TILE_B} rows)")
    return devs


def _dedup(seqs) -> List[Tuple[str, int, int]]:
    """Collapse identical (sequence, mode) arms into one weighted entry
    at the first occurrence; merging one arm with weight w is exactly
    merging w copies."""
    out: Dict[Tuple[str, int], int] = {}
    for s, md in seqs:
        out[(s, md)] = out.get((s, md), 0) + 1
    return [(s, md, w) for (s, md), w in out.items()]


# ASCII byte -> global code for packing tiles; a letter outside the
# alphabet (an N from the reads or the draft) packs as 0, as in the JAX
# package
_CODE_LUT = np.zeros(256, np.int8)
for _c, _v in GLOBAL_CODE.items():
    _CODE_LUT[ord(_c)] = _v

_ALPHA_LUT = np.frombuffer(GLOBAL_ALPHABET.encode(), np.uint8).copy()


def _decode(codes: np.ndarray) -> str:
    return _ALPHA_LUT[codes].tobytes().decode()


def _debug() -> bool:
    return bool(os.environ.get("HYPO_POA_DEBUG"))


def _log(msg: str) -> None:
    print(f"[poa] {msg}", flush=True)


class FullDeviceRunner(DeviceConsensusRunner):
    """Device engine over tiles, computing on ``device`` (a CUDA device
    or a list of them, see runner_devices; CPU tensors in tests): the
    same job model as DeviceConsensusRunner, with each window's whole
    POA and consensus on the devices."""

    KERNELS = ("poa_dp", "poa_tb", "consensus")

    def __init__(self, sp: ScoreParams, device, threads: int = 0,
                 fix_long_align_type: bool = False, use_native: bool = None):
        devices = runner_devices(device)
        super().__init__(sp, devices[0], fix_long_align_type, use_native)
        self.devices = devices
        self.ndev = len(devices)
        self._warm_thread: Optional[threading.Thread] = None
        self._warm_error: Optional[Exception] = None
        # (class, scores) -> its tile program, whose CUDA graphs and
        # buffers live as long as this runner
        self._programs: Dict[tuple, TileProgram] = {}
        for ci in range(len(CLASSES)):      # raises unless B splits
            self._program(ci, self.short_scores)
        self.threads = threads
        self.host_engine = ConsensusEngine(sp, fix_long_align_type,
                                           use_native)
        self.stats.update({"full_dispatches": 0, "full_windows": 0,
                           "full_overflows": 0, "trivial_windows": 0,
                           "host_long_windows": 0,
                           # per shape class (index into CLASSES)
                           "class_tiles": [0] * len(CLASSES),
                           "class_windows": [0] * len(CLASSES),
                           "rows_per_device": [0] * self.ndev})

    # -- warm-up, dispatch, drain, readback --------------------------------
    def warm(self, classes=(0,)) -> threading.Thread:
        """In a background thread, build (or load) the kernels on a CUDA
        device, then run the tile program of each class in ``classes``
        once on a zero tile (hypo_tpu full_runner.warm, where the first
        call compiles the program): every window empty but the first,
        which has one empty arm slot, so that the arm loop runs one step
        and all five kernels launch (the rank and merge kernels, not in
        KERNELS, are built at that first launch).  On a CUDA device that
        first tile
        captures the program's graphs, so they are made here, behind the
        host stages.  The first dispatch joins the thread and raises the
        error it met, if any; unlike the JAX package's, a failed warm-up
        is never swallowed.  The thread's spans hang under the span open
        here.  Returns the thread."""
        parent = trace.current()

        def run():
            try:
                with trace.under(parent):
                    self._warm_classes(classes)
            except Exception as e:  # raised by the first dispatch
                self._warm_error = e

        self._join_warm()
        self._warm_thread = threading.Thread(target=run, daemon=True,
                                             name="hypo-tile-warm")
        self._warm_thread.start()
        return self._warm_thread

    def _warm_classes(self, classes) -> None:
        super().warm()
        for ci in classes:
            L, N, K, B, A = self._class_shape(ci)
            idx = np.full((B, K), -1, np.int32)
            narms = np.zeros(B, np.int32)
            narms[0] = 1
            self._program(ci, self.short_scores)(
                np.zeros((A, L), np.int8), np.zeros(A, np.int32), idx,
                np.zeros((B, K), np.int8), np.zeros((B, K), np.int32),
                narms, np.zeros(B, np.int32))
        self._drain()


    def _join_warm(self) -> None:
        """Wait for the warm-up thread, if one is running, and raise the
        error it met."""
        t, self._warm_thread = self._warm_thread, None
        if t is not None:
            with trace.span("tiles.warm_wait"):
                t.join()
        err, self._warm_error = self._warm_error, None
        if err is not None:
            raise RuntimeError("FullDeviceRunner: the warm-up failed") \
                from err

    def _dispatch(self, ci: int, scores, arrays):
        """Queue one tile on the devices (after the warm-up); returns
        (its output, still on the device, the pinned upload buffers that
        must live until it is read)."""
        self._join_warm()
        keep: List[torch.Tensor] = []
        return self._program(ci, scores)(*arrays, keep=keep), keep

    def _drain(self) -> None:
        """Wait for the work queued on the runner's CUDA devices."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _readback(self, handle) -> np.ndarray:
        """A dispatched tile's packed output on the host."""
        return handle[0].cpu().numpy()

    @classmethod
    def check_scores(cls, sp: ScoreParams, long_reads: bool) -> None:
        """As DeviceConsensusRunner.check_scores, at the shape classes:
        full mode launches the short-read scores only (LONG windows go
        to the host engine)."""
        for L, N, _K, _B, _A in CLASSES:
            check_scores(sp.sr_match, sp.sr_mismatch, sp.sr_gap, N, L)

    @staticmethod
    def supports_native_tiles() -> bool:
        return host_api.available()

    def _class_shape(self, ci: int):
        L, N, K, B, A = CLASSES[ci]
        if self.device.type == "cpu":
            B = _CPU_TILE_B
            A = 2 * B * K
        return L, N, K, B, A

    def _program(self, ci: int, scores) -> TileProgram:
        """The tile program of class ``ci`` at ``scores``, built at its
        first use (its graphs are captured at its first tile)."""
        key = (ci, tuple(scores))
        prog = self._programs.get(key)
        if prog is None:
            L, N, K, B, A = self._class_shape(ci)
            m, n, g = scores
            prog = self._programs[key] = build_tile_program(
                N=N, L=L, K=K, P=P_FULL, m=m, n=n, g=g, B=B, A=A,
                devices=self.devices)
        return prog

    def _count_tile(self, ci: int, rows: np.ndarray) -> None:
        """Count a tile of len(rows) windows in tile rows ``rows``."""
        self.stats["full_dispatches"] += 1
        self.stats["full_windows"] += len(rows)
        self.stats["class_tiles"][ci] += 1
        self.stats["class_windows"][ci] += len(rows)
        blk = self._class_shape(ci)[3] // self.ndev
        per = np.bincount(np.asarray(rows) // blk, minlength=self.ndev)
        for d in range(self.ndev):
            self.stats["rows_per_device"][d] += int(per[d])

    def _row_order(self, n: int, B: int) -> np.ndarray:
        """Tile row of each of n windows: striped across the device
        blocks (hypo_tpu full_runner._row_order)."""
        nd = self.ndev
        if nd <= 1:
            return np.arange(n, dtype=np.int64)
        blk = B // nd
        i = np.arange(n, dtype=np.int64)
        return (i % nd) * blk + (i // nd)

    def run_polish_batch(self, contigs) -> int:
        debug = _debug()
        with trace.span("runner.jobs", timed=debug) as sp:
            jobs, job_refs, fallback, host_windows, count = \
                build_batch_jobs(contigs, self.stats)
        self.stats["host_long_windows"] += len(host_windows)
        if debug:
            nj = jobs.n_jobs if jobs is not None else 0
            _log(f"native jobs: {sp.seconds:.2f}s ({nj} jobs, "
                 f"{len(host_windows)} host long, {len(fallback)} "
                 f"pre-fallbacks)")
        left = self._run_tiles(jobs, job_refs, debug)
        # host leftovers: the jobs left (no class, or overflowed) on the
        # native jobs engine; LONG windows (arms already materialized) and
        # pre-fallbacks (arms rebuilt from the flat table) on the classic
        self.stats["host_fallbacks"] += len(fallback) + len(left)
        with trace.span("runner.leftovers", timed=debug) as sp:
            finish_leftovers(self.host_engine, self.threads, fallback,
                             host_windows, jobs, job_refs, left)
        if debug and (fallback or left or host_windows):
            _log(f"host leftovers: {sp.seconds:.2f}s "
                 f"({len(fallback) + len(left)} fallbacks)")
        return count

    def _run_tiles(self, jobs, job_refs, debug: bool = False) -> List[int]:
        """Run every job (of ``jobs``, or none) that fits a shape class
        through device tiles, assigning consensus in place: every tile
        dispatched, the devices drained, then each tile read back and
        finalized in order.  Returns the indices of the jobs left for
        the host (no class, then overflowed)."""
        left: List[int] = []
        handles = []
        with trace.span("tiles.dispatch", timed=debug) as sp:
            if jobs is not None:
                left = self._dispatch_jobs(jobs, handles)
        if debug:
            _log(f"pack+dispatch: {sp.seconds:.2f}s "
                 f"({len(handles)} tiles)")
        with trace.span("tiles.drain", timed=debug) as sp:
            self._drain()
        if debug:
            _log(f"device drain: {sp.seconds:.2f}s")
        with trace.span("tiles.collect", timed=debug) as sp:
            for handle, order, lo, hi, row_of, N in handles:
                with trace.span("tiles.readback"):
                    packed = self._readback(handle)
                with trace.span("tiles.finalize"):
                    cnt = hi - lo
                    out, out_len = host_api.tile_finalize(
                        packed, row_of[:cnt], cnt, 0, N)
                    for t in range(cnt):
                        j = int(order[lo + t])
                        ctg, wi = job_refs[j]
                        if out_len[t] < 0:
                            self.stats["full_overflows"] += 1
                            left.append(j)
                        else:
                            ctg.windows[wi].consensus = \
                                out[t, :out_len[t]].tobytes().decode(
                                    "latin1")
        if debug:
            _log(f"readback+finalize: {sp.seconds:.2f}s "
                 f"stats={self.stats}")
        return left

    def _dispatch_jobs(self, jobs, handles: List) -> List[int]:
        """Class, pack and dispatch every job of ``jobs`` that fits a
        shape class, each tile's handle appended to ``handles``; returns
        the indices of the jobs that fit none."""
        nj = jobs.n_jobs
        job_th = np.zeros(nj, np.int32)  # short windows keep every base
        need_n = np.maximum(2 * jobs.job_maxlen, jobs.job_maxlen + 32)
        cls = np.full(nj, -1, np.int64)
        for ci, (L, N, K, _B, _A) in enumerate(CLASSES):
            ok = ((cls < 0) & (jobs.job_maxlen <= L) & (need_n <= N)
                  & (jobs.job_next <= K))
            cls[ok] = ci
        for ci in range(len(CLASSES)):
            idx = np.nonzero(cls == ci)[0]
            if not len(idx):
                continue
            order = np.ascontiguousarray(
                idx[np.lexsort((-jobs.job_maxlen[idx],
                                -jobs.job_next[idx]))], np.int64)
            L, N, K, B, A = self._class_shape(ci)
            lo = 0
            while lo < len(order):
                with trace.span("tiles.pack"):
                    hi, *arrays, row_of = host_api.tile_pack(
                        order, lo, jobs, job_th, B, K, A, L, self.ndev)
                with trace.span("tiles.issue"):
                    handle = self._dispatch(ci, self.short_scores, arrays)
                handles.append((handle, order, lo, hi, row_of, N))
                self._count_tile(ci, row_of[:hi - lo])
                lo = hi
        return np.nonzero(cls < 0)[0].tolist()

    # -- the path without the native host library ----------------------------
    @staticmethod
    def _trivial(job: _Job) -> bool:
        """One distinct (arm, NW) => consensus is that arm, exactly
        (single-sequence chain graph; support = total weight >= any
        curate threshold)."""
        return len(job.ext) == 1 and job.ext[0][1] == NW

    def _finish_trivial(self, job: _Job) -> Optional[_Job]:
        s = job.ext[0][0]
        w = job.window
        if job.kind == "short":
            w.consensus = s[1:-1]   # strip J/O markers (th = 0)
            return None
        # long windows curate at floor(0.4 * num_internal); every base's
        # support is the total arm weight, so it is all-or-nothing
        curated = s if job.ext[0][2] >= self._curate_threshold(job) else ""
        w.consensus = curated
        if job.kind == "long1":
            return self._build_long_job(w, backbone=curated, kind="long2")
        return None

    def _class_for(self, job: _Job) -> Optional[int]:
        if len(job.ext) > CLASSES[-1][2]:
            return None
        maxl = max(len(s) for s, _m, _w in job.ext)
        need_n = max(2 * maxl, maxl + 32)
        for ci, (L, N, K, _B, _A) in enumerate(CLASSES):
            if maxl <= L and need_n <= N and len(job.ext) <= K:
                return ci
        return None

    @staticmethod
    def _curate_threshold(job: _Job) -> int:
        if job.kind == "short":
            return 0
        return math.floor(job.window.num_internal * CURATE_THRESH)

    def run_windows(self, windows) -> int:
        """Consensus for ``windows`` (arms materialized on each window):
        LONG windows on the host engine, trivial ones on the host, the
        rest in waves of device tiles, all tiles of a wave dispatched
        before the first is read back."""
        debug = _debug()
        with trace.span("runner.jobs", timed=debug) as sp:
            jobs, host_long, count = self._window_jobs(windows)
            if host_long:
                self.stats["host_long_windows"] += len(host_long)
                with trace.span("runner.engine"):
                    self.host_engine.generate_consensus_batch(host_long,
                                                              self.threads)
        if debug:
            _log(f"build jobs: {sp.seconds:.2f}s ({len(jobs)} jobs, "
                 f"{len(host_long)} host long)")
        active = jobs
        wave = 0
        while active:
            nxt: List[_Job] = []
            with trace.span("runner.classify", timed=debug) as sp:
                groups = self._classify(active, nxt)
            if debug:
                ng = sum(len(g) for g in groups.values())
                _log(f"wave {wave}: classify {sp.seconds:.2f}s "
                     f"({ng} device jobs)")
            handles = []
            with trace.span("tiles.dispatch", timed=debug) as sp:
                for (ci, scores), grp in sorted(groups.items(),
                                                key=lambda kv: kv[0]):
                    grp.sort(key=lambda j: (-len(j.ext),
                                            -max(len(s) for s, _m, _w
                                                 in j.ext)))
                    lo = 0
                    while lo < len(grp):
                        tile, hi = self._take_tile(grp, lo, ci)
                        handles.append(
                            (tile, self._dispatch_tile(tile, ci, scores)))
                        lo = hi
            if debug:
                _log(f"wave {wave}: pack+dispatch {sp.seconds:.2f}s "
                     f"({len(handles)} tiles)")
            # drain the devices before the first readback, then read
            # every tile (no dispatches in between)
            with trace.span("tiles.drain", timed=debug) as sp:
                self._drain()
            if debug:
                _log(f"wave {wave}: device drain {sp.seconds:.2f}s")
            with trace.span("tiles.collect", timed=debug) as sp:
                for tile, handle in handles:
                    nxt.extend(self._collect_full(tile, handle))
            if debug:
                _log(f"wave {wave}: readback+finalize "
                     f"{sp.seconds:.2f}s  stats={self.stats}")
            active = nxt
            wave += 1
        return count

    def _window_jobs(self, windows):
        """The device jobs of ``windows``, trivial windows settled:
        (jobs, LONG windows for the host engine, windows counted)."""
        jobs: List[_Job] = []
        host_long = []
        count = 0
        for w in windows:
            if w is None:
                continue
            count += 1
            if w.wtype != 0:
                host_long.append(w)
                continue
            non_empty = w.num_internal + w.num_pre + w.num_suf
            if w.num_empty <= non_empty and non_empty >= 2:
                # identical-arm shortcut before decoding / dedup, the
                # majority case; the same condition _trivial would find
                tc = self.host_engine._trivial_consensus(w)
                if tc is not None:
                    w.consensus = tc
                    self.stats["trivial_windows"] += 1
                    continue
            j = self._build_job(w)
            if j is not None:
                jobs.append(j)
        return jobs, host_long, count

    def _classify(self, active: List[_Job], nxt: List[_Job]):
        """A wave's jobs deduplicated; trivial and classless ones
        finished on the host (the jobs they spawn appended to ``nxt``),
        the rest grouped by (class, scores)."""
        groups: Dict[tuple, List[_Job]] = {}
        for job in active:
            job.ext = _dedup(job.seqs)
            if self._trivial(job):
                self.stats["trivial_windows"] += 1
                spawned = self._finish_trivial(job)
                if spawned is not None:
                    nxt.append(spawned)
                continue
            ci = self._class_for(job)
            if ci is None:
                spawned = self._host_finish(job)
                if spawned is not None:
                    nxt.append(spawned)
                continue
            groups.setdefault((ci, job.scores), []).append(job)
        return groups

    def _take_tile(self, grp: List[_Job], lo: int, ci: int):
        """Take as many jobs from grp[lo:] as fit one tile's window and
        arm-pool capacities."""
        L, N, K, B, A = self._class_shape(ci)
        pool_used = 0
        seen: Dict[str, int] = {}
        hi = lo
        while hi < len(grp) and hi - lo < B:
            need = sum(1 for s, _m, _w in grp[hi].ext if s not in seen)
            if pool_used + need > A:
                break
            for s, _m, _w in grp[hi].ext:
                if s not in seen:
                    seen[s] = pool_used
                    pool_used += 1
            hi += 1
        return grp[lo:hi], hi

    def _dispatch_tile(self, grp: List[_Job], ci: int, scores):
        """Pack one tile (deduplicated arm pool + per-window index table,
        window j in row _row_order(...)[j]) and launch it; returns
        (``_dispatch``'s handle, the rows)."""
        with trace.span("tiles.pack"):
            arrays, rows = self._pack_tile(grp, ci)
        self._count_tile(ci, rows)
        with trace.span("tiles.issue"):
            return self._dispatch(ci, scores, arrays), rows

    def _pack_tile(self, grp: List[_Job], ci: int):
        """One tile's arrays (the program's inputs) and the rows of its
        windows."""
        L, N, K, B, A = self._class_shape(ci)
        pool_idx: Dict[str, int] = {}
        strs: List[str] = []
        idxt = np.full((B, K), -1, np.int32)
        amode = np.zeros((B, K), np.int8)
        aw = np.zeros((B, K), np.int32)
        narms = np.zeros(B, np.int32)
        th = np.zeros(B, np.int32)
        rows = self._row_order(len(grp), B)
        for j, job in enumerate(grp):
            b = rows[j]
            narms[b] = len(job.ext)
            th[b] = self._curate_threshold(job)
            for k, (s, md, w) in enumerate(job.ext):
                r = pool_idx.get(s)
                if r is None:
                    r = pool_idx[s] = len(strs)
                    strs.append(s)
                idxt[b, k] = r
                amode[b, k] = md
                aw[b, k] = w
        pool = np.zeros((A, L), np.int8)
        plen = np.zeros(A, np.int32)
        if strs:
            lens = np.fromiter((len(s) for s in strs), np.int64,
                               len(strs))
            codes = _CODE_LUT[np.frombuffer("".join(strs).encode(),
                                            np.uint8)]
            plen[:len(strs)] = lens
            starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
            within = np.arange(len(codes)) - np.repeat(starts, lens)
            dst = np.repeat(np.arange(len(strs)) * L, lens) + within
            pool.reshape(-1)[dst] = codes
        return (pool, plen, idxt, amode, aw, narms, th), rows

    def _collect_full(self, grp: List[_Job], handle) -> List[_Job]:
        handle, rows = handle
        with trace.span("tiles.readback"):
            packed = self._readback(handle)
        with trace.span("tiles.finalize"):
            return self._finalize_tile(grp, rows, packed)

    def _finalize_tile(self, grp: List[_Job], rows,
                       packed: np.ndarray) -> List[_Job]:
        """Each window's consensus from a tile's packed output, or the
        host engine's where the tile overflowed; returns the jobs they
        spawn."""
        half = packed.shape[1] - 4
        nib = packed[:, :half].view(np.uint8)
        codes = np.empty((packed.shape[0], 2 * half), np.uint8)
        codes[:, 0::2] = nib & 0xF
        codes[:, 1::2] = nib >> 4
        clen = (packed[:, half].view(np.uint8).astype(np.int32)
                | (packed[:, half + 1].view(np.uint8).astype(np.int32)
                   << 8))
        ovf = packed[:, half + 2] != 0
        out: List[_Job] = []
        for j, job in enumerate(grp):
            b = rows[j]
            if ovf[b]:
                self.stats["full_overflows"] += 1
                spawned = self._host_finish(job)
            else:
                spawned = self._finalize_full(job, codes[b, :clen[b]])
            if spawned is not None:
                out.append(spawned)
        return out

    def _finalize_full(self, job: _Job,
                       codes: np.ndarray) -> Optional[_Job]:
        """codes are already curated on device (short: th=0 keeps all)."""
        w = job.window
        cons = _decode(codes)
        if job.kind == "short":
            w.consensus = cons[1:-1]   # strip J/O markers
            return None
        w.consensus = cons
        if job.kind == "long1":
            return self._build_long_job(w, backbone=cons, kind="long2")
        return None
