"""Window consensus through the tile program on a PyTorch device: the
port of hypo_tpu.poa.full_runner.FullDeviceRunner (``--device-poa``,
mode ``full``), its native tile path ``run_polish_batch``.

The native job builder (native.host_api.tile_jobs, via
host_runner.build_batch_jobs) settles trivial windows and deduplicates
arms, host_api.tile_pack packs B windows into a tile and
host_api.tile_finalize unpacks its output; ``_dispatch_jobs`` holds the
class rule.  The runner needs the native host and POA libraries
(host_runner.missing_native_libs), which the orchestrator checks.

Each tile is one call of the tile program (poa.device_full.
build_tile_program; one a class and scores, kept by the runner, whose
CUDA graphs are captured at its first tile) over this runner's devices:
on a CUDA device a tile is a few input copies and graph replays.  With
ndev devices the tile's B rows split into ndev blocks of B // ndev, one
a device, and tile_pack stripes a tile's windows across the blocks
(window t of a tile in row (t % ndev) * (B // ndev) + t // ndev, as the
JAX package does), so each block gets a like mix of arm counts.
``stats["rows_per_device"]`` counts the windows each block got (a list
of ints; the JAX package counts them with ndev > 1 only).
``HYPO_POA_NDEV`` caps ndev at its value, which must not exceed the
devices the runner is given.  LONG windows (wtype != 0), windows that
fit no shape class and windows that overflow a class cap on the device
go to the host, as in the JAX package: that routing is part of the
algorithm.  The classless and overflowed windows keep their jobs, which
the native jobs engine finishes (host_runner.finish_leftovers; the
classic engine's consensus), and LONG windows and the job builder's
pre-fallbacks go to the classic engine (engine.ConsensusEngine).
``stats`` puts LONG windows under host_long_windows and the rest under
host_fallbacks (the JAX package adds both to host_long_windows).

Every tile of a call is dispatched before the first is read back, as
the JAX package does: the tile program queues its work without a host
sync (pinned uploads, the arm loop's bound from the host's narms), then
the runner drains the devices (``_drain``) and reads the tiles back in
order (``_readback``).  The runner opens spans (``utils.trace``:
``runner.*`` and ``tiles.*``; the warm-up thread's under the span that
called ``warm``).  With ``HYPO_POA_DEBUG`` set, it prints the JAX
runner's stage lines (``[poa] ...``) to stdout, with those spans'
seconds.  ``warm()`` builds kernels 1-3 and runs the tile program
(which builds kernels 4 and 5 at their first launch) once on a zero
tile in a background thread, as the JAX package does, so that both (and
the capture of the program's graphs) overlap the host stages; the first
dispatch waits for the thread and raises the error it met, if any.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ScoreParams
from ..native import host_api
from ..utils import trace
from .cuda_poa import check_scores
from .device_full import TileProgram, as_devices, build_tile_program
from .engine import ConsensusEngine
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


def _debug() -> bool:
    return bool(os.environ.get("HYPO_POA_DEBUG"))


def _log(msg: str) -> None:
    print(f"[poa] {msg}", flush=True)


class FullDeviceRunner:
    """Device engine over tiles, computing on ``device`` (a CUDA device
    or a list of them, see runner_devices; CPU tensors in tests): each
    short window's whole POA and consensus on the devices.
    ``fix_long_align_type`` reaches the host engine, which takes the
    LONG windows (engine.ConsensusEngine)."""

    # kernels warm() builds
    KERNELS = ("poa_dp", "poa_tb", "consensus")

    def __init__(self, sp: ScoreParams, device, threads: int = 0,
                 fix_long_align_type: bool = False):
        self.devices = runner_devices(device)
        self.device = self.devices[0]
        self.ndev = len(self.devices)
        self.short_scores = (sp.sr_match, sp.sr_mismatch, sp.sr_gap)
        self._warm_thread: Optional[threading.Thread] = None
        self._warm_error: Optional[Exception] = None
        # (class, scores) -> its tile program, whose CUDA graphs and
        # buffers live as long as this runner
        self._programs: Dict[tuple, TileProgram] = {}
        for ci in range(len(CLASSES)):      # raises unless B splits
            self._program(ci, self.short_scores)
        self.threads = threads
        self.host_engine = ConsensusEngine(sp, fix_long_align_type)
        self.stats = {"full_dispatches": 0, "full_windows": 0,
                      "full_overflows": 0, "trivial_windows": 0,
                      "host_long_windows": 0, "host_fallbacks": 0,
                      # per shape class (index into CLASSES)
                      "class_tiles": [0] * len(CLASSES),
                      "class_windows": [0] * len(CLASSES),
                      "rows_per_device": [0] * self.ndev}

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
        if self.device.type == "cuda":
            from .. import _build
            for name in self.KERNELS:
                _build.load(name)
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
        """Raises ValueError unless the DP kernel's int16 cells hold the
        scores at the shape classes: full mode launches the short-read
        scores only (LONG windows go to the host engine), so
        ``long_reads`` changes nothing."""
        for L, N, _K, _B, _A in CLASSES:
            check_scores(sp.sr_match, sp.sr_mismatch, sp.sr_gap, N, L)

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
