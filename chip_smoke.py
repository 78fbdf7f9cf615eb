#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hypo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--baseline OLD_poa_dp.cu OLD_poa_tb.cu
                           OLD_consensus.cu OLD_poa_rank.cu
                           OLD_poa_merge.cu]

Phases, each raising on failure (so the script exits non-zero and never
prints its last line):
  1. environment: torch / CUDA / nvcc versions, the card's name and
     power limit; fails without CUDA;
  2. build: the five CUDA kernels with nvcc and the port's three native
     host libraries with g++, one compiler each, all started together
     (timed; each kernel's registers, spills and shared memory as
     ``-Xptxas -v`` prints them);
  3. DP kernel vs its plain PyTorch version on the card, at the class-0
     (B=2048, N=256, L=126, P=8; a chain and a multi-predecessor bucket)
     and class-1 (B=256, N=1024, L=510, P=8) tile shapes, mixed
     NW/LOV/ROV modes and ragged n_nodes: exact equality, median times;
     then the DP and traceback kernels vs their plain versions at exact
     mode's buckets (N 64, L 64, P 1, short scores, B=4096; N 1024,
     L 512, P 4 and N 1024, L 1024, P 4, long scores, B=64 and 8):
     exact equality of bp, max_row, ti, tj and steps, median times.
     Each kernel's bound at each shape, from this run's inputs: the
     larger of the bytes it must move over 3.35 TB/s and its int32
     operations over 132 SMs x 64 lanes x the card's clocks.max.sm.
     ``--baseline`` takes earlier sources of kernel 1 (csrc/poa_dp.cu),
     kernel 3 (csrc/poa_tb.cu), kernel 2 (csrc/consensus.cu), kernel 4
     (csrc/poa_rank.cu) and kernel 5 (csrc/poa_merge.cu), told apart by
     the entry they export, and times each at its shapes in
     turns with this one (baseline, this, this, baseline), after
     checking it against the plain version;
  4. consensus kernel vs its plain version on the rank arrays of a real
     tile of each shape class (class 0: B=2048, N=256, L=126; class 1:
     B=256, N=1024, L=510; random windows merged by the port's arm
     steps): exact equality, median times, windows resident an SM, and
     how many windows entered branch completion and the most rounds
     one ran (from the plain version); and the traceback kernel's
     tile emitter (the tile program's walk) vs its plain version on
     the bp of that tile's arm steps (the first two, the middle one and
     the last; rows above n_nodes hold what kernel 1 left there), with
     matched rebuilt from exact mode's emitter on the same inputs:
     exact equality, median times at the third step; (4c) the rank
     kernel (kernel 4) and the merge kernel (kernel 5) vs their plain
     versions on the state before every arm step of that tile (recorded
     as the eager steps ran) and on its final state: kernel 4 with all
     its leaves and with the arm step's and the finish's subsets, kernel
     5 on a copy of each state (it merges in place), every leaf equal;
     the step head (cuda_rank.step_head: the tile program's arm fetch
     and kernel 4 in one launch) against its plain version
     (device_full._step_head_batch) at steps 0, 1, 2, the middle one
     and the last, and on a ragged copy of the tile's arm rows (windows
     with no arm, a -1 in mid-row, rows past narms) at step 1, the last
     and the one after; device and call times at the third step
     (kernel 5's device time from its kernel alone: its state is
     restored before each call), each against its bound on that step's
     own bytes, and the head in turns with the fetch's torch ops plus
     kernel 4 (the step before the head); kernel 4's and kernel 5's
     launch shapes; with a ``--baseline`` of kernel 4 or 5, that kernel
     checked against the plain version and timed in turns with this
     one at the third step (kernel 4 with each leaf set, on the final
     state for the finish's);
  5. each tile through the tile program (its CUDA graphs captured at
     that first tile) vs the eager arm steps and finish, and vs the
     NumPy spec hypo_tpu_torch.poa.colpoa_ref.ColPoa on every window
     without overflow (at least 256 / 128 of them); the five kernels'
     launch counters > 0; how many rows the DP kernel keeps in its
     int16 device-memory copy (rows read from beyond its ring) over the
     tile's arm steps; then (5b) three different tiles of the class
     dispatched back to back through the program before any readback,
     each equal to the eager tile (run_tile_eager), with the capture's
     time and graph memory and the host's launch calls in one tile,
     eager and through the graphs; then where the class-0 tile's time
     goes: the eager tile's per-step times with a sync around each
     call, the eager and graph tiles' walls, and the device's busy
     share in one torch.profiler trace of the graph tile;
  6. end to end at E. coli scale: a 4 Mbp / 30x simulation
     (``python -m hypo_tpu_torch.sim``) polished by ``hypo_tpu_torch.cli
     --device-poa`` (in this process, kernel launch counters reset just
     before) and by the port's host engine (``hypo_tpu_torch.cli
     --no-device-poa``, a subprocess): both FASTA md5s equal the md5
     pinned from hypo_tpu's host engine on the same input; stage times,
     QV before/after;
  7. exact mode end to end: a 1 Mbp hybrid simulation (30x short, 25x
     long reads, short-read dropout over 3% of the genome) polished by
     ``hypo_tpu_torch.cli -B lr.bam --device-poa --device-poa-mode
     exact`` (LONG windows on the card; calls, windows and launches of
     kernels 1 and 3 per (N, L, P) bucket) and, on the same input, in
     mode full; md5s as in 6;
  8. without the native libraries (``HYPO_TPU_NO_NATIVE=1``) on a
     200 kbp hybrid simulation: exact mode (pure-Python host stages,
     the Python graphs, kernels 1 and 3 on the card), md5s as in 6;
     mode full refuses before any host stage, naming the libraries;
  9. sharded polish: a 4 Mbp / 30x simulation in 4 contigs of 1 Mbp
     (phase 6's configuration, nothing cut), polished (a) by the port's
     host engine; (b) by two ranks (``--nproc 2``, a fresh aux directory
     and output path, ``HYPO_POA_NDEV=1`` each): rank 1 a
     ``hypo_tpu_torch.cli`` subprocess started first, rank 0 in this
     process; rank 1 on the second card when there are two
     (``CUDA_VISIBLE_DEVICES=1``), else both on cuda:0; (c) by one
     process whose tiles split into two device blocks (the first two
     cards, or cuda:0 twice on one card): every md5 equals the pin,
     rows per device balanced within 1.5; then ``entry.entry()``'s DP
     call against its plain version, ``entry.dryrun_multichip(2)`` over
     the same two devices, and two processes started together that
     build one kernel under a fresh name (the build's race).
  10. the port's measurement tools on phase 6's 4 Mbp simulation, each
     a subprocess whose output is printed here: ``python -m
     hypo_tpu_torch.bench --sim <sim_4m>`` (the host engine,
     then one device process polishing cold and warm: the pipeline
     tables and the md5 check; every md5 must equal the
     pin) and ``python -m hypo_tpu_torch.tools.profile_device 2048 2``
     (the class-0 arm step's parts, the tile program's step graph,
     which must equal the eager step, and a tile eager and through the
     program's graphs, which must give the same bytes).
  11. class 1 end to end: a 2 Mbp simulation at 8x short-read coverage
     (``--short-cov 8``; its weak windows' arms reach class 1) polished
     with ``-c 8`` by ``hypo_tpu_torch.cli --device-poa`` in this process
     and by the port's host engine: md5s as in 6, at least two class-1
     tiles, whose graphs are captured at the class's first dispatch,
     mid-run (capture seconds and graph memory a class logged), QV
     before/after;
  12. the whole-batch entry point ``device_full.poa_full_batch`` on the
     first tile of each class that phase 11 dispatched, gathered into
     [B, K, L] at full width (B=2048, N=256, L=126, K=16; B=256, N=1024,
     L=510, K=16; the pool's int8 codes): inputs unchanged, equal to
     poa_full_batch on the CPU (int32 codes) on a row subset, every
     window without overflow equal to ColPoa; times; then each kernel
     against its plain version and timed, with its bound, on the class-1
     call's third arm step (the class-1 kernels' first real-tile times);
     then on each of those two tiles as the runner packed them, merged
     by the eager arm steps, the step head and kernel 4 (every leaf set)
     against their plain versions at steps 0, 1, 2, the middle one and
     the last, and the head timed at the class-1 tile's third step;
  13. the runners' ``fix_long_align_type`` on phase 7's 1 Mbp hybrid
     simulation, through a Polisher subclass (neither CLI has the
     option): exact mode (LONG windows' prefix arms LOV and suffix arms
     ROV on the card), mode full and the port's host engine with the
     option each write the md5 pinned from hypo_tpu's host engine with
     it, exact mode's windows equal the host engine's, the default host
     engine writes phase 7's pin, and some windows differ from its.
Launch counters count kernels that ran: a launch captured in a graph
counts at each replay (the capture's eager first call of each part
counts once), so a path's counts are its arm steps (kernels 1, 3, 5,
and kernel 4 as the step head), its tiles (kernel 2, and kernel 4 as
the finish's rank), plus one of each for every capture; the eager arm
steps of poa_full_batch rank through kernel 4's rank_arrays.
Phases 6-9, 11 and 13 run the port in this process, and phase 12 its
first two poa_full_batch calls, every launch counter set to 0 just
before each run and read just after.  Nothing of hypo_tpu or jax
is imported or run.  Tolerance everywhere: 0 (every compared value is
an integer).  A kernel's time is its device time per call under
torch.profiler, checked against CUDA graph replays of back-to-back
calls (graph_ms), whose time it takes, with a log line, where the two
differ by more than 1.5x; beside it, its time per call between CUDA
events over back-to-back calls, which also holds the wrapper's host
work and is that work's time where the kernel is shorter.  A plain
version's time is the latter (median of REPS samples).

The last lines are the card (nvidia-smi name, power limit), one JSON
object describing each kernel, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import io
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hypo_tpu_torch import _build
from hypo_tpu_torch.poa import NW, LOV, ROV
from hypo_tpu_torch.poa import device_full as TF
from hypo_tpu_torch.poa import cuda_consensus
from hypo_tpu_torch.poa.cuda_consensus import heaviest_bundle
from hypo_tpu_torch.poa import cuda_merge, cuda_poa, cuda_rank
from hypo_tpu_torch.poa.cuda_merge import merge_arm
from hypo_tpu_torch.poa.cuda_poa import poa_dp_batch
from hypo_tpu_torch.poa.cuda_rank import (CONS_LEAVES, STEP_LEAVES,
                                          rank_arrays, step_head)
from hypo_tpu_torch.poa.cuda_tb import poa_tb_batch, poa_tb_matched
from hypo_tpu_torch.poa.dp import (poa_dp_batch_ref, poa_tb_batch_ref,
                                   poa_tb_matched_ref)

HERE = os.path.dirname(os.path.abspath(__file__))
SCORES = dict(m=5, n=-4, g=-8)
LONG_SCORES = dict(m=3, n=-5, g=-4)
KERNELS = ("poa_dp", "poa_tb", "consensus", "poa_rank", "poa_merge")
# each kernel wrapper's launches; kernel 3 has one wrapper for each
# emitter, kernel 4 (csrc/poa_rank.cu) its rank (the finish's, and each
# eager arm step's) and the tile program's step head
COUNTERS = {"poa_dp": (poa_dp_batch,),
            "poa_tb": (poa_tb_batch, poa_tb_matched),
            "consensus": (heaviest_bundle,),
            "poa_rank": (rank_arrays,),
            "poa_step_head": (step_head,),
            "poa_merge": (merge_arm,)}
# what a polish in mode full (its arm steps in the tile program) launches
FULL_PATH = KERNELS + ("poa_step_head",)
# the C entry by which a --baseline source is known as a kernel's
BASELINE_ENTRY = {"poa_dp": "hypo_poa_dp", "poa_tb": "hypo_poa_tb",
                  "consensus": "hypo_heaviest_bundle",
                  "poa_rank": "hypo_poa_rank",
                  "poa_merge": "hypo_poa_merge"}
REPS = 5
KERNEL_INNER = 10
POA_RE = re.compile(r"POA over (\d+) windows\. \[([0-9.]+) sec")
TOTAL_RE = re.compile(r"Overall\. \[([0-9.]+) sec total")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, inner: int = 1, reps: int = REPS) -> float:
    """Median over reps samples of the milliseconds per call of fn(),
    after one warm-up; a sample is ``inner`` back-to-back calls between
    two CUDA events, so a kernel's launch overhead overlaps the previous
    launch instead of being counted as device time."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / inner)
    return float(np.median(ts))


def traced_ms(fn, only=None, tries: int = 3):
    """(the summed durations of the device kernels that KERNEL_INNER *
    REPS calls of fn() launch under torch.profiler (CUDA activity only;
    with ``only``, just the kernels whose name holds it), over the calls,
    after one warm-up; the number of those kernels in the trace), or
    None when ``tries`` traces in a row held no such kernel (the
    profiler's device activity is sometimes lost)."""
    from torch.profiler import ProfilerActivity, profile
    calls = KERNEL_INNER * REPS
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (only is None or only in e.name)]
        if spans:
            return sum(spans) / 1e3 / calls, len(spans)
    return None


def kernel_ms(fn, only=None, less=None) -> tuple:
    """(device ms, call ms) per call of a kernel wrapper fn(): traced_ms's
    device time, checked against graph_ms's (fn's less that of ``less``,
    the work fn does around the kernel), and cuda_ms's time per call.
    The call time also holds the wrapper's host work (argument checks,
    allocation, the ctypes launch), and is that work's time where the
    kernel is shorter.  Where the profiler saw no kernel, or its time
    and the graph replays' differ by more than 1.5x (its device times
    have read 3-5x low in some runs of this script, even below the
    kernel's bound), the device time is the graph replays', and a line
    says so."""
    traced = traced_ms(fn, only)
    call_ms = cuda_ms(fn, inner=KERNEL_INNER)
    replay_ms = graph_ms(fn) - (graph_ms(less) if less else 0.0)
    if traced is None:
        log(f"torch.profiler saw no device kernel{f' {only}' if only else ''}"
            f" in 3 traces: its device time {replay_ms:.4f} ms is from CUDA "
            f"graph replays{', less the work around it' if less else ''}")
        return replay_ms, call_ms
    ms, events = traced
    # a replay time at or below 0 is fn's and ``less``'s noise: no check
    if replay_ms > 0 and not 2 / 3 < ms / replay_ms < 3 / 2:
        log(f"torch.profiler's device time {ms:.4f} ms ({events} kernels in "
            f"the trace of {KERNEL_INNER * REPS} calls) differs from the "
            f"CUDA graph replays' {replay_ms:.4f} ms by more than 1.5x: the "
            f"device time is the replays'")
        ms = replay_ms
    return ms, call_ms


def graph_ms(fn, calls: int = 20, reps: int = REPS) -> float:
    """Milliseconds a call of fn() from replays of one CUDA graph that
    holds ``calls`` back-to-back calls (captured after one eager call on
    the capture stream): the device's time a call with no host work
    between the kernels (median of ``reps`` replays between CUDA
    events).  A launch captured here is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / calls)
    return float(np.median(ts))


def launch_counts() -> dict:
    return {k: sum(w.launches for w in ws) for k, ws in COUNTERS.items()}


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


# -- 1. environment -----------------------------------------------------------

def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    r = subprocess.run([_build.nvcc_path(), "--version"],
                       capture_output=True, text=True, check=True)
    log("nvcc: " + r.stdout.strip().splitlines()[-1])
    card = smi_line()
    log(f"card: {card} (devices: {torch.cuda.device_count()})")
    return card


# -- 2. build -----------------------------------------------------------------

def phase_build(baselines) -> dict:
    """Every CUDA kernel with nvcc and the three native host libraries
    with g++, one compiler each, all started together; ``baselines``
    (.cu files) add earlier kernel sources for comparison.  Returns
    {kernel: loaded baseline library} by the entry each exports."""
    from concurrent.futures import ThreadPoolExecutor

    from hypo_tpu_torch.native import api, bam_api, host_api
    jobs = [(name, _build.load, (name,)) for name in KERNELS]
    jobs += [(f"baseline{k}", _build.load, (f"baseline{k}", src))
             for k, src in enumerate(baselines)]
    jobs += [(mod.__name__, mod.available, ()) for mod in
             (host_api, api, bam_api)]
    t0 = time.time()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = [(name, pool.submit(fn, *a)) for name, fn, a in jobs]
        for name, f in futs:
            if f.result() is False:
                raise RuntimeError(f"build of {name} failed")
    log(f"build of {len(jobs)} libraries ({len(jobs) - 3} nvcc, 3 g++), "
        f"all together: {time.time() - t0:.2f} s")
    for name, (secs, out) in sorted(_build.build_log.items()):
        log(f"build {name}: its compiler ran {secs:.2f} s (concurrently)")
        for line in out.splitlines():
            if re.search(r"entry function|registers|spill|smem|error|"
                         r"warning", line):
                log("  " + line.strip())
    found = {}
    for k, src in enumerate(baselines):
        lib = _build.load(f"baseline{k}", src)
        kern = [n for n, e in BASELINE_ENTRY.items() if hasattr(lib, e)]
        if len(kern) != 1:
            raise RuntimeError(f"baseline {src}: exports none or several "
                               f"of {sorted(BASELINE_ENTRY.values())}")
        found[kern[0]] = lib
        log(f"baseline of {kern[0]}: {src}")
    return found


# -- 3. DP kernel vs plain ----------------------------------------------------

def dp_bucket(rng, B, N, L, P, multi: bool, dev, inactive: float = 0.02):
    """bench.py's chain / multi-predecessor recipe with mixed modes,
    ragged graph sizes (a share ``inactive`` of windows empty) and
    ragged arms."""
    nc = rng.integers(0, 4, (B, N))
    pr = np.tile(np.arange(N)[None, :, None], (B, 1, P))
    pc = np.ones((B, N), np.int64)
    if multi:
        # ~30% of rows get 2-3 predecessors reaching 1-8 ranks back
        pc = np.where(rng.random((B, N)) < 0.3,
                      rng.integers(2, 4, (B, N)), 1)
        for p in range(1, 3):
            pr[:, :, p] = np.maximum(pr[:, :, 0] - rng.integers(1, 8, (B, N)),
                                     0)
    nn = rng.integers(N // 4, N + 1, B)
    nn[rng.random(B) < inactive] = 0
    ie = rng.random((B, N)) < 0.05
    ie[np.arange(B), np.maximum(nn - 1, 0)] = True
    arm = rng.integers(0, 4, (B, L))
    al = rng.integers(L // 2, L + 1, B)
    md = rng.choice([NW, LOV, ROV], B)
    i32 = lambda a: torch.as_tensor(a, device=dev).to(torch.int32)  # noqa
    return (i32(nc), i32(pr), i32(pc), torch.as_tensor(ie, device=dev),
            i32(nn), i32(arm), i32(al), i32(md))


def smi_query(field: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={field}",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


HBM_BYTES_PER_S = 3.35e12     # H100 SXM peak HBM3 bandwidth
INT32_LANES = 132 * 64        # SMs x INT32 lanes a clock


@functools.lru_cache(maxsize=None)
def int32_ops_per_s() -> float:
    return INT32_LANES * float(smi_query("clocks.max.sm")) * 1e6


def bound(nbytes: float, ops: float) -> dict:
    """The least time for ``nbytes`` moved and ``ops`` int32 operations:
    the larger of bytes over HBM rate and ops over the int32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int32_ops_per_s() * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


def dp_bound(args, N, L, P) -> dict:
    """Kernel 1's bound on these inputs: each used input read once (the
    rows below n_nodes: code, count, end flag and the real predecessor
    slots; the arm; three scalars), each output written once (bp rows
    0..n_nodes, max_row); 6p + 3 int32 operations a cell of a row below
    n_nodes with p real predecessors, p at least 1 (two adds, two maxes
    and two compares each, then the horizontal gap, its max and the
    backpointer select); rows past n_nodes cost nothing."""
    nc, pr, pc, ie, nn, arm, al, md = args
    rows = (torch.arange(N, device=nn.device)[None, :]
            < nn[:, None])
    n_rows = int(rows.sum())
    n_preds = int(torch.where(rows, pc.clamp(0, P), 0).sum())
    n_slots = int(torch.where(rows, pc.clamp(1, P), 0).sum())
    nbytes = (n_rows * (4 + 4 + 1) + 4 * n_preds + arm.numel() * 4
              + 12 * nn.numel()
              + int((nn + 1).sum()) * (L + 1) + 4 * nn.numel())
    ops = (6 * n_slots + 3 * n_rows) * (L + 1)
    return bound(nbytes, ops)


def launch_note(N, L, P) -> str:
    """Kernel 1's launch at this shape: threads, columns a thread, ring
    rows and dynamic shared memory (ptxas, in the build phase, sees only
    the static part)."""
    per = cuda_poa.columns_per_thread(L)
    threads = cuda_poa.launch_threads(L)
    return (f"launch {threads} threads x {per} columns, ring "
            f"{cuda_poa.RING} rows, "
            f"{cuda_poa.smem_bytes(threads * per, N, P)} B dynamic shared "
            f"memory a CTA")


class FarRows:
    """Counts, over the DP calls it wraps, the rows kernel 1 copies to
    its int16 device-memory scratch: rows 1..N that a row below n_nodes
    reads through a real predecessor slot from more than RING - 1 rows
    back (csrc/poa_dp.cu's far[] marks).  The scratch is allocated for
    all N + 1 rows of every window."""

    def __init__(self, fn):
        self.fn = fn
        self.far = self.rows = self.calls = self.worst = 0
        self.slots = 0

    def __call__(self, *args, N, P, **kw):
        nn, pr, pc = args[4], args[1], args[2]
        B = nn.shape[0]
        i = torch.arange(N, device=nn.device)
        real = ((i[None, :] < nn[:, None])[:, :, None]
                & (torch.arange(P, device=nn.device)[None, None, :]
                   < pc.clamp(0, P)[:, :, None]))
        r = pr.clamp(0, N).long()
        far = real & (r >= 1) & (r <= i[None, :, None] - cuda_poa.RING)
        marked = torch.zeros((B, N + 1), dtype=torch.int32, device=nn.device)
        marked.scatter_add_(1, torch.where(far, r, 0).reshape(B, -1),
                            far.reshape(B, -1).int())
        per_win = (marked[:, 1:] > 0).sum(1)
        self.far += int(per_win.sum())
        self.worst = max(self.worst, int(per_win.max()) if B else 0)
        self.rows += int(nn.clamp(0, N).sum())
        self.slots += B * (N + 1)
        self.calls += 1
        return self.fn(*args, N=N, P=P, **kw)

    def line(self, name: str) -> str:
        return (f"{name} tile DP far rows (kept in the int16 device copy): "
                f"{self.far} of {self.rows} rows over {self.calls} calls "
                f"({self.far / max(self.rows, 1):.4f}), at most {self.worst} "
                f"in a window; the copy is allocated for {self.slots} rows "
                f"({self.far / max(self.slots, 1):.4f} of them written)")


def baseline_dp(lib, args, N, L, P, m, n, g):
    """The earlier DP kernel (int32 H scratch in device memory)."""
    B = args[0].shape[0]
    dev = args[0].device
    bp = torch.empty((B, N + 1, L + 1), dtype=torch.int8, device=dev)
    mr = torch.empty((B,), dtype=torch.int32, device=dev)
    H = torch.empty((B, N + 1, L + 1), dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hypo_poa_dp.restype = ci
    lib.hypo_poa_dp.argtypes = [vp] * 11 + [ci] * 7 + [vp]
    p = _build.ptr
    rc = lib.hypo_poa_dp(*(p(x) for x in args), p(bp), p(mr), p(H), B, N, L,
                         P, m, n, g, ctypes.c_void_p(
                             torch.cuda.current_stream().cuda_stream))
    _build.check(lib, rc, "baseline poa_dp launch")
    return bp, mr


def dp_diff(out, ref, nn, N) -> int:
    """Max |difference| of (bp on rows <= n_nodes, max_row)."""
    rows = (torch.arange(N + 1, device=nn.device)[None, :]
            <= nn[:, None])[:, :, None]
    bp_diff = ((out[0].int() - ref[0].int()).abs() * rows).amax().item()
    return max(bp_diff, (out[1] - ref[1]).abs().amax().item())


def in_turns(what: str, run_old, run_new, only=None, less=None) -> dict:
    """A kernel against its baseline on the same inputs, timed in turns
    (baseline, kernel, kernel, baseline): device and call times (device
    time of the kernels named ``only``, as kernel_ms counts it)."""
    t = [kernel_ms(f, only, less)
         for f in (run_old, run_new, run_new, run_old)]
    old_ms, new_ms = (t[0][0] + t[3][0]) / 2, (t[1][0] + t[2][0]) / 2
    old_call, new_call = (t[0][1] + t[3][1]) / 2, (t[1][1] + t[2][1]) / 2
    log(f"{what} (in turns: baseline, this, this, baseline): device "
        f"baseline kernel {t[0][0]:.4f} / {t[3][0]:.4f} ms, this kernel "
        f"{t[1][0]:.4f} / {t[2][0]:.4f} ms: {old_ms / new_ms:.2f}x; per call "
        f"{t[0][1]:.4f} / {t[3][1]:.4f} ms against {t[1][1]:.4f} / "
        f"{t[2][1]:.4f} ms: {old_call / new_call:.2f}x")
    return dict(baseline_ms=old_ms, new_ms=new_ms, baseline_call_ms=old_call,
                new_call_ms=new_call)


def dp_versions(name, args, kw, ref, baseline) -> dict:
    """Kernel 1 against the baseline kernel on the same inputs, in turns,
    the baseline checked against the plain version's output ``ref``
    first."""
    if baseline is None:
        return {}
    N, L, P = kw["N"], kw["L"], kw["P"]
    sc = {k: kw[k] for k in ("m", "n", "g")}
    diff = dp_diff(baseline_dp(baseline, args, N, L, P, **sc), ref, args[4],
                   N)
    if diff:
        raise RuntimeError(f"baseline DP != plain on {name}: {diff}")
    return in_turns(f"DP {name}", lambda: baseline_dp(baseline, args, N, L, P,
                                                      **sc),
                    lambda: poa_dp_batch(*args, **kw))


def baseline_tb(lib, tb_args, N, L, P):
    """An earlier kernel 3 through its exact-mode entry (same contract)."""
    B = tb_args[0].shape[0]
    dev = tb_args[0].device
    S = N + L + 1
    ti = torch.empty((B, S), dtype=torch.int16, device=dev)
    tj = torch.empty((B, S), dtype=torch.int16, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hypo_poa_tb.restype = ci
    lib.hypo_poa_tb.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    p = _build.ptr
    rc = lib.hypo_poa_tb(*(p(x) for x in tb_args), p(ti), p(tj), p(steps), B,
                         N, L, P, ctypes.c_void_p(
                             torch.cuda.current_stream().cuda_stream))
    _build.check(lib, rc, "baseline poa_tb launch")
    return ti, tj, steps


def tb_versions(name, tb_args, N, L, P, ref, baseline) -> dict:
    """Kernel 3 (exact emitter) against the baseline kernel, in turns, the
    baseline checked against the plain version's output ``ref`` first."""
    if baseline is None:
        return {}
    got = baseline_tb(baseline, tb_args, N, L, P)
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise RuntimeError(f"baseline traceback != plain on {name}")
    return in_turns(f"traceback {name}",
                    lambda: baseline_tb(baseline, tb_args, N, L, P),
                    lambda: poa_tb_batch(*tb_args, N=N, L=L, P=P))


def phase_dp(rng, dev, baseline) -> dict:
    P = 8
    res = {}
    for name, (B, N, L), multi in (("class0_chain", (2048, 256, 126), False),
                                   ("class0_multi", (2048, 256, 126), True),
                                   ("class1_multi", (256, 1024, 510), True)):
        args = dp_bucket(rng, B, N, L, P, multi, dev)
        kw = dict(N=N, L=L, P=P, **SCORES)
        out_k = poa_dp_batch(*args, **kw)
        ref = poa_dp_batch_ref(*args, **kw)
        torch.cuda.synchronize()
        nn = args[4]
        err = dp_diff(out_k, ref, nn, N)
        if err:
            raise RuntimeError(f"DP kernel != plain on {name}: max |diff| "
                               f"{err} (bp rows <= n_nodes, max_row)")
        ms, call_ms = kernel_ms(lambda: poa_dp_batch(*args, **kw))
        plain_ms = cuda_ms(lambda: poa_dp_batch_ref(*args, **kw))
        cells = int(nn.sum().item()) * (L + 1)
        bd = dp_bound(args, N, L, P)
        log(f"DP {name} B={B} N={N} L={L} P={P}: equal (bp rows <= n_nodes,"
            f" max_row); kernel {ms:.4f} ms ({cells / ms / 1e6:.2f} "
            f"Gcells/s; {call_ms:.4f} ms a call), plain {plain_ms:.3f} ms; "
            f"bound {bd['bound_ms']:.4f}"
            f" ms by {bd['bound_by']} ({bd['bytes'] / 1e6:.1f} MB, "
            f"{bd['ops'] / 1e9:.3f} Gop): {bd['bound_ms'] / ms:.3f} of it; "
            + launch_note(N, L, P))
        res[name] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         max_abs_err=err,
                         bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                         **dp_versions(name, args, kw, ref, baseline))
    return res


# exact mode's buckets: name, B, N, L, P, scores
EXACT_BUCKETS = (("exact_N64_L64_P1", 4096, 64, 64, 1, SCORES),
                 ("exact_N1024_L512_P4", 64, 1024, 512, 4, LONG_SCORES),
                 ("exact_N1024_L1024_P4", 8, 1024, 1024, 4, LONG_SCORES))


def tb_bound(steps, N, L, matched: bool = False) -> dict:
    """Kernel 3's bound on these inputs: per step the bp cell and the
    predecessor entry it reads (1 + 4 bytes) and about 10 int32
    operations; per window three scalars read and, for exact mode, ti,
    tj (S = N + L + 1 int16 each) and steps written, or for the tile
    walk the active flag read and matched (L int32) written.  ``steps``
    [B] counts each window's walk (0 for a window not active)."""
    B = steps.numel()
    total = int(steps.sum())
    S = N + L + 1
    per_window = 12 + (1 + 4 * L if matched else 4 * S + 4)
    return bound(5 * total + B * per_window, 10 * total)


def phase_exact_dp(rng, dev, baselines) -> tuple:
    """Kernels 1 and 3 against their plain versions at exact mode's
    buckets.  Every window is active, as in exact mode (it launches
    groups at their exact size).  Kernel 3 and the plain traceback walk
    the kernel's bp; the kernels' chain is also held against the plain
    chain (poa_dp_batch_ref then poa_tb_batch_ref)."""
    dp, tb = {}, {}
    for name, B, N, L, P, sc in EXACT_BUCKETS:
        args = dp_bucket(rng, B, N, L, P, P > 1, dev, inactive=0.0)
        kw = dict(N=N, L=L, P=P, **sc)
        bp_k, mr_k = poa_dp_batch(*args, **kw)
        bp_p, mr_p = poa_dp_batch_ref(*args, **kw)
        tb_args = (bp_k, args[1], mr_k, args[6], args[7])
        out_k = poa_tb_batch(*tb_args, N=N, L=L, P=P)
        out_p = poa_tb_batch_ref(*tb_args, N=N, L=L, P=P)
        chain_p = poa_tb_batch_ref(bp_p, args[1], mr_p, args[6], args[7],
                                   N=N, L=L, P=P)
        torch.cuda.synchronize()
        nn = args[4]
        rows = (torch.arange(N + 1, device=dev)[None, :]
                <= nn[:, None])[:, :, None]
        bp_diff = ((bp_k.int() - bp_p.int()).abs() * rows).amax().item()
        mr_diff = (mr_k - mr_p).abs().amax().item()
        tb_diff = max((a.int() - b.int()).abs().amax().item()
                      for a, b in zip(out_k, out_p))
        chain_diff = max((a.int() - b.int()).abs().amax().item()
                         for a, b in zip(out_k, chain_p))
        if bp_diff or mr_diff or tb_diff or chain_diff:
            raise RuntimeError(
                f"exact {name}: kernel != plain (max |diff| bp {bp_diff}, "
                f"max_row {mr_diff}, traceback {tb_diff}, DP+traceback "
                f"chain {chain_diff})")
        dp_ms, dp_call = kernel_ms(lambda: poa_dp_batch(*args, **kw))
        dp_plain = cuda_ms(lambda: poa_dp_batch_ref(*args, **kw))
        tb_ms, tb_call = kernel_ms(lambda: poa_tb_batch(*tb_args, N=N, L=L,
                                                        P=P))
        tb_plain = cuda_ms(lambda: poa_tb_batch_ref(*tb_args, N=N, L=L,
                                                    P=P))
        steps = out_k[2]
        bd, bt = dp_bound(args, N, L, P), tb_bound(steps, N, L)
        log(f"exact {name} bounds: DP {bd['bound_ms']:.4f} ms by "
            f"{bd['bound_by']} ({bd['bytes'] / 1e6:.1f} MB, "
            f"{bd['ops'] / 1e9:.3f} Gop), traceback {bt['bound_ms']:.4f} "
            f"ms by {bt['bound_by']} ({bt['bytes'] / 1e6:.2f} MB); DP "
            + launch_note(N, L, P))
        log(f"exact {name} B={B}: equal (bp rows <= n_nodes, max_row, ti, "
            f"tj, steps; steps mean {steps.float().mean().item():.0f} max "
            f"{int(steps.max())}); DP kernel {dp_ms:.4f} ms ({dp_call:.4f} "
            f"ms a call), plain {dp_plain:.3f} ms; traceback kernel "
            f"{tb_ms:.4f} ms ({tb_call:.4f} ms a call), plain "
            f"{tb_plain:.3f} ms")
        dp[name] = dict(ms=dp_ms, call_ms=dp_call, plain_ms=dp_plain,
                        max_abs_err=max(bp_diff, mr_diff),
                        bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                        **dp_versions(name, args, kw, (bp_p, mr_p),
                                      baselines.get("poa_dp")))
        tb[name] = dict(ms=tb_ms, call_ms=tb_call, plain_ms=tb_plain,
                        max_abs_err=max(tb_diff, chain_diff),
                        bound_ms=bt["bound_ms"], bound_by=bt["bound_by"],
                        **tb_versions(name, tb_args, N, L, P, out_p,
                                      baselines.get("poa_tb")))
    return dp, tb


# -- 4./5. a real class-0 tile: consensus kernel, tile vs spec ---------------

def random_tile(rng, B, K, L, tlen, err):
    """Windows of 3..K-1 noisy copies of a random truth (NW arms framed
    by the J/O markers 4/5, LOV heads, ROV tails), one pool row per
    arm, weights 1-3.  Returns the tile inputs and each window's arms."""
    pool, plen, specs = [], [], []
    idx = np.full((B, K), -1, np.int32)
    amode = np.zeros((B, K), np.int8)
    aw = np.zeros((B, K), np.int32)
    narms = np.zeros(B, np.int32)
    for b in range(B):
        truth = rng.integers(0, 4, tlen)
        arms = []
        for k in range(int(rng.integers(3, K))):
            r = rng.random(tlen)
            sub = rng.integers(0, 4, tlen)
            s = np.where(r < err * 2 / 3, sub, truth)
            ins = (r >= err * 2 / 3) & (r < err)
            s = np.insert(s, np.nonzero(ins)[0], sub[ins])
            s = s[rng.random(len(s)) >= err / 3].tolist()  # deletions
            md = int(rng.choice([NW, NW, NW, LOV, ROV]))
            if md == NW:
                s = [4] + s + [5]
            elif md == LOV:
                s = [4] + s[:max(1, len(s) // 2)]
            else:
                s = s[len(s) // 2:] + [5]
            s = s[:L]
            w = int(rng.integers(1, 4))
            idx[b, k] = len(pool)
            amode[b, k] = md
            aw[b, k] = w
            row = np.zeros(L, np.int8)
            row[:len(s)] = s
            pool.append(row)
            plen.append(len(s))
            arms.append((s, md, w))
        narms[b] = len(arms)
        specs.append(arms)
    return (np.stack(pool), np.array(plen, np.int32), idx, amode, aw, narms,
            specs)


def spec_consensus(arms):
    """(codes, supports) of the NumPy spec for one window's arms."""
    from hypo_tpu_torch.poa.colpoa_ref import ColPoa
    cp = ColPoa(SCORES["m"], SCORES["n"], SCORES["g"])
    for s, md, w in arms:
        cp.add(s, md, w=w)
    return cp.consensus()


# shape classes of the tile phases (poa.full_runner.CLASSES at full B):
# name, B, L, N, truth length of the random windows, minimum windows
# without overflow held against the spec
TILES = (("class0", 2048, 126, 256, 100, 256),
         ("class1", 256, 510, 1024, 400, 128))


def cons_bound(cargs, N, P) -> dict:
    """Kernel 2's bound on these inputs: per node below n_nodes its real
    predecessor entries (rank and weight, 8 bytes each), count, end flag,
    code and support read once (13 bytes) and about 4 int32 operations
    per predecessor and 4 per node; per window two scalars read and the
    codes, supports (N int32 each) and length written."""
    pred_cnt, nn = cargs[2], cargs[6]
    B = nn.numel()
    rows = torch.arange(N, device=nn.device)[None, :] < nn[:, None]
    n_rows = int(rows.sum())
    n_preds = int(torch.where(rows, pred_cnt.clamp(0, P), 0).sum())
    return bound(8 * n_preds + 13 * n_rows + 8 * B + B * (8 * N + 4),
                 4 * n_preds + 4 * n_rows)


def multi_in_edge_share(cargs, N) -> float:
    """The share of nodes below n_nodes with more than one in-edge."""
    pred_cnt, nn = cargs[2], cargs[6]
    rows = torch.arange(N, device=nn.device)[None, :] < nn[:, None]
    return int((rows & (pred_cnt > 1)).sum()) / max(int(rows.sum()), 1)


def baseline_consensus(lib, cargs, N, P):
    """The first kernel 2 (one thread per window; scores and preds
    scratch in device memory), through its 13-pointer entry."""
    B = cargs[0].shape[0]
    dev = cargs[0].device
    out = [torch.empty((B, N), dtype=torch.int32, device=dev)
           for _ in range(4)]
    cons_len = torch.empty((B,), dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hypo_heaviest_bundle.restype = ci
    lib.hypo_heaviest_bundle.argtypes = [vp] * 13 + [ci] * 3 + [vp]
    p = _build.ptr
    rc = lib.hypo_heaviest_bundle(
        *(p(x) for x in cargs), p(out[0]), p(out[1]), p(cons_len),
        p(out[2]), p(out[3]), B, N, P,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(lib, rc, "baseline heaviest_bundle launch")
    return out[0], out[1], cons_len


def cons_versions(name, cargs, N, P, ref, baseline) -> dict:
    """Kernel 2 against the baseline kernel on the same inputs, in turns,
    the baseline checked against the plain version's output ``ref``
    first."""
    if baseline is None:
        return {}
    got = baseline_consensus(baseline, cargs, N, P)
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise RuntimeError(f"baseline consensus != plain on {name}")
    return in_turns(f"consensus {name}",
                    lambda: baseline_consensus(baseline, cargs, N, P),
                    lambda: heaviest_bundle(*cargs, N=N, P=P))


def matched_from_exact(ti, tj, steps, active, L):
    """matched [B, L] rebuilt from exact mode's emitter: each step that
    consumed a query base j records its rank (or -1) at j."""
    B, S = ti.shape
    t = torch.arange(S, device=ti.device)[None, :]
    ok = (t < steps[:, None]) & (tj >= 0)
    out = torch.full((B, L + 1), -1, dtype=torch.int32, device=ti.device)
    out.scatter_(1, torch.where(ok, tj.long(), L), ti.int())
    return torch.where(active[:, None], out[:, :L], -1)


def phase_tile_walk(name, calls, N, L, P) -> dict:
    """Kernel 3's tile emitter against its plain version (the lockstep
    walk the tile program ran before) on the recorded arm steps' inputs,
    and against matched rebuilt from the exact emitter on the same
    inputs; times at the third arm step, the first with every window
    active and a graph of two arms."""
    kw = dict(N=N, L=L, P=P)
    kmax = len(calls)
    checked = sorted({0, 1, min(2, kmax - 1), kmax // 2, kmax - 1})
    err = 0
    for k in checked:
        args = calls[k]
        bp, pred_rows, arm_len, mode, max_row, active = args
        out_k = poa_tb_matched(*args, **kw)
        out_p = poa_tb_matched_ref(*args, **kw)
        rebuilt = matched_from_exact(
            *poa_tb_batch(bp, pred_rows, max_row, arm_len, mode, **kw),
            active, L)
        torch.cuda.synchronize()
        diff = max((out_k - out_p).abs().amax().item(),
                   (rebuilt - out_p).abs().amax().item())
        if diff:
            raise RuntimeError(f"{name} tile walk, arm step {k}: kernel != "
                               f"plain (max |diff| {diff}, matched and "
                               f"matched rebuilt from exact mode's emitter)")
        err = max(err, diff)
    args = calls[min(2, kmax - 1)]
    bp, pred_rows, arm_len, mode, max_row, active = args
    steps = poa_tb_batch(bp, pred_rows, max_row, arm_len, mode, **kw)[2]
    steps = torch.where(active, steps, 0)
    ms, call_ms = kernel_ms(lambda: poa_tb_matched(*args, **kw))
    plain_ms = cuda_ms(lambda: poa_tb_matched_ref(*args, **kw))
    bd = tb_bound(steps, N, L, matched=True)
    log(f"tile walk {name} B={bp.shape[0]} N={N} L={L} P={P}: equal at arm "
        f"steps {checked} of {kmax} (matched, and rebuilt from exact mode's "
        f"emitter); at step {min(2, kmax - 1)} ({int(active.sum())} active, "
        f"walk steps mean {steps.float().mean().item():.0f} max "
        f"{int(steps.max())}): kernel {ms:.4f} ms ({call_ms:.4f} ms a "
        f"call), plain (the lockstep loop) {plain_ms:.3f} ms; bound "
        f"{bd['bound_ms']:.5f} ms by "
        f"{bd['bound_by']} ({bd['bytes'] / 1e6:.2f} MB): "
        f"{bd['bound_ms'] / ms:.4f} of it")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=bd["bound_ms"], bound_by=bd["bound_by"])


def rank_bound(st, N, P, leaves) -> dict:
    """Kernel 4's bound on this state for ``leaves``: per window its two
    counts (8 bytes); per valid column its position and NCODES col_node
    entries (28 bytes); per valid node its column and each other input an
    asked leaf reads (code, support, predecessor count, out count: 4
    bytes each; P predecessor ids, and P weights for pred_w_r); every
    asked leaf written whole (int32, is_end_r one byte).  Operations:
    about 12 a column and 14 a node (counting and placing), 3 an output
    element."""
    B = st.n_nodes.numel()
    cols, nodes = int(st.n_cols.sum()), int(st.n_nodes.sum())
    lv = set(leaves)
    per_node = 4 + 4 * len(lv & {"node_code_r", "node_sup_r", "pred_cnt_r",
                                 "is_end_r"})
    pred = set(cuda_rank.PRED_FIELDS)
    per_node += 4 * P * (bool(lv & pred) + ("pred_w_r" in lv))
    elems = sum(N * P if f in pred else N for f in lv)
    written = B * sum((N * P if f in pred else N)
                      * (1 if f == "is_end_r" else 4) for f in lv)
    return bound(8 * B + 28 * cols + per_node * nodes + written,
                 12 * cols + 14 * nodes + 3 * B * elems)


def merge_bound(before, after, args, L, P) -> dict:
    """Kernel 5's bound on this arm step: per window its flags, counts and
    weight (18 bytes); per base of a window the merge reaches (active,
    an arm, no earlier overflow) its code and alignment (8 bytes), for a
    matched base its rank's column, col_node entry and position (12), for
    an edge its node's P predecessor ids and count (4P + 4); per valid
    column of a window whose merge applies its position read and written
    (8), per applied base its node's support and per applied edge its
    weight read and written (8 each); per new node its code, column and
    col_node entry (12), per new column its position (4), per new edge
    its predecessor id and both counts read and written (20); n_nodes and
    n_cols written (8) or ovf (1).  Operations: about 40 + 2P a reached
    base (four running scans, the slot search) and 3 a column."""
    _ncr, matched, _arm, al, _w, active = args
    reach = active & (al > 0) & ~before.ovf
    applied = reach & ~after.ovf
    j = torch.arange(L, device=al.device)[None, :]
    based = j < al[:, None]
    n = lambda x: int(x.sum())  # noqa: E731
    bases = n(based & reach[:, None])
    matched_b = n(based & reach[:, None] & (matched >= 0)
                  & (before.n_nodes > 0)[:, None])
    edges = n(based & (j >= 1) & reach[:, None])
    a_bases = n(based & applied[:, None])
    a_edges = n(based & (j >= 1) & applied[:, None])
    cols = n(torch.where(applied, before.n_cols, 0))
    new = [n(getattr(after, f) - getattr(before, f))
           for f in ("n_nodes", "n_cols", "pred_cnt")]
    nbytes = (18 * al.numel() + 8 * bases + 12 * matched_b
              + (4 * P + 4) * edges + 8 * cols + 8 * a_bases + 8 * a_edges
              + 12 * new[0] + 4 * new[1] + 20 * new[2] + 8 * n(applied)
              + n(reach & ~applied))
    return bound(nbytes, (40 + 2 * P) * bases + 3 * cols)


def leaf_diff(a, b) -> int:
    """max |a - b| over one leaf's two tensors (bool as 0 / 1)."""
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def merge_call(lib, st, args, N, L, P):
    """Kernel 5 of library ``lib`` (an earlier source's) on ``st`` in
    place, through its C entry hypo_poa_merge."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    p = _build.ptr
    lib.hypo_poa_merge.restype = ci
    lib.hypo_poa_merge.argtypes = [vp] * 18 + [ci] * 4 + [vp]
    rc = lib.hypo_poa_merge(*[p(x) for x in st], *[p(x) for x in args],
                            args[0].shape[0], N, L, P,
                            ctypes.c_void_p(
                                torch.cuda.current_stream().cuda_stream))
    _build.check(lib, rc, "poa_merge launch")


def merge_versions(name, args, want, N, L, P, restore, work,
                   baseline) -> dict:
    """Kernel 5 against an earlier kernel 5 (``baseline``, its C entry
    hypo_poa_merge) at this step, in turns, each call on the restored
    state; the baseline checked against the plain version first."""
    if baseline is None:
        return {}
    restore()
    merge_call(baseline, work, args, N, L, P)
    err = max(leaf_diff(a, b) for a, b in zip(work, want))
    if err:
        raise RuntimeError(f"baseline merge != plain on {name}: {err}")

    def old():
        restore()
        merge_call(baseline, work, args, N, L, P)

    def new():
        restore()
        merge_arm(work, *args, N=N, L=L, P=P)

    return in_turns(f"merge {name}", old, new, only="poa_merge_kernel",
                    less=restore)


def baseline_rank(lib, st, N, leaves):
    """Kernel 4 of library ``lib`` (an earlier source's) through its C
    entry hypo_poa_rank: the RankArrays of ``leaves`` (others None), in
    new tensors, as rank_arrays makes them."""
    B, P = st.pred_nd.shape[0], st.pred_nd.shape[2]
    outs = [torch.empty(cuda_rank.leaf_shape(f, B, N, P),
                        dtype=cuda_rank.leaf_dtype(f),
                        device=st.n_nodes.device) if f in leaves else None
            for f in cuda_rank.FIELDS]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hypo_poa_rank.restype = ci
    lib.hypo_poa_rank.argtypes = [vp] * 22 + [ci] * 4 + [vp]
    p = lambda t: None if t is None else _build.ptr(t)  # noqa: E731
    rc = lib.hypo_poa_rank(
        *map(p, st[:11]), *map(p, outs), B, N, P,
        sum(cuda_rank.LEAF_BITS[f] for f in leaves),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(lib, rc, "baseline poa_rank launch")
    return TF.RankArrays(*outs)


def rank_versions(what, st, N, leaves, want, baseline) -> dict:
    """Kernel 4 against an earlier kernel 4 (``baseline``) on ``st`` for
    ``leaves``, in turns; the baseline checked against the plain
    version's RankArrays ``want`` first."""
    if baseline is None:
        return {}
    got = baseline_rank(baseline, st, N, leaves)
    err = max(leaf_diff(getattr(got, f), getattr(want, f)) for f in leaves)
    if err:
        raise RuntimeError(f"baseline rank != plain on {what}: {err}")
    return in_turns(what, lambda: baseline_rank(baseline, st, N, leaves),
                    lambda: rank_arrays(st, N, leaves))


def tile_tensors(arrays, dev):
    """A tile's arm arrays (pool, plen, idx, amode, aw, narms) on ``dev``
    as the tile program's buffers hold them."""
    dt = (np.int8, np.int32, np.int32, np.int8, np.int32, np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, d)).to(dev)
                 for x, d in zip(arrays[:6], dt))


def ragged_rows(arrays):
    """A tile's arm arrays with the ragged rows a tile may hold: every
    7th window with no arm (narms 0, idx -1), every 5th from window 1
    with three arms or more a -1 at arm 1, every 6th from window 2 pool
    rows set past its narms."""
    pool, plen, idx, amode, aw, narms = arrays[:6]
    idx, narms = np.array(idx), np.array(narms)
    B, K = idx.shape
    idx[::7] = -1
    narms[::7] = 0
    hole = [b for b in range(1, B, 5) if narms[b] >= 3]
    idx[hole, 1] = -1
    rng = np.random.default_rng(7)
    for b in range(2, B, 6):
        if b % 7:
            idx[b, narms[b]:] = rng.integers(0, len(pool), K - narms[b])
    return pool, plen, idx, amode, aw, narms


def head_diff(got, want) -> int:
    """max |diff| over the step head's outputs and rank leaves."""
    return max([leaf_diff(getattr(got, f), getattr(want, f))
                for f in TF.StepHead._fields[:-1]]
               + [leaf_diff(getattr(got.ra, f), getattr(want.ra, f))
                  for f in STEP_LEAVES])


def head_checks(name, states, arrays, N, L) -> int:
    """The step head against its plain version at steps 0, 1, 2, the
    middle one and the last of a tile (``states``: the state before each
    arm step, then the final one; ``arrays`` the tile's arm arrays), and
    on its ragged rows at step 1, the last and the one after; raises on
    a difference; returns how many steps were compared."""
    dev = states[0].n_nodes.device
    B, P = states[0].pred_nd.shape[0], states[0].pred_nd.shape[2]
    kmax = len(states) - 1
    tiles = {"tile": tile_tensors(arrays, dev),
             "ragged": tile_tensors(ragged_rows(arrays), dev)}
    calls = [("tile", k) for k in sorted({0, 1, 2, kmax // 2, kmax - 1})
             if 0 <= k < kmax]
    calls += [("ragged", k) for k in sorted({1, kmax - 1, kmax})
              if 0 <= k < min(kmax + 1, arrays[2].shape[1])]
    out = TF.head_buffers(B, N, L, P, dev)
    for rows, k in calls:
        st = states[min(k, kmax)]
        kt = torch.tensor([k], dtype=torch.int32, device=dev)
        step_head(st, *tiles[rows], kt, out, N=N)
        err = head_diff(out, TF._step_head_batch(st, *tiles[rows], kt, N=N))
        if err or int(kt) != k:
            raise RuntimeError(f"{name}: step head != plain at step {k} "
                               f"({rows} rows; max |diff| {err})")
    log(f"step head {name} B={B} N={N} L={L}: equal to its plain version "
        f"at steps {[k for r, k in calls if r == 'tile']} and on ragged "
        f"rows at steps {[k for r, k in calls if r == 'ragged']} "
        f"({int(tiles['ragged'][5].eq(0).sum())} windows with no arm)")
    return len(calls)


def old_fetch_rank(st, t, k, N):
    """The arm step's head before the step head: _Block.step's fetch of
    arm k as torch ops, act and nn_eff, and kernel 4 (rank_arrays)."""
    pool, plen, idx, amode, aw, narms = t
    col = k.long().expand(idx.shape[0], 1)
    rows = idx.gather(1, col)[:, 0]
    active = (k < narms) & (rows >= 0)
    rr = rows.clamp(min=0).long()
    al = torch.where(active, plen[rr], 0)
    act = active & (al > 0) & (st.n_nodes > 0)
    return (pool[rr].to(torch.int32), al,
            amode.gather(1, col)[:, 0].to(torch.int32),
            aw.gather(1, col)[:, 0], active, act,
            torch.where(act, st.n_nodes, 0),
            rank_arrays(st, N, STEP_LEAVES))


def head_bound(st, N, P, L) -> dict:
    """The step head's bound: kernel 4's with the step's leaves
    (rank_bound) plus the fetch's bytes, per window its idx entry,
    narms, plen and aw entries (4 bytes each), its amode entry (1) and
    its pool row's L bytes read, and its arm (4L bytes), arm_len, mode,
    w, nn_eff (4 each), active and act (1 each) written."""
    bd = rank_bound(st, N, P, STEP_LEAVES)
    B = st.n_nodes.numel()
    return bound(bd["bytes"] + B * (17 + L + 4 * L + 18), bd["ops"])


def head_times(name, st, arrays, k, N, L, P) -> dict:
    """The step head at step k of a tile: its device and call times
    against its bound, its plain version's time, and in turns with the
    step's fetch as torch ops plus kernel 4 (old_fetch_rank)."""
    dev = st.n_nodes.device
    B = st.n_nodes.numel()
    t = tile_tensors(arrays, dev)
    kt = torch.tensor([k], dtype=torch.int32, device=dev)
    out = TF.head_buffers(B, N, L, P, dev)
    plain_ms = cuda_ms(lambda: TF._step_head_batch(st, *t, kt, N=N))
    v = in_turns(f"step head {name} at step {k} (baseline: the fetch's "
                 f"torch ops and kernel 4)",
                 lambda: old_fetch_rank(st, t, kt, N),
                 lambda: step_head(st, *t, kt, out, N=N))
    bd = head_bound(st, N, P, L)
    ms = v["new_ms"]
    log(f"step head {name} B={B} N={N} L={L} P={P} at step {k}: "
        f"{ms:.4f} ms ({v['new_call_ms']:.4f} ms a call), the fetch's torch "
        f"ops and kernel 4 {v['baseline_ms']:.4f} ms "
        f"({v['baseline_call_ms']:.4f} ms a call), plain {plain_ms:.3f} "
        f"ms; bound {bd['bound_ms']:.5f} ms by {bd['bound_by']} "
        f"({bd['bytes'] / 1e6:.2f} MB): {bd['bound_ms'] / ms:.4f} of it")
    return dict(ms=ms, call_ms=v["new_call_ms"], plain_ms=plain_ms,
                max_abs_err=0, bound_ms=bd["bound_ms"],
                bound_by=bd["bound_by"], fetch_rank_ms=v["baseline_ms"],
                fetch_rank_call_ms=v["baseline_call_ms"])


def phase_rank_merge(name, steps, final, N, L, P, arrays, baseline=None,
                     rank_baseline=None) -> tuple:
    """Kernels 4 (rank) and 5 (merge) against their plain versions
    (device_full._rank_arrays_batch, _merge_step) on the state before
    every arm step of the tile, recorded as the eager arm steps ran, and
    on its final state (the finish's rank): kernel 4 for all its leaves
    and for the arm step's and the finish's subsets, kernel 5 on a copy
    of each state (it works in place), every leaf.  Times at the third
    arm step (kernel 4's step and all-leaf forms, kernel 5) and on the
    final state (the finish's form), each form in turns with the
    ``rank_baseline`` library of an earlier kernel 4 when given.  The
    step head against its plain version (head_checks, on the tile's arm
    ``arrays``) and timed at the third step (head_times).  Kernel 5
    restores its copy of the state before each call (12 device copies):
    its device time counts its kernel alone, its call time is the pair's
    less the restore's; there it is also timed against the ``baseline``
    library of an earlier kernel 5 in turns.  Returns (kernel 4's
    times, kernel 5's, the head's)."""
    kw = dict(N=N, L=L, P=P)
    err_r = err_m = 0
    for st, args in steps + [(final, None)]:
        want = TF._rank_arrays_batch(st, N)
        for leaves in (cuda_rank.FIELDS, STEP_LEAVES, CONS_LEAVES):
            got = rank_arrays(st, N, leaves)
            err_r = max([err_r] + [leaf_diff(a, b) for f, a, b in zip(
                cuda_rank.FIELDS, got, want) if f in leaves])
        if args is not None:
            want = TF._merge_step(st, *args, **kw)
            got = merge_arm(TF.clone_state(st), *args, **kw)
            err_m = max([err_m] + [leaf_diff(a, b)
                                   for a, b in zip(got, want)])
    if err_r or err_m:
        raise RuntimeError(f"{name}: rank kernel != plain (max |diff| "
                           f"{err_r}) or merge kernel != plain ({err_m})")
    at = min(2, len(steps) - 1)
    st, args = steps[at]
    B = st.n_nodes.numel()
    shape = cuda_rank.launch_shape(B, N)
    log(f"rank {name} launch: {shape.warps} warp(s) a window, "
        f"{shape.windows} window(s) a block: {shape.threads} threads, "
        f"{shape.smem} B shared memory a block")
    head_checks(name, [s for s, _a in steps] + [final], arrays, N, L)
    head = {name: head_times(name, st, arrays, at, N, L, P)}
    rank = {}
    for label, state, leaves in (("step", st, STEP_LEAVES),
                                 ("all", st, cuda_rank.FIELDS),
                                 ("finish", final, CONS_LEAVES)):
        ms, call_ms = kernel_ms(lambda: rank_arrays(state, N, leaves))
        want = TF._rank_arrays_batch(state, N)
        plain_ms = cuda_ms(lambda: TF._rank_arrays_batch(state, N))
        bd = rank_bound(state, N, P, leaves)
        rank[f"{name}_{label}"] = dict(
            ms=ms, call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err_r,
            bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
            launch=shape._asdict())
        log(f"rank {name} {label} ({len(leaves)} leaves) "
            f"B={B} N={N} P={P}: equal at every arm step "
            f"and on the final state; kernel {ms:.4f} ms "
            f"({call_ms:.4f} ms a call), plain {plain_ms:.3f} ms; bound "
            f"{bd['bound_ms']:.5f} ms by {bd['bound_by']} "
            f"({bd['bytes'] / 1e6:.2f} MB): {bd['bound_ms'] / ms:.4f} of it")
        versions = rank_versions(f"rank {name} {label}", state, N, leaves,
                                 want, rank_baseline)
        if versions:
            rank[f"{name}_{label}"].update(versions)
            log(f"rank {name} {label} share of the bound: baseline "
                f"{bd['bound_ms'] / versions['baseline_ms']:.4f}, this "
                f"kernel {bd['bound_ms'] / versions['new_ms']:.4f}")
    work = TF.clone_state(st)

    def restore():
        for dst, src in zip(work, st):
            dst.copy_(src)

    def merge_once():
        restore()
        merge_arm(work, *args, **kw)

    ms, pair_ms = kernel_ms(merge_once, only="poa_merge_kernel",
                            less=restore)
    restore_ms = cuda_ms(restore, inner=KERNEL_INNER)
    plain_ms = cuda_ms(lambda: TF._merge_step(st, *args, **kw))
    want = TF._merge_step(st, *args, **kw)
    bd = merge_bound(st, want, args, L, P)
    shape = cuda_merge.launch_shape(N, L)
    merge = {name: dict(ms=ms, call_ms=pair_ms - restore_ms,
                        plain_ms=plain_ms, max_abs_err=err_m,
                        bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                        launch=shape._asdict())}
    log(f"merge {name} B={st.n_nodes.numel()} N={N} L={L} P={P}: equal at "
        f"all {len(steps)} arm steps; at step {at} ({int(args[5].sum())} "
        f"active): kernel {ms:.4f} ms (a call with the restore "
        f"{pair_ms:.4f} ms, the restore alone {restore_ms:.4f} ms), plain "
        f"{plain_ms:.3f} ms; bound {bd['bound_ms']:.5f} ms by "
        f"{bd['bound_by']} ({bd['bytes'] / 1e6:.2f} MB): "
        f"{bd['bound_ms'] / ms:.4f} of it; launch {shape.per} bases a "
        f"thread, {shape.warps} warp(s) a window, {shape.windows} "
        f"window(s) a block: {shape.threads} threads, {shape.smem} B "
        f"shared memory a block")
    versions = merge_versions(name, args, want, N, L, P, restore, work,
                              baseline)
    if versions:
        merge[name].update(versions)
        log(f"merge {name} share of the bound: baseline "
            f"{bd['bound_ms'] / versions['baseline_ms']:.4f}, this kernel "
            f"{bd['bound_ms'] / versions['new_ms']:.4f}")
    return rank, merge, head


def phase_tile(rng, dev, name, B, L, N, tlen, min_spec,
               baseline=None, merge_baseline=None,
               rank_baseline=None) -> dict:
    K, P = 16, 8
    t0 = time.time()
    pool, plen, idx, amode, aw, narms, specs = random_tile(
        rng, B, K, L, tlen=tlen, err=0.04)
    log(f"{name} tile: {B} windows, {len(pool)} arms, L={L} N={N} (made in "
        f"{time.time() - t0:.1f} s)")
    steps = dict(N=N, L=L, P=P, device=dev, **SCORES)
    # the inputs of every arm step's walk, for the tile-walk phase
    calls = []
    walk = TF._traceback_matched_batch

    def record(bp, pred_rows, arm_len, mode, max_row, *, active, **kw):
        calls.append((bp, pred_rows, arm_len, mode, max_row, active))
        return walk(bp, pred_rows, arm_len, mode, max_row, active=active,
                    **kw)

    # the state before every arm step and the merge's other inputs, for
    # the rank and merge phase (the merge updates the state in place)
    states = []

    def record_merge(st, *args, **kw):
        states.append((TF.clone_state(st), args))
        return merge_arm(st, *args, **kw)

    TF._traceback_matched_batch = record
    TF.merge_arm = record_merge
    far = TF.poa_dp_batch = FarRows(poa_dp_batch)
    t0 = time.time()
    try:
        st = TF.run_arm_steps(pool, plen, idx, amode, aw, narms, **steps)
        torch.cuda.synchronize()
    finally:
        TF._traceback_matched_batch = walk
        TF.merge_arm = merge_arm
        TF.poa_dp_batch = poa_dp_batch
    log(f"{name} tile arm steps ({int(narms.max())}): "
        f"{time.time() - t0:.2f} s; nodes max {int(st.n_nodes.max())}")
    tb = phase_tile_walk(name, calls, N, L, P)
    del calls
    rank_merge = phase_rank_merge(name, states, st, N, L, P,
                                  (pool, plen, idx, amode, aw, narms),
                                  baseline=merge_baseline,
                                  rank_baseline=rank_baseline)
    del states

    # 4. consensus kernel vs plain on the final graphs' rank arrays
    ra = TF._rank_arrays_batch(st, N)
    cargs = (ra.pred_ranks, ra.pred_w_r, ra.pred_cnt_r, ra.is_end_r,
             ra.node_code_r, ra.node_sup_r, st.n_nodes,
             ra.rank_of[:, 0].contiguous())
    out_k = heaviest_bundle(*cargs, N=N, P=P)
    *out_p, rounds = TF._consensus_wavefront(*cargs, N=N, P=P,
                                             with_rounds=True)
    torch.cuda.synchronize()
    err = max((a - b).abs().amax().item() for a, b in zip(out_k, out_p))
    if err:
        raise RuntimeError(f"consensus kernel != plain on {name}: max diff "
                           f"{err}")
    ms, call_ms = kernel_ms(lambda: heaviest_bundle(*cargs, N=N, P=P))
    plain_ms = cuda_ms(lambda: TF._consensus_wavefront(*cargs, N=N, P=P))
    bd = cons_bound(cargs, N, P)
    log(f"consensus {name} B={B} N={N} P={P}: equal (codes, supports, "
        f"lengths); kernel {ms:.4f} ms ({call_ms:.4f} ms a call), plain "
        f"{plain_ms:.3f} ms; bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['bytes'] / 1e6:.1f}"
        f" MB): {bd['bound_ms'] / ms:.3f} of it; "
        f"{cuda_consensus.smem_bytes(N, P)} B shared memory a window, "
        f"{cuda_consensus.occupancy(N, P)} windows resident an SM; "
        f"branch completion in {int((rounds > 0).sum())} of {B} windows, "
        f"at most {int(rounds.max())} rounds in one; nodes mean "
        f"{st.n_nodes.float().mean().item():.1f}, "
        f"{multi_in_edge_share(cargs, N):.3f} of them with more than one "
        f"in-edge")
    versions = cons_versions(name, cargs, N, P, out_p, baseline)
    if versions:
        log(f"consensus {name} share of the bound: baseline "
            f"{bd['bound_ms'] / versions['baseline_ms']:.4f}, this kernel "
            f"{bd['bound_ms'] / versions['new_ms']:.4f}")

    # 5. the tile program (its graphs captured at this first tile) vs
    # the eager arm steps and finish, and vs the NumPy spec
    log(far.line(name))
    tile = TF.build_tile_program(N=N, L=L, K=K, P=P, B=B, A=len(pool),
                                 devices=dev, **SCORES)
    targs = (pool, plen, idx, amode, aw, narms, np.zeros(B, np.int32))
    packed_t = tile(*targs)
    eager = TF._finish_packed(st, torch.zeros(B, dtype=torch.int32,
                                              device=dev), N=N, P=P)
    if not torch.equal(packed_t, eager):
        raise RuntimeError(f"{name}: the tile program's graphs != the eager "
                           f"arm steps and finish")
    packed = packed_t.cpu().numpy()
    cc, cs, cl = (x.cpu().numpy() for x in TF._consensus_batch(st, N=N, P=P))
    nib = packed[:, :N // 2].view(np.uint8)
    codes = np.stack([nib & 0xF, nib >> 4], axis=2).reshape(B, N)
    clen = (packed[:, N // 2].view(np.uint8).astype(np.int64)
            | (packed[:, N // 2 + 1].view(np.uint8).astype(np.int64) << 8))
    ovf = packed[:, N // 2 + 2] != 0
    ok = np.nonzero(~ovf)[0]
    if len(ok) < min_spec:
        raise RuntimeError(f"{name}: only {len(ok)} windows without "
                           f"overflow")
    t0 = time.time()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(os.cpu_count() or 1) as workers:
        wants = workers.map(spec_consensus, [specs[b] for b in ok],
                            chunksize=4)
    for b, (want, want_sup) in zip(ok, wants):
        if (codes[b, :clen[b]].tolist() != want
                or cc[b, :cl[b]].tolist() != want
                or cs[b, :cl[b]].tolist() != want_sup):
            raise RuntimeError(f"{name} tile window {b} != ColPoa spec")
    log(f"{name} tile vs ColPoa: all {len(ok)} windows without overflow "
        f"equal ({int(ovf.sum())} of {B} overflowed; spec "
        f"{time.time() - t0:.1f} s)")
    launches = launch_counts()
    log(f"launch counters so far: {launches} (kernel 3's tile emitter "
        f"{poa_tb_matched.launches})")
    if min(launches.values()) <= 0 or poa_tb_matched.launches <= 0:
        raise RuntimeError("a kernel was never launched")
    graphs = phase_graph(rng, name, tile, targs, N, L, P, dev)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err,
                tile=tile,
                targs=targs, bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                tb=tb, rank_merge=rank_merge, graphs=graphs, **versions)


def phase_graph(rng, name, tile, targs, N, L, P, dev) -> dict:
    """5b. The tile program's graphs against eager launches on three
    tiles of this class dispatched back to back before any readback:
    the phase's tile; its rows rolled by B // 3 with two arms fewer a
    window (at least one); its rows reversed with curation thresholds
    0-2.  Each output must equal run_tile_eager's (run_arm_steps then
    _finish_packed) on the same tile; the first also equals ColPoa
    (phase 5).  Logs the capture's time and graph memory
    (torch.cuda.memory_reserved before and after it) and the host's
    launch calls in one tile, eager and through the graphs."""
    from hypo_tpu_torch.tools.profile_device import host_launches
    pool, plen, idx, amode, aw, narms, th = targs
    B, K = idx.shape
    roll = np.roll(np.arange(B), B // 3)
    fewer = np.maximum(narms[roll] - 2, 1).astype(np.int32)
    idx2 = idx[roll]
    idx2[np.arange(K)[None, :] >= fewer[:, None]] = -1
    rev = np.arange(B)[::-1]
    tiles = (targs,
             (pool, plen, idx2, amode[roll], aw[roll], fewer, th[roll]),
             (pool, plen, idx[rev], amode[rev], aw[rev], narms[rev],
              rng.integers(0, 3, B).astype(np.int32)))
    keep = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [tile(*t, keep=keep) for t in tiles]
    issue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kw = dict(N=N, L=L, P=P, device=dev, **SCORES)
    for i, (t, out) in enumerate(zip(tiles, outs)):
        want = TF.run_tile_eager(*t, **kw)
        if not torch.equal(out, want):
            raise RuntimeError(f"{name} graph tile {i} != eager tile")
    cap = tile.blocks[0].capture_stats
    launches = {"eager": host_launches(
        lambda: TF.run_tile_eager(*targs, **kw), dev),
        "graphs": host_launches(lambda: tile(*targs), dev)}
    log(f"{name} graphs: 3 tiles (arm steps {[int(t[5].max()) for t in tiles]}"
        f") dispatched back to back equal the eager tiles; issue "
        f"{issue:.4f} s, to the device's end {wall:.4f} s; capture "
        f"{cap['seconds']:.3f} s, memory reserved "
        f"{cap['reserved_before'] / 2**20:.0f} -> "
        f"{cap['reserved_after'] / 2**20:.0f} MiB; host launch calls in one "
        f"tile: eager {sum(launches['eager'].values())} "
        f"{json.dumps(launches['eager'])}, graphs "
        f"{sum(launches['graphs'].values())} "
        f"{json.dumps(launches['graphs'])}")
    return dict(capture_s=cap["seconds"],
                graph_mib=(cap["reserved_after"] - cap["reserved_before"])
                / 2**20, host_launches=launches)


def phase_profile(tile, targs, N, L, P, dev) -> None:
    """Where one class-0 tile's time goes, all in this one run: (a) the
    eager tile (run_tile_eager) with a synchronize around every call of
    its parts; (b) the eager tile and the tile program's graph tile,
    each unprofiled; (c) the graph tile under torch.profiler (CUDA
    activity only): device kernels and copies, their summed time, and
    the device's busy share (union of their intervals over the traced
    wall)."""
    names = ("rank_arrays", "poa_dp_batch", "_traceback_matched_batch",
             "merge_arm", "heaviest_bundle")
    orig = {n: getattr(TF, n) for n in names}
    spent = {n: [0.0, 0] for n in names}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name][0] += time.perf_counter() - t0
            spent[name][1] += 1
            return out
        return call

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def eager():
        return TF.run_tile_eager(*targs, N=N, L=L, P=P, device=dev,
                                 **SCORES)

    def graphs():
        return tile(*targs)

    for n in names:
        setattr(TF, n, timed(n, orig[n]))
    try:
        inst = wall(eager)
    finally:
        for n, fn in orig.items():
            setattr(TF, n, fn)
    rest = inst - sum(s for s, _ in spent.values())
    log(f"profile: eager tile with a sync around each step {inst:.3f} s = "
        + ", ".join(f"{n.strip('_')} {s:.3f} s ({c} calls)"
                    for n, (s, c) in spent.items())
        + f", other {rest:.3f} s (arm gather, curation, packing)")
    eager_wall, graph_wall = wall(eager), wall(graphs)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = wall(graphs)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"profile: tile unprofiled, eager {eager_wall:.4f} s, graphs "
        f"{graph_wall:.4f} s")
    if not spans:
        log("profile: the profiler saw no device time in the graph tile "
            "(busy share not measured)")
        return
    busy, hi = 0, float("-inf")
    for a, b in spans:
        busy += max(0, b - max(a, hi))
        hi = max(hi, b)
    total = sum(b - a for a, b in spans) / 1e6
    log(f"profile: graph tile traced {traced:.4f} s with {len(spans)} device "
        f"kernels / copies, {total:.4f} s of device time, busy "
        f"{busy / 1e6:.4f} s = {busy / 1e6 / traced:.3f} of the traced wall "
        f"({total / graph_wall:.3f} of the unprofiled wall)")


# -- 6. end to end ------------------------------------------------------------

class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _md5(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.md5(fh.read()).hexdigest()


def simulate(tmp: str, name: str, genome_size: int, hybrid: bool,
             contigs: int = 1, short_cov: int = 30):
    """A hypo_tpu_torch.sim dataset (seed 1, ``short_cov``x short reads,
    in ``contigs`` contigs; hybrid: 25x long reads and short-read dropout
    over [0.30, 0.33) of the genome, the hybrid recipe of SCALE.md) and
    the polishing arguments that read it (polish_args)."""
    sim = os.path.join(tmp, name)
    extra = ["--long-cov", "25", "--dropout", "0.30,0.33"] if hybrid else []
    if contigs > 1:
        extra += ["--num-contigs", str(contigs)]
    t0 = time.time()
    subprocess.run([sys.executable, "-m", "hypo_tpu_torch.sim", "--out", sim,
                    "--genome-size", str(genome_size), "--short-cov",
                    str(short_cov), *extra, "--seed", "1"], cwd=HERE,
                   env=dict(os.environ, PYTHONPATH=HERE), check=True,
                   capture_output=True)
    log(f"sim {name}: {genome_size / 1e6:g} Mbp in {contigs} contig(s), "
        f"{short_cov}x short{', 25x long' if hybrid else ''}: "
        f"{time.time() - t0:.1f} s")
    return sim, polish_args(sim, genome_size, hybrid, short_cov)


def polish_args(sim: str, genome_size: int, hybrid: bool,
                short_cov: int = 30):
    """The polishing arguments that read simulation ``sim`` (``-c`` its
    short-read coverage; ``-B lr.bam`` when hybrid)."""
    common = ["-r", f"{sim}/reads.fq.gz", "-d", f"{sim}/draft.fa",
              "-b", f"{sim}/sr.bam", "-c", str(short_cov), "-s",
              str(genome_size), "-t", str(os.cpu_count() or 1)]
    if hybrid:
        common += ["-B", f"{sim}/lr.bam"]
    return common


def stage_times(text: str):
    """(windows, POA-stage seconds, total seconds) from the Monitor."""
    mp, mt = POA_RE.search(text), TOTAL_RE.search(text)
    return int(mp.group(1)), float(mp.group(2)), float(mt.group(1))


def run_port(argv, no_native: bool = False, device=None, ndev=None,
             polisher=None):
    """``hypo_tpu_torch.cli`` in this process, every kernel launch counter
    set to 0 just before and read just after; ``no_native`` sets
    HYPO_TPU_NO_NATIVE=1 for the run, ``ndev`` HYPO_POA_NDEV; a
    ``device`` (or list of devices) polishes through
    ``pipeline.polish.polish(flags, device)`` instead of cli.run, and a
    ``polisher`` (a pipeline.polish.Polisher subclass) through
    ``polisher(flags, device).polish()``.  Returns (the device runner's
    stats, or {} for --no-device-poa, launches, (windows, POA seconds,
    total seconds), wall seconds); the Polisher stays in
    ``run_port.last``."""
    from hypo_tpu_torch import cli
    from hypo_tpu_torch.pipeline.polish import polish
    for wrappers in COUNTERS.values():
        for w in wrappers:
            w.launches = 0
    buf = io.StringIO()
    old = sys.stderr
    sys.stderr = _Tee(old, buf)
    if no_native:
        os.environ["HYPO_TPU_NO_NATIVE"] = "1"
    if ndev is not None:
        os.environ["HYPO_POA_NDEV"] = str(ndev)
    t0 = time.time()
    try:
        flags = lambda: cli.flags_from_args(  # noqa: E731
            cli.build_parser().parse_args(argv))
        if polisher is not None:
            polisher = polisher(flags(), device)
            polisher.polish()
        elif device is None:
            polisher = cli.run(argv)
        else:
            polisher = polish(flags(), device)
        torch.cuda.synchronize()
    finally:
        sys.stderr = old
        os.environ.pop("HYPO_TPU_NO_NATIVE", None)
        if ndev is not None:
            os.environ.pop("HYPO_POA_NDEV", None)
    wall = time.time() - t0
    launches = launch_counts()
    run_port.last = polisher
    runner = polisher.device_runner      # None for the CLI's host engine
    return (runner.stats if runner is not None else {}, launches,
            stage_times(buf.getvalue()), wall)


def run_host(common, out: str):
    """The port's native host engine (``--no-device-poa``) in a
    subprocess: (md5, stage times)."""
    r = subprocess.run([sys.executable, "-m", "hypo_tpu_torch.cli", *common,
                        "-o", out, "--no-device-poa"], cwd=HERE,
                       env=dict(os.environ, PYTHONPATH=HERE),
                       capture_output=True, text=True, check=True)
    return _md5(out), stage_times(r.stderr)


def check_launches(path: str, launches: dict, kernels) -> None:
    log(f"{path}: kernel launches {launches}")
    for name in kernels:
        if launches[name] <= 0:
            raise RuntimeError(f"{path}: kernel {name} never launched")


def check_qv(what: str, sim: str, out: str) -> None:
    from hypo_tpu_torch.eval_qv import compare
    q0 = compare(f"{sim}/truth.fa", f"{sim}/draft.fa")
    q1 = compare(f"{sim}/truth.fa", out)
    log(f"{what} QV: draft {q0['qv']:.2f} (edit distance "
        f"{q0['edit_distance']}) -> polished {q1['qv']:.2f} "
        f"({q1['edit_distance']})")
    if not q1["edit_distance"] < q0["edit_distance"]:
        raise RuntimeError(f"{what}: polishing did not reduce the edit "
                           f"distance")


def log_times(what: str, times, wall=None) -> None:
    nwin, poa_s, total_s = times
    log(f"{what}: {nwin} windows, POA stage {poa_s:.2f} s "
        f"({nwin / poa_s:.0f} windows/s), total {total_s:.2f} s"
        + (f" (wall {wall:.2f} s)" if wall is not None else ""))


def log_tiles(what: str, stats: dict) -> None:
    log(f"{what} device stats: device windows {stats['full_windows']}, "
        f"tiles {stats['full_dispatches']}, overflows "
        f"{stats['full_overflows']}, host-routed windows "
        f"{stats['host_long_windows'] + stats['host_fallbacks']} (long "
        f"{stats['host_long_windows']}, fallbacks {stats['host_fallbacks']})"
        f", trivial {stats['trivial_windows']}; per class: tiles "
        f"{stats['class_tiles']}, windows {stats['class_windows']}")
    if stats["full_windows"] <= 0:
        raise RuntimeError(f"{what}: no window went through the device")


# md5 of the FASTA that hypo_tpu's host engine (``python -m hypo_tpu.cli
# ... --no-device-poa``) writes from each simulation of this script: the
# tie between the port and the JAX package on the card
PINNED_MD5 = {"sim_4m": "db85bbe32c2b4637f6e6a5e933e5c498",
              "sim_4m_4c": "0ee822b6c4de06d42b6826c98721247c",
              "sim_hybrid": "2989f8d282e631eb5c6307e062eef83d",
              "sim_no_native": "11375dabd37edd4de899aeba20f8d588",
              # -c 8: python -m hypo_tpu.cli ... -c 8 --no-device-poa
              "sim_2m_8x": "c4be59285044e2012ead5ff5cd715189",
              # sim_hybrid with fix_long_align_type on: hypo_tpu's
              # pipeline.polish.Polisher whose runner is
              # HostTileRunner(sp, fix_long_align_type=True) (neither
              # CLI has the option)
              "sim_hybrid_fixlong": "97b8b3b8d3858f8c1f32d809549ac841"}


def same_md5(what: str, sim: str, port: str, host: str,
             key: str = None) -> None:
    """The port's device run and its host engine both write the FASTA
    pinned for ``sim`` (or under ``key``)."""
    pin = PINNED_MD5[key or os.path.basename(sim)]
    log(f"{what} md5: port {port} host engine {host} pinned {pin}")
    if port != pin or host != pin:
        raise RuntimeError(f"{what}: FASTA differs from the pinned md5")


def phase_e2e(tmp: str, genome_size: int = 4_000_000) -> dict:
    from hypo_tpu_torch.native import host_api
    if not host_api.available():
        raise RuntimeError("the native host library did not build/load")
    sim, common = simulate(tmp, "sim_4m", genome_size, hybrid=False)
    out = os.path.join(tmp, "torch_4m.fa")
    stats, launches, times, wall = run_port(
        common + ["-o", out, "--device-poa"])
    md5_host, host_times = run_host(common, os.path.join(tmp, "host_4m.fa"))
    log_times(f"e2e port (--device-poa, {common[-1]} threads)", times, wall)
    log_tiles("e2e port", stats)
    log_times("e2e host engine (--no-device-poa)", host_times)
    check_qv("e2e", sim, out)
    same_md5("e2e", sim, _md5(out), md5_host)
    check_launches("e2e (full mode, 4 Mbp)", launches, FULL_PATH)
    return launches


def phase_exact_e2e(tmp: str, genome_size: int = 1_000_000) -> tuple:
    """Exact mode on a hybrid simulation, then full mode on the same."""
    sim, common = simulate(tmp, "sim_hybrid", genome_size, hybrid=True)
    md5_host, host_times = run_host(common,
                                    os.path.join(tmp, "host_hybrid.fa"))
    out = os.path.join(tmp, "torch_exact.fa")
    # where the POA stage goes: each device call (kernel 1 then kernel 3)
    # timed on the host clock up to a synchronize; the rest is host work.
    # Per (N, L, P) bucket: calls, windows, launches of kernels 1 and 3
    from hypo_tpu_torch.poa import batch
    device_s = [0.0]
    buckets = {}
    orig = batch.poa_dp_tb_batch

    def timed(*a, **k):
        n1, n3 = poa_dp_batch.launches, poa_tb_batch.launches
        t0 = time.perf_counter()
        res = orig(*a, **k)
        torch.cuda.synchronize()
        device_s[0] += time.perf_counter() - t0
        bk = buckets.setdefault((k["N"], k["L"], k["P"]), [0, 0, 0, 0])
        bk[0] += 1
        bk[1] += a[0].shape[0]
        bk[2] += poa_dp_batch.launches - n1
        bk[3] += poa_tb_batch.launches - n3
        return res

    batch.poa_dp_tb_batch = timed
    try:
        stats, launches, times, wall = run_port(
            common + ["-o", out, "--device-poa", "--device-poa-mode",
                      "exact"])
    finally:
        batch.poa_dp_tb_batch = orig
    log_times("exact port (--device-poa-mode exact)", times, wall)
    aligns = stats["device_aligns"]
    log(f"exact port device stats: device rounds {stats['device_rounds']}, "
        f"device aligns {aligns} (of LONG windows {stats['long_aligns']}), "
        f"host fallbacks {stats['host_fallbacks']}")
    host_s = times[1] - device_s[0]
    log(f"exact POA stage {times[1]:.2f} s: device calls {device_s[0]:.2f} s"
        f" ({stats['device_rounds']} calls, kernels 1 + 3 to a sync), the "
        f"rest {host_s:.2f} s ({1e6 * host_s / max(aligns, 1):.0f} us per "
        f"aligned arm: job building, graph extraction, copies, merges)")
    for (N, L, P), (calls, wins, k1, k3) in sorted(buckets.items()):
        log(f"exact bucket N={N} L={L} P={P}: {calls} calls, {wins} "
            f"windows, kernel 1 launches {k1}, kernel 3 launches {k3}")
    log_times("exact host engine (--no-device-poa)", host_times)
    check_qv("exact", sim, out)
    same_md5("exact", sim, _md5(out), md5_host)
    if stats["device_aligns"] <= 0:
        raise RuntimeError("exact: no arm was aligned on the device")
    check_launches("exact (1 Mbp hybrid)", launches, ("poa_dp", "poa_tb"))

    out = os.path.join(tmp, "torch_full_hybrid.fa")
    stats, full_launches, times, wall = run_port(
        common + ["-o", out, "--device-poa"])
    log_times("hybrid full-mode port (--device-poa)", times, wall)
    log_tiles("hybrid full-mode port", stats)
    same_md5("hybrid full mode", sim, _md5(out), md5_host)
    check_launches("full mode (1 Mbp hybrid)", full_launches, FULL_PATH)
    return launches, full_launches


def phase_no_native(tmp: str, genome_size: int = 200_000) -> dict:
    """HYPO_TPU_NO_NATIVE=1: exact mode (pure-Python host stages and
    graphs) against the native host engine; mode full exits before any
    host stage, naming the native libraries it needs."""
    sim, common = simulate(tmp, "sim_no_native", genome_size, hybrid=True)
    md5_host, host_times = run_host(common,
                                    os.path.join(tmp, "host_no_native.fa"))
    out = os.path.join(tmp, "torch_no_native_full.fa")
    try:
        run_port(common + ["-o", out, "--device-poa"], no_native=True)
    except SystemExit as e:
        refusal = str(e)
    else:
        raise RuntimeError("no-native: mode full ran without the native "
                           "libraries")
    log(f"no-native mode full: {refusal}")
    if "libhypo_host, libhypo_poa did not load" not in refusal or \
            os.path.exists(out):
        raise RuntimeError("no-native: mode full's refusal does not name "
                           "both libraries, or it wrote a FASTA")
    out = os.path.join(tmp, "torch_no_native.fa")
    stats, launches, times, wall = run_port(
        common + ["-o", out, "--device-poa", "--device-poa-mode", "exact"],
        no_native=True)
    log_times("no-native port (HYPO_TPU_NO_NATIVE=1, --device-poa-mode "
              "exact)", times, wall)
    log(f"no-native exact device stats: device rounds "
        f"{stats['device_rounds']}, device aligns {stats['device_aligns']} "
        f"(of LONG windows {stats['long_aligns']}), host fallbacks "
        f"{stats['host_fallbacks']}")
    log_times("no-native host engine (native, --no-device-poa)", host_times)
    same_md5("no-native", sim, _md5(out), md5_host)
    check_launches("no-native exact (200 kbp hybrid)", launches,
                   ("poa_dp", "poa_tb"))
    return launches


# -- 9. sharded polish --------------------------------------------------------

def two_ranks(tmp: str, sim: str, common, md5_host: str) -> dict:
    """(b): rank 1 a command-line subprocess started first, rank 0 in
    this process; each rank drives one card (HYPO_POA_NDEV=1)."""
    from hypo_tpu_torch.io.fasta import read_fastx
    from hypo_tpu_torch.parallel.distributed import shard_contigs_contiguous
    two = torch.cuda.device_count() >= 2
    log("two ranks: " + ("rank 0 on cuda:0, rank 1 on the second card "
                         "(CUDA_VISIBLE_DEVICES=1)" if two else
                         "one card, both ranks on cuda:0"))
    ranges = shard_contigs_contiguous(
        [len(s) for _n, s in read_fastx(f"{sim}/draft.fa")], 2)
    out = os.path.join(tmp, "sharded_2rank.fa")
    argv = common + ["-o", out, "--aux-dir", os.path.join(tmp, "aux_2rank"),
                     "--nproc", "2", "--device-poa"]
    env = dict(os.environ, PYTHONPATH=HERE, HYPO_POA_NDEV="1")
    if two:
        env["CUDA_VISIBLE_DEVICES"] = "1"
    rank1_log = os.path.join(tmp, "rank1.log")
    t0 = time.time()
    with open(rank1_log, "w") as fh:
        rank1 = subprocess.Popen(
            [sys.executable, "-m", "hypo_tpu_torch.cli", *argv,
             "--procid", "1"], cwd=HERE, env=env, stdout=fh,
            stderr=subprocess.STDOUT)
    try:
        stats, launches, times, wall = run_port(argv + ["--procid", "0"],
                                                ndev=1)
        rc = rank1.wait(timeout=600)
    finally:
        if rank1.poll() is None:
            rank1.kill()
            rank1.wait()
    wall_both = time.time() - t0
    with open(rank1_log) as fh:
        text1 = fh.read()
    if rc != 0:
        raise RuntimeError(f"rank 1 exited with {rc}:\n{text1[-3000:]}")
    stats1 = json.loads(re.search(r"device POA stats \(full\): (\{.*\})",
                                  text1).group(1))
    for pid, st, tm, w in ((0, stats, times, wall),
                           (1, stats1, stage_times(text1), None)):
        log_times(f"two ranks: rank {pid}, contigs [{ranges[pid][0]}, "
                  f"{ranges[pid][1]})", tm, w)
        log(f"two ranks: rank {pid} device POA stats {json.dumps(st)}")
        if st["full_windows"] <= 0:
            raise RuntimeError(f"rank {pid}: no window on the device")
    log(f"two ranks: wall {wall_both:.2f} s from rank 1's start to both "
        f"ranks' end (rank 1 a new process: its CUDA context and kernel "
        f"loads included)")
    same_md5("two ranks (gathered by rank 0)", sim, _md5(out), md5_host)
    check_launches("two ranks (rank 0, 4 Mbp in 4 contigs)", launches,
                   FULL_PATH)
    return launches


def build_race(tmp: str) -> None:
    """Two processes started together build csrc/poa_dp.cu under one
    fresh name into _build/ and load it: each compiles to its own
    temporary file and renames it into place."""
    name = f"race_{os.getpid()}"
    code = ("import sys; from hypo_tpu_torch import _build; "
            f"lib = _build.load({name!r}, 'hypo_tpu_torch/csrc/poa_dp.cu'); "
            "assert hasattr(lib, 'hypo_poa_dp')")
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=HERE,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for _ in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        so = os.path.join(_build.BUILD_DIR, f"lib{name}.so")
        if os.path.exists(so):
            os.remove(so)
    for p, text in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"concurrent build failed:\n{text[-2000:]}")
    log(f"build race: two processes built and loaded one kernel under one "
        f"name together in {time.time() - t0:.1f} s")


def phase_sharded(tmp: str, genome_size: int = 4_000_000) -> tuple:
    t_phase = time.time()
    from hypo_tpu_torch import entry
    sim, common = simulate(tmp, "sim_4m_4c", genome_size, hybrid=False,
                           contigs=4)
    # (a) the host engine
    md5_host, host_times = run_host(common,
                                    os.path.join(tmp, "host_4m_4c.fa"))
    log_times("sharded: host engine (--no-device-poa)", host_times)
    # (b) two ranks
    ranks = two_ranks(tmp, sim, common, md5_host)
    # (c) one process, tiles split into two device blocks
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", 0), torch.device("cuda", 1)] if n >= 2
            else [torch.device("cuda", 0)] * 2)
    log("split: " + ("tiles over the first two cards" if n >= 2 else
                     "one card: both blocks on cuda:0 (this checks the "
                     "split, not two cards)"))
    out = os.path.join(tmp, "split_2dev.fa")
    stats, split, times, wall = run_port(
        common + ["-o", out, "--aux-dir", os.path.join(tmp, "aux_split"),
                  "--device-poa"], device=devs, ndev=2)
    log_times(f"split over {[str(d) for d in devs]}", times, wall)
    log_tiles("split", stats)
    rows = stats["rows_per_device"]
    balance = max(rows) / max(min(rows), 1)
    log(f"split: rows per device {rows} (max/min {balance:.3f})")
    if len(rows) != 2 or sum(rows) != stats["full_windows"] or balance > 1.5:
        raise RuntimeError(f"split: rows per device {rows} unbalanced or "
                           f"not summing to {stats['full_windows']}")
    same_md5("split over two device blocks", sim, _md5(out), md5_host)
    check_launches("split (4 Mbp in 4 contigs, two device blocks)", split,
                   FULL_PATH)
    # the entry points
    fn, args = entry.entry()
    got = fn(*args)
    ref = poa_dp_batch_ref(*(a.cpu() for a in args), N=128, L=128, P=8,
                           **SCORES)
    err = dp_diff([x.cpu() for x in got], ref, args[4].cpu(), 128)
    log(f"entry(): DP kernel on {args[0].device} vs plain, bp on rows <= "
        f"n_nodes and max_row: max diff {err}")
    if err:
        raise RuntimeError("entry(): DP kernel differs from its plain "
                           "version")
    entry.dryrun_multichip(2, devices=devs)
    build_race(tmp)
    log(f"sharded phase: {time.time() - t_phase:.1f} s "
        f"(card: {smi_line()})")
    return ranks, split


# -- 10. the bench and the profile tool ----------------------------------------

def run_tool(args, what: str) -> tuple:
    """``python -m <args>`` from the repo root, its output printed here;
    returns (stdout, stderr).  Raises if it exits non-zero."""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", *args], cwd=HERE,
                       env=dict(os.environ, PYTHONPATH=HERE),
                       capture_output=True, text=True, timeout=900)
    for line in (r.stderr + r.stdout).splitlines():
        if line.startswith(("[bench]", "[prof]", "{")):
            log(f"{what}: {line}")
    if r.returncode != 0:
        raise RuntimeError(f"{what} exited with {r.returncode}:\n"
                           f"{r.stderr[-3000:]}")
    log(f"{what}: {time.time() - t0:.1f} s")
    return r.stdout, r.stderr


def phase_tools(tmp: str) -> None:
    sim = os.path.join(tmp, "sim_4m")
    _out, err = run_tool(["hypo_tpu_torch.bench", "--sim", sim], "bench")
    sec = json.loads(re.search(r"\[bench\] secondary (\{.*\})",
                               err).group(1))
    pin = PINNED_MD5["sim_4m"]
    md5s = {k: sec[k] for k in ("host_md5", "cold_md5", "warm_md5")}
    log(f"bench md5s {md5s}, pinned {pin}")
    if set(md5s.values()) != {pin}:
        raise RuntimeError("bench: a FASTA differs from the pinned md5")
    out, _err = run_tool(["hypo_tpu_torch.tools.profile_device", "2048",
                          "2"], "profile tool")
    rows = json.loads(out.strip().splitlines()[-1])["rows"]
    if [r["part"] for r in rows][-2:] != ["step (graph)", "tile"] or \
            not all(r.get("equal_to_eager") for r in rows[-2:]):
        raise RuntimeError("profile tool: no graph-replayed step and tile "
                           "equal to the eager step and tile")


# -- 11. class 1 end to end -----------------------------------------------------

def phase_class1(tmp: str, genome_size: int = 2_000_000) -> tuple:
    """A 2 Mbp simulation at 8x short-read coverage, whose weak windows
    reach tile class 1 (low coverage leaves long gaps between solid
    k-mers, so long arms), polished in mode full by the port (every
    kernel launch counted; the class-1 graphs captured at the class's
    first dispatch, mid-run, behind class-0 tiles already queued) and by
    its host engine: both FASTAs equal the pin, at least two class-1
    tiles ran, QV after is above QV before.  Returns (launches, the
    first tile of each class as the runner packed it)."""
    from hypo_tpu_torch.poa.full_runner import FullDeviceRunner
    sim, common = simulate(tmp, "sim_2m_8x", genome_size, hybrid=False,
                           short_cov=8)
    out = os.path.join(tmp, "torch_2m_8x.fa")
    first = {}
    dispatch = FullDeviceRunner._dispatch

    def keep_first(self, ci, scores, arrays):
        if ci not in first:
            first[ci] = tuple(np.array(a) for a in arrays)
        return dispatch(self, ci, scores, arrays)

    FullDeviceRunner._dispatch = keep_first
    try:
        stats, launches, times, wall = run_port(
            common + ["-o", out, "--device-poa"])
    finally:
        FullDeviceRunner._dispatch = dispatch
    runner = run_port.last.device_runner
    md5_host, host_times = run_host(common, os.path.join(tmp,
                                                         "host_2m_8x.fa"))
    log_times("class 1 e2e port (--device-poa, -c 8)", times, wall)
    log_tiles("class 1 e2e port", stats)
    log_times("class 1 e2e host engine (--no-device-poa)", host_times)
    for ci, n in enumerate(stats["class_tiles"]):
        prog = runner._programs[(ci, runner.short_scores)]
        when = "by the warm-up thread" if ci == 0 else "at its first dispatch"
        for d, block in enumerate(prog.blocks or []):
            cap = block.capture_stats
            if cap is None:         # a block that never ran, or off the card
                continue
            log(f"class {ci} ({n} tiles) graphs of block {d}, captured "
                f"{when}: {cap['seconds']:.3f} s, memory reserved "
                f"{cap['reserved_before'] / 2**20:.0f} -> "
                f"{cap['reserved_after'] / 2**20:.0f} MiB")
    if stats["class_tiles"][1] < 2:
        raise RuntimeError(f"class 1 e2e: {stats['class_tiles'][1]} class-1 "
                           f"tiles, at least 2 expected")
    check_qv("class 1 e2e", sim, out)
    same_md5("class 1 e2e", sim, _md5(out), md5_host)
    check_launches("class 1 e2e (full mode, 2 Mbp at 8x)", launches, FULL_PATH)
    return launches, first


# -- 12. poa_full_batch on real tiles ---------------------------------------

def gather_arms(tile):
    """poa_full_batch's inputs from a tile as the runner packed it: arm k
    of window b is pool row idx[b, k] (the pool's int8 codes, plen long),
    none where idx is -1; the tile's weights are dropped (every arm of
    poa_full_batch weighs 1)."""
    pool, plen, idx, amode, _aw, narms = tile[:6]
    ok = idx >= 0
    rows = np.where(ok, idx, 0)
    arms = np.where(ok[:, :, None], pool[rows], 0).astype(np.int8)
    alen = np.where(ok, plen[rows], 0).astype(np.int32)
    return arms, alen, amode.astype(np.int32), narms.astype(np.int32)


class AtStep:
    """Within ``with``, device_full's kernel wrappers wrapped to keep the
    inputs of arm step ``at`` (the rank's, the DP's, the walk's and the
    merge's, the state cloned before that merge) and of the last rank
    (the finish's)."""
    NAMES = ("rank_arrays", "poa_dp_batch", "_traceback_matched_batch",
             "merge_arm")

    def __init__(self, at: int = 2):
        self.at = at
        self.kept = {}
        self.count = dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        self.orig = {n: getattr(TF, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(TF, n, functools.partial(self._call, n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(TF, n, fn)

    def _call(self, name, *args, **kw):
        if self.count[name] == self.at:
            st = TF.clone_state(args[0]) if name == "merge_arm" else args[0]
            self.kept[name] = ((st,) + args[1:], kw)
        self.count[name] += 1
        if name == "rank_arrays":
            self.kept["rank_last"] = (args, kw)
        return self.orig[name](*args, **kw)


def real_tile_kernels(name, kept, N, L, P) -> dict:
    """Each kernel on the inputs AtStep kept from a real tile: equal to its
    plain version (one call), its device and call times, its bound on
    these inputs.  The plain versions' times are the synthetic tile's
    (phases 3-4)."""
    res = {}
    (st, *margs), mkw = kept["merge_arm"]
    B = st.n_nodes.numel()
    step = f"arm step {AtStep().at}"

    def record(key, what, fn, err, bd, only=None, less=None, extra="",
               where=step):
        if err:
            raise RuntimeError(f"{name}: {what} kernel != plain (max |diff| "
                               f"{err})")
        ms, call_ms = kernel_ms(fn, only, less)
        res[key] = dict(ms=ms, call_ms=call_ms, plain_ms=None,
                        max_abs_err=err, bound_ms=bd["bound_ms"],
                        bound_by=bd["bound_by"])
        log(f"{name} {what} B={B} N={N} L={L} P={P} at {where}: equal to "
            f"plain; kernel {ms:.4f} ms ({call_ms:.4f} ms a call); bound "
            f"{bd['bound_ms']:.5f} ms by {bd['bound_by']} "
            f"({bd['bytes'] / 1e6:.2f} MB): {bd['bound_ms'] / ms:.4f} of it"
            + extra)

    dargs, dkw = kept["poa_dp_batch"]
    err = dp_diff(poa_dp_batch(*dargs, **dkw), poa_dp_batch_ref(*dargs, **dkw),
                  dargs[4], N)
    nodes = int(dargs[4].sum())
    record("poa_dp", "DP", lambda: poa_dp_batch(*dargs, **dkw), err,
           dp_bound(dargs, N, L, P), extra=f"; {nodes} rows")
    (bp, pred_rows, arm_len, mode, max_row), wkw = kept[
        "_traceback_matched_batch"]
    targs = (bp, pred_rows, arm_len, mode, max_row, wkw["active"])
    err = leaf_diff(poa_tb_matched(*targs, N=N, L=L, P=P),
                    poa_tb_matched_ref(*targs, N=N, L=L, P=P))
    steps = poa_tb_batch(bp, pred_rows, max_row, arm_len, mode, N=N, L=L,
                         P=P)[2]
    record("poa_tb", "tile walk",
           lambda: poa_tb_matched(*targs, N=N, L=L, P=P), err,
           tb_bound(torch.where(wkw["active"], steps, 0), N, L,
                    matched=True))
    final = kept["rank_last"][0][0]
    for label, state, leaves in (("step", st, STEP_LEAVES),
                                 ("finish", final, CONS_LEAVES)):
        want = TF._rank_arrays_batch(state, N)
        got = rank_arrays(state, N, leaves)
        err = max(leaf_diff(a, b) for f, a, b in zip(cuda_rank.FIELDS, got,
                                                     want) if f in leaves)
        record(f"poa_rank_{label}", f"rank ({label}'s leaves)",
               lambda: rank_arrays(state, N, leaves), err,
               rank_bound(state, N, P, leaves),
               where=step if label == "step" else "the finish")
    want = TF._merge_step(st, *margs, **mkw)
    err = max(leaf_diff(a, b) for a, b in zip(
        merge_arm(TF.clone_state(st), *margs, **mkw), want))
    work = TF.clone_state(st)

    def restore():
        for dst, src in zip(work, st):
            dst.copy_(src)

    def merge_once():
        restore()
        merge_arm(work, *margs, **mkw)

    record("poa_merge", "merge", merge_once, err,
           merge_bound(st, want, margs, L, P), only="poa_merge_kernel",
           less=restore, extra=" (a call's time holds the state's restore)")
    ra = TF._rank_arrays_batch(final, N)
    cargs = (ra.pred_ranks, ra.pred_w_r, ra.pred_cnt_r, ra.is_end_r,
             ra.node_code_r, ra.node_sup_r, final.n_nodes,
             ra.rank_of[:, 0].contiguous())
    err = max(leaf_diff(a, b) for a, b in zip(
        heaviest_bundle(*cargs, N=N, P=P),
        TF._consensus_wavefront(*cargs, N=N, P=P)))
    record("consensus", "consensus",
           lambda: heaviest_bundle(*cargs, N=N, P=P), err,
           cons_bound(cargs, N, P), where="the finish")
    return res


def phase_full_batch(dev, tiles) -> tuple:
    """The whole-batch entry point device_full.poa_full_batch (kernels 4,
    1, 3, 5 a step for all K = 16 steps, then 4 and 2) on phase 11's
    first tile of each class, gathered into [B, K, L] at full width
    (class 0: B = 2048, N = 256, L = 126; class 1: B = 256, N = 1024,
    L = 510), int8 codes: the inputs on the card unchanged; equal to
    poa_full_batch on the CPU (the plain versions, int32 codes) on a row
    subset; every window with arms and without overflow equal to the
    NumPy spec ColPoa; the first call's and a warm call's times.  Then
    each kernel on the class-1 call's third arm step (AtStep): the first
    times of the class-1 kernels on a real tile.  Returns (launches of
    the two first calls, those kernels' results)."""
    from hypo_tpu_torch.poa.full_runner import CLASSES, P_FULL
    for wrappers in COUNTERS.values():
        for w in wrappers:
            w.launches = 0
    runs = {}
    for ci in sorted(tiles):
        L, N = CLASSES[ci][:2]
        B, K = tiles[ci][2].shape
        kw = dict(K=K, P=P_FULL, **SCORES)
        x = gather_arms(tiles[ci])
        given = [torch.from_numpy(a).to(dev) for a in x]
        before = [t.clone() for t in given]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = TF.poa_full_batch(*given, N=N, L=L, **kw)
        torch.cuda.synchronize()
        runs[ci] = (x, given, out, time.perf_counter() - t0, kw)
        if not all(torch.equal(a, b) for a, b in zip(given, before)):
            raise RuntimeError(f"poa_full_batch class {ci}: an input on the "
                               f"card changed")
    launches = launch_counts()
    check_launches("poa_full_batch (one call a class)", launches, KERNELS)
    real = {}
    # one pool of ColPoa workers for both classes
    with multiprocessing.get_context("spawn").Pool(os.cpu_count() or 1) \
            as workers:
        for ci, (x, given, out, first_s, kw) in runs.items():
            L, N = CLASSES[ci][:2]
            B, K = x[1].shape
            ms = cuda_ms(lambda: TF.poa_full_batch(*given, N=N, L=L, **kw),
                         reps=3)
            sub = np.arange(0, B, max(1, B // (64, 16)[ci]))
            t0 = time.perf_counter()
            ref = TF.poa_full_batch(*(a[sub].astype(np.int32) for a in x),
                                    N=N, L=L, device="cpu", **kw)
            cpu_s = time.perf_counter() - t0
            cc, cs, cl, ovf = (t.cpu().numpy() for t in out)
            for f, a, b in zip(("codes", "supports", "lengths", "ovf"), out,
                               ref):
                if a.dtype != b.dtype or not torch.equal(a[sub].cpu(), b):
                    raise RuntimeError(f"poa_full_batch class {ci}: {f} on "
                                       f"the card != the CPU's on rows "
                                       f"{sub.tolist()}")
            arms, alen, amode, narms = x
            ok = [b for b in range(B) if narms[b] > 0 and not ovf[b]]
            specs = [[(arms[b, k, :alen[b, k]].tolist(), int(amode[b, k]), 1)
                      for k in range(narms[b]) if alen[b, k] > 0]
                     for b in ok]
            t0 = time.time()
            wants = workers.map(spec_consensus, specs, chunksize=8)
            for b, (want, want_sup) in zip(ok, wants):
                if (cc[b, :cl[b]].tolist() != want
                        or cs[b, :cl[b]].tolist() != want_sup):
                    raise RuntimeError(f"poa_full_batch class {ci} window {b}"
                                       f" != ColPoa spec")
            log(f"poa_full_batch class {ci} B={B} N={N} L={L} K={K} (phase "
                f"11's first class-{ci} tile, {int((narms > 0).sum())} "
                f"windows with arms, arm steps {int(narms.max())}): inputs "
                f"unchanged; rows {len(sub)} equal the CPU's ({cpu_s:.1f} s "
                f"there); all {len(ok)} windows without overflow equal ColPoa "
                f"({int(ovf.sum())} overflowed; spec {time.time() - t0:.1f} "
                f"s); first call {first_s * 1e3:.2f} ms, warm {ms:.2f} ms a "
                f"call (CUDA events, {K} steps and the finish)")
            if ci == 1:
                with AtStep() as rec:
                    TF.poa_full_batch(*given, N=N, L=L, **kw)
                real = real_tile_kernels("class-1 real tile", rec.kept, N, L,
                                         kw["P"])
    real["poa_step_head"] = real_tile_heads(dev, tiles)
    return launches, real


def real_tile_heads(dev, tiles) -> dict:
    """The step head and kernel 4 on phase 11's first tile of each class
    as the runner packed it (its weights kept), merged by the eager arm
    steps: the head against its plain version (head_checks), kernel 4
    with every leaf set against _rank_arrays_batch on the state before
    each arm step and the final one; the head timed at the class-1
    tile's third step.  Returns that time's record."""
    from hypo_tpu_torch.poa.full_runner import CLASSES, P_FULL
    timed = {}
    for ci in sorted(tiles):
        L, N = CLASSES[ci][:2]
        states = []

        def record(st, *args, **kw):
            states.append(TF.clone_state(st))
            return merge_arm(st, *args, **kw)

        TF.merge_arm = record
        try:
            final = TF.run_arm_steps(*tiles[ci][:6], N=N, L=L, P=P_FULL,
                                     device=dev, **SCORES)
        finally:
            TF.merge_arm = merge_arm
        states.append(final)
        name = f"class-{ci} real tile"
        head_checks(name, states, tiles[ci], N, L)
        err = 0
        for st in states:
            want = TF._rank_arrays_batch(st, N)
            for leaves in (cuda_rank.FIELDS, STEP_LEAVES, CONS_LEAVES):
                got = rank_arrays(st, N, leaves)
                err = max([err] + [leaf_diff(getattr(got, f),
                                             getattr(want, f))
                                   for f in leaves])
        if err:
            raise RuntimeError(f"{name}: rank kernel != plain (max |diff| "
                               f"{err})")
        log(f"rank {name}: every leaf set equal to plain on the state "
            f"before each of its {len(states) - 1} arm steps and the final "
            f"one")
        if ci == 1:
            at = min(2, len(states) - 2)
            timed = head_times(name, states[at], tiles[ci], at, N, L,
                               P_FULL)
    return timed


# -- 13. exact mode with fix_long_align_type --------------------------------------

def fix_long_polisher():
    """A pipeline.polish.Polisher subclass whose runner has
    fix_long_align_type on: exact mode's DeviceConsensusRunner, mode
    full's FullDeviceRunner (the option reaches its host engine, which
    takes the LONG windows), or without --device-poa the host engine
    (HostTileRunner, which the polisher builds in that case)."""
    from hypo_tpu_torch.pipeline.polish import Polisher, cuda_device
    from hypo_tpu_torch.poa.batch import DeviceConsensusRunner
    from hypo_tpu_torch.poa.full_runner import FullDeviceRunner
    from hypo_tpu_torch.poa.host_runner import HostTileRunner

    class FixLong(Polisher):
        def _make_device_runner(self):
            f = self.flags
            if not f.use_device_poa:
                return HostTileRunner(f.score_params, fix_long_align_type=True,
                                      threads=f.threads)
            full = f.device_poa_mode == "full"
            cls = FullDeviceRunner if full else DeviceConsensusRunner
            cls.check_scores(f.score_params, long_reads=not self.no_long_reads)
            dev = self.device if self.device is not None else cuda_device()
            runner = (FullDeviceRunner(f.score_params, dev, f.threads,
                                       fix_long_align_type=True) if full
                      else DeviceConsensusRunner(f.score_params, dev,
                                                 fix_long_align_type=True))
            runner.warm()
            return runner

    return FixLong


def window_consensus(polisher) -> list:
    return [(w.wtype, w.consensus) for c in polisher.contigs
            for w in c.windows if w is not None]


def phase_exact_fixlong(tmp: str, genome_size: int = 1_000_000) -> tuple:
    """fix_long_align_type on phase 7's 1 Mbp hybrid simulation (LONG
    windows with prefix and suffix arms): exact mode (LONG windows on the
    card, their prefix arms LOV and suffix arms ROV at the long-read
    scores) and mode full (they go to the host engine) with the option,
    and the port's host engine with it, all in this process: every FASTA
    equals the pin from hypo_tpu's host engine with the option, and
    exact mode's windows equal the host engine's one by one; the port's
    default host engine writes phase 7's pin, and some windows differ
    from its (else the option was not exercised)."""
    sim = os.path.join(tmp, "sim_hybrid")
    common = polish_args(sim, genome_size, hybrid=True)
    fix = fix_long_polisher()
    runs = {}
    for name, cls, extra in (
            ("default host engine", None, ["--no-device-poa"]),
            ("host engine", fix, ["--no-device-poa"]),
            ("exact", fix, ["--device-poa", "--device-poa-mode", "exact"]),
            ("full", fix, ["--device-poa"])):
        out = os.path.join(tmp, f"fixlong_{name.replace(' ', '_')}.fa")
        stats, launches, times, wall = run_port(common + ["-o", out] + extra,
                                                polisher=cls)
        runs[name] = (_md5(out), window_consensus(run_port.last), launches,
                      stats)
        log_times(f"fix_long {name}", times, wall)
    md5_default, default, _l, _s = runs["default host engine"]
    md5_host, host, _l, _s = runs["host engine"]
    md5_exact, exact, exact_launches, stats = runs["exact"]
    md5_full, full, full_launches, full_stats = runs["full"]
    log(f"fix_long exact device stats: device rounds "
        f"{stats['device_rounds']}, device aligns {stats['device_aligns']} "
        f"(of LONG windows {stats['long_aligns']}), host fallbacks "
        f"{stats['host_fallbacks']}")
    log_tiles("fix_long full", full_stats)
    same_md5("default host engine (no option)", sim, md5_default,
             md5_default)
    same_md5("fix_long exact", sim, md5_exact, md5_host,
             key="sim_hybrid_fixlong")
    same_md5("fix_long full", sim, md5_full, md5_host,
             key="sim_hybrid_fixlong")
    if exact != host or full != host:
        raise RuntimeError("fix_long: a window's consensus differs between "
                           "the device runs and the host engine")
    differ = [w for w, d in zip(exact, default) if w != d]
    log(f"fix_long: {len(differ)} of {len(exact)} windows differ from the "
        f"default's ({sum(1 for t, _c in differ if t != 0)} of them LONG; "
        f"{sum(1 for t, _c in exact if t != 0)} LONG windows in all)")
    if not differ or stats["long_aligns"] <= 0:
        raise RuntimeError("fix_long: no window differs from the default's, "
                           "or no LONG arm went through the card")
    check_launches("exact with fix_long (1 Mbp hybrid)", exact_launches,
                   ("poa_dp", "poa_tb"))
    check_launches("full with fix_long (1 Mbp hybrid)", full_launches,
                   FULL_PATH)
    return exact_launches, full_launches


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", metavar="CU", nargs="+", default=[],
                    help="earlier sources of csrc/poa_dp.cu, "
                         "csrc/poa_tb.cu, csrc/consensus.cu and/or "
                         "csrc/poa_merge.cu, each "
                         "timed in turns with the kernel it exports the "
                         "entry of, in the same run, at that kernel's "
                         "shapes")
    return ap.parse_args(argv)


def main() -> None:
    opts = parse_args()
    card = phase_env()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(20261016)
    baselines = phase_build(opts.baseline)
    dp = phase_dp(rng, dev, baselines.get("poa_dp"))
    exact_dp, exact_tb = phase_exact_dp(rng, dev, baselines)
    cons = {t[0]: phase_tile(rng, dev, *t, baseline=baselines.get("consensus"),
                             merge_baseline=baselines.get("poa_merge"),
                             rank_baseline=baselines.get("poa_rank"))
            for t in TILES}
    tile_tb = {k: v.pop("tb") for k, v in cons.items()}
    tile_rank, tile_merge, tile_head = {}, {}, {}
    for v in cons.values():
        r, m, h = v.pop("rank_merge")
        tile_rank.update(r)
        tile_merge.update(m)
        tile_head.update(h)
    phase_profile(cons["class0"]["tile"], cons["class0"]["targs"],
                  N=TILES[0][3], L=TILES[0][2], P=8, dev=dev)
    with tempfile.TemporaryDirectory(prefix="hypo_chip_smoke_") as tmp:
        paths = {"full_4mbp": phase_e2e(tmp)}
        paths["exact_1mbp_hybrid"], paths["full_1mbp_hybrid"] = \
            phase_exact_e2e(tmp)
        paths["no_native_200kbp_hybrid"] = phase_no_native(tmp)
        paths["sharded_2rank_4mbp"], paths["split_2dev_4mbp"] = \
            phase_sharded(tmp)
        phase_tools(tmp)
        paths["full_2mbp_8x"], first_tiles = phase_class1(tmp)
        paths["full_batch"], real = phase_full_batch(dev, first_tiles)
        paths["exact_fixlong_1mbp_hybrid"], \
            paths["full_fixlong_1mbp_hybrid"] = phase_exact_fixlong(tmp)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    cons = {k: {f: x for f, x in v.items()
                if f not in ("tile", "targs", "graphs")}
            for k, v in cons.items()}

    def entry(name, key, replaces, path, shape, by_shape, source=None):
        # launches on ``path`` (every path's under "launches_by_path");
        # ms / plain_ms at ``shape`` (every shape under "shapes")
        return dict(name=name, route="cuda",
                    source=f"hypo_tpu_torch/csrc/{source or key}.cu",
                    replaces=replaces, launches=paths[path][key],
                    path=path, max_abs_err=max(v["max_abs_err"]
                                               for v in by_shape.values()),
                    ms=by_shape[shape]["ms"],
                    plain_ms=by_shape[shape]["plain_ms"],
                    bound_ms=by_shape[shape]["bound_ms"],
                    bound_by=by_shape[shape]["bound_by"], library_ms=None,
                    shape=shape,
                    shapes=by_shape,
                    launches_by_path={p: c[key] for p, c in paths.items()})

    # the class-1 real tile's times (phase 12) beside each kernel's shapes
    real = {k: {"class1_real": v} for k, v in real.items()}
    kernels = [
        entry("poa_dp", "poa_dp", "hypo_tpu/poa/pallas_poa.py:259",
              "full_4mbp", "class0_multi",
              {**dp, **exact_dp, **real["poa_dp"]}),
        entry("poa_tb", "poa_tb",
              "hypo_tpu/poa/jax_poa.py:85-116 and "
              "hypo_tpu/poa/device_full.py:247-307 (XLA, no Pallas kernel)",
              "full_4mbp", "class0",
              {**tile_tb, **exact_tb, **real["poa_tb"]}),
        entry("heaviest_bundle", "consensus",
              "hypo_tpu/poa/pallas_consensus.py:191", "full_4mbp",
              "class0", {**cons, **real["consensus"]}),
        entry("poa_rank", "poa_rank",
              "hypo_tpu/poa/device_full.py:144-193 (XLA, no Pallas kernel)",
              "full_4mbp", "class0_step",
              {**tile_rank,
               "class1_real_step": real["poa_rank_step"]["class1_real"],
               "class1_real_finish": real["poa_rank_finish"]["class1_real"]}),
        entry("poa_step_head", "poa_step_head",
              "hypo_tpu/poa/device_full.py:756-765 and :444-445 (the tile "
              "body's arm fetch) with :144-193 (XLA, no Pallas kernel)",
              "full_4mbp", "class0", {**tile_head, **real["poa_step_head"]},
              source="poa_rank"),
        entry("poa_merge", "poa_merge",
              "hypo_tpu/poa/device_full.py:309-424 (XLA, no Pallas kernel)",
              "full_4mbp", "class0", {**tile_merge, **real["poa_merge"]}),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
