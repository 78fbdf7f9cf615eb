"""The span recorder (``utils.trace``) on a whole polish: what tracing
costs, and how closely the spans sit on ``torch.profiler``'s timeline.

    python -m hypo_tpu_torch.tools.trace_check --sim DIR [--turns 3]
        [--threads 8] [--device cuda|cpu] [--out PATH]

``DIR`` holds a simulation (``hypo_tpu_torch.sim``'s reads.fq.gz,
draft.fa and sr.bam; its draft's length is ``-s``).  In this process:

1. One untimed polish through the device path (``--device-poa``, mode
   ``full``), which builds or loads the kernels.
2. ``--turns`` rounds of four polishes with the recorder off, on, on,
   off: each polish's wall seconds (host clock, to a synchronize).  The
   cost is the median on polish over the median off one, less 1.  Beside
   it, the recorder's own seconds per span and per counter addition,
   timed in a loop, times what one polish records: what the cost comes
   to where the polishes' own spread hides it.
3. One polish with the recorder on under ``torch.profiler`` (CPU and
   CUDA activity), after an anchor range that ties the profiler's clock
   to ``time.perf_counter``: each span's profiler range against the
   span's own start and end (the largest difference), and
   the card's idle gaps cut at the spans' bounds, each piece labelled
   with the innermost span open on the polish's thread (``none``
   outside every span): the longest pieces, and idle seconds by label.

Prints one JSON object as its last line, and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..cli import build_parser, flags_from_args
from ..pipeline.polish import polish
from ..utils import trace
from .timing import card, device_for, sync


def polisher(sim: str, threads: int, dev: torch.device, work: str):
    """A function that polishes ``sim`` once (its log to ``work``) and
    returns its wall seconds."""
    from ..io.fasta import read_fastx
    size = sum(len(s) for _n, s in read_fastx(f"{sim}/draft.fa"))
    argv = ["-r", f"{sim}/reads.fq.gz", "-d", f"{sim}/draft.fa",
            "-b", f"{sim}/sr.bam", "-c", "30", "-s", str(size),
            "-t", str(threads), "-o", os.path.join(work, "out.fa"),
            "--aux-dir", os.path.join(work, "aux"), "--device-poa"]

    def one() -> float:
        flags = flags_from_args(build_parser().parse_args(argv))
        old = sys.stdout, sys.stderr
        t0 = time.perf_counter()
        with open(os.path.join(work, "polish.log"), "a") as fh:
            sys.stdout = sys.stderr = fh
            try:
                polish(flags, dev if dev.type == "cpu" else None)
                sync(dev)
            finally:
                sys.stdout, sys.stderr = old
        return time.perf_counter() - t0
    return one


def recorder_cost(n: int = 100_000) -> Tuple[float, float]:
    """Seconds per span and per counter addition with the recorder on,
    less the same loop's with it off."""
    def loop(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n

    def one_span():
        with trace.span("trace_check.span"):
            pass

    def one_count():
        trace.count("trace_check.count", 1)

    trace.disable()
    off = loop(one_span), loop(one_count)
    trace.enable()
    try:
        on = loop(one_span), loop(one_count)
    finally:
        trace.disable()
        trace.RECORDER.reset()
    return on[0] - off[0], on[1] - off[1]


def anchor() -> float:
    """A ``perf_counter`` reading taken just before a range opens, as a
    span's start is; a session's first range pays the profiler's set-up,
    so one goes first."""
    with torch.profiler.record_function("trace_check.warm"):
        pass
    t = time.perf_counter()
    with torch.profiler.record_function("trace_check.anchor"):
        return t


def profiler_events(prof, host_anchor: float):
    """(CPU ranges and ops, device activities) of a profile as (name,
    start, end) on the host's ``perf_counter`` clock."""
    events = prof.profiler.kineto_results.events()
    start = next(e.start_ns() for e in events
                 if e.name() == "trace_check.anchor")
    off = host_anchor - start / 1e9
    cuda = torch.autograd.DeviceType.CUDA
    cpu, dev = [], []
    for e in events:
        row = (e.name(), e.start_ns() / 1e9 + off, e.end_ns() / 1e9 + off)
        (dev if e.device_type() == cuda else cpu).append(row)
    return cpu, dev


def clock_deviation(spans, ranges) -> Tuple[float, int]:
    """The largest distance between a span's start or end and its
    profiler range's (each name's spans and ranges paired in order of
    start), and how many spans had a range.  ``spans`` are one thread's:
    the profiler records the ranges of the thread that started it."""
    worst, paired = 0.0, 0
    for name in {s.name for s in spans}:
        mine = sorted((s for s in spans if s.name == name),
                      key=lambda s: s.start)
        theirs = sorted(r for r in ranges if r[0] == name)
        if len(theirs) != len(mine):
            raise RuntimeError(f"{len(mine)} spans {name!r} but "
                               f"{len(theirs)} profiler ranges")
        for s, (_n, start, end) in zip(mine, theirs):
            worst = max(worst, abs(start - s.start), abs(end - s.end))
            paired += 1
    return worst, paired


def idle_gaps_by_span(acts, spans, lo: float, hi: float,
                      top: int = 10) -> Tuple[List[list], Dict[str, float]]:
    """The stretches of [lo, hi) with no device activity, cut at the
    spans' bounds, each piece labelled with the innermost span open
    there (the latest begun; ``none`` outside every span): the ``top``
    longest [[label, seconds]], and the idle seconds by label."""
    gaps, cur = [], lo
    for _n, s, e in sorted(a for a in acts if a[2] > lo and a[1] < hi):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    bounds = sorted({b for s in spans for b in (s.start, s.end)})
    pieces, by_label = [], {}
    for s, e in gaps:
        cuts = [s] + [b for b in bounds if s < b < e] + [e]
        for ps, pe in zip(cuts, cuts[1:]):
            mid = (ps + pe) / 2
            inner = max((sp for sp in spans if sp.start <= mid < sp.end),
                        key=lambda sp: sp.start, default=None)
            label = inner.name if inner is not None else "none"
            pieces.append([label, pe - ps])
            by_label[label] = by_label.get(label, 0.0) + pe - ps
    pieces.sort(key=lambda p: -p[1])
    return pieces[:top], dict(sorted(by_label.items(), key=lambda kv: -kv[1]))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sim", required=True)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", help="also write the JSON object here")
    opts = ap.parse_args(argv)
    dev = device_for(opts.device)
    work = tempfile.mkdtemp(prefix="trace_check_")
    try:
        result = check(opts, dev, polisher(opts.sim, opts.threads, dev,
                                           work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    line = json.dumps(result)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)),
                    exist_ok=True)
        with open(opts.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)


def check(opts, dev: torch.device, one) -> dict:
    """Steps 1-3 of the module's docstring, with ``one()`` a polish."""
    result: dict = {"device": card(dev), "warm_up_s": one()}

    walls: Dict[str, List[float]] = {"off": [], "on": []}
    spans_per_polish = counts_per_polish = 0
    for _ in range(opts.turns):
        for mode in ("off", "on", "on", "off"):
            trace.RECORDER.reset()
            (trace.enable if mode == "on" else trace.disable)()
            walls[mode].append(one())
            if mode == "on":
                spans_per_polish = len(trace.RECORDER.spans)
                counts_per_polish = len(trace.RECORDER.counts)
    trace.disable()
    per_span, per_count = recorder_cost()
    med = {m: statistics.median(w) for m, w in walls.items()}
    bound = per_span * spans_per_polish + per_count * counts_per_polish
    result.update(
        polish_s=walls, median_s=med, cost=med["on"] / med["off"] - 1,
        spans_per_polish=spans_per_polish,
        counts_per_polish=counts_per_polish, span_s=per_span,
        count_s=per_count, recorder_s_per_polish=bound,
        recorder_share=bound / med["off"])

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    trace.RECORDER.reset()
    trace.enable()
    try:
        with profile(activities=acts) as prof:
            host_anchor = anchor()
            one()
    finally:
        trace.disable()
    spans = list(trace.RECORDER.spans)
    trace.RECORDER.reset()
    ranges, device = profiler_events(prof, host_anchor)
    (root,) = [s for s in spans if s.name == "polish"]
    mine = [s for s in spans if s.thread == root.thread]
    worst, paired = clock_deviation(mine, ranges)
    top, by_label = idle_gaps_by_span(device, mine, root.start, root.end)
    result.update(
        clock_worst_s=worst, spans_paired=paired,
        spans_other_threads=len(spans) - len(mine),
        device_activities=len(device), polish_traced_s=root.end - root.start,
        idle_gaps_by_span=top, idle_s_by_span=by_label)
    return result


if __name__ == "__main__":
    main()
