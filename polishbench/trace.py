"""The traced run's instrumentation (``--trace 1`` only; an untraced run
installs none of it), and the reduction of what it records to the
numbers the metric readers take.

- Stage spans: every ``Monitor`` stage of every polish of the window
  (its label, with the numbers taken out, and its start and end on the
  host clock), and each polish's ``Overall`` seconds, unrounded.
- Runner timers: host-clock seconds of the runner's functions, each
  call counted in its own bucket only (nested calls are taken out), as
  ``hypo_tpu_torch.bench.Spans`` wraps them; calls from other threads
  than the main one (the warm-up) are not counted.
- Counters: the runner's ``stats``, summed over the polishes, and the
  kernel wrappers' ``launches`` over the window.
- One ``torch.profiler`` trace (CUDA activity) over the window, with a
  marker whose host time ties the trace's clock to the host clock.  A
  trace that comes back with no device activity is taken again (the
  profiler's device activity is sometimes lost), twice at most.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Tuple

BUCKETS = ("jobs", "pack", "issue", "warm_wait", "drain", "readback",
           "finalize", "leftovers")
_ANCHOR = "polishbench.anchor"


def stage_label(msg: str) -> str:
    """A Monitor message without its prefix and numbers: ``[hypo_tpu]
    POA over 47946 windows. `` -> ``POA over windows``."""
    msg = msg.replace("[hypo_tpu]", "")
    msg = re.sub(r"\([^)]*\)", "", msg)
    msg = re.sub(r"[0-9]+", "", msg)
    return " ".join(msg.replace(".", " ").split())


class Spans:
    """Exclusive host seconds and calls of wrapped functions, by
    bucket (``hypo_tpu_torch.bench.Spans``, copied)."""

    def __init__(self):
        self._stack: List[float] = []
        self.secs = {b: 0.0 for b in BUCKETS}
        self.calls = {b: 0 for b in BUCKETS}

    def wrap(self, bucket: str, fn):
        def call(*a, **k):
            if threading.current_thread() is not threading.main_thread():
                return fn(*a, **k)
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*a, **k)
            finally:
                inner = self._stack.pop()
                dt = time.perf_counter() - t0
                self.secs[bucket] += dt - inner
                self.calls[bucket] += 1
                if self._stack:
                    self._stack[-1] += dt
        call.__wrapped__ = fn
        return call


class Tracer:
    """Installs the spans and counters, traces the window, and holds
    what a metric reader reads (see ``Trace``)."""

    def __init__(self):
        self._undo: List[tuple] = []
        self.spans = Spans()
        self.reset()

    def reset(self) -> None:
        """Forget what was recorded (a trace taken again)."""
        for b in BUCKETS:
            self.spans.secs[b] = 0.0
            self.spans.calls[b] = 0
        self.stages: List[Tuple[str, float, float]] = []
        self.totals: List[float] = []
        self.recording = False

    def install(self) -> None:
        from hypo_tpu_torch.native import host_api
        from hypo_tpu_torch.poa import engine, full_runner
        from hypo_tpu_torch.utils.monitor import Monitor
        FDR = full_runner.FullDeviceRunner
        for owner, name, bucket in (
                (full_runner, "build_batch_jobs", "jobs"),
                (host_api, "tile_pack", "pack"),
                (FDR, "_dispatch", "issue"),
                (FDR, "_join_warm", "warm_wait"),
                (FDR, "_drain", "drain"),
                (FDR, "_readback", "readback"),
                (host_api, "tile_finalize", "finalize"),
                (full_runner, "materialize_arms_bulk", "leftovers"),
                (engine.ConsensusEngine, "generate_consensus_batch",
                 "leftovers")):
            fn = getattr(owner, name)
            self._undo.append((owner, name, fn))
            setattr(owner, name, self.spans.wrap(bucket, fn))
        stop, total = Monitor.stop, Monitor.total
        self._undo += [(Monitor, "stop", stop), (Monitor, "total", total)]
        tracer = self

        def stage_stop(mon, msg):
            if tracer.recording:
                end = time.time()
                start = mon._start or mon._t0
                now = time.perf_counter()
                tracer.stages.append((stage_label(msg), now - (end - start),
                                      now))
            return stop(mon, msg)

        def stage_total(mon, msg):
            if tracer.recording:
                tracer.totals.append(time.time() - mon._t0)
            return total(mon, msg)

        Monitor.stop = stage_stop
        Monitor.total = stage_total

    def uninstall(self) -> None:
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo = []


def launch_counters():
    """Each kernel wrapper of the port (kernel 4 has two: the finish's
    rank and the step head)."""
    from hypo_tpu_torch.poa import (cuda_consensus, cuda_merge, cuda_poa,
                                    cuda_rank, cuda_tb)
    return (cuda_poa.poa_dp_batch, cuda_tb.poa_tb_matched,
            cuda_consensus.heaviest_bundle, cuda_rank.rank_arrays,
            cuda_rank.step_head, cuda_merge.merge_arm)


class Trace:
    """What a traced window recorded, on one clock (seconds on the host's
    ``perf_counter``):

    - ``polishes``: whole polishes in the window; ``window``: (start, end);
    - ``stages``: [(label, start, end)] of every Monitor stage;
    - ``totals``: each polish's Monitor ``Overall`` seconds;
    - ``buckets``: runner timer seconds over the window, by bucket;
    - ``stats``: the runner's stats summed over the polishes;
    - ``launches``: kernel launches over the window;
    - ``device``: [(name, start, end)] of each device activity (kernel,
      copy or set) in the trace, or None when no trace was taken.
    """

    def __init__(self, polishes: int, window: Tuple[float, float],
                 stages, totals, buckets: Dict[str, float],
                 stats: Dict[str, float], launches: int,
                 device: Optional[List[Tuple[str, float, float]]]):
        self.polishes = polishes
        self.window = window
        self.stages = stages
        self.totals = totals
        self.buckets = buckets
        self.stats = stats
        self.launches = launches
        self.device = device

    # -- shared arithmetic for the readers ---------------------------------
    def stage_seconds(self, prefix: str) -> List[float]:
        return [e - s for label, s, e in self.stages
                if label.startswith(prefix)]

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [d for d in (self.device or [])
                if not d[0].startswith(("Memcpy", "Memset"))]

    def busy(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi) in which some device activity ran."""
        return busy_seconds(self.device or [], lo, hi)


def busy_seconds(acts, lo: float, hi: float) -> float:
    """Length of the union of the activities' intervals within
    [lo, hi)."""
    ivs = sorted((max(s, lo), min(e, hi)) for _n, s, e in acts
                 if e > lo and s < hi)
    busy = 0.0
    cur_s = cur_e = None
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(acts, stages, lo: float, hi: float,
              top: int = 10) -> List[List]:
    """The ``top`` longest stretches of [lo, hi) with no device activity,
    each cut at the Monitor stages' bounds and labelled with the stage
    the host was in (``harness`` between stages): [[label, seconds]]."""
    ivs = sorted((s, e) for _n, s, e in acts if e > lo and s < hi)
    gaps = []
    cur = lo
    for s, e in ivs:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    bounds = sorted({b for _lb, ss, ee in stages for b in (ss, ee)})
    pieces = []
    for s, e in gaps:
        cuts = [s] + [b for b in bounds if s < b < e] + [e]
        for ps, pe in zip(cuts, cuts[1:]):
            mid = (ps + pe) / 2
            label = next((lb for lb, ss, ee in stages if ss <= mid < ee),
                         "harness")
            pieces.append([label, pe - ps])
    return sorted(pieces, key=lambda p: -p[1])[:top]


def top_ops(acts, top: int = 10) -> List[List]:
    """The ``top`` device activities by total seconds: [[name, seconds]]."""
    tot: Dict[str, float] = {}
    for name, s, e in acts:
        tot[name] = tot.get(name, 0.0) + (e - s)
    return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def device_activity(prof, anchor_host: float) -> List[Tuple[str, float,
                                                              float]]:
    """The trace's device activities on the host clock, through the
    anchor marker recorded at ``anchor_host``."""
    import torch
    events = prof.events()
    anchor = next(e for e in events if e.name == _ANCHOR)
    off = anchor_host - anchor.time_range.start / 1e6
    return [(e.name, e.time_range.start / 1e6 + off,
             e.time_range.end / 1e6 + off) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]


def anchor_mark() -> float:
    """A marker in the running trace; returns its host time."""
    import torch
    with torch.profiler.record_function(_ANCHOR):
        return time.perf_counter()
