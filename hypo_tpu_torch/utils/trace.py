"""Spans and counters of the port's host side, on the host's
``time.perf_counter`` clock: one recorder for the process, off unless
something turns it on (``enable``; the CLI's ``--trace-out``).

- A span is one interval of work on one thread: its name, an id, the
  id of the span that caused it (``parent``), the id of the polish it
  belongs to (``polish``: the id of its root span, named ``polish``),
  the thread's name, its start and end, and a few attributes.  Parents
  follow a stack per thread; a thread that the program starts is given
  its parent explicitly (``under``).
- A counter is a named integer added to where the work happens
  (``count``), each addition kept with its time, polish and thread.
- Both stay in memory; ``write_chrome`` writes them out once, at the
  end of a run, as Chrome trace events (one complete event per span,
  one counter event per addition), which Perfetto loads.

Off, ``span(name)`` returns the shared ``NULL`` span: no clock read, no
allocation, no lock, no profiler range.  On, and while a
``torch.profiler`` session runs, each span also opens a profiler range
of its name (a ``RecordFunction``, as ``record_function`` opens), so the
span sits on the profiler's timeline beside the device's kernels and
copies; the profiler records the ranges of the thread that started it.  The range is of the op kind (``_RecordFunctionFast``): a
``record_function`` range is a user annotation, which the profiler also
mirrors onto the device's timeline as a ``gpu_user_annotation``
activity around the kernels launched inside it, and a reader of the
trace's device activity would count that as time the card was busy.

``span(name, timed=True)`` times its interval even with the recorder
off (a ``Timed``, which records nothing): the runners' ``HYPO_POA_DEBUG``
lines print the seconds of these spans.

Where the spans are (names fixed, with no counts in them):

- ``polish``, the root (``pipeline.polish.Polisher``: construction to
  the ``Overall`` line; attributes draft_bp, contigs), with
  ``pipeline.runner_setup`` and each Monitor stage (``pipeline.*``);
  ``pipeline.load_short_alignments`` is only the wait for the prefetch
  when a thread loaded the batch;
- the input pass's producers, each on a thread of its own:
  ``pipeline.fastq_decode`` (one chunk of reads inflated and parsed,
  ``kmers.counting.decoded_chunks``; under ``pipeline.solid_kmers``) and
  ``pipeline.bam_prefetch`` (the first batch's short-read alignments
  loaded, ``pipeline.polish._Prefetch``; under ``polish``), and the
  counter ``pipeline.alignments_prefetched`` (1 a batch whose alignments
  the prefetch loaded);
- counters ``pipeline.regions_native`` and ``pipeline.regions_python``:
  the regions a contig's division made (``pipeline.contig.Contig
  .divide_into_regions``, under ``pipeline.window_division``) through
  the host library's one call, or through the Python walk where the
  library did not load;
- the long-read pass (``-B``), under ``pipeline.long_arms``:
  ``pipeline.long_load`` (the long-read BAM's batch loaded, with the
  MAPQ and ``-n`` filters) and ``pipeline.long_find`` (pseudo-windows,
  long arms, window fill);
- ``runner.jobs`` (the job build; child ``runner.jobs_native``, each
  native ``tile_jobs`` call), ``runner.jobs_consensus`` (the host tile
  runner), ``runner.leftovers`` (the host's windows; children
  ``runner.materialize``, arm lists rebuilt for the pre-fallbacks,
  ``runner.engine``, the classic engine's call, and
  ``runner.fallback_jobs``, the native jobs engine's call over the
  short windows left in job form), with counters
  ``runner.fallback_jobs`` (the jobs sent to that call) and
  ``runner.fallback_materialized`` (the windows whose arms were
  rebuilt);
- ``tiles.dispatch`` (every tile packed and queued; per tile
  ``tiles.pack`` and ``tiles.issue``, under which ``tiles.warm_wait``
  when the first dispatch joins the warm-up thread), ``tiles.drain``,
  ``tiles.collect`` (per tile ``tiles.readback`` and ``tiles.finalize``),
  and ``tiles.capture`` (a device block's CUDA graph capture, on any
  thread; attributes seconds, reserved_growth);
- counters ``tiles.window_steps`` (rows x arm steps of each block's
  tile) and ``tiles.active_window_steps`` (the steps of those in which
  the row had an arm: the sum of min(narms, kmax)).
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional


class _Null:
    """The span of a recorder that is off: does nothing, times nothing."""

    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass

    def close(self) -> None:
        pass


NULL = _Null()


class Timed:
    """An interval timed, not recorded (``span(..., timed=True)`` with
    the recorder off)."""

    __slots__ = ("start", "end")

    def __init__(self):
        self.start = time.perf_counter()
        self.end = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        if self.end is None:
            self.end = time.perf_counter()


class Span:
    """One recorded span; begun when made, recorded when closed."""

    __slots__ = ("name", "id", "parent", "polish", "thread", "start", "end",
                 "attrs", "_rec", "_range")

    def __init__(self, rec: "Recorder", name: str, parent: Optional["Span"],
                 root: bool):
        self._rec = rec
        self.name = name
        self.id = next(rec._ids)
        self.parent = parent.id if parent is not None else None
        self.polish = (self.id if root
                       else parent.polish if parent is not None else None)
        self.thread = threading.current_thread().name
        self.attrs: Dict[str, object] = {}
        self.end = None
        # the clock read first: entering the range releases the GIL, and
        # taking it back can wait for another thread
        self.start = time.perf_counter()
        self._range = _profiler_range(name)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def close(self) -> None:
        if self.end is None:
            self.end = time.perf_counter()
            self._rec._close(self)


def _profiler_range(name: str):
    """A profiler range of ``name`` (see the module's docstring),
    entered, while a ``torch.profiler`` session runs; else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class Recorder:
    """Spans and counter additions of this process (see the module's
    docstring).  ``spans`` holds the closed spans in the order they
    closed; ``counts`` the additions, as (name, n, time, polish,
    thread)."""

    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self.counts: List[tuple] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, root: bool = False) -> Span:
        st = self._stack()
        if root:
            st.clear()      # what an error left open is not recorded
        sp = Span(self, name, st[-1] if st else None, root)
        st.append(sp)
        return sp

    def _close(self, sp: Span) -> None:
        st = self._stack()
        if any(s is sp for s in st):
            # spans an error left open above this one are dropped
            while st:
                top = st.pop()
                if top._range is not None:
                    top._range.__exit__(None, None, None)
                if top is sp:
                    break
        elif sp._range is not None:
            sp._range.__exit__(None, None, None)
        self.spans.append(sp)

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def count(self, name: str, n: int) -> None:
        cur = self.current()
        self.counts.append((name, int(n), time.perf_counter(),
                            cur.polish if cur is not None else None,
                            threading.current_thread().name))

    def reset(self) -> None:
        """Forget every closed span and counter addition."""
        self.spans = []
        self.counts = []


RECORDER = Recorder()


def enable() -> None:
    RECORDER.on = True


def disable() -> None:
    RECORDER.on = False


def active() -> bool:
    return RECORDER.on


def span(name: str, timed: bool = False, root: bool = False):
    """A span of ``name`` begun now, under the thread's innermost open
    span (``root``: a new polish, its stack cleared); close it with
    ``close()`` or use it in a ``with``.  With the recorder off: ``NULL``,
    or with ``timed`` a ``Timed``."""
    if RECORDER.on:
        return RECORDER.span(name, root)
    return Timed() if timed else NULL


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (nothing with the recorder
    off)."""
    if RECORDER.on:
        RECORDER.count(name, n)


def current() -> Optional[Span]:
    """The thread's innermost open span (None with the recorder off):
    what a thread that the program starts is given as its parent."""
    return RECORDER.current() if RECORDER.on else None


class under:
    """``with under(parent):`` the spans this thread opens hang under
    ``parent`` (a span another thread opened, or None for nothing)."""

    __slots__ = ("parent",)

    def __init__(self, parent: Optional[Span]):
        self.parent = parent

    def __enter__(self):
        if self.parent is not None:
            RECORDER._stack().append(self.parent)
        return self

    def __exit__(self, *exc) -> bool:
        if self.parent is not None:
            st = RECORDER._stack()
            if self.parent in st:
                del st[st.index(self.parent):]
        return False


# -- reading ------------------------------------------------------------------

def seconds(spans, name: str) -> float:
    """Summed seconds of the spans named ``name``."""
    return sum(s.end - s.start for s in spans if s.name == name)


def chrome_events(spans, counts) -> List[dict]:
    """Chrome trace events: one complete event ("X") per span, with its
    ids and attributes in ``args``, one counter event ("C") per addition
    carrying the counter's running total, and the threads' names;
    microseconds of ``time.perf_counter``."""
    pid = os.getpid()
    tids: Dict[str, int] = {}

    def tid(name: str) -> int:
        return tids.setdefault(name, len(tids) + 1)

    events = []
    for s in spans:
        events.append({
            "name": s.name, "cat": "hypo_tpu_torch", "ph": "X",
            "ts": s.start * 1e6, "dur": (s.end - s.start) * 1e6,
            "pid": pid, "tid": tid(s.thread),
            "args": dict(s.attrs, id=s.id, parent=s.parent,
                         polish=s.polish, thread=s.thread)})
    totals: Dict[str, int] = {}
    for name, n, t, polish, thread in counts:
        totals[name] = totals.get(name, 0) + n
        events.append({"name": name, "cat": "hypo_tpu_torch", "ph": "C",
                       "ts": t * 1e6, "pid": pid, "tid": tid(thread),
                       "args": {name: totals[name]}})
    for name, t in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": t, "args": {"name": name}})
    return events


def write_chrome(path: str) -> None:
    """Write the recorder's spans and counters to ``path`` as Chrome
    trace JSON.  ``otherData`` holds one reading of ``time.time`` and
    ``time.perf_counter`` taken together, to put the events on the wall
    clock."""
    doc = {"traceEvents": chrome_events(RECORDER.spans, RECORDER.counts),
           "displayTimeUnit": "ms",
           "otherData": {"clock": "time.perf_counter",
                         "unix_time_s": time.time(),
                         "perf_counter_s": time.perf_counter()}}
    with open(path, "w") as fh:
        json.dump(doc, fh)
