"""Stage timing + memory monitor (replaces reference external/slog:
Monitor start/stop pairs printing elapsed seconds and peak/current RSS,
slog/src/Monitor.cpp:40-64).

Copied from hypo_tpu/utils/monitor.py, with spans (``utils.trace``;
nothing is recorded while the recorder is off): a Monitor times one
polish, whose root span ``polish`` it opens when made and closes at
``total``; ``start(span)`` opens a stage's span and ``stop`` closes it.
The printed lines are the copy's.
"""
from __future__ import annotations

import resource
import sys
import time

from . import trace


def _rss_gb() -> float:
    # ru_maxrss is KB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


class Monitor:
    def __init__(self, stream=None):
        self._start = None
        self._stage = trace.NULL
        self.root = trace.span("polish", root=True)
        self._t0 = time.time()
        self.stream = stream or sys.stderr

    def start(self, span: str = None) -> None:
        """A stage starts; ``span`` names its span (the name is needed
        here: a profiler range takes it when it opens)."""
        self._stage.close()
        self._stage = trace.span(span) if span else trace.NULL
        self._start = time.time()

    def stop(self, msg: str) -> str:
        elapsed = time.time() - (self._start or self._t0)
        self._stage.close()
        self._stage = trace.NULL
        stamp = f"{elapsed:.2f} sec; peak RSS {_rss_gb():.2f} GB"
        print(f"{msg}[{stamp}]", file=self.stream)
        return stamp

    def total(self, msg: str) -> None:
        elapsed = time.time() - self._t0
        self.root.close()
        print(f"{msg}[{elapsed:.2f} sec total; peak RSS {_rss_gb():.2f} GB]",
              file=self.stream)
