"""Stage timing + memory monitor (replaces reference external/slog:
Monitor start/stop pairs printing elapsed seconds and peak/current RSS,
slog/src/Monitor.cpp:40-64).

Copied from hypo_tpu/utils/monitor.py.
"""
from __future__ import annotations

import resource
import sys
import time


def _rss_gb() -> float:
    # ru_maxrss is KB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


class Monitor:
    def __init__(self, stream=None):
        self._start = None
        self._t0 = time.time()
        self.stream = stream or sys.stderr

    def start(self) -> None:
        self._start = time.time()

    def stop(self, msg: str) -> str:
        elapsed = time.time() - (self._start or self._t0)
        stamp = f"{elapsed:.2f} sec; peak RSS {_rss_gb():.2f} GB"
        print(f"{msg}[{stamp}]", file=self.stream)
        return stamp

    def total(self, msg: str) -> None:
        elapsed = time.time() - self._t0
        print(f"{msg}[{elapsed:.2f} sec total; peak RSS {_rss_gb():.2f} GB]",
              file=self.stream)
