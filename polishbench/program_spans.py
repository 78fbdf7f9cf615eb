"""The port's own spans and counters (``hypo_tpu_torch.utils.trace``)
of the polishes in a traced run's window, for the metric readers that
read them.

The registry loads a traced run's metric readers before the run's first
polish, and an untraced run loads none: so importing this module, which
those readers do, turns the port's recorder on for the traced run and
for it alone.  Where the port has no recorder (a checkout from before
it), ``RECORDER`` is None and every such reader finds nothing.
"""
from __future__ import annotations

from typing import List, Optional

try:
    from hypo_tpu_torch.utils import trace as _trace
except ImportError:
    RECORDER = None
else:
    _trace.enable()
    RECORDER = _trace.RECORDER


def window_polishes(t) -> Optional[List]:
    """The root ``polish`` spans that lie inside the window, or None
    when there are none to read."""
    if RECORDER is None:
        return None
    w0, w1 = t.window
    roots = [s for s in RECORDER.spans
             if s.name == "polish" and s.start >= w0 and s.end <= w1]
    return roots or None


def per_polish(t, *names: str) -> Optional[float]:
    """Seconds per polish in the spans named ``names`` (any thread) of
    the window's polishes."""
    roots = window_polishes(t)
    if roots is None:
        return None
    ids = {r.id for r in roots}
    total = sum(s.end - s.start for s in RECORDER.spans
                if s.polish in ids and s.name in names)
    return total / len(roots)


def counted(t, name: str) -> Optional[int]:
    """The counter ``name`` summed over the window's polishes."""
    roots = window_polishes(t)
    if roots is None:
        return None
    ids = {r.id for r in roots}
    return sum(n for c, n, _t, polish, _th in RECORDER.counts
               if c == name and polish in ids)
