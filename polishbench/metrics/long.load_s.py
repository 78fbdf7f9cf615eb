"""Seconds per polish loading the long-read BAM's batches, with the
MAPQ (``-q``) and normalised edit distance (``-n``) filters: the port's
``pipeline.long_load`` span, under ``pipeline.long_arms``.  None where
the window's polishes have no such span (a polish without ``-B``, or a
port from before the span)."""
from polishbench import program_spans

SPAN = "pipeline.long_load"


def read(t):
    roots = program_spans.window_polishes(t)
    if roots is None:
        return None
    ids = {r.id for r in roots}
    if not any(s.name == SPAN and s.polish in ids
               for s in program_spans.RECORDER.spans):
        return None
    return program_spans.per_polish(t, SPAN)
