"""Seconds per polish rebuilding the arm lists of the host engine's
fallback windows (the port's ``runner.materialize`` span, under
``runner.leftovers``: ``materialize_arms_bulk``, per contig)."""
from polishbench.program_spans import per_polish


def read(t):
    return per_polish(t, "runner.materialize")
