"""Seconds per polish loading the short-read alignments (the port's
``pipeline.load_short_alignments`` span: the BAM's records parsed and
filtered)."""
from polishbench.program_spans import per_polish


def read(t):
    return per_polish(t, "pipeline.load_short_alignments")
