"""Seconds per polish in the solid k-mer stage (the port's
``pipeline.solid_kmers`` span: k-mer counting over the reads and the
solid set's selection)."""
from polishbench.program_spans import per_polish


def read(t):
    return per_polish(t, "pipeline.solid_kmers")
