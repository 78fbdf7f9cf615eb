"""Seconds per polish dividing the draft into windows (the port's
``pipeline.solid_positions``, ``pipeline.kmer_support``,
``pipeline.strong_regions``, ``pipeline.minimizer_support`` and
``pipeline.window_division`` spans)."""
from polishbench.program_spans import per_polish

STAGES = ("pipeline.solid_positions", "pipeline.kmer_support",
          "pipeline.strong_regions", "pipeline.minimizer_support",
          "pipeline.window_division")


def read(t):
    return per_polish(t, *STAGES)
