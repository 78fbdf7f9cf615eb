"""Seconds per polish finding the reads' arms and filling the windows
(the port's ``pipeline.short_arms``, ``pipeline.window_fill`` and
``pipeline.long_arms`` spans)."""
from polishbench.program_spans import per_polish


def read(t):
    return per_polish(t, "pipeline.short_arms", "pipeline.window_fill",
                      "pipeline.long_arms")
