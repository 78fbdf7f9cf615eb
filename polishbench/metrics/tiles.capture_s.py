"""Seconds per polish capturing the tile programs' CUDA graphs, on any
thread (the port's ``tiles.capture`` span, one a device block at its
first tile; the warm-up thread's count: they overlap the host stages
there).  0 where nothing was captured (on the CPU)."""
from polishbench.program_spans import per_polish


def read(t):
    return per_polish(t, "tiles.capture")
