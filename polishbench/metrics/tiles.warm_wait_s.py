"""Seconds per polish that the first dispatch waited for the runner's
warm-up thread (the port's ``tiles.warm_wait`` span; 0 where no
dispatch joined a thread)."""
from polishbench.program_spans import per_polish


def read(t):
    return per_polish(t, "tiles.warm_wait")
