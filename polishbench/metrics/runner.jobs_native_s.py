"""Seconds per polish in the native job builder's C code (the port's
``runner.jobs_native`` span: each ``host_api.tile_jobs`` call, under
``runner.jobs``); the rest of ``runner.jobs_s`` is its Python."""
from polishbench.program_spans import per_polish


def read(t):
    return per_polish(t, "runner.jobs_native")
