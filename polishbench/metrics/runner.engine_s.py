"""Seconds per polish in the host engine's consensus of the leftover
windows (the port's ``runner.engine`` span, under ``runner.leftovers``:
``ConsensusEngine.generate_consensus_batch``)."""
from polishbench.program_spans import per_polish


def read(t):
    return per_polish(t, "runner.engine")
