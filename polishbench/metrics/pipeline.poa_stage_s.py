"""Seconds of the Monitor's ``POA over N windows`` stage per polish
(the runner's whole stage: job build, tiles, host leftovers)."""


def read(t):
    poa = t.stage_seconds("POA over")
    if not t.polishes or not poa:
        return None
    return sum(poa) / t.polishes
