"""Launches per polish of the port's kernels 1-5 (the wrappers'
``launches`` counters, a captured launch counted at each graph
replay)."""


def read(t):
    if not t.polishes or not t.launches:
        return None
    return t.launches / t.polishes
