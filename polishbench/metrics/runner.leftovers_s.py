"""Seconds per polish in the host engine's windows: LONG, classless and
overflowed windows (``materialize_arms_bulk`` and
``ConsensusEngine.generate_consensus_batch`` under
``FullDeviceRunner.run_polish_batch``; host-clock timers)."""


def read(t):
    if not t.polishes:
        return None
    return t.buckets["leftovers"] / t.polishes
