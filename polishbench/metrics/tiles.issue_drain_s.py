"""Seconds per polish in the tile program: ``FullDeviceRunner._dispatch``
less the wait for the warm-up thread (the host queues each tile's
uploads and graph replays), plus ``_drain`` (the synchronize before the
first readback); host-clock timers."""


def read(t):
    if not t.polishes:
        return None
    return (t.buckets["issue"] + t.buckets["drain"]) / t.polishes
