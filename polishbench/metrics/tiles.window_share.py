"""Share (%) of the windows that needed a POA consensus that the device
tiles gave it: tile windows less overflows, over those plus the host
engine's (LONG windows and fallbacks, overflows included), from the
runner's ``stats``.  Trivial windows, which the job build settles
without a POA, are in neither."""


def read(t):
    s = t.stats
    tiles = sum(s.get("class_windows", [])) - s.get("full_overflows", 0)
    host = s.get("host_long_windows", 0) + s.get("host_fallbacks", 0)
    if tiles + host <= 0:
        return None
    return 100.0 * tiles / (tiles + host)
