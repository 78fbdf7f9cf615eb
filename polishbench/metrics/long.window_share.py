"""Share (%) of the windows that needed a POA consensus that were LONG
windows, sent to the host engine, from the runner's ``stats``: LONG
windows over the tile windows less overflows plus the host engine's
(LONG windows and fallbacks, overflows included), the denominator of
``tiles.window_share``.  None where the window's polishes had no LONG
window (a polish without ``-B``)."""


def read(t):
    s = t.stats
    long_windows = s.get("host_long_windows", 0)
    if long_windows <= 0:
        return None
    tiles = sum(s.get("class_windows", [])) - s.get("full_overflows", 0)
    return 100.0 * long_windows / (
        tiles + long_windows + s.get("host_fallbacks", 0))
