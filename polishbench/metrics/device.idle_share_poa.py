"""Share (%) of the POA stages' wall time in which the card ran no
kernel, copy or set (the trace's device activities against the Monitor
stages' host times)."""


def read(t):
    poa = [(s, e) for label, s, e in t.stages if label.startswith("POA over")]
    total = sum(e - s for s, e in poa)
    if t.device is None or total <= 0:
        return None
    busy = sum(t.busy(s, e) for s, e in poa)
    return 100.0 * (1.0 - busy / total)
