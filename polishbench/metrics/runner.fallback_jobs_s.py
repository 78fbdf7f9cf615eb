"""Seconds per polish of the native jobs engine's call over the short
windows the runner leaves to the host in job form, classless or
overflowed (the port's ``runner.fallback_jobs`` span, under
``runner.leftovers``, on a thread of its own beside ``runner.engine``
where both run); None where no polish of the window has the span."""
from polishbench import program_spans


def read(t):
    roots = program_spans.window_polishes(t)
    if roots is None:
        return None
    ids = {r.id for r in roots}
    if not any(s.name == "runner.fallback_jobs" and s.polish in ids
               for s in program_spans.RECORDER.spans):
        return None
    return program_spans.per_polish(t, "runner.fallback_jobs")
