"""Share (%) of the host's short windows that the native jobs engine
finished from their jobs, against those whose arms were rebuilt for the
classic engine: the port's counters ``runner.fallback_jobs`` over those
plus ``runner.fallback_materialized``, summed over the window's
polishes; None where neither counted anything."""
from polishbench.program_spans import counted


def read(t):
    jobs = counted(t, "runner.fallback_jobs")
    rebuilt = counted(t, "runner.fallback_materialized")
    if not jobs and not rebuilt:
        return None
    return 100.0 * jobs / (jobs + rebuilt)
