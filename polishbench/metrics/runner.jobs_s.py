"""Seconds per polish in the native job build
(``host_runner.build_batch_jobs`` under ``run_polish_batch``:
deduplicated arms, trivial windows settled; host-clock timer)."""


def read(t):
    if not t.polishes:
        return None
    return t.buckets["jobs"] / t.polishes
