"""Shared fixtures of the benchmark's tests (``python -m pytest
polishbench/tests``; ``pytest tests/`` does not collect them).  They run
on the CPU at small sizes; a case that needs the card is marked ``cuda``
and skips in the ``card`` fixture without one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a cell cut to run on the CPU in seconds: 40 kbp (60 kbp hybrid, its
# long reads 2 kbp), two stretches of the check
TINY = {
    "bact4m_sr.cov30": {"genome_size": 40000, "check": {"bp": 8000,
                                                        "count": 2}},
    "hybrid_test.sr30_lr25": {
        "genome_size": 60000, "long_len": 2000,
        "check": {"bp": 10000, "count": 2, "margin": 3000, "pad": 1000}},
}

# a hybrid cell that BENCHMARK.json does not hold (its traffic has no
# public source yet), so that the harness's long-read path (-B, a
# short-read dropout the check covers) stays tested for the cell a
# later change adds
HYBRID = {
    "workload": {"name": "hybrid_test.sr30_lr25", "config": "hybrid_test",
                 "traffic": "sr30_lr25", "chips": 1},
    "config": {"name": "hybrid_test",
               "genome": {"genome_size": 60000, "num_contigs": 1,
                          "draft_error_rate": 0.01},
               "polisher": {"size_ref": "60000", "kind_sr": "sr",
                            "threads": 2, "device_poa_mode": "full",
                            "device_poa": True}},
    "mix": {"name": "sr30_lr25",
            "reads": {"short_cov": 30, "short_len": 150, "short_err": 0.002,
                      "long_cov": 25, "long_len": 2000, "long_err": 0.08,
                      "dropout": [0.30, 0.33]},
            "check": {"count": 2, "bp": 10000, "margin": 3000, "pad": 1000,
                      "dropout_zone": True}},
}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_cell(monkeypatch, workload: str):
    """Point the registry at a small copy of ``workload``'s config and
    mix (``HYBRID``'s for its cell); returns (config, mix)."""
    from polishbench import registry
    bench = registry.benchmark()
    if workload == HYBRID["workload"]["name"]:
        bench = dict(bench, workloads=bench["workloads"] + [
            HYBRID["workload"]])
        monkeypatch.setattr(registry, "benchmark", lambda root=None: bench)
        cfg, mx = HYBRID["config"], HYBRID["mix"]
    else:
        entry = {w["name"]: w for w in bench["workloads"]}[workload]
        cfg = registry.config(entry["config"])
        mx = registry.mix(entry["traffic"])
    cut = TINY[workload]
    cfg = dict(cfg, genome=dict(cfg["genome"],
                                genome_size=cut["genome_size"]),
               polisher=dict(cfg["polisher"],
                             size_ref=str(cut["genome_size"]), threads=2))
    reads = dict(mx["reads"])
    if "long_len" in cut:
        reads["long_len"] = cut["long_len"]
    mx = dict(mx, reads=reads, check=dict(mx["check"], **cut["check"]))
    monkeypatch.setattr(registry, "config", lambda name: cfg)
    monkeypatch.setattr(registry, "mix", lambda name: mx)
    return cfg, mx
