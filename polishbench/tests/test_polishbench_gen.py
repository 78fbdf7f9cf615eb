"""The frozen generator writes what ``python -m hypo_tpu_torch.sim``
writes for the same seed (the same bytes once decompressed; its FASTQ
is gzipped at another level)."""
import gzip
import os
import subprocess
import sys

import pytest

from polishbench import gen

from polishbench.registry import ROOT


def _content(path: str) -> bytes:
    with open(path, "rb") as fh:
        data = fh.read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


@pytest.mark.parametrize("hybrid", [False, True], ids=["short", "hybrid"])
def test_generator_matches_the_ports_sim(tmp_path, hybrid):
    kw = {"long_cov": 25, "dropout": (0.3, 0.33)} if hybrid else {}
    mine = gen.simulate(str(tmp_path / "mine"), 1, 20000, workers=2, **kw)
    cmd = [sys.executable, "-m", "hypo_tpu_torch.sim", "--out",
           str(tmp_path / "port"), "--genome-size", "20000", "--seed", "1"]
    if hybrid:
        cmd += ["--long-cov", "25", "--dropout", "0.3,0.33"]
    subprocess.run(cmd, check=True, cwd=ROOT, capture_output=True,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    names = ["truth.fa", "draft.fa", "reads.fq.gz", "sr.bam"]
    names += ["lr.bam"] if hybrid else []
    for name in names:
        assert _content(str(tmp_path / "mine" / name)) == _content(
            str(tmp_path / "port" / name)), name
    assert (mine["lr_bam"] is not None) == hybrid
