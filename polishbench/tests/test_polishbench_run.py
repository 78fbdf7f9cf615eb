"""One run of the harness, end to end on the CPU (the port's plain
kernels, at the small sizes of ``conftest.TINY``): the result line, the
look for a card, the modules it loads, and the check catching a broken
timed path."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from polishbench.registry import ROOT

from conftest import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(monkeypatch, tmp_path, workload="bact4m_sr.cov30", trace=0,
         seed=4294967311):
    import torch

    import polishbench.run as R
    tiny_cell(monkeypatch, workload)
    opts = R.parse(["--workload", workload, "--seed", str(seed),
                    "--seconds", "0.5", "--trace", str(trace)])
    return R.run(opts, device=torch.device("cpu"), work_dir=str(tmp_path))


@pytest.mark.parametrize("workload", ["bact4m_sr.cov30",
                                      "hybrid_test.sr30_lr25"])
def test_result_line_has_its_keys(monkeypatch, tmp_path, workload):
    res = _run(monkeypatch, tmp_path, workload)
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"polish_kbp_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_traced_run_reads_per_layer_metrics(monkeypatch, tmp_path):
    from polishbench import registry
    res = _run(monkeypatch, tmp_path, trace=1)
    assert res["correct"] is True
    names = {m["name"] for m in registry.benchmark()["per_layer"]}
    assert set(res["metrics"]) <= names
    # on the CPU the spans and counters read, the device trace does not
    assert {"pipeline.host_s", "pipeline.poa_stage_s", "runner.jobs_s",
            "tiles.issue_drain_s", "tiles.window_share"} <= set(
        res["metrics"])
    assert "kernels.device_ms" not in res["metrics"]
    assert res["metrics"]["tiles.window_share"]["value"] > 0


def _alter_answers(orig):
    """The tiles' outputs with their second byte changed in every row:
    an answer altered where it is produced."""
    def readback(self, handle):
        out = orig(self, handle).copy()
        out[:, 1] ^= np.int8(0x11)
        return out
    return readback


def _drop_half(orig):
    """The tiles' outputs with the second half of the rows zeroed: half
    of each batch left out."""
    def readback(self, handle):
        out = orig(self, handle).copy()
        out[out.shape[0] // 2:] = 0
        return out
    return readback


@pytest.mark.parametrize("fault", [_alter_answers, _drop_half],
                         ids=["answer_altered", "half_left_out"])
def test_broken_timed_path_is_not_correct(monkeypatch, tmp_path, fault):
    from hypo_tpu_torch.poa.full_runner import FullDeviceRunner
    monkeypatch.setattr(FullDeviceRunner, "_readback",
                        fault(FullDeviceRunner._readback))
    res = _run(monkeypatch, tmp_path, seed=11)
    assert res["correct"] is False
    assert res["checks"]["stretches_wrong"]["value"] > 0
    assert res["failed"] == res["attempted"]


def test_run_without_a_card_exits_with_no_result(tmp_path):
    """Here there is no CUDA card: the command fails before it makes any
    input, and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = subprocess.run([sys.executable, "polishbench/run.py", "--workload",
                        "bact4m_sr.cov30", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, env=dict(os.environ, TMPDIR=str(tmp_path)),
                       timeout=300)
    assert r.returncode != 0
    assert "correct" not in r.stdout
    assert "no CUDA card" in r.stderr


def test_harness_loads_no_jax(tmp_path):
    """A whole run in a process of its own leaves no module with the
    top-level name jax, jaxlib, flax or hypo_tpu in sys.modules
    (``hypo_tpu_torch`` is not ``hypo_tpu``)."""
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
import pytest, torch
import polishbench.run as R
from conftest import tiny_cell
def main():
    mp = pytest.MonkeyPatch()
    tiny_cell(mp, "bact4m_sr.cov30")
    opts = R.parse(["--workload", "bact4m_sr.cov30", "--seed", "2",
                    "--seconds", "0.5", "--trace", "0"])
    res = R.run(opts, device=torch.device("cpu"), work_dir={str(tmp_path)!r})
    print(json.dumps({{"correct": res["correct"],
                      "found": R.forbidden_modules(),
                      "port": "hypo_tpu_torch" in sys.modules}}))
if __name__ == "__main__":
    main()
"""
    script = tmp_path / "harness_only.py"
    script.write_text(code)
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, cwd=str(tmp_path), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "found": [], "port": True}


@pytest.mark.cuda
def test_run_on_the_card(card, monkeypatch, tmp_path):
    """On the card, the small cell runs through the CUDA kernels and is
    correct."""
    import polishbench.run as R
    tiny_cell(monkeypatch, "bact4m_sr.cov30")
    opts = R.parse(["--workload", "bact4m_sr.cov30", "--seed", "3",
                    "--seconds", "1", "--trace", "1"])
    res = R.run(opts, work_dir=str(tmp_path))
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["kernels.launches"]["value"] > 0
