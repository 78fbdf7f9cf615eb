"""The port's two Python-job-model runners against the JAX package's, on
CPU tensors (the kernels' plain versions): exact mode's
DeviceConsensusRunner.run_windows (hypo_tpu_torch.poa.batch vs
hypo_tpu.poa.batch) and the tile runner's run_windows, the path without
the native host library (hypo_tpu_torch.poa.full_runner vs
hypo_tpu.poa.full_runner).  Windows are test_device_poa's synthetic
SHORT + LONG windows, made from numpy seeds, plus a few that force the
host paths; consensus strings and stats must be equal (tolerance 0)."""
import numpy as np
import pytest

from hypo_tpu.config import ScoreParams
from hypo_tpu.dna import encode
from hypo_tpu.pipeline.window import LONG, SHORT, Window
from hypo_tpu.poa import batch as jbatch
from hypo_tpu.poa import full_runner as jfull
from hypo_tpu.poa.engine import ConsensusEngine
from hypo_tpu_torch.poa import batch as tbatch
from hypo_tpu_torch.poa import full_runner as tfull
from test_device_poa import _make_windows, mutate, rand_seq


def windows(seed, n, long_arms=False):
    """n synthetic windows (about 30% LONG), then, with ``long_arms``,
    two LONG windows of ~1.1 kbp arms, beyond the largest DP bucket, one
    SHORT window of ~140 bp arms, beyond tile class 0, and one SHORT
    window whose arms are all equal (trivial)."""
    rng = np.random.default_rng(seed)
    out = _make_windows(rng, n)
    if long_arms:
        for wt, lo, hi, k in ((LONG, 1050, 1150, 3), (LONG, 1050, 1150, 4),
                              (SHORT, 135, 150, 4)):
            base = rand_seq(rng, lo, hi)
            w = Window(encode(base), wt)
            for _ in range(k):
                w.add_internal(encode(mutate(rng, base, 0.05)))
            out.append(w)
        base = rand_seq(rng, 60, 80)
        w = Window(encode(base), SHORT)
        for _ in range(3):
            w.add_internal(encode(base))
        out.append(w)
    return out


def with_n(rng):
    """A SHORT window whose arms each hold an N (dna code 4), as reads
    and drafts may: the tiles pack it as code 0, as the JAX runner
    does."""
    base = rand_seq(rng, 60, 80)
    w = Window(encode(base), SHORT)
    for _ in range(4):
        arm = mutate(rng, base, 0.05)
        k = int(rng.integers(len(arm)))
        w.add_internal(encode(arm[:k] + "N" + arm[k + 1:]))
    return w


@pytest.mark.parametrize("use_native", [True, False])
def test_exact_runner_matches_jax_and_host_engine(use_native, monkeypatch):
    """Host graphs are NativeGraph, or the Python Graph with
    HYPO_TPU_NO_NATIVE set, in both runners."""
    if not use_native:
        monkeypatch.setenv("HYPO_TPU_NO_NATIVE", "1")
    sp = ScoreParams()
    runs = {}
    for name, make in (
            ("port", lambda: tbatch.DeviceConsensusRunner(sp, "cpu")),
            ("jax", lambda: jbatch.DeviceConsensusRunner(sp)),
            ("host", None)):
        wins = windows(31, 20, long_arms=True)
        if make is None:
            engine = ConsensusEngine(sp)
            for w in wins:
                engine.generate_consensus(w)
            stats = None
        else:
            runner = make()
            assert runner.run_windows(wins) == len(wins)
            stats = runner.stats
        runs[name] = ([w.consensus for w in wins], stats)
    port, jax_, host = runs["port"], runs["jax"], runs["host"]
    assert port[0] == jax_[0] == host[0]
    for key in ("device_rounds", "device_aligns", "host_fallbacks"):
        assert port[1][key] == jax_[1][key], key
    assert port[1]["host_fallbacks"] >= 2     # the ~1.1 kbp LONG windows
    assert 0 < port[1]["long_aligns"] < port[1]["device_aligns"]


def test_full_runner_run_windows_matches_jax(monkeypatch):
    """One JAX device (HYPO_POA_NDEV=1), so the two runners cut the same
    tiles; the port has one device by construction."""
    monkeypatch.setenv("HYPO_POA_NDEV", "1")
    sp = ScoreParams()
    runs = {}
    for name, make in (("port", lambda: tfull.FullDeviceRunner(sp, "cpu")),
                       ("jax", lambda: jfull.FullDeviceRunner(sp))):
        wins = windows(32, 24, long_arms=True)
        wins.append(with_n(np.random.default_rng(33)))
        runner = make()
        assert runner.run_windows(wins) == len(wins)
        runs[name] = ([w.consensus for w in wins], runner.stats)
    port, jax_ = runs["port"], runs["jax"]
    assert port[0][-1]                        # the N window's consensus
    assert port[0] == jax_[0]
    for key in ("full_dispatches", "full_windows", "full_overflows",
                "trivial_windows", "host_long_windows", "host_fallbacks"):
        assert port[1][key] == jax_[1][key], key
    st = port[1]
    assert st["full_windows"] > 0 and st["host_long_windows"] > 0
    assert st["trivial_windows"] > 0
    assert st["class_windows"][1] > 0
    assert sum(st["class_tiles"]) == st["full_dispatches"]
