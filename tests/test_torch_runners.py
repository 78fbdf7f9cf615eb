"""The port's runners against the JAX package's, on CPU tensors (the
kernels' plain versions): exact mode's DeviceConsensusRunner.run_windows
(hypo_tpu_torch.poa.batch vs hypo_tpu.poa.batch), also with its options
fix_long_align_type and use_native, on test_device_poa's synthetic
SHORT + LONG windows, made from numpy seeds, plus a few that force the
host paths; and the tile runner's run_polish_batch
(hypo_tpu_torch.poa.full_runner vs hypo_tpu.poa.full_runner), also with
fix_long_align_type, on the dry run's contig (hypo_tpu_torch.entry), its
device windows also held to the column-POA spec.  Consensus strings and
stats must be equal (tolerance 0)."""
import copy

import numpy as np
import pytest
import torch

from hypo_tpu.config import InputFlags, ScoreParams, get_kmer_len
from hypo_tpu.dna import encode
from hypo_tpu.pipeline.window import LONG, SHORT, Window
from hypo_tpu.poa import batch as jbatch
from hypo_tpu.poa import full_runner as jfull
from hypo_tpu.poa.engine import ConsensusEngine
from hypo_tpu.sim import SimConfig, simulate
from hypo_tpu_torch.entry import check_against_spec, dryrun_specs, make_contig
from hypo_tpu_torch.pipeline.polish import Polisher
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


def dryrun_runs(monkeypatch, **kw):
    """The dry run's contig for one device through the port's and
    hypo_tpu's run_polish_batch (one JAX device, HYPO_POA_NDEV=1, so
    the two cut the same tiles), with the runners' options ``kw``:
    {name: (consensus, stats)}, after the port's device windows are
    checked against the column-POA spec."""
    monkeypatch.setenv("HYPO_POA_NDEV", "1")
    sp = ScoreParams()
    specs = dryrun_specs(1)
    runs = {}
    for name, make, window_cls in (
            ("port", lambda: tfull.FullDeviceRunner(sp, "cpu", **kw), None),
            ("jax", lambda: jfull.FullDeviceRunner(sp, **kw), Window)):
        ctg = make_contig(specs, window_cls)
        runner = make()
        assert runner.run_polish_batch([ctg]) == len(specs)
        runs[name] = ([w.consensus for w in ctg.windows], runner.stats)
        if name == "port":
            check_against_spec(ctg, specs)
    return runs


def same_tiles_and_routing(port, jax_):
    """The port's run_polish_batch stats against hypo_tpu's, which adds
    the fallbacks to host_long_windows."""
    for key in ("full_dispatches", "full_windows", "full_overflows",
                "trivial_windows"):
        assert port[key] == jax_[key], key
    assert port["host_long_windows"] + port["host_fallbacks"] == \
        jax_["host_long_windows"]


def test_full_runner_run_polish_batch_matches_jax(monkeypatch):
    runs = dryrun_runs(monkeypatch)
    port, jax_ = runs["port"], runs["jax"]
    assert port[0] == jax_[0]
    same_tiles_and_routing(port[1], jax_[1])
    st = port[1]
    assert st["full_windows"] > 0 and st["host_long_windows"] >= 2
    assert st["host_fallbacks"] >= 2
    assert st["class_windows"][1] > 0
    assert sum(st["class_tiles"]) == st["full_dispatches"]
    assert st["rows_per_device"] == [st["full_windows"]]


def consensus_of(wins, engine):
    for w in wins:
        engine.generate_consensus(w)
    return [w.consensus for w in wins]


@pytest.mark.parametrize("fix_long,use_native", [(True, None), (False, False),
                                                 (True, False)])
def test_exact_runner_options_match_jax(fix_long, use_native):
    """DeviceConsensusRunner(sp, device, fix_long_align_type, use_native)
    against hypo_tpu's runner with the same options, window by window,
    and against hypo_tpu's host engine with them: use_native=False
    merges into the Python Graph; fix_long_align_type aligns LONG
    windows' prefix arms LOV and suffix arms ROV, which changes some
    window's consensus from the default's."""
    sp = ScoreParams()
    kw = dict(fix_long_align_type=fix_long, use_native=use_native)
    runs = {}
    for name, runner in (
            ("port", tbatch.DeviceConsensusRunner(sp, "cpu", **kw)),
            ("jax", jbatch.DeviceConsensusRunner(sp, **kw))):
        wins = windows(32, 24, long_arms=True)
        assert runner.run_windows(wins) == len(wins)
        assert runner.use_native == (use_native is not False)
        runs[name] = ([w.consensus for w in wins], runner.stats)
    port, jax_ = runs["port"], runs["jax"]
    assert port[0] == jax_[0]
    assert port[0] == consensus_of(windows(32, 24, long_arms=True),
                                   ConsensusEngine(sp, fix_long, use_native))
    for key in ("device_rounds", "device_aligns", "host_fallbacks"):
        assert port[1][key] == jax_[1][key], key
    assert 0 < port[1]["long_aligns"] < port[1]["device_aligns"]
    default = consensus_of(windows(32, 24, long_arms=True),
                           ConsensusEngine(sp))
    assert (port[0] != default) == fix_long


def test_full_runner_fix_long_run_polish_batch_matches_jax(monkeypatch):
    """FullDeviceRunner(..., fix_long_align_type=True).run_polish_batch
    against hypo_tpu's with the option: the dry run's LONG windows,
    which carry prefix and suffix arms, reach the host engine with the
    option (their consensus is hypo_tpu's host engine's with it), so
    some LONG window differs from the default's, and only LONG windows
    do."""
    runs = dryrun_runs(monkeypatch, fix_long_align_type=True)
    port, jax_ = runs["port"], runs["jax"]
    assert port[0] == jax_[0]
    same_tiles_and_routing(port[1], jax_[1])
    specs = dryrun_specs(1)
    long = [w for w in make_contig(specs, Window).windows
            if w.wtype == LONG]
    assert len(long) == port[1]["host_long_windows"] >= 2
    assert all(w.pre_arms and w.suf_arms for w in long)
    assert [c for c, s in zip(port[0], specs) if s[1] == LONG] == \
        consensus_of(long, ConsensusEngine(ScoreParams(), True))
    default = dryrun_runs(monkeypatch)["port"][0]
    differ = [i for i, (a, b) in enumerate(zip(port[0], default)) if a != b]
    assert differ and all(specs[i][1] == LONG for i in differ)


class _KeepLong:
    """An exact-mode device runner for the port's polisher that keeps a
    copy of every LONG window it is given, arms and all, and leaves the
    consensus to the host engine."""

    def __init__(self, sp):
        self.engine = ConsensusEngine(sp)
        self.long = []
        self.stats = {}

    def warm(self):
        pass

    def run_windows(self, windows):
        self.long += [copy.deepcopy(w) for w in windows if w.wtype != SHORT]
        return self.engine.generate_consensus_batch(windows)


def test_exact_runner_fix_long_matches_jax_on_a_hybrid_sim(tmp_path):
    """The LONG windows of an 8 kbp hybrid simulation (25x long reads,
    short reads dropped over [0.2, 0.7) of the genome), as the port's
    polisher builds them: the port's exact runner with
    fix_long_align_type equals hypo_tpu's with it and hypo_tpu's host
    engine with it, window by window, and some window differs from the
    default's consensus."""
    paths = simulate(SimConfig(genome_size=8000, seed=2,
                               draft_error_rate=0.02, long_cov=25,
                               dropout=(0.2, 0.7)), str(tmp_path))
    flags = InputFlags(
        sr_filenames=[paths["reads"]], sr_bam_filename=paths["sr_bam"],
        lr_bam_filename=paths["lr_bam"], draft_filename=paths["draft"],
        output_filename=str(tmp_path / "out.fa"),
        k=get_kmer_len(str(paths["genome_size"])), cov=paths["short_cov"],
        use_device_poa=True, device_poa_mode="exact")
    sp = flags.score_params
    keep = _KeepLong(sp)

    class Keeping(Polisher):
        def _make_device_runner(self):
            return keep

    Keeping(flags, torch.device("cpu")).polish()
    assert len(keep.long) >= 8
    assert any(w.pre_arms or w.suf_arms for w in keep.long)
    runs = {}
    for name, runner in (
            ("port", tbatch.DeviceConsensusRunner(sp, "cpu",
                                                  fix_long_align_type=True)),
            ("jax", jbatch.DeviceConsensusRunner(sp,
                                                 fix_long_align_type=True))):
        wins = copy.deepcopy(keep.long)
        assert runner.run_windows(wins) == len(wins)
        runs[name] = ([w.consensus for w in wins], runner.stats)
    port, jax_ = runs["port"], runs["jax"]
    assert port[0] == jax_[0]
    assert port[1]["long_aligns"] == port[1]["device_aligns"] > 0
    for key in ("device_rounds", "device_aligns", "host_fallbacks"):
        assert port[1][key] == jax_[1][key], key
    assert port[0] == consensus_of(copy.deepcopy(keep.long),
                                   ConsensusEngine(sp, True))
    assert port[0] != consensus_of(copy.deepcopy(keep.long),
                                   ConsensusEngine(sp))
