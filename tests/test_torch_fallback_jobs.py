"""The tile runner's host leftovers on CPU tensors (the kernels' plain
versions): short windows that fit no shape class, or overflow their
tile, keep their native jobs and go to the native jobs engine in one
call (``host_runner.finish_leftovers``); pre-fallbacks (an N where the
job builder meets it) and LONG windows go to the classic engine after
it.

- A contig (``entry.make_contig``) holds every kind of window: tile
  windows, a trivial one, classless ones (more distinct arms than K, an
  arm longer than the last class's L), windows that overflow a class-0
  tile (the classes' caps lowered, in this test only), a pre-fallback
  and a LONG window.  Through either caller of ``finish_leftovers``
  (FullDeviceRunner and HostTileRunner), each window's consensus equals
  the classic engine's over its materialized arms; the tile runner's
  also equals hypo_tpu's ``run_polish_batch``, its stats count as
  before, and the counters ``runner.fallback_jobs`` and
  ``runner.fallback_materialized`` count the two routes.
- ``take_jobs`` gives, for any index list, each job's ext slices as the
  merged TileJobs holds them.
- On test_torch_pipeline's 9 kbp hybrid simulation, the native call
  followed by the classic engine's (LONG windows), and the route before
  it (every fallback's arms rebuilt, one classic-engine call), both
  write the FASTA of hypo_tpu's host engine.
"""
import hashlib

import numpy as np
import pytest
import torch

from hypo_tpu.config import InputFlags
from hypo_tpu.config import ScoreParams as JScoreParams
from hypo_tpu.config import get_kmer_len
from hypo_tpu.pipeline.polish import polish as polish_ref
from hypo_tpu.pipeline.window import Window as JWindow
from hypo_tpu.poa import full_runner as jfull
from hypo_tpu.sim import SimConfig, simulate
from hypo_tpu_torch.config import ScoreParams
from hypo_tpu_torch.entry import make_contig
from hypo_tpu_torch.native import host_api
from hypo_tpu_torch.pipeline.polish import polish
from hypo_tpu_torch.pipeline.window import LONG, SHORT
from hypo_tpu_torch.poa import full_runner as tfull
from hypo_tpu_torch.poa import host_runner
from hypo_tpu_torch.poa.engine import ConsensusEngine
from hypo_tpu_torch.utils import trace
from test_device_poa import mutate, rand_seq

CPU = torch.device("cpu")
# class caps lowered so that windows of 30-40 bp overflow a class-0 tile
SMALL = ((40, 80, 6, 2048, 4096), (100, 200, 6, 256, 512))
N_CLASSLESS, N_OVERFLOW = 3, 4

pytestmark = pytest.mark.skipif(not host_api.available(),
                                reason="the native host library did not build")


def _specs(seed):
    """(kind, wtype, draft, [(arm type, arm)]) of each window: arm type
    0 internal, 1 prefix, 2 suffix, as the arm table has them."""
    rng = np.random.default_rng(seed)
    out = []

    def mutants(base, n, rate):
        return [mutate(rng, base, rate) for _ in range(n)]

    for _ in range(6):
        base = rand_seq(rng, 28, 34)
        out.append(("tile", SHORT, base,
                    [(0, a) for a in mutants(base, 4, 0.04)]))
    base = rand_seq(rng, 28, 34)
    out.append(("trivial", SHORT, base, [(0, base)] * 3))
    base = rand_seq(rng, 28, 34)            # distinct arms beyond K = 6
    arms = []
    while len(set(arms)) < 9:
        arms.append(mutate(rng, base, 0.08))
    out.append(("classless", SHORT, base, [(0, a) for a in arms]))
    base = rand_seq(rng, 28, 34)
    out.append(("classless", SHORT, base,
                [(0, a) for a in list(dict.fromkeys(arms))[:3]]
                + [(0, a) for a in mutants(base, 8, 0.1)]))
    base = rand_seq(rng, 110, 120)          # arms beyond L = 100
    out.append(("classless", SHORT, base,
                [(0, a) for a in mutants(base, 4, 0.03)]))
    for _ in range(N_OVERFLOW):             # unrelated arms: > 80 nodes
        out.append(("overflow", SHORT, rand_seq(rng, 34, 37),
                    [(0, rand_seq(rng, 34, 37)) for _ in range(5)]))
    base = rand_seq(rng, 28, 34)            # an N in the draft, read by
    k = len(base) // 2                      # the builder (no internal
    draft = base[:k] + "N" + base[k + 1:]   # arm): no job
    out.append(("prefallback", SHORT, draft,
                [(1, base[:20]), (1, base[:24]), (2, base[-20:]),
                 (2, base[-22:])]))
    base = rand_seq(rng, 180, 200)
    out.append(("long", LONG, base, [(0, a) for a in mutants(base, 5, 0.05)]))
    return out


def _classic(specs):
    """Every window's consensus from the classic engine over its
    materialized arms."""
    ctg = make_contig(specs)
    short = [wi for wi, s in enumerate(specs) if s[1] == SHORT]
    host_runner.materialize_arms_bulk(ctg, short)
    engine = ConsensusEngine(ScoreParams())
    for w in ctg.windows:
        engine.generate_consensus(w)
    return [w.consensus for w in ctg.windows]


@pytest.fixture
def small_classes(monkeypatch):
    monkeypatch.setattr(tfull, "CLASSES", SMALL)
    monkeypatch.setattr(jfull, "CLASSES", SMALL)
    monkeypatch.setenv("HYPO_POA_NDEV", "1")


RUNNERS = {"full": lambda: tfull.FullDeviceRunner(ScoreParams(), CPU),
           "host": lambda: host_runner.HostTileRunner(ScoreParams())}


def _port_run(specs, runner):
    """The port's run_polish_batch with the recorder on: (consensus,
    stats, the runner's counters, the leftovers' spans)."""
    ctg = make_contig(specs)
    runner = RUNNERS[runner]()
    trace.RECORDER.reset()
    trace.enable()
    try:
        with trace.span("polish", root=True):
            assert runner.run_polish_batch([ctg]) == len(specs)
    finally:
        trace.disable()
    counts = {}
    for name, n, *_ in trace.RECORDER.counts:
        counts[name] = counts.get(name, 0) + n
    spans = {s.name: s for s in trace.RECORDER.spans
             if s.name.startswith("runner.")}
    trace.RECORDER.reset()
    return [w.consensus for w in ctg.windows], runner.stats, counts, spans


@pytest.mark.parametrize("runner", ["full", "host"])
def test_every_kind_of_window_keeps_its_consensus(small_classes, runner):
    """Both callers of finish_leftovers: the tile runner sends its
    classless and overflowed windows' jobs to the native jobs engine;
    the host runner finishes every job there itself; both leave the
    pre-fallback (arms rebuilt) and the LONG window to the classic
    engine."""
    specs = _specs(5)
    kinds = [k for k, *_ in specs]
    cons, st, counts, spans = _port_run(specs, runner)
    ref = _classic(specs)
    assert cons == ref
    assert all(c is not None for c in cons)
    assert cons[kinds.index("prefallback")]
    assert counts["runner.fallback_materialized"] == 1
    assert "runner.engine" in spans
    if runner == "host":
        assert st["fallbacks"] == 1 and st["host_long_windows"] == 2
        assert st["native_jobs"] == len(specs) - 3   # trivial, pre, LONG
        assert "runner.fallback_jobs" not in counts
        return
    jctg = make_contig(specs, JWindow)
    jrunner = jfull.FullDeviceRunner(JScoreParams())
    jrunner.run_polish_batch([jctg])
    assert [w.consensus for w in jctg.windows] == cons
    jst = jrunner.stats
    assert st["full_overflows"] == jst["full_overflows"] == N_OVERFLOW
    assert st["host_fallbacks"] == 1 + N_CLASSLESS + N_OVERFLOW
    assert st["host_long_windows"] == 1
    assert (st["host_long_windows"] + st["host_fallbacks"]
            == jst["host_long_windows"])
    for key in ("full_windows", "full_dispatches", "trivial_windows"):
        assert st[key] == jst[key], key
    assert counts["runner.fallback_jobs"] == N_CLASSLESS + N_OVERFLOW
    assert "runner.fallback_jobs" in spans


def _merged_jobs():
    """A merged TileJobs of two contigs' jobs."""
    parts = []
    for seed in (7, 8):
        specs = [s for s in _specs(seed) if s[1] == SHORT]
        ctg = make_contig(specs)
        n = len(specs)
        table, abuf, aoff = ctg._device_arm_data
        parts.append(host_api.tile_jobs(
            ctg.codes, ctg.reg_starts, np.ones(n, np.uint8),
            np.array([w.num_pre + w.num_suf > 0 for w in ctg.windows],
                     np.uint8), table, abuf, aoff))
    return host_runner.merge_tile_jobs(parts)


def _ext(jobs, j):
    """Job j's ext entries: (codes, mode, weight) each."""
    out = []
    for e in range(jobs.job_ext_off[j], jobs.job_ext_off[j + 1]):
        lo, hi = jobs.ext_off[e], jobs.ext_off[e + 1]
        assert hi - lo == jobs.ext_len[e]
        out.append((jobs.ext_buf[lo:hi].tobytes(), int(jobs.ext_mode[e]),
                    int(jobs.ext_w[e])))
    return out


@pytest.mark.parametrize("pick", ["all", "none", "one", "last", "reversed",
                                  "repeated", "random"])
def test_take_jobs_gives_each_jobs_ext_slices(pick):
    jobs = _merged_jobs()
    n = jobs.n_jobs
    assert n > 10
    idx = {"all": list(range(n)), "none": [], "one": [3], "last": [n - 1],
           "reversed": list(range(n))[::-1], "repeated": [2, 2, 5],
           "random": list(np.random.default_rng(1).choice(n, n // 2,
                                                          replace=False))
           }[pick]
    sub = host_runner.take_jobs(jobs, idx)
    assert sub.n_jobs == len(idx)
    assert sub.job_ext_off[0] == 0 and sub.ext_off[0] == 0
    assert len(sub.ext_off) == len(sub.ext_len) + 1 == sub.job_ext_off[-1] + 1
    assert len(sub.ext_buf) == sub.ext_off[-1]
    for k, j in enumerate(idx):
        assert _ext(sub, k) == _ext(jobs, j)
        assert sub.job_next[k] == jobs.job_next[j]
        assert sub.job_maxlen[k] == jobs.job_maxlen[j]


def _md5(path):
    with open(path, "rb") as fh:
        return hashlib.md5(fh.read()).hexdigest()


@pytest.fixture(scope="module")
def hybrid_sim(tmp_path_factory):
    """test_torch_pipeline's 9 kbp hybrid simulation and the md5 of the
    FASTA that hypo_tpu's native host engine polishes from it."""
    tmp = tmp_path_factory.mktemp("hybrid")
    paths = simulate(SimConfig(genome_size=9000, seed=22,
                               draft_error_rate=0.015, long_cov=25,
                               dropout=(0.4, 0.5)), str(tmp))
    ref = _flags(paths, tmp / "host.fa", False)
    polish_ref(ref)
    return paths, _md5(ref.output_filename)


def _flags(paths, out, device_poa):
    return InputFlags(
        sr_filenames=[paths["reads"]], sr_bam_filename=paths["sr_bam"],
        lr_bam_filename=paths["lr_bam"], draft_filename=paths["draft"],
        output_filename=str(out),
        k=max(2, get_kmer_len(str(paths["genome_size"]))),
        cov=paths["short_cov"], use_device_poa=device_poa,
        device_poa_mode="full")


def _one_classic_call(engine, threads, fallback, host_windows, jobs=None,
                      job_refs=(), left=()):
    """The route before the native jobs call: every fallback's arms
    rebuilt, one classic-engine call with the LONG windows."""
    host_runner.finish_leftovers(
        engine, threads, list(fallback) + [job_refs[j] for j in left],
        host_windows)


@pytest.mark.parametrize("route", ["native_jobs", "one_classic_call"])
def test_hybrid_fasta_with_and_without_the_native_call(
        hybrid_sim, tmp_path, monkeypatch, route):
    paths, md5 = hybrid_sim
    if route == "one_classic_call":
        monkeypatch.setattr(tfull, "finish_leftovers", _one_classic_call)
    flags = _flags(paths, tmp_path / f"{route}.fa", True)
    trace.RECORDER.reset()
    trace.enable()
    try:
        stats = polish(flags, device=CPU).device_runner.stats
    finally:
        trace.disable()
    spans = {s.name: s for s in trace.RECORDER.spans
             if s.name in ("runner.engine", "runner.fallback_jobs")}
    trace.RECORDER.reset()
    assert stats["host_long_windows"] > 0 and stats["host_fallbacks"] > 0
    if route == "native_jobs":
        assert set(spans) == {"runner.engine", "runner.fallback_jobs"}
        assert (spans["runner.fallback_jobs"].end
                <= spans["runner.engine"].start)
    else:
        assert set(spans) == {"runner.engine"}
    assert _md5(flags.output_filename) == md5
