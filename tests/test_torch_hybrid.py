"""HyPo's hybrid mode (``-B``) through the port's device path on the CPU,
at the small size of a 60 kbp draft with a short-read dropout and 2 kbp
long reads (``polishbench.gen``, the benchmark's generator):

- the polish through the CLI's flags (``--device-poa --device-poa-mode
  full``) equals the benchmark's plain reference (``polishbench.check``)
  on the dropout's stretch and one other, on two seeds;
- the long-read pass's spans nest under ``pipeline.long_arms``;
- the benchmark's three ``long.*`` readers read them and the runner's
  LONG windows, and read nothing on a short-read polish;
- the hybrid cell resolves through the registry, its mix's margin
  holds the longest long alignment;
- the recorder changes no base: the traced polish and an untraced one
  are byte-equal.
"""
import os
import sys

import pytest
import torch

from hypo_tpu_torch.cli import build_parser, flags_from_args
from hypo_tpu_torch.native import host_api
from hypo_tpu_torch.pipeline.polish import Polisher
from hypo_tpu_torch.utils import trace
import polishbench
from polishbench import check, gen, registry
from polishbench.run import cli_argv, flags_k

CPU = torch.device("cpu")
SEEDS = [4294967311, 2147483659]
GENOME = 60000
CFG = {"genome": {"genome_size": GENOME, "num_contigs": 1,
                  "draft_error_rate": 0.01},
       "polisher": {"size_ref": str(GENOME), "kind_sr": "sr", "threads": 2,
                    "device_poa_mode": "full", "device_poa": True}}
MIX = {"reads": {"short_cov": 30, "short_len": 150, "short_err": 0.002,
                 "long_cov": 25, "long_len": 2000, "long_err": 0.05,
                 "dropout": [0.30, 0.33]},
       "check": {"count": 1, "bp": 10000, "margin": 3000, "pad": 1000,
                 "dropout_zone": True}}
READERS = ("long.load_s", "long.arms_s", "long.window_share")


class _Window:
    """What a metric reader reads of a traced run: its window and the
    runner's stats."""
    window = (0.0, float("inf"))

    def __init__(self, stats):
        self.stats = stats


def _polish(inputs, out_dir, traced=False):
    """One polish as the benchmark's run does it; returns (the Polisher,
    the polished FASTA's path, spans, counter additions)."""
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "polished.fa")
    argv = cli_argv(CFG, MIX, inputs, out, os.path.join(out_dir, "aux"))
    flags = flags_from_args(build_parser().parse_args(argv))
    was = trace.active()
    trace.RECORDER.reset()
    (trace.enable if traced else trace.disable)()
    try:
        p = Polisher(flags, CPU)
        p.polish()
    finally:
        (trace.enable if was else trace.disable)()
    spans, counts = list(trace.RECORDER.spans), list(trace.RECORDER.counts)
    trace.RECORDER.reset()
    return p, out, spans, counts


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """``made(seed)``: the seed's inputs and its polish, made once (the
    first seed's polish traced): (seed, inputs, Polisher, polished FASTA,
    spans, counter additions)."""
    if not host_api.available():
        pytest.skip("the native host library did not build")
    cache = {}

    def make(seed):
        if seed not in cache:
            tmp = tmp_path_factory.mktemp(f"hybrid_{seed}")
            inputs = gen.simulate_cell(str(tmp / "in"), seed, CFG, MIX)
            cache[seed] = (seed, inputs) + _polish(
                inputs, str(tmp / "out"), traced=seed == SEEDS[0])
        return cache[seed]
    return make


@pytest.fixture(params=SEEDS)
def hybrid(request, made):
    return made(request.param)


@pytest.fixture
def traced(made):
    _seed, inputs, p, _out, spans, counts = made(SEEDS[0])
    return inputs, p, spans, counts


def test_polish_equals_the_reference(hybrid):
    seed, inputs, _p, out, _s, _c = hybrid
    name, draft = check.read_fasta(inputs["draft"])[0]
    stretches = check.plan(seed, len(draft), MIX)
    assert len(stretches) == 2
    lo, hi = (int(f * len(draft)) for f in MIX["reads"]["dropout"])
    assert any(a < lo and hi < b for a, b in stretches)
    ref = check.Reference(inputs, flags_k(CFG), MIX["reads"]["short_cov"],
                          MIX["check"], stretches, workers=2)
    texts = ref.run()
    assert ref.stats["long_windows"] > 0
    checks, correct = check.verdict([out], name, texts, ref.stats)
    assert correct, checks
    assert checks["stretches_unchecked"]["value"] == 0


def test_long_spans_nest(traced):
    _inputs, p, spans, _counts = traced
    by_id = {s.id: s for s in spans}
    parent = {s.name: by_id[s.parent].name for s in spans
              if s.parent is not None}
    assert parent["pipeline.long_load"] == "pipeline.long_arms"
    assert parent["pipeline.long_find"] == "pipeline.long_arms"
    assert sum(1 for s in spans if s.name == "pipeline.long_load") == 1
    assert p.device_runner.stats["host_long_windows"] > 0


@pytest.fixture
def readers():
    """The benchmark's ``long.*`` readers.  Loading them imports
    ``polishbench.program_spans``, which turns the recorder on for the
    process; where this loads it first, it is dropped again after, with
    the recorder off, so that the next loader turns the recorder on as a
    traced run does.  Else the recorder's state is put back."""
    fresh = "polishbench.program_spans" not in sys.modules
    was = trace.active()
    out = {n: registry.metric_reader(n) for n in READERS}
    trace.disable()
    yield out
    trace.RECORDER.reset()
    if fresh:
        sys.modules.pop("polishbench.program_spans", None)
        if hasattr(polishbench, "program_spans"):
            delattr(polishbench, "program_spans")
    (trace.enable if was and not fresh else trace.disable)()


def test_readers_read_the_long_pass(traced, readers, tmp_path):
    inputs, p, spans, counts = traced
    rec = trace.RECORDER
    rec.spans, rec.counts = spans, counts
    st = p.device_runner.stats
    got = {n: r(_Window(st)) for n, r in readers.items()}
    roots = sum(1 for s in spans if s.name == "polish")
    assert roots == 1
    assert got["long.load_s"] == pytest.approx(
        trace.seconds(spans, "pipeline.long_load"))
    assert got["long.arms_s"] == pytest.approx(
        trace.seconds(spans, "pipeline.long_find"))
    assert got["long.window_share"] == pytest.approx(
        100.0 * st["host_long_windows"]
        / (sum(st["class_windows"]) - st["full_overflows"]
           + st["host_long_windows"] + st["host_fallbacks"]))
    assert all(v > 0 for v in got.values()), got
    # a short-read polish: the same inputs without -B
    sr = dict(inputs, lr_bam=None)
    p2, _out, spans, counts = _polish(sr, str(tmp_path / "sr"), traced=True)
    rec.spans, rec.counts = spans, counts
    assert {n: r(_Window(p2.device_runner.stats))
            for n, r in readers.items()} == {
        n: None for n in READERS}


def test_tracing_changes_no_base(made, tmp_path):
    """The first seed's polish ran with the recorder on; the same polish
    with it off writes the same bytes."""
    _seed, inputs, _p, out, spans, _counts = made(SEEDS[0])
    assert spans
    _p2, out2, spans2, _counts2 = _polish(inputs, str(tmp_path / "off"))
    assert not spans2
    with open(out, "rb") as a, open(out2, "rb") as b:
        assert a.read() == b.read()


def test_the_hybrid_cell_resolves():
    cell = registry.Cell("bact4m_hybrid.sr30_lr25", registry.benchmark())
    assert cell.chips == 1
    reads, chk = cell.mix["reads"], cell.mix["check"]
    assert chk["dropout_zone"] and reads["dropout"] == [0.30, 0.30754]
    assert chk["margin"] >= reads["long_len"] * (1 + reads["long_err"])
    assert cell.config["genome"]["genome_size"] == 4641652
    assert set(cell.config["reduced"]) == {"dropout", "long_len",
                                           "long_err"}
    assert [m["name"] for m in cell.per_layer] == list(READERS) + [
        "runner.fallback_jobs_s", "runner.fallback_native_share"]
    assert {m["name"] for m in cell.end_to_end} == {"polish_kbp_per_s",
                                                    "setup_s"}
