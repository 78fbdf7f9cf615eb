"""The port's span and counter recorder (``hypo_tpu_torch.utils.trace``)
on the CPU, on a 20 kbp short-read polish through the device path's CPU
tile (as ``test_torch_bench.py``'s ``polished_20k``) and a 20 kbp hybrid
one:

- every span of the program's table appears (``tiles.capture`` only on
  a card: the card-only case below), in one tree per polish rooted at
  ``polish``, each child inside its parent;
- the Monitor's stage spans do not overlap, and lie inside ``polish``
  with ``pipeline.runner_setup``;
- ``runner.materialize`` + ``runner.engine`` + ``runner.fallback_jobs``
  is ``runner.leftovers``;
- the step counters: 0 < active window steps <= window steps, as the
  tiles' arm counts give them; the region counters: every region divided
  through the native call;
- each span is a profiler range on the profiler's timeline, at its
  host times once tied by an anchor;
- off, ``span()`` is the shared no-op, and a polish records nothing and
  opens no profiler range;
- ``--trace-out`` writes Chrome trace JSON with one event per span.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from hypo_tpu_torch import cli
from hypo_tpu_torch.config import InputFlags, ScoreParams, get_kmer_len
from hypo_tpu_torch.native import host_api
from hypo_tpu_torch.pipeline.polish import Polisher
from hypo_tpu_torch.poa import device_full as TF
from hypo_tpu_torch.poa import full_runner as tfull
from hypo_tpu_torch.sim import SimConfig, simulate
from hypo_tpu_torch.utils import trace

CPU = torch.device("cpu")
STAGES = ("pipeline.load_contigs", "pipeline.solid_kmers",
          "pipeline.solid_positions", "pipeline.load_short_alignments",
          "pipeline.kmer_support", "pipeline.strong_regions",
          "pipeline.minimizer_support", "pipeline.window_division",
          "pipeline.short_arms", "pipeline.window_fill",
          "pipeline.long_arms", "pipeline.poa", "pipeline.write")
TABLE = {"polish", "pipeline.runner_setup", *STAGES,
         "pipeline.fastq_decode", "pipeline.bam_prefetch", "runner.jobs",
         "runner.jobs_native", "tiles.pack", "tiles.issue",
         "tiles.warm_wait", "tiles.drain", "tiles.readback",
         "tiles.finalize", "runner.leftovers", "runner.materialize",
         "runner.fallback_jobs"}
# the hybrid polish's long-read pass, under ``pipeline.long_arms``, and
# the classic engine's call for its LONG windows
LONG = {"pipeline.long_load", "pipeline.long_find", "runner.engine"}


@pytest.fixture
def recorder():
    """The process's recorder, empty and off before and after."""
    trace.disable()
    trace.RECORDER.reset()
    yield trace.RECORDER
    trace.disable()
    trace.RECORDER.reset()


def _flags(paths, out_dir, **kw):
    return InputFlags(
        sr_filenames=[paths["reads"]], sr_bam_filename=paths["sr_bam"],
        lr_bam_filename=paths.get("lr_bam") or "",
        draft_filename=paths["draft"],
        output_filename=os.path.join(out_dir, "out.fa"),
        aux_dir=os.path.join(out_dir, "aux"),
        k=max(2, get_kmer_len(str(paths["genome_size"]))),
        cov=paths["short_cov"], use_device_poa=True, device_poa_mode="full",
        **kw)


def _polish(paths, out_dir, profiled=False):
    """One device-path polish on the CPU tile with the recorder on;
    returns (spans, counts, (the profiler, the anchor's host time) or
    None)."""
    os.makedirs(out_dir, exist_ok=True)
    trace.RECORDER.reset()
    trace.enable()
    try:
        if profiled:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                anchor = _anchor()
                Polisher(_flags(paths, out_dir), device=CPU).polish()
            prof = (prof, anchor)
        else:
            prof = None
            Polisher(_flags(paths, out_dir), device=CPU).polish()
    finally:
        trace.disable()
    rec = trace.RECORDER
    spans, counts = list(rec.spans), list(rec.counts)
    rec.reset()
    return spans, counts, prof


def _anchor():
    """A host clock reading taken just before a profiler range opens, as
    a span's start is.  A session's first range pays the profiler's
    set-up (about 1 ms here), so one range goes first."""
    with torch.profiler.record_function("test.warm"):
        pass
    t = time.perf_counter()
    with torch.profiler.record_function("test.anchor"):
        return t


def _ranges(prof):
    """The profiler's events as (name, start s, end s, kind), read from
    its raw results (``prof.events()`` takes a minute on a polish)."""
    return [(e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9,
             e.activity_type())
            for e in prof.profiler.kineto_results.events()]


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    if not host_api.available():
        pytest.skip("the native host library did not build")
    tmp = tmp_path_factory.mktemp("trace_sims")
    sr = simulate(SimConfig(genome_size=20000, seed=1), str(tmp / "sr"))
    hy = simulate(SimConfig(genome_size=20000, seed=3, long_cov=10,
                            long_len=2000), str(tmp / "hybrid"))
    return tmp, sr, hy


@pytest.fixture(scope="module")
def traced(sims):
    """The short-read polish traced under the profiler, and the hybrid
    one traced: {name: (spans, counts, profiler)}."""
    tmp, sr, hy = sims
    trace.disable()
    out = {"sr": _polish(sr, str(tmp / "out_sr"), profiled=True),
           "hybrid": _polish(hy, str(tmp / "out_hy"))}
    trace.RECORDER.reset()
    return out


def _roots(spans):
    return [s for s in spans if s.name == "polish"]


@pytest.mark.parametrize("run", ["sr", "hybrid"])
def test_every_span_of_the_table_appears(traced, run):
    spans, _c, _p = traced[run]
    names = {s.name for s in spans}
    want = (TABLE | LONG if run == "hybrid"
            else TABLE - {"pipeline.long_arms"})
    assert want <= names, sorted(want - names)
    assert "tiles.capture" not in names       # CUDA graphs: card only
    assert len(_roots(spans)) == 1
    root = _roots(spans)[0]
    assert root.attrs == {"draft_bp": root.attrs["draft_bp"], "contigs": 1}
    assert 19000 < root.attrs["draft_bp"] < 21000


@pytest.mark.parametrize("run", ["sr", "hybrid"])
def test_spans_form_one_tree_per_polish(traced, run):
    """One root; every other span's parent is in the tree and the same
    polish; a child on its parent's thread lies inside it, one on
    another thread (the warm-up's) starts inside it and ends inside the
    root."""
    spans, _c, _p = traced[run]
    (root,) = _roots(spans)
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.polish == root.id, s.name
        assert s.end >= s.start
        if s is root:
            assert s.parent is None
            continue
        parent = by_id[s.parent]
        assert parent.start <= s.start, (s.name, parent.name)
        if s.thread == parent.thread:
            assert s.end <= parent.end, (s.name, parent.name)
        else:
            assert s.start <= parent.end and s.end <= root.end


def test_stage_spans_do_not_overlap(traced):
    spans, _c, _p = traced["sr"]
    (root,) = _roots(spans)
    stages = sorted((s for s in spans if s.name in STAGES),
                    key=lambda s: s.start)
    assert [s.name for s in stages] == [n for n in STAGES
                                        if n != "pipeline.long_arms"]
    for a, b in zip(stages, stages[1:]):
        assert a.end <= b.start, (a.name, b.name)
    (setup,) = [s for s in spans if s.name == "pipeline.runner_setup"]
    for s in stages + [setup]:
        assert s.parent == root.id
        assert root.start <= s.start and s.end <= root.end
    assert setup.end <= stages[0].start


@pytest.mark.parametrize("run", ["sr", "hybrid"])
def test_leftovers_split_into_materialize_and_engine(traced, run):
    spans, _c, _p = traced[run]
    secs = {n: trace.seconds(spans, n) for n in (
        "runner.leftovers", "runner.materialize", "runner.engine",
        "runner.fallback_jobs")}
    assert secs["runner.engine"] + secs["runner.fallback_jobs"] > 0
    assert (secs["runner.materialize"] + secs["runner.engine"]
            + secs["runner.fallback_jobs"]
            == pytest.approx(secs["runner.leftovers"], rel=0.02, abs=1e-3))
    assert trace.seconds(spans, "runner.jobs_native") <= trace.seconds(
        spans, "runner.jobs")


def test_step_counters(traced):
    _s, counts, _p = traced["sr"]
    total = {n: sum(c[1] for c in counts if c[0] == n)
             for n in ("tiles.window_steps", "tiles.active_window_steps")}
    assert 0 < total["tiles.active_window_steps"] <= total[
        "tiles.window_steps"]


@pytest.mark.parametrize("run", ["sr", "hybrid"])
def test_region_counters(traced, run):
    """The polish's regions all divided through the native call (a few
    hundred on 20 kbp), none through the Python walk."""
    spans, counts, _p = traced[run]
    total = {}
    for name, n, *_ in counts:
        total[name] = total.get(name, 0) + n
    assert total.get("pipeline.regions_python", 0) == 0
    n_regions = total["pipeline.regions_native"]
    (root,) = _roots(spans)
    assert 200 < n_regions < root.attrs["draft_bp"] / 5


def test_step_counters_count_rows_times_kmax(recorder):
    """One tile of two blocks: window steps are rows x the block's most
    arms, active ones the arms."""
    kw = dict(N=64, L=16, K=4, P=8, m=5, n=-4, g=-8, B=8, A=16)
    prog = TF.build_tile_program(**kw, devices=[CPU, CPU])
    narms = np.array([1, 3, 0, 2, 4, 0, 0, 1], np.int32)
    idx = np.where(np.arange(4)[None, :] < narms[:, None], 0, -1)
    trace.enable()
    prog(np.ones((16, 16), np.int8), np.full(16, 8, np.int32),
         idx.astype(np.int32), np.zeros((8, 4), np.int8),
         np.ones((8, 4), np.int32), narms, np.zeros(8, np.int32))
    trace.disable()
    got = [(c[0], c[1]) for c in recorder.counts]
    assert got == [("tiles.window_steps", 4 * 3),
                   ("tiles.active_window_steps", 6),
                   ("tiles.window_steps", 4 * 4),
                   ("tiles.active_window_steps", 5)]


def test_spans_sit_on_the_profilers_timeline(traced):
    """Each span opened a profiler range of its name, of the op kind (a
    user annotation would be mirrored onto the device's row); in order,
    each range's ends lie at the span's host times once the anchor ties
    the clocks.  On a loaded CPU the process can lose its core between
    a clock read and the range's own (8 ms seen under the test workers),
    so the median is held to 1 ms, nine spans in ten to 5 ms and every
    one to 100 ms; a clock not tied, or a range opened at the wrong end,
    moves them all.  The card's run is held to 1 ms for every span
    (``tools/trace_check``).  The profiler records the ranges of the
    thread that started it, so the spans held are the polish's thread's;
    the input pass's producer threads open none."""
    spans, _c, (prof, host_anchor) = traced["sr"]
    (root,) = _roots(spans)
    others = {s.name for s in spans if s.thread != root.thread}
    assert others == {"pipeline.fastq_decode", "pipeline.bam_prefetch"}
    spans = [s for s in spans if s.thread == root.thread]
    events = _ranges(prof)
    assert not [e for e in events if e[0] in others]
    (anchor,) = [e for e in events if e[0] == "test.anchor"]
    off = host_anchor - anchor[1]
    devs = []
    for name in {s.name for s in spans}:
        mine = sorted((s for s in spans if s.name == name),
                      key=lambda s: s.start)
        ranges = sorted(e for e in events if e[0] == name)
        assert len(ranges) == len(mine), name
        assert {e[3] for e in ranges} == {"cpu_op"}, name
        for s, (_n, start, end, _k) in zip(mine, ranges):
            devs.append(max(abs(start + off - s.start),
                            abs(end + off - s.end)))
    devs.sort()
    assert len(devs) == len(spans)
    assert devs[len(devs) // 2] < 1e-3
    assert devs[int(0.9 * len(devs))] < 5e-3
    assert devs[-1] < 0.1


def test_off_records_nothing_and_opens_no_range(sims, recorder, tmp_path):
    assert trace.span("x") is trace.NULL
    assert trace.span("x", root=True) is trace.NULL
    with trace.span("x") as sp:
        sp.set(a=1)
    timed = trace.span("x", timed=True)
    assert isinstance(timed, trace.Timed)
    timed.close()
    assert timed.seconds >= 0
    trace.count("tiles.window_steps", 3)
    assert trace.current() is None
    _tmp, sr, _hy = sims
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        Polisher(_flags(sr, str(tmp_path)), device=CPU).polish()
    assert recorder.spans == [] and recorder.counts == []
    names = {e[0] for e in _ranges(prof)}
    assert "aten::add" in names or len(names) > 10    # the polish's ops
    assert not names & (TABLE | {"tiles.dispatch", "tiles.collect"})


def test_a_thread_under_a_parent(recorder):
    """A thread's spans hang under the parent it is given, in the
    parent's polish; the parent stays open on its own thread."""
    trace.enable()
    root = trace.span("polish", root=True)
    parent = trace.span("pipeline.runner_setup")

    def work():
        with trace.under(parent):
            with trace.span("tiles.capture"):
                pass
        with trace.span("orphan"):
            pass

    t = threading.Thread(target=work, name="worker")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    parent.close()
    root.close()
    by = {s.name: s for s in recorder.spans}
    cap = by["tiles.capture"]
    assert (cap.parent, cap.polish, cap.thread) == (parent.id, root.id,
                                                   "worker")
    assert by["orphan"].parent is None and by["orphan"].polish is None
    assert [s.name for s in recorder.spans][-2:] == [
        "pipeline.runner_setup", "polish"]


def test_a_new_root_drops_what_an_error_left_open(recorder):
    trace.enable()
    trace.span("polish", root=True)
    trace.span("pipeline.poa")                 # never closed: an error
    root = trace.span("polish", root=True)
    with trace.span("pipeline.write") as sp:
        pass
    root.close()
    assert [s.name for s in recorder.spans] == ["pipeline.write", "polish"]
    assert sp.parent == root.id


def test_trace_out_writes_chrome_json(sims, recorder, tmp_path):
    """The host engine's polish from the CLI: the file parses, holds one
    complete event per span the run recorded, with its ids, and the
    HostTileRunner's spans; the recorder is off again afterwards."""
    _tmp, sr, _hy = sims
    path = tmp_path / "trace.json"
    cli.run(["-r", sr["reads"], "-d", sr["draft"], "-b", sr["sr_bam"],
             "-c", "30", "-s", "20000", "-t", "2", "-o",
             str(tmp_path / "out.fa"), "--aux-dir", str(tmp_path / "aux"),
             "--no-device-poa", "--trace-out", str(path)])
    assert not trace.active()
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == len(recorder.spans) > 0
    assert {e["args"]["id"] for e in spans} == {
        s.id for s in recorder.spans}
    names = {e["name"] for e in spans}
    assert {"polish", "pipeline.poa", "runner.jobs", "runner.jobs_native",
            "runner.jobs_consensus", "runner.leftovers"} <= names
    for e in spans:
        assert e["dur"] >= 0 and {"parent", "polish", "thread"} <= set(
            e["args"])


def test_idle_gaps_by_span_cut_at_the_innermost_span():
    """``trace_check``'s idle gaps: the card idle in [0, 1) and [2, 10),
    cut at the spans' bounds, each piece named for the latest-begun span
    open there."""
    from collections import namedtuple

    from hypo_tpu_torch.tools.trace_check import idle_gaps_by_span
    S = namedtuple("S", "name start end")
    spans = [S("polish", 0.0, 10.0), S("pipeline.poa", 0.5, 6.0),
             S("tiles.issue", 1.5, 3.0)]
    top, by = idle_gaps_by_span([("kernel", 1.0, 2.0)], spans, 0.0, 10.0)
    assert top == [["polish", 4.0], ["pipeline.poa", 3.0],
                   ["tiles.issue", 1.0], ["polish", 0.5],
                   ["pipeline.poa", 0.5]]
    assert by == {"polish": 4.5, "pipeline.poa": 3.5, "tiles.issue": 1.0}


def test_clock_deviation_pairs_spans_with_their_ranges():
    from collections import namedtuple

    from hypo_tpu_torch.tools.trace_check import clock_deviation
    S = namedtuple("S", "name start end")
    spans = [S("a", 3.0, 4.0), S("a", 1.0, 2.0), S("b", 1.5, 1.6)]
    ranges = [("a", 1.0001, 2.0), ("a", 3.0, 4.0003), ("b", 1.5, 1.6),
              ("aten::add", 1.2, 1.3)]
    worst, paired = clock_deviation(spans, ranges)
    assert paired == 3 and worst == pytest.approx(3e-4)
    with pytest.raises(RuntimeError, match="2 spans 'a' but 1"):
        clock_deviation(spans, ranges[1:])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_warm_up_capture_spans_on_the_card(cuda_device, recorder):
    """On the card, the warm-up thread's graph capture is a
    ``tiles.capture`` span under the span that called ``warm``, with the
    capture's seconds and the reserved bytes' growth."""
    runner = tfull.FullDeviceRunner(ScoreParams(), cuda_device)
    trace.enable()
    with trace.span("polish", root=True) as root:
        with trace.span("pipeline.runner_setup") as setup:
            runner.warm()
        runner._join_warm()
    trace.disable()
    caps = [s for s in recorder.spans if s.name == "tiles.capture"]
    assert caps
    for s in caps:
        assert (s.parent, s.polish, s.thread) == (setup.id, root.id,
                                                 "hypo-tile-warm")
        assert s.attrs["seconds"] > 0 and s.attrs["reserved_growth"] >= 0
        assert s.seconds >= s.attrs["seconds"]
