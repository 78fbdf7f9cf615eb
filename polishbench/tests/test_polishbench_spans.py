"""The metric readers of the port's own spans and counters
(``program_spans``) in a traced run on the CPU, at the small cell of
``conftest.TINY``: each gives a number, the numbers add up to the
harness's own timers, and a port without the recorder gives none."""
import pytest

from test_polishbench_run import _run

NEW = ("pipeline.kmers_s", "pipeline.alignments_s", "pipeline.segment_s",
       "pipeline.arms_s", "pipeline.other_s", "runner.materialize_s",
       "runner.engine_s", "runner.jobs_native_s", "tiles.warm_wait_s",
       "tiles.capture_s", "tiles.step_fill")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        res = _run(mp, tmp_path_factory.mktemp("spans"), trace=1)
    finally:
        mp.undo()
    return {k: v["value"] for k, v in res["metrics"].items()}, res


def test_each_new_reader_gives_a_number(traced):
    m, res = traced
    assert res["correct"] is True
    assert set(NEW) <= set(m), sorted(set(NEW) - set(m))
    assert all(m[k] >= 0 for k in NEW)
    assert m["tiles.capture_s"] == 0            # no CUDA graphs here


def test_the_numbers_add_up_to_the_harness_timers(traced):
    m, _res = traced
    parts = sum(m[k] for k in ("pipeline.kmers_s", "pipeline.alignments_s",
                               "pipeline.segment_s", "pipeline.arms_s",
                               "pipeline.other_s"))
    assert parts == pytest.approx(m["pipeline.host_s"], rel=0.02)
    assert (m["runner.materialize_s"] + m["runner.engine_s"]
            == pytest.approx(m["runner.leftovers_s"], rel=0.02, abs=2e-3))
    assert m["runner.jobs_native_s"] <= m["runner.jobs_s"]
    assert 0 < m["tiles.step_fill"] <= 100


def test_a_port_without_the_recorder_reads_nothing(monkeypatch):
    from polishbench import program_spans, registry
    monkeypatch.setattr(program_spans, "RECORDER", None)

    class T:
        window = (0.0, 1e12)
        polishes = 1
    for name in NEW:
        reader = registry.metric_reader(name)
        assert reader(T()) is None, name
