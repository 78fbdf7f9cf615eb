"""The registry finds every configuration, mix and metric reader by the
names in BENCHMARK.json, and refuses a name it does not hold."""
import json
import os

import pytest

from polishbench import registry

BENCH = registry.benchmark()


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(w):
    cell = registry.Cell(w["name"], BENCH)
    assert cell.config["name"] == w["config"]
    assert cell.mix["name"] == w["traffic"]
    assert {m["name"] for m in cell.end_to_end} == {
        "polish_kbp_per_s", "setup_s"}
    readers = cell.readers()
    assert readers and all(callable(r) for r in readers.values())


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_registrys(c):
    with open(os.path.join(registry.ROOT, c["file"])) as fh:
        assert json.load(fh) == registry.config(c["name"])
    cfg = registry.config(c["name"])
    assert cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("kind,lookup", [
    ("config", registry.config), ("mix", registry.mix),
    ("metric", registry.metric_reader),
    ("cell", lambda n: registry.Cell(n, BENCH))])
def test_unknown_name_fails(kind, lookup):
    with pytest.raises(registry.UnknownName):
        lookup(f"no_such_{kind}")


def test_names_and_units_are_well_formed():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert name.match(entry["name"]), entry["name"]
    for m in metrics:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    moved = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in moved for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_kernel_time_counts_the_five_kernels_only():
    """``kernels.device_ms`` sums the port's hand-written kernels alone:
    the tile program's torch ops and the copies are another layer's."""
    from polishbench.trace import Trace
    acts = [
        ("void (anonymous namespace)::poa_dp_kernel<4>(int const*)",
         0.0, 0.002),
        ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::FillFunctor<int> >(int)", 0.002, 0.010),
        ("Memcpy HtoD (Pinned -> Device)", 0.010, 0.020),
        ("void (anonymous namespace)::heaviest_bundle_kernel<2>(int const*)",
         0.020, 0.021),
    ]
    read = registry.metric_reader("kernels.device_ms")
    traced = Trace(2, (0.0, 1.0), [], [], {}, {}, 0, acts)
    assert read(traced) == pytest.approx(1.5)
    assert read(Trace(2, (0.0, 1.0), [], [], {}, {}, 0, acts[1:3])) is None
