"""Everything the harness runs, found by the names in ``BENCHMARK.json``:

- a cell ``<config>.<mix>``: an entry of ``workloads``;
- a configuration: ``configs/<config>.json`` (the deployment: genome,
  polisher flags, what was reduced and assumed);
- a traffic mix: ``mixes/<mix>.json`` (the reads the generator makes,
  and the stretches the correctness check draws);
- a per-layer metric: ``metrics/<metric>.py``, whose ``read(trace)``
  returns the metric's value from a traced run, or None where it finds
  nothing to read.

A later cell, configuration, mix or metric is a new file and a new entry
of ``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class UnknownName(KeyError):
    """A name that BENCHMARK.json or the benchmark's folders do not hold."""


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise UnknownName(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def config(name: str) -> dict:
    return _json("configs", name)


def mix(name: str) -> dict:
    return _json("mixes", name)


def metric_reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise UnknownName(f"no metric reader named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"polishbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """One entry of ``workloads`` with its configuration, mix and
    metrics."""

    def __init__(self, name: str, bench: dict):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise UnknownName(f"no workload named {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = config(self.entry["config"])
        self.mix = mix(self.entry["traffic"])
        self.end_to_end = self._metrics(bench["end_to_end"])
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self._metrics(bench["per_layer"])
                          if "workloads" in m or m["moves"] in moved]

    def _metrics(self, entries: List[dict]) -> List[dict]:
        return [m for m in entries
                if self.name in m.get("workloads", [self.name])]

    def readers(self) -> Dict[str, Callable]:
        return {m["name"]: metric_reader(m["name"]) for m in self.per_layer}
