"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by its name:

* ``benchmark/configs/<config>.json``: the model, the CLI flags it runs
  with, its ``task`` and its check limits;
* ``benchmark/traffic/<traffic>.json``: the feed's parameters (where the
  frames live, loader workers, prefetch depth, the corpus);
* ``benchmark/metrics/<metric>.py``: a reader ``read(reading)`` that
  returns the metric's value, or ``None`` when the run shows nothing to
  read;
* ``benchmark/tasks/<task>.py`` drives the program for a kind of training
  step, and ``benchmark/reference/<task>.py`` is its plain reference.

A cell of ``workloads`` is one configuration under one traffic mix.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "benchmark", "configs", f"{name}.json"))


def traffic(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "benchmark", "traffic", f"{name}.json"))


def reader(name: str, root: str = ROOT):
    """``read`` of ``metrics/<name>.py`` (the name may hold dots)."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def task(name: str):
    return importlib.import_module(f"tasks.{name}")


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``metric`` is reported in ``cell``: it lists the cell, or it
    lists none and the cell reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


@dataclass
class Cell:
    """One run of one cell."""

    name: str
    seed: int
    seconds: float
    trace: bool
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    root: str = ROOT
    device: str = "cuda"
    fault: Optional[str] = None  # a planted fault, for the checks' own tests
    cache: Optional[str] = None  # where the run's files go; the checkout's by default

    @property
    def scratch(self) -> str:
        """The run's files (the corpus, a trace): ``.bench_cache`` in the
        checkout, unless ``cache`` says otherwise."""
        return self.cache or os.path.join(self.root, ".bench_cache")

    @classmethod
    def load(cls, name: str, seed: int, seconds: float, trace: bool, root: str = ROOT,
             **kw) -> "Cell":
        bench = benchmark(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        return cls(name=name, seed=seed, seconds=seconds, trace=trace, bench=bench,
                   workload=w, config=config(w["config"], root),
                   traffic=traffic(w["traffic"], root), root=root, **kw)

    @property
    def program_seed(self) -> int:
        """The seed handed to the program (its loaders seed numpy, which
        takes 32 bits; the streams add up to 2048 and the epochs one each)."""
        return self.seed % (2**32 - 2**20)

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self):
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"] if reports(m, self.name, e2e)]
