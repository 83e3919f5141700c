"""Finding a cell by its name: ``BENCHMARK.json`` at the checkout's root
names each cell's configuration and traffic mix, and the files beside this
one hold them, one file each, so that a cell, a configuration, a traffic
mix or a per-layer metric is added as new files and entries alone:

  bench/configs/<config>.json    the model as run, its source and cuts
  bench/traffic/<traffic>.json   the batches: rows, tokens, their law
  bench/workloads/<cell>.json    how the program runs the cell, the
                                 steps the reference follows, the limits
  bench/metrics/<metric>.py      ``read(trace)`` of one per-layer metric
  bench/reference/<name>.py      a model family's plain reference
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # bench/configs/<config>.json
    traffic: dict  # bench/traffic/<traffic>.json
    run: dict  # bench/workloads/<cell>.json
    end_to_end: List[dict]  # the BENCHMARK.json metrics this cell reports
    per_layer: List[dict]


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _load(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its three files.
    A cell kept out of ``BENCHMARK.json`` (its ``workloads`` file holds
    the entry it would have there, under ``entry``) is found too, for
    ``bench/control.py``."""
    bm = benchmark(root)
    bench = root / "bench"
    entries = {w["name"]: w for w in bm["workloads"]}
    path = bench / "workloads" / f"{name}.json"
    if name not in entries and not path.exists():
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    run = _load(path)
    w = entries.get(name) or run["entry"]
    return Cell(name=name, chips=w["chips"],
                config=_load(bench / "configs" / f"{w['config']}.json"),
                traffic=_load(bench / "traffic" / f"{w['traffic']}.json"),
                run=run,
                end_to_end=[m for m in bm["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bm["per_layer"] if _reports(m, name)])


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(metrics: List[dict]) -> Dict[str, ModuleType]:
    """Each per-layer metric's reader, ``bench/metrics/<name>.py``."""
    return {m["name"]: _module(BENCH / "metrics" / f"{m['name']}.py",
                               f"bench_metric_{m['name'].replace('.', '_')}")
            for m in metrics}


def reference(name: str) -> ModuleType:
    """A model family's plain reference, ``bench/reference/<name>.py``."""
    return importlib.import_module(f"bench.reference.{name}")
