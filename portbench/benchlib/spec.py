"""Everything a cell is made of, found by name: its entry in BENCHMARK.json,
the configuration file it names, the traffic file ``traffic/<name>.json``,
the kind of traffic ``kinds/<kind>.py`` that the traffic file names, and the
reader ``metrics/<metric>.py`` of each per-layer metric it reports. A kind
may name further files of its own the same way (``circuits/<name>.py``)."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: str = ""
    moves: str = ""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    readers: Dict[str, Callable] = field(default_factory=dict)
    bench_dir: str = BENCH_DIR


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_file(folder: str, name: str, bench_dir: str = BENCH_DIR):
    """The module <folder>/<name>.py of the benchmark, loaded from its path."""
    path = os.path.join(bench_dir, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no {folder}/{name}.py in {bench_dir}")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read(ctx)`` of metrics/<name>.py."""
    return load_file("metrics", name, bench_dir).read


def load_kind(c: Cell) -> Callable:
    """``run(cell, seed, seconds, tracer, dev, fault)`` of the cell's kind."""
    return load_file("kinds", c.traffic["kind"], c.bench_dir).run


def _metric(d: dict) -> Metric:
    return Metric(d["name"], d["unit"], d["better"], d["source"],
                  d.get("layer", ""), d.get("moves", ""))


def cell(name: str, bench: dict = None, root: str = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json (or of `bench`, a parsed
    file), its files read under `root`."""
    bench_dir = os.path.join(root, os.path.relpath(BENCH_DIR, ROOT))
    if bench is None:
        bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(os.path.join(root, conf["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    e2e = [_metric(m) for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m.name for m in e2e}
    layer = [_metric(m) for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name, w["chips"], config, traffic, e2e, layer,
                {m.name: load_reader(m.name, bench_dir) for m in layer}, bench_dir)
