"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration, whose file holds the
classy parameters at the centre of the walk, the walked parameters with
their widths, the accessors the cell's likelihood reads and the limits of
the comparison; and a traffic mix, `benchmark/traffic/<traffic>.json`, whose
`generator` names `benchmark/traffic/<generator>.py`, whose
`points(config, mix, seed)` yields the points. Each metric is read by
`benchmark/metrics/<name>.py`, whose `read(run)` returns its value or None
where the run holds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def cell(manifest: dict, name: str) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def config(manifest: dict, cell_entry: dict) -> dict:
    """The configuration file of a cell, with its manifest entry's name."""
    entry = _by_name(manifest["configs"], cell_entry["config"], "config")
    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)
    cfg["name"] = entry["name"]
    return cfg


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end metrics untraced,
    its per-layer metrics traced (an entry without `workloads` holds in
    every cell)."""
    entries = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def _module(folder: str, name: str, what: str):
    path = BENCH_DIR / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {what} {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The `read(run)` function of benchmark/metrics/<name>.py."""
    return _module("metrics", name, "reader for metric").read


def generator(name: str):
    """The `points(config, mix, seed)` function of benchmark/traffic/<name>.py."""
    return _module("traffic", name, "traffic generator").points
