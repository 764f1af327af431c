"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
resolves to its file."""

import json
import re
from pathlib import Path

import pytest

from harness import compare, manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (manifest.ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    named = [w for w in BENCH["command"] if "/" in w]
    assert named and all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in named)


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E and 0.0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_pairs_once_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    """The config file, the traffic file and every metric's reader of the
    cell load by name; the config's limits cover every number its reads
    give; the cell reports setup_s, another end-to-end metric and a
    per-layer metric whose end-to-end metric it reports."""
    entry = manifest.cell(BENCH, cell)
    cfg = manifest.config(BENCH, entry)
    assert {"params", "walk", "reads", "limits", "source"} <= set(cfg)
    mix = manifest.traffic(entry["traffic"])
    assert callable(manifest.generator(mix["generator"]))
    assert {compare.NUMBER_OF[r["call"]] for r in cfg["reads"]} == set(cfg["limits"])
    e2e = manifest.metrics(BENCH, cell, False)
    per_layer = manifest.metrics(BENCH, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    assert {m["moves"] for m in per_layer} <= {m["name"] for m in e2e}
    for m in e2e + per_layer:
        assert callable(manifest.reader(m["name"]))


def test_config_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in BENCH["paths"])
        assert (manifest.ROOT / f).is_file()


def test_per_layer_lists_cells():
    """A per-layer metric names the cells it is read in, each a cell that
    reports the metric it moves."""
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert m["moves"] in {e["name"] for e in manifest.metrics(BENCH, c, False)}


def test_files_named_from_name_characters():
    for f in Path(manifest.BENCH_DIR).rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        assert PATH.match(str(f.relative_to(manifest.ROOT))), f
