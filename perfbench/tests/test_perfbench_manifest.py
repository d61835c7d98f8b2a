"""BENCHMARK.json against the benchmark's contract, and the discovery of
each cell's files by name."""

import json
import os
import re

import pytest

from perfbench.core import cell

ROOT = cell.ROOT
BENCH = cell.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_paths_and_command():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word
    assert cmd[1].startswith(BENCH["paths"][0] + "/")


def _entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            yield key, e


@pytest.mark.parametrize("key,entry", list(_entries()),
                         ids=lambda v: v if isinstance(v, str) else v["name"])
def test_names_and_units(key, entry):
    assert NAME.match(entry["name"]), entry["name"]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    for k in ("why", "layer", "source"):
        if k in entry and key != "end_to_end" and key != "per_layer":
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]
    if key == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(r) for r in entry["reduced"])
    if key == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] == 1
    if key == "end_to_end":
        assert set(entry) - {"workloads"} == {"name", "unit", "better",
                                              "bound", "source"}
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "per_layer":
        assert set(entry) - {"workloads"} == {"name", "unit", "better",
                                              "source", "layer", "moves"}
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert 1 <= len(entry["layer"]) <= 200


def test_unique_names():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = [w["name"] for w in BENCH["workloads"]]
    for c in cells:
        mine = [m for m in e2e.values() if c in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(c in m.get("workloads", cells) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)


def test_discovery_by_name():
    """Each configuration, cell and metric is a file of its own, found by
    the name BENCHMARK.json gives it."""
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert len(files) == len(BENCH["configs"])
    for w in BENCH["workloads"]:
        entry, traffic, cfg = cell.cell_files(w["name"], BENCH)
        assert traffic["traffic"] == w["traffic"]
        assert hasattr(cell.driver(traffic["kind"]), "check")
    for m in BENCH["per_layer"]:
        assert callable(cell.metric_reader(m["name"]))


def test_check_budget_fits_a_full_benchmark():
    """A full check of 24 cells at this length fits the time allowed."""
    cells, run_s = 24, BENCH["run_seconds"]
    runs = 2 + 14 * cells
    assert runs * (run_s + 60) + cells * 2 * 90 + 1200 <= 43200
