"""``BENCHMARK.json`` against the contract the harness is built to: its
keys, names and units, the files each cell and metric is found by, and
which cells report which metrics."""

from __future__ import annotations

import json
import re

import pytest

from portbench import manifest
from portbench.tests.tiny import ROOT

REPO = ROOT.parent
DATA = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert DATA["paths"] == ["portbench"]
    assert DATA["command"][1:] == ["portbench/run.py"]
    assert 1 <= DATA["run_seconds"] <= 51


def test_names_and_units():
    names = [e["name"] for kind in ("configs", "workloads", "end_to_end",
                                    "per_layer") for e in DATA[kind]]
    names += [w["traffic"] for w in DATA["workloads"]]
    names += [k for c in DATA["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for kind in ("end_to_end", "per_layer"):
        for m in DATA[kind]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in DATA[kind]]
        assert len(seen) == len(set(seen)), kind


def test_entry_keys_and_bounds():
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS, m
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS, m
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_finds_its_files():
    m = manifest.Manifest.load(REPO)
    for cell in DATA["workloads"]:
        config = m.config(cell)
        assert config["name"] == cell["config"]
        m.traffic(cell)
        manifest.family(config["family"])
        assert (ROOT / "limits" / f"{cell['name']}.json").exists()
    for metric in DATA["per_layer"]:
        assert callable(manifest.metric_reader(metric["name"]))
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in DATA["workloads"]}
    assert used == {c["name"] for c in DATA["configs"]}


@pytest.mark.parametrize("metric", DATA["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    m = manifest.Manifest.load(REPO)
    e2e = {e["name"] for e in DATA["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", m.cells):
        names = {e["name"] for e in m.metrics(cell, "end_to_end")}
        assert metric["moves"] in names, (metric["name"], cell)


def test_every_cell_reports_enough():
    m = manifest.Manifest.load(REPO)
    for cell in m.cells:
        e2e = {e["name"] for e in m.metrics(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.metrics(cell, "per_layer")


def test_check_fits_the_budget():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (DATA["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
