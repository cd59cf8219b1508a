"""BENCHMARK.json against the benchmark's rules, and every cell, metric and
configuration found by name: a cell is a workload file, a configuration a
JSON file with its plain reference beside it, a metric a reader of its own.

    python3 -m pytest h100_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import re

import pytest

from h100_bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["h100_bench"]
    assert len((harness.CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for e in BENCH["configs"] + BENCH["workloads"] + ALL_METRICS]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in ALL_METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for text in [w["why"] for w in BENCH["workloads"] + BENCH["configs"]] + [
            m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_it_must():
    layer_names = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        layer_names.setdefault(m["layer"], m["layer"])
        assert "mfu" in m["name"] or not m["name"].startswith("step_")
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = harness.cell_metrics(BENCH, w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer), w["name"]
        assert w["chips"] in (1, 4)


def test_a_metric_without_cells_goes_to_every_cell_it_moves():
    """A per-layer entry may leave out ``workloads``: then every cell that
    reports the end-to-end metric it moves reports it."""
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "any.setup", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "device",
                               "moves": "setup_s"})
    for w in bench["workloads"]:
        assert "any.setup" in {m["name"] for m in harness.cell_metrics(bench, w["name"], True)}


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((harness.CHECKOUT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16 and set(cfg["reduced"]) <= set(data), cfg["reduced"]
    assert all(NAME.match(key) for key in cfg["reduced"])
    assert cfg["file"] == f"h100_bench/configs/{cfg['name']}.json"
    assert (harness.BENCH / "configs" / f"{cfg['name']}.py").exists()
    assert len(cfg["source"]) <= 200 and cfg["source"].startswith("https://")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_found_by_name(cell):
    traffic = harness.load_json("workloads", cell["traffic"])
    assert traffic["config"] == cell["config"]
    assert (harness.BENCH / "entries" / f"{traffic['entry']}.py").exists()
    assert traffic["limits"] and all(v > 0 for v in traffic["limits"].values())


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_readers_found_by_name(metric):
    mod = harness.load_module("metrics", metric["name"])
    assert mod.read(harness.Context()) is None  # nothing to read: left out of the line
