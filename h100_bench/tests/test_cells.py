"""A CPU rehearsal of every cell at a toy size: the whole run (set-up, the
window or the traced units, the check against the plain reference) with the
program's plain kernels, the result line's keys, and the check failing
under each fault a cell can have, planted in the program underneath.

Each entry kind gives its toy sizes (``TOY``, with limits for that size)
and its faults (``FAULTS``, planted by its ``plant``), so a cell of a new
entry kind is rehearsed here without an edit of this file.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from h100_bench import harness, run


def entry(cell):
    """The entry module that drives ``cell``."""
    return harness.load_module("entries", harness.load_json("workloads", cell)["entry"])


# Every workload file: the cells of BENCHMARK.json and those kept ready for a later PR.
CELLS = sorted(p.stem for p in (harness.BENCH / "workloads").glob("*.json"))
SEED = 2**33 + 12345  # wider than 32 bits, as the driver's are


@pytest.fixture
def toy(monkeypatch):
    """Shrink every workload and configuration to its entry's toy size."""
    load = harness.load_json
    entry_of = {}

    def toy_json(kind, name):
        data = load(kind, name)
        if kind == "workloads":
            entry_of[data["config"]] = data["entry"]
            data.update(harness.load_module("entries", data["entry"]).TOY[0])
        elif kind == "configs" and name in entry_of:
            data.update(harness.load_module("entries", entry_of[name]).TOY[1])
        return data

    monkeypatch.setattr(harness, "load_json", toy_json)


def bench_with_all_cells():
    """BENCHMARK.json with a one-chip entry for each workload file it lacks."""
    bench = harness.benchmark()
    listed = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [{"name": c, "config": harness.load_json("workloads", c)["config"],
                            "traffic": c, "chips": 1} for c in CELLS if c not in listed]
    return bench


def run_cell(cell, trace=0, seconds=0.5, seed=SEED):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.run(args, device=torch.device("cpu"), bench=bench_with_all_cells())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(toy, cell, trace):
    res = run_cell(cell, trace)
    line = json.loads(harness.result_line(res["correct"], res["attempted"], res["failed"],
                                          res["metrics"], res["device"], res["checks"],
                                          res["breakdown"]))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1, line
    want = {m["name"] for m in harness.cell_metrics(bench_with_all_cells(), cell, bool(trace))}
    assert set(line["metrics"]) <= want
    if not trace:  # the host clock's metrics are there on any device
        assert set(line["metrics"]) == want
    else:
        assert "breakdown" in line


# --- faults planted in the program ---------------------------------------------
@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in entry(c).FAULTS])
def test_faults_fail_the_check(toy, monkeypatch, cell, fault):
    entry(cell).plant(monkeypatch, fault)
    res = run_cell(cell)
    assert res["correct"] is False, res["checks"]


def test_sv_control_fails_the_cells_limits():
    """The bfloat16 control in the program's place at N = 2^18 fails the
    2^20 cell's own limits (on the card it is run at the cells' sizes)."""
    real = json.loads((harness.BENCH / "workloads" / "sv_sir_n20.json").read_text())
    cfg = json.loads((harness.BENCH / "configs" / "sv_1d.json").read_text())
    mod = harness.load_module("entries", "sir_run")
    entry = mod.Entry(dict(real, particles=1 << 18, sequences=2, check_units=2), cfg, SEED,
                      torch.device("cpu"))
    entry.free()
    checks, failed, _ = entry.check(control=True)
    assert failed >= 1 and any(v > lim for v, lim in checks.values()), checks


@pytest.mark.cuda
def test_flow_control_fails_on_the_card():
    """The TF32 control of the LEDH cell (10 of its 100 trials) fails its
    limits; TF32 products exist only on the card (run there by the command
    in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 products exist only on a CUDA device")
    cfg = json.loads((harness.BENCH / "configs" / "skewt_d144.json").read_text())
    real = json.loads((harness.BENCH / "workloads" / "skewt_ledh200.json").read_text())
    mod = harness.load_module("entries", "flow_trials")
    entry = mod.Entry(dict(real, check_units=1), dict(cfg, trials=10), SEED,
                      torch.device("cuda", 0))
    entry.free()
    _, failed, _ = entry.check(control=True)
    assert failed == 1


def test_no_card_no_result():
    """Without a CUDA device a run exits with code 2 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cell = harness.benchmark()["workloads"][0]["name"]
    res = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", cell,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 2 and res.stdout == ""


def test_imports_no_jax_and_no_columns():
    """A run imports neither JAX, the JAX package, the interop module nor the
    program's benchmark columns."""
    code = (
        "import sys, torch\n"
        "from h100_bench import harness\n"
        "for kind in ('sir_run', 'flow_trials'):\n"
        "    harness.load_module('entries', kind)\n"
        "from particle_filters_tpu_torch.ops import fused_pf\n"
        "from particle_filters_tpu_torch import models\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'particle_filters_tpu' or m.startswith('particle_filters_tpu.')\n"
        "       or m.endswith('.interop') or '_torch.benchmarks' in m]\n"
        "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
