"""The port's benchmark harness (``particle_filters_tpu_torch/benchmarks/
run_benchmarks.py``), the twin of ``benchmarks/run_benchmarks.py``, on the
CPU at toy sizes (the modules' size constants monkeypatched; the harness
reads them when a column runs).

- Each of the nine columns: its record's keys are the JAX record's in
  ``benchmarks/results.json`` (under the JAX record's name, ``snlg`` →
  ``snlg_d64``) less those beginning with ``reference``, every value
  finite, its module's gates evaluated as ``(value, held)`` (at toy sizes
  they need not hold). ``ot_large``'s keys name the sizes run: the toy
  sizes in place of 4096, 16384 and 65536.
- The nlngssm, MAT and SPF example 1 records time the work of the JAX
  key: the module's call with one seed (one set of runs), made after the
  gates' call with all of them.
- The file: two runs merge their records; ``backend``, ``device`` and
  ``power_limit_w`` are ``utils/timing.card``'s; a file of another backend
  is not merged into; the JAX package's file is never written.
- The exit code: 0 when every gate holds, 1 when one fails.
"""

import json
import math
import pathlib

import pytest
import torch

from particle_filters_tpu_torch.benchmarks import (
    dpf,
    mat,
    nlngssm,
    ot_large,
    skewt,
    snlg,
    spf,
    sv_classic,
)
from particle_filters_tpu_torch.benchmarks import run_benchmarks as rb
from particle_filters_tpu_torch.utils.timing import card

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_RESULTS = ROOT / "benchmarks" / "results.json"
JAX_OT_SIZES = (4096, 16384, 65536)  # bench_ot_large's
TOY_OT = (64, 128, 256)


@pytest.fixture
def toy(monkeypatch):
    """Every column at a toy size: a few steps, particles, trials and seeds."""
    for mod, name, value in [
        (sv_classic, "T", 40), (sv_classic, "N_PF", 100), (sv_classic, "SEEDS", 2),
        (dpf, "SEEDS", 2), (dpf, "TRAIN_STEPS", 2), (dpf, "EVAL_SEEDS", (990, 991)),
        (dpf, "LIN", {**dpf.LIN, "N": 8, "T": 5}), (dpf, "NL", {**dpf.NL, "N": 8, "T": 5}),
        (snlg, "TRIALS", 2), (snlg, "T", 3), (snlg, "D", 4),
        (snlg, "FLOWS", (("edh200", "edh", 8), ("ledh200", "ledh", 8), ("edh10000", "edh", 16))),
        (skewt, "TRIALS", 2), (skewt, "T", 2),
        (skewt, "FLOWS", (("edh200", "edh", 8), ("edh10000", "edh", 16), ("ledh200", "ledh", 8))),
        (mat, "SEEDS", 2), (mat, "N", 8), (mat, "T", 6),
        (nlngssm, "T", 10), (nlngssm, "N", 16), (nlngssm, "SEEDS", 2),
        (ot_large, "SIZES", TOY_OT), (ot_large, "BLOCK", 32),
        (spf, "RUNS1", 2), (spf, "SETS1", 2), (spf, "N1", 8), (spf, "STEPS1", 20),
    ]:
        monkeypatch.setattr(mod, name, value)


def jax_keys(name):
    rec = json.loads(JAX_RESULTS.read_text())["results"][rb.COLUMNS[name][0]]
    keys = {k for k in rec if not k.startswith("reference")}
    if name == "ot_large":
        for big, small in zip(JAX_OT_SIZES, TOY_OT):
            keys = {k.replace(f"n{big}_", f"n{small}_") for k in keys}
    return keys


@pytest.mark.parametrize("name", list(rb.COLUMNS))
def test_column_record_has_the_jax_keys(toy, name):
    record, gates, _ = rb.COLUMNS[name][1](CPU)
    assert set(record) == jax_keys(name)
    assert all(math.isfinite(v) for v in record.values()), record
    assert gates and all(isinstance(g, tuple) and len(g) == 2 for g in gates.values())


# name: (module, function, its count argument, the module's count, a time
# key, that time in the function's result)
ONE_RUN = {
    "nlngssm_flows": (nlngssm, "run_column", "seeds", "SEEDS", "edh_total_s",
                      lambda r: r["edh"]["s"]),
    "mat_flows": (mat, "run_column", "seeds", "SEEDS", "ledh_total_s",
                  lambda r: r["ledh"]["total_s"]),
    "spf_example1": (spf, "run_example1", "sets", "SETS1", "optimal_total_s",
                     lambda r: r["optimal"]["s"]),
}


@pytest.mark.parametrize("name", list(ONE_RUN))
def test_record_times_one_run(toy, monkeypatch, name):
    mod, fn, arg, const, key, secs = ONE_RUN[name]
    real, calls = getattr(mod, fn), []

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((kw[arg], out))
        return out

    monkeypatch.setattr(mod, fn, spy)
    record, _, res = rb.COLUMNS[name][1](CPU)
    assert [c for c, _ in calls] == [getattr(mod, const), 1]
    assert calls[0][1] is res and record[key] == secs(calls[1][1])


def _run(tmp_path, *names, out=None):
    out = tmp_path / "results.json" if out is None else out
    return rb.main([*names, "--device", "cpu", "--out", str(out)]), out


def test_records_merge_with_the_card_fields(toy, tmp_path):
    jax_bytes = JAX_RESULTS.read_bytes()
    _, out = _run(tmp_path, "ot_large")
    _, out = _run(tmp_path, "spf_example1")
    got = json.loads(out.read_text())
    name, limit = card(CPU)
    assert (got["backend"], got["device"], got["power_limit_w"]) == ("cpu", name, limit)
    assert set(got["results"]) == {"ot_large", "spf_example1"}
    assert JAX_RESULTS.read_bytes() == jax_bytes
    assert rb.DEFAULT_OUT.resolve() != JAX_RESULTS.resolve()
    assert rb.DEFAULT_OUT.parent == ROOT / "particle_filters_tpu_torch" / "benchmarks"


def test_no_merge_into_another_backend(toy, tmp_path):
    out = tmp_path / "results.json"
    out.write_text(json.dumps({"backend": "cuda", "device": "NVIDIA H100 80GB HBM3",
                               "power_limit_w": 700.0, "results": {}}))
    with pytest.raises(ValueError, match="holds a record of cuda"):
        _run(tmp_path, "ot_large", out=out)


def test_exit_code_follows_the_gates(toy, tmp_path, monkeypatch):
    assert _run(tmp_path, "ot_large")[0] == 0  # no reference at the toy sizes: finite only
    monkeypatch.setattr(ot_large, "JAX_MEAN_ERR", {TOY_OT[0]: 0.0})
    assert _run(tmp_path, "ot_large")[0] == 1
    with pytest.raises(SystemExit):
        _run(tmp_path, "no_such_column")
