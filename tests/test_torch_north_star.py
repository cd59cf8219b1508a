"""The north-star scripts of the port on the CPU: ``benchmarks/bench.py``
(the twin of the repo's ``bench.py``) and ``benchmarks/scaling_curve.py``
(the twin of ``benchmarks/scaling_curve.py``), at toy sizes.

- The bench twin at N = 2¹², T = 50 on the CPU: one JSON line with
  ``bench.py``'s keys (``fused_kernel_step`` in place of
  ``fused_pallas_step``) and the card's, meeting the main path's gates
  (``sv_rmse < 1.5``, ``0.02 ≤ resample_frac ≤ 0.3``).
- Without a card it raises unless asked for the CPU, and it never runs the
  generic ``ParticleFilter``.
- ``scaling_curve.measure`` at toy N and lengths: the row's fields, a
  positive slope, finite histories, the busy share not measured off the
  card; ``main --out`` writes the rows at the module's N as JSON.
"""

import ast
import json
import pathlib
import subprocess

import pytest
import torch

from particle_filters_tpu_torch.benchmarks import bench, scaling_curve

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
EXTRAS = {"n_particles", "n_steps", "ms_per_step", "sv_rmse", "resample_frac",
          "fused_kernel_step", "backend", "device", "power_limit_w"}


def jax_bench_keys():
    """The keys of the dict the repo's ``bench.py`` prints, read from its
    source: (top-level keys, extras' keys)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric" for k in n.keys)]
    (top,) = dicts
    extras = next(v for k, v in zip(top.keys, top.values) if k.value == "extras")
    return {k.value for k in top.keys}, {k.value for k in extras.keys}


def test_bench_twin_on_the_cpu(capsys):
    assert bench.main(["--device", "cpu", "--n", "4096", "--t", "50"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    top, jax_extras = jax_bench_keys()
    assert set(record) == top
    assert set(record["extras"]) == EXTRAS
    assert jax_extras - {"fused_pallas_step"} <= EXTRAS
    ex = record["extras"]
    assert ex["n_particles"] == 4096 and ex["n_steps"] == 50
    assert ex["fused_kernel_step"] is False and ex["backend"] == "cpu"
    assert ex["device"] == "cpu" and ex["power_limit_w"] is None
    assert record["metric"] == "particle_steps_per_sec_per_chip"
    assert record["value"] == pytest.approx(4096 * 50 / (ex["ms_per_step"] * 1e-3 * 50))
    gates = bench.gates(record)
    assert all(held for _, held in gates.values()), gates


def test_bench_twin_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--n", "4096", "--t", "5"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling_curve.measure(1 << 10, "cuda")


def test_bench_twin_runs_the_fused_filter_only(monkeypatch):
    from particle_filters_tpu_torch.models import particle_filter

    def refuse(*args, **kwargs):
        raise AssertionError("the bench twin ran the generic ParticleFilter")

    monkeypatch.setattr(particle_filter.ParticleFilter, "__init__", refuse)
    record = bench.run("cpu", n=1024, t=10, runs=1)
    assert record["extras"]["n_particles"] == 1024


def test_scaling_curve_rows():
    row = scaling_curve.measure(1 << 10, "cpu", m_lo=20, m_hi=60, reps=2)
    assert set(row) == {"n_particles", "log2_n", "n_steps", "m_hi", "ms_per_step",
                        "particle_steps_per_sec", "resample_frac", "finite", "busy", "wall_s"}
    assert row["log2_n"] == 10 and row["m_hi"] == 60 and row["n_steps"] == 20
    assert row["ms_per_step"] > 0
    assert row["particle_steps_per_sec"] == pytest.approx((1 << 10) / (row["ms_per_step"] * 1e-3))
    assert row["finite"] and 0.0 < row["resample_frac"] < 0.5 and row["busy"] is None
    assert scaling_curve.m_hi_for(1 << 16) == 8000 and scaling_curve.m_hi_for(1 << 18) == 1700
    assert scaling_curve.LOG2_N == (14, 16, 18, 20, 22, 24)
    rows = scaling_curve.curve("cpu", log2_n=(9, 10), reps=1, m_hi=40)
    assert [r["log2_n"] for r in rows] == [9, 10]
    assert "not measured" in scaling_curve.format_row(rows[0])


def test_scaling_curve_main_writes_the_rows(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(scaling_curve, "LOG2_N", (8,))
    monkeypatch.setattr(scaling_curve, "m_hi_for", lambda n: scaling_curve.M_LO + 40)
    out = tmp_path / "rows.json"
    assert scaling_curve.main(["--device", "cpu", "--out", str(out)]) == 0
    saved = json.loads(out.read_text())
    assert saved["device"] == "cpu" and saved["power_limit_w"] is None
    assert saved["baseline"] == bench.BASELINE_PARTICLE_STEPS_PER_SEC
    ((row,),) = (saved["rows"],)
    assert row["log2_n"] == 8 and row["m_hi"] == scaling_curve.M_LO + 40 and row["finite"]
    assert "N=2^8:" in capsys.readouterr().out


def test_card_reads_nvidia_smi_csv(monkeypatch):
    from particle_filters_tpu_torch.utils import timing

    def fake_run(cmd, **kwargs):
        assert cmd == ["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader,nounits"]
        return subprocess.CompletedProcess(cmd, 0, "NVIDIA H100 80GB HBM3, 700.00\nx, 1\n", "")

    monkeypatch.setattr(timing.subprocess, "run", fake_run)
    assert timing.card("cuda") == ("NVIDIA H100 80GB HBM3", 700.0)
    assert timing.card_line("cuda") == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert timing.card("cpu") == ("cpu", None) and timing.card_line("cpu") == "cpu"
