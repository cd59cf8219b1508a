"""The benchmark harness on the port: the twin of ``benchmarks/run_benchmarks.py``.

    python -m particle_filters_tpu_torch.benchmarks.run_benchmarks [names...] [--device cpu]
        [--out PATH]

Runs the JAX harness's nine columns (all of them when no name is given):
``sv_classic``, ``dpf_linear``, ``dpf_nonlinear``, ``snlg``,
``skewt_flows``, ``mat_flows``, ``nlngssm_flows``, ``ot_large`` and
``spf_example1``, each through its port module at the module's own full
size (the module's size constants, read when the column runs and passed to
it), and merges their records into one JSON file: ``backend`` (``"cuda"``
or ``"cpu"``), ``device`` and ``power_limit_w`` (``utils/timing.card``),
and ``results``, one record a column under the JAX record's name (``snlg``
→ ``snlg_d64``). The file is written after every column, merged into what
the path already holds, which must come from the same backend and device.
The default path is ``particle_filters_tpu_torch/benchmarks/results.json``,
the card's record; the JAX package's ``benchmarks/results.json`` is never
written.

A record carries exactly the JAX record's keys but those beginning with
``reference`` (the original notebooks' runs). The harness maps what each
module measured onto them and computes nothing itself:

- an accuracy the JAX record takes from one key (``soft_rmse``,
  ``pf_rmse``, ``edh_avg_omat``, ``edh_rmse``, ...) is the module's seed-0
  run; one it averages over 8 keys (``rnn_rmse_8keys``, ``rnn_trained_*``,
  ``rnn_baseline_nll``) is the module's mean over its 8 seeds;
- times are each module's wall time to a sync, after its warm-up, with no
  RPC-floor subtraction (the card has no relay), for the work the JAX key
  times: the SNLG and skew-t times for all 100 trials, the nlngssm and MAT
  times for one run, SPF example 1's for one call of 20 runs (``n_runs``).
  The nlngssm and MAT modules run their seeds batched in one call, and SPF
  example 1 8 sets of 20 runs, for their gates; their records come from a
  second call of the module with one seed (one set), run after the gates'
  call, so it is warm.

Each column's gates are its module's (against the JAX package's values on
the CPU, by the module's tolerance or two-sample test), each ``(value,
held)``; they are printed, and the exit code is 1 if any gate failed.
Without a card the default raises: ``--device cpu`` checks the path, it
measures nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

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
from particle_filters_tpu_torch.utils.timing import card, card_line, resolve_device

DEFAULT_OUT = pathlib.Path(__file__).resolve().parent / "results.json"


def sv_classic_column(device):
    data = sv_classic.load_data(device)
    t = sv_classic.T
    res = sv_classic.run_column(device, data, t=t, n_pf=sv_classic.N_PF, seeds=sv_classic.SEEDS)
    record = {"T": t, **{f"{k}_ms_per_step": res[k]["s"] / t * 1e3 for k in ("ekf", "ukf")},
              "pf_ms_per_step": res["pf"]["s"] / t * 1e3,
              "ekf_rmse": res["ekf"]["rmse"], "ukf_rmse": res["ukf"]["rmse"],
              "pf_rmse": res["pf"]["rmses"][0]}
    return record, sv_classic.gates(res, data), res


def _dpf_rows(res):
    return {k: v for tag in ("soft", "ot", "rnn")
            for k, v in ((f"{tag}_ms_per_step", res[tag]["ms_per_step"]),
                         (f"{tag}_rmse", res[tag]["rmse_seed0"]))}


def dpf_linear_column(device):
    res = dpf.run_linear(device, seeds=dpf.SEEDS, train_steps=dpf.TRAIN_STEPS)
    tr = res["rnn_trained"]
    record = {**_dpf_rows(res), "rnn_trained_ms_per_step": tr["ms_per_step"],
              "rnn_trained_rmse": tr["rmse"], "rnn_trained_nll": tr["nll"],
              "rnn_baseline_nll": tr["baseline_nll"], "rnn_rmse_8keys": res["rnn"]["rmse"]}
    return record, dpf.gates("dpf_linear", res), res


def dpf_nonlinear_column(device):
    res = dpf.run_nonlinear(device, seeds=dpf.SEEDS)
    record = {"T": dpf.NL["T"], "N": dpf.NL["N"], **_dpf_rows(res)}
    return record, dpf.gates("dpf_nonlinear", res), res


def snlg_column(device):
    res = snlg.run_column(device, trials=snlg.TRIALS, steps=snlg.T, d=snlg.D, flows=snlg.FLOWS)
    record = {"trials": snlg.TRIALS, "kf_total_s": res["kf"]["total_s"],
              "ukf_total_s": res["ukf"]["total_s"], "kf_mse": res["kf"]["mse"],
              "kf_mse_sz1": res["kf_sz1"]["mse"], "ukf_mse": res["ukf"]["mse"]}
    for tag, _, _ in snlg.FLOWS:
        record.update({f"{tag}_total_s": res[tag]["total_s"], f"{tag}_mse": res[tag]["mse"]})
    return record, snlg.gates(res), res


def skewt_column(device):
    X, Z, Sigma, L = skewt.load_data(device)
    X, Z = X[:skewt.TRIALS, :skewt.T], Z[:skewt.TRIALS, :skewt.T]
    res = skewt.run_column(device, (X, Z, Sigma, L), flows=skewt.FLOWS)
    trials, steps, d = Z.shape
    record = {"trials": trials, "d": d, "T": steps}
    for tag in ("ekf", "ukf"):
        record.update({f"{tag}_total_s": res[tag]["total_s"], f"{tag}_mse": res[tag]["mse"]})
    for tag, _, _ in skewt.FLOWS:
        record.update({f"{tag}_total_s": res[tag]["total_s"], f"{tag}_mse": res[tag]["mse"],
                       f"{tag}_ess": res[tag]["ess"]})
    return record, skewt.gates(res), res


def mat_column(device):
    data = mat.load_data(device)
    data = {**data, "zs": data["zs"][:mat.T], "P": data["P"][:mat.T]}
    res = mat.run_column(device, data, seeds=mat.SEEDS, n_particles=mat.N, flows=mat.FLOWS)
    one = mat.run_column(device, data, seeds=1, n_particles=mat.N, flows=mat.FLOWS)
    record = {"T": data["zs"].shape[0], "N": mat.N}
    for tag in mat.FLOWS:
        record.update({f"{tag}_total_s": one[tag]["total_s"],
                       f"{tag}_avg_omat": one[tag]["omats"][0]})
    for tag in ("ekf", "ukf"):
        record.update({f"{tag}_total_s": one[tag]["total_s"],
                       f"{tag}_avg_omat": one[tag]["omat"]})
    return record, mat.gates(res), res


def nlngssm_column(device):
    data = sv_classic.load_data(device)
    t, n = nlngssm.T, nlngssm.N
    res = nlngssm.run_column(device, data, t=t, n=n, seeds=nlngssm.SEEDS, names=nlngssm.NAMES)
    one = nlngssm.run_column(device, data, t=t, n=n, seeds=1, names=nlngssm.NAMES)
    record = {"T": t, "N": n}
    for name in nlngssm.NAMES:
        record.update({f"{name}_total_s": one[name]["s"], f"{name}_rmse": one[name]["rmses"][0]})
    return record, nlngssm.gates(res, data, cut=t == nlngssm.T_CUT), res


def ot_large_column(device):
    res = ot_large.run(device, sizes=ot_large.SIZES)
    record = {k: v for n, r in res.items()
              for k, v in ((f"n{n}_s", r["s"]), (f"n{n}_mean_err", r["mean_err"]))}
    record["n_iters"] = ot_large.N_ITERS
    return record, ot_large.gates(res), res


def spf_example1_column(device):
    res = spf.run_example1(device, runs=spf.RUNS1, sets=spf.SETS1)
    one = spf.run_example1(device, runs=spf.RUNS1, sets=1)
    record = {"n_runs": spf.RUNS1, "N": spf.N1, "n_steps": spf.STEPS1}
    for mode, r in one.items():
        record.update({f"{mode}_total_s": r["s"], f"{mode}_rmse": r["rmse"]})
    return record, spf.ex1_gates(res), res


# name: (the JAX record's name, the column)
COLUMNS = {
    "sv_classic": ("sv_classic", sv_classic_column),
    "dpf_linear": ("dpf_linear", dpf_linear_column),
    "dpf_nonlinear": ("dpf_nonlinear", dpf_nonlinear_column),
    "snlg": ("snlg_d64", snlg_column),
    "skewt_flows": ("skewt_flows", skewt_column),
    "mat_flows": ("mat_flows", mat_column),
    "nlngssm_flows": ("nlngssm_flows", nlngssm_column),
    "ot_large": ("ot_large", ot_large_column),
    "spf_example1": ("spf_example1", spf_example1_column),
}


def write_record(path, records: dict, device) -> None:
    """Merge ``records`` into the file at ``path`` (created when absent),
    with the card fields of ``device``."""
    path = pathlib.Path(path)
    name, limit = card(device)
    head = {"backend": device.type, "device": name, "power_limit_w": limit}
    merged = {}
    if path.exists():
        old = json.loads(path.read_text())
        if (old.get("backend"), old.get("device")) != (head["backend"], head["device"]):
            raise ValueError(f"{path} holds a record of {old.get('backend')} "
                             f"({old.get('device')}), not of {device.type} ({name}).")
        merged = old["results"]
    merged.update(records)
    path.write_text(json.dumps({**head, "results": merged}, indent=2) + "\n")


def run_columns(names, device, out) -> dict:
    """Each named column in turn, its record printed and merged into
    ``out``: ``{name: (record, gates, the module's result)}``. A gate is
    ``(value, held)``."""
    device = resolve_device(device)
    done = {}
    for name in names:
        key, column = COLUMNS[name]
        print(f"=== {name} ===  [{card_line(device)}]", flush=True)
        t0 = time.perf_counter()
        record, gates, res = column(device)
        done[name] = (record, gates, res)
        print(json.dumps(record, indent=2))
        for gate, (value, held) in gates.items():
            print(f"  gate {gate}: {value}  {'held' if held else 'FAILED'}")
        print(f"({time.perf_counter() - t0:.1f} s with warm-ups)", flush=True)
        write_record(out, {key: record}, device)
    print(f"wrote {out}")
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"columns of {', '.join(COLUMNS)} (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in COLUMNS]
    if unknown:
        ap.error(f"unknown columns {unknown}; choose from {list(COLUMNS)}")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    done = run_columns(args.names or list(COLUMNS), device, args.out)
    failed = [f"{name}: {gate}" for name, (_, gates, _) in done.items()
              for gate, (_, held) in gates.items() if not held]
    for f in failed:
        print(f"FAILED gate {f}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
