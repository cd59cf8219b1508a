"""The stochastic particle flow columns — the port's twins of
``bench_spf`` (``benchmarks/run_benchmarks.py``, SPF example 1) and
``examples/10_spf_example2.py`` (SPF example 2).

    python -m particle_filters_tpu_torch.benchmarks.spf [n_time_steps]

- **Example 1**: one bearing-only tempered Bayes update, the notebook's
  numbers (sensors at (±3.5, 0), truth (4, 4), prior N([3, 5],
  diag(1000, 2)), R = 0.04·I, z = [0.4754, 1.1868], μ = 0.2), linearized
  at the prior mean (H by ``torch.func.jacfwd``); runs of N = 50 particles
  and 1000 λ-steps, linear and optimal β, Q = M⁻¹. The runs share one
  model, so the optimal β* is solved once and the runs are a leading axis
  of the draws: 8 sets of 20 runs (the suite's 20) in one call. RMSE = the
  mean over a set's runs of ‖x̂ − x_true‖.
- **Example 2**: 9-state angle-only tracking, T = 50, 20 runs batched: the
  SPF (N = 100, 300 λ-steps, μ = 1e-5, Q = M⁻¹, the fixed update
  covariance, local linearization at the predicted mean) with optimal and
  linear β, a new β* for every run and time step (one batched solve a
  step), and the SIR PF at N = 10⁴ through ``ParticleFilter`` (kernel B2
  at (10⁴, 9) on the card). The trajectories and observations are the
  JAX package's (``data/spf_example2.npz``, ``jax.random`` key 100);
  RMSE of the position, velocity and acceleration blocks, the example's
  definition.

The accuracies are sampled, so they are held to the JAX package's on the
CPU by two-sample tests (``_stats``, p ≥ 1e-3): example 1's 8 sets of 20
runs against its 8 (``JAX_EX1``), example 2's 20 runs against its 20 on the
same trajectories, paired run by run (``jax_rmse`` in DATA; both written by
``python tests/test_torch_spf.py``). Seconds are wall clock to a
sync. Products run with TF32 off (``main`` sets it; a caller sets its own).
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import torch

from particle_filters_tpu_torch.benchmarks._stats import P_MIN, paired_z, summary, welch_z
from particle_filters_tpu_torch.benchmarks.snlg import _timed, print_profile
from particle_filters_tpu_torch.models.particle_filter import ParticleFilter
from particle_filters_tpu_torch.models.stochastic_particle_filter import (
    LinearGaussianBayes,
    draw_spf_normals,
    run_generalized_spf,
    solve_beta_star_bisection,
)
from particle_filters_tpu_torch.ops.resample import resample_by_starts
from particle_filters_tpu_torch.utils.timing import card_line

DATA = pathlib.Path(__file__).resolve().parent / "data" / "spf_example2.npz"
# Example 1 (the notebook's numbers).
SENSORS = ((3.5, 0.0), (-3.5, 0.0))
X_TRUE, X_PRIOR = (4.0, 4.0), (3.0, 5.0)
P_PRIOR_DIAG, R1, Z1, MU1 = (1000.0, 2.0), 0.04, (0.4754, 1.1868), 0.2
RUNS1, N1, STEPS1 = 20, 50, 1000
SETS1 = 8  # sets of 20 runs for the accuracy (the JAX band is over 8 key sets)
# Example 2.
T2, DT, RUNS2 = 50, 0.1, 20
GAMMA, MU2, N_SPF, STEPS2, N_SIR = 1e-2, 1e-5, 100, 300, 10_000
S_PRIOR0 = (50.0, 50.0, 10.0, 10.0, 40.0, 0.0, 0.0, 0.0, 0.0)
P_PRIOR0_DIAG = (10.0,) * 3 + (1e4,) * 3 + (10.0,) * 3
P_UPDATE_DIAG = (5.0,) * 3 + (50.0,) * 3 + (5.0,) * 3
R2 = 1e-6
BLOCKS = {"position": slice(0, 3), "velocity": slice(3, 6), "acceleration": slice(6, 9)}
FILTERS2 = ("spf_optimal", "spf_linear", "sir_pf")
WINDOWS2 = (10, 50)  # example 2's RMSE windows with JAX references: chip_smoke's, all
# The JAX package on the CPU (``python tests/test_torch_spf.py``): example 1's
# RMSE of 8 sets of 20 runs (keys split(PRNGKey(s), 20), s = 0..7). Example 2's
# per-run RMSEs on the example's keys are in DATA (``jax_rmse``).
JAX_EX1 = {"linear": [5.462244987487793, 5.437593936920166, 5.499679088592529,
                      5.479527950286865, 5.444969654083252, 5.477285861968994,
                      5.496285438537598, 5.414483547210693],
           "optimal": [8.881964683532715, 8.228307723999023, 8.985109329223633,
                       8.671768188476562, 9.037242889404297, 7.962245464324951,
                       8.337210655212402, 8.332504272460938]}


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


# ------------------------------- example 1 -----------------------------------


def bearings(x, sensors):
    d = x[None, :] - sensors
    return torch.atan2(d[:, 1], d[:, 0])


def example1_model(device) -> LinearGaussianBayes:
    """The bearing update linearized at the prior mean (innovation form)."""
    sensors = torch.tensor(SENSORS, device=device)
    x_prior = torch.tensor(X_PRIOR, device=device)
    H = torch.func.jacfwd(lambda x: bearings(x, sensors))(x_prior)
    z = torch.tensor(Z1, device=device)
    z_adj = z - (bearings(x_prior, sensors) - H @ x_prior)
    return LinearGaussianBayes.create(x_prior, torch.diag(torch.tensor(P_PRIOR_DIAG)),
                                      H, R1 * torch.eye(2), z_adj, device=device)


def solve_example1(device):
    """β* of example 1 (n_grid = 1001): (lam, beta, betadot)."""
    m = example1_model(device)
    return solve_beta_star_bisection(m.M0, m.Mh, mu=MU1, n_grid=STEPS1 + 1)


def run_example1(device, runs=RUNS1, sets=SETS1):
    """Both rows: ``sets`` sets of ``runs`` runs in one call (one β*
    solve), its seconds to a sync, the RMSE of each set and their mean, and
    the λ/β/β' grids (``info``)."""
    device = torch.device(device)
    model = example1_model(device)
    x_true = torch.tensor(X_TRUE, device=device)
    out = {}
    for mode in ("linear", "optimal"):
        gen = _gen(device, 0)

        def run():
            normals = draw_spf_normals(gen, N1, 2, STEPS1, (runs * sets,), device)
            _, means, info = run_generalized_spf(model, N=N1, n_steps=STEPS1, beta_mode=mode,
                                                 mu=MU1, normals=normals)
            return means, info

        secs, (means, info) = _timed(run, lambda: None, device)
        err = torch.linalg.vector_norm(means - x_true, dim=-1).reshape(sets, runs).mean(1)
        out[mode] = {"s": secs, "runs": runs * sets, "rmse": float(err.mean()),
                     "rmses": err.tolist(), "finite": bool(torch.isfinite(means).all()),
                     "betadot0": float(info["betadot"][0]), "info": info}
    return out


# ------------------------------- example 2 -----------------------------------


def _dynamics(device):
    I3, Z3 = np.eye(3), np.zeros((3, 3))
    A = GAMMA * np.block([[-I3, I3, Z3], [Z3, -I3, I3], [Z3, Z3, -I3]])
    return torch.as_tensor(A, dtype=torch.float32, device=device)


def h_meas(s):
    """Azimuth and elevation of the target from a sensor at the origin."""
    x, y, z = s[0], s[1], s[2]
    return torch.stack([torch.atan2(x, y), torch.atan2(z, torch.hypot(x, y))])


def load_example2(device, path=DATA):
    with np.load(str(path)) as f:
        return {k: torch.as_tensor(f[k], device=device) for k in f.files}


def example2_model(x, z, device) -> LinearGaussianBayes:
    """The batched update of one time step: predict each run's estimate x
    (R, 9), linearize h there (innovation form), observation z (R, 2)."""
    runs = x.shape[0]
    x_pred = x + (x @ _dynamics(device).T) * DT
    H = torch.func.vmap(torch.func.jacfwd(h_meas))(x_pred)
    z_adj = z - (torch.func.vmap(h_meas)(x_pred) - (H @ x_pred[..., None])[..., 0])
    P_upd = torch.diag(torch.tensor(P_UPDATE_DIAG, device=device)).expand(runs, 9, 9)
    R = (R2 * torch.eye(2, device=device)).expand(runs, 2, 2)
    return LinearGaussianBayes.create(x_pred, P_upd, H, R, z_adj, device=device)


def prior_estimates(runs, device):
    return torch.tensor(S_PRIOR0, device=device).expand(runs, 9)


def spf_filter(gen, zs, beta_mode, device, steps=None):
    """The sequential SPF of all runs at once: zs (R, T, 2) → estimates
    (R, T+1, 9); one batched model (and β* solve) a time step."""
    x = prior_estimates(zs.shape[0], device)
    ests = [x]
    for t in range(zs.shape[1] if steps is None else steps):
        model = example2_model(x, zs[:, t], device)
        _, x, _ = run_generalized_spf(model, N=N_SPF, n_steps=STEPS2, beta_mode=beta_mode,
                                      mu=MU2, Q_mode="inv_M", generator=gen)
        ests.append(x)
    return torch.stack(ests, dim=1)


def sir_filter(gen, zs, device, steps=None):
    """The SIR PF (N = 10⁴, regularized after resampling) run by run:
    estimates (R, T+1, 9) and the number of steps that resampled."""
    A = _dynamics(device)
    pf = ParticleFilter(lambda x, u: x + (A @ x) * DT, h_meas, 1e-4 * np.eye(9),
                        R2 * np.eye(2), Np=N_SIR, resample_thresh=0.5,
                        regularize_after_resample=True, device=device)
    s0 = torch.tensor(S_PRIOR0, device=device)
    out, resampled = [], 0
    for r in range(zs.shape[0]):
        st = pf.initialize(gen, s0, np.diag(P_PRIOR0_DIAG))
        _, hist = pf.run(gen, st, zs[r, :steps])
        out.append(torch.cat([s0[None], hist["mean"]]))
        resampled += int(hist["resampled"].sum())
    return torch.stack(out), resampled


def block_rmse(est, traj):
    """The example's RMSE of each block, run by run: the mean over times of
    the block's error norm (the example averages these over the runs)."""
    return {name: torch.linalg.vector_norm(est[..., sl] - traj[..., sl], dim=-1).mean(1).tolist()
            for name, sl in BLOCKS.items()}


def run_example2(device, steps=None):
    """All three filters over the 20 runs (the first ``steps`` time steps):
    seconds, block RMSEs, and for the SIR PF B2's launches."""
    device = torch.device(device)
    d = load_example2(device)
    steps = d["zs"].shape[1] if steps is None else steps
    traj = d["traj"][:, :steps + 1]
    out = {}
    for i, name in enumerate(FILTERS2):
        gen = _gen(device, i)  # a stream a filter, as the example splits its key
        if name == "sir_pf":
            resample_by_starts.launches = 0
            secs, (est, resampled) = _timed(lambda: sir_filter(gen, d["zs"], device, steps),
                                            lambda: None, device)
            launches = resample_by_starts.launches
        else:
            mode = name.split("_")[1]
            secs, est = _timed(lambda: spf_filter(gen, d["zs"], mode, device, steps),
                               lambda: None, device)
            launches = resampled = 0
        per_run = block_rmse(est, traj)
        out[name] = {"s": secs, "rmse": {b: sum(v) / len(v) for b, v in per_run.items()},
                     "per_run": per_run, "b2_launches": launches,
                     "resample_steps": resampled, "finite": bool(torch.isfinite(est).all()),
                     "steps": steps}
    return out


def ex1_against_jax(mode, rmses):
    """(z, p) of example 1's per-set RMSEs against the JAX package's."""
    return welch_z(rmses, *summary(JAX_EX1[mode]))


def ex1_gates(ex1) -> dict:
    """``{gate: (value, held)}`` of example 1: each row finite and its
    per-set RMSEs against the JAX package's (p ≥ ``P_MIN``)."""
    out = {}
    for mode, r in ex1.items():
        out[f"{mode} finite"] = (r["finite"], r["finite"])
        z, p = ex1_against_jax(mode, r["rmses"])
        out[f"{mode} RMSEs against the JAX package's, p >= {P_MIN}"] = (p, p >= P_MIN)
    return out


def jax_ex2(name, block, steps):
    """The JAX package's per-run RMSEs of one example-2 filter and block
    over the first ``steps`` steps (None where not computed)."""
    if steps not in WINDOWS2:
        return None
    with np.load(str(DATA)) as f:
        ref = f["jax_rmse"]
    return ref[FILTERS2.index(name), WINDOWS2.index(steps), list(BLOCKS).index(block)].tolist()


def ex2_against_jax(name, r):
    """{block: (z, p)} of one filter's per-run RMSEs against the JAX
    package's on the same runs, paired (empty where not computed)."""
    out = {}
    for block, vals in r["per_run"].items():
        ref = jax_ex2(name, block, r["steps"])
        if ref is not None:
            out[block] = paired_z(vals, ref)
    return out


def print_columns(ex1, ex2, card=""):
    if ex1:
        for mode, r in ex1.items():
            mean, sd, n = summary(JAX_EX1[mode])
            z, p = ex1_against_jax(mode, r["rmses"])
            print(f"SPF example 1 {mode}: {r['s']:.4f} s for {r['runs']} runs in one call, RMSE "
                  f"{r['rmse']:.4f} (mean over {len(r['rmses'])} sets of {RUNS1} runs; JAX CPU "
                  f"{mean:.4f} ± "
                  f"{sd:.4f} over {n} sets, z {z:.2f}, p {p:.4f}), beta'(0) "
                  f"{r['betadot0']:.4f}  [{card}]")
    if ex2:
        for name, r in ex2.items():
            tests = ex2_against_jax(name, r)
            rm = ", ".join(
                f"{b} {v:.4f}" + (f" (JAX CPU {sum(jax_ex2(name, b, r['steps'])) / RUNS2:.4f}, "
                                  f"paired p {tests[b][1]:.4f})" if b in tests else "")
                for b, v in r["rmse"].items())
            print(f"SPF example 2 {name} ({r['steps']} steps x {RUNS2} runs): {r['s']:.4f} s, "
                  f"RMSE {rm}; B2 x{r['b2_launches']} ({r['resample_steps']} resample steps)  "
                  f"[{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("spf: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else None
    card = card_line()
    t0 = time.perf_counter()
    sol = solve_example1("cuda")
    torch.cuda.synchronize()
    print(f"SPF example 1 beta* solve (n_grid {STEPS1 + 1}): {time.perf_counter() - t0:.4f} s "
          f"(first call), beta'(0) {float(sol[2][0]):.4f}  [{card}]")
    print_columns(run_example1("cuda"), run_example2("cuda", steps=steps), card)
    d = load_example2("cuda")
    m = example2_model(prior_estimates(RUNS2, "cuda"), d["zs"][:, 0], "cuda")
    print_profile(f"SPF example 2 beta* solve ({RUNS2} runs batched, n_grid {STEPS2 + 1})",
                  lambda: solve_beta_star_bisection(m.M0, m.Mh, mu=MU2, n_grid=STEPS2 + 1), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
