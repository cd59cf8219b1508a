"""The LEDH particle flow on the SPF's stiffness-optimal β(λ) schedule: the
port's twin of ``examples/11_spf_ledh_beta_schedule.py``.

    python -m particle_filters_tpu_torch.examples.ex11_spf_ledh_beta_schedule [--device cpu]

The bearing-only single update of the SPF paper's example 1: target at
(4, 4), sensors at (±3.5, 0), prior N([3, 5], diag(1000, 2)) (the stiff
500:1 prior), bearings z = [0.4754, 1.1868], R = 0.04·I. The LEDH flow
(N = 256, 16 λ-steps, identity dynamics, no resampling) runs from the SAME
particles on the linear schedule β = λ and on the optimal β* that
``solve_beta_star_bisection`` finds on the model linearized at the prior
mean (µ = 0.2), through ``LEDHFlowPF.step(beta_schedule=…)`` with the
notebook's tracker that always predicts the fixed prior. Then the Monte
Carlo over ``N_TRIALS`` prior draws, both schedules, as one batched
``run_trials`` call each (the JAX script vmaps the draws). Also the κ₂(M(β))
profiles along both schedules.

The notebook's hypothesis, that β* improves the estimate, fails on this
problem, and the JAX package reproduces the failure (its 50 draws: linear
RMSE 8.1931 ± 0.1895, optimal 8.3506 ± 0.1770; the notebook 8.18 ± 0.18
against 9.48 ± 0.16). Gates: the mean error of the linear schedule below
the optimal one's, every error finite; β* on the card is held to the CPU's
by ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from particle_filters_tpu_torch.core.structs import stack_states
from particle_filters_tpu_torch.core.weights import ess_from_logw
from particle_filters_tpu_torch.models.ledh_particle_filter import LEDHConfig, LEDHFlowPF
from particle_filters_tpu_torch.models.stochastic_particle_filter import (
    LinearGaussianBayes,
    kappa2_and_derivative,
    linspace,
    solve_beta_star_bisection,
)
from particle_filters_tpu_torch.models.trackers import TrackerState
from particle_filters_tpu_torch.utils.timing import card_line, resolve_device, sync

X_TRUE = (4.0, 4.0)
SENSORS = ((3.5, 0.0), (-3.5, 0.0))
X_PRIOR = (3.0, 5.0)
P_PRIOR = ((1000.0, 0.0), (0.0, 2.0))
R_OBS = ((0.04, 0.0), (0.0, 0.04))
Z_OBS = (0.4754, 1.1868)
MU, N_STEPS, N_PARTICLES = 0.2, 16, 256
N_TRIALS = 50
# The JAX package's Monte Carlo (its script's 50 draws, split(PRNGKey(7),
# 50)): mean, standard deviation (n − 1) and count of the error, printed by
# ``python tests/test_torch_ex11.py``.
JAX_MC = {"lin": (8.19306637763977, 0.1895372364523625, 50),
          "opt": (8.350558547973632, 0.1770490817936082, 50)}


class Problem:
    """The single-update problem's tensors and callables on ``device``."""

    def __init__(self, device) -> None:
        f32 = dict(dtype=torch.float32, device=device)
        self.device = device
        self.x_true = torch.tensor(X_TRUE, **f32)
        self.sensors = torch.tensor(SENSORS, **f32)
        self.x_prior = torch.tensor(X_PRIOR, **f32)
        self.P_prior = torch.tensor(P_PRIOR, **f32)
        self.R = torch.tensor(R_OBS, **f32)
        self.R_inv = torch.linalg.inv(self.R)
        self.z = torch.tensor(Z_OBS, **f32)

    def h(self, x):
        d = x[None, :] - self.sensors  # (2 sensors, 2)
        return torch.atan2(d[:, 1], d[:, 0])

    def jacobian_h(self, x):
        return torch.func.jacfwd(self.h)(x)

    def log_like(self, z, x):
        diff = z - self.h(x)
        diff = torch.atan2(torch.sin(diff), torch.cos(diff))  # wrap the angles
        return -0.5 * diff @ (self.R_inv @ diff)


class StaticTracker:
    """The notebook's tracker for a single update: ``predict`` always
    returns the fixed prior, ``update`` keeps the state."""

    def __init__(self, problem: Problem) -> None:
        self.p = problem

    def init(self) -> TrackerState:
        return TrackerState(mean=self.p.x_prior, cov=self.p.P_prior, past_mean=self.p.x_prior,
                            t=torch.zeros((), dtype=torch.int32, device=self.p.device))

    def predict(self, ts, u=None):
        return ts, self.p.x_prior, self.p.P_prior

    def update(self, ts, z):
        return ts, ts.mean, ts.cov


def make_ledh(problem: Problem) -> LEDHFlowPF:
    """The flow: identity dynamics, a zero transition density, no resampling."""
    return LEDHFlowPF(
        tracker=StaticTracker(problem), g=lambda x, u, v: x, h=problem.h,
        jacobian_h=problem.jacobian_h, log_trans_pdf=lambda xn, xo: torch.zeros(()),
        log_like_pdf=problem.log_like, R=problem.R,
        config=LEDHConfig(n_particles=N_PARTICLES, n_lambda_steps=N_STEPS,
                          resample_ess_ratio=0.0),
        device=problem.device)


def schedules(problem: Problem):
    """(linear β, optimal β*): the (N_STEPS + 1,) schedules, β* solved on
    the model linearized at the prior mean."""
    H = problem.jacobian_h(problem.x_prior)
    model = LinearGaussianBayes.create(problem.x_prior, problem.P_prior, H, problem.R,
                                       problem.z, device=problem.device)
    _, beta_opt, _ = solve_beta_star_bisection(model.M0, model.Mh, mu=MU, n_grid=N_STEPS + 1)
    return linspace(0.0, 1.0, N_STEPS + 1, device=problem.device), beta_opt, model


def kappas(model, beta):
    """κ₂(M0 + β·Mh) at each β of a schedule."""
    M = model.M0 + beta[:, None, None] * model.Mh
    return kappa2_and_derivative(M, model.Mh.expand_as(M))[0]


def single_update(problem, ledh, state0, sched, generator) -> dict:
    """One LEDH update of ``state0`` on a schedule: estimate, error, ESS and
    the flow's largest cond(S⁰)."""
    st, _ = ledh.step(generator, state0, ledh.tracker.init(), problem.z, beta_schedule=sched)
    return {"mean": st.mean, "err": torch.linalg.norm(st.mean - problem.x_true).item(),
            "ess": ess_from_logw(st.log_weights).item(),
            "cond_max": st.diagnostics["condition_numbers"].max().item(),
            "particles": st.particles, "log_weights": st.log_weights}


def monte_carlo(problem, ledh, states, sched, generator):
    """The flow over B prior draws at once (``states`` stacked on a trial
    axis): each trial's error and ESS."""
    B = states.particles.shape[0]
    ts = stack_states([ledh.tracker.init()] * B)
    zs = problem.z.expand(B, 1, 2)
    st, _, _ = ledh.run_trials(generator, states, ts, zs, beta_schedule=sched)
    err = torch.linalg.norm(st.mean - problem.x_true, dim=-1)
    return err, torch.func.vmap(ess_from_logw)(st.log_weights)


def run_all(device="cuda", generator=None, n_trials: int = N_TRIALS, states=None) -> dict:
    """The schedules (and the linearized model β* was solved on), their κ₂
    profiles, the single update from one cloud and the Monte Carlo over
    ``n_trials`` prior draws (``states``: given draws, stacked), with the
    seconds of each part (to a sync)."""
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(42)
    problem = Problem(device)
    secs = {}
    sync(device)
    t0 = time.perf_counter()
    beta_lin, beta_opt, model = schedules(problem)
    sync(device)
    secs["beta*"] = time.perf_counter() - t0
    ledh = make_ledh(problem)
    scheds = {"lin": beta_lin, "opt": beta_opt}
    state0 = ledh.init_from_gaussian(gen, problem.x_prior, problem.P_prior)
    t0 = time.perf_counter()
    single = {k: single_update(problem, ledh, state0, s, gen) for k, s in scheds.items()}
    sync(device)
    secs["single"] = time.perf_counter() - t0
    if states is None:
        states = stack_states([ledh.init_from_gaussian(gen, problem.x_prior, problem.P_prior)
                               for _ in range(n_trials)])
    t0 = time.perf_counter()
    mc = {k: monte_carlo(problem, ledh, states, s, gen) for k, s in scheds.items()}
    sync(device)
    secs["mc"] = time.perf_counter() - t0
    return {"beta_lin": beta_lin, "beta_opt": beta_opt, "model": model,
            "kappa": {k: kappas(model, s) for k, s in scheds.items()},
            "single": single, "mc": mc, "seconds": secs}


def gates(res) -> dict:
    """``{gate: (value, held)}``: linear β's mean error below β*'s, finite."""
    lin, opt = (res["mc"][k][0].mean().item() for k in ("lin", "opt"))
    finite = all(bool(torch.isfinite(e).all()) for e, _ in res["mc"].values())
    return {"MC error linear < optimal": ((lin, opt), lin < opt),
            "finite MC errors": (None, finite and math.isfinite(lin + opt))}


def print_tables(res, card: str) -> None:
    kl, ko = res["kappa"]["lin"], res["kappa"]["opt"]
    s = res["seconds"]
    print(f"ex11 kappa_2(M(beta)) along the flow: linear max {kl.max().item():.2e} mean "
          f"{kl.mean().item():.2e}; optimal max {ko.max().item():.2e} mean "
          f"{ko.mean().item():.2e}; interior mean linear {kl[1:].mean().item():.2f}, optimal "
          f"{ko[1:].mean().item():.2f}; beta* solve {s['beta*']:.3f} s  [{card}]")
    print(f"ex11 LEDH single update, N={N_PARTICLES}, {N_STEPS} lambda-steps, identical "
          f"particles ({s['single']:.3f} s for both)  [{card}]:")
    for k, label in (("lin", "linear beta"), ("opt", "optimal beta*")):
        r = res["single"][k]
        m = r["mean"].tolist()
        print(f"  {label:13s} estimate ({m[0]:6.3f}, {m[1]:6.3f})   RMSE {r['err']:7.4f}   "
              f"ESS {r['ess']:6.1f}/{N_PARTICLES}   flow cond(S0) max {r['cond_max']:.2e}")
    n = res["mc"]["lin"][0].numel()
    print(f"ex11 Monte Carlo, {n} prior draws (one batched run_trials a schedule, "
          f"{s['mc']:.3f} s for both)  [{card}]:")
    for k, label in (("lin", "linear beta"), ("opt", "optimal beta*")):
        err, ess = (v.double() for v in res["mc"][k])
        jm, jsd, _ = JAX_MC[k]
        print(f"  {label:13s} RMSE {err.mean().item():7.4f} ± {err.std(unbiased=False).item():6.4f}"
              f" (JAX package {jm:.4f} ± {jsd:.4f})   ESS {ess.mean().item():6.1f} ± "
              f"{ess.std(unbiased=False).item():5.1f}")
    wins = (res["mc"]["opt"][0] < res["mc"]["lin"][0]).float().mean().item()
    print(f"  optimal beta* lower-error fraction: {wins * 100:.0f}% of trials")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    res = run_all(device)
    print_tables(res, card_line(device))
    return 0 if all(held for _, held in gates(res).values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
