"""Port parity: ``examples/11_spf_ledh_beta_schedule.py`` and its twin
``particle_filters_tpu_torch/examples/ex11_spf_ledh_beta_schedule.py``.

- β* from ``solve_beta_star_bisection`` on the model linearized at the
  prior mean: the problem's stiff prior (κ = 500) leaves the f32 solve an
  error of order 1e-4 (the port's f32 β* lies 2.4e-4 from its f64 β*, the
  JAX package's 1.4e-4), so the port's β* is held to the JAX package's
  within its own f32 error, max |β*_f32 − β*_f64|; the linear schedule bit
  for bit. (On the card ``chip_smoke.py`` holds β* to the CPU's within
  3e-7: the same arithmetic.)
- One LEDH update on each schedule from the JAX package's initial cloud
  (``init_from_gaussian(PRNGKey(42))``): particles, log-weights and mean
  within 3× the largest change that ``ULP_PATTERNS`` random one-ulp changes
  of the initial particles make in the JAX package's own update (RMS for
  the particles and log-weights, max for the mean): the Woodbury flow of
  the 1000:2 prior amplifies rounding (one ulp moves the JAX package's
  particles by ~0.0076 RMS and its mean by up to ~6e-4).
- The κ₂ profiles of both schedules within 1e-4 relative.
- The batched Monte Carlo (one ``run_trials`` call) equal to the trials run
  one at a time, within 1e-5.
- The Monte Carlo at 8 of the port's own draws on the CPU: each schedule's
  errors against the JAX package's 50 (``JAX_MC``) by the Welch test
  (p ≥ 1e-3), and the negative finding (linear below optimal).

Run this file as a script to print the JAX package's Monte Carlo again
(``ex11_spf_ledh_beta_schedule.JAX_MC``; about 30 s):

    JAX_PLATFORMS=cpu python tests/test_torch_ex11.py
"""

import dataclasses
import os
import sys

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from particle_filters_tpu.core.weights import ess_from_logw  # noqa: E402
from particle_filters_tpu.models.ledh_particle_filter import LEDHConfig, LEDHFlowPF  # noqa: E402
from particle_filters_tpu.models.stochastic_particle_filter import (  # noqa: E402
    LinearGaussianBayes,
    kappa2_and_derivative,
    solve_beta_star_bisection,
)
from particle_filters_tpu.models.trackers import TrackerState  # noqa: E402
from particle_filters_tpu_torch.benchmarks._stats import P_MIN, welch_z  # noqa: E402
from particle_filters_tpu_torch.core.structs import stack_states  # noqa: E402
from particle_filters_tpu_torch.examples import ex11_spf_ledh_beta_schedule as ex  # noqa: E402
from particle_filters_tpu_torch.interop import state_from_jax  # noqa: E402
from particle_filters_tpu_torch.models.stochastic_particle_filter import (  # noqa: E402
    solve_beta_star_bisection as solve_beta_star_port,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
ULP_PATTERNS = 4  # random one-ulp changes of the initial particles

X_TRUE, SENSORS = jnp.array(ex.X_TRUE), jnp.array(ex.SENSORS)
X_PRIOR, P_PRIOR = jnp.array(ex.X_PRIOR), jnp.array(ex.P_PRIOR)
R, Z_OBS = jnp.array(ex.R_OBS), jnp.array(ex.Z_OBS)


def h_bearing(x):
    d = x[None, :] - SENSORS
    return jnp.arctan2(d[:, 1], d[:, 0])


def log_like(z, x):
    diff = z - h_bearing(x)
    diff = jnp.arctan2(jnp.sin(diff), jnp.cos(diff))
    return -0.5 * diff @ jnp.linalg.solve(R, diff)


class StaticTracker:
    def init(self):
        return TrackerState(mean=X_PRIOR, cov=P_PRIOR, past_mean=X_PRIOR,
                            t=jnp.asarray(0, jnp.int32))

    def predict(self, ts, u=None):
        return ts, X_PRIOR, P_PRIOR

    def update(self, ts, z):
        return ts, ts.mean, ts.cov


def jax_setup():
    """The JAX script's schedules, model and flow."""
    model = LinearGaussianBayes.create(X_PRIOR, P_PRIOR, jax.jacfwd(h_bearing)(X_PRIOR), R, Z_OBS)
    _, beta_opt, _ = solve_beta_star_bisection(model.M0, model.Mh, mu=ex.MU,
                                               n_grid=ex.N_STEPS + 1)
    ledh = LEDHFlowPF(tracker=StaticTracker(), g=lambda x, u, v: x, h=h_bearing,
                      jacobian_h=jax.jacfwd(h_bearing), log_trans_pdf=lambda xn, xo: 0.0,
                      log_like_pdf=log_like, R=R,
                      config=LEDHConfig(n_particles=ex.N_PARTICLES, n_lambda_steps=ex.N_STEPS,
                                        resample_ess_ratio=0.0))
    return {"lin": jnp.linspace(0.0, 1.0, ex.N_STEPS + 1), "opt": beta_opt}, model, ledh


def jax_mc(n_trials=ex.N_TRIALS):
    """The JAX script's Monte Carlo: ``{schedule: (errors, ess)}``."""
    scheds, _, ledh = jax_setup()

    def one_trial(key):
        st = ledh.init_from_gaussian(key, X_PRIOR, P_PRIOR)
        out = {}
        for name, sched in scheds.items():
            stf, _ = ledh.step(jax.random.fold_in(key, 1), st, StaticTracker().init(), Z_OBS,
                               beta_schedule=sched)
            out[name] = (jnp.linalg.norm(stf.mean - X_TRUE), ess_from_logw(stf.log_weights))
        return out

    return jax.jit(jax.vmap(one_trial))(jax.random.split(jax.random.PRNGKey(7), n_trials))


@pytest.fixture(scope="module")
def jax_ref():
    return jax_setup()


@pytest.fixture(scope="module")
def port():
    problem = ex.Problem(CPU)
    return problem, ex.make_ledh(problem), ex.schedules(problem)


def test_beta_star_matches_jax(jax_ref, port):
    scheds, _, _ = jax_ref
    _, _, (beta_lin, beta_opt, model) = port
    beta64 = solve_beta_star_port(model.M0.double(), model.Mh.double(), mu=ex.MU,
                                  n_grid=ex.N_STEPS + 1)[1]
    f32_error = (beta_opt.double() - beta64).abs().max().item()
    assert 0.0 < f32_error < 1e-3
    np.testing.assert_allclose(beta_opt.numpy(), np.asarray(scheds["opt"]), rtol=0,
                               atol=f32_error)
    np.testing.assert_array_equal(beta_lin.numpy(), np.asarray(scheds["lin"]))


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@pytest.mark.parametrize("name", ["lin", "opt"])
def test_single_update_from_jax_particles(jax_ref, port, name):
    scheds, model, ledh_j = jax_ref
    problem, ledh, _ = port
    st0 = ledh_j.init_from_gaussian(jax.random.PRNGKey(42), X_PRIOR, P_PRIOR)
    step = jax.jit(lambda s: ledh_j.step(jax.random.PRNGKey(0), s, StaticTracker().init(),
                                         Z_OBS, beta_schedule=scheds[name])[0])
    want = step(st0)
    p = np.asarray(st0.particles)
    rng = np.random.default_rng(0)
    spread = {"particles": 0.0, "log_weights": 0.0, "mean": 0.0}
    for _ in range(ULP_PATTERNS):
        up = rng.random(p.shape) < 0.5
        p_ulp = np.where(up, np.nextafter(p, np.inf, dtype=np.float32),
                         np.nextafter(p, -np.inf, dtype=np.float32))
        ulp = step(dataclasses.replace(st0, particles=jnp.asarray(p_ulp)))
        for field in ("particles", "log_weights"):
            spread[field] = max(spread[field], _rms(getattr(ulp, field), getattr(want, field)))
        spread["mean"] = max(spread["mean"],
                             float(np.abs(np.asarray(ulp.mean) - np.asarray(want.mean)).max()))
    got = ex.single_update(problem, ledh, state_from_jax(st0, device=CPU),
                           torch.tensor(np.asarray(scheds[name])), None)
    for field in ("particles", "log_weights"):
        assert 0.0 < _rms(got[field].numpy(), getattr(want, field)) <= 3.0 * spread[field], field
    assert np.abs(got["mean"].numpy() - np.asarray(want.mean)).max() <= 3.0 * spread["mean"]
    kappa_j = jax.vmap(lambda b: kappa2_and_derivative(model.M0 + b * model.Mh, model.Mh)[0])(
        scheds[name])
    kappa = ex.kappas(ex.schedules(problem)[2], torch.tensor(np.asarray(scheds[name])))
    np.testing.assert_allclose(kappa.numpy(), np.asarray(kappa_j), rtol=1e-4)


def test_batched_mc_equals_trials_one_at_a_time(port):
    problem, ledh, (beta_lin, beta_opt, _) = port
    gen = torch.Generator().manual_seed(3)
    states = [ledh.init_from_gaussian(gen, problem.x_prior, problem.P_prior) for _ in range(3)]
    for sched in (beta_lin, beta_opt):
        err, ess = ex.monte_carlo(problem, ledh, stack_states(states), sched, None)
        for i, st in enumerate(states):
            one = ex.single_update(problem, ledh, st, sched, None)
            np.testing.assert_allclose(err[i].item(), one["err"], rtol=1e-5)
            np.testing.assert_allclose(ess[i].item(), one["ess"], rtol=1e-5)


def test_monte_carlo_against_jax():
    res = ex.run_all(CPU, n_trials=8)
    for name in ("lin", "opt"):
        err = res["mc"][name][0].tolist()
        _, p = welch_z(err, *ex.JAX_MC[name])
        assert p >= P_MIN, (name, err, ex.JAX_MC[name], p)
    gates = ex.gates(res)
    assert all(held for _, held in gates.values()), gates


if __name__ == "__main__":
    mc = jax_mc()
    for name in ("lin", "opt"):
        err = np.asarray(mc[name][0], np.float64)
        print(f'"{name}": ({err.mean()!r}, {err.std(ddof=1)!r}, {err.size}),')
