"""Port parity: Lorenz-96 and the kernel particle filter against the JAX
package, and the committed nx = 1000 case.

- ``l96_rhs`` and one RK4 step equal the JAX package's to f32 rounding
  (rtol 1e-6); 50 integration steps to 1e-4 (rounding grows along the
  chaotic flow); the localization, kernel and divergence matrices to 1e-6.
- ``analyze`` at nx = 40 (both kernel types, localized and not), from one
  ensemble: the same number of pseudo-steps and s, the posterior within
  2e-4 (localized, or with a ridge that keeps B⁻¹ well conditioned).
- The committed nx = 1000 case (``benchmarks/kpf.py``): the same steps as
  the JAX package, and the posteriors within the tolerance that module
  states (3× the JAX package's own one-ulp sensitivity without
  localization; 1e-4 particle by particle with it).
- The Jacobi update (``tests/unit/test_kpf_update_order.py``): a numpy
  sweep of the reference equations that writes into a copy matches
  ``analyze`` to 2e-4.

``particle_filters_tpu_torch/benchmarks/data/kpf_l96_nx1000.npz`` equals
what the JAX package gives for ``examples/12_kernel_pf_experiments.py``'s
run. Run this file as a script to write it again and print the JAX
package's one-ulp sensitivities:

    JAX_PLATFORMS=cpu python tests/test_torch_kpf.py
"""

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

from particle_filters_tpu.core import linalg as jlin  # noqa: E402
from particle_filters_tpu.models import kernel_particle_filter as jk  # noqa: E402
from particle_filters_tpu.simulators import lorenz96 as jl  # noqa: E402
from particle_filters_tpu_torch import interop  # noqa: E402
from particle_filters_tpu_torch.benchmarks import kpf as tbench  # noqa: E402
from particle_filters_tpu_torch.models import kernel_particle_filter as tk  # noqa: E402
from particle_filters_tpu_torch.simulators import lorenz96 as tl  # noqa: E402

torch.set_num_threads(1)

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_model(H_idx, R):
    nx_of = lambda x: x.shape[-1]  # noqa: E731
    return jk.Model(H=lambda x: jnp.take(x, H_idx, axis=-1),
                    JH=lambda x: jnp.zeros((H_idx.shape[0], nx_of(x))).at[
                        jnp.arange(H_idx.shape[0]), H_idx].set(1.0),
                    R=R)


def torch_model(H_idx, R):
    obs = tl.ObsModel(H_idx=_t(H_idx), R=_t(R))
    return tk.Model(H=obs.H, JH=obs.JH, R=obs.R)


def _jax_cfg(cfg):
    return jk.KPFConfig(**cfg.__dict__)


def jax_data():
    """The example's run (``examples/12_kernel_pf_experiments.py:48-58``),
    its priors, observations and truths at obs indices 1 and 3, H_idx and
    diag R, and the JAX package's posterior and step count for each case of
    ``benchmarks/kpf.py``."""
    r = jl.simulate_lorenz96(nx=1000, F=8.0, dt=0.01, spinup_steps=1000, total_steps=1500,
                             Np=20, obs_interval=20, obs_fraction=4, obs_error_std=1.0,
                             seed=42)
    out = {"H_idx": np.asarray(r.H_idx, np.int32), "R_diag": np.asarray(jnp.diag(r.R))}
    for idx in (1, 3):
        t = int(r.obs_times[idx])
        out[f"prior{idx}"] = np.asarray(r.ensemble_traj[:, t, :])
        out[f"y{idx}"] = np.asarray(r.observations[idx])
        out[f"truth{idx}"] = np.asarray(r.truth_traj[t])
    model = jax_model(r.H_idx, r.R)
    for name, (cfg, idx) in tbench.CASES.items():
        st = jax.jit(jk.KernelParticleFilter(model, _jax_cfg(cfg)).analyze)(
            out[f"prior{idx}"], out[f"y{idx}"])
        out[f"post_{name}"] = np.asarray(st.particles)
        out[f"steps_{name}"] = np.asarray(st.steps, np.int32)
    return out


# --- Lorenz-96 -----------------------------------------------------------------------
def test_rhs_rk4_and_integration_match_jax():
    rng = np.random.default_rng(0)
    x = (8.0 + 2.0 * rng.standard_normal((3, 40))).astype(np.float32)
    np.testing.assert_allclose(tl.l96_rhs(_t(x)).numpy(), np.asarray(jl.l96_rhs(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-5)
    f_t, f_j = (lambda z: tl.l96_rhs(z, 8.0)), (lambda z: jl.l96_rhs(z, 8.0))
    np.testing.assert_allclose(tl.rk4_step(_t(x), 0.01, f_t).numpy(),
                               np.asarray(jl.rk4_step(jnp.asarray(x), 0.01, f_j)), rtol=1e-6)
    traj_t = tl.l96_integrate(_t(x[0]), 0.01, 50).numpy()
    traj_j = np.asarray(jl.l96_integrate(jnp.asarray(x[0]), 0.01, 50))
    assert traj_t.shape == (51, 40)
    np.testing.assert_allclose(traj_t, traj_j, rtol=1e-4, atol=1e-4)
    noisy = tl.l96_integrate(_t(x), 0.01, 5, q_std=0.1,
                             generator=torch.Generator().manual_seed(1))
    assert noisy.shape == (6, 3, 40) and not torch.equal(noisy[-1], tl.l96_integrate(
        _t(x), 0.01, 5)[-1])


def test_simulator_protocol_and_files(tmp_path):
    r = tl.simulate_lorenz96(nx=40, spinup_steps=50, total_steps=60, Np=5, obs_interval=20,
                             obs_fraction=2, seed=5, device=CPU)
    j = jl.simulate_lorenz96(nx=40, spinup_steps=50, total_steps=60, Np=5, obs_interval=20,
                             obs_fraction=2, seed=5)
    # deterministic: spin-up and truth; f32 rounding grows along the chaotic
    # flow over the 110 steps
    np.testing.assert_allclose(r.truth_traj.numpy(), np.asarray(j.truth_traj), rtol=1e-3,
                               atol=1e-3)
    for k in ("obs_times", "H_idx", "R"):
        np.testing.assert_array_equal(getattr(r, k).numpy(), np.asarray(getattr(j, k)))
    assert r.ensemble_traj.shape == (5, 61, 40) and r.observations.shape == (4, 20)
    assert r.config == j.config
    # the ensemble starts at the truth plus N(0, 2) perturbations
    pert = (r.ensemble_traj[:, 0] - r.truth_traj[0]).numpy()
    assert abs(pert.std() - np.sqrt(2.0)) < 0.2
    obs = tl.ObsModel(H_idx=r.H_idx, R=r.R)
    x = r.truth_traj[10]
    torch.testing.assert_close(obs.H(x), x[::2])
    torch.testing.assert_close(obs.JH(x) @ x, x[::2])
    r.save(str(tmp_path / "t"))
    back = jl.Lorenz96SimulationResult.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(back.ensemble_traj), r.ensemble_traj.numpy())
    assert back.config == r.config
    j.save(str(tmp_path / "j.npz"))
    fwd = tl.Lorenz96SimulationResult.load(str(tmp_path / "j.npz"), device=CPU)
    np.testing.assert_array_equal(fwd.observations.numpy(), np.asarray(j.observations))
    with pytest.raises(FileExistsError):
        r.save(str(tmp_path / "t"))
    ens = r.ensemble_traj[:, 5]
    np.testing.assert_allclose(tl.compute_ensemble_spread(ens).numpy(),
                               np.asarray(jl.compute_ensemble_spread(jnp.asarray(ens.numpy()))),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tl.compute_rmse(ens.mean(0), x)),
                               float(jl.compute_rmse(jnp.asarray(ens.mean(0).numpy()),
                                                     jnp.asarray(x.numpy()))), rtol=1e-6)


# --- kernels and localization ----------------------------------------------------------
def test_localization_and_kernels_match_jax():
    r = np.linspace(0.0, 2.5, 101).astype(np.float32)
    np.testing.assert_allclose(tk.gaspari_cohn(_t(r)).numpy(),
                               np.asarray(jk.gaspari_cohn(jnp.asarray(r))), rtol=1e-6, atol=1e-6)
    for radius in (3.0, np.inf):
        np.testing.assert_allclose(tk.build_localization_matrix(12, radius, device=CPU).numpy(),
                                   np.asarray(jk.build_localization_matrix(12, radius)),
                                   rtol=1e-6, atol=1e-7)
    metric = np.abs(np.subtract.outer(np.arange(6.0), np.arange(6.0))).astype(np.float32) * 0.7
    np.testing.assert_allclose(
        tk.build_localization_matrix(6, 2.0, metric, device=CPU).numpy(),
        np.asarray(jk.build_localization_matrix(6, 2.0, metric)), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="metric"):
        tk.build_localization_matrix(5, 2.0, metric, device=CPU)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((7, 5)).astype(np.float32)
    ell = (0.5 + rng.random(5)).astype(np.float32)
    for a, b in zip(tk.matrix_kernel_and_divergence(_t(X[2]), _t(X), _t(ell)),
                    jk.matrix_kernel_and_divergence(jnp.asarray(X[2]), jnp.asarray(X),
                                                    jnp.asarray(ell))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(tk.scalar_kernel_full_matrix(_t(X[1]), _t(X), 1.3),
                    jk.scalar_kernel_full_matrix(jnp.asarray(X[1]), jnp.asarray(X), 1.3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(tk.rbf_1d(_t(X), 0.8), jk.rbf_1d(jnp.asarray(X), 0.8)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    mu, B = tk.KernelParticleFilter.mean_and_cov(_t(X), reg=1e-3)
    mj, Bj = jk.KernelParticleFilter.mean_and_cov(jnp.asarray(X), reg=1e-3)
    np.testing.assert_allclose(B.numpy(), np.asarray(Bj), rtol=1e-5, atol=1e-6)


# --- analyze ------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def l96_40():
    return jl.simulate_lorenz96(nx=40, spinup_steps=200, total_steps=100, Np=20,
                                obs_interval=20, obs_fraction=2, obs_error_std=1.0, seed=5)


# Unlocalized, 20 members leave B of rank 19 in 40 dims; a ridge of 0.05
# (in place of 1e-6) keeps B⁻¹ well conditioned, so both packages' f32
# rounding stays small there too.
@pytest.mark.parametrize("cfg", [
    dict(kernel_type="diagonal", localization_radius=4.0, ds_init=0.1, max_steps=60),
    dict(kernel_type="diagonal", lengthscale_mode="fixed", fixed_lengthscale=2.0, reg=0.05),
    dict(kernel_type="scalar", localization_radius=4.0, c_move_max=3.0),
    dict(kernel_type="scalar", lengthscale_mode="std", min_steps=7, ds_init=0.3, reg=0.05),
], ids=["diag-loc", "diag-fixed", "scalar-loc", "scalar-min-steps"])
def test_analyze_matches_jax_at_nx40(l96_40, cfg):
    r = l96_40
    X = np.asarray(r.ensemble_traj[:, 60, :])
    y = np.asarray(r.observations[3])
    js = jk.KernelParticleFilter(jax_model(r.H_idx, r.R), jk.KPFConfig(**cfg)).analyze(X, y)
    ts = tk.KernelParticleFilter(torch_model(r.H_idx, r.R), tk.KPFConfig(**cfg)).analyze(
        _t(X), _t(y))
    assert int(ts.steps) == int(js.steps)
    assert float(ts.s) == float(js.s)
    np.testing.assert_array_equal(ts.ds_history.numpy(), np.asarray(js.ds_history))
    np.testing.assert_allclose(ts.particles.numpy(), np.asarray(js.particles), rtol=2e-4,
                               atol=2e-4)
    conv = interop.kpf_state_from_jax(js, device=CPU)
    assert conv.steps.dtype == torch.int32 and torch.equal(conv.ds_history, ts.ds_history)
    bounded = tk.KernelParticleFilter(torch_model(r.H_idx, r.R),
                                      tk.KPFConfig(**cfg, bounded_loop=True)).analyze(_t(X), _t(y))
    assert torch.equal(bounded.particles, ts.particles)


def test_pinned_jitter_reproduces_the_ladders_rung(l96_40):
    """Unlocalized without a ridge, B of 20 members in 40 dims has rank 19
    and needs a jitter rung; ``analyze(jitter=)`` at the rung that
    ``prior_factor`` reports gives the same posterior as the ladder."""
    r = l96_40
    X, y = _t(np.asarray(r.ensemble_traj[:, 60, :])), _t(np.asarray(r.observations[3]))
    kpf = tk.KernelParticleFilter(torch_model(r.H_idx, r.R), tk.KPFConfig(reg=0.0))
    _, rung = kpf.prior_factor(kpf._prior_stats(X)[1])
    assert float(rung) > 0.0
    free, pinned = kpf.analyze(X, y), kpf.analyze(X, y, jitter=float(rung))
    assert torch.equal(free.particles, pinned.particles) and int(free.steps) == int(pinned.steps)


def test_jacobi_update_matches_a_copy_writing_sweep():
    """One pseudo-step (min_steps = max_steps = 1) of ``analyze`` against a
    numpy sweep that writes each particle's move into a copy of the frozen
    ensemble, in a shuffled order (the reference's loop)."""
    rng = np.random.default_rng(2)
    Np, n = 12, 6
    X = rng.standard_normal((Np, n)).astype(np.float32)
    H_idx = np.arange(0, n, 2)
    R = 0.5 * np.eye(3, dtype=np.float32)
    y = rng.standard_normal(3).astype(np.float32)
    cfg = tk.KPFConfig(min_steps=1, max_steps=1, ds_init=0.5, c_move_max=1e9, reg=1e-3)
    out = tk.KernelParticleFilter(torch_model(H_idx, R), cfg).analyze(_t(X), _t(y))
    Xd = X.astype(np.float64)
    x0 = Xd.mean(0)
    A = Xd - x0
    B = A.T @ A / (Np - 1) + 1e-3 * np.eye(n)
    B_inv = np.linalg.inv(B + 1e-3 * np.eye(n))
    Hm = np.eye(n)[H_idx]
    G = np.stack([Hm.T @ np.linalg.solve(R, y - Hm @ x) - B_inv @ (x - x0) for x in Xd])
    ell = Xd.std(0) + 1e-12
    X_new = Xd.copy()
    for i in rng.permutation(Np):
        D = Xd[i] - Xd
        K = np.exp(-0.5 * (D / ell) ** 2)
        dK = -(D / ell**2) * K
        X_new[i] = Xd[i] + 0.5 * B @ ((K * G).mean(0) + dK.sum(0) / Np)
    np.testing.assert_allclose(out.particles.numpy(), X_new, rtol=2e-4, atol=2e-4)


def test_committed_data_equals_jax():
    want = jax_data()
    with np.load(str(tbench.DATA)) as f:
        got = {k: f[k] for k in f.files}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", list(tbench.CASES))
def test_committed_case_matches_jax(name):
    """The nx = 1000 case on the CPU: the JAX package's step count and
    jitter rung (recomputed here), the posterior within the module's
    tolerance, the same with the jitter pinned at the JAX package's rung
    (there the same factor); the localized analysis beats the forecast."""
    res = tbench.run_cases(CPU, cases={name: tbench.CASES[name]})[name]
    assert res["steps"] == res["pinned"]["steps"] == res["jax_steps"]
    cfg, idx = tbench.CASES[name]
    with np.load(str(tbench.DATA)) as f:
        assert res["rung"] == pytest.approx(jax_rung(cfg, f[f"prior{idx}"]), rel=1e-6)
    assert res["rung"] == pytest.approx(tbench.JAX_RUNG[name], rel=1e-6)
    kind, bound = tbench.tolerance(name)
    key = "rms" if kind == "rms" else "max_abs"
    assert res[key] <= bound and res["pinned"][key] <= bound
    if name == "localized":
        assert res["rmse_analysis"] < res["rmse_forecast"]


# The rungs of ``chol_with_jitter``'s ladder at its defaults.
RUNGS = (0.0,) + tuple(1e-9 * 10.0**k for k in range(6))


def jax_rung(cfg, X):
    """The jitter rung at which the JAX package's ``analyze`` factorizes
    B + reg·I for the prior ``X`` (the first that its Cholesky accepts)."""
    kpf = jk.KernelParticleFilter(jax_model(jnp.arange(2), jnp.eye(2)), _jax_cfg(cfg))
    _, B = kpf._prior_stats(jnp.asarray(X))
    B_reg = B + cfg.reg * jnp.eye(B.shape[0])
    for r in RUNGS:
        if np.all(np.isfinite(np.asarray(jlin.chol_with_jitter(B_reg, jitter=r, max_tries=0)))):
            return r
    return None


def main():
    """Write the committed file and print, for each case, the jitter rung
    of the JAX package's factor of the prior covariance, and the RMS change
    of its posterior under a one-ulp (seeded ±1) change of the prior."""
    data = jax_data()
    np.savez_compressed(str(tbench.DATA), **data)
    print("wrote", tbench.DATA, os.path.getsize(tbench.DATA), "bytes")
    model = jax_model(jnp.asarray(data["H_idx"]), jnp.diag(jnp.asarray(data["R_diag"])))
    for name, (cfg, idx) in tbench.CASES.items():
        X = data[f"prior{idx}"]
        print(f"{name}: JAX rung {jax_rung(cfg, X)!r}")
        sign = np.random.default_rng(0).choice([-1.0, 1.0], X.shape)
        Xp = np.nextafter(X, np.where(sign > 0, np.float32(np.inf), np.float32(-np.inf)))
        assert Xp.dtype == np.float32 and np.all(Xp != X)
        st = jax.jit(jk.KernelParticleFilter(model, _jax_cfg(cfg)).analyze)(Xp, data[f"y{idx}"])
        d = np.asarray(st.particles) - data[f"post_{name}"]
        print(f"{name}: steps {int(data[f'steps_{name}'])}, one-ulp RMS "
              f"{float(np.sqrt(np.mean(d ** 2)))!r}, max {float(np.abs(d).max())!r}")


if __name__ == "__main__":
    main()
