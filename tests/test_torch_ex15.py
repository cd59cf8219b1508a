"""Port parity: ``examples/15_pf_degeneracy_analysis.py`` and its twin
``particle_filters_tpu_torch/examples/ex15_pf_degeneracy_analysis.py``, on
the JAX package's seed-123 SV trajectory (``sv_vs_t2000.npz``).

- The boundary thresholds at Np = 200: resample fractions exactly 0
  (1e-9) and 1 (1 + 1e-9) in the port, as in the JAX package.
- The trigger's f32 comparison against the JAX package's at both
  thresholds where the ESS is N: a model whose likelihood is constant keeps
  every weight uniform, so ``ess < thresh·N`` compares ESS ≈ N (the JAX
  package's reads N, the port's one ulp above) with f32(thresh·N) = N at
  1 + 1e-9; both packages must resample on the same steps (none).
- The degeneracy panel at Np = 200 (the baseline's settings): every field's
  range (ESS in [1, N], entropy, Gini and the surviving fraction in [0, 1],
  max weight in [1/N, 1]), the summary's fields, and the module's gates on
  a cut run of the experiments (each of them at one setting, the first
  ``T_CUT`` steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.models import ParticleFilter as JaxPF
from particle_filters_tpu_torch.examples import ex15_pf_degeneracy_analysis as ex
from particle_filters_tpu_torch.examples.ex14_sv_variance_stabilized import (
    ALPHA,
    BETA,
    P0,
    SIGMA,
    load_data,
)
from particle_filters_tpu_torch.models import ParticleFilter

torch.set_num_threads(1)
CPU = torch.device("cpu")
NP = 200
T_CUT = 400  # the experiments' gate check on the first steps of the trajectory


@pytest.fixture(scope="module")
def data():
    return load_data(CPU)


def jax_obs_ll(x, z):
    var = BETA**2 * jnp.exp(x[0])
    return -0.5 * (z[0] ** 2 / var + jnp.log(var))


def jax_resampled(ys, n, thresh, obs_ll, key=4):
    pf = JaxPF(lambda x, u: ALPHA * x, None, jnp.array([[SIGMA**2]]), None, Np=n,
               obs_loglik=obs_ll, resample_thresh=thresh, regularize_after_resample=True)
    k0, k1 = jax.random.split(jax.random.PRNGKey(key))
    st = pf.initialize(k0, jnp.zeros(1), jnp.array([[P0]]))
    _, hist = jax.jit(lambda k, s: pf.run(k, s, jnp.asarray(ys)[:, None]))(k1, st)
    return np.asarray(hist["resampled"])


@pytest.mark.parametrize("thresh,frac", [(1e-9, 0.0), (1.0 + 1e-9, 1.0)])
def test_boundary_fractions(data, thresh, frac):
    p = ex.panel(ex.run_pf(CPU, data, NP, ex.SEED_BOUNDARY, thresh), data["X"], NP)
    assert p["resample_frac"] == frac and p["finite"]
    assert jax_resampled(data["Y"].numpy(), NP, thresh, jax_obs_ll).mean() == frac


@pytest.mark.parametrize("thresh", [1e-9, 1.0 + 1e-9])
def test_trigger_at_ess_equal_to_n_matches_jax(data, thresh):
    ys = data["Y"][:40]
    pf = ParticleFilter(lambda x, u: ALPHA * x, None, [[SIGMA**2]], None, Np=NP,
                        obs_loglik=lambda x, z: torch.zeros(()), resample_thresh=thresh,
                        regularize_after_resample=True, device=CPU)
    gen = torch.Generator().manual_seed(0)
    _, hist = pf.run(gen, pf.initialize(gen, [0.0], [[P0]]), ys[:, None])
    want = jax_resampled(ys.numpy(), NP, thresh, lambda x, z: jnp.zeros(()))
    np.testing.assert_array_equal(hist["resampled"].numpy(), want)


def test_panel_fields_and_ranges(data):
    hist = ex.run_pf(CPU, data, NP, ex.SEED_BASE)
    assert {"ess", "entropy", "gini", "max_weight", "unique_frac", "resampled"} <= set(hist)
    assert float(hist["ess"].min()) >= 1.0 - 1e-4 and float(hist["ess"].max()) <= NP * (1 + 1e-5)
    for k in ("entropy", "gini", "unique_frac"):
        assert 0.0 <= float(hist[k].min()) and float(hist[k].max()) <= 1.0 + 1e-6, k
    mw = hist["max_weight"]
    assert float(mw.min()) >= 1.0 / NP * (1 - 1e-5) and float(mw.max()) <= 1.0
    assert bool((hist["unique_frac"][~hist["resampled"]] == 1.0).all())
    p = ex.panel(hist, data["X"], NP)
    assert p["finite"] and p["rmse"] < 1.5 and 0.2 < p["resample_frac"] < 0.5
    assert 0.0 < p["unique_min"] <= p["unique_mean"] < 1.0


def test_cut_experiments_meet_the_gates(data):
    res = ex.run_all(CPU, data, n=NP, nps=(100,), thresholds=(0.5,),
                     methods=("stratified", "multinomial"), seeds=2, t=T_CUT)
    assert res["t"] == T_CUT
    assert set(res["thresh"]) == {(0.5, "stratified"), (0.5, "multinomial")}
    assert len(res["seeds"]) == 2 and set(res["boundary"]) == {lbl for _, lbl in ex.BOUNDARY}
    gates = ex.gates(res)
    assert all(held for _, held in gates.values()), gates
