"""Port parity: ``examples/01_kalman_lgssm.py`` and its twin
``particle_filters_tpu_torch/examples/ex01_kalman_lgssm.py``.

- On the JAX package's simulated data (two of the script's seeds, T = 1000):
  the port's filtered means and covariances within 1e-5 relative of the JAX
  package's ``kalman_filter_general`` (f32, Joseph form; 1e-6 absolute for
  entries near 0), the mean NEES within 1e-5 relative, the same count of
  steps inside the coverage band.
- The NEES band: it holds 2, the JAX package's own 10-seed mean (2.0343),
  and widens as the seeds fall.
- The port's 10 seeds on the CPU (its own draws) meet the module's gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_filters_tpu.models import kalman_filter_general as jax_kf
from particle_filters_tpu.simulators import simulate_lgssm as jax_simulate
from particle_filters_tpu.utils import coverage_95 as jax_coverage
from particle_filters_tpu.utils import nees as jax_nees
from particle_filters_tpu_torch.examples import ex01_kalman_lgssm as ex

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [42, 2024])
def test_filter_matches_jax_on_its_data(seed):
    data = jax_simulate(ex.A, ex.B, ex.C, ex.D, ex.SIGMA, ex.T, seed=seed)
    want = jax_kf(data.Y, ex.A, ex.C, np.eye(2, dtype=np.float32), ex.Q, ex.R,
                  x0=np.zeros(2, np.float32), P0=ex.SIGMA, use_joseph=True)
    X = torch.tensor(np.asarray(data.X))
    got = ex.filter_seed(X, torch.tensor(np.asarray(data.Y)), CPU)
    np.testing.assert_allclose(got["kf"].x_filt.numpy(), np.asarray(want.x_filt), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["kf"].P_filt.numpy(), np.asarray(want.P_filt), rtol=1e-5,
                               atol=1e-6)
    nees = float(jnp.mean(jax_nees(want.x_filt, want.P_filt, data.X)))
    np.testing.assert_allclose(got["nees"], nees, rtol=1e-5)
    # the same count of steps inside the band (each mean rounds in f32)
    cover = float(jax_coverage(want.x_filt, want.P_filt, data.X))
    assert abs(got["coverage"] - cover) < 0.5 / ex.T


def test_nees_band():
    lo, hi = ex.nees_band(len(ex.SEEDS))
    assert lo < 2.0 < hi and lo <= 2.0343 <= hi
    lo1, hi1 = ex.nees_band(1)
    assert lo1 < lo and hi1 > hi


def test_ten_seeds_meet_the_gate():
    res = ex.run_all(CPU)
    assert len(res["rows"]) == len(ex.SEEDS)
    assert 0.15 < res["rmse"] < 0.25 and 0.9 < res["coverage"] < 1.0
    gates = ex.gates(res)
    assert all(held for _, held in gates.values()), gates
