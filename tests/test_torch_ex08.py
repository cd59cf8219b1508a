"""Port parity: ``examples/08_dpf_ot_tuning.py`` and its twin
``particle_filters_tpu_torch/examples/ex08_dpf_ot_tuning.py``.

- The JAX package's best cell (ε 0.01, damping 1, 50 iterations) from its
  data and draws (the script's 10 seeds): each seed's RMSE within 2e-5
  relative of the JAX script's ``run_filter`` (f32; ε = 0.01 divides the
  cost by 0.01, and 20 resamples of 50 iterations compound the rounding),
  and the mean equal to the committed ``ot_tuning_results.json``'s to 1e-5.
- The vmapped grid (ε and damping as 0-dim tensors through
  ``sinkhorn_ot_resample``) equal to a loop over its cells with Python
  floats, within 1e-6 relative (vmap batches the same ops).
- The sweep at the example's size on the CPU from the port's own draws, at
  25 and 50 iterations: every cell finite and the module's gates.

Run this file as a script to print the JAX package's best cell's standard
error (``ex08_dpf_ot_tuning.JAX_BEST_SE``) and the best cell's mean RMSE
over 200 seeds in both packages (about a minute):

    JAX_PLATFORMS=cpu python tests/test_torch_ex08.py
"""

import importlib
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from particle_filters_tpu_torch.examples import ex08_dpf_ot_tuning as ex  # noqa: E402

sys.path.insert(0, str(ROOT / "examples"))
jex = importlib.import_module("08_dpf_ot_tuning")  # the JAX script; its main() is not run

torch.set_num_threads(1)
CPU = torch.device("cpu")


def jax_inputs(keys):
    """The JAX script's data and the draws its ``run_filter`` takes."""
    xs, ys = jax.vmap(jex.simulate)(keys)
    init, steps = [], []
    for key in keys:
        k_init, k_scan = jax.random.split(key)
        init.append(jax.random.normal(k_init, (ex.N, 1)))
        steps.append(jnp.stack([jax.random.normal(k, (ex.N, 1))
                                for k in jax.random.split(k_scan, ex.T)]))
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    return (xs, ys), (t(xs), t(ys)), (t(jnp.stack(init)), t(jnp.stack(steps)))


def jax_cell(keys, xs, ys, eps, damping, n_iters):
    f = jax.vmap(lambda k, x, y: jnp.sqrt(jnp.mean(
        (jex.run_filter(k, y, eps, damping, n_iters) - x) ** 2)))
    return np.asarray(jax.jit(f)(keys, xs, ys))


def test_best_cell_from_jax_draws():
    keys = jax.random.split(jax.random.PRNGKey(0), ex.SEEDS)
    (jxs, jys), (xs, ys), noise = jax_inputs(keys)
    b = ex.JAX_BEST
    want = jax_cell(keys, jxs, jys, b["epsilon"], b["damping"], b["n_iters"])
    got = ex.seed_rmses(xs, ys, noise, torch.tensor(b["epsilon"]), torch.tensor(b["damping"]),
                        b["n_iters"])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    committed = json.loads((ROOT / "examples" / "ot_tuning_results.json").read_text())["best"]
    assert committed["epsilon"] == np.float32(b["epsilon"]) and committed["damping"] == b["damping"]
    np.testing.assert_allclose(got.mean().item(), committed["rmse"], rtol=1e-5)
    np.testing.assert_allclose(ex.JAX_BEST_RMSE, committed["rmse"], rtol=0)


def test_vmapped_grid_equals_the_loop_over_cells():
    gen = torch.Generator().manual_seed(5)
    xs, ys = ex.simulate(gen, 2, CPU)
    noise = ex.draw_noise(gen, 2, CPU)
    eps_grid, damp_grid, n_iters = (0.01, 0.2), (0.5, 1.0), 5
    grid = ex.grid_rmses(xs, ys, noise, n_iters, eps_grid, damp_grid)
    assert grid.shape == (2, 2, 2)
    for i, e in enumerate(eps_grid):
        for j, d in enumerate(damp_grid):
            for s in range(2):
                means = ex.filter_means(noise[0][s], noise[1][s], ys[s], e, d, n_iters)
                rmse = torch.sqrt(torch.mean((means - xs[s]) ** 2))
                np.testing.assert_allclose(grid[i, j, s].item(), rmse.item(), rtol=1e-6)


def test_sweep_meets_the_gates():
    iters = ex.ITERS_GRID[:2]  # 25 and 50 (the JAX package's best); 100 takes 2/3 of the time
    res = ex.run_all(CPU, iters_grid=iters)
    assert len(res["grid"]) == len(ex.EPS_GRID) * len(ex.DAMP_GRID) * len(iters)
    gates = ex.gates(res)
    assert all(held for _, held in gates.values()), gates


if __name__ == "__main__":
    keys = jax.random.split(jax.random.PRNGKey(0), ex.SEEDS)
    (jxs, jys), _, _ = jax_inputs(keys)
    b = ex.JAX_BEST
    r = jax_cell(keys, jxs, jys, b["epsilon"], b["damping"], b["n_iters"]).astype(np.float64)
    print("JAX_BEST_RMSE", r.mean(), "JAX_BEST_SE", r.std(ddof=1) / np.sqrt(r.size))
    k200 = jax.random.split(jax.random.PRNGKey(123), 200)
    x200, y200 = jax.vmap(jex.simulate)(k200)
    r = jax_cell(k200, x200, y200, b["epsilon"], b["damping"], b["n_iters"]).astype(np.float64)
    print("JAX package, 200 seeds:", r.mean(), "±", r.std(ddof=1) / np.sqrt(r.size))
    gen = torch.Generator().manual_seed(7)
    xs, ys = ex.simulate(gen, 200, CPU)
    r = ex.seed_rmses(xs, ys, ex.draw_noise(gen, 200, CPU), torch.tensor(b["epsilon"]),
                      torch.tensor(b["damping"]), b["n_iters"]).double()
    print("port (CPU), 200 seeds:", r.mean().item(), "±", (r.std() / np.sqrt(200)).item())
