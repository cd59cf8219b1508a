"""The kernel particle filter on Lorenz-96 at nx = 1000, Np = 20 — the port's
twin of ``examples/12_kernel_pf_experiments.py``, held against the JAX
package's posteriors.

    python -m particle_filters_tpu_torch.benchmarks.kpf

The data is the example's: ``simulate_lorenz96(nx=1000, Np=20, obs every
20 steps on every 4th variable, obs_error_std=1, seed=42)`` from the JAX
package, written once on the CPU into ``data/kpf_l96_nx1000.npz`` with the
JAX package's ``analyze`` posteriors (``tests/test_torch_kpf.py``
regenerates it and holds it equal). Three analyses, each from the stored
prior ensemble and observation:

- ``scalar`` and ``diagonal``: the example's two configs at its first
  assimilation time (obs index 1), no localization;
- ``localized``: ``tests/integration/test_kpf_lorenz96.py``'s config
  (ds 0.1, at most 60 steps, Gaspari-Cohn radius 4, move cap 3) at obs
  index 3, where the forecast error has outgrown the observation noise and
  the analysis must beat the forecast (at obs index 1 it cannot: the
  JAX package's own diagonal analysis is 0.5405 against a forecast RMSE of
  0.4682).

Without localization the prior covariance B has rank 19 plus a 2e-6
ridge, and f32 rounding leaves eigenvalues of B + reg·I near −3e-6, so
``chol_with_jitter`` factorizes it only at a jitter rung that the
factorization itself decides: LAPACK's f32 Cholesky (the JAX package's on
the CPU, and the port's there) accepts 1e-4 first, cuSOLVER's on the
card may accept 1e-5, and B⁻¹ differs by up to 10× in 981 directions. So
each case runs twice: once as a user runs it (the ladder; its rung, step
count and difference from the JAX package's posterior are reported), and
once with the factor's jitter pinned at the JAX package's rung, which is
held against the JAX package's posterior. A one-ulp change of the prior
moves the JAX package's own posterior by the RMS in ``JAX_ULP_RMS``; the
pinned unlocalized posteriors are held to 3× that. The localized analysis
is well conditioned and is held particle by particle.
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import torch

from particle_filters_tpu_torch.benchmarks.snlg import _sync, card_line
from particle_filters_tpu_torch.models.kernel_particle_filter import (
    KernelParticleFilter,
    KPFConfig,
    Model,
)
from particle_filters_tpu_torch.simulators.lorenz96 import ObsModel, compute_rmse

DATA = pathlib.Path(__file__).resolve().parent / "data" / "kpf_l96_nx1000.npz"
_EXAMPLE = dict(ds_init=0.2, ds_min=1e-3, c_move_max=2.0, min_steps=5, max_steps=100,
                localization_radius=np.inf, reg=1e-6)
# name: (config, obs index of the prior and observation)
CASES = {
    "scalar": (KPFConfig(**_EXAMPLE, kernel_type="scalar", lengthscale_mode="fixed",
                         fixed_lengthscale=1.0), 1),
    "diagonal": (KPFConfig(**_EXAMPLE, kernel_type="diagonal", lengthscale_mode="std"), 1),
    "localized": (KPFConfig(ds_init=0.1, max_steps=60, localization_radius=4.0,
                            c_move_max=3.0), 3),
}
# The RMS change of the JAX package's posterior when the prior moves by one
# ulp (a seeded ±1 pattern), on the CPU, written by
# ``python tests/test_torch_kpf.py``; the port is held to 3× it.
JAX_ULP_RMS = {"scalar": 0.534300684928894, "diagonal": 0.14955976605415344}
ULP_FACTOR = 3.0
# The jitter at which the JAX package's factor of each case's B + reg·I is
# taken on the CPU (``python tests/test_torch_kpf.py`` prints it).
JAX_RUNG = {"scalar": 1e-4, "diagonal": 1e-4, "localized": 0.0}
LOCALIZED_MAX_ABS = 1e-4  # the port against JAX, particle by particle (CPU: 2.9e-6)


def load_data(device, path=DATA):
    with np.load(str(path)) as f:
        return {k: torch.as_tensor(f[k], device=device) for k in f.files}


def obs_model(data) -> Model:
    obs = ObsModel(H_idx=data["H_idx"], R=torch.diag(data["R_diag"]))
    return Model(H=obs.H, JH=obs.JH, R=obs.R)


def tolerance(name: str):
    """("rms" | "max", bound) that ``name``'s posterior is held to."""
    if name == "localized":
        return "max", LOCALIZED_MAX_ABS
    return "rms", ULP_FACTOR * JAX_ULP_RMS[name]


def run_cases(device="cuda", data=None, cases=CASES):
    """Each case's analysis on ``device``: ``{name: {...}}`` with ``steps``,
    ``jax_steps``, ``s``, ``rung`` (the jitter its factor took), ``ms``
    (wall, to a sync, after a warm-up), ``rms`` and ``max_abs`` (the
    posterior against the JAX package's), ``rmse_forecast`` and
    ``rmse_analysis`` (ensemble means against the truth) and ``posterior``;
    ``pinned`` holds ``steps``, ``s``, ``rms`` and ``max_abs`` of the run
    with the jitter pinned at ``JAX_RUNG``."""
    device = torch.device(device)
    data = load_data(device) if data is None else data
    model = obs_model(data)
    out = {}
    for name, (cfg, idx) in cases.items():
        X, y, truth = data[f"prior{idx}"], data[f"y{idx}"], data[f"truth{idx}"]
        want = data[f"post_{name}"]
        kpf = KernelParticleFilter(model, cfg)
        kpf.analyze(X, y)  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        st = kpf.analyze(X, y)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        pinned = kpf.analyze(X, y, jitter=JAX_RUNG[name])
        out[name] = {
            "steps": int(st.steps), "jax_steps": int(data[f"steps_{name}"]), "s": float(st.s),
            "rung": float(kpf.prior_factor(kpf._prior_stats(X)[1])[1]), "ms": ms,
            **_diff(st.particles, want),
            "rmse_forecast": compute_rmse(X.mean(0), truth).item(),
            "rmse_analysis": compute_rmse(st.particles.mean(0), truth).item(),
            "posterior": st.particles,
            "pinned": {"steps": int(pinned.steps), "s": float(pinned.s),
                       **_diff(pinned.particles, want)},
        }
    return out


def _diff(got, want):
    d = got - want
    return {"rms": torch.sqrt(torch.mean(d**2)).item(), "max_abs": d.abs().max().item()}


def print_cases(res, card: str) -> None:
    for name, r in res.items():
        kind, bound = tolerance(name)
        p = r["pinned"]
        print(f"KPF nx=1000 {name:9s}: {r['steps']} pseudo-steps (JAX {r['jax_steps']}), "
              f"s {r['s']:.6f}, {r['ms']:.3f} ms, factor at jitter {r['rung']:g}; posterior vs "
              f"JAX rms {r['rms']:.3e}, max {r['max_abs']:.3e}; RMSE forecast "
              f"{r['rmse_forecast']:.4f}, analysis {r['rmse_analysis']:.4f}; at the JAX "
              f"package's jitter {JAX_RUNG[name]:g}: {p['steps']} pseudo-steps, rms "
              f"{p['rms']:.3e}, max {p['max_abs']:.3e} ({kind} bound {bound:.3e})  [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("kpf needs a CUDA device.", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print_cases(run_cases("cuda"), card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
