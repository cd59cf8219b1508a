"""Entry kind ``dpf_ot_run``: one unit is one whole run of the program's
Sinkhorn-OT differentiable particle filter (``DPF_OT.run_filter`` over T
steps: propagate, linear-domain weights, the dense Sinkhorn resample every
step; ``return_log_evidence=True``, diagnostics off), from the call to a
sync, on one sequence of a bank the configuration's simulator draws from
the seed.

Every unit draws its inputs from the seed and its index: the normals of
the stationary initial cloud, and the transition noise, which the program's
transition draws (one (N, 1) draw a step) from the generator the unit hands
``run_filter``. The check draws the same noise again, all T steps of a
checked unit (N × T floats), and hands it to the plain reference.

Workload keys: ``particles`` (N), ``sequences`` (the bank), ``trace_units``,
``check_units`` (the units compared) and ``limits`` (of ``compare``'s
numbers).

For the CPU rehearsal (``h100_bench/tests``): ``TOY``, the workload's and
the configuration's keys at a toy size (N = 64, T = 5, where a sound run
reads every number below 1e-5 on the CPU), and ``FAULTS``, the faults a run
can have, each planted in the program by :func:`plant`.
"""

from __future__ import annotations

import math

import torch

from h100_bench import harness

WARM_STEPS = 2  # the warm-up: every step has the same shapes


class Entry:
    def __init__(self, traffic: dict, config: dict, seed: int, device) -> None:
        from particle_filters_tpu_torch.models.dpf import DPF_OT

        self.cfg, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.ref = harness.load_module("configs", config["name"])
        self.n, self.T = int(traffic["particles"]), int(config["steps"])
        gen = harness.generator(device, seed, "data")
        _, self.ys = self.ref.simulate(config, int(traffic["sequences"]), gen, device)
        a, s, b = config["alpha"], config["sigma"], config["beta"]
        self.std0 = s / math.sqrt(1 - a * a)

        def transition(generator, x, t):
            return a * x + s * torch.randn(x.shape, generator=generator, device=x.device)

        def loglik(x, y, t):
            x = x[:, 0]
            return -0.5 * (y * y / (b * b) * torch.exp(-x) + x + 2 * math.log(b))

        self.filt = DPF_OT(self.n, 1, transition, loglik, epsilon=config["epsilon"],
                           n_sinkhorn_iters=config["sinkhorn_iters"],
                           damping=config["damping"], device=device)
        self.keep = harness.Keep(seed, int(traffic["check_units"]))
        self.shape = {"particles": self.n, "sinkhorn_iters": int(config["sinkhorn_iters"])}
        self.reset_counts()

    # --- the inputs of a unit ------------------------------------------------
    def init_eps(self, i: int):
        gen = harness.generator(self.device, self.seed, i, "init")
        return torch.randn((self.n, 1), generator=gen, device=self.device)

    def noise(self, i: int):
        """Unit i's transition noise, (T, N): the draws its run makes."""
        gen = harness.generator(self.device, self.seed, i, "noise")
        return torch.stack([torch.randn((self.n, 1), generator=gen, device=self.device)[:, 0]
                            for _ in range(self.T)])

    def _run(self, i: int, steps: int) -> dict:
        gen = harness.generator(self.device, self.seed, i, "noise")
        ps, ws, log_z = self.filt.run_filter(
            gen, self.ys[i % self.ys.shape[0], :steps, None], [0.0], [[self.std0]],
            init_eps=self.init_eps(i), return_log_evidence=True)
        return {"particles": ps, "weights": ws, "log_evidence": log_z}

    def warm_up(self) -> None:
        """A few steps at the cell's N (every step has the same shapes); the
        output is dropped."""
        self._run(-1, WARM_STEPS)

    def unit(self, i: int) -> None:
        out = self._run(i, self.T)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.keep.add(i, out)

    def work(self, units: int) -> dict:
        return {"particle_steps": units * self.n * self.T, "steps": units * self.T}

    def reset_counts(self) -> None:
        from particle_filters_tpu_torch.resampling.ot import sinkhorn_ot_resample

        sinkhorn_ot_resample.half_updates = 0

    def counts(self, units: int) -> dict:
        """The units' steps, and the Sinkhorn half-updates the program ran
        since :meth:`reset_counts` (its counter, raised in the dual loop)."""
        from particle_filters_tpu_torch.resampling.ot import sinkhorn_ot_resample

        return {"steps": units * self.T, "half_updates": sinkhorn_ot_resample.half_updates}

    def free(self) -> None:
        """Drop the program's filter; keep the units' outputs."""
        self.filt = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        """The units kept (``check_units`` of them drawn from the seed, the
        last always among them) against the plain reference on their
        sequences and noise (the configuration's ``compare``): ``({name:
        (worst value, limit)}, units failed, [numbers of each unit])``. With
        ``control`` the configuration's control (the plain filter in its
        lower precision, from the program's initial cloud) stands in the
        program's place, on the first ``check_units`` units."""
        units = ([(i, None) for i in range(int(self.traffic["check_units"]))] if control
                 else self.keep.items())
        per_unit = []
        for i, out in units:
            y, vs = self.ys[i % self.ys.shape[0]], self.noise(i)
            if control:
                out = self.ref.control(self.cfg, self.init_eps(i)[:, 0] * self.std0, y, vs)
            per_unit.append(self.ref.compare(self.cfg, out, y, vs))
        return harness.worst(per_unit, self.traffic["limits"])


# --- the CPU rehearsal ---------------------------------------------------------
TOY = ({"particles": 64, "sequences": 2, "trace_units": 1, "check_units": 2,
        "limits": {"particle_gap_p50": 1e-4, "particle_gap_p90": 1e-4, "mean_gap": 1e-4,
                   "logz_gap": 1e-4}},
       {"steps": 5})
FAULTS = ("25 of the 50 iterations", "epsilon doubled", "damping 1", "g half-update skipped",
          "projection not divided by b", "source weights uniform", "step returns its input",
          "first increment left out")


def plant(monkeypatch, fault: str) -> None:
    """Plant ``fault`` in the program under ``monkeypatch``: the resample
    with half the Sinkhorn iterations, twice the ε, undamped updates, the g
    half-update returning nothing (g stays 0: the resample's one logsumexp
    over the rows, τ_g's, reads 0), the barycentric projection not divided
    by b = 1/N, or uniform source weights a in place of the filter's; a
    step that returns the cloud and weights it was given; the log-evidence
    without its first step's increment."""
    from particle_filters_tpu_torch.models import dpf
    from particle_filters_tpu_torch.resampling import ot

    if fault == "g half-update skipped":
        class Torch:
            def __getattr__(self, name):
                return getattr(torch, name)

            @staticmethod
            def logsumexp(x, dim):
                return torch.zeros_like(x[0]) if dim == 0 else torch.logsumexp(x, dim=dim)

        monkeypatch.setattr(ot, "torch", Torch())
    elif fault in ("step returns its input", "first increment left out"):
        orig_step = dpf.DPF_OT._step

        def step(self, generator, particles, weights, y, t, *a):
            out, increment = orig_step(self, generator, particles, weights, y, t, *a)
            if fault == "first increment left out":
                return out, increment * (t > 0)
            return (particles, weights) + tuple(out[2:]), increment

        monkeypatch.setattr(dpf.DPF_OT, "_step", step)
    elif fault in FAULTS:
        orig = dpf.sinkhorn_ot_resample

        def resample(particles, weights, **k):
            if fault == "25 of the 50 iterations":
                k["n_iters"] //= 2
            elif fault == "epsilon doubled":
                k["epsilon"] *= 2
            elif fault == "damping 1":
                k["damping"] = 1.0
            elif fault == "source weights uniform":
                weights = torch.full_like(weights, 1.0 / weights.shape[0])
            out = orig(particles, weights, **k)
            if fault == "projection not divided by b":
                return (out[0] / particles.shape[0],) + tuple(out[1:])
            return out

        monkeypatch.setattr(dpf, "sinkhorn_ot_resample", resample)
    else:
        raise ValueError(fault)
