"""Entry kind ``dpf_ot_grad``: one unit is one value-and-gradient evaluation
of the log-evidence of the program's Sinkhorn-OT differentiable particle
filter, what a step of fitting its parameters computes: ``DPF_OT.run_filter``
over T steps with ``return_log_evidence=True``, then ``torch.autograd.grad``
of the log-evidence for the three leaf tensors (α, σ, β), from the call to a
sync, on one sequence of a bank the configuration's simulator draws from
the seed. The parameters reach the filter through its transition and
observation closures and the initial cloud's std σ/√(1−α²).

The unit's inputs are ``dpf_ot_run``'s (this entry is its subclass): the
initial normals and the transition noise from the seed and the unit's
index, drawn again for the check, which hands them to the plain reference's
own whole run (the configuration's ``compare``).

Workload keys as ``dpf_ot_run``'s. ``counts`` reports the steps, the
Sinkhorn half-updates and their VJPs (``sinkhorn_ot_resample``'s counters),
and asserts both are 2 × iterations a step (a backward step: each run's
last resample is not upstream of the log-evidence). ``TOY`` and ``FAULTS``
for the CPU rehearsal (``h100_bench/tests``); the faults keep the forward's
values and break only the gradient, where the forward's checks cannot see
them.
"""

from __future__ import annotations

import torch

from h100_bench import harness

Base = harness.load_module("entries", "dpf_ot_run").Entry
PARAMS = ("alpha", "sigma", "beta")


class Entry(Base):
    def __init__(self, traffic: dict, config: dict, seed: int, device) -> None:
        from particle_filters_tpu_torch.models.dpf import DPF_OT

        super().__init__(traffic, config, seed, device)
        self.params = tuple(torch.tensor(float(config[k]), device=device, requires_grad=True)
                            for k in PARAMS)
        alpha, sigma, beta = self.params

        def transition(generator, x, t):
            return alpha * x + sigma * torch.randn(x.shape, generator=generator, device=x.device)

        def loglik(x, y, t):
            x = x[:, 0]
            return -0.5 * (y * y / (beta * beta) * torch.exp(-x) + x + 2 * torch.log(beta))

        self.filt = DPF_OT(self.n, 1, transition, loglik, epsilon=config["epsilon"],
                           n_sinkhorn_iters=config["sinkhorn_iters"],
                           damping=config["damping"], device=device)

    def _run(self, i: int, steps: int) -> dict:
        gen = harness.generator(self.device, self.seed, i, "noise")
        alpha, sigma, _ = self.params
        std0 = sigma / torch.sqrt(1 - alpha * alpha)
        ps, ws, log_z = self.filt.run_filter(
            gen, self.ys[i % self.ys.shape[0], :steps, None], [0.0], std0.reshape(1, 1),
            init_eps=self.init_eps(i), return_log_evidence=True)
        grads = torch.autograd.grad(log_z, self.params)
        return {"particles": ps.detach(), "weights": ws.detach(),
                "log_evidence": log_z.detach(), "grads": torch.stack(grads)}

    def warm_up(self) -> None:
        """One whole unit forward and backward, dropped: the kernels' builds
        and every shape, and the allocator grown to a unit's saved state, so
        that the first timed or traced unit allocates nothing new."""
        self._run(-1, self.T)

    def reset_counts(self) -> None:
        from particle_filters_tpu_torch.resampling.ot import sinkhorn_ot_resample

        sinkhorn_ot_resample.half_updates = 0
        sinkhorn_ot_resample.vjp_half_updates = 0

    def counts(self, units: int) -> dict:
        """The units' steps and ``backward_steps``, the resamples whose
        backward the log-evidence needs: all but each run's last, whose
        output no later increment reads, so autograd never reaches it.
        With them the Sinkhorn half-updates and their VJPs the program ran
        since :meth:`reset_counts`, asserted to be 2 × iterations a step and
        a backward step (every backward through every iteration)."""
        from particle_filters_tpu_torch.resampling.ot import sinkhorn_ot_resample

        iters = int(self.cfg["sinkhorn_iters"])
        out = {"steps": units * self.T, "backward_steps": units * (self.T - 1),
               "half_updates": sinkhorn_ot_resample.half_updates,
               "vjp_half_updates": sinkhorn_ot_resample.vjp_half_updates}
        assert out["half_updates"] == 2 * iters * out["steps"], out
        # the tile path's backward counts its VJPs; the torch ops' (CPU) have none to count
        want = 2 * iters * out["backward_steps"]
        assert out["vjp_half_updates"] in ((want, 0) if self.device.type == "cpu" else (want,)), out
        return out

    def check(self, control: bool = False):
        """The units kept (``check_units`` of them, the last always among
        them) against the plain reference's own whole run from the same
        initial normals and noise (the configuration's ``compare``): ``({name:
        (worst value, limit)}, units failed, [numbers of each unit])``. With
        ``control`` the configuration's control (that run, gradient included,
        in its lower precision) stands in the program's place, on the first
        ``check_units`` units."""
        units = ([(i, None) for i in range(int(self.traffic["check_units"]))] if control
                 else self.keep.items())
        per_unit = []
        for i, out in units:
            y, vs, e0 = self.ys[i % self.ys.shape[0]], self.noise(i), self.init_eps(i)[:, 0]
            if control:
                out = self.ref.control(self.cfg, e0, y, vs)
            per_unit.append(self.ref.compare(self.cfg, out, y, vs, e0))
        return harness.worst(per_unit, self.traffic["limits"])


# --- the CPU rehearsal ---------------------------------------------------------
TOY = ({"particles": 64, "sequences": 2, "trace_units": 1, "check_units": 2,
        "limits": {"grad_gap": 1e-4, "logz_gap": 1e-4, "particle_gap_p50": 1e-4,
                   "particle_gap_p90": 1e-4, "mean_gap": 1e-4}},
       {"steps": 5})
FAULTS = ("resampler output detached", "backward through 25 of the 50 iterations",
          "gradient to log a dropped", "initial cloud detached from alpha and sigma",
          "first increment's gradient left out", "damping 1 in the backward only")


def _straight_through(value, grad_of):
    """``value``'s numbers with ``grad_of``'s gradient."""
    return value.detach() + grad_of - grad_of.detach()


def plant(monkeypatch, fault: str) -> None:
    """Plant ``fault`` in the program under ``monkeypatch``, each leaving the
    forward's values as they are: the resampler's output cut from the graph;
    the resample's gradient taken through 25 of its 50 iterations, or with
    undamped updates, while its output is the 50 damped iterations'; the
    weights cut from the resample's gradient (no gradient reaches log a);
    the initial cloud cut from (α, σ); the first step's increment cut from
    the gradient."""
    from particle_filters_tpu_torch.models import dpf

    if fault == "initial cloud detached from alpha and sigma":
        orig_init = dpf.DPF_OT.init_particles

        def init_particles(self, *a, **k):
            p, w = orig_init(self, *a, **k)
            return p.detach(), w

        monkeypatch.setattr(dpf.DPF_OT, "init_particles", init_particles)
    elif fault == "first increment's gradient left out":
        orig_step = dpf.DPF_OT._step

        def step(self, generator, particles, weights, y, t, *a):
            out, increment = orig_step(self, generator, particles, weights, y, t, *a)
            return out, increment.detach() if t == 0 else increment

        monkeypatch.setattr(dpf.DPF_OT, "_step", step)
    elif fault in FAULTS:
        orig = dpf.sinkhorn_ot_resample

        def resample(particles, weights, **k):
            if fault == "gradient to log a dropped":
                return orig(particles, weights.detach(), **k)
            out = orig(particles, weights, **k)
            if fault == "resampler output detached":
                return (out[0].detach(),) + tuple(out[1:])
            other = dict(k, n_iters=k["n_iters"] // 2) if fault.startswith("backward") else \
                dict(k, damping=1.0)
            return (_straight_through(out[0], orig(particles, weights, **other)[0]),) + \
                tuple(out[1:])

        monkeypatch.setattr(dpf, "sinkhorn_ot_resample", resample)
    else:
        raise ValueError(fault)
