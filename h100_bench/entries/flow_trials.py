"""Entry kind ``flow_trials``: one unit is one batch of trials through the
program's flow particle filter (``EDHFlowPF`` or ``LEDHFlowPF`` with a UKF
tracker), from the call to a sync, on the trials the configuration's
simulator draws from the seed. The unit calls ``run_trials`` once a step
(the step vmapped over trials, one host read of the triggers, one launch of
kernel B2 for every triggered trial) and hands each call the state the last
one returned, as a user who filters online does; so every step's state is
there for the check.

Every unit draws its inputs from the seed and its index: the initial cloud
N(0, Σ) and the process noise (one draw of (B·N, d) a step, by the sampler
it hands the program), and the generator the program draws the resample's
uniforms from. The plain reference gets the same inputs.

Workload keys: ``filter`` ("edh" | "ledh"), ``particles`` (N a trial),
``trace_units``, ``check_units``, ``reference_chunk`` (trials a block of the
reference) and ``limits``.

For the CPU rehearsal (``h100_bench/tests``): ``TOY``, the workload's and
the configuration's keys at a toy size (d = 16, where the program and the
plain filter agree to the last bit on the CPU), and ``FAULTS``, the faults a
run can have, each planted in the program by :func:`plant`.
"""

from __future__ import annotations

import math

import torch

from h100_bench import harness


class Entry:
    def __init__(self, traffic: dict, config: dict, seed: int, device) -> None:
        self.cfg, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.ref = harness.load_module("configs", config["name"])
        self.kind, self.n = traffic["filter"], int(traffic["particles"])
        self.B, self.T, self.d = config["trials"], config["steps"], config["d"]
        _, self.Z, self.sigma, self.L = self.ref.simulate(
            config, harness.generator(device, seed, "data"), device)
        self.filt = self._program()
        self.keep = harness.Keep(seed, int(traffic["check_units"]))
        self.resampled = []  # each unit's resample flags a step, for the counters
        self.shape = {"kind": self.kind, "trials": self.B, "particles": self.n, "dim": self.d,
                      "steps": self.T, "lambda_steps": config["lambda_steps"]}
        self.reset_counts()

    def _program(self):
        from particle_filters_tpu_torch.core.linalg import mvn_logpdf_chol
        from particle_filters_tpu_torch.models import (
            EDHConfig,
            EDHFlowPF,
            GaussianTracker,
            LEDHConfig,
            LEDHFlowPF,
            UnscentedKalmanFilter,
        )

        c, dev = self.cfg, self.device
        m1, m2, (lo, hi) = c["m1"], c["m2"], c["clip"]

        def h(x):
            return m1 * torch.exp(m2 * torch.clamp(x, lo, hi))

        def loglik(z, x):
            lam = h(x)
            return torch.sum(z * torch.log(lam + 1e-10) - lam)

        jac = torch.func.jacfwd(h)
        R = torch.diag(h(torch.zeros(self.d, device=dev)))
        u = c["ukf"]
        ukf = UnscentedKalmanFilter(lambda x, _: c["alpha"] * x, h, self.sigma, R,
                                    alpha=u["alpha"], beta=u["beta"], kappa=u["kappa"],
                                    jitter=u["jitter"], device=dev)
        L = self.L
        args = (GaussianTracker(ukf), lambda x, _, v: c["alpha"] * x + v, h,
                lambda x: jac(x).to(x.dtype),
                lambda xn, xo: mvn_logpdf_chol(xn, c["alpha"] * xo, L), loglik, R)
        if self.kind == "edh":
            cfg = EDHConfig(n_particles=self.n, n_lambda_steps=c["lambda_steps"],
                            flow_integrator="euler",
                            resample_ess_ratio=c["resample_ess_ratio"])
            return EDHFlowPF(*args, cfg, device=dev)
        cfg = LEDHConfig(n_particles=self.n, n_lambda_steps=c["lambda_steps"],
                         resample_ess_ratio=c["resample_ess_ratio"])
        return LEDHFlowPF(*args, cfg, device=dev)

    # --- the inputs of a unit ------------------------------------------------
    def particles0(self, i: int):
        gen = harness.generator(self.device, self.seed, i, "init")
        eps = torch.randn((self.B, self.n, self.d), generator=gen, device=self.device)
        return eps @ self.L.T

    def noise(self, i: int):
        """The process noise of unit i: ``noise(k)`` is step k's (B, N, d)."""
        gen = harness.generator(self.device, self.seed, i, "noise")
        steps = iter(range(self.T))

        def draw(k):
            if next(steps) != k:
                raise RuntimeError("the process noise is drawn once a step, in order.")
            eps = torch.randn((self.B * self.n, self.d), generator=gen, device=self.device)
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False  # an input: float32 also in the control
            try:
                return (eps @ self.L.T).view(self.B, self.n, self.d)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev

        return draw

    def _run(self, i: int, steps: int) -> list:
        """``steps`` steps of unit i, one ``run_trials`` call each: every
        step's state as the program returned it (no copy)."""
        from particle_filters_tpu_torch.core.structs import stack_states
        from particle_filters_tpu_torch.models.edh_particle_filter import FlowPFState

        dev, B, n, d = self.device, self.B, self.n, self.d
        logw = torch.full((B, n), -math.log(n), device=dev)
        st = FlowPFState(
            particles=self.particles0(i), weights=torch.exp(logw), log_weights=logw,
            mean=torch.zeros((B, d), device=dev), cov=self.sigma.expand(B, d, d),
            diagnostics={"condition_numbers": torch.zeros((B, self.cfg["lambda_steps"]),
                                                          device=dev),
                         "resampled": torch.zeros(B, dtype=torch.bool, device=dev)})
        ts = stack_states([self.filt.tracker.init(torch.zeros(d, device=dev), self.sigma)] * B)
        gen, draw, out = harness.generator(dev, self.seed, i, "resample"), self.noise(i), []
        for k in range(steps):
            st, ts, hist = self.filt.run_trials(
                gen, st, ts, self.Z[:, k:k + 1],
                process_noise_sampler=lambda _g, m, nx, k=k: draw(k).reshape(-1, nx)[:m])
            out.append({"particles": st.particles, "logw": st.log_weights,
                        "track_mean": ts.mean, "track_cov": ts.cov,
                        "mean": hist["mean"][:, 0], "resampled": hist["resampled"][:, 0]})
        return out

    def warm_up(self) -> None:
        """One step of a batch at the cell's shapes (every step has the same
        shapes); its output is dropped."""
        self._run(-1, 1)

    def unit(self, i: int) -> None:
        steps = self._run(i, self.T)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.keep.add(i, steps)
        self.resampled.append([s["resampled"] for s in steps])

    def work(self, units: int) -> dict:
        return {"trials": units * self.B, "steps": units * self.T}

    def reset_counts(self) -> None:
        from particle_filters_tpu_torch.ops.resample import resample_by_starts

        resample_by_starts.launches = 0

    def counts(self, units: int) -> dict:
        from particle_filters_tpu_torch.ops.resample import resample_by_starts

        resampled = sum(int(r.sum()) for unit in self.resampled[-units:] for r in unit)
        return {"steps": units * self.T, "b2_launches": resample_by_starts.launches,
                "b2_rows": resampled * self.n}

    def free(self) -> None:
        """Drop the program's filter; keep the units' outputs."""
        self.filt = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        """The units kept (``check_units`` of them drawn from the seed, the
        last always among them), every step from the program's own previous
        state against the plain filter on the same inputs (the
        configuration's ``compare``): ``({name: (worst value, limit)}, units
        failed, [numbers of each unit])``. With ``control`` the
        configuration's control stands in the program's place, on the first
        ``check_units`` units."""
        plain = self.ref.PlainFilter(self.cfg, self.kind, self.sigma, self.L,
                                     chunk=int(self.traffic["reference_chunk"]))
        units = ([(i, None) for i in range(int(self.traffic["check_units"]))] if control
                 else self.keep.items())
        per_unit = []
        for i, steps in units:
            start = plain.start(self.particles0(i))
            if control:
                steps = self.ref.control(plain, start, self.Z, self.noise(i),
                                         harness.generator(self.device, self.seed, i, "resample"))
            per_unit.append(self.ref.compare(
                plain, start, steps, self.Z, self.noise(i),
                harness.generator(self.device, self.seed, i, "resample")))
        return harness.worst(per_unit, self.traffic["limits"])


# --- the CPU rehearsal ---------------------------------------------------------
TOY = ({"particles": 20, "trace_units": 1, "check_units": 2, "reference_chunk": 2,
        "limits": {"particle_gap_p50": 1e-4, "particle_gap_p90": 1e-4, "track_gap": 1e-4,
                   "mean_gap_p50": 1e-4}},
       {"d": 16, "trials": 4, "steps": 4})
FAULTS = ("state unchanged", "state unchanged after step 0", "half the batch",
          "half the trials not flowed", "resample skipped", "an answer altered")


def plant(monkeypatch, fault: str) -> None:
    """Plant ``fault`` in the program under ``monkeypatch``: a step that
    returns its state unchanged (every step, or every step after the
    first); half of the trials left out, their answers copied from the
    others (tracker too); half of the trials' particles left where they
    were, the tracker whole; the triggered trials' rows not resampled;
    the means' normalizer 5 % off."""
    from particle_filters_tpu_torch.core.structs import state_fields
    from particle_filters_tpu_torch.models import edh_particle_filter
    from particle_filters_tpu_torch.models.edh_particle_filter import _FlowPF

    orig_adv, orig_trials = _FlowPF._advance, _FlowPF.run_trials
    if fault in ("state unchanged", "state unchanged after step 0"):
        after = fault.endswith("step 0")

        def advance(self, particles, log_weights, ts, *a, **k):
            xk, lw, conds, ts_new = orig_adv(self, particles, log_weights, ts, *a, **k)
            if not after:
                return particles, log_weights, conds, ts
            later = ts.t > 0  # the step's index, per trial under vmap
            return (torch.where(later, particles, xk), torch.where(later, log_weights, lw),
                    conds, ts_new)

        monkeypatch.setattr(_FlowPF, "_advance", advance)
    elif fault in ("half the batch", "half the trials not flowed"):
        def trials(self, gen, states, tracks, zs, *a, **k):
            h = zs.shape[0] // 2
            if fault == "half the trials not flowed":
                st, ts, hist = orig_trials(self, gen, states, tracks, zs, *a, **k)
                p = torch.cat([st.particles[:h], states.particles[h:]])
                lw = torch.cat([st.log_weights[:h], states.log_weights[h:]])
                mean = hist["mean"].clone()
                mean[h:, 0] = (torch.softmax(lw[h:], -1)[:, None, :] @ p[h:])[:, 0]
                return (type(st)(particles=p, weights=torch.exp(lw), log_weights=lw,
                                 mean=st.mean, cov=st.cov, diagnostics=st.diagnostics),
                        ts, dict(hist, mean=mean))

            def half(s):
                return type(s)(*(({kk: v[:h] for kk, v in f.items()} if isinstance(f, dict)
                                  else f[:h]) for f in state_fields(s)))

            st, ts, hist = orig_trials(self, gen, half(states), half(tracks), zs[:h], *a, **k)

            def twice(s):
                return type(s)(*(({kk: torch.cat([v, v]) for kk, v in f.items()}
                                  if isinstance(f, dict) else torch.cat([f, f]))
                                 for f in state_fields(s)))

            return twice(st), twice(ts), {kk: torch.cat([v, v]) for kk, v in hist.items()}

        monkeypatch.setattr(_FlowPF, "run_trials", trials)
    elif fault == "resample skipped":
        def resample(generator, particles, **k):
            torch.rand((particles.shape[0],), generator=generator, device=particles.device)
            return particles

        monkeypatch.setattr(edh_particle_filter, "systematic_resample_values_batched", resample)
    elif fault == "an answer altered":
        orig_moments = _FlowPF._moments

        def moments(particles, logw):
            mean, cov = orig_moments(particles, logw)
            return 1.05 * mean, cov

        monkeypatch.setattr(_FlowPF, "_moments", staticmethod(moments))
    else:
        raise ValueError(fault)
