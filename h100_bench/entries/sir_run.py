"""Entry kind ``sir_run``: one unit is one whole run of the program's fused
SIR filter (``FusedSIRFilter``: ``initialize`` then ``run`` over T steps,
kernel B1 every step, kernel B2 on resample steps), from the call to a
sync, on one sequence of a bank the configuration's simulator draws from
the seed.

Workload keys: ``particles`` (N), ``sequences`` (the bank), ``trace_units``,
``check_units`` (the units compared) and ``limits`` (of ``compare``'s
numbers).

For the CPU rehearsal (``h100_bench/tests``): ``TOY``, the workload's and
the configuration's keys at a toy size, with limits for that size (at
N = 2^14 a sound run reads ``logz_gap`` up to ~0.25, ``mean_gap`` ~0.011
and ``ess_gap`` ~0.011 on the CPU), and ``FAULTS``, the faults a run can
have, each planted in the program by :func:`plant`.
"""

from __future__ import annotations

import torch

from h100_bench import harness


class Entry:
    def __init__(self, traffic: dict, config: dict, seed: int, device) -> None:
        from particle_filters_tpu_torch.ops.fused_pf import FusedSIRFilter, SVModel

        self.cfg, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.ref = harness.load_module("configs", config["name"])
        self.n, self.T = int(traffic["particles"]), int(config["steps"])
        gen = harness.generator(device, seed, "data")
        _, self.ys = self.ref.simulate(config, int(traffic["sequences"]), gen, device)
        a, s = config["alpha"], config["sigma"]
        self.filt = FusedSIRFilter(SVModel(a, config["beta"]), [[s * s]], Np=self.n,
                                   resample_thresh=config["resample_ess_ratio"], device=device)
        self.var0 = s * s / (1 - a * a)
        self.keep = harness.Keep(seed, int(traffic["check_units"]))
        self.resampled = []  # each unit's resample flags, for the counters
        self.shape = {"particles": self.n, "steps": self.T, "dim": 1}
        self.reset_counts()

    def _run(self, i: int):
        gen = harness.generator(self.device, self.seed, i, "filter")
        state = self.filt.initialize(gen, [0.0], [[self.var0]])
        _, hist = self.filt.run(gen, state, self.ys[i % self.ys.shape[0], :, None])
        return hist

    def warm_up(self) -> None:
        """One whole run at the cell's shapes (B1 compiles, B2 builds or
        loads, the allocator fills); its output is dropped."""
        self._run(-1)

    def unit(self, i: int) -> None:
        hist = self._run(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.keep.add(i, hist)
        self.resampled.append(hist["resampled"])

    def work(self, units: int) -> dict:
        return {"particle_steps": units * self.n * self.T, "steps": units * self.T}

    def reset_counts(self) -> None:
        from particle_filters_tpu_torch.ops.fused_pf import fused_step
        from particle_filters_tpu_torch.ops.resample import resample_by_starts

        fused_step.launches = 0
        resample_by_starts.launches = 0

    def counts(self, units: int) -> dict:
        """The program's launch counters since :meth:`reset_counts`, and the
        units' steps and resample steps (from their histories)."""
        from particle_filters_tpu_torch.ops.fused_pf import fused_step
        from particle_filters_tpu_torch.ops.resample import resample_by_starts

        resampled = sum(int(r.sum()) for r in self.resampled[-units:])
        return {"steps": units * self.T, "b1_launches": fused_step.launches,
                "b2_launches": resample_by_starts.launches, "resample_steps": resampled,
                "b2_rows": resampled * self.n}

    def free(self) -> None:
        """Drop the program's filter and its buffers; keep the histories."""
        self.filt = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        """The units kept (``check_units`` of them drawn from the seed, the
        last always among them) against the plain filter on their sequences:
        ``({name: (worst value, limit)}, units failed, [numbers of each
        unit])``. With ``control`` the configuration's control (the plain
        filter in its lower precision) stands in the program's place, on
        the first ``check_units`` units."""
        limits = self.traffic["limits"]
        per_unit = []
        units = ([(i, None) for i in range(int(self.traffic["check_units"]))] if control
                 else self.keep.items())
        for i, h in units:
            y = self.ys[i % self.ys.shape[0]]
            if control:
                prog = self.ref.control(self.cfg, y, self.n,
                                        harness.generator(self.device, self.seed, i, "filter"))
            else:
                prog = {"log_z": h["log_evidence"], "ess": h["ess"], "mean": h["mean"][:, 0],
                        "resampled": h["resampled"]}
            ref = self.ref.sir(self.cfg, y, self.n,
                               harness.generator(self.device, self.seed, i, "reference"))
            per_unit.append(self.ref.compare(prog, ref, self.n))
        return harness.worst(per_unit, limits)


# --- the CPU rehearsal ---------------------------------------------------------
TOY = ({"particles": 1 << 14, "sequences": 4, "trace_units": 2, "check_units": 2,
        "limits": {"logz_gap": 1.0, "mean_gap": 0.04, "ess_gap": 0.05}}, {})
FAULTS = ("state unchanged", "half the batch", "an answer altered")


def plant(monkeypatch, fault: str) -> None:
    """Plant ``fault`` in the program under ``monkeypatch``: a step that
    returns its state unchanged; half of the particles left out of the step
    (the mean and weights taken over the rest); step 100's posterior mean
    altered where the kernel writes it."""
    from particle_filters_tpu_torch.ops import fused_pf

    orig_core, orig_step = fused_pf.FusedSIRFilter._step_core, fused_pf._fused_step
    if fault == "state unchanged":
        def core(self, seed, generator, carry, *a, **k):
            _, trig, ok = orig_core(self, seed, generator, carry, *a, **k)
            return carry, trig, ok

        monkeypatch.setattr(fused_pf.FusedSIRFilter, "_step_core", core)
    elif fault == "half the batch":
        def step(x, lw, off_u, z, Lq, params, model, seed, eps, thresh, work, x_out, lw_out,
                 row_out, shard=(0, 1)):
            h = x.shape[1] // 2
            orig_step(x[:, :h], lw[:h], off_u, z, Lq, params, model, seed, eps, thresh, work,
                      x_out[:, :h], lw_out[:h], row_out, shard)
            x_out[:, h:], lw_out[h:] = x[:, h:], lw[h:]
            return x_out, lw_out, row_out

        monkeypatch.setattr(fused_pf, "_fused_step", step)
    elif fault == "an answer altered":
        calls = iter(range(10**9))

        def step(*a, **k):
            x, lw, row = orig_step(*a, **k)
            if next(calls) % 200 == 100:
                row[2] += 1.0
            return x, lw, row

        monkeypatch.setattr(fused_pf, "_fused_step", step)
    else:
        raise ValueError(fault)
