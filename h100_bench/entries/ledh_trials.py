"""Entry kind ``ledh_trials``: ``flow_trials``'s unit (one batch of trials
through the program's ``LEDHFlowPF``, one ``run_trials`` call a step), with
``LEDHFlowPF.factored_matrices`` among the counters: the d×d matrices the
λ-steps' single-shot Cholesky factored in the traced units. A program
without that counter runs the cell all the same, and its counters leave
it out. ``TOY``, ``FAULTS`` and ``plant`` are ``flow_trials``'s."""

from __future__ import annotations

from h100_bench import harness

_flow = harness.load_module("entries", "flow_trials")
TOY, FAULTS, plant = _flow.TOY, _flow.FAULTS, _flow.plant


def _ledh():
    from particle_filters_tpu_torch.models import LEDHFlowPF

    return LEDHFlowPF


class Entry(_flow.Entry):
    def reset_counts(self) -> None:
        super().reset_counts()
        ledh = _ledh()
        if getattr(ledh, "factored_matrices", None) is not None:
            ledh.factored_matrices = 0

    def counts(self, units: int) -> dict:
        out = super().counts(units)
        factored = getattr(_ledh(), "factored_matrices", None)
        if factored is not None:
            out["factored_matrices"] = factored
        return out
