from particle_filters_tpu_torch.simulators.stochastic_volatility import (
    SV1DParams,
    SV1DResults,
    simulate_sv_1d,
    sv_obs_logpdf,
    sv_transition_logpdf,
    sv_transition_sample,
)

__all__ = [
    "SV1DParams",
    "SV1DResults",
    "simulate_sv_1d",
    "sv_obs_logpdf",
    "sv_transition_logpdf",
    "sv_transition_sample",
]
