from particle_filters_tpu_torch.simulators.lgssm import (
    LGSSMParams,
    LGSSMSimulationResult,
    lgssm_noise_covs,
    simulate_lgssm,
)
from particle_filters_tpu_torch.simulators.sensor_network_lg import (
    SNLGConfig,
    SNLGDataset,
    make_grid_coords,
    se_kernel_cov,
    simulate_snlg_dataset,
)
from particle_filters_tpu_torch.simulators.stochastic_volatility import (
    SV1DParams,
    SV1DResults,
    simulate_sv_1d,
    sv_obs_logpdf,
    sv_transition_logpdf,
    sv_transition_sample,
)

__all__ = [
    "LGSSMParams",
    "LGSSMSimulationResult",
    "SNLGConfig",
    "SNLGDataset",
    "SV1DParams",
    "SV1DResults",
    "lgssm_noise_covs",
    "make_grid_coords",
    "se_kernel_cov",
    "simulate_lgssm",
    "simulate_snlg_dataset",
    "simulate_sv_1d",
    "sv_obs_logpdf",
    "sv_transition_logpdf",
    "sv_transition_sample",
]
