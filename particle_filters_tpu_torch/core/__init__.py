from particle_filters_tpu_torch.core.linalg import chol_with_jitter, symmetrize
from particle_filters_tpu_torch.core.structs import PFState
from particle_filters_tpu_torch.core.weights import (
    effective_sample_size,
    ess_from_logw,
    log_normalize,
    uniform_logw,
    weight_entropy,
    weighted_mean,
    weighted_mean_cov,
)

__all__ = [
    "PFState",
    "chol_with_jitter",
    "effective_sample_size",
    "ess_from_logw",
    "log_normalize",
    "symmetrize",
    "uniform_logw",
    "weight_entropy",
    "weighted_mean",
    "weighted_mean_cov",
]
