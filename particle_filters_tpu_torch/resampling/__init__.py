from particle_filters_tpu_torch.resampling.exact import (
    EXACT_THRESHOLD,
    exact_child_run_ends,
    exact_child_run_ends_u,
    quantize_weights,
)
from particle_filters_tpu_torch.resampling.hard import (
    multinomial_resample,
    resample_indices,
    residual_resample,
    stratified_resample,
    systematic_counts,
    systematic_resample,
    systematic_resample_values,
    systematic_resample_values_batched,
)

__all__ = [
    "EXACT_THRESHOLD",
    "exact_child_run_ends",
    "exact_child_run_ends_u",
    "multinomial_resample",
    "quantize_weights",
    "resample_indices",
    "residual_resample",
    "stratified_resample",
    "systematic_counts",
    "systematic_resample",
    "systematic_resample_values",
    "systematic_resample_values_batched",
]
