from particle_filters_tpu_torch.resampling.hard import (
    multinomial_resample,
    resample_indices,
    residual_resample,
    stratified_resample,
    systematic_counts,
    systematic_resample,
    systematic_resample_values,
)

__all__ = [
    "multinomial_resample",
    "resample_indices",
    "residual_resample",
    "stratified_resample",
    "systematic_counts",
    "systematic_resample",
    "systematic_resample_values",
]
