from particle_filters_tpu_torch.resampling.exact import (
    EXACT_THRESHOLD,
    exact_child_run_ends,
    exact_child_run_ends_u,
    quantize_weights,
)
from particle_filters_tpu_torch.resampling.ot import ot_resample, sinkhorn_ot_resample
from particle_filters_tpu_torch.resampling.ot_blockwise import (
    ot_resample_blockwise,
    sinkhorn_ot_resample_blockwise,
)
from particle_filters_tpu_torch.resampling.rnn import RNNResampler, rnn_resample
from particle_filters_tpu_torch.resampling.soft import gumbel_softmax, sample_gumbel, soft_resample
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
    "RNNResampler",
    "exact_child_run_ends",
    "exact_child_run_ends_u",
    "gumbel_softmax",
    "multinomial_resample",
    "ot_resample",
    "ot_resample_blockwise",
    "quantize_weights",
    "resample_indices",
    "residual_resample",
    "rnn_resample",
    "sample_gumbel",
    "sinkhorn_ot_resample",
    "sinkhorn_ot_resample_blockwise",
    "soft_resample",
    "stratified_resample",
    "systematic_counts",
    "systematic_resample",
    "systematic_resample_values",
    "systematic_resample_values_batched",
]
