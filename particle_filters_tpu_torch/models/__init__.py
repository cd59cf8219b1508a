from particle_filters_tpu_torch.core.structs import PFState
from particle_filters_tpu_torch.models.dpf import (
    DPF_OT,
    DifferentiableParticleFilter,
    DifferentiableParticleFilterRNN,
)
from particle_filters_tpu_torch.models.edh_particle_filter import (
    EDHConfig,
    EDHFlowPF,
    FlowPFState,
)
from particle_filters_tpu_torch.models.extended_kalman_filter import (
    EKFState,
    ExtendedKalmanFilter,
    make_ekf_state,
    numerical_jacobian_g,
    numerical_jacobian_h,
)
from particle_filters_tpu_torch.models.kalman_filter import KFResults, kalman_filter_general
from particle_filters_tpu_torch.models.kernel_particle_filter import (
    KernelParticleFilter,
    KPFConfig,
    KPFState,
    Model,
    build_localization_matrix,
    gaspari_cohn,
)
from particle_filters_tpu_torch.models.ledh_particle_filter import LEDHConfig, LEDHFlowPF
from particle_filters_tpu_torch.models.particle_filter import ParticleFilter
from particle_filters_tpu_torch.models.stochastic_particle_filter import (
    LinearGaussianBayes,
    kappa2_and_derivative,
    run_generalized_spf,
    solve_beta_star_bisection,
)
from particle_filters_tpu_torch.models.trackers import (
    EKFTracker,
    GaussianTracker,
    TrackerState,
    UKFTracker,
)
from particle_filters_tpu_torch.models.unscented_kalman_filter import (
    UKFState,
    UnscentedKalmanFilter,
    make_ukf_state,
)

__all__ = [
    "DPF_OT",
    "DifferentiableParticleFilter",
    "DifferentiableParticleFilterRNN",
    "EDHConfig",
    "EDHFlowPF",
    "EKFState",
    "EKFTracker",
    "ExtendedKalmanFilter",
    "FlowPFState",
    "GaussianTracker",
    "KFResults",
    "KPFConfig",
    "KPFState",
    "KernelParticleFilter",
    "LEDHConfig",
    "LEDHFlowPF",
    "LinearGaussianBayes",
    "Model",
    "PFState",
    "ParticleFilter",
    "TrackerState",
    "UKFState",
    "UKFTracker",
    "UnscentedKalmanFilter",
    "build_localization_matrix",
    "gaspari_cohn",
    "kalman_filter_general",
    "kappa2_and_derivative",
    "make_ekf_state",
    "make_ukf_state",
    "numerical_jacobian_g",
    "numerical_jacobian_h",
    "run_generalized_spf",
    "solve_beta_star_bisection",
]
