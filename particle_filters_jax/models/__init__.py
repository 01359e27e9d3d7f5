"""Filters: KF / EKF / UKF, SIR PF, particle flows (EDH/LEDH/KPF/SPF), DPFs.

Capability parity with reference ``models/`` (SURVEY.md §2.1), rebuilt as
scan/vmap programs with explicit keys and pytree state.
"""

from particle_filters_jax.models.kalman_filter import KFResults, kalman_filter_general
from particle_filters_jax.models.extended_kalman_filter import (
    EKFState,
    ExtendedKalmanFilter,
    make_ekf_state,
    numerical_jacobian_g,
    numerical_jacobian_h,
)
from particle_filters_jax.models.unscented_kalman_filter import (
    UKFState,
    UnscentedKalmanFilter,
    make_ukf_state,
)
from particle_filters_jax.models.particle_filter import PFState, ParticleFilter
from particle_filters_jax.models.fused_sir import FusedSIRFilter
from particle_filters_jax.models.trackers import (
    EKFTracker,
    GaussianTracker,
    TrackerState,
    UKFTracker,
)
from particle_filters_jax.models.edh_particle_filter import (
    EDHConfig,
    EDHFlowPF,
    FlowPFState,
)
from particle_filters_jax.models.ledh_particle_filter import LEDHConfig, LEDHFlowPF
from particle_filters_jax.models.kernel_particle_filter import (
    KPFConfig,
    KPFState,
    KernelParticleFilter,
    Model,
    build_localization_matrix,
    gaspari_cohn,
)
from particle_filters_jax.models.stochastic_particle_filter import (
    LinearGaussianBayes,
    kappa2_and_derivative,
    run_generalized_spf,
    solve_beta_star_bisection,
)

from particle_filters_jax.models.dpf import (
    DPF_OT,
    DifferentiableParticleFilter,
    DifferentiableParticleFilterRNN,
    aggregate_diagnostics,
    compute_ess,
    compute_particle_diversity,
    compute_weight_entropy,
    rmse_sequence,
)

__all__ = [
    "DPF_OT",
    "DifferentiableParticleFilter",
    "DifferentiableParticleFilterRNN",
    "aggregate_diagnostics",
    "compute_ess",
    "compute_particle_diversity",
    "compute_weight_entropy",
    "rmse_sequence",
    "KPFConfig",
    "KPFState",
    "KernelParticleFilter",
    "FusedSIRFilter",
    "Model",
    "build_localization_matrix",
    "gaspari_cohn",
    "LinearGaussianBayes",
    "kappa2_and_derivative",
    "run_generalized_spf",
    "solve_beta_star_bisection",
    "GaussianTracker",
    "TrackerState",
    "EKFTracker",
    "UKFTracker",
    "EDHConfig",
    "EDHFlowPF",
    "FlowPFState",
    "LEDHConfig",
    "LEDHFlowPF",
    "KFResults",
    "kalman_filter_general",
    "EKFState",
    "ExtendedKalmanFilter",
    "make_ekf_state",
    "numerical_jacobian_g",
    "numerical_jacobian_h",
    "UKFState",
    "UnscentedKalmanFilter",
    "make_ukf_state",
    "PFState",
    "ParticleFilter",
]
