"""State-space-model simulators as pure ``lax.scan`` step functions.

Each simulator exposes:
- a config / params pytree dataclass,
- a result pytree dataclass with ``.save(path)`` / ``load(path)`` ``.npz``
  round-trips compatible with the reference's dataset layouts,
- a ``simulate_*`` entry point (seeded via ``jax.random`` keys or int seeds).

Capability parity with reference ``simulator/`` (see SURVEY.md §2.2).
"""

from particle_filters_jax.simulators.lgssm import (
    LGSSMParams,
    LGSSMSimulationResult,
    simulate_lgssm,
)
from particle_filters_jax.simulators.stochastic_volatility import (
    SV1DParams,
    SV1DResults,
    simulate_sv_1d,
)
from particle_filters_jax.simulators.lorenz96 import (
    Lorenz96Config,
    Lorenz96SimulationResult,
    simulate_lorenz96,
    l96_rhs,
    l96_integrate,
    ObsModel,
)
from particle_filters_jax.simulators.sensor_network_lg import (
    SNLGConfig,
    SNLGDataset,
    simulate_snlg_dataset,
    make_grid_coords,
    se_kernel_cov,
)
from particle_filters_jax.simulators.sensor_network_skewt import (
    SkewTGridConfig,
    SkewTDynConfig,
    SkewTMeasConfig,
    SkewTSimConfig,
    SkewTTrialResult,
    simulate_skewt_trial,
    simulate_skewt_many,
)
from particle_filters_jax.simulators.acoustic_tracking import (
    MATDynamicsConfig,
    MATScenarioConfig,
    MATDataset,
    simulate_acoustic_dataset,
    acoustic_measurement_model,
    make_sensor_grid,
    build_cv_transition,
    article_process_noise_cov,
    article_initial_states,
)

__all__ = [
    "LGSSMParams",
    "LGSSMSimulationResult",
    "simulate_lgssm",
    "SV1DParams",
    "SV1DResults",
    "simulate_sv_1d",
    "Lorenz96Config",
    "Lorenz96SimulationResult",
    "simulate_lorenz96",
    "l96_rhs",
    "l96_integrate",
    "ObsModel",
    "SNLGConfig",
    "SNLGDataset",
    "simulate_snlg_dataset",
    "make_grid_coords",
    "se_kernel_cov",
    "SkewTGridConfig",
    "SkewTDynConfig",
    "SkewTMeasConfig",
    "SkewTSimConfig",
    "SkewTTrialResult",
    "simulate_skewt_trial",
    "simulate_skewt_many",
    "MATDynamicsConfig",
    "MATScenarioConfig",
    "MATDataset",
    "simulate_acoustic_dataset",
    "acoustic_measurement_model",
    "make_sensor_grid",
    "build_cv_transition",
    "article_process_noise_cov",
    "article_initial_states",
]
