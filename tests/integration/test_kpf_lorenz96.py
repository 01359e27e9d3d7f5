"""KPF on Lorenz-96 ensemble data assimilation.

Reference ``tests/integration_tests/test_kpf_vs_simulator_lorenz96.py:195-313``:
posterior beats the forecast, ensemble spread stays sane, pseudo-time
reaches 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models import KPFConfig, KernelParticleFilter, Model
from particle_filters_jax.simulators import l96_integrate, simulate_lorenz96
from particle_filters_jax.simulators.lorenz96 import compute_ensemble_spread, compute_rmse

pytestmark = pytest.mark.integration

NX = 40


@pytest.fixture(scope="module")
def l96():
    return simulate_lorenz96(
        nx=NX, spinup_steps=200, total_steps=100, Np=20,
        obs_interval=20, obs_fraction=2, obs_error_std=1.0, seed=5,
    )


class TestKPFAssimilation:
    def test_analysis_beats_forecast(self, l96):
        """One assimilation cycle: KPF analysis RMSE < forecast RMSE.

        Uses obs time index 3 (t=60), where chaotic growth has pushed the
        forecast error (≈1.1) above the observation noise (1.0); at earlier
        obs times the forecast is tighter than the observations and
        assimilation cannot — and should not — improve it."""
        r = l96
        idx = 3
        obs_t = int(r.obs_times[idx])
        truth = r.truth_traj[obs_t]
        forecast = r.ensemble_traj[:, obs_t, :]  # (Np, nx)
        y = r.observations[idx]

        H_idx = r.H_idx
        model = Model(
            H=lambda x: jnp.take(x, H_idx, axis=-1),
            JH=lambda x: jnp.zeros((H_idx.shape[0], NX)).at[
                jnp.arange(H_idx.shape[0]), H_idx
            ].set(1.0),
            R=jnp.asarray(r.R),
        )
        kpf = KernelParticleFilter(
            model,
            KPFConfig(ds_init=0.1, max_steps=60, localization_radius=4.0,
                      c_move_max=3.0),
        )
        st = kpf.analyze(forecast, y)
        rmse_f = float(compute_rmse(jnp.mean(forecast, axis=0), truth))
        rmse_a = float(compute_rmse(jnp.mean(st.particles, axis=0), truth))
        assert float(st.s) >= 1.0 - 1e-5
        assert rmse_a < rmse_f

    def test_spread_stays_sane(self, l96):
        r = l96
        obs_t = int(r.obs_times[1])
        forecast = r.ensemble_traj[:, obs_t, :]
        H_idx = r.H_idx
        model = Model(
            H=lambda x: jnp.take(x, H_idx, axis=-1),
            JH=lambda x: jnp.zeros((H_idx.shape[0], NX)).at[
                jnp.arange(H_idx.shape[0]), H_idx
            ].set(1.0),
            R=jnp.asarray(r.R),
        )
        kpf = KernelParticleFilter(model, KPFConfig(localization_radius=4.0))
        st = kpf.analyze(forecast, r.observations[1])
        spread_f = float(jnp.mean(compute_ensemble_spread(forecast)))
        spread_a = float(jnp.mean(compute_ensemble_spread(st.particles)))
        assert 0 < spread_a <= 1.5 * spread_f  # contracts (or stays) on update

    def test_multi_cycle_assimilation(self, l96):
        """Forecast-analyze cycles keep RMSE bounded below the no-DA run."""
        r = l96
        H_idx = r.H_idx
        model = Model(
            H=lambda x: jnp.take(x, H_idx, axis=-1),
            JH=lambda x: jnp.zeros((H_idx.shape[0], NX)).at[
                jnp.arange(H_idx.shape[0]), H_idx
            ].set(1.0),
            R=jnp.asarray(r.R),
        )
        kpf = KernelParticleFilter(
            model, KPFConfig(ds_init=0.1, max_steps=40, localization_radius=4.0)
        )
        dt, F = r.config["dt"], r.config["F"]
        interval = r.config["obs_interval"]

        ens = r.ensemble_traj[:, 0, :]
        rmses_da, rmses_free = [], []
        free = ens
        for i in range(1, 4):
            obs_t = int(r.obs_times[i])
            ens = jax.vmap(lambda e: l96_integrate(e, dt, interval, F=F)[-1])(ens)
            free = jax.vmap(lambda e: l96_integrate(e, dt, interval, F=F)[-1])(free)
            st = kpf.analyze(ens, r.observations[i])
            ens = st.particles
            truth = r.truth_traj[obs_t]
            rmses_da.append(float(compute_rmse(jnp.mean(ens, axis=0), truth)))
            rmses_free.append(float(compute_rmse(jnp.mean(free, axis=0), truth)))
        assert np.mean(rmses_da) < np.mean(rmses_free)
