"""SPF sequential filtering on the LGSSM.

Reference ``tests/integration_tests/test_spf_sequential_filtering.py:71-98``:
re-instantiate ``LinearGaussianBayes`` per time step, propagate (m0, P0)
manually, and compare the SPF track against the exact Kalman filter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models import (
    LinearGaussianBayes,
    kalman_filter_general,
    run_generalized_spf,
)

pytestmark = pytest.mark.integration


class TestSPFSequential:
    @pytest.mark.slow
    def test_spf_tracks_kf(self, key, small_system, lgssm_data):
        s = small_system
        T = 15
        Y = lgssm_data.Y[:T]
        X = lgssm_data.X[:T]
        A = np.asarray(s["A"], np.float32)
        Q = np.asarray(s["Q"], np.float32)
        R = np.asarray(s["R"], np.float32)
        H = np.eye(2, dtype=np.float32)

        kf = kalman_filter_general(
            Y, A, H, np.eye(2, dtype=np.float32), Q, R,
            x0=np.zeros(2, np.float32), P0=np.eye(2, dtype=np.float32),
        )

        m, P = np.zeros(2, np.float32), np.eye(2, dtype=np.float32)
        spf_means = []
        for t in range(T):
            # Predict the prior for this step, then SPF the Bayes update.
            m_pred = A @ m
            P_pred = A @ P @ A.T + Q
            model = LinearGaussianBayes.create(
                m_pred, P_pred, H, R, np.asarray(Y[t])
            )
            Xp, x_hat, _ = run_generalized_spf(
                model, N=1500, n_steps=80, beta_mode="linear",
                key=jax.random.fold_in(key, t),
            )
            spf_means.append(np.asarray(x_hat))
            m = np.asarray(x_hat)
            P = np.cov(np.asarray(Xp).T).astype(np.float32)
        spf_means = np.stack(spf_means)

        kf_rmse = float(jnp.sqrt(jnp.mean((kf.x_filt - X) ** 2)))
        spf_rmse = float(np.sqrt(np.mean((spf_means - np.asarray(X)) ** 2)))
        assert spf_rmse < 1.6 * kf_rmse + 0.05
        # per-step agreement with the exact posterior mean
        per_step = np.linalg.norm(spf_means - np.asarray(kf.x_filt), axis=1)
        assert per_step.mean() < 0.25
