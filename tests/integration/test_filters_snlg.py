"""Filters on the linear-Gaussian sensor network (SNLG).

Reference ``tests/integration_tests/test_filters_snlg_simulator.py:123-267``:
KF is exact; UKF matches KF; flow filters land in the same MSE ballpark
(BASELINE.md: KF/UKF 0.4958, EDH-200 0.6510 at σ_z=2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.core.linalg import mvn_logpdf_chol
from particle_filters_jax.models import (
    EDHConfig,
    EDHFlowPF,
    ExtendedKalmanFilter,
    GaussianTracker,
    UnscentedKalmanFilter,
    kalman_filter_general,
    make_ukf_state,
)
from particle_filters_jax.simulators import SNLGConfig, simulate_snlg_dataset

pytestmark = pytest.mark.integration

D, T, SIGMA_Z, ALPHA = 16, 12, 1.0, 0.9


@pytest.fixture(scope="module")
def snlg():
    cfg = SNLGConfig(d=D, T=T, trials=2, sigmas=(SIGMA_Z,), seed=7)
    return simulate_snlg_dataset(cfg), cfg


def _kf_mse(snlg_ds, trial):
    ds, cfg = snlg_ds
    X = ds.X[0, trial]  # (T+1, d)
    Z = ds.Z[0, trial]  # (T, d)
    I = np.eye(D, dtype=np.float32)
    res = kalman_filter_general(
        Z, ALPHA * I, I, I, np.asarray(ds.Sigma, np.float32),
        SIGMA_Z**2 * I, x0=np.zeros(D, np.float32),
        P0=np.asarray(ds.Sigma, np.float32),
    )
    mse = float(jnp.mean((res.x_filt - X[1:]) ** 2))
    return res, mse


class TestKFOnSNLG:
    def test_kf_beats_observation_noise(self, snlg):
        _, mse = _kf_mse(snlg, 0)
        assert mse < SIGMA_Z**2  # filtering beats raw observations

    def test_kf_consistent_across_trials(self, snlg):
        _, m0 = _kf_mse(snlg, 0)
        _, m1 = _kf_mse(snlg, 1)
        assert abs(m0 - m1) < 0.8 * max(m0, m1) + 0.1


class TestUKFOnSNLG:
    def test_ukf_matches_kf(self, snlg):
        """Linear model ⇒ UKF ≡ KF (reference/BASELINE: identical MSE)."""
        ds, cfg = snlg
        X, Z = ds.X[0, 0], ds.Z[0, 0]
        res, kf_mse = _kf_mse(snlg, 0)
        Sigma = jnp.asarray(ds.Sigma)
        ukf = UnscentedKalmanFilter(
            lambda x, u: ALPHA * x, lambda x: x, Sigma,
            SIGMA_Z**2 * jnp.eye(D), alpha=1.0,
        )
        _, means, _ = ukf.run(make_ukf_state(jnp.zeros(D), Sigma), Z)
        mse = float(jnp.mean((means - X[1:]) ** 2))
        assert abs(mse - kf_mse) < 0.15 * kf_mse + 0.02


class TestEDHOnSNLG:
    def test_edh_in_kf_ballpark(self, key, snlg):
        ds, cfg = snlg
        X, Z = ds.X[0, 0], ds.Z[0, 0]
        _, kf_mse = _kf_mse(snlg, 0)

        Sigma = jnp.asarray(ds.Sigma)
        LQ = jnp.linalg.cholesky(Sigma + 1e-6 * jnp.eye(D))
        R = SIGMA_Z**2 * jnp.eye(D)
        LR = SIGMA_Z * jnp.eye(D)
        I = jnp.eye(D)

        g = lambda x, u, v: ALPHA * x + v
        h = lambda x: x
        jh = lambda x: I
        lt = lambda xn, xo: mvn_logpdf_chol(xn, ALPHA * xo, LQ)
        ll = lambda z, x: mvn_logpdf_chol(z, x, LR)
        ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T

        ekf = ExtendedKalmanFilter(lambda x, u: ALPHA * x, h, Sigma, R)
        tracker = GaussianTracker(ekf)
        edh = EDHFlowPF(
            tracker, g, h, jh, lt, ll, R,
            EDHConfig(n_particles=200, n_lambda_steps=8, flow_integrator="euler"),
        )
        st = edh.init_from_gaussian(key, jnp.zeros(D), Sigma)
        ts = tracker.init(jnp.zeros(D), Sigma)
        _, _, hist = jax.jit(
            lambda k, s, t: edh.run(k, s, t, Z, process_noise_sampler=ns)
        )(jax.random.fold_in(key, 1), st, ts)
        mse = float(jnp.mean((hist["mean"] - X[1:]) ** 2))
        # BASELINE: EDH-200 ≈ 1.3× KF MSE at this config; allow 2×+slack.
        assert mse < 2.0 * kf_mse + 0.1
        assert np.all(np.isfinite(np.asarray(hist["condition_numbers"])))


class TestLEDHOnSNLG:
    """LEDH on the sensor network — the reference's remaining SNLG pairing
    (``test_filters_snlg_simulator.py``; BASELINE LEDH-200 MSE 0.6512)."""

    def test_ledh_in_kf_ballpark(self, key, snlg):
        from particle_filters_jax.models import LEDHConfig, LEDHFlowPF

        ds, cfg = snlg
        I = jnp.eye(D)
        Sigma = jnp.asarray(ds.Sigma)
        R = SIGMA_Z**2 * I
        LQ = jnp.linalg.cholesky(Sigma + 1e-8 * I)
        LR = SIGMA_Z * I

        g = lambda x, u, v: ALPHA * x + v
        h = lambda x: x
        jac_h = lambda x: I
        lt = lambda xn, xo: mvn_logpdf_chol(xn, ALPHA * xo, LQ)
        ll = lambda z, x: mvn_logpdf_chol(z, x, LR)
        noise = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T

        ekf = ExtendedKalmanFilter(
            lambda x, u: ALPHA * x, h, Sigma, R
        )
        tracker = GaussianTracker(ekf)
        ledh = LEDHFlowPF(
            tracker, g, h, jac_h, lt, ll, R,
            LEDHConfig(n_particles=100, n_lambda_steps=8),
        )
        st = ledh.init_from_gaussian(key, jnp.zeros(D), Sigma)
        ts = tracker.init(jnp.zeros(D), Sigma)
        Z = ds.Z[0, 0]
        _, _, hist = jax.jit(
            lambda k, s, t: ledh.run(k, s, t, Z, process_noise_sampler=noise)
        )(jax.random.fold_in(key, 1), st, ts)
        mse = float(jnp.mean((hist["mean"] - ds.X[0, 0, 1:]) ** 2))
        _, kf_mse = _kf_mse(snlg, 0)
        # reference ratio LEDH/KF ≈ 1.31 at d=64; allow slack at d=16, T=12
        assert np.isfinite(mse)
        assert mse < 2.5 * kf_mse + 0.1


class TestCrossFilterOrdering:
    def test_exact_kf_is_best(self, key, snlg):
        """The exact KF must not lose to the approximate flow filters on
        its own linear-Gaussian model (reference table ordering)."""
        ds, cfg = snlg
        I = jnp.eye(D)
        Sigma = jnp.asarray(ds.Sigma)
        R = SIGMA_Z**2 * I
        LQ = jnp.linalg.cholesky(Sigma + 1e-8 * I)
        LR = SIGMA_Z * I
        g = lambda x, u, v: ALPHA * x + v
        h = lambda x: x
        lt = lambda xn, xo: mvn_logpdf_chol(xn, ALPHA * xo, LQ)
        ll = lambda z, x: mvn_logpdf_chol(z, x, LR)
        noise = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T

        tracker = GaussianTracker(
            ExtendedKalmanFilter(lambda x, u: ALPHA * x, h, Sigma, R)
        )
        edh = EDHFlowPF(
            tracker, g, h, lambda x: I, lt, ll, R,
            EDHConfig(n_particles=100, n_lambda_steps=8),
        )
        st = edh.init_from_gaussian(key, jnp.zeros(D), Sigma)
        ts = tracker.init(jnp.zeros(D), Sigma)
        Z = ds.Z[0, 1]
        _, _, hist = jax.jit(
            lambda k, s, t: edh.run(k, s, t, Z, process_noise_sampler=noise)
        )(jax.random.fold_in(key, 2), st, ts)
        edh_mse = float(jnp.mean((hist["mean"] - ds.X[0, 1, 1:]) ** 2))
        _, kf_mse = _kf_mse(snlg, 1)
        assert kf_mse <= edh_mse + 1e-3
