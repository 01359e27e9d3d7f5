"""EKF/UKF/EDH/LEDH on the skew-t sensor network with Poisson counts.

Reference ``tests/integration_tests/test_filters_skewt_simulator.py:85-277``:
filters use a Gaussian working model for the heavy-tailed latent dynamics
and a linearized / exact-Poisson measurement; assertions are finite/PSD/
tracking-sanity with loose bounds.
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
    LEDHConfig,
    LEDHFlowPF,
    UnscentedKalmanFilter,
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_jax.simulators import (
    SkewTDynConfig,
    SkewTGridConfig,
    SkewTMeasConfig,
    SkewTSimConfig,
    simulate_skewt_trial,
)

pytestmark = pytest.mark.integration

D = 9
M1, M2 = 1.0, 1.0 / 3.0
ALPHA = 0.9


@pytest.fixture(scope="module")
def skewt_data():
    r = simulate_skewt_trial(
        SkewTGridConfig(d=D, alpha0=1.0, beta=8.0),
        SkewTDynConfig(alpha=ALPHA, nu=8.0, seed=3),
        SkewTMeasConfig(m1=M1, m2=M2),
        SkewTSimConfig(T=15),
    )
    return r


def _models(skewt_data):
    Sigma = jnp.asarray(skewt_data.Sigma)
    h = lambda x: M1 * jnp.exp(M2 * jnp.clip(x, -10, 10))
    jac_h = jax.jacfwd(h)
    # Working measurement covariance: Poisson variance at the prior mean.
    R = jnp.diag(h(jnp.zeros(D)))
    return Sigma, h, jac_h, R


class TestEKFUKFOnSkewT:
    def test_ekf_runs_and_tracks(self, skewt_data):
        Sigma, h, jh, R = _models(skewt_data)
        ekf = ExtendedKalmanFilter(
            lambda x, u: ALPHA * x, h, Sigma, R, joseph=True, jitter=1e-4
        )
        zs = jnp.asarray(skewt_data.Z, jnp.float32)
        _, means, covs = ekf.run(make_ekf_state(jnp.zeros(D), Sigma), zs)
        assert np.all(np.isfinite(np.asarray(means)))
        X = np.asarray(skewt_data.X)
        # Correlation with the truth beats zero (tracking sanity).
        corr = np.corrcoef(np.asarray(means).ravel(), X.ravel())[0, 1]
        assert corr > 0.2

    def test_ukf_runs_finite_psd(self, skewt_data):
        Sigma, h, jh, R = _models(skewt_data)
        ukf = UnscentedKalmanFilter(
            lambda x, u: ALPHA * x, h, Sigma, R, alpha=0.5, jitter=1e-5
        )
        zs = jnp.asarray(skewt_data.Z, jnp.float32)
        _, means, covs = ukf.run(make_ukf_state(jnp.zeros(D), Sigma), zs)
        assert np.all(np.isfinite(np.asarray(means)))
        ev = np.linalg.eigvalsh(np.asarray(covs, np.float64))
        assert ev.min() > -1e-4


class TestFlowsOnSkewT:
    def _flow_ingredients(self, skewt_data):
        Sigma, h, jh, R = _models(skewt_data)
        LQ = jnp.linalg.cholesky(Sigma + 1e-5 * jnp.eye(D))

        def poisson_loglik(z, x):
            lam = M1 * jnp.exp(M2 * jnp.clip(x, -10, 10))
            return jnp.sum(z * jnp.log(lam + 1e-10) - lam - jax.scipy.special.gammaln(z + 1.0))

        lt = lambda xn, xo: mvn_logpdf_chol(xn, ALPHA * xo, LQ)
        g = lambda x, u, v: ALPHA * x + v
        ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T
        ekf = ExtendedKalmanFilter(
            lambda x, u: ALPHA * x, h, Sigma, R, jitter=1e-4
        )
        tracker = GaussianTracker(ekf)
        return Sigma, g, h, jh, lt, poisson_loglik, R, tracker, ns

    def test_edh_poisson_counts(self, key, skewt_data):
        Sigma, g, h, jh, lt, ll, R, tracker, ns = self._flow_ingredients(skewt_data)
        edh = EDHFlowPF(
            tracker, g, h, jh, lt, ll, R,
            EDHConfig(n_particles=128, flow_integrator="euler"),
        )
        st = edh.init_from_gaussian(key, jnp.zeros(D), Sigma)
        ts = tracker.init(jnp.zeros(D), Sigma)
        zs = jnp.asarray(skewt_data.Z, jnp.float32)
        _, _, hist = jax.jit(
            lambda k, s, t: edh.run(k, s, t, zs, process_noise_sampler=ns)
        )(jax.random.fold_in(key, 1), st, ts)
        means = np.asarray(hist["mean"])
        assert np.all(np.isfinite(means))
        corr = np.corrcoef(means.ravel(), np.asarray(skewt_data.X).ravel())[0, 1]
        assert corr > 0.2

    def test_ledh_poisson_counts(self, key, skewt_data):
        Sigma, g, h, jh, lt, ll, R, tracker, ns = self._flow_ingredients(skewt_data)
        ledh = LEDHFlowPF(
            tracker, g, h, jh, lt, ll, R, LEDHConfig(n_particles=64)
        )
        st = ledh.init_from_gaussian(key, jnp.zeros(D), Sigma)
        ts = tracker.init(jnp.zeros(D), Sigma)
        zs = jnp.asarray(skewt_data.Z[:8], jnp.float32)
        _, _, hist = jax.jit(
            lambda k, s, t: ledh.run(k, s, t, zs, process_noise_sampler=ns)
        )(jax.random.fold_in(key, 2), st, ts)
        means = np.asarray(hist["mean"])
        assert np.all(np.isfinite(means))
        # weights stayed normalized through the θ-corrections
        assert np.all(np.isfinite(np.asarray(hist["ess"])))
