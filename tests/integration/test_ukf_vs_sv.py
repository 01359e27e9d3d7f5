"""UKF on the 1-D stochastic-volatility model.

Counterpart of the reference's
``tests/integration_tests/test_ukf_vs_simulator_sv.py:70-246``: basic run,
tracking RMSE, covariance stability, alpha sweep, reproducibility.

Deviation: the reference sweeps alpha down to 1e-4 in float64; in float32
the UT moments at alpha < ~0.05 are dominated by rounding (see the
``UnscentedKalmanFilter`` docstring), so the sweep here covers the
float32-usable range 0.05-1.0 — for this mildly-nonlinear model the UT is
effectively alpha-independent, matching the reference's conclusion.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from particle_filters_jax.models.unscented_kalman_filter import (
    UnscentedKalmanFilter,
    make_ukf_state,
)

ALPHA, SIGMA, BETA = 0.9, 0.2, 1.0
Q = np.array([[SIGMA**2]], np.float32)
R = np.array([[0.1]], np.float32)


def _g(x, u):
    return ALPHA * x


def _h(x):
    return BETA * jnp.exp(0.5 * x)


def _make_ukf(alpha=0.5, **kw):
    kw.setdefault("jitter", 1e-8)
    return UnscentedKalmanFilter(
        _g, _h, Q, R, alpha=alpha, beta=2.0, kappa=0.0, **kw
    )


@pytest.fixture(scope="module")
def ukf_run(sv_data):
    ukf = _make_ukf()
    st0 = make_ukf_state(np.zeros(1, np.float32), np.ones((1, 1), np.float32))
    final, means, covs = jax.jit(lambda s, z: ukf.run(s, z))(
        st0, sv_data.Y[:, None]
    )
    return final, np.asarray(means), np.asarray(covs)


@pytest.mark.integration
class TestUKFvsSV:
    def test_basic_run(self, ukf_run, sv_data):
        final, means, covs = ukf_run
        assert means.shape == (sv_data.Y.shape[0], 1)
        assert np.all(np.isfinite(means))
        assert np.all(np.isfinite(covs))

    def test_tracking_performance(self, ukf_run, sv_data):
        _, means, _ = ukf_run
        rmse = float(np.sqrt(np.mean((means[:, 0] - sv_data.X) ** 2)))
        assert rmse < 2.0, f"UKF RMSE too high: {rmse}"

    def test_covariance_stability(self, ukf_run):
        _, _, covs = ukf_run
        np.testing.assert_allclose(covs, np.swapaxes(covs, 1, 2), atol=1e-5)
        eigs = np.linalg.eigvalsh(covs)
        assert np.all(eigs > -1e-7)
        assert np.all(np.trace(covs, axis1=1, axis2=2) < 10.0)

    def test_different_alpha_values(self, sv_data):
        zs = sv_data.Y[:200, None]
        st0 = make_ukf_state(
            np.zeros(1, np.float32), np.ones((1, 1), np.float32)
        )
        for alpha in (0.05, 0.1, 0.5, 1.0):
            _, means, _ = _make_ukf(alpha=alpha).run(st0, zs)
            rmse = float(
                np.sqrt(np.mean((np.asarray(means)[:, 0] - sv_data.X[:200]) ** 2))
            )
            assert rmse < 5.0, f"alpha={alpha}: RMSE={rmse}"

    def test_reproducibility(self, sv_data):
        zs = sv_data.Y[:, None]
        st0 = make_ukf_state(
            np.zeros(1, np.float32), np.ones((1, 1), np.float32)
        )
        f1, _, _ = jax.jit(lambda s, z: _make_ukf().run(s, z))(st0, zs)
        f2, _, _ = jax.jit(lambda s, z: _make_ukf().run(s, z))(st0, zs)
        np.testing.assert_array_equal(np.asarray(f1.mean), np.asarray(f2.mean))
        np.testing.assert_array_equal(np.asarray(f1.cov), np.asarray(f2.cov))
