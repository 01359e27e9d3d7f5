"""EKF on the 1-D stochastic-volatility model.

Counterpart of the reference's
``tests/integration_tests/test_ekf_vs_simulator_sv.py:80-369``: basic run,
tracking RMSE, covariance stability under the Joseph form, Joseph-vs-standard
agreement, numerical-vs-AD Jacobians, innovation consistency, initialization
robustness, and bitwise reproducibility. The time loop is one ``lax.scan``
(``ExtendedKalmanFilter.run``) instead of the reference's Python loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.extended_kalman_filter import (
    ExtendedKalmanFilter,
    make_ekf_state,
    numerical_jacobian_g,
    numerical_jacobian_h,
)

ALPHA, SIGMA, BETA = 0.9, 0.2, 1.0
Q = np.array([[SIGMA**2]], np.float32)
R = np.array([[0.1]], np.float32)  # assumed measurement noise (reference :47)


def _g(x, u):
    return ALPHA * x


def _h(x):
    return BETA * jnp.exp(0.5 * x)


def _make_ekf(**kw):
    kw.setdefault("joseph", True)
    kw.setdefault("jitter", 1e-8)
    return ExtendedKalmanFilter(_g, _h, Q, R, **kw)


@pytest.fixture(scope="module")
def ekf_run(sv_data):
    ekf = _make_ekf()
    st0 = make_ekf_state(np.zeros(1, np.float32), np.ones((1, 1), np.float32))
    final, means, covs = jax.jit(lambda s, z: ekf.run(s, z))(
        st0, sv_data.Y[:, None]
    )
    return final, np.asarray(means), np.asarray(covs)


@pytest.mark.integration
class TestEKFvsSV:
    def test_basic_run(self, ekf_run, sv_data):
        final, means, covs = ekf_run
        assert means.shape == (sv_data.Y.shape[0], 1)
        assert np.all(np.isfinite(means))
        assert np.all(np.isfinite(covs))
        assert int(final.t) == sv_data.Y.shape[0]

    def test_tracking_performance(self, ekf_run, sv_data):
        _, means, _ = ekf_run
        rmse = float(np.sqrt(np.mean((means[:, 0] - sv_data.X) ** 2)))
        assert rmse < 2.0, f"EKF RMSE too high: {rmse}"

    def test_covariance_stability(self, ekf_run):
        _, _, covs = ekf_run
        # Joseph form: symmetric, PSD, bounded trace at every step
        np.testing.assert_allclose(
            covs, np.swapaxes(covs, 1, 2), atol=1e-6
        )
        eigs = np.linalg.eigvalsh(covs)
        assert np.all(eigs > -1e-8)
        assert np.all(np.trace(covs, axis1=1, axis2=2) < 10.0)

    def test_joseph_vs_standard(self, sv_data):
        zs = sv_data.Y[:100, None]
        st0 = make_ekf_state(np.zeros(1, np.float32), np.ones((1, 1), np.float32))
        fj, mj, cj = _make_ekf(joseph=True).run(st0, zs)
        fs, ms, cs = _make_ekf(joseph=False).run(st0, zs)
        np.testing.assert_allclose(
            np.asarray(fj.mean), np.asarray(fs.mean), rtol=1e-4, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(fj.cov), np.asarray(fs.cov), rtol=1e-3, atol=1e-5
        )

    def test_numerical_vs_ad_jacobians(self, sv_data):
        """Finite-difference Jacobians (reference default) agree with the
        AD default within FD truncation error."""
        zs = sv_data.Y[:50, None]
        st0 = make_ekf_state(np.zeros(1, np.float32), np.ones((1, 1), np.float32))
        ekf_fd = _make_ekf(
            jac_g=lambda x, u: numerical_jacobian_g(_g, x, u),
            jac_h=lambda x: numerical_jacobian_h(_h, x),
        )
        ekf_ad = _make_ekf()
        f_fd, _, _ = ekf_fd.run(st0, zs)
        f_ad, _, _ = ekf_ad.run(st0, zs)
        np.testing.assert_allclose(
            np.asarray(f_fd.mean), np.asarray(f_ad.mean), rtol=1e-3, atol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(f_fd.cov), np.asarray(f_ad.cov), rtol=1e-2, atol=1e-3
        )

    def test_innovation_consistency(self, sv_data):
        """Mean innovation stays small (the SV model is nonlinear, so only a
        loose bound applies — reference :296-298)."""
        ekf = _make_ekf()

        def body(s, z):
            pred = ekf.predict(s)
            innov = z - _h(pred.mean)
            return ekf.update(pred, z), innov[0]

        st0 = make_ekf_state(np.zeros(1, np.float32), np.ones((1, 1), np.float32))
        _, innovations = jax.lax.scan(body, st0, sv_data.Y[:, None])
        assert abs(float(jnp.mean(innovations))) < 1.0

    def test_different_initializations_converge(self, sv_data):
        zs = sv_data.Y[:200, None]
        ekf = _make_ekf()
        finals = []
        for m0, p0 in ((0.0, 1.0), (1.0, 2.0), (-1.0, 0.5)):
            st0 = make_ekf_state(
                np.array([m0], np.float32), np.array([[p0]], np.float32)
            )
            f, _, _ = ekf.run(st0, zs)
            finals.append(np.asarray(f.mean))
        for a, b in zip(finals[:-1], finals[1:]):
            assert np.linalg.norm(a - b) < 1.0

    def test_reproducibility(self, sv_data):
        zs = sv_data.Y[:, None]
        st0 = make_ekf_state(np.zeros(1, np.float32), np.ones((1, 1), np.float32))
        f1, _, _ = jax.jit(lambda s, z: _make_ekf().run(s, z))(st0, zs)
        f2, _, _ = jax.jit(lambda s, z: _make_ekf().run(s, z))(st0, zs)
        np.testing.assert_array_equal(np.asarray(f1.mean), np.asarray(f2.mean))
        np.testing.assert_array_equal(np.asarray(f1.cov), np.asarray(f2.cov))
