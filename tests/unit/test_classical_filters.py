"""KF / EKF / UKF unit + golden tests.

Reproduces the reference's test archetypes for ``test_kf_*`` /
``test_ekf_*`` / ``test_ukf_*``: NEES ≈ nx, Joseph == standard form,
loglik finite, EKF/UKF == KF on linear systems, Jacobian checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models import (
    ExtendedKalmanFilter,
    UnscentedKalmanFilter,
    kalman_filter_general,
    make_ekf_state,
    make_ukf_state,
    numerical_jacobian_g,
    numerical_jacobian_h,
)


@pytest.fixture(scope="module")
def kf_run(request):
    return None


class TestKF:
    def test_shapes(self, small_system, lgssm_data):
        s = small_system
        res = kalman_filter_general(
            lgssm_data.Y, s["A"], s["C"], np.eye(2, dtype=np.float32),
            s["Q"], s["R"], x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        N = lgssm_data.Y.shape[0]
        assert res.x_filt.shape == (N, 2)
        assert res.P_filt.shape == (N, 2, 2)
        assert res.K.shape == (N, 2, 2)
        assert res.S.shape == (N, 2, 2)
        assert np.isfinite(float(res.loglik))

    def test_filter_beats_prior(self, small_system, lgssm_data):
        """Filtered RMSE < predicted RMSE (reference
        ``test_kf_vs_simulator_lgssm.py:24-42``)."""
        s = small_system
        res = kalman_filter_general(
            lgssm_data.Y, s["A"], s["C"], np.eye(2, dtype=np.float32),
            s["Q"], s["R"], x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        rmse_filt = float(jnp.sqrt(jnp.mean((res.x_filt - lgssm_data.X) ** 2)))
        rmse_pred = float(jnp.sqrt(jnp.mean((res.x_pred - lgssm_data.X) ** 2)))
        assert rmse_filt < rmse_pred

    def test_nees_consistency(self, small_system, lgssm_data):
        """Mean NEES ≈ nx = 2 (reference notebook: 2.189)."""
        s = small_system
        res = kalman_filter_general(
            lgssm_data.Y, s["A"], s["C"], np.eye(2, dtype=np.float32),
            s["Q"], s["R"], x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        diff = res.x_filt - lgssm_data.X
        nees = jax.vmap(lambda d, P: d @ jnp.linalg.solve(P, d))(diff, res.P_filt)
        assert 1.2 < float(jnp.mean(nees)) < 3.0

    def test_joseph_matches_standard(self, small_system, lgssm_data):
        s = small_system
        args = (
            lgssm_data.Y, s["A"], s["C"], np.eye(2, dtype=np.float32),
            s["Q"], s["R"],
        )
        kw = dict(x0=np.zeros(2, np.float32), P0=s["Sigma"])
        std = kalman_filter_general(*args, **kw)
        jos = kalman_filter_general(*args, use_joseph=True, **kw)
        np.testing.assert_allclose(
            np.asarray(std.x_filt), np.asarray(jos.x_filt), atol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(std.P_filt), np.asarray(jos.P_filt), atol=5e-3
        )

    def test_psd_covariances(self, small_system, lgssm_data):
        s = small_system
        res = kalman_filter_general(
            lgssm_data.Y, s["A"], s["C"], np.eye(2, dtype=np.float32),
            s["Q"], s["R"], x0=np.zeros(2, np.float32), P0=s["Sigma"],
            use_joseph=True,
        )
        ev = np.linalg.eigvalsh(np.asarray(res.P_filt, np.float64))
        assert ev.min() > -1e-6

    def test_time_varying_params(self, small_system, lgssm_data):
        """Stacked (N, ...) parameters equal broadcast time-invariant ones."""
        s = small_system
        N = lgssm_data.Y.shape[0]
        A_seq = np.tile(s["A"], (N, 1, 1))
        res_ti = kalman_filter_general(
            lgssm_data.Y, s["A"], s["C"], np.eye(2, dtype=np.float32),
            s["Q"], s["R"], x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        res_tv = kalman_filter_general(
            lgssm_data.Y, A_seq, s["C"], np.eye(2, dtype=np.float32),
            s["Q"], s["R"], x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        np.testing.assert_allclose(
            np.asarray(res_ti.x_filt), np.asarray(res_tv.x_filt), atol=1e-6
        )

    def test_control_inputs(self, small_system):
        """Known constant control shifts the filtered mean accordingly."""
        s = small_system
        N = 50
        Y = np.zeros((N, 2), np.float32)
        B = np.eye(2, dtype=np.float32)
        U = np.ones((N, 2), np.float32)
        res = kalman_filter_general(
            Y, s["A"], s["C"], np.eye(2, dtype=np.float32), s["Q"], s["R"],
            B=B, U=U, x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        assert np.all(np.isfinite(np.asarray(res.x_filt)))

    def test_bad_inputs_raise(self, small_system):
        s = small_system
        with pytest.raises(ValueError, match="2D"):
            kalman_filter_general(
                np.zeros(5, np.float32), s["A"], s["C"],
                np.eye(2, dtype=np.float32), s["Q"], s["R"],
                x0=np.zeros(2, np.float32), P0=s["Sigma"],
            )
        with pytest.raises(ValueError, match="leading length"):
            kalman_filter_general(
                np.zeros((5, 2), np.float32), np.tile(s["A"], (3, 1, 1)),
                s["C"], np.eye(2, dtype=np.float32), s["Q"], s["R"],
                x0=np.zeros(2, np.float32), P0=s["Sigma"],
            )


class TestEKF:
    def test_matches_kf_linear(self, small_system, lgssm_data):
        s = small_system
        kf = kalman_filter_general(
            lgssm_data.Y, s["A"], s["C"], np.eye(2, dtype=np.float32),
            s["Q"], s["R"], x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        A, C = jnp.asarray(s["A"]), jnp.asarray(s["C"])
        ekf = ExtendedKalmanFilter(
            lambda x, u: A @ x, lambda x: C @ x, s["Q"], s["R"]
        )
        _, means, covs = ekf.run(
            make_ekf_state(np.zeros(2, np.float32), s["Sigma"]), lgssm_data.Y
        )
        np.testing.assert_allclose(
            np.asarray(means), np.asarray(kf.x_filt), atol=5e-3
        )

    def test_ad_jacobian_matches_numerical(self, key):
        g = lambda x, u: jnp.array([jnp.sin(x[0]) * x[1], x[0] ** 2 - x[1]])
        x = jax.random.normal(key, (2,))
        J_ad = jax.jacfwd(g, argnums=0)(x, None)
        J_fd = numerical_jacobian_g(g, x, None)
        np.testing.assert_allclose(np.asarray(J_ad), np.asarray(J_fd), atol=1e-2)

    def test_numerical_jacobian_h(self, key):
        h = lambda x: jnp.array([x[0] * x[1], jnp.exp(0.1 * x[0])])
        x = jax.random.normal(key, (2,))
        J_fd = numerical_jacobian_h(h, x)
        J_ad = jax.jacfwd(h)(x)
        np.testing.assert_allclose(np.asarray(J_fd), np.asarray(J_ad), atol=1e-2)

    def test_predict_update_step(self, small_system):
        s = small_system
        A, C = jnp.asarray(s["A"]), jnp.asarray(s["C"])
        ekf = ExtendedKalmanFilter(
            lambda x, u: A @ x, lambda x: C @ x, s["Q"], s["R"], joseph=True
        )
        st = make_ekf_state(np.zeros(2, np.float32), s["Sigma"])
        pred = ekf.predict(st)
        assert int(pred.t) == 1
        post = ekf.update(pred, jnp.array([0.1, -0.2]))
        assert int(post.t) == 1
        # update reduces covariance
        assert float(jnp.trace(post.cov)) < float(jnp.trace(pred.cov))
        step = ekf.step(st, jnp.array([0.1, -0.2]))
        np.testing.assert_allclose(
            np.asarray(step.mean), np.asarray(post.mean), atol=1e-6
        )

    def test_nonlinear_tracking(self, key):
        """EKF on a mildly nonlinear model reduces error vs prior."""
        Q = 0.01 * jnp.eye(2)
        R = 0.1 * jnp.eye(2)
        g = lambda x, u: jnp.array(
            [0.9 * x[0] + 0.1 * jnp.sin(x[1]), 0.9 * x[1] + 0.1 * jnp.cos(x[0])]
        )
        h = lambda x: x
        ekf = ExtendedKalmanFilter(g, h, Q, R)
        # simulate
        T = 100
        ks = jax.random.split(key, T)
        xs, x = [], jnp.array([1.0, -1.0])
        for k in ks:
            k1, k2 = jax.random.split(k)
            x = g(x, None) + 0.1 * jax.random.normal(k1, (2,))
            xs.append(x)
        xs = jnp.stack(xs)
        zs = xs + jnp.sqrt(0.1) * jax.random.normal(key, xs.shape)
        _, means, _ = ekf.run(make_ekf_state(jnp.zeros(2), jnp.eye(2)), zs)
        rmse = float(jnp.sqrt(jnp.mean((means - xs) ** 2)))
        assert rmse < float(jnp.sqrt(jnp.mean(zs**2)))  # beats raw obs scale


class TestUKF:
    def test_weights_sum_to_one(self, small_system):
        s = small_system
        ukf = UnscentedKalmanFilter(
            lambda x, u: x, lambda x: x, s["Q"], s["R"], alpha=0.5
        )
        assert np.isclose(float(jnp.sum(ukf.Wm)), 1.0, atol=1e-5)

    def test_sigma_points_recover_moments(self, small_system, key):
        s = small_system
        ukf = UnscentedKalmanFilter(
            lambda x, u: x, lambda x: x, s["Q"], s["R"], alpha=0.5
        )
        mean = jnp.array([1.0, -2.0])
        cov = jnp.array([[0.5, 0.1], [0.1, 0.3]])
        X = ukf._sigma_points(mean, cov)
        assert X.shape == (5, 2)
        m = ukf._ut_mean(X)
        np.testing.assert_allclose(np.asarray(m), np.asarray(mean), atol=1e-4)
        DX = X - m
        P = jnp.einsum("i,ij,ik->jk", ukf.Wc, DX, DX)
        np.testing.assert_allclose(np.asarray(P), np.asarray(cov), atol=1e-3)

    def test_matches_kf_linear(self, small_system, lgssm_data):
        s = small_system
        kf = kalman_filter_general(
            lgssm_data.Y, s["A"], s["C"], np.eye(2, dtype=np.float32),
            s["Q"], s["R"], x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        A, C = jnp.asarray(s["A"]), jnp.asarray(s["C"])
        ukf = UnscentedKalmanFilter(
            lambda x, u: A @ x, lambda x: C @ x, s["Q"], s["R"], alpha=1.0
        )
        _, means, _ = ukf.run(
            make_ukf_state(np.zeros(2, np.float32), s["Sigma"]), lgssm_data.Y
        )
        np.testing.assert_allclose(
            np.asarray(means), np.asarray(kf.x_filt), atol=2e-2
        )

    def test_posterior_cov_symmetric_psd(self, small_system):
        s = small_system
        ukf = UnscentedKalmanFilter(
            lambda x, u: x, lambda x: x, s["Q"], s["R"], alpha=0.5
        )
        st = make_ukf_state(jnp.zeros(2), jnp.eye(2))
        post = ukf.step(st, jnp.array([0.5, -0.5]))
        P = np.asarray(post.cov, np.float64)
        np.testing.assert_allclose(P, P.T, atol=1e-6)
        assert np.linalg.eigvalsh(P).min() > 0

    def test_step_increments_t(self, small_system):
        s = small_system
        ukf = UnscentedKalmanFilter(
            lambda x, u: x, lambda x: x, s["Q"], s["R"], alpha=0.5
        )
        st = make_ukf_state(jnp.zeros(2), jnp.eye(2))
        st2 = ukf.step(st, jnp.zeros(2))
        assert int(st2.t) == 1
