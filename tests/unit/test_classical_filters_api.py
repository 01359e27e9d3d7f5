"""EKF/UKF/KF shapes-API and innovation/gain mechanism tests — counterpart
of the reference ``tests/unit_tests/models/test_ekf_shapes_and_api.py`` (15),
``test_ekf_innovation_and_gains.py`` (9), ``test_ukf_shapes_and_api.py`` (19),
``test_ukf_sigma_points_and_weights.py`` (13), ``test_kf_shapes.py`` /
``test_kf_controls_and_errors.py`` / ``test_kf_joseph_and_psd.py`` /
``test_kf_timevarying_equivalence.py``, beyond what
``tests/unit/test_classical_filters.py`` already covers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models import (
    ExtendedKalmanFilter,
    UnscentedKalmanFilter,
    kalman_filter_general,
)
from particle_filters_jax.models.extended_kalman_filter import (
    make_ekf_state,
    numerical_jacobian_g,
    numerical_jacobian_h,
)
from particle_filters_jax.models.unscented_kalman_filter import make_ukf_state


def _linear_ekf(small_system):
    s = small_system
    A, C = jnp.asarray(s["A"]), jnp.asarray(s["C"])
    return ExtendedKalmanFilter(lambda x, u: A @ x, lambda x: C @ x, s["Q"], s["R"])


def _linear_ukf(small_system, **kw):
    s = small_system
    A, C = jnp.asarray(s["A"]), jnp.asarray(s["C"])
    kw.setdefault("alpha", 0.5)
    return UnscentedKalmanFilter(lambda x, u: A @ x, lambda x: C @ x, s["Q"], s["R"], **kw)


class TestEKFShapesAPI:
    def test_state_fields(self):
        st = make_ekf_state(jnp.zeros(3), jnp.eye(3))
        assert st.mean.shape == (3,) and st.cov.shape == (3, 3)
        assert st.t.dtype == jnp.int32 and int(st.t) == 0

    def test_state_custom_t(self):
        assert int(make_ekf_state(jnp.zeros(2), jnp.eye(2), t=7).t) == 7

    def test_predict_shapes(self, small_system):
        ekf = _linear_ekf(small_system)
        pred = ekf.predict(make_ekf_state(jnp.zeros(2), jnp.eye(2)))
        assert pred.mean.shape == (2,) and pred.cov.shape == (2, 2)

    def test_predict_increments_t(self, small_system):
        ekf = _linear_ekf(small_system)
        assert int(ekf.predict(make_ekf_state(jnp.zeros(2), jnp.eye(2))).t) == 1

    def test_update_keeps_t(self, small_system):
        ekf = _linear_ekf(small_system)
        pred = ekf.predict(make_ekf_state(jnp.zeros(2), jnp.eye(2)))
        post = ekf.update(pred, jnp.array([0.5, -0.5]))
        assert int(post.t) == 1

    def test_step_equals_predict_update(self, small_system):
        ekf = _linear_ekf(small_system)
        st = make_ekf_state(jnp.array([0.1, -0.2]), jnp.eye(2))
        z = jnp.array([0.3, 0.0])
        a = ekf.step(st, z)
        b = ekf.update(ekf.predict(st), z)
        np.testing.assert_allclose(np.asarray(a.mean), np.asarray(b.mean), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(a.cov), np.asarray(b.cov), rtol=1e-6)

    def test_run_shapes(self, small_system, lgssm_data):
        ekf = _linear_ekf(small_system)
        zs = lgssm_data.Y[:20]
        final, means, covs = ekf.run(make_ekf_state(jnp.zeros(2), jnp.eye(2)), zs)
        assert means.shape == (20, 2) and covs.shape == (20, 2, 2)
        assert int(final.t) == 20

    def test_jittable(self, small_system):
        ekf = _linear_ekf(small_system)
        st = make_ekf_state(jnp.zeros(2), jnp.eye(2))
        out = jax.jit(ekf.step)(st, jnp.array([0.1, 0.2]))
        assert np.isfinite(np.asarray(out.mean)).all()

    def test_input_state_not_mutated(self, small_system):
        ekf = _linear_ekf(small_system)
        st = make_ekf_state(jnp.array([1.0, 2.0]), jnp.eye(2))
        before = np.asarray(st.mean).copy()
        ekf.step(st, jnp.array([0.0, 0.0]))
        np.testing.assert_array_equal(np.asarray(st.mean), before)


class TestEKFInnovationAndGains:
    def test_update_moves_mean_toward_observation(self, small_system):
        ekf = _linear_ekf(small_system)
        pred = make_ekf_state(jnp.zeros(2), jnp.eye(2), t=1)
        z = jnp.array([1.0, 1.0])
        post = ekf.update(pred, z)
        # posterior strictly between prior mean and z (C = I)
        m = np.asarray(post.mean)
        assert np.all(m > 0.0) and np.all(m < 1.0)

    def test_gain_formula_manual(self, small_system):
        # K = P C^T (C P C^T + R)^{-1}; identity C lets us verify by hand
        s = small_system
        ekf = _linear_ekf(small_system)
        P = jnp.array([[2.0, 0.0], [0.0, 0.5]])
        pred = make_ekf_state(jnp.zeros(2), P, t=1)
        z = jnp.array([1.0, 1.0])
        post = ekf.update(pred, z)
        K = np.asarray(P) @ np.linalg.inv(np.asarray(P) + np.asarray(s["R"]))
        np.testing.assert_allclose(np.asarray(post.mean), K @ np.asarray(z), atol=1e-4)

    def test_zero_innovation_keeps_mean(self, small_system):
        ekf = _linear_ekf(small_system)
        pred = make_ekf_state(jnp.array([0.7, -0.3]), jnp.eye(2), t=1)
        post = ekf.update(pred, ekf.h(pred.mean))
        np.testing.assert_allclose(np.asarray(post.mean), np.asarray(pred.mean), atol=1e-5)

    def test_small_R_trusts_observation(self, small_system):
        s = small_system
        A, C = jnp.asarray(s["A"]), jnp.asarray(s["C"])
        ekf = ExtendedKalmanFilter(
            lambda x, u: A @ x, lambda x: C @ x, s["Q"], 1e-8 * jnp.eye(2)
        )
        post = ekf.update(make_ekf_state(jnp.zeros(2), jnp.eye(2), t=1),
                          jnp.array([2.0, -1.0]))
        np.testing.assert_allclose(np.asarray(post.mean), [2.0, -1.0], atol=1e-3)

    def test_large_R_trusts_prior(self, small_system):
        s = small_system
        A, C = jnp.asarray(s["A"]), jnp.asarray(s["C"])
        ekf = ExtendedKalmanFilter(
            lambda x, u: A @ x, lambda x: C @ x, s["Q"], 1e8 * jnp.eye(2)
        )
        pred = make_ekf_state(jnp.array([0.4, 0.6]), jnp.eye(2), t=1)
        post = ekf.update(pred, jnp.array([100.0, -100.0]))
        np.testing.assert_allclose(np.asarray(post.mean), np.asarray(pred.mean), atol=1e-3)

    def test_update_reduces_covariance(self, small_system):
        ekf = _linear_ekf(small_system)
        pred = make_ekf_state(jnp.zeros(2), jnp.eye(2), t=1)
        post = ekf.update(pred, jnp.array([0.1, 0.1]))
        assert np.trace(np.asarray(post.cov)) < np.trace(np.asarray(pred.cov))

    @pytest.mark.parametrize("eps", [1e-2, 1e-3, 1e-4])
    def test_numerical_jacobian_g_eps(self, eps):
        g = lambda x, u: jnp.array([x[0] ** 2, jnp.sin(x[1])])
        x = jnp.array([1.5, 0.3])
        J = numerical_jacobian_g(g, x, None, eps=eps)
        expected = np.array([[3.0, 0.0], [0.0, np.cos(0.3)]])
        np.testing.assert_allclose(np.asarray(J), expected, atol=30 * eps)

    def test_numerical_jacobian_h_rectangular(self):
        h = lambda x: jnp.array([x[0] + x[1] + x[2]])
        J = numerical_jacobian_h(h, jnp.zeros(3))
        assert J.shape == (1, 3)
        np.testing.assert_allclose(np.asarray(J), 1.0, atol=1e-3)

    def test_fd_matches_ad_jacobian(self):
        g = lambda x, u: jnp.array([jnp.exp(0.5 * x[0]), x[0] * x[1]])
        x = jnp.array([0.4, -1.2])
        J_fd = numerical_jacobian_g(g, x, None)
        J_ad = jax.jacfwd(lambda xx: g(xx, None))(x)
        np.testing.assert_allclose(np.asarray(J_fd), np.asarray(J_ad), atol=5e-3)


class TestUKFSigmaPointsAndWeights:
    def test_sigma_point_count_and_shape(self, small_system):
        ukf = _linear_ukf(small_system)
        X = ukf._sigma_points(jnp.zeros(2), jnp.eye(2))
        assert X.shape == (5, 2)  # 2nx+1

    def test_first_point_is_mean(self, small_system):
        ukf = _linear_ukf(small_system)
        m = jnp.array([1.0, -2.0])
        X = ukf._sigma_points(m, jnp.eye(2))
        np.testing.assert_allclose(np.asarray(X[0]), np.asarray(m))

    def test_symmetric_placement(self, small_system):
        ukf = _linear_ukf(small_system)
        m = jnp.array([0.5, 0.5])
        X = np.asarray(ukf._sigma_points(m, jnp.eye(2)))
        np.testing.assert_allclose(
            X[1:3] + X[3:5], np.tile(2 * np.asarray(m), (2, 1)), atol=1e-5
        )

    def test_lambda_gamma_formulas(self, small_system):
        ukf = _linear_ukf(small_system, alpha=0.3, kappa=1.0)
        lam = 0.3**2 * (2 + 1.0) - 2
        assert ukf._lambda == pytest.approx(lam)
        assert ukf._gamma == pytest.approx(np.sqrt(2 + lam))

    def test_wm_sums_to_one(self, small_system):
        ukf = _linear_ukf(small_system, alpha=0.8, beta=2.0, kappa=0.5)
        assert float(jnp.sum(ukf.Wm)) == pytest.approx(1.0, abs=1e-5)

    def test_wc0_beta_correction(self, small_system):
        ukf = _linear_ukf(small_system, alpha=0.5, beta=2.0)
        assert float(ukf.Wc[0] - ukf.Wm[0]) == pytest.approx(1 - 0.25 + 2.0, abs=1e-5)

    def test_tail_weights_equal(self, small_system):
        ukf = _linear_ukf(small_system)
        w = np.asarray(ukf.Wm[1:])
        np.testing.assert_allclose(w, w[0])
        np.testing.assert_allclose(np.asarray(ukf.Wc[1:]), w[0])

    def test_sigma_points_span_covariance(self, small_system):
        # UT of identity map recovers (mean, cov) exactly
        ukf = _linear_ukf(small_system)
        m = jnp.array([1.0, 2.0])
        P = jnp.array([[1.5, 0.4], [0.4, 0.8]])
        X = ukf._sigma_points(m, P)
        mu = ukf._ut_mean(X)
        D = X - mu
        P_rec = jnp.einsum("i,ij,ik->jk", ukf.Wc, D, D)
        np.testing.assert_allclose(np.asarray(mu), np.asarray(m), atol=1e-5)
        np.testing.assert_allclose(np.asarray(P_rec), np.asarray(P), atol=1e-4)

    def test_near_singular_cov_jitter_fallback(self, small_system):
        ukf = _linear_ukf(small_system)
        P = jnp.array([[1.0, 1.0], [1.0, 1.0]])  # rank-1
        X = ukf._sigma_points(jnp.zeros(2), P)
        assert np.isfinite(np.asarray(X)).all()


class TestUKFShapesAPI:
    def test_state_fields(self):
        st = make_ukf_state(jnp.zeros(4), jnp.eye(4), t=2)
        assert st.mean.shape == (4,) and st.cov.shape == (4, 4) and int(st.t) == 2

    def test_invalid_Q_shape_raises(self):
        with pytest.raises(ValueError, match="Q"):
            UnscentedKalmanFilter(
                lambda x, u: x, lambda x: x, jnp.zeros((2, 3)), jnp.eye(2)
            )

    def test_invalid_R_shape_raises(self):
        with pytest.raises(ValueError, match="R"):
            UnscentedKalmanFilter(
                lambda x, u: x, lambda x: x, jnp.eye(2), jnp.zeros((2, 3))
            )

    def test_predict_update_shapes(self, small_system):
        ukf = _linear_ukf(small_system)
        pred = ukf.predict(make_ukf_state(jnp.zeros(2), jnp.eye(2)))
        post = ukf.update(pred, jnp.array([0.1, -0.1]))
        assert post.mean.shape == (2,) and post.cov.shape == (2, 2)
        assert int(pred.t) == 1 and int(post.t) == 1

    def test_run_shapes(self, small_system, lgssm_data):
        ukf = _linear_ukf(small_system)
        final, means, covs = ukf.run(
            make_ukf_state(jnp.zeros(2), jnp.eye(2)), lgssm_data.Y[:15]
        )
        assert means.shape == (15, 2) and covs.shape == (15, 2, 2)

    def test_update_reduces_uncertainty(self, small_system):
        ukf = _linear_ukf(small_system)
        pred = ukf.predict(make_ukf_state(jnp.zeros(2), jnp.eye(2)))
        post = ukf.update(pred, jnp.array([0.0, 0.0]))
        assert np.trace(np.asarray(post.cov)) < np.trace(np.asarray(pred.cov))

    def test_jittable(self, small_system):
        ukf = _linear_ukf(small_system)
        out = jax.jit(ukf.step)(make_ukf_state(jnp.zeros(2), jnp.eye(2)),
                                jnp.array([0.2, 0.1]))
        assert np.isfinite(np.asarray(out.mean)).all()

    def test_nonlinear_ut_beats_linearization_at_strong_curvature(self, key):
        # classic UT sanity: for h(x) = ||x||² the UT mean captures the
        # +trace(P) term that a first-order EKF linearization drops entirely.
        Q = jnp.eye(2)
        R = jnp.eye(1)
        h = lambda x: jnp.array([x[0] ** 2 + x[1] ** 2])
        ukf = UnscentedKalmanFilter(lambda x, u: x, h, Q, R, alpha=1.0, kappa=1.0)
        P = jnp.eye(2)
        X = ukf._sigma_points(jnp.zeros(2), P)
        Z = jax.vmap(h)(X)
        z_ut = float(ukf._ut_mean(Z)[0])
        # E[||x||²] = trace(P) = 2; linearized prediction is h(mean) = 0
        assert abs(z_ut - 2.0) < 0.5


class TestKFEdges:
    def test_scalar_system(self):
        # 1-D KF end to end
        Y = jnp.array([[0.5], [0.7], [0.2]])
        res = kalman_filter_general(
            Y, jnp.array([[0.9]]), jnp.array([[1.0]]), jnp.array([[1.0]]),
            jnp.array([[0.1]]), jnp.array([[0.2]]),
            x0=jnp.zeros(1), P0=jnp.eye(1),
        )
        assert res.x_filt.shape == (3, 1)
        assert np.isfinite(float(res.loglik))

    def test_timevarying_equals_constant_when_stacked(self, small_system, lgssm_data):
        s = small_system
        Y = lgssm_data.Y[:30]
        N = Y.shape[0]
        const = kalman_filter_general(
            Y, s["A"], s["C"], np.eye(2, dtype=np.float32), s["Q"], s["R"],
            x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        tv = kalman_filter_general(
            Y,
            np.broadcast_to(s["A"], (N, 2, 2)),
            np.broadcast_to(s["C"], (N, 2, 2)),
            np.broadcast_to(np.eye(2, dtype=np.float32), (N, 2, 2)),
            np.broadcast_to(s["Q"], (N, 2, 2)),
            np.broadcast_to(s["R"], (N, 2, 2)),
            x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        np.testing.assert_allclose(
            np.asarray(tv.x_filt), np.asarray(const.x_filt), rtol=1e-5, atol=1e-6
        )
        assert float(tv.loglik) == pytest.approx(float(const.loglik), rel=1e-5)

    def test_single_step_sequence(self, small_system):
        s = small_system
        res = kalman_filter_general(
            jnp.array([[0.1, 0.2]]), s["A"], s["C"], np.eye(2, dtype=np.float32),
            s["Q"], s["R"], x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        assert res.x_filt.shape == (1, 2)
