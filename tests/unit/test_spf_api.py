"""SPF shapes/API unit suite — counterpart of the reference
``tests/unit_tests/models/test_spf_shapes_and_api.py`` (24 tests) and
``test_spf_linear_gaussian_bayes.py`` (12 tests), beyond the golden/mechanism
tests in ``tests/unit/test_spf.py`` and ``test_spf_condition_number.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.stochastic_particle_filter import (
    LinearGaussianBayes,
    chol_solve_eye,
    run_generalized_spf,
    solve_beta_star_bisection,
)


@pytest.fixture(scope="module")
def lgb():
    return LinearGaussianBayes.create(
        m0=jnp.array([1.0, -1.0]),
        P0=jnp.array([[2.0, 0.3], [0.3, 1.0]]),
        H=jnp.array([[1.0, 0.0]]),
        R=jnp.array([[0.5]]),
        z=jnp.array([0.5]),
    )


class TestLinearGaussianBayes:
    def test_create_fields(self, lgb):
        assert lgb.n == 2 and lgb.d == 1
        np.testing.assert_allclose(np.asarray(lgb.m0), [1.0, -1.0])

    def test_precision_inverses(self, lgb):
        np.testing.assert_allclose(
            np.asarray(lgb.P0_inv @ lgb.P0), np.eye(2), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(lgb.R_inv @ lgb.R), np.eye(1), atol=1e-6
        )

    def test_hessians(self, lgb):
        np.testing.assert_allclose(
            np.asarray(lgb.Hess_log_p0), -np.asarray(lgb.P0_inv), atol=1e-6
        )
        Mh = np.asarray(lgb.H).T @ np.asarray(lgb.R_inv) @ np.asarray(lgb.H)
        np.testing.assert_allclose(np.asarray(lgb.Mh), Mh, atol=1e-6)
        np.testing.assert_allclose(np.asarray(lgb.Hess_log_h), -Mh, atol=1e-6)

    def test_m0_z_flattened(self):
        m = LinearGaussianBayes.create(
            m0=jnp.ones((2, 1)), P0=jnp.eye(2), H=jnp.eye(2),
            R=jnp.eye(2), z=jnp.zeros((2, 1)),
        )
        assert m.m0.shape == (2,) and m.z.shape == (2,)

    @pytest.mark.parametrize("bad", [
        dict(P0=jnp.eye(3)),
        dict(H=jnp.zeros((1, 3))),
        dict(R=jnp.eye(2)),
    ])
    def test_inconsistent_shapes_raise(self, bad):
        kw = dict(
            m0=jnp.zeros(2), P0=jnp.eye(2), H=jnp.ones((1, 2)),
            R=jnp.eye(1), z=jnp.zeros(1),
        )
        kw.update(bad)
        with pytest.raises(ValueError, match="Inconsistent"):
            LinearGaussianBayes.create(**kw)

    def test_grad_log_p0_matches_autodiff(self, lgb):
        x = jnp.array([0.3, 0.7])
        logp = lambda xx: -0.5 * (xx - lgb.m0) @ lgb.P0_inv @ (xx - lgb.m0)
        np.testing.assert_allclose(
            np.asarray(lgb.grad_log_p0(x)), np.asarray(jax.grad(logp)(x)), atol=1e-5
        )

    def test_grad_log_h_matches_autodiff(self, lgb):
        x = jnp.array([0.3, 0.7])
        logh = lambda xx: -0.5 * (lgb.z - lgb.H @ xx) @ lgb.R_inv @ (lgb.z - lgb.H @ xx)
        np.testing.assert_allclose(
            np.asarray(lgb.grad_log_h(x)), np.asarray(jax.grad(logh)(x)), atol=1e-5
        )

    def test_grads_batched_shapes(self, lgb, key):
        X = jax.random.normal(key, (11, 2))
        assert lgb.grad_log_p0(X).shape == (11, 2)
        assert lgb.grad_log_h(X).shape == (11, 2)

    def test_grad_zero_at_mean(self, lgb):
        np.testing.assert_allclose(
            np.asarray(lgb.grad_log_p0(lgb.m0)), 0.0, atol=1e-6
        )

    def test_kalman_posterior_manual(self, lgb):
        m, P = lgb.kalman_posterior()
        P0, H, R = (np.asarray(lgb.P0, np.float64), np.asarray(lgb.H, np.float64),
                    np.asarray(lgb.R, np.float64))
        S = H @ P0 @ H.T + R
        K = P0 @ H.T @ np.linalg.inv(S)
        m_exp = np.asarray(lgb.m0) + (K @ (np.asarray(lgb.z) - H @ np.asarray(lgb.m0)))
        P_exp = (np.eye(2) - K @ H) @ P0
        np.testing.assert_allclose(np.asarray(m), m_exp, atol=1e-5)
        np.testing.assert_allclose(np.asarray(P), P_exp, atol=1e-5)

    def test_posterior_interpolates_prior_and_obs(self, lgb):
        m, _ = lgb.kalman_posterior()
        # observed component pulled from prior mean 1.0 toward z=0.5
        assert 0.5 < float(m[0]) < 1.0

    def test_pytree_flattens(self, lgb):
        leaves = jax.tree_util.tree_leaves(lgb)
        assert all(isinstance(l, jax.Array) for l in leaves)

    def test_chol_solve_eye_identity(self):
        a = jnp.array([[4.0, 1.0], [1.0, 3.0]])
        np.testing.assert_allclose(np.asarray(chol_solve_eye(a) @ a), np.eye(2), atol=1e-5)


class TestRunGeneralizedSPFAPI:
    def test_output_shapes(self, lgb):
        X, m, info = run_generalized_spf(lgb, N=64, n_steps=20, beta_mode="linear")
        assert X.shape == (64, 2) and m.shape == (2,)
        assert set(info) == {"lam", "beta", "betadot"}
        assert info["beta"].shape == (21,)

    def test_linear_beta_grid(self, lgb):
        _, _, info = run_generalized_spf(lgb, N=16, n_steps=10, beta_mode="linear")
        np.testing.assert_allclose(
            np.asarray(info["beta"]), np.linspace(0, 1, 11), atol=1e-6
        )
        np.testing.assert_allclose(np.asarray(info["betadot"]), 1.0)

    def test_optimal_beta_endpoints(self, lgb):
        _, _, info = run_generalized_spf(
            lgb, N=16, n_steps=50, beta_mode="optimal", mu=1e-2
        )
        b = np.asarray(info["beta"])
        assert b[0] == 0.0 and b[-1] == 1.0
        assert (b >= 0.0).all() and (b <= 1.0).all()

    def test_invalid_beta_mode_raises(self, lgb):
        with pytest.raises(ValueError, match="beta_mode"):
            run_generalized_spf(lgb, N=8, n_steps=5, beta_mode="quadratic")

    def test_invalid_q_mode_raises(self, lgb):
        with pytest.raises(ValueError, match="Q_mode"):
            run_generalized_spf(lgb, N=8, n_steps=5, beta_mode="linear", Q_mode="bad")

    def test_seed_reproducible(self, lgb):
        a = run_generalized_spf(lgb, N=32, n_steps=10, beta_mode="linear", seed=4)[0]
        b = run_generalized_spf(lgb, N=32, n_steps=10, beta_mode="linear", seed=4)[0]
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_different_seeds_differ(self, lgb):
        a = run_generalized_spf(lgb, N=32, n_steps=10, beta_mode="linear", seed=1)[0]
        b = run_generalized_spf(lgb, N=32, n_steps=10, beta_mode="linear", seed=2)[0]
        assert not np.allclose(np.asarray(a), np.asarray(b))

    def test_explicit_key_overrides_seed(self, lgb, key):
        a = run_generalized_spf(lgb, N=16, n_steps=5, beta_mode="linear", key=key)[0]
        b = run_generalized_spf(lgb, N=16, n_steps=5, beta_mode="linear",
                                seed=999, key=key)[0]
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.parametrize("q_mode", ["scaled_identity", "inv_M"])
    def test_q_modes_run_finite(self, lgb, q_mode):
        X, m, _ = run_generalized_spf(
            lgb, N=64, n_steps=30, beta_mode="linear", Q_mode=q_mode
        )
        assert np.isfinite(np.asarray(X)).all()

    def test_converges_toward_posterior_mean(self, lgb):
        _, m, _ = run_generalized_spf(lgb, N=4000, n_steps=200, beta_mode="linear")
        m_exact, _ = lgb.kalman_posterior()
        np.testing.assert_allclose(np.asarray(m), np.asarray(m_exact), atol=0.15)

    def test_posterior_covariance_approximated(self, lgb):
        X, _, _ = run_generalized_spf(lgb, N=4000, n_steps=200, beta_mode="linear")
        _, P_exact = lgb.kalman_posterior()
        P_emp = np.cov(np.asarray(X).T)
        np.testing.assert_allclose(P_emp, np.asarray(P_exact), atol=0.3)

    def test_jittable(self, lgb):
        f = jax.jit(
            lambda k: run_generalized_spf(
                lgb, N=16, n_steps=5, beta_mode="linear", key=k
            )[1]
        )
        assert np.isfinite(np.asarray(f(jax.random.PRNGKey(0)))).all()

    def test_single_particle(self, lgb):
        X, m, _ = run_generalized_spf(lgb, N=1, n_steps=10, beta_mode="linear")
        assert X.shape == (1, 2) and np.isfinite(np.asarray(X)).all()


class TestBetaStarAPI:
    def test_output_shapes(self, lgb):
        lam, beta, betadot = solve_beta_star_bisection(
            lgb.M0, lgb.Mh, mu=1e-2, n_grid=101
        )
        assert lam.shape == beta.shape == betadot.shape == (101,)

    def test_lambda_grid_uniform(self, lgb):
        lam, _, _ = solve_beta_star_bisection(lgb.M0, lgb.Mh, mu=1e-2, n_grid=51)
        np.testing.assert_allclose(np.asarray(lam), np.linspace(0, 1, 51), atol=1e-6)

    def test_mu_sweep_all_valid(self, lgb):
        for mu in (0.0, 1e-3, 1e-1):
            _, beta, _ = solve_beta_star_bisection(
                lgb.M0, lgb.Mh, mu=mu, n_grid=51
            )
            b = np.asarray(beta)
            assert b[0] == 0.0 and b[-1] == 1.0 and np.isfinite(b).all()
