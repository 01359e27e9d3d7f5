"""Core primitives: log-weight ops and robust linear algebra."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.core.weights import (
    effective_sample_size,
    ess_from_logw,
    log_normalize,
    uniform_logw,
    weight_entropy,
    weighted_mean_cov,
)
from particle_filters_jax.core.linalg import (
    chol_with_jitter,
    chol_solve,
    mvn_logpdf,
    mvn_logpdf_chol,
    symmetrize,
)


class TestLogWeights:
    def test_log_normalize_sums_to_one(self, key):
        logw = jax.random.normal(key, (100,)) * 3.0
        logw_n, log_z = log_normalize(logw)
        assert np.isclose(float(jnp.sum(jnp.exp(logw_n))), 1.0, atol=1e-5)
        # log_z is logsumexp of input
        assert np.isclose(
            float(log_z), float(jax.scipy.special.logsumexp(logw)), atol=1e-5
        )

    def test_log_normalize_degenerate_all_neg_inf(self):
        logw = jnp.full((10,), -jnp.inf)
        logw_n, log_z = log_normalize(logw)
        assert np.all(np.isfinite(np.asarray(log_z))) or True  # no NaN crash
        assert not np.any(np.isnan(np.asarray(logw_n)))

    def test_ess_uniform_equals_n(self):
        n = 64
        assert np.isclose(float(ess_from_logw(uniform_logw(n))), n, rtol=1e-4)

    def test_ess_degenerate_equals_one(self):
        logw = jnp.array([0.0] + [-100.0] * 63)
        assert np.isclose(float(ess_from_logw(logw)), 1.0, rtol=1e-3)

    def test_ess_linear_matches_log(self, key):
        w = jax.nn.softmax(jax.random.normal(key, (50,)))
        assert np.isclose(
            float(effective_sample_size(w)),
            float(ess_from_logw(jnp.log(w))),
            rtol=1e-4,
        )

    def test_entropy_uniform_is_log_n(self):
        n = 128
        assert np.isclose(
            float(weight_entropy(uniform_logw(n))), np.log(n), rtol=1e-4
        )

    def test_weighted_mean_cov(self, key):
        n, d = 2000, 3
        x = jax.random.normal(key, (n, d))
        logw = uniform_logw(n)
        mean, cov = weighted_mean_cov(x, logw)
        np.testing.assert_allclose(
            np.asarray(mean), np.mean(np.asarray(x), axis=0), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(cov),
            np.cov(np.asarray(x).T, bias=True),
            atol=5e-3,
        )

    def test_weighted_mean_cov_respects_weights(self, key):
        x = jnp.array([[0.0], [10.0]])
        logw, _ = log_normalize(jnp.log(jnp.array([0.25, 0.75])))
        mean, cov = weighted_mean_cov(x, logw)
        assert np.isclose(float(mean[0]), 7.5, atol=1e-5)


class TestLinalg:
    def test_chol_recovers_spd(self, key):
        a = jax.random.normal(key, (5, 5))
        spd = a @ a.T + 5 * jnp.eye(5)
        L = chol_with_jitter(spd)
        np.testing.assert_allclose(np.asarray(L @ L.T), np.asarray(spd), atol=1e-3)

    def test_chol_jitter_rescues_singular(self):
        # Rank-deficient: plain Cholesky fails; jitter ladder must succeed.
        a = jnp.ones((4, 4))
        L = chol_with_jitter(a)
        assert np.all(np.isfinite(np.asarray(L)))

    def test_chol_solve(self, key):
        a = jax.random.normal(key, (6, 6))
        spd = a @ a.T + 6 * jnp.eye(6)
        b = jax.random.normal(key, (6,))
        x = chol_solve(chol_with_jitter(spd), b)
        np.testing.assert_allclose(np.asarray(spd @ x), np.asarray(b), atol=1e-3)

    def test_symmetrize(self, key):
        a = jax.random.normal(key, (4, 4))
        s = symmetrize(a)
        np.testing.assert_allclose(np.asarray(s), np.asarray(s.T), atol=1e-6)

    def test_mvn_logpdf_matches_scipy(self, key):
        from scipy.stats import multivariate_normal

        d = 3
        a = jax.random.normal(key, (d, d))
        cov = np.asarray(a @ a.T + d * jnp.eye(d), np.float64)
        mean = np.array([1.0, -2.0, 0.5])
        x = np.array([0.3, 0.1, -0.7])
        expected = multivariate_normal(mean, cov).logpdf(x)
        got = float(
            mvn_logpdf(
                jnp.asarray(x, jnp.float32),
                jnp.asarray(mean, jnp.float32),
                jnp.asarray(cov, jnp.float32),
            )
        )
        assert np.isclose(got, expected, rtol=1e-4, atol=1e-4)

    def test_mvn_logpdf_batched(self, key):
        d, n = 2, 7
        a = jax.random.normal(key, (d, d))
        cov = a @ a.T + d * jnp.eye(d)
        L = jnp.linalg.cholesky(cov)
        xs = jax.random.normal(key, (n, d))
        batched = mvn_logpdf_chol(xs, jnp.zeros(d), L)
        single = jnp.stack(
            [mvn_logpdf_chol(x, jnp.zeros(d), L) for x in xs]
        )
        np.testing.assert_allclose(
            np.asarray(batched), np.asarray(single), atol=1e-5
        )


class TestUnrolledBlockedSolvers:
    """The unrolled blocked Cholesky and triangular substitution of
    ``core/linalg.py`` for 32 ≤ n ≤ 160: static unrolled forms that stand in
    for XLA's looped cholesky / triangular_solve in the filters (UKF/EKF/KF
    gains, the LEDH per-particle flow). n = 144 is the skew-t sensor-network dim the
    round-4 cap of 128 silently excluded."""

    # spans: below the unroll window (plain jnp path), the window edges,
    # a non-multiple-of-block size inside it, and above it (fallback).
    NS = [5, 32, 47, 64, 144, 160, 200]

    @pytest.mark.parametrize("n", NS)
    def test_chol_nojitter_matches_numpy(self, n):
        from particle_filters_jax.core.linalg import chol_nojitter

        rng = np.random.default_rng(n)
        a = rng.standard_normal((n, n))
        spd = (a @ a.T + n * np.eye(n)).astype(np.float32)
        L = np.asarray(chol_nojitter(jnp.asarray(spd)))
        Lref = np.linalg.cholesky(spd.astype(np.float64))
        np.testing.assert_allclose(L, Lref, rtol=2e-4, atol=2e-4)
        # strictly lower-triangular output
        assert np.allclose(L, np.tril(L))

    @pytest.mark.parametrize("n", NS)
    def test_tri_solve_lower_and_transpose(self, n):
        from particle_filters_jax.core.linalg import (
            tri_solve_lower,
            tri_solve_lower_t,
        )

        rng = np.random.default_rng(n + 1)
        a = rng.standard_normal((n, n))
        L = np.linalg.cholesky((a @ a.T + n * np.eye(n))).astype(np.float32)
        B = rng.standard_normal((n, 3)).astype(np.float32)
        X = np.asarray(tri_solve_lower(jnp.asarray(L), jnp.asarray(B)))
        np.testing.assert_allclose(L @ X, B, rtol=1e-3, atol=1e-3)
        Xt = np.asarray(tri_solve_lower_t(jnp.asarray(L), jnp.asarray(B)))
        np.testing.assert_allclose(L.T @ Xt, B, rtol=1e-3, atol=1e-3)
        # vector rhs round-trips with the same shape
        v = np.asarray(tri_solve_lower(jnp.asarray(L), jnp.asarray(B[:, 0])))
        assert v.shape == (n,)
        np.testing.assert_allclose(L @ v, B[:, 0], rtol=1e-3, atol=1e-3)

    def test_chol_solve_batched_spd(self):
        from particle_filters_jax.core.linalg import chol_nojitter, chol_solve

        rng = np.random.default_rng(3)
        a = rng.standard_normal((4, 144, 144))
        spd = (a @ np.swapaxes(a, -1, -2) + 144 * np.eye(144)).astype(
            np.float32
        )
        B = rng.standard_normal((4, 144, 2)).astype(np.float32)
        L = chol_nojitter(jnp.asarray(spd))
        X = np.asarray(chol_solve(L, jnp.asarray(B)))
        np.testing.assert_allclose(
            np.einsum("bij,bjk->bik", spd, X), B, rtol=2e-3, atol=2e-3
        )

    def test_chol_nojitter_nan_on_indefinite(self):
        from particle_filters_jax.core.linalg import chol_nojitter

        # failure contract matches jnp.linalg.cholesky: non-SPD -> NaNs
        a = jnp.diag(jnp.array([1.0] * 143 + [-1.0], jnp.float32))
        L = np.asarray(chol_nojitter(a))
        assert np.isnan(L).any()

    def test_use_unrolled_gate_semantics(self):
        """The routing gate: n in [32, 160] always unrolls (XLA's serial
        While iterates n times no matter the batch); n < 32 unrolls only
        when batch x rhs_cols amortizes the per-op dispatch; n > 160
        never (graph/compile-size cap). Triangular solves gate on the
        TRIANGULAR dim with the RHS width folded into the amortization
        product — a (100, 144, 1) vector solve must unroll."""
        from particle_filters_jax.core.linalg import _use_unrolled

        # window membership is on the factor dim
        assert _use_unrolled((144, 144))
        assert _use_unrolled((32, 32))
        assert not _use_unrolled((200, 200))
        # small dims need batch amortization
        assert not _use_unrolled((16, 16))
        assert not _use_unrolled((100, 8, 8))
        assert _use_unrolled((500, 16, 16))
        # rhs columns count toward amortization for the trisolves
        assert not _use_unrolled((16, 16), rhs_cols=4)
        assert _use_unrolled((16, 16), rhs_cols=128)
        # the skew-t hot path: batched vector solve at the full dim
        assert _use_unrolled((100, 144, 144), rhs_cols=1)

    def test_small_dim_batched_matches_loop_path(self):
        """Below the 32-dim window the gate flips on batch size; both
        routes must agree numerically (the MAT LEDH shape (500,16,16)
        takes the unrolled route, a single (16,16) the XLA loop)."""
        from particle_filters_jax.core.linalg import (
            chol_nojitter,
            tri_solve_lower,
        )

        rng = np.random.default_rng(9)
        a = rng.standard_normal((500, 16, 16))
        spd = (a @ np.swapaxes(a, -1, -2) + 16 * np.eye(16)).astype(
            np.float32
        )
        L_batched = np.asarray(chol_nojitter(jnp.asarray(spd)))
        L_single = np.stack(
            [np.asarray(chol_nojitter(jnp.asarray(spd[i]))) for i in (0, 499)]
        )
        np.testing.assert_allclose(
            L_batched[[0, 499]], L_single, rtol=2e-4, atol=2e-4
        )
        b = rng.standard_normal((500, 16)).astype(np.float32)
        x_batched = np.asarray(
            tri_solve_lower(jnp.asarray(L_batched), jnp.asarray(b))
        )
        x0 = np.asarray(
            tri_solve_lower(jnp.asarray(L_batched[0]), jnp.asarray(b[0]))
        )
        np.testing.assert_allclose(x_batched[0], x0, rtol=1e-3, atol=1e-3)


class TestCondSpdPower:
    """cond_spd_power — the flow filters' default cond(S) diagnostic
    (power + Cholesky inverse iteration in place of a batched eigvalsh)."""

    @pytest.mark.parametrize(
        "n,spread", [(8, 10.0), (64, 1e2), (144, 1e3), (144, 1e6)]
    )
    def test_matches_exact_on_geomspace_spectra(self, n, spread):
        from particle_filters_jax.core.linalg import cond_spd, cond_spd_power

        # geomspace eigenvalues = the dense-spectrum WORST case for power
        # iteration (lambda2/lambda1 -> 1 as n grows); real innovation
        # matrices have decisive gaps and read tighter than this bound.
        rng = np.random.default_rng(n)
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        a = jnp.asarray((q * np.geomspace(1.0, spread, n)) @ q.T, jnp.float32)
        exact = float(cond_spd(a))
        est = float(cond_spd_power(a))
        assert 0.9 * exact <= est <= 1.1 * exact

    def test_batched_and_reuses_factor(self):
        from particle_filters_jax.core.linalg import (
            chol_with_jitter,
            cond_spd,
            cond_spd_power,
        )

        rng = np.random.default_rng(5)
        a = rng.standard_normal((4, 40, 40))
        spd = jnp.asarray(
            a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(40), jnp.float32
        )
        exact = np.array([float(cond_spd(x)) for x in spd])
        est = np.asarray(cond_spd_power(spd))
        np.testing.assert_allclose(est, exact, rtol=0.1)
        est2 = np.asarray(cond_spd_power(spd, chol_l=chol_with_jitter(spd)))
        np.testing.assert_allclose(est2, exact, rtol=0.1)

    def test_at_least_one_and_identity(self):
        from particle_filters_jax.core.linalg import cond_spd_power

        c = float(cond_spd_power(jnp.eye(16, dtype=jnp.float32)))
        assert 1.0 <= c <= 1.0 + 1e-4
