"""Skew-t sensor-network simulator: utility-function, simulation, and config
tests.

Reproduces the reference archetypes of
``tests/unit_tests/simulator/test_sn_skewt_utility_funcs.py`` (29 tests),
``test_sn_skewt_simulation.py`` (27) and ``test_sn_skewt_config.py`` (27)
against ``simulators/sensor_network_skewt.py`` — lattices, SE covariance,
inverse-gamma sampling, γ-vector preparation, trial statistics and
reproducibility, multi-trial stacking, config validation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.simulators.sensor_network_skewt import (
    SkewTDynConfig,
    SkewTGridConfig,
    SkewTMeasConfig,
    SkewTSimConfig,
    build_spatial_cov,
    make_lattice,
    prepare_gamma_vector,
    sample_inverse_gamma,
    simulate_skewt_many,
    simulate_skewt_trial,
)


class TestMakeLattice:
    @pytest.mark.parametrize("d", [4, 16, 64, 144])
    def test_shape(self, d):
        R = make_lattice(d)
        assert R.shape == (d, 2)

    def test_values_2x2(self):
        R = np.asarray(make_lattice(4))
        expected = {(0, 0), (1, 0), (0, 1), (1, 1)}
        assert {tuple(r) for r in R.astype(int)} == expected

    def test_range(self):
        R = np.asarray(make_lattice(16))
        assert R.min() == 0 and R.max() == 3

    def test_unique_points(self):
        R = np.asarray(make_lattice(25))
        assert len({tuple(r) for r in R}) == 25

    def test_not_perfect_square_raises(self):
        with pytest.raises(ValueError, match="perfect square"):
            make_lattice(10)

    def test_deterministic(self):
        np.testing.assert_array_equal(
            np.asarray(make_lattice(9)), np.asarray(make_lattice(9))
        )


class TestSpatialCov:
    def _cov(self, d=16, a0=1.0, a1=1e-3, beta=8.0):
        return build_spatial_cov(make_lattice(d), a0, a1, beta)

    def test_shape_symmetric(self):
        S = self._cov()
        assert S.shape == (16, 16)
        np.testing.assert_allclose(np.asarray(S), np.asarray(S).T, atol=1e-7)

    def test_positive_definite(self):
        ev = np.linalg.eigvalsh(np.asarray(self._cov(), np.float64))
        assert ev.min() > 0

    def test_diagonal_value(self):
        S = np.asarray(self._cov(a0=2.0, a1=0.5))
        np.testing.assert_allclose(np.diag(S), 2.5, rtol=1e-6)

    def test_decay_with_distance(self):
        S = np.asarray(self._cov())
        # (0,0)↔(1,0) closer than (0,0)↔(3,3)
        assert S[0, 1] > S[0, 15]

    def test_beta_effect(self):
        """Larger β ⇒ longer correlation length ⇒ larger off-diagonals."""
        S_small = np.asarray(self._cov(beta=2.0))
        S_large = np.asarray(self._cov(beta=32.0))
        assert S_large[0, 15] > S_small[0, 15]


class TestInverseGamma:
    def test_positive(self, key):
        W = sample_inverse_gamma(key, 4.0, 4.0, shape=(2000,))
        assert float(W.min()) > 0

    def test_mean(self, key):
        """E[InvGamma(a, b)] = b/(a−1); reference ``test_sample_inverse_gamma_mean``."""
        a, b = 5.0, 4.0
        W = sample_inverse_gamma(key, a, b, shape=(40000,))
        assert np.isclose(float(W.mean()), b / (a - 1.0), rtol=0.05)

    def test_variance(self, key):
        """Var = b²/((a−1)²(a−2))."""
        a, b = 6.0, 4.0
        W = sample_inverse_gamma(key, a, b, shape=(80000,))
        expected = b**2 / ((a - 1.0) ** 2 * (a - 2.0))
        assert np.isclose(float(W.var()), expected, rtol=0.15)

    def test_different_keys_differ(self, key):
        W1 = sample_inverse_gamma(key, 4.0, 4.0, shape=(10,))
        W2 = sample_inverse_gamma(jax.random.fold_in(key, 1), 4.0, 4.0, shape=(10,))
        assert not np.allclose(np.asarray(W1), np.asarray(W2))


class TestGammaVector:
    def test_provided_passthrough(self, key):
        g = jnp.arange(4.0)
        out = prepare_gamma_vector(key, 4, 0.1, g)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(g))

    def test_random_norm_is_scale(self, key):
        out = prepare_gamma_vector(key, 16, 0.3, None)
        assert np.isclose(float(jnp.linalg.norm(out)), 0.3, rtol=1e-4)

    def test_reproducible(self, key):
        a = prepare_gamma_vector(key, 8, 0.1, None)
        b = prepare_gamma_vector(key, 8, 0.1, None)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_wrong_shape_raises(self, key):
        with pytest.raises(ValueError, match="gamma_vec"):
            prepare_gamma_vector(key, 4, 0.1, jnp.zeros(3))

    def test_zero_scale(self, key):
        out = prepare_gamma_vector(key, 8, 0.0, None)
        np.testing.assert_allclose(np.asarray(out), 0.0, atol=1e-12)


def _simulate(d=9, T=8, seed=3, **dyn_kw):
    return simulate_skewt_trial(
        SkewTGridConfig(d=d),
        SkewTDynConfig(seed=seed, **dyn_kw),
        SkewTMeasConfig(),
        SkewTSimConfig(T=T),
    )


class TestTrialSimulation:
    def test_shapes_and_keys(self):
        r = _simulate()
        assert r.X.shape == (8, 9)
        assert r.Z.shape == (8, 9)
        assert r.Lambda.shape == (8, 9)
        assert r.Sigma.shape == (9, 9)
        assert set(r.as_dict()) >= {"X", "Z", "Sigma", "L", "R", "gamma", "Lambda"}

    def test_save_lambda_false(self):
        r = simulate_skewt_trial(
            SkewTGridConfig(d=4), SkewTDynConfig(seed=1), SkewTMeasConfig(),
            SkewTSimConfig(T=3, save_lambda=False),
        )
        assert r.Lambda is None
        assert "Lambda" not in r.as_dict()

    def test_seed_reproducibility(self):
        a, b = _simulate(seed=7), _simulate(seed=7)
        np.testing.assert_array_equal(np.asarray(a.X), np.asarray(b.X))
        np.testing.assert_array_equal(np.asarray(a.Z), np.asarray(b.Z))

    def test_different_seeds_differ(self):
        a, b = _simulate(seed=7), _simulate(seed=8)
        assert not np.allclose(np.asarray(a.X), np.asarray(b.X))

    def test_counts_nonnegative_lambda_positive(self):
        r = _simulate()
        assert np.all(np.asarray(r.Z) >= 0)
        assert np.all(np.asarray(r.Lambda) > 0)

    def test_no_nan_or_inf(self):
        r = _simulate(T=30)
        for arr in (r.X, r.Z, r.Lambda, r.Sigma, r.L):
            assert np.all(np.isfinite(np.asarray(arr)))

    def test_rate_clipping_bounds_lambda(self):
        """λ = m₁ e^{m₂ clip(x)} ≤ m₁ e^{10 m₂} even with heavy tails."""
        r = _simulate(T=40, nu=2.5)  # heavier tails
        m1, m2 = 1.0, 1.0 / 3.0
        assert float(jnp.max(r.Lambda)) <= m1 * np.exp(m2 * 10.0) + 1e-3

    def test_ar1_decay_toward_zero_when_no_noise(self):
        """With γ = 0 the latent mean reverts: |E x_t| stays bounded by the
        stationary scale (AR-1 behavior, reference
        ``test_simulate_trial_ar1_behavior``)."""
        r = _simulate(T=60, gamma_vec=np.zeros(9))
        X = np.asarray(r.X, np.float64)
        # lag-1 autocorrelation of each site is positive and < 1
        x0, x1 = X[:-1].ravel(), X[1:].ravel()
        rho = np.corrcoef(x0, x1)[0, 1]
        assert 0.3 < rho < 0.999

    def test_skewness_direction(self):
        """A positive γ vector skews the latent field positive
        (reference ``test_simulate_trial_skewness``)."""
        g = 0.5 * np.ones(9)
        r = simulate_skewt_trial(
            SkewTGridConfig(d=9), SkewTDynConfig(seed=5, gamma_vec=g),
            SkewTMeasConfig(), SkewTSimConfig(T=200),
        )
        X = np.asarray(r.X)
        assert X.mean() > 0.3  # drift W γ with E[W] = ν/(ν−2) > 1

    def test_heavy_tails_vs_gaussian(self):
        """ν = 3 produces more extreme steps than ν = 50 (reference
        ``test_simulate_trial_heavy_tails``)."""
        r_heavy = _simulate(T=150, nu=3.0, clip_x=None)
        r_light = _simulate(T=150, nu=50.0, clip_x=None)
        dx_h = np.abs(np.diff(np.asarray(r_heavy.X), axis=0))
        dx_l = np.abs(np.diff(np.asarray(r_light.X), axis=0))
        assert np.quantile(dx_h, 0.999) > np.quantile(dx_l, 0.999)

    def test_custom_gamma_vector_stored(self):
        g = np.linspace(-0.1, 0.1, 9)
        r = _simulate(gamma_vec=g)
        np.testing.assert_allclose(np.asarray(r.gamma), g, rtol=1e-6)

    def test_meta_stored(self):
        r = _simulate()
        assert r.meta["grid_cfg"]["d"] == 9
        assert r.meta["sim_cfg"]["T"] == 8


class TestManyTrials:
    def test_shapes(self):
        r = simulate_skewt_many(
            SkewTGridConfig(d=4), SkewTDynConfig(seed=2), SkewTMeasConfig(),
            SkewTSimConfig(T=5, n_trials=3),
        )
        assert r.X.shape == (3, 5, 4)
        assert r.Z.shape == (3, 5, 4)

    def test_single_trial(self):
        r = simulate_skewt_many(
            SkewTGridConfig(d=4), SkewTDynConfig(seed=2), SkewTMeasConfig(),
            SkewTSimConfig(T=5, n_trials=1),
        )
        assert r.X.shape == (1, 5, 4)

    def test_trials_differ(self):
        r = simulate_skewt_many(
            SkewTGridConfig(d=4), SkewTDynConfig(seed=2), SkewTMeasConfig(),
            SkewTSimConfig(T=5, n_trials=3),
        )
        X = np.asarray(r.X)
        assert not np.allclose(X[0], X[1])
        assert not np.allclose(X[1], X[2])

    def test_reproducible(self):
        kw = dict(
            grid_cfg=SkewTGridConfig(d=4),
            dyn_cfg=SkewTDynConfig(seed=9),
            meas_cfg=SkewTMeasConfig(),
            sim_cfg=SkewTSimConfig(T=4, n_trials=2),
        )
        a = simulate_skewt_many(**kw)
        b = simulate_skewt_many(**kw)
        np.testing.assert_array_equal(np.asarray(a.Z), np.asarray(b.Z))

    def test_geometry_shared(self):
        r = simulate_skewt_many(
            SkewTGridConfig(d=9), SkewTDynConfig(seed=2), SkewTMeasConfig(),
            SkewTSimConfig(T=3, n_trials=2),
        )
        assert r.Sigma.shape == (9, 9)  # one Σ, not per-trial
        assert np.all(np.isfinite(np.asarray(r.X)))


class TestConfigs:
    def test_defaults(self):
        g, d, m, s = (SkewTGridConfig(), SkewTDynConfig(), SkewTMeasConfig(),
                      SkewTSimConfig())
        assert (g.d, g.alpha0, g.beta) == (144, 1.0, 8.0)
        assert (d.alpha, d.nu, d.gamma_scale) == (0.9, 8.0, 0.1)
        assert (m.m1, m.m2) == (1.0, 1.0 / 3.0)
        assert (s.T, s.n_trials, s.save_lambda) == (10, 1, True)

    def test_immutability(self):
        g = SkewTGridConfig()
        with pytest.raises(dataclasses.FrozenInstanceError):
            g.d = 99

    def test_custom_values_roundtrip(self):
        d = SkewTDynConfig(alpha=0.5, nu=4.0, clip_x=None, seed=None)
        dd = dataclasses.asdict(d)
        assert dd["alpha"] == 0.5 and dd["clip_x"] is None

    def test_no_clip_runs(self):
        r = _simulate(T=5, clip_x=None)
        assert np.all(np.isfinite(np.asarray(r.X)))

    def test_no_seed_defaults(self):
        r = simulate_skewt_trial(
            SkewTGridConfig(d=4), SkewTDynConfig(seed=None), SkewTMeasConfig(),
            SkewTSimConfig(T=2),
        )
        assert r.X.shape == (2, 4)
