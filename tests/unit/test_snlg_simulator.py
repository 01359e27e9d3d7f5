"""SNLG simulator unit suite — counterpart of the reference's six SNLG files
(``tests/unit_tests/simulator/test_snlg_{cholesky,config_validation,
grid_coords,io,kernel,simulation}.py``, ~89 tests upstream).

Covers the jitter-ladder Cholesky, config validation, grid coordinates, the
SE-kernel covariance, npz/json persistence, and the vmapped dataset
simulation (``particle_filters_jax/simulators/sensor_network_lg.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.core.linalg import chol_with_jitter
from particle_filters_jax.simulators.sensor_network_lg import (
    SNLGConfig,
    SNLGDataset,
    make_grid_coords,
    se_kernel_cov,
    simulate_snlg_dataset,
)


# ---------------------------------------------------------------------------
# Cholesky with jitter (reference test_snlg_cholesky.py, 13 tests)
# ---------------------------------------------------------------------------


class TestCholWithJitter:
    def test_spd_matrix(self):
        a = jnp.array([[4.0, 1.0], [1.0, 3.0]])
        L = chol_with_jitter(a)
        np.testing.assert_allclose(L @ L.T, a, atol=1e-5)

    def test_diagonal_matrix(self):
        a = jnp.diag(jnp.array([4.0, 9.0, 16.0]))
        L = chol_with_jitter(a)
        np.testing.assert_allclose(L, jnp.diag(jnp.array([2.0, 3.0, 4.0])), atol=1e-6)

    def test_identity(self):
        L = chol_with_jitter(jnp.eye(5))
        np.testing.assert_allclose(L, np.eye(5), atol=1e-6)

    def test_larger_spd(self, key):
        m = jax.random.normal(key, (12, 12))
        a = m @ m.T + 12 * jnp.eye(12)
        L = chol_with_jitter(a)
        np.testing.assert_allclose(L @ L.T, a, rtol=1e-4, atol=1e-4)

    def test_nearly_singular(self):
        # rank-1 + tiny nugget: plain cholesky in f32 may fail; ladder must not.
        v = jnp.ones((8, 1))
        a = v @ v.T + 1e-8 * jnp.eye(8)
        L = chol_with_jitter(a)
        assert jnp.all(jnp.isfinite(L))

    def test_ill_conditioned(self):
        a = jnp.diag(jnp.array([1e8, 1.0, 1e-6], jnp.float32))
        L = chol_with_jitter(a)
        assert jnp.all(jnp.isfinite(L))
        np.testing.assert_allclose((L @ L.T)[0, 0], 1e8, rtol=1e-5)

    def test_lower_triangular(self, key):
        m = jax.random.normal(key, (6, 6))
        L = chol_with_jitter(m @ m.T + 6 * jnp.eye(6))
        np.testing.assert_allclose(L, jnp.tril(L), atol=0)

    def test_reconstruction_accuracy(self, key):
        m = jax.random.normal(jax.random.fold_in(key, 1), (10, 10))
        a = m @ m.T + 10 * jnp.eye(10)
        L = chol_with_jitter(a)
        rel = jnp.linalg.norm(L @ L.T - a) / jnp.linalg.norm(a)
        assert rel < 1e-5

    def test_determinism(self):
        a = se_kernel_cov(make_grid_coords(16), 3.0, 20.0, 0.01)
        L1 = chol_with_jitter(a)
        L2 = chol_with_jitter(a)
        np.testing.assert_array_equal(np.asarray(L1), np.asarray(L2))

    def test_zero_matrix_gets_jitter(self):
        # chol(0) is the zero matrix (PSD boundary); the ladder must return
        # a finite factor either way.
        L = chol_with_jitter(jnp.zeros((4, 4)))
        assert jnp.all(jnp.isfinite(L))

    def test_non_spd_returns_nan(self):
        # A matrix the whole jitter ladder cannot rescue (large negative
        # eigenvalue) reports failure as NaN rather than a wrong factor.
        a = jnp.diag(jnp.array([1.0, -5.0]))
        L = chol_with_jitter(a, max_tries=3)
        assert not bool(jnp.all(jnp.isfinite(L)))

    def test_jitter_parameter_added(self):
        # Explicit base jitter shifts the diagonal before any ladder step.
        a = jnp.eye(3)
        L = chol_with_jitter(a, jitter=1.0)
        np.testing.assert_allclose(jnp.diag(L), np.sqrt(2.0) * np.ones(3), rtol=1e-6)

    def test_snlg_kernel_factorizes(self):
        # The actual SNLG d=64 smooth kernel (beta=20) — the motivating case.
        cov = se_kernel_cov(make_grid_coords(64), 3.0, 20.0, 0.01)
        L = chol_with_jitter(cov.astype(jnp.float32))
        assert jnp.all(jnp.isfinite(L))
        np.testing.assert_allclose(L @ L.T, cov, atol=5e-3)

    def test_jittable(self):
        a = jnp.eye(4) * 2.0
        L = jax.jit(chol_with_jitter)(a)
        np.testing.assert_allclose(L, np.sqrt(2.0) * np.eye(4), rtol=1e-6)


# ---------------------------------------------------------------------------
# Config validation (reference test_snlg_config_validation.py, 17 tests)
# ---------------------------------------------------------------------------


class TestSNLGConfigValidation:
    def test_valid_default(self):
        cfg = SNLGConfig()
        assert cfg.d == 64 and cfg.alpha == 0.9 and cfg.sigmas == (2.0, 1.0, 0.5)

    def test_valid_custom(self):
        cfg = SNLGConfig(d=16, alpha=0.5, T=5, trials=3, sigmas=(1.0,), seed=7)
        assert cfg.d == 16 and cfg.trials == 3

    @pytest.mark.parametrize("d", [2, 3, 5, 10, 63, 65])
    def test_invalid_d_not_perfect_square(self, d):
        with pytest.raises(ValueError, match="perfect square"):
            SNLGConfig(d=d)

    @pytest.mark.parametrize("d", [1, 4, 9, 16, 25, 64, 144])
    def test_valid_d_perfect_squares(self, d):
        assert SNLGConfig(d=d).d == d

    @pytest.mark.parametrize("T", [0, -1, -10])
    def test_invalid_T(self, T):
        with pytest.raises(ValueError, match="positive"):
            SNLGConfig(T=T)

    @pytest.mark.parametrize("trials", [0, -5])
    def test_invalid_trials(self, trials):
        with pytest.raises(ValueError, match="positive"):
            SNLGConfig(trials=trials)

    @pytest.mark.parametrize("sigmas", [(0.0,), (-1.0,), (2.0, -0.5), (-1.0, -2.0)])
    def test_invalid_sigmas(self, sigmas):
        with pytest.raises(ValueError, match="positive"):
            SNLGConfig(sigmas=sigmas)

    def test_valid_single_sigma(self):
        assert SNLGConfig(sigmas=(0.5,)).sigmas == (0.5,)

    def test_invalid_alpha1_negative(self):
        with pytest.raises(ValueError, match="nonneg"):
            SNLGConfig(alpha1=-0.01)

    def test_valid_alpha1_zero(self):
        assert SNLGConfig(alpha1=0.0).alpha1 == 0.0

    @pytest.mark.parametrize("beta", [0.0, -20.0])
    def test_invalid_beta(self, beta):
        with pytest.raises(ValueError, match="beta"):
            SNLGConfig(beta=beta)

    def test_valid_beta_small(self):
        assert SNLGConfig(beta=1e-3).beta == 1e-3

    def test_frozen(self):
        cfg = SNLGConfig()
        with pytest.raises(Exception):
            cfg.d = 16


# ---------------------------------------------------------------------------
# Grid coordinates (reference test_snlg_grid_coords.py, 13 tests)
# ---------------------------------------------------------------------------


class TestGridCoords:
    @pytest.mark.parametrize("d,n", [(16, 4), (64, 8), (144, 12)])
    def test_shape(self, d, n):
        c = make_grid_coords(d)
        assert c.shape == (d, 2)
        assert int(c.max()) == n - 1

    def test_dtype_float(self):
        assert make_grid_coords(16).dtype == jnp.float32

    def test_values_2x2(self):
        c = np.asarray(make_grid_coords(4))
        np.testing.assert_array_equal(c, [[0, 0], [0, 1], [1, 0], [1, 1]])

    def test_values_3x3_row_major(self):
        c = np.asarray(make_grid_coords(9))
        # first row of the lattice first (x=0, y=0..2), i.e. ij indexing
        np.testing.assert_array_equal(c[:3], [[0, 0], [0, 1], [0, 2]])
        np.testing.assert_array_equal(c[3:6], [[1, 0], [1, 1], [1, 2]])

    def test_unique_points(self):
        c = np.asarray(make_grid_coords(64))
        assert len({tuple(p) for p in c.tolist()}) == 64

    def test_integer_valued(self):
        c = np.asarray(make_grid_coords(25))
        np.testing.assert_array_equal(c, np.round(c))

    def test_range(self):
        c = np.asarray(make_grid_coords(49))
        assert c.min() == 0 and c.max() == 6

    def test_d1(self):
        assert make_grid_coords(1).shape == (1, 2)

    def test_deterministic(self):
        np.testing.assert_array_equal(
            np.asarray(make_grid_coords(36)), np.asarray(make_grid_coords(36))
        )

    def test_corner_positions(self):
        c = np.asarray(make_grid_coords(16))
        corners = {(0.0, 0.0), (0.0, 3.0), (3.0, 0.0), (3.0, 3.0)}
        assert corners <= {tuple(p) for p in c.tolist()}


# ---------------------------------------------------------------------------
# SE kernel covariance (reference test_snlg_kernel.py, 14 tests)
# ---------------------------------------------------------------------------


class TestSEKernel:
    @pytest.fixture(scope="class")
    def coords(self):
        return make_grid_coords(16)

    def test_shape(self, coords):
        assert se_kernel_cov(coords, 3.0, 20.0, 0.01).shape == (16, 16)

    def test_shape_large(self):
        c = make_grid_coords(144)
        assert se_kernel_cov(c, 1.0, 8.0, 0.0).shape == (144, 144)

    def test_symmetric(self, coords):
        K = se_kernel_cov(coords, 3.0, 20.0, 0.01)
        np.testing.assert_allclose(K, K.T, atol=0)

    def test_positive_definite(self, coords):
        K = se_kernel_cov(coords, 3.0, 20.0, 0.01)
        evals = np.linalg.eigvalsh(np.asarray(K, np.float64))
        assert evals.min() > 0

    def test_diagonal_values(self, coords):
        K = se_kernel_cov(coords, 3.0, 20.0, 0.01)
        np.testing.assert_allclose(jnp.diag(K), 3.01 * np.ones(16), rtol=1e-6)

    def test_nugget_effect(self, coords):
        K0 = se_kernel_cov(coords, 3.0, 20.0, 0.0)
        K1 = se_kernel_cov(coords, 3.0, 20.0, 0.5)
        np.testing.assert_allclose(K1 - K0, 0.5 * np.eye(16), atol=1e-6)

    def test_decay_with_distance(self, coords):
        K = np.asarray(se_kernel_cov(coords, 3.0, 2.0, 0.0))
        c = np.asarray(coords)
        d01 = np.sum((c[0] - c[1]) ** 2)
        d03 = np.sum((c[0] - c[3]) ** 2)
        assert d01 < d03 and K[0, 1] > K[0, 3]

    def test_alpha0_scales_amplitude(self, coords):
        K1 = se_kernel_cov(coords, 1.0, 20.0, 0.0)
        K5 = se_kernel_cov(coords, 5.0, 20.0, 0.0)
        np.testing.assert_allclose(K5, 5.0 * K1, rtol=1e-5)

    def test_beta_lengthscale(self, coords):
        # larger beta → slower decay → larger off-diagonals
        Ks = se_kernel_cov(coords, 1.0, 1.0, 0.0)
        Kl = se_kernel_cov(coords, 1.0, 100.0, 0.0)
        assert float(Ks[0, 5]) < float(Kl[0, 5])

    def test_formula_verification(self, coords):
        a0, b, a1 = 2.0, 7.0, 0.3
        K = np.asarray(se_kernel_cov(coords, a0, b, a1))
        c = np.asarray(coords)
        i, j = 2, 11
        expected = a0 * np.exp(-np.sum((c[i] - c[j]) ** 2) / b)
        np.testing.assert_allclose(K[i, j], expected, rtol=1e-5)

    def test_large_beta_limit(self, coords):
        # beta→∞: all entries → alpha0
        K = np.asarray(se_kernel_cov(coords, 3.0, 1e8, 0.0))
        np.testing.assert_allclose(K, 3.0, rtol=1e-4)

    def test_small_beta_limit(self, coords):
        # beta→0: off-diagonals vanish, K → (alpha0+alpha1) I
        K = np.asarray(se_kernel_cov(coords, 3.0, 1e-6, 0.5))
        np.testing.assert_allclose(K, 3.5 * np.eye(16), atol=1e-6)


# ---------------------------------------------------------------------------
# npz / json persistence (reference test_snlg_io.py, 14 tests)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_snlg():
    cfg = SNLGConfig(d=16, T=4, trials=2, sigmas=(1.0, 0.5), seed=3)
    return simulate_snlg_dataset(cfg)


class TestSNLGIO:
    def test_save_creates_file(self, small_snlg, tmp_path):
        p = str(tmp_path / "ds.npz")
        small_snlg.save_npz(p)
        assert (tmp_path / "ds.npz").exists()

    def test_roundtrip_arrays(self, small_snlg, tmp_path):
        p = str(tmp_path / "ds.npz")
        small_snlg.save_npz(p)
        back = SNLGDataset.load_npz(p)
        np.testing.assert_allclose(back.X, small_snlg.X, rtol=1e-6)
        np.testing.assert_allclose(back.Z, small_snlg.Z, rtol=1e-6)
        np.testing.assert_allclose(back.Sigma, small_snlg.Sigma, rtol=1e-6)
        np.testing.assert_allclose(back.coords, small_snlg.coords, atol=0)

    def test_roundtrip_config(self, small_snlg, tmp_path):
        p = str(tmp_path / "ds.npz")
        small_snlg.save_npz(p)
        cfg = SNLGDataset.load_npz(p).config
        assert cfg.d == 16 and cfg.T == 4 and cfg.trials == 2
        assert cfg.sigmas == (1.0, 0.5) and cfg.seed == 3

    def test_npz_keys(self, small_snlg, tmp_path):
        p = str(tmp_path / "ds.npz")
        small_snlg.save_npz(p)
        with np.load(p) as f:
            # same key layout as the reference save_npz (:208-245)
            assert {"X", "Z", "coords", "Sigma", "sigmas", "alpha", "T",
                    "trials", "d", "seed"} <= set(f.files)

    def test_save_overwrite(self, small_snlg, tmp_path):
        p = str(tmp_path / "ds.npz")
        small_snlg.save_npz(p)
        small_snlg.save_npz(p)  # second save must not raise
        assert SNLGDataset.load_npz(p).X.shape == small_snlg.X.shape

    def test_json_creates_file(self, small_snlg, tmp_path):
        p = str(tmp_path / "cfg.json")
        small_snlg.dump_config_json(p)
        assert (tmp_path / "cfg.json").exists()

    def test_json_content(self, small_snlg, tmp_path):
        p = str(tmp_path / "cfg.json")
        small_snlg.dump_config_json(p)
        with open(p) as f:
            data = json.load(f)
        assert data["d"] == 16 and data["T"] == 4
        assert list(data["sigmas"]) == [1.0, 0.5]

    def test_json_roundtrip_to_config(self, small_snlg, tmp_path):
        p = str(tmp_path / "cfg.json")
        small_snlg.dump_config_json(p)
        with open(p) as f:
            data = json.load(f)
        cfg = SNLGConfig(**{**data, "sigmas": tuple(data["sigmas"])})
        assert cfg == small_snlg.config

    def test_npz_and_json_together(self, small_snlg, tmp_path):
        small_snlg.save_npz(str(tmp_path / "d.npz"))
        small_snlg.dump_config_json(str(tmp_path / "d.json"))
        assert (tmp_path / "d.npz").exists() and (tmp_path / "d.json").exists()


# ---------------------------------------------------------------------------
# Dataset simulation (reference test_snlg_simulation.py, 18 tests)
# ---------------------------------------------------------------------------


class TestSNLGSimulation:
    def test_output_shapes_default_small(self, small_snlg):
        S, R, T, d = 2, 2, 4, 16
        assert small_snlg.X.shape == (S, R, T + 1, d)
        assert small_snlg.Z.shape == (S, R, T, d)

    def test_output_shapes_custom(self):
        cfg = SNLGConfig(d=9, T=3, trials=5, sigmas=(2.0,), seed=1)
        ds = simulate_snlg_dataset(cfg)
        assert ds.X.shape == (1, 5, 4, 9) and ds.Z.shape == (1, 5, 3, 9)

    def test_dtypes(self, small_snlg):
        assert small_snlg.X.dtype == jnp.float32
        assert small_snlg.Z.dtype == jnp.float32

    def test_initial_state_zero(self, small_snlg):
        np.testing.assert_array_equal(np.asarray(small_snlg.X[:, :, 0]), 0.0)

    def test_seed_reproducibility(self):
        cfg = SNLGConfig(d=16, T=4, trials=2, sigmas=(1.0,), seed=11)
        a = simulate_snlg_dataset(cfg)
        b = simulate_snlg_dataset(cfg)
        np.testing.assert_array_equal(np.asarray(a.X), np.asarray(b.X))
        np.testing.assert_array_equal(np.asarray(a.Z), np.asarray(b.Z))

    def test_different_seeds_differ(self):
        base = dict(d=16, T=4, trials=2, sigmas=(1.0,))
        a = simulate_snlg_dataset(SNLGConfig(seed=1, **base))
        b = simulate_snlg_dataset(SNLGConfig(seed=2, **base))
        assert not np.allclose(np.asarray(a.X), np.asarray(b.X))

    def test_trials_independent(self, small_snlg):
        x0 = np.asarray(small_snlg.X[0, 0])
        x1 = np.asarray(small_snlg.X[0, 1])
        assert not np.allclose(x0, x1)

    def test_sigma_matrix_properties(self, small_snlg):
        S = np.asarray(small_snlg.Sigma, np.float64)
        np.testing.assert_allclose(S, S.T, atol=0)
        assert np.linalg.eigvalsh(S).min() > 0

    def test_coords_deterministic(self, small_snlg):
        np.testing.assert_array_equal(
            np.asarray(small_snlg.coords), np.asarray(make_grid_coords(16))
        )

    def test_single_trial(self):
        ds = simulate_snlg_dataset(SNLGConfig(d=4, T=2, trials=1, sigmas=(1.0,)))
        assert ds.X.shape == (1, 1, 3, 4)

    @pytest.mark.slow
    def test_observation_noise_levels_ordering(self):
        # higher sigma_z ⇒ larger observation residual z - x
        cfg = SNLGConfig(d=16, T=20, trials=8, sigmas=(2.0, 0.25), seed=5)
        ds = simulate_snlg_dataset(cfg)
        resid = np.asarray(ds.Z) - np.asarray(ds.X[:, :, 1:])
        stds = resid.reshape(2, -1).std(axis=1)
        assert stds[0] > stds[1]
        np.testing.assert_allclose(stds, [2.0, 0.25], rtol=0.15)

    @pytest.mark.slow
    def test_dynamics_alpha_scaling(self):
        # with alpha=0 states are iid process noise; with alpha≈1 they are a
        # random walk whose late-time variance is larger.
        base = dict(d=16, T=30, trials=8, sigmas=(1.0,), seed=9)
        v0 = np.var(np.asarray(simulate_snlg_dataset(SNLGConfig(alpha=0.0, **base)).X[:, :, -1]))
        v1 = np.var(np.asarray(simulate_snlg_dataset(SNLGConfig(alpha=0.99, **base)).X[:, :, -1]))
        assert v1 > 2.0 * v0

    @pytest.mark.slow
    def test_process_noise_spatial_correlation(self):
        # beta=20 on a 4x4 grid: innovations at adjacent sites are strongly
        # positively correlated (kernel value 3·exp(-1/20) ≈ 2.85 of 3.01).
        cfg = SNLGConfig(d=16, T=50, trials=8, sigmas=(1.0,), alpha=0.0, seed=13)
        ds = simulate_snlg_dataset(cfg)
        # alpha=0 ⇒ X[t] = v_t exactly
        V = np.asarray(ds.X[0, :, 1:]).reshape(-1, 16)
        c = np.corrcoef(V[:, 0], V[:, 1])[0, 1]
        assert c > 0.8

    def test_time_evolution_nontrivial(self, small_snlg):
        X = np.asarray(small_snlg.X)
        assert not np.allclose(X[:, :, 1], X[:, :, 2])

    def test_no_nan_or_inf(self, small_snlg):
        assert np.isfinite(np.asarray(small_snlg.X)).all()
        assert np.isfinite(np.asarray(small_snlg.Z)).all()

    @pytest.mark.slow
    def test_stationary_variance_matches_theory(self):
        # x stationary covariance solves P = a²P + Σ ⇒ diag ≈ Σ_ii/(1-a²)
        cfg = SNLGConfig(d=16, T=200, trials=16, sigmas=(1.0,), alpha=0.5, seed=21)
        ds = simulate_snlg_dataset(cfg)
        X_late = np.asarray(ds.X[0, :, 100:]).reshape(-1, 16)
        expected = 3.01 / (1 - 0.25)
        np.testing.assert_allclose(X_late.var(axis=0).mean(), expected, rtol=0.15)

    def test_jit_compatible(self):
        cfg = SNLGConfig(d=4, T=2, trials=1, sigmas=(1.0,))
        ds = jax.jit(lambda: simulate_snlg_dataset(cfg).X)()
        assert ds.shape == (1, 1, 3, 4)
