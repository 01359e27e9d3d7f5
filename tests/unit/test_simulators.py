"""Simulator tests: shapes, seeds, statistics, validation, persistence.

Reproduces the reference's simulator test archetypes (SURVEY.md §4):
shape/API/validation, statistical moments vs theory, chaotic dynamics,
Poisson/heavy-tail behavior, seed-reproducibility, npz round-trips.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.simulators import (
    Lorenz96SimulationResult,
    MATDynamicsConfig,
    MATScenarioConfig,
    SNLGConfig,
    SkewTDynConfig,
    SkewTGridConfig,
    SkewTMeasConfig,
    SkewTSimConfig,
    acoustic_measurement_model,
    article_initial_states,
    article_process_noise_cov,
    build_cv_transition,
    l96_integrate,
    l96_rhs,
    make_grid_coords,
    make_sensor_grid,
    se_kernel_cov,
    simulate_acoustic_dataset,
    simulate_lgssm,
    simulate_lorenz96,
    simulate_skewt_many,
    simulate_skewt_trial,
    simulate_snlg_dataset,
    simulate_sv_1d,
)


class TestLGSSM:
    def test_shapes(self, small_system):
        s = small_system
        r = simulate_lgssm(s["A"], s["B"], s["C"], s["D"], s["Sigma"], 50, seed=1)
        assert r.X.shape == (50, 2) and r.Y.shape == (50, 2)

    def test_seed_reproducible(self, small_system):
        s = small_system
        r1 = simulate_lgssm(s["A"], s["B"], s["C"], s["D"], s["Sigma"], 20, seed=7)
        r2 = simulate_lgssm(s["A"], s["B"], s["C"], s["D"], s["Sigma"], 20, seed=7)
        np.testing.assert_array_equal(np.asarray(r1.X), np.asarray(r2.X))

    def test_different_seeds_differ(self, small_system):
        s = small_system
        r1 = simulate_lgssm(s["A"], s["B"], s["C"], s["D"], s["Sigma"], 20, seed=1)
        r2 = simulate_lgssm(s["A"], s["B"], s["C"], s["D"], s["Sigma"], 20, seed=2)
        assert not np.allclose(np.asarray(r1.X), np.asarray(r2.X))

    def test_stationary_covariance(self, small_system):
        """Empirical cov → solution of the Lyapunov equation (burn-in
        stats, reference ``test_lgssm_burnin_and_stats.py``)."""
        s = small_system
        r = simulate_lgssm(
            s["A"], s["B"], s["C"], s["D"], s["Sigma"], 20000, seed=3, burn_in=500
        )
        # Stationary P solves P = A P Aᵀ + Q.
        A, Q = np.asarray(s["A"], np.float64), np.asarray(s["Q"], np.float64)
        P = np.eye(2)
        for _ in range(500):
            P = A @ P @ A.T + Q
        emp = np.cov(np.asarray(r.X).T)
        np.testing.assert_allclose(emp, P, rtol=0.15, atol=0.02)

    def test_validation(self, small_system):
        s = small_system
        with pytest.raises(ValueError):
            simulate_lgssm(s["A"], s["B"], s["C"], s["D"], s["Sigma"], 0)
        with pytest.raises(ValueError):
            simulate_lgssm(np.eye(3), s["B"], s["C"], s["D"], s["Sigma"], 5)

    def test_npz_roundtrip(self, small_system, tmp_path):
        from particle_filters_jax.simulators import LGSSMSimulationResult

        s = small_system
        r = simulate_lgssm(s["A"], s["B"], s["C"], s["D"], s["Sigma"], 10, seed=1)
        path = str(tmp_path / "lgssm")
        r.to_file(path, "npz")
        r2 = LGSSMSimulationResult.from_file(path)
        np.testing.assert_allclose(np.asarray(r.X), np.asarray(r2.X))
        with pytest.raises(FileExistsError):
            r.to_file(path, "npz")  # overwrite=False


class TestSV:
    def test_shapes_and_seed(self):
        r = simulate_sv_1d(100, 0.9, 0.2, 1.0, seed=5)
        assert r.X.shape == (100,) and r.Y.shape == (100,)
        r2 = simulate_sv_1d(100, 0.9, 0.2, 1.0, seed=5)
        np.testing.assert_array_equal(np.asarray(r.X), np.asarray(r2.X))

    def test_validation(self):
        """Parameter validation parity (reference
        ``simulator_sto_volatility_model.py:88-95``)."""
        with pytest.raises(ValueError):
            simulate_sv_1d(0, 0.9, 0.2, 1.0)
        with pytest.raises(ValueError):
            simulate_sv_1d(10, 1.0, 0.2, 1.0)
        with pytest.raises(ValueError):
            simulate_sv_1d(10, 0.9, -0.1, 1.0)
        with pytest.raises(ValueError):
            simulate_sv_1d(10, 0.9, 0.2, -1.0)

    def test_stationary_variance(self):
        """Var(X) → σ²/(1−α²) (reference ``test_sv_statistics.py``)."""
        alpha, sigma = 0.9, 0.2
        r = simulate_sv_1d(50000, alpha, sigma, 1.0, seed=11)
        expected = sigma**2 / (1 - alpha**2)
        assert np.isclose(float(jnp.var(r.X)), expected, rtol=0.15)

    def test_x0_override(self):
        r = simulate_sv_1d(10, 0.9, 0.2, 1.0, seed=1, x0=3.0)
        assert np.isclose(float(r.X[0]), 3.0)

    def test_save_load(self, tmp_path):
        from particle_filters_jax.simulators import SV1DResults

        r = simulate_sv_1d(20, 0.9, 0.2, 1.0, seed=1)
        path = str(tmp_path / "sv.npz")
        r.save(path)
        r2 = SV1DResults.load(path)
        np.testing.assert_allclose(np.asarray(r.X), np.asarray(r2.X))
        assert r2.alpha == r.alpha and r2.seed == r.seed


class TestLorenz96:
    def test_rhs_symmetry(self):
        """Constant state x=F is a fixed point shifted by forcing: check
        the cyclic structure directly."""
        x = jnp.full((8,), 8.0)
        dx = l96_rhs(x, F=8.0)
        np.testing.assert_allclose(np.asarray(dx), np.zeros(8), atol=1e-5)

    def test_rhs_batched(self, key):
        xs = jax.random.normal(key, (5, 40))
        batched = l96_rhs(xs)
        single = jnp.stack([l96_rhs(x) for x in xs])
        np.testing.assert_allclose(np.asarray(batched), np.asarray(single), atol=1e-6)

    def test_integrate_shape(self):
        x0 = jnp.full((12,), 8.0).at[0].set(8.01)
        traj = l96_integrate(x0, 0.01, 50)
        assert traj.shape == (51, 12)
        np.testing.assert_allclose(np.asarray(traj[0]), np.asarray(x0))

    def test_chaos_divergence(self):
        """Nearby trajectories diverge (positive Lyapunov exponent),
        reference ``test_lorenz96_dynamics.py``."""
        x0 = jnp.full((40,), 8.0).at[0].set(9.0)
        # Spin onto the attractor first, THEN perturb (perturbing before the
        # transient saturates the separation before measurement starts).
        xa = l96_integrate(x0, 0.01, 1000)[-1]
        xb = xa.at[1].add(1e-4)
        ta = l96_integrate(xa, 0.01, 200)
        tb = l96_integrate(xb, 0.01, 200)
        d0 = float(jnp.linalg.norm(ta[0] - tb[0]))
        d1 = float(jnp.linalg.norm(ta[-1] - tb[-1]))
        assert d1 > 5 * d0  # ≈ e^{1.7·2} ≈ 30× growth expected

    def test_simulate_shapes_and_obs(self):
        r = simulate_lorenz96(
            nx=40, spinup_steps=50, total_steps=60, Np=4, obs_interval=20,
            obs_fraction=4, seed=0,
        )
        assert r.truth_traj.shape == (61, 40)
        assert r.ensemble_traj.shape == (4, 61, 40)
        assert r.obs_times.shape == (4,)  # 0, 20, 40, 60
        assert r.observations.shape == (4, 10)
        assert r.H_idx.shape == (10,)
        # ObsModel gather/Jacobian consistency
        om = r.obs_model
        x = r.truth_traj[0]
        np.testing.assert_allclose(
            np.asarray(om.H(x)), np.asarray(om.JH(x) @ x), atol=1e-5
        )

    def test_save_load_roundtrip(self, tmp_path):
        r = simulate_lorenz96(
            nx=20, spinup_steps=10, total_steps=20, Np=2, obs_interval=10, seed=0
        )
        path = str(tmp_path / "l96")
        r.save(path)
        r2 = Lorenz96SimulationResult.load(path)
        np.testing.assert_allclose(
            np.asarray(r.truth_traj), np.asarray(r2.truth_traj)
        )
        assert r2.config["nx"] == 20


class TestSNLG:
    def test_config_validation(self):
        """Reference ``test_snlg_config_validation.py`` semantics."""
        with pytest.raises(ValueError, match="perfect square"):
            SNLGConfig(d=10)
        with pytest.raises(ValueError):
            SNLGConfig(T=0)
        with pytest.raises(ValueError):
            SNLGConfig(trials=-1)
        with pytest.raises(ValueError):
            SNLGConfig(sigmas=(1.0, -2.0))
        with pytest.raises(ValueError):
            SNLGConfig(alpha1=-0.1)
        with pytest.raises(ValueError):
            SNLGConfig(beta=0.0)

    def test_grid_and_kernel(self):
        coords = make_grid_coords(16)
        assert coords.shape == (16, 2)
        K = se_kernel_cov(coords, 3.0, 20.0, 0.01)
        assert K.shape == (16, 16)
        ev = np.linalg.eigvalsh(np.asarray(K, np.float64))
        assert ev.min() > 0  # SPD with nugget
        np.testing.assert_allclose(np.diag(np.asarray(K)), 3.01, atol=1e-5)

    def test_dataset_shapes(self):
        cfg = SNLGConfig(d=16, T=5, trials=3, sigmas=(2.0, 1.0))
        ds = simulate_snlg_dataset(cfg)
        assert ds.X.shape == (2, 3, 6, 16)
        assert ds.Z.shape == (2, 3, 5, 16)

    def test_noise_level_ordering(self):
        """Observation residual std should track sigma_z."""
        cfg = SNLGConfig(d=16, T=40, trials=5, sigmas=(2.0, 0.5), seed=0)
        ds = simulate_snlg_dataset(cfg)
        resid = np.asarray(ds.Z) - np.asarray(ds.X[:, :, 1:, :])
        s_hi = resid[0].std()
        s_lo = resid[1].std()
        assert np.isclose(s_hi, 2.0, rtol=0.1)
        assert np.isclose(s_lo, 0.5, rtol=0.1)

    def test_npz_json_roundtrip(self, tmp_path):
        from particle_filters_jax.simulators.sensor_network_lg import SNLGDataset

        cfg = SNLGConfig(d=16, T=3, trials=2, sigmas=(1.0,))
        ds = simulate_snlg_dataset(cfg)
        path = str(tmp_path / "snlg.npz")
        ds.save_npz(path)
        ds2 = SNLGDataset.load_npz(path)
        np.testing.assert_allclose(np.asarray(ds.X), np.asarray(ds2.X), atol=1e-6)
        jpath = str(tmp_path / "snlg.json")
        ds.dump_config_json(jpath)
        assert json.load(open(jpath))["d"] == 16


class TestSkewT:
    def test_trial_shapes(self, skewt_small):
        assert skewt_small.X.shape == (10, 16)
        assert skewt_small.Z.shape == (10, 16)
        assert skewt_small.Lambda.shape == (10, 16)

    def test_counts_nonnegative_ints(self, skewt_small):
        z = np.asarray(skewt_small.Z)
        assert np.issubdtype(z.dtype, np.integer)
        assert np.all(z >= 0)

    def test_lattice_validation(self):
        from particle_filters_jax.simulators.sensor_network_skewt import make_lattice

        with pytest.raises(ValueError):
            make_lattice(10)

    @pytest.mark.slow
    def test_heavy_tails(self):
        """Skew-t dynamics have heavier tails than the Gaussian analog
        (reference ``test_sn_skewt_simulation.py`` semantics): low nu ⇒
        larger excess kurtosis of increments."""
        heavy = simulate_skewt_many(
            SkewTGridConfig(d=9),
            SkewTDynConfig(nu=2.5, seed=0, clip_x=None, gamma_scale=0.0),
            SkewTMeasConfig(),
            SkewTSimConfig(T=200, n_trials=10),
        )
        light = simulate_skewt_many(
            SkewTGridConfig(d=9),
            SkewTDynConfig(nu=200.0, seed=0, clip_x=None, gamma_scale=0.0),
            SkewTMeasConfig(),
            SkewTSimConfig(T=200, n_trials=10),
        )

        def kurt(x):
            x = np.asarray(x).ravel()
            x = x - x.mean()
            return (x**4).mean() / (x**2).mean() ** 2

        assert kurt(heavy.X) > kurt(light.X) + 0.5

    @pytest.mark.slow
    def test_multi_trial_independent(self):
        r = simulate_skewt_many(
            SkewTGridConfig(d=9),
            SkewTDynConfig(seed=1),
            SkewTMeasConfig(),
            SkewTSimConfig(T=5, n_trials=3),
        )
        assert r.X.shape == (3, 5, 9)
        assert not np.allclose(np.asarray(r.X[0]), np.asarray(r.X[1]))

    def test_poisson_rate_link(self, skewt_small):
        """λ = m₁ exp(m₂ clip(x))."""
        lam = np.asarray(skewt_small.Lambda)
        x = np.clip(np.asarray(skewt_small.X), -10, 10)
        np.testing.assert_allclose(lam, np.exp(x / 3.0), rtol=1e-4)


class TestMAT:
    def test_article_constants(self):
        F = build_cv_transition(1.0)
        np.testing.assert_allclose(np.asarray(F)[0], [1, 0, 1, 0])
        V = article_process_noise_cov()
        np.testing.assert_allclose(np.asarray(V)[0, 0], 1.0 / 60.0, rtol=1e-5)
        X0 = article_initial_states(4)
        assert X0.shape == (4, 4)
        with pytest.raises(ValueError):
            article_initial_states(3)

    def test_sensor_grid(self):
        s = make_sensor_grid((40.0, 40.0), (5, 5))
        assert s.shape == (25, 2)
        assert float(s[:, 0].min()) == 0.0 and float(s[:, 0].max()) == 40.0

    def test_trajectories_in_bounds(self, mat_small):
        P = np.asarray(mat_small.P)
        assert P.min() >= 0.0 and P.max() <= 40.0

    def test_measurement_additivity(self, mat_small):
        """Z equals the sum of per-target contributions (reference
        ``test_filters_mat_simulator.py:97-118`` cross-check)."""
        P = mat_small.P
        S = mat_small.S
        total = acoustic_measurement_model(P, S, psi=10.0, d0=0.1)
        per_target = sum(
            acoustic_measurement_model(P[:, c : c + 1, :], S, psi=10.0, d0=0.1)
            for c in range(P.shape[1])
        )
        np.testing.assert_allclose(
            np.asarray(total), np.asarray(per_target), rtol=1e-5
        )

    def test_measurement_positive_and_peaked(self, mat_small):
        z = np.asarray(mat_small.Z)
        assert np.all(z > 0)

    def test_random_init_branch(self):
        cfg = MATScenarioConfig(n_targets=3, n_steps=10, use_article_init=False)
        r = simulate_acoustic_dataset(cfg, MATDynamicsConfig())
        assert r.X.shape == (10, 3, 4)

    def test_npz_roundtrip(self, mat_small, tmp_path):
        from particle_filters_jax.simulators.acoustic_tracking import MATDataset

        path = str(tmp_path / "mat.npz")
        mat_small.save_npz(path)
        r2 = MATDataset.load_npz(path)
        np.testing.assert_allclose(np.asarray(mat_small.Z), np.asarray(r2.Z))
