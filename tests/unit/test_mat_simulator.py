"""Multi-target acoustic tracking (MAT) simulator unit suite — counterpart
of the reference ``tests/unit_tests/simulator/test_mat_{cv_dynamics,
measurement,shapes_and_seed,end2end}.py`` (24 tests), beyond the smoke tests
in ``tests/unit/test_simulators.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.simulators.acoustic_tracking import (
    MATDataset,
    MATDynamicsConfig,
    MATScenarioConfig,
    acoustic_measurement_model,
    article_initial_states,
    article_process_noise_cov,
    build_cv_transition,
    make_sensor_grid,
    simulate_acoustic_dataset,
    simulate_cv_targets,
)


@pytest.fixture(scope="module")
def small_ds():
    return simulate_acoustic_dataset(
        MATScenarioConfig(n_steps=30, seed=7), MATDynamicsConfig()
    )


class TestCVDynamics:
    def test_transition_structure(self):
        F = np.asarray(build_cv_transition(2.0))
        expected = np.eye(4)
        expected[0, 2] = expected[1, 3] = 2.0
        np.testing.assert_array_equal(F, expected)

    def test_transition_propagates_position_by_velocity(self):
        F = build_cv_transition(1.0)
        x = jnp.array([1.0, 2.0, 0.5, -0.5])
        x1 = F @ x
        np.testing.assert_allclose(np.asarray(x1), [1.5, 1.5, 0.5, -0.5])

    def test_process_noise_article_values(self):
        V = np.asarray(article_process_noise_cov())
        np.testing.assert_allclose(V[0, 0], 1.0 / 60.0, rtol=1e-6)
        np.testing.assert_allclose(V[0, 2], 1.0 / 40.0, rtol=1e-6)
        np.testing.assert_allclose(V[2, 2], 1.0 / 20.0, rtol=1e-6)
        np.testing.assert_allclose(V, V.T)

    def test_process_noise_positive_definite(self):
        V = np.asarray(article_process_noise_cov(), np.float64)
        assert np.linalg.eigvalsh(V).min() > 0

    def test_article_initial_states_values(self):
        x0 = np.asarray(article_initial_states(4))
        assert x0.shape == (4, 4)
        np.testing.assert_allclose(x0[0], [12.0, 6.0, 0.001, 0.001])
        np.testing.assert_allclose(x0[2], [20.0, 13.0, -0.1, 0.01])

    def test_article_initial_states_wrong_count_raises(self):
        with pytest.raises(ValueError, match="n_targets"):
            article_initial_states(3)

    def test_trajectories_stay_in_bounds(self, key):
        traj = simulate_cv_targets(
            200, 4, (40.0, 40.0), MATDynamicsConfig(), key
        )
        P = np.asarray(traj[..., :2])
        assert P.min() >= -1e-5 and P.max() <= 40.0 + 1e-5

    def test_reflection_flips_velocity(self, key):
        # start a fast target heading straight at the x=0 wall
        x0_like = simulate_cv_targets(
            2, 1, (10.0, 10.0), MATDynamicsConfig(), key,
            use_article_init=False, enforce_boundaries=True,
        )
        # direct mechanism check instead: propagate a state past the wall
        from particle_filters_jax.simulators.acoustic_tracking import _reflect

        pos, vel = _reflect(jnp.array([-0.5]), jnp.array([-1.0]), 0.0, 10.0, 1e-6)
        assert float(pos[0]) > 0 and float(vel[0]) == 1.0
        pos, vel = _reflect(jnp.array([10.5]), jnp.array([1.0]), 0.0, 10.0, 1e-6)
        assert float(pos[0]) < 10.0 and float(vel[0]) == -1.0

    def test_no_boundaries_can_escape(self, key):
        traj = simulate_cv_targets(
            300, 4, (1.0, 1.0), MATDynamicsConfig(), key,
            use_article_init=False, enforce_boundaries=False,
        )
        P = np.asarray(traj[..., :2])
        assert (P < 0).any() or (P > 1.0).any()

    def test_random_init_within_central_region(self, key):
        traj = simulate_cv_targets(
            1, 6, (40.0, 40.0), MATDynamicsConfig(), key, use_article_init=False
        )
        P0 = np.asarray(traj[0, :, :2])
        assert (P0 >= 10.0).all() and (P0 <= 30.0).all()

    def test_seed_reproducible(self, key):
        a = simulate_cv_targets(10, 4, (40.0, 40.0), MATDynamicsConfig(), key)
        b = simulate_cv_targets(10, 4, (40.0, 40.0), MATDynamicsConfig(), key)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestSensorGrid:
    def test_grid_shape(self):
        S = make_sensor_grid((40.0, 40.0), (5, 5))
        assert S.shape == (25, 2)

    def test_grid_covers_boundaries(self):
        S = np.asarray(make_sensor_grid((40.0, 20.0), (3, 4)))
        assert S[:, 0].min() == 0.0 and S[:, 0].max() == 40.0
        assert S[:, 1].min() == 0.0 and S[:, 1].max() == 20.0

    def test_grid_rectangular_shape(self):
        assert make_sensor_grid((10.0, 10.0), (2, 7)).shape == (14, 2)

    def test_grid_uniform_spacing(self):
        S = np.asarray(make_sensor_grid((40.0, 40.0), (5, 5)))
        xs = np.unique(S[:, 0])
        np.testing.assert_allclose(np.diff(xs), 10.0, rtol=1e-6)


class TestMeasurementModel:
    def test_shape_time_batched(self, key):
        pos = jax.random.uniform(key, (7, 3, 2), minval=5.0, maxval=35.0)
        S = make_sensor_grid((40.0, 40.0), (5, 5))
        Z = acoustic_measurement_model(pos, S, psi=10.0, d0=0.1)
        assert Z.shape == (7, 25)

    def test_single_target_formula(self):
        sensors = jnp.array([[0.0, 0.0], [3.0, 4.0]])
        pos = jnp.array([[3.0, 4.0]])  # one target at second sensor
        Z = np.asarray(acoustic_measurement_model(pos, sensors, psi=10.0, d0=0.1))
        np.testing.assert_allclose(Z[0], 10.0 / 25.1, rtol=1e-5)
        np.testing.assert_allclose(Z[1], 10.0 / 0.1, rtol=1e-5)

    def test_additivity_over_targets(self, key):
        S = make_sensor_grid((40.0, 40.0), (3, 3))
        p1 = jnp.array([[10.0, 10.0]])
        p2 = jnp.array([[30.0, 25.0]])
        both = jnp.concatenate([p1, p2], axis=0)
        Z1 = acoustic_measurement_model(p1, S, 10.0, 0.1)
        Z2 = acoustic_measurement_model(p2, S, 10.0, 0.1)
        Zb = acoustic_measurement_model(both, S, 10.0, 0.1)
        np.testing.assert_allclose(np.asarray(Zb), np.asarray(Z1 + Z2), rtol=1e-5)

    def test_amplitude_peaks_at_nearest_sensor(self):
        S = make_sensor_grid((40.0, 40.0), (5, 5))
        pos = jnp.array([[0.5, 0.5]])  # near corner sensor 0
        Z = np.asarray(acoustic_measurement_model(pos, S, 10.0, 0.1))
        assert Z.argmax() == 0

    def test_psi_scales_linearly(self, key):
        S = make_sensor_grid((40.0, 40.0), (3, 3))
        pos = jax.random.uniform(key, (2, 2), minval=5.0, maxval=35.0)
        Z1 = acoustic_measurement_model(pos, S, 1.0, 0.1)
        Z10 = acoustic_measurement_model(pos, S, 10.0, 0.1)
        np.testing.assert_allclose(np.asarray(Z10), 10 * np.asarray(Z1), rtol=1e-5)

    def test_d0_regularizes_peak(self):
        sensors = jnp.array([[0.0, 0.0]])
        pos = jnp.array([[0.0, 0.0]])  # on top of the sensor
        Z = acoustic_measurement_model(pos, sensors, 10.0, 0.5)
        np.testing.assert_allclose(float(Z[0]), 20.0, rtol=1e-6)

    def test_measurements_positive(self, small_ds):
        assert (np.asarray(small_ds.Z) > 0).all()


class TestEnd2End:
    def test_dataset_shapes(self, small_ds):
        assert small_ds.X.shape == (30, 4, 4)
        assert small_ds.P.shape == (30, 4, 2)
        assert small_ds.S.shape == (25, 2)
        assert small_ds.Z.shape == (30, 25)
        assert small_ds.meta.shape == (5,)

    def test_meta_values(self, small_ds):
        np.testing.assert_allclose(
            np.asarray(small_ds.meta), [40.0, 40.0, 10.0, 0.1, 1.0]
        )

    def test_positions_match_states(self, small_ds):
        np.testing.assert_array_equal(
            np.asarray(small_ds.P), np.asarray(small_ds.X[..., :2])
        )

    def test_measurements_consistent_with_positions(self, small_ds):
        Z_re = acoustic_measurement_model(small_ds.P, small_ds.S, 10.0, 0.1)
        np.testing.assert_allclose(np.asarray(Z_re), np.asarray(small_ds.Z), rtol=1e-5)

    def test_article_init_used(self, small_ds):
        np.testing.assert_allclose(
            np.asarray(small_ds.X[0]), np.asarray(article_initial_states(4))
        )

    def test_seed_reproducible(self):
        cfg = MATScenarioConfig(n_steps=10, seed=3)
        a = simulate_acoustic_dataset(cfg, MATDynamicsConfig())
        b = simulate_acoustic_dataset(cfg, MATDynamicsConfig())
        np.testing.assert_array_equal(np.asarray(a.X), np.asarray(b.X))

    def test_different_seeds_differ(self):
        a = simulate_acoustic_dataset(
            MATScenarioConfig(n_steps=10, seed=1), MATDynamicsConfig()
        )
        b = simulate_acoustic_dataset(
            MATScenarioConfig(n_steps=10, seed=2), MATDynamicsConfig()
        )
        assert not np.allclose(np.asarray(a.X[1:]), np.asarray(b.X[1:]))

    def test_npz_roundtrip(self, small_ds, tmp_path):
        p = str(tmp_path / "mat.npz")
        small_ds.save_npz(p)
        back = MATDataset.load_npz(p)
        np.testing.assert_allclose(np.asarray(back.X), np.asarray(small_ds.X), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(back.Z), np.asarray(small_ds.Z), rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(back.meta), np.asarray(small_ds.meta))

    def test_as_dict_keys(self, small_ds):
        assert set(small_ds.as_dict()) == {"X", "P", "S", "Z", "meta"}
