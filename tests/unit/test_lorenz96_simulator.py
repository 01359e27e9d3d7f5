"""Lorenz-96 simulator unit suite — counterpart of the reference's
``tests/unit_tests/simulator/test_lorenz96_{dynamics,io,shapes_and_seed}.py``
(38 tests upstream): RHS structure, RK4 integration, chaos properties,
persistence, and the simulate_lorenz96 protocol
(``particle_filters_jax/simulators/lorenz96.py``).

Complements the smaller smoke tests in ``tests/unit/test_simulators.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.simulators.lorenz96 import (
    Lorenz96SimulationResult,
    ObsModel,
    compute_ensemble_spread,
    compute_rmse,
    l96_integrate,
    l96_rhs,
    rk4_step,
    simulate_lorenz96,
)

NX = 40  # classic small L96 size for fast tests


@pytest.fixture(scope="module")
def small_sim():
    return simulate_lorenz96(
        nx=NX, spinup_steps=100, total_steps=60, Np=5,
        obs_interval=10, obs_fraction=4, seed=7,
    )


class TestRHS:
    def test_shape(self):
        x = jnp.ones((NX,))
        assert l96_rhs(x).shape == (NX,)

    def test_batched_shape(self):
        x = jnp.ones((3, 7, NX))
        assert l96_rhs(x).shape == (3, 7, NX)

    def test_periodic_boundary(self, key):
        # shifting the state cyclically shifts the RHS cyclically
        x = jax.random.normal(key, (NX,))
        r = l96_rhs(x)
        r_shift = l96_rhs(jnp.roll(x, 3))
        np.testing.assert_allclose(r_shift, jnp.roll(r, 3), rtol=1e-5)

    def test_forcing_term(self):
        # at x = 0 the RHS is exactly F everywhere
        np.testing.assert_allclose(l96_rhs(jnp.zeros(NX), F=8.0), 8.0)
        np.testing.assert_allclose(l96_rhs(jnp.zeros(NX), F=3.5), 3.5)

    def test_fixed_point_at_F(self):
        # x_a = F for all a is an equilibrium: (F-F)·F − F + F = 0
        np.testing.assert_allclose(l96_rhs(jnp.full(NX, 8.0), F=8.0), 0.0, atol=1e-5)

    def test_formula_small_system(self):
        # hand-check component 0 for nx=5: (x1 - x3)·x4 − x0 + F
        x = jnp.array([1.0, 2.0, 3.0, 4.0, 5.0])
        r = l96_rhs(x, F=0.0)
        np.testing.assert_allclose(r[0], (2.0 - 4.0) * 5.0 - 1.0, rtol=1e-6)


class TestRK4:
    def test_advances_state(self):
        x = jnp.full(NX, 1.0)
        x1 = rk4_step(x, 0.01, lambda z: l96_rhs(z, 8.0))
        assert not np.allclose(np.asarray(x1), np.asarray(x))

    def test_conserves_dimension(self):
        x = jnp.ones((4, NX))
        assert rk4_step(x, 0.01, l96_rhs).shape == (4, NX)

    def test_exact_for_linear_ode(self):
        # dx/dt = -x: RK4 matches exp(-dt) to O(dt^5)
        x = jnp.array([2.0])
        out = rk4_step(x, 0.1, lambda z: -z)
        np.testing.assert_allclose(out, 2.0 * np.exp(-0.1), rtol=1e-7)

    def test_order_of_accuracy(self):
        # halving dt must reduce one-step error ~16x (4th order ⇒ O(dt^5) local)
        f = lambda z: -z
        exact = lambda t: np.exp(-t)
        e1 = abs(float(rk4_step(jnp.array([1.0]), 0.2, f)[0]) - exact(0.2))
        e2 = abs(
            float(
                rk4_step(rk4_step(jnp.array([1.0]), 0.1, f), 0.1, f)[0]
            )
            - exact(0.2)
        )
        assert e1 / e2 > 8.0


class TestIntegrate:
    def test_shape_includes_x0(self):
        traj = l96_integrate(jnp.ones(NX), 0.01, 10)
        assert traj.shape == (11, NX)
        np.testing.assert_allclose(traj[0], 1.0)

    def test_deterministic_without_noise(self):
        x0 = jnp.linspace(0, 1, NX)
        a = l96_integrate(x0, 0.01, 20)
        b = l96_integrate(x0, 0.01, 20)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_with_noise_differs(self, key):
        x0 = jnp.linspace(0, 1, NX)
        a = l96_integrate(x0, 0.01, 20)
        b = l96_integrate(x0, 0.01, 20, q_std=0.1, key=key)
        assert not np.allclose(np.asarray(a), np.asarray(b))

    def test_noise_seed_reproducible(self, key):
        x0 = jnp.zeros(NX)
        a = l96_integrate(x0, 0.01, 10, q_std=0.1, key=key)
        b = l96_integrate(x0, 0.01, 10, q_std=0.1, key=key)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_batched_over_ensemble(self):
        x0 = jnp.stack([jnp.full(NX, 8.0), jnp.full(NX, 8.1)])
        traj = l96_integrate(x0, 0.01, 5)
        assert traj.shape == (6, 2, NX)

    @pytest.mark.slow
    def test_chaotic_divergence(self):
        # two nearby trajectories on the attractor separate exponentially
        x0 = np.full(NX, 8.0)
        x0[::5] += 1.0
        base = l96_integrate(jnp.asarray(x0, jnp.float32), 0.01, 1000)[-1]
        pert = l96_integrate(
            jnp.asarray(x0 + 1e-3, jnp.float32), 0.01, 1000
        )[-1]
        d_final = float(jnp.linalg.norm(base - pert))
        assert d_final > 0.5  # grew ≫ initial 1e-3·√40 ≈ 6e-3

    @pytest.mark.slow
    def test_attractor_statistics(self):
        # long-run mean of L96 at F=8 is ≈ 2.3, std ≈ 3.6 (well-known values)
        x0 = np.full(NX, 8.0)
        x0[::5] += 1.0
        traj = l96_integrate(jnp.asarray(x0, jnp.float32), 0.01, 2000)
        late = np.asarray(traj[500:])
        assert 1.0 < late.mean() < 3.5
        assert 2.5 < late.std() < 5.0


class TestObsModel:
    def test_H_picks_indices(self):
        om = ObsModel(H_idx=jnp.array([0, 2]), R=jnp.eye(2))
        x = jnp.array([10.0, 11.0, 12.0, 13.0])
        np.testing.assert_allclose(om.H(x), [10.0, 12.0])

    def test_H_batched(self):
        om = ObsModel(H_idx=jnp.array([1, 3]), R=jnp.eye(2))
        x = jnp.arange(8.0).reshape(2, 4)
        assert om.H(x).shape == (2, 2)

    def test_JH_is_selection_matrix(self):
        om = ObsModel(H_idx=jnp.array([0, 2]), R=jnp.eye(2))
        x = jnp.zeros(4)
        J = np.asarray(om.JH(x))
        expected = np.zeros((2, 4))
        expected[0, 0] = expected[1, 2] = 1.0
        np.testing.assert_array_equal(J, expected)

    def test_JH_consistent_with_H(self, key):
        om = ObsModel(H_idx=jnp.array([1, 2, 5]), R=jnp.eye(3))
        x = jax.random.normal(key, (8,))
        np.testing.assert_allclose(om.JH(x) @ x, om.H(x), rtol=1e-6)


class TestSimulateLorenz96:
    def test_basic_shapes(self, small_sim):
        T = 60
        n_obs = T // 10 + 1
        ny = NX // 4
        assert small_sim.truth_traj.shape == (T + 1, NX)
        assert small_sim.ensemble_traj.shape == (5, T + 1, NX)
        assert small_sim.observations.shape == (n_obs, ny)
        assert small_sim.obs_times.shape == (n_obs,)

    def test_reproducibility_with_seed(self):
        kw = dict(nx=8, spinup_steps=10, total_steps=5, Np=2, seed=3)
        a, b = simulate_lorenz96(**kw), simulate_lorenz96(**kw)
        np.testing.assert_array_equal(np.asarray(a.truth_traj), np.asarray(b.truth_traj))
        np.testing.assert_array_equal(np.asarray(a.observations), np.asarray(b.observations))

    def test_different_seeds_differ(self):
        kw = dict(nx=8, spinup_steps=10, total_steps=5, Np=2)
        a = simulate_lorenz96(seed=1, **kw)
        b = simulate_lorenz96(seed=2, **kw)
        # truth is seed-independent (deterministic spinup) but obs noise and
        # ensemble perturbations are not
        np.testing.assert_array_equal(np.asarray(a.truth_traj), np.asarray(b.truth_traj))
        assert not np.allclose(np.asarray(a.observations), np.asarray(b.observations))
        assert not np.allclose(np.asarray(a.ensemble_traj), np.asarray(b.ensemble_traj))

    def test_config_stored(self, small_sim):
        c = small_sim.config
        assert c["nx"] == NX and c["Np"] == 5 and c["obs_interval"] == 10
        assert c["ny"] == NX // 4

    def test_observation_indices(self, small_sim):
        np.testing.assert_array_equal(
            np.asarray(small_sim.H_idx), np.arange(0, NX, 4)
        )

    def test_observation_covariance_diagonal(self, small_sim):
        R = np.asarray(small_sim.R)
        np.testing.assert_array_equal(R, np.eye(NX // 4))

    def test_observation_times(self, small_sim):
        np.testing.assert_array_equal(
            np.asarray(small_sim.obs_times), np.arange(0, 61, 10)
        )

    def test_observations_near_truth(self, small_sim):
        true_at_obs = np.asarray(
            small_sim.truth_traj[np.asarray(small_sim.obs_times)]
        )[:, np.asarray(small_sim.H_idx)]
        resid = np.asarray(small_sim.observations) - true_at_obs
        assert abs(resid.mean()) < 1.0 and 0.3 < resid.std() < 3.0

    def test_custom_initial_condition(self):
        x0 = jnp.linspace(-1, 1, 8)
        res = simulate_lorenz96(nx=8, spinup_steps=0, total_steps=3, Np=1, x0=x0, seed=0)
        np.testing.assert_allclose(res.truth_traj[0], x0, rtol=1e-6)

    def test_invalid_x0_shape_raises(self):
        with pytest.raises(ValueError, match="x0"):
            simulate_lorenz96(nx=8, x0=jnp.zeros(5), total_steps=2, spinup_steps=0)

    def test_default_init_pattern(self):
        # x(0) = F everywhere with +1 every 5th before spinup
        res = simulate_lorenz96(nx=10, F=8.0, spinup_steps=0, total_steps=1, Np=1, seed=0)
        x0 = np.asarray(res.truth_traj[0])
        np.testing.assert_allclose(x0[[0, 5]], 9.0)
        np.testing.assert_allclose(x0[[1, 2, 3, 4, 6, 7, 8, 9]], 8.0)

    def test_perturbation_std_default_sqrt2(self):
        res = simulate_lorenz96(nx=30, spinup_steps=5, total_steps=1, Np=50, seed=4)
        assert res.config["perturbation_std"] == pytest.approx(np.sqrt(2.0))
        spread0 = np.asarray(res.ensemble_traj[:, 0] - res.truth_traj[0]).std()
        assert 1.0 < spread0 < 1.9

    def test_custom_perturbation_std(self):
        res = simulate_lorenz96(
            nx=30, spinup_steps=5, total_steps=1, Np=50,
            perturbation_std=0.1, seed=4,
        )
        spread0 = np.asarray(res.ensemble_traj[:, 0] - res.truth_traj[0]).std()
        assert spread0 < 0.2

    def test_dtypes_float(self, small_sim):
        assert jnp.issubdtype(small_sim.truth_traj.dtype, jnp.floating)
        assert jnp.issubdtype(small_sim.observations.dtype, jnp.floating)


class TestLorenz96IO:
    def test_save_creates_npz_and_json(self, small_sim, tmp_path):
        p = tmp_path / "l96"
        small_sim.save(str(p))
        assert (tmp_path / "l96.npz").exists()
        assert (tmp_path / "l96.json").exists()

    def test_save_with_npz_extension(self, small_sim, tmp_path):
        small_sim.save(str(tmp_path / "x.npz"))
        assert (tmp_path / "x.npz").exists()

    def test_save_overwrite_false_raises(self, small_sim, tmp_path):
        p = str(tmp_path / "y.npz")
        small_sim.save(p)
        with pytest.raises(FileExistsError):
            small_sim.save(p)

    def test_save_overwrite_true(self, small_sim, tmp_path):
        p = str(tmp_path / "z.npz")
        small_sim.save(p)
        small_sim.save(p, overwrite=True)

    def test_load_restores_data(self, small_sim, tmp_path):
        p = str(tmp_path / "r.npz")
        small_sim.save(p)
        back = Lorenz96SimulationResult.load(p)
        np.testing.assert_allclose(
            np.asarray(back.truth_traj), np.asarray(small_sim.truth_traj), rtol=1e-6
        )
        np.testing.assert_array_equal(
            np.asarray(back.H_idx), np.asarray(small_sim.H_idx)
        )
        assert back.config["nx"] == NX

    def test_load_without_extension(self, small_sim, tmp_path):
        small_sim.save(str(tmp_path / "noext"))
        back = Lorenz96SimulationResult.load(str(tmp_path / "noext"))
        assert back.truth_traj.shape == small_sim.truth_traj.shape

    def test_load_missing_config_graceful(self, small_sim, tmp_path):
        p = str(tmp_path / "nocfg.npz")
        small_sim.save(p)
        (tmp_path / "nocfg.json").unlink()
        back = Lorenz96SimulationResult.load(p)
        assert back.config == {}

    def test_roundtrip_obs_model(self, small_sim, tmp_path):
        p = str(tmp_path / "om.npz")
        small_sim.save(p)
        om = Lorenz96SimulationResult.load(p).obs_model
        x = jnp.arange(NX, dtype=jnp.float32)
        np.testing.assert_allclose(om.H(x), np.arange(0, NX, 4), rtol=1e-6)


class TestMetrics:
    def test_rmse_basic(self):
        f = jnp.array([1.0, 2.0, 3.0])
        t = jnp.array([1.0, 2.0, 5.0])
        np.testing.assert_allclose(compute_rmse(f, t), np.sqrt(4.0 / 3.0), rtol=1e-6)

    def test_rmse_perfect_match(self):
        x = jnp.ones((5, 3))
        assert float(compute_rmse(x, x)) == 0.0

    def test_ensemble_spread(self):
        ens = jnp.array([[0.0, 0.0], [2.0, 2.0]])
        np.testing.assert_allclose(compute_ensemble_spread(ens), [1.0, 1.0])

    def test_spread_axis(self):
        ens = jnp.array([[0.0, 0.0], [2.0, 4.0]])
        np.testing.assert_allclose(
            compute_ensemble_spread(ens, axis=1), [0.0, 1.0]
        )
