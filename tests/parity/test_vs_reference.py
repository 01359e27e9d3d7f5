"""Numeric parity vs the ORIGINAL reference implementation.

These tests import the upstream NumPy code (mounted read-only at
/root/reference) and compare it output-to-output against this framework on
IDENTICAL inputs. Only deterministic paths are compared exactly (the RNGs
differ by design — threefry vs PCG64): Kalman-family filters given the same
observations, SPF β schedules given the same matrices, kernel/localization
functions, simulator constants. Skipped wholesale when the reference is not
mounted.
"""

import os
import sys

import numpy as np
import pytest

REF = "/root/reference"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference repo not mounted"
)


@pytest.fixture(scope="module", autouse=True)
def _ref_path():
    sys.path.insert(0, REF)
    yield
    sys.path.remove(REF)


@pytest.fixture(scope="module")
def ref_lgssm_data():
    """One dataset, generated by the REFERENCE simulator, consumed by both."""
    from simulator.simulator_LGSSM import simulate_lgssm as ref_sim

    A = np.array([[0.9, 0.5], [0.0, 0.7]])
    B = np.diag([np.sqrt(0.05), np.sqrt(0.02)])
    C = np.eye(2)
    D = np.sqrt(0.1) * np.eye(2)
    Sigma = np.eye(2)
    r = ref_sim(A, B, C, D, Sigma, 200, seed=42)
    return dict(A=A, B=B, C=C, D=D, Sigma=Sigma, X=r.X, Y=r.Y)


class TestKFParity:
    def test_kalman_filter_general_matches(self, ref_lgssm_data):
        """Same Y → same filtered means/covs/loglik (f32 vs f64 tolerance)."""
        from models.kalman_filter import kalman_filter_general as ref_kf

        from particle_filters_jax.models import kalman_filter_general

        d = ref_lgssm_data
        Q = d["B"] @ d["B"].T
        R = d["D"] @ d["D"].T
        kw = dict(x0=np.zeros(2), P0=d["Sigma"])
        ref = ref_kf(d["Y"], d["A"], d["C"], np.eye(2), Q, R, **kw)
        ours = kalman_filter_general(
            d["Y"].astype(np.float32), d["A"].astype(np.float32),
            d["C"].astype(np.float32), np.eye(2, dtype=np.float32),
            Q.astype(np.float32), R.astype(np.float32),
            x0=np.zeros(2, np.float32), P0=d["Sigma"].astype(np.float32),
        )
        np.testing.assert_allclose(
            np.asarray(ours.x_filt), ref.x_filt, atol=2e-3
        )
        np.testing.assert_allclose(
            np.asarray(ours.P_filt), ref.P_filt, atol=2e-3
        )
        np.testing.assert_allclose(
            float(ours.loglik), ref.loglik, rtol=1e-3
        )

    def test_joseph_form_matches(self, ref_lgssm_data):
        from models.kalman_filter import kalman_filter_general as ref_kf

        from particle_filters_jax.models import kalman_filter_general

        d = ref_lgssm_data
        Q = d["B"] @ d["B"].T
        R = d["D"] @ d["D"].T
        ref = ref_kf(
            d["Y"], d["A"], d["C"], np.eye(2), Q, R,
            x0=np.zeros(2), P0=d["Sigma"], use_joseph=True,
        )
        ours = kalman_filter_general(
            d["Y"].astype(np.float32), d["A"].astype(np.float32),
            d["C"].astype(np.float32), np.eye(2, dtype=np.float32),
            Q.astype(np.float32), R.astype(np.float32),
            x0=np.zeros(2, np.float32), P0=d["Sigma"].astype(np.float32),
            use_joseph=True,
        )
        np.testing.assert_allclose(np.asarray(ours.x_filt), ref.x_filt, atol=2e-3)


class TestEKFUKFParity:
    def test_ekf_matches_on_nonlinear_model(self, ref_lgssm_data):
        """Same nonlinear g/h + same observations → same posterior track."""
        import jax.numpy as jnp
        from models.extended_kalman_filter import (
            EKFState as RefEKFState,
            ExtendedKalmanFilter as RefEKF,
        )

        from particle_filters_jax.models import ExtendedKalmanFilter, make_ekf_state

        Q = 0.05 * np.eye(2)
        R = 0.1 * np.eye(2)

        g_np = lambda x, u: np.array([0.9 * x[0] + 0.2 * np.sin(x[1]), 0.8 * x[1]])
        h_np = lambda x: np.array([x[0], x[0] * x[1]])
        jg_np = lambda x, u: np.array([[0.9, 0.2 * np.cos(x[1])], [0.0, 0.8]])
        jh_np = lambda x: np.array([[1.0, 0.0], [x[1], x[0]]])

        g_jx = lambda x, u: jnp.array([0.9 * x[0] + 0.2 * jnp.sin(x[1]), 0.8 * x[1]])
        h_jx = lambda x: jnp.array([x[0], x[0] * x[1]])

        zs = np.random.default_rng(0).normal(size=(30, 2))

        ref = RefEKF(g_np, h_np, Q, R, jac_g=jg_np, jac_h=jh_np)
        rs = RefEKFState(mean=np.array([1.0, 1.0]), cov=np.eye(2), t=0)
        ref_means = []
        for z in zs:
            rs = ref.step(rs, z)
            ref_means.append(rs.mean.copy())

        ours = ExtendedKalmanFilter(g_jx, h_jx, Q, R)  # AD Jacobians
        _, means, _ = ours.run(
            make_ekf_state(np.array([1.0, 1.0], np.float32), np.eye(2, dtype=np.float32)),
            zs.astype(np.float32),
        )
        np.testing.assert_allclose(
            np.asarray(means), np.stack(ref_means), atol=5e-3
        )

    def test_ukf_matches(self):
        """Same sigma-point parameters → same UKF track (alpha=0.5 so the
        reference's float64 small-alpha regime isn't needed)."""
        import jax.numpy as jnp
        from models.unscented_kalman_filter import (
            UKFState as RefUKFState,
            UnscentedKalmanFilter as RefUKF,
        )

        from particle_filters_jax.models import UnscentedKalmanFilter, make_ukf_state

        Q = 0.05 * np.eye(2)
        R = 0.1 * np.eye(2)
        g_np = lambda x, u: np.array([0.9 * x[0] + 0.1 * x[1] ** 2, 0.8 * x[1]])
        h_np = lambda x: np.array([np.sin(x[0]), x[1]])
        g_jx = lambda x, u: jnp.array([0.9 * x[0] + 0.1 * x[1] ** 2, 0.8 * x[1]])
        h_jx = lambda x: jnp.array([jnp.sin(x[0]), x[1]])
        zs = np.random.default_rng(1).normal(size=(30, 2))

        ref = RefUKF(g_np, h_np, Q, R, alpha=0.5, beta=2.0, kappa=0.0)
        rs = RefUKFState(mean=np.zeros(2), cov=np.eye(2), t=0)
        ref_means = []
        for z in zs:
            rs = ref.step(rs, z)
            ref_means.append(rs.mean.copy())

        ours = UnscentedKalmanFilter(g_jx, h_jx, Q, R, alpha=0.5)
        _, means, _ = ours.run(
            make_ukf_state(np.zeros(2, np.float32), np.eye(2, dtype=np.float32)),
            zs.astype(np.float32),
        )
        np.testing.assert_allclose(
            np.asarray(means), np.stack(ref_means), atol=5e-3
        )


class TestSPFParity:
    def test_beta_schedule_matches(self):
        """Same (M0, Mh, µ) → same optimal β(λ) curve."""
        from models.Stochastic_particle_filter import (
            solve_beta_star_bisection as ref_solve,
        )

        from particle_filters_jax.models import solve_beta_star_bisection

        M0 = np.array([[1.0, 0.2], [0.2, 2.0]])
        Mh = np.array([[4.0, 0.0], [0.0, 0.5]])
        lam_r, beta_r, _ = ref_solve(M0, Mh, mu=1e-2, n_grid=101)
        lam_o, beta_o, _ = solve_beta_star_bisection(
            M0.astype(np.float32), Mh.astype(np.float32), mu=1e-2, n_grid=101
        )
        np.testing.assert_allclose(np.asarray(beta_o), beta_r, atol=5e-3)

    def test_kappa2_matches(self):
        from models.Stochastic_particle_filter import (
            kappa2_and_derivative as ref_k2,
        )

        from particle_filters_jax.models import kappa2_and_derivative

        M = np.array([[2.0, 0.3], [0.3, 1.0]])
        dM = np.array([[1.0, 0.0], [0.0, 3.0]])
        k_r, dk_r = ref_k2(M, dM)
        k_o, dk_o = kappa2_and_derivative(
            M.astype(np.float32), dM.astype(np.float32)
        )
        assert np.isclose(float(k_o), k_r, rtol=1e-4)
        assert np.isclose(float(dk_o), dk_r, rtol=1e-3)

    def test_kalman_posterior_matches(self):
        from models.Stochastic_particle_filter import (
            LinearGaussianBayes as RefLGB,
        )

        from particle_filters_jax.models import LinearGaussianBayes

        m0 = np.array([1.0, -2.0])
        P0 = np.array([[2.0, 0.5], [0.5, 1.0]])
        H = np.array([[1.0, 0.0]])
        R = np.array([[0.3]])
        z = np.array([0.5])
        ref = RefLGB(m0=m0, P0=P0, H=H, R=R, z=z)
        m_r, P_r = ref.kalman_posterior()
        ours = LinearGaussianBayes.create(
            m0.astype(np.float32), P0.astype(np.float32),
            H.astype(np.float32), R.astype(np.float32), z.astype(np.float32),
        )
        m_o, P_o = ours.kalman_posterior()
        np.testing.assert_allclose(np.asarray(m_o), m_r, atol=1e-4)
        np.testing.assert_allclose(np.asarray(P_o), P_r, atol=1e-4)


class TestKernelParity:
    def test_gaspari_cohn_matches(self):
        from models.kernel_particle_filter import gaspari_cohn as ref_gc

        from particle_filters_jax.models import gaspari_cohn

        r = np.linspace(0, 2.5, 101)
        np.testing.assert_allclose(
            np.asarray(gaspari_cohn(r.astype(np.float32))), ref_gc(r), atol=1e-5
        )

    def test_localization_matrix_matches(self):
        from models.kernel_particle_filter import (
            build_localization_matrix as ref_loc,
        )

        from particle_filters_jax.models import build_localization_matrix

        np.testing.assert_allclose(
            np.asarray(build_localization_matrix(12, 3.0)),
            ref_loc(12, 3.0),
            atol=1e-5,
        )

    def test_matrix_kernel_matches(self):
        from models.kernel_particle_filter import (
            matrix_kernel_and_divergence as ref_mk,
        )

        from particle_filters_jax.models.kernel_particle_filter import (
            matrix_kernel_and_divergence,
        )

        rng = np.random.default_rng(3)
        x = rng.normal(size=3)
        ens = rng.normal(size=(7, 3))
        ell = np.abs(rng.normal(size=3)) + 0.5
        K_r, div_r = ref_mk(x, ens, ell)
        K_o, div_o = matrix_kernel_and_divergence(
            x.astype(np.float32), ens.astype(np.float32), ell.astype(np.float32)
        )
        np.testing.assert_allclose(np.asarray(K_o), K_r, atol=1e-5)
        np.testing.assert_allclose(np.asarray(div_o), div_r, atol=1e-4)


class TestSimulatorParity:
    def test_mat_constants_match(self):
        from simulator.simulator_Multi_acoustic_tracking import (
            article_initial_states as ref_init,
            article_process_noise_cov as ref_v,
            build_cv_transition as ref_f,
            make_sensor_grid as ref_grid,
        )

        from particle_filters_jax.simulators import (
            article_initial_states,
            article_process_noise_cov,
            build_cv_transition,
            make_sensor_grid,
        )

        np.testing.assert_allclose(np.asarray(build_cv_transition(1.0)), ref_f(1.0))
        np.testing.assert_allclose(
            np.asarray(article_process_noise_cov()), ref_v(), atol=1e-7
        )
        np.testing.assert_allclose(
            np.asarray(article_initial_states(4)), ref_init(4)
        )
        np.testing.assert_allclose(
            np.asarray(make_sensor_grid((40.0, 40.0), (5, 5))),
            ref_grid((40.0, 40.0), (5, 5)),
            atol=1e-5,
        )

    def test_acoustic_measurement_matches(self):
        from simulator.simulator_Multi_acoustic_tracking import (
            acoustic_measurement_model as ref_meas,
            make_sensor_grid as ref_grid,
        )

        from particle_filters_jax.simulators import acoustic_measurement_model

        rng = np.random.default_rng(5)
        P = rng.uniform(0, 40, size=(6, 4, 2))
        S = ref_grid((40.0, 40.0), (5, 5))
        np.testing.assert_allclose(
            np.asarray(
                acoustic_measurement_model(
                    P.astype(np.float32), S.astype(np.float32), 10.0, 0.1
                )
            ),
            ref_meas(P, S, 10.0, 0.1),
            rtol=1e-4,
        )

    def test_snlg_kernel_matches(self):
        from simulator.simulator_sensor_network_linear_gaussian import (
            make_grid_coords as ref_coords,
            se_kernel_cov as ref_kernel,
        )

        from particle_filters_jax.simulators import make_grid_coords, se_kernel_cov

        c_o = np.asarray(make_grid_coords(16))
        c_r = ref_coords(16)
        np.testing.assert_allclose(c_o, c_r)
        np.testing.assert_allclose(
            np.asarray(se_kernel_cov(c_o.astype(np.float32), 3.0, 20.0, 0.01)),
            ref_kernel(c_r, 3.0, 20.0, 0.01),
            atol=1e-5,
        )

    def test_l96_rhs_matches(self):
        from simulator.simulator_Lorenz_96 import l96_rhs as ref_rhs

        from particle_filters_jax.simulators import l96_rhs

        x = np.random.default_rng(7).normal(size=40)
        np.testing.assert_allclose(
            np.asarray(l96_rhs(x.astype(np.float32), F=8.0)),
            ref_rhs(x, F=8.0),
            atol=1e-4,
        )

    def test_l96_trajectory_matches(self):
        """Deterministic RK4 integration: trajectories agree to f32 accuracy
        over a short chaotic window."""
        from simulator.simulator_Lorenz_96 import l96_integrate as ref_int

        from particle_filters_jax.simulators import l96_integrate

        x0 = np.full(40, 8.0)
        x0[0] = 9.0
        ref = ref_int(x0, 0.01, 100, F=8.0)
        ours = np.asarray(l96_integrate(x0.astype(np.float32), 0.01, 100, F=8.0))
        np.testing.assert_allclose(ours, ref, atol=5e-3)
