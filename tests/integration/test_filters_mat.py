"""Filters on multi-target acoustic tracking (MAT).

Reference ``tests/integration_tests/test_filters_mat_simulator.py:97-423``:
EKF/UKF on the joint 16-dim CV state with the additive acoustic measurement;
noiseless-measurement cross-check vs hand-computed sums; EDH improves over
EKF in OMAT (BASELINE: EDH 10.05 vs EKF 24.79).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.core.linalg import mvn_logpdf_chol
from particle_filters_jax.models import (
    EDHConfig,
    EDHFlowPF,
    ExtendedKalmanFilter,
    GaussianTracker,
    LEDHConfig,
    LEDHFlowPF,
    UnscentedKalmanFilter,
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_jax.simulators import (
    MATDynamicsConfig,
    MATScenarioConfig,
    acoustic_measurement_model,
    article_initial_states,
    article_process_noise_cov,
    build_cv_transition,
    simulate_acoustic_dataset,
)
from particle_filters_jax.utils.diagnostics import omat

pytestmark = pytest.mark.integration

C = 4  # targets
NX = 4 * C  # joint state [x, y, vx, vy] per target


@pytest.fixture(scope="module")
def mat():
    return simulate_acoustic_dataset(
        MATScenarioConfig(n_steps=25, seed=7), MATDynamicsConfig()
    )


def _joint_models(mat):
    sensors = mat.S
    psi, d0 = 10.0, 0.1
    F1 = build_cv_transition(1.0)
    V1 = article_process_noise_cov()
    F = jnp.kron(jnp.eye(C), F1)
    Q = jnp.kron(jnp.eye(C), V1)

    def h(x):
        pos = x.reshape(C, 4)[:, :2]
        return acoustic_measurement_model(pos[None], sensors, psi, d0)[0]

    return F, Q, h, sensors


class TestMeasurementCrossCheck:
    def test_h_matches_simulator(self, mat):
        """The filter-side measurement function reproduces the simulator's
        noiseless Z exactly (reference :97-118)."""
        F, Q, h, sensors = _joint_models(mat)
        x_joint = mat.X[0].reshape(-1)
        np.testing.assert_allclose(
            np.asarray(h(x_joint)), np.asarray(mat.Z[0]), rtol=1e-5
        )


class TestEKFOnMAT:
    def test_runs_and_omat_reasonable(self, mat, key):
        F, Q, h, sensors = _joint_models(mat)
        R = 0.01 * jnp.eye(sensors.shape[0])
        ekf = ExtendedKalmanFilter(
            lambda x, u: F @ x, h, Q, R, joseph=True, jitter=1e-5
        )
        x0 = article_initial_states(C).reshape(-1)
        # Slightly perturbed init (filters don't get the exact truth).
        x0 = x0 + 0.5 * jax.random.normal(key, x0.shape)
        st = make_ekf_state(x0, 1.0 * jnp.eye(NX))
        noise = 0.1 * jax.random.normal(key, mat.Z.shape)
        _, means, _ = ekf.run(st, mat.Z + noise)
        assert np.all(np.isfinite(np.asarray(means)))
        est_pos = np.asarray(means[-1]).reshape(C, 4)[:, :2]
        true_pos = np.asarray(mat.P[-1])
        o = omat(est_pos, true_pos)
        assert o < 30.0  # reference EKF avg OMAT ≈ 25


class TestEDHOnMAT:
    def test_edh_tracks_better_than_prior(self, mat, key):
        F, Q, h, sensors = _joint_models(mat)
        nz = sensors.shape[0]
        R = 0.01 * jnp.eye(nz)
        LR = 0.1 * jnp.eye(nz)
        LQ = jnp.linalg.cholesky(Q + 1e-8 * jnp.eye(NX))
        jac_h = jax.jacfwd(h)

        g = lambda x, u, v: F @ x + v
        lt = lambda xn, xo: mvn_logpdf_chol(xn, F @ xo, LQ)
        ll = lambda z, x: mvn_logpdf_chol(z, h(x), LR)
        ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T

        ekf = ExtendedKalmanFilter(lambda x, u: F @ x, h, Q, R, jitter=1e-5)
        tracker = GaussianTracker(ekf)
        edh = EDHFlowPF(
            tracker, g, h, jac_h, lt, ll, R,
            EDHConfig(n_particles=128, flow_integrator="euler"),
        )
        x0 = article_initial_states(C).reshape(-1) + 0.5 * jax.random.normal(
            key, (NX,)
        )
        st = edh.init_from_gaussian(key, x0, 1.0 * jnp.eye(NX))
        ts = tracker.init(x0, 1.0 * jnp.eye(NX))
        noise = 0.1 * jax.random.normal(key, mat.Z.shape)
        _, _, hist = jax.jit(
            lambda k, s, t: edh.run(k, s, t, mat.Z + noise, process_noise_sampler=ns)
        )(jax.random.fold_in(key, 1), st, ts)
        means = np.asarray(hist["mean"])
        assert np.all(np.isfinite(means))
        est_pos = means[-1].reshape(C, 4)[:, :2]
        o_est = omat(est_pos, np.asarray(mat.P[-1]))
        # dead-reckoned prior (no measurement updates)
        x_prior = jnp.asarray(x0)
        for _ in range(mat.Z.shape[0]):
            x_prior = F @ x_prior
        o_prior = omat(
            np.asarray(x_prior).reshape(C, 4)[:, :2], np.asarray(mat.P[-1])
        )
        assert o_est < max(o_prior, 25.0) + 1e-6


class TestUKFOnMAT:
    def test_runs_and_omat_reasonable(self, mat, key):
        """UKF on the joint 16-dim CV state (reference MAT suite runs UKF
        alongside EKF; BASELINE UKF avg OMAT ≈ 29)."""
        F, Q, h, sensors = _joint_models(mat)
        R = 0.01 * jnp.eye(sensors.shape[0])
        ukf = UnscentedKalmanFilter(
            lambda x, u: F @ x, h, Q, R, alpha=0.5, jitter=1e-5
        )
        x0 = article_initial_states(C).reshape(-1) + 0.5 * jax.random.normal(
            key, (NX,)
        )
        st = make_ukf_state(x0, 1.0 * jnp.eye(NX))
        noise = 0.1 * jax.random.normal(key, mat.Z.shape)
        _, means, covs = jax.jit(lambda s, z: ukf.run(s, z))(
            st, mat.Z + noise
        )
        assert np.all(np.isfinite(np.asarray(means)))
        assert np.all(np.isfinite(np.asarray(covs)))
        est_pos = np.asarray(means[-1]).reshape(C, 4)[:, :2]
        o = omat(est_pos, np.asarray(mat.P[-1]))
        assert o < 35.0  # reference UKF avg OMAT ≈ 29


class TestLEDHOnMAT:
    def test_ledh_runs_on_joint_state(self, mat, key):
        """LEDH on the joint 16-dim MAT state: per-particle linearization
        with 25-dim observations stays finite and tracks no worse than the
        dead-reckoned prior (reference LEDH avg OMAT ≈ 10.7)."""
        F, Q, h, sensors = _joint_models(mat)
        nz = sensors.shape[0]
        R = 0.01 * jnp.eye(nz)
        LR = 0.1 * jnp.eye(nz)
        LQ = jnp.linalg.cholesky(Q + 1e-8 * jnp.eye(NX))
        jac_h = jax.jacfwd(h)

        g = lambda x, u, v: F @ x + v
        lt = lambda xn, xo: mvn_logpdf_chol(xn, F @ xo, LQ)
        ll = lambda z, x: mvn_logpdf_chol(z, h(x), LR)
        ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T

        ekf = ExtendedKalmanFilter(lambda x, u: F @ x, h, Q, R, jitter=1e-5)
        tracker = GaussianTracker(ekf)
        ledh = LEDHFlowPF(
            tracker, g, h, jac_h, lt, ll, R,
            LEDHConfig(n_particles=64, n_lambda_steps=4,
                       resample_ess_ratio=0.5),
        )
        x0 = article_initial_states(C).reshape(-1) + 0.5 * jax.random.normal(
            key, (NX,)
        )
        st = ledh.init_from_gaussian(key, x0, 1.0 * jnp.eye(NX))
        ts = tracker.init(x0, 1.0 * jnp.eye(NX))
        noise = 0.1 * jax.random.normal(key, mat.Z[:10].shape)
        _, _, hist = jax.jit(
            lambda k, s, t: ledh.run(
                k, s, t, mat.Z[:10] + noise, process_noise_sampler=ns
            )
        )(jax.random.fold_in(key, 1), st, ts)
        means = np.asarray(hist["mean"])
        assert np.all(np.isfinite(means))
        est_pos = means[-1].reshape(C, 4)[:, :2]
        o_est = omat(est_pos, np.asarray(mat.P[9]))
        x_prior = jnp.asarray(x0)
        for _ in range(10):
            x_prior = F @ x_prior
        o_prior = omat(
            np.asarray(x_prior).reshape(C, 4)[:, :2], np.asarray(mat.P[9])
        )
        assert o_est < max(o_prior, 25.0) + 1e-6


class TestTrackerNoAliasing:
    @pytest.mark.slow
    def test_shared_tracker_object_cannot_alias_state(self, mat, key):
        """Regression for the reference's aliasing bug
        (``test_filters_mat_simulator.py:415-423``): there, EDH and LEDH
        sharing one stateful EKFTracker silently corrupt each other's
        companion state. Here tracker state is an explicit pytree, so two
        flow filters built on the SAME GaussianTracker object interleaved
        step-by-step produce bitwise the same trajectory as a solo run."""
        F, Q, h, sensors = _joint_models(mat)
        nz = sensors.shape[0]
        R = 0.01 * jnp.eye(nz)
        LR = 0.1 * jnp.eye(nz)
        LQ = jnp.linalg.cholesky(Q + 1e-8 * jnp.eye(NX))
        jac_h = jax.jacfwd(h)
        g = lambda x, u, v: F @ x + v
        lt = lambda xn, xo: mvn_logpdf_chol(xn, F @ xo, LQ)
        ll = lambda z, x: mvn_logpdf_chol(z, h(x), LR)
        ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T

        ekf = ExtendedKalmanFilter(lambda x, u: F @ x, h, Q, R, jitter=1e-5)
        tracker = GaussianTracker(ekf)  # ONE object, shared by both filters
        cfg = EDHConfig(n_particles=64, flow_integrator="euler")
        edh_a = EDHFlowPF(tracker, g, h, jac_h, lt, ll, R, cfg)
        edh_b = EDHFlowPF(tracker, g, h, jac_h, lt, ll, R, cfg)

        x0 = article_initial_states(C).reshape(-1)
        zs = mat.Z[:5] + 0.1 * jax.random.normal(key, mat.Z[:5].shape)

        def run_steps(filt, tag):
            st = filt.init_from_gaussian(key, x0, jnp.eye(NX))
            ts = tracker.init(x0, jnp.eye(NX))
            means = []
            for t in range(zs.shape[0]):
                k = jax.random.fold_in(key, 1000 * tag + t)
                st, ts = filt.step(k, st, ts, zs[t],
                                   process_noise_sampler=ns)
                means.append(np.asarray(st.mean))
            return np.stack(means)

        solo = run_steps(edh_a, tag=1)

        # interleaved: same steps for edh_a, with edh_b stepping in between
        st_a = edh_a.init_from_gaussian(key, x0, jnp.eye(NX))
        ts_a = tracker.init(x0, jnp.eye(NX))
        st_b = edh_b.init_from_gaussian(jax.random.fold_in(key, 5), x0,
                                        jnp.eye(NX))
        ts_b = tracker.init(x0, jnp.eye(NX))
        means_a = []
        for t in range(zs.shape[0]):
            k_a = jax.random.fold_in(key, 1000 * 1 + t)
            k_b = jax.random.fold_in(key, 1000 * 2 + t)
            st_a, ts_a = edh_a.step(k_a, st_a, ts_a, zs[t],
                                    process_noise_sampler=ns)
            st_b, ts_b = edh_b.step(k_b, st_b, ts_b, zs[t],
                                    process_noise_sampler=ns)
            means_a.append(np.asarray(st_a.mean))
        interleaved = np.stack(means_a)

        np.testing.assert_array_equal(solo, interleaved)
