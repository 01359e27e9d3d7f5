"""EDH / LEDH particle-flow filter tests.

Reproduces the reference archetypes: flow filters track on linear-Gaussian
systems (≈ KF), per-particle-linearization properties and log-det-Jacobian
tracking for LEDH (``test_ledh_flow_pf.py:503-582``), condition-number
diagnostics, and nonlinear tracking sanity
(``test_filters_snlg_simulator.py:123-267`` semantics).
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
    kalman_filter_general,
)


def _linear_setup(small_system):
    """Flow-filter ingredients for the 2-D LGSSM."""
    s = small_system
    A = jnp.asarray(s["A"])
    C = jnp.asarray(s["C"])
    Q = jnp.asarray(s["Q"])
    R = jnp.asarray(s["R"])
    LQ = jnp.linalg.cholesky(Q + 1e-10 * jnp.eye(2))
    LR = jnp.linalg.cholesky(R)

    g = lambda x, u, v: A @ x + v
    h = lambda x: C @ x
    jac_h = lambda x: C
    log_trans = lambda x_new, x_old: mvn_logpdf_chol(x_new, A @ x_old, LQ)
    log_like = lambda z, x: mvn_logpdf_chol(z, C @ x, LR)

    def noise_sampler(key, n, nx):
        return jax.random.normal(key, (n, nx)) @ LQ.T

    ekf = ExtendedKalmanFilter(lambda x, u: A @ x, h, Q, R)
    tracker = GaussianTracker(ekf)
    return g, h, jac_h, log_trans, log_like, R, tracker, noise_sampler


@pytest.fixture(scope="module")
def linear_flow(small_system):
    return _linear_setup(small_system)


def _kf_rmse(small_system, lgssm_data):
    s = small_system
    res = kalman_filter_general(
        lgssm_data.Y, s["A"], s["C"], np.eye(2, dtype=np.float32),
        s["Q"], s["R"], x0=np.zeros(2, np.float32), P0=s["Sigma"],
    )
    return float(jnp.sqrt(jnp.mean((res.x_filt - lgssm_data.X) ** 2)))


class TestEDH:
    def test_init_from_gaussian(self, key, linear_flow):
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        edh = EDHFlowPF(tracker, g, h, jh, lt, ll, R, EDHConfig(n_particles=256))
        st = edh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        assert st.particles.shape == (256, 2)
        assert np.isclose(float(jnp.sum(st.weights)), 1.0, atol=1e-4)

    @pytest.mark.parametrize("integrator", ["euler", "rk4"])
    def test_tracks_linear_system(
        self, key, small_system, lgssm_data, linear_flow, integrator
    ):
        """On the LGSSM the EDH flow must track close to the exact KF."""
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        edh = EDHFlowPF(
            tracker, g, h, jh, lt, ll, R,
            EDHConfig(n_particles=256, n_lambda_steps=8, flow_integrator=integrator),
        )
        st = edh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        zs = lgssm_data.Y[:100]
        _, _, hist = jax.jit(
            lambda k, s, t: edh.run(k, s, t, zs, process_noise_sampler=ns)
        )(jax.random.fold_in(key, 1), st, ts)
        rmse = float(jnp.sqrt(jnp.mean((hist["mean"] - lgssm_data.X[:100]) ** 2)))
        kf_rmse = _kf_rmse(small_system, lgssm_data)
        assert rmse < 2.5 * kf_rmse + 0.1

    def test_condition_numbers_finite(self, key, lgssm_data, linear_flow):
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        edh = EDHFlowPF(tracker, g, h, jh, lt, ll, R, EDHConfig(n_particles=64))
        st = edh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = edh.step(key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns)
        conds = np.asarray(st2.diagnostics["condition_numbers"])
        assert conds.shape == (8,)
        assert np.all(np.isfinite(conds)) and np.all(conds >= 1.0)

    def test_flow_moves_particles_toward_observation(self, key, linear_flow):
        """After the flow, particles concentrate near the posterior, not the
        prior: the flow migration is the whole point of EDH."""
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        edh = EDHFlowPF(tracker, g, h, jh, lt, ll, R, EDHConfig(n_particles=512))
        st = edh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        z = jnp.array([2.0, -1.0])
        st2, _ = edh.step(key, st, ts, z, process_noise_sampler=ns)
        # posterior mean pulled toward z (h = identity-ish C = I)
        assert float(jnp.linalg.norm(st2.mean - z)) < float(jnp.linalg.norm(0.0 - z))

    def test_ess_resampling_trigger(self, key, lgssm_data, linear_flow):
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        edh = EDHFlowPF(
            tracker, g, h, jh, lt, ll, R,
            EDHConfig(n_particles=128, resample_ess_ratio=2.0),  # always
        )
        st = edh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = edh.step(key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns)
        np.testing.assert_allclose(
            np.asarray(st2.weights), np.full(128, 1 / 128), atol=1e-6
        )


class TestLEDH:
    def test_tracks_linear_system(self, key, small_system, lgssm_data, linear_flow):
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        ledh = LEDHFlowPF(
            tracker, g, h, jh, lt, ll, R,
            LEDHConfig(n_particles=128, n_lambda_steps=8),
        )
        st = ledh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        zs = lgssm_data.Y[:60]
        _, _, hist = jax.jit(
            lambda k, s, t: ledh.run(k, s, t, zs, process_noise_sampler=ns)
        )(jax.random.fold_in(key, 1), st, ts)
        rmse = float(jnp.sqrt(jnp.mean((hist["mean"] - lgssm_data.X[:60]) ** 2)))
        kf_rmse = _kf_rmse(small_system, lgssm_data)
        assert rmse < 2.5 * kf_rmse + 0.1

    def test_close_to_edh_on_linear_system(self, key, lgssm_data, linear_flow):
        """For a LINEAR observation model both flows approximate the same
        Gaussian posterior, so the posterior MEANS agree closely. (The
        particle clouds differ: LEDH's drift bⁱ anchors at each particle's
        own η₀ⁱ — reference ``LEDH_particle_filter.py:163-165`` — while EDH
        anchors at the mean path η̄.)"""
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        cfg = dict(n_particles=512, n_lambda_steps=8)
        edh = EDHFlowPF(
            tracker, g, h, jh, lt, ll, R,
            EDHConfig(flow_integrator="euler", **cfg),
        )
        ledh = LEDHFlowPF(tracker, g, h, jh, lt, ll, R, LEDHConfig(**cfg))
        st = edh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        z = lgssm_data.Y[0]
        st_e, _ = edh.step(key, st, ts, z, process_noise_sampler=ns)
        st_l, _ = ledh.step(key, st, ts, z, process_noise_sampler=ns)
        np.testing.assert_allclose(
            np.asarray(st_e.mean), np.asarray(st_l.mean), atol=0.25
        )

    def test_theta_logdet_is_tracked(self, key, lgssm_data, linear_flow):
        """LEDH weights include |det(I + εA)| θ-corrections: with a linear h
        the A matrix is contraction-like, so θ < 1 (log θ < 0); weights must
        remain finite and normalized (reference ``test_ledh_flow_pf.py:503``)."""
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        ledh = LEDHFlowPF(
            tracker, g, h, jh, lt, ll, R, LEDHConfig(n_particles=64)
        )
        st = ledh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = ledh.step(key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns)
        w = np.asarray(st2.weights)
        assert np.all(np.isfinite(w))
        assert np.isclose(w.sum(), 1.0, atol=1e-4)

    def test_nonlinear_observation(self, key, small_system):
        """LEDH on a nonlinear (quadratic-norm) observation stays finite and
        reduces uncertainty."""
        s = small_system
        A = jnp.asarray(s["A"])
        Q = jnp.asarray(s["Q"])
        LQ = jnp.linalg.cholesky(Q + 1e-10 * jnp.eye(2))
        R = jnp.array([[0.1]])
        LR = jnp.linalg.cholesky(R)

        h = lambda x: jnp.array([jnp.sum(x**2)])
        jac_h = jax.jacfwd(h)
        g = lambda x, u, v: A @ x + v
        lt = lambda xn, xo: mvn_logpdf_chol(xn, A @ xo, LQ)
        ll = lambda z, x: mvn_logpdf_chol(z, h(x), LR)
        ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T

        ekf = ExtendedKalmanFilter(lambda x, u: A @ x, h, Q, R)
        tracker = GaussianTracker(ekf)
        ledh = LEDHFlowPF(tracker, g, h, jac_h, lt, ll, R, LEDHConfig(n_particles=128))
        st = ledh.init_from_gaussian(key, jnp.array([1.0, 0.5]), 0.5 * jnp.eye(2))
        ts = tracker.init(jnp.array([1.0, 0.5]), 0.5 * jnp.eye(2))
        st2, _ = ledh.step(key, st, ts, jnp.array([1.2]), process_noise_sampler=ns)
        assert np.all(np.isfinite(np.asarray(st2.mean)))
        assert np.all(np.isfinite(np.asarray(st2.particles)))


class TestLEDHBetaSchedule:
    """Custom monotone β(λ) temper schedules in the LEDH flow
    (reference ``notebooks/SPF_LEDH.ipynb``, ``LEDHFlowPF_CustomBeta``)."""

    def _ledh(self, linear_flow, n_steps=8, n=64):
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        return (
            LEDHFlowPF(
                tracker, g, h, jh, lt, ll, R,
                LEDHConfig(n_particles=n, n_lambda_steps=n_steps),
            ),
            tracker,
            ns,
        )

    def test_linear_schedule_matches_default(self, key, linear_flow, lgssm_data):
        """β = λ (uniform grid) must reproduce the default path exactly."""
        ledh, tracker, ns = self._ledh(linear_flow)
        st = ledh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        z = lgssm_data.Y[0]
        st_def, _ = ledh.step(key, st, ts, z, process_noise_sampler=ns)
        beta_lin = jnp.linspace(0.0, 1.0, 9)
        st_lin, _ = ledh.step(
            key, st, ts, z, process_noise_sampler=ns, beta_schedule=beta_lin
        )
        np.testing.assert_allclose(
            np.asarray(st_lin.particles), np.asarray(st_def.particles),
            rtol=2e-5, atol=2e-6,
        )
        np.testing.assert_allclose(
            np.asarray(st_lin.log_weights), np.asarray(st_def.log_weights),
            rtol=1e-4, atol=5e-4,
        )

    def test_nonuniform_schedule_finite_and_distinct(self, key, linear_flow, lgssm_data):
        ledh, tracker, ns = self._ledh(linear_flow)
        st = ledh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        z = lgssm_data.Y[0]
        # quadratic ramp: slow start, fast finish; still 0 → 1 monotone
        beta = jnp.linspace(0.0, 1.0, 9) ** 2
        st_q, _ = ledh.step(
            key, st, ts, z, process_noise_sampler=ns, beta_schedule=beta
        )
        assert np.all(np.isfinite(np.asarray(st_q.particles)))
        assert np.all(np.isfinite(np.asarray(st_q.log_weights)))
        st_def, _ = ledh.step(key, st, ts, z, process_noise_sampler=ns)
        assert not np.allclose(
            np.asarray(st_q.particles), np.asarray(st_def.particles)
        )

    def test_bad_shape_raises(self, key, linear_flow, lgssm_data):
        ledh, tracker, ns = self._ledh(linear_flow)
        st = ledh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        with pytest.raises(ValueError, match="beta_schedule"):
            ledh.step(
                key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns,
                beta_schedule=jnp.linspace(0.0, 1.0, 5),
            )

    def test_run_accepts_schedule(self, key, linear_flow, lgssm_data):
        ledh, tracker, ns = self._ledh(linear_flow, n_steps=4, n=32)
        st = ledh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        beta = jnp.linspace(0.0, 1.0, 5) ** 1.5
        _, _, hist = jax.jit(
            lambda k, s, t: ledh.run(
                k, s, t, lgssm_data.Y[:10],
                process_noise_sampler=ns, beta_schedule=beta,
            )
        )(key, st, ts)
        assert hist["mean"].shape == (10, 2)
        assert np.all(np.isfinite(np.asarray(hist["mean"])))


class TestFlowArchetypes:
    """Remaining reference LEDH/EDH archetypes
    (``test_ledh_flow_pf.py:356-874``, ``test_edh_flow_pf.py``): weight
    normalization, particle evolution, sequential steps, resampling count
    preservation, covariance symmetry/PSD, extreme observations, single
    particle / single λ-step / high-dimensional edge cases."""

    def _make(self, linear_flow, cls, cfg):
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        return cls(tracker, g, h, jh, lt, ll, R, cfg), tracker, ns

    @pytest.mark.parametrize("which", ["edh", "ledh"])
    def test_step_weights_normalized(self, key, linear_flow, lgssm_data, which):
        cls, cfg = (
            (EDHFlowPF, EDHConfig(n_particles=64))
            if which == "edh"
            else (LEDHFlowPF, LEDHConfig(n_particles=64))
        )
        filt, tracker, ns = self._make(linear_flow, cls, cfg)
        st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = filt.step(key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns)
        assert np.isclose(float(jnp.sum(st2.weights)), 1.0, atol=1e-4)
        assert np.all(np.asarray(st2.weights) >= 0)

    @pytest.mark.parametrize("which", ["edh", "ledh"])
    def test_step_particles_evolve(self, key, linear_flow, lgssm_data, which):
        cls, cfg = (
            (EDHFlowPF, EDHConfig(n_particles=64))
            if which == "edh"
            else (LEDHFlowPF, LEDHConfig(n_particles=64))
        )
        filt, tracker, ns = self._make(linear_flow, cls, cfg)
        st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = filt.step(key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns)
        assert not np.allclose(np.asarray(st2.particles), np.asarray(st.particles))

    def test_sequential_steps_advance_time(self, key, linear_flow, lgssm_data):
        filt, tracker, ns = self._make(
            linear_flow, LEDHFlowPF, LEDHConfig(n_particles=32)
        )
        st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        for k in range(3):
            st, ts = filt.step(
                jax.random.fold_in(key, k), st, ts, lgssm_data.Y[k],
                process_noise_sampler=ns,
            )
            assert np.all(np.isfinite(np.asarray(st.mean)))
        assert int(ts.t) == 3

    def test_resampling_preserves_particle_count(self, key, linear_flow, lgssm_data):
        filt, tracker, ns = self._make(
            linear_flow, LEDHFlowPF,
            LEDHConfig(n_particles=48, resample_ess_ratio=1.0),  # always resample
        )
        st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = filt.step(key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns)
        assert st2.particles.shape == (48, 2)
        # resampled weights are uniform
        np.testing.assert_allclose(
            np.asarray(st2.weights), 1.0 / 48, rtol=1e-4
        )

    def test_resampling_disabled_keeps_weights(self, key, linear_flow, lgssm_data):
        filt, tracker, ns = self._make(
            linear_flow, LEDHFlowPF,
            LEDHConfig(n_particles=48, resample_ess_ratio=0.0),
        )
        st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = filt.step(key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns)
        w = np.asarray(st2.weights)
        assert w.std() > 1e-9  # non-uniform: the correction was kept

    @pytest.mark.parametrize("which", ["edh", "ledh"])
    def test_covariance_symmetric_psd(self, key, linear_flow, lgssm_data, which):
        cls, cfg = (
            (EDHFlowPF, EDHConfig(n_particles=64))
            if which == "edh"
            else (LEDHFlowPF, LEDHConfig(n_particles=64))
        )
        filt, tracker, ns = self._make(linear_flow, cls, cfg)
        st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = filt.step(key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns)
        P = np.asarray(st2.cov, np.float64)
        np.testing.assert_allclose(P, P.T, atol=1e-5)
        assert np.linalg.eigvalsh(P).min() > -1e-5

    def test_extreme_observation_stays_finite(self, key, linear_flow):
        filt, tracker, ns = self._make(
            linear_flow, LEDHFlowPF, LEDHConfig(n_particles=32)
        )
        st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = filt.step(
            key, st, ts, jnp.array([50.0, -50.0]), process_noise_sampler=ns
        )
        assert np.all(np.isfinite(np.asarray(st2.particles)))
        assert np.all(np.isfinite(np.asarray(st2.mean)))

    def test_single_particle(self, key, linear_flow, lgssm_data):
        filt, tracker, ns = self._make(
            linear_flow, LEDHFlowPF,
            LEDHConfig(n_particles=1, resample_ess_ratio=0.0),
        )
        st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = filt.step(key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns)
        assert st2.particles.shape == (1, 2)
        assert np.isclose(float(st2.weights[0]), 1.0, atol=1e-5)

    def test_single_lambda_step(self, key, linear_flow, lgssm_data):
        filt, tracker, ns = self._make(
            linear_flow, LEDHFlowPF,
            LEDHConfig(n_particles=32, n_lambda_steps=1),
        )
        st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = filt.step(key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns)
        assert np.all(np.isfinite(np.asarray(st2.particles)))
        assert st2.diagnostics["condition_numbers"].shape == (1,)

    def test_high_dimensional_state(self, key):
        """nx = 16 linear system (reference ``test_high_dimensional_state``)."""
        nx = 16
        A = 0.9 * jnp.eye(nx)
        Q = 0.1 * jnp.eye(nx)
        R = 0.5 * jnp.eye(nx)
        LQ = jnp.linalg.cholesky(Q)
        g = lambda x, u, v: A @ x + v
        h = lambda x: x
        jh = lambda x: jnp.eye(nx)
        lt = lambda xn, xo: mvn_logpdf_chol(xn, A @ xo, LQ)
        ll = lambda z, x: mvn_logpdf_chol(z, x, jnp.linalg.cholesky(R))
        ns = lambda k, n, d: jax.random.normal(k, (n, d)) @ LQ.T
        ekf = ExtendedKalmanFilter(lambda x, u: A @ x, h, Q, R)
        tracker = GaussianTracker(ekf)
        filt = LEDHFlowPF(tracker, g, h, jh, lt, ll, R, LEDHConfig(n_particles=32))
        st = filt.init_from_gaussian(key, jnp.zeros(nx), jnp.eye(nx))
        ts = tracker.init(jnp.zeros(nx), jnp.eye(nx))
        st2, _ = filt.step(
            key, st, ts, 0.3 * jnp.ones(nx), process_noise_sampler=ns
        )
        assert st2.particles.shape == (32, nx)
        assert np.all(np.isfinite(np.asarray(st2.particles)))

    def test_euler_rk4_agree_on_linear(self, key, linear_flow, lgssm_data):
        """On a linear-Gaussian model the EDH flow is affine in η, so Euler
        and RK4 integrate the same ODE closely (reference's integrator
        cross-check)."""
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        means = {}
        for integ in ("euler", "rk4"):
            filt = EDHFlowPF(
                tracker, g, h, jh, lt, ll, R,
                EDHConfig(n_particles=128, n_lambda_steps=16,
                          flow_integrator=integ, resample_ess_ratio=0.0),
            )
            st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
            ts = tracker.init(jnp.zeros(2), jnp.eye(2))
            st2, _ = filt.step(
                key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns
            )
            means[integ] = np.asarray(st2.mean)
        np.testing.assert_allclose(means["euler"], means["rk4"], atol=0.08)


class TestCondModes:
    """cond_mode="power" (default estimator) vs "eigh" (the reference's
    exact np.linalg.cond semantics) must agree on the recorded cond(S)
    trace; the particles themselves are cond-mode independent."""

    @pytest.mark.parametrize("cls,cfg_cls", [
        (EDHFlowPF, EDHConfig), (LEDHFlowPF, LEDHConfig),
    ])
    def test_power_matches_eigh(self, key, lgssm_data, linear_flow, cls, cfg_cls):
        g, h, jh, lt, ll, R, tracker, ns = linear_flow
        outs = {}
        for mode in ("power", "eigh"):
            filt = cls(
                tracker, g, h, jh, lt, ll, R,
                cfg_cls(n_particles=64, n_lambda_steps=4, cond_mode=mode),
            )
            st = filt.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
            ts = tracker.init(jnp.zeros(2), jnp.eye(2))
            st2, _ = filt.step(
                key, st, ts, lgssm_data.Y[0], process_noise_sampler=ns
            )
            outs[mode] = st2
        c_pow = np.asarray(outs["power"].diagnostics["condition_numbers"])
        c_eig = np.asarray(outs["eigh"].diagnostics["condition_numbers"])
        assert np.all(np.isfinite(c_pow)) and np.all(c_pow >= 1.0)
        np.testing.assert_allclose(c_pow, c_eig, rtol=0.05)
        # the diagnostic does not feed back into the flow
        np.testing.assert_allclose(
            np.asarray(outs["power"].particles),
            np.asarray(outs["eigh"].particles),
            atol=1e-6,
        )
