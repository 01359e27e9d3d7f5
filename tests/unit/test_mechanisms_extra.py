"""Second-wave mechanism & statistical tests.

Deepens coverage toward the reference's ~750-test breadth: UKF parameter
sweeps, EKF options, simulator statistics, PF likelihood paths, flow
configuration edges, DPF hyperparameter behavior.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.core.linalg import (
    chol_with_jitter,
    diag_gaussian_logpdf,
    inv_psd,
    solve_psd,
)
from particle_filters_jax.models import (
    DifferentiableParticleFilter,
    EDHConfig,
    EDHFlowPF,
    ExtendedKalmanFilter,
    GaussianTracker,
    ParticleFilter,
    UnscentedKalmanFilter,
    kalman_filter_general,
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_jax.simulators import (
    simulate_lgssm,
    simulate_lorenz96,
    simulate_sv_1d,
)


class TestLinalgExtra:
    def test_solve_and_inv_psd(self, key):
        a = jax.random.normal(key, (4, 4))
        spd = a @ a.T + 4 * jnp.eye(4)
        b = jax.random.normal(key, (4,))
        np.testing.assert_allclose(
            np.asarray(spd @ solve_psd(spd, b)), np.asarray(b), atol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(spd @ inv_psd(spd)), np.eye(4), atol=1e-3
        )

    def test_diag_gaussian_logpdf_matches_mvn(self, key):
        from particle_filters_jax.core.linalg import mvn_logpdf

        x = jax.random.normal(key, (3,))
        mean = jnp.array([0.5, -0.5, 1.0])
        var = jnp.array([0.5, 2.0, 1.5])
        got = float(diag_gaussian_logpdf(x, mean, var))
        want = float(mvn_logpdf(x, mean, jnp.diag(var)))
        assert np.isclose(got, want, rtol=1e-4)

    def test_chol_jitter_ladder_scaling(self):
        """A badly scaled near-singular matrix still factors finitely."""
        a = jnp.array([[1e6, 1e6], [1e6, 1e6]])
        L = chol_with_jitter(a, initial=1e-3)
        assert np.all(np.isfinite(np.asarray(L)))


class TestUKFSweeps:
    @pytest.mark.parametrize("kappa", [0.0, 1.0, 3.0 - 2.0])
    @pytest.mark.parametrize("beta", [0.0, 2.0])
    def test_weights_consistent(self, kappa, beta):
        ukf = UnscentedKalmanFilter(
            lambda x, u: x, lambda x: x, jnp.eye(2), jnp.eye(2),
            alpha=0.5, beta=beta, kappa=kappa,
        )
        assert np.isclose(float(jnp.sum(ukf.Wm)), 1.0, atol=1e-5)
        # Wc differs from Wm only in the 0th element
        np.testing.assert_allclose(
            np.asarray(ukf.Wc[1:]), np.asarray(ukf.Wm[1:]), atol=1e-7
        )

    def test_sigma_point_count(self):
        for nx in (1, 3, 7):
            ukf = UnscentedKalmanFilter(
                lambda x, u: x, lambda x: x, jnp.eye(nx), jnp.eye(nx), alpha=0.5
            )
            X = ukf._sigma_points(jnp.zeros(nx), jnp.eye(nx))
            assert X.shape == (2 * nx + 1, nx)

    def test_invalid_shapes_raise(self):
        with pytest.raises(ValueError):
            UnscentedKalmanFilter(
                lambda x, u: x, lambda x: x, jnp.ones((2, 3)), jnp.eye(2)
            )


class TestEKFOptions:
    def test_joseph_equals_standard_linear(self, small_system, lgssm_data):
        s = small_system
        A, C = jnp.asarray(s["A"]), jnp.asarray(s["C"])
        ms = {}
        for joseph in (False, True):
            ekf = ExtendedKalmanFilter(
                lambda x, u: A @ x, lambda x: C @ x, s["Q"], s["R"],
                joseph=joseph,
            )
            _, means, _ = ekf.run(
                make_ekf_state(np.zeros(2, np.float32), s["Sigma"]),
                lgssm_data.Y[:80],
            )
            ms[joseph] = np.asarray(means)
        np.testing.assert_allclose(ms[False], ms[True], atol=2e-3)

    def test_analytic_jacobian_override(self, key):
        A = jnp.array([[0.9, 0.1], [0.0, 0.8]])
        g = lambda x, u: A @ x
        jac = lambda x, u: A
        ekf = ExtendedKalmanFilter(g, lambda x: x, jnp.eye(2), jnp.eye(2), jac_g=jac)
        st = ekf.predict(make_ekf_state(jnp.ones(2), jnp.eye(2)))
        ekf2 = ExtendedKalmanFilter(g, lambda x: x, jnp.eye(2), jnp.eye(2))
        st2 = ekf2.predict(make_ekf_state(jnp.ones(2), jnp.eye(2)))
        np.testing.assert_allclose(np.asarray(st.cov), np.asarray(st2.cov), atol=1e-5)

    def test_q_r_validation(self):
        with pytest.raises(ValueError):
            ExtendedKalmanFilter(lambda x, u: x, lambda x: x, jnp.ones((2, 3)), jnp.eye(2))
        with pytest.raises(ValueError):
            ExtendedKalmanFilter(lambda x, u: x, lambda x: x, jnp.eye(2), jnp.ones((1, 2)))


class TestKFExtra:
    def test_loglik_decreases_for_mismatched_model(self, small_system, lgssm_data):
        """The exact log-likelihood prefers the true transition matrix."""
        s = small_system
        Q, R = s["Q"], s["R"]
        kw = dict(x0=np.zeros(2, np.float32), P0=s["Sigma"])
        ll_true = float(
            kalman_filter_general(
                lgssm_data.Y, s["A"], s["C"], np.eye(2, dtype=np.float32), Q, R, **kw
            ).loglik
        )
        A_bad = 0.2 * np.asarray(s["A"])
        ll_bad = float(
            kalman_filter_general(
                lgssm_data.Y, A_bad, s["C"], np.eye(2, dtype=np.float32), Q, R, **kw
            ).loglik
        )
        assert ll_true > ll_bad

    def test_gain_goes_to_zero_with_huge_R(self, small_system, lgssm_data):
        s = small_system
        res = kalman_filter_general(
            lgssm_data.Y[:30], s["A"], s["C"], np.eye(2, dtype=np.float32),
            s["Q"], 1e6 * np.eye(2, dtype=np.float32),
            x0=np.zeros(2, np.float32), P0=s["Sigma"],
        )
        assert float(jnp.max(jnp.abs(res.K))) < 1e-3


class TestPFLikelihoodPaths:
    def test_gaussian_hR_path_matches_custom_loglik(self, key):
        """The (h, R) Gaussian path equals an equivalent obs_loglik (up to
        the dropped constant, which cancels in normalization)."""
        Q = np.array([[0.05]], np.float32)
        R = np.array([[0.1]], np.float32)
        pf1 = ParticleFilter(lambda x, u: 0.9 * x, lambda x: x, Q, R, Np=256,
                             resample_thresh=0.0)

        def obs_ll(x, z):
            return -0.5 * (z[0] - x[0]) ** 2 / 0.1

        pf2 = ParticleFilter(lambda x, u: 0.9 * x, None, Q, None, Np=256,
                             obs_loglik=obs_ll, resample_thresh=0.0)
        st1 = pf1.initialize(key, np.zeros(1, np.float32), np.eye(1, dtype=np.float32))
        st2 = pf2.initialize(key, np.zeros(1, np.float32), np.eye(1, dtype=np.float32))
        z = jnp.array([0.7])
        k = jax.random.fold_in(key, 1)
        s1 = pf1.step(k, st1, z)
        s2 = pf2.step(k, st2, z)
        np.testing.assert_allclose(
            np.asarray(s1.weights), np.asarray(s2.weights), atol=1e-5
        )

    def test_control_input_shifts_particles(self, key):
        Q = np.array([[1e-6]], np.float32)
        pf = ParticleFilter(
            lambda x, u: x + (u if u is not None else 0.0),
            lambda x: x, Q, np.eye(1, dtype=np.float32), Np=64,
            resample_thresh=0.0,
        )
        st = pf.initialize(key, np.zeros(1, np.float32), 1e-6 * np.eye(1, dtype=np.float32))
        p = pf.predict(jax.random.fold_in(key, 1), st, u=jnp.array([5.0]))
        assert np.isclose(float(jnp.mean(p)), 5.0, atol=0.01)


class TestSimulatorStatsExtra:
    @pytest.mark.slow
    def test_lgssm_burnin_reaches_stationarity(self, small_system):
        """With burn-in, the first sample is already stationary: its variance
        across seeds matches the stationary covariance diagonal."""
        s = small_system
        firsts = []
        for seed in range(200):
            r = simulate_lgssm(
                s["A"], s["B"], s["C"], s["D"],
                0.0001 * np.eye(2, dtype=np.float32), 1, seed=seed, burn_in=200,
            )
            firsts.append(np.asarray(r.X[0]))
        emp = np.var(np.stack(firsts), axis=0)
        A, Q = np.asarray(s["A"], np.float64), np.asarray(s["Q"], np.float64)
        P = np.zeros((2, 2))
        for _ in range(500):
            P = A @ P @ A.T + Q
        np.testing.assert_allclose(emp, np.diag(P), rtol=0.35)

    def test_sv_obs_variance_tracks_state(self):
        """Var(Y | X=x) = β² eˣ: observed in binned samples."""
        r = simulate_sv_1d(200000, 0.95, 0.3, 1.0, seed=0)
        X, Y = np.asarray(r.X), np.asarray(r.Y)
        lo = (X > -1.1) & (X < -0.9)
        hi = (X > 0.9) & (X < 1.1)
        assert Y[hi].var() > 2.0 * Y[lo].var()

    def test_lorenz96_attractor_statistics(self):
        """Long-run mean/variance of L96 at F=8 match the known climate
        (mean ≈ 2.3, std ≈ 3.6)."""
        r = simulate_lorenz96(
            nx=40, spinup_steps=500, total_steps=2000, Np=1,
            obs_interval=100, seed=2,
        )
        traj = np.asarray(r.truth_traj[500:])
        assert 1.5 < traj.mean() < 3.2
        assert 2.7 < traj.std() < 4.5


class TestFlowConfigEdges:
    def _setup(self, key):
        A = jnp.asarray(np.array([[0.9, 0.0], [0.0, 0.8]], np.float32))
        Q = 0.05 * jnp.eye(2)
        R = 0.1 * jnp.eye(2)
        LQ = jnp.linalg.cholesky(Q + 1e-9 * jnp.eye(2))
        from particle_filters_jax.core.linalg import mvn_logpdf_chol

        g = lambda x, u, v: A @ x + v
        h = lambda x: x
        jh = lambda x: jnp.eye(2)
        lt = lambda xn, xo: mvn_logpdf_chol(xn, A @ xo, LQ)
        ll = lambda z, x: mvn_logpdf_chol(z, x, jnp.linalg.cholesky(R))
        ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T
        ekf = ExtendedKalmanFilter(lambda x, u: A @ x, h, Q, R)
        return GaussianTracker(ekf), g, h, jh, lt, ll, R, ns

    def test_single_lambda_step(self, key):
        tracker, g, h, jh, lt, ll, R, ns = self._setup(key)
        edh = EDHFlowPF(tracker, g, h, jh, lt, ll, R,
                        EDHConfig(n_particles=64, n_lambda_steps=1))
        st = edh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = edh.step(key, st, ts, jnp.array([0.5, -0.5]),
                          process_noise_sampler=ns)
        assert np.all(np.isfinite(np.asarray(st2.particles)))
        assert st2.diagnostics["condition_numbers"].shape == (1,)

    def test_no_noise_sampler_default(self, key):
        """Without a process-noise sampler the flow uses zero noise
        (reference default, ``EDH_particle_filter.py:200-203``)."""
        tracker, g, h, jh, lt, ll, R, ns = self._setup(key)
        edh = EDHFlowPF(tracker, g, h, jh, lt, ll, R, EDHConfig(n_particles=32))
        st = edh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = tracker.init(jnp.zeros(2), jnp.eye(2))
        st2, _ = edh.step(key, st, ts, jnp.array([0.1, 0.1]))
        assert np.all(np.isfinite(np.asarray(st2.mean)))

    def test_resampling_disabled_by_default_ledh(self, key):
        from particle_filters_jax.models import LEDHConfig

        assert LEDHConfig().resample_ess_ratio == 0.0  # reference default


class TestDPFHyperparams:
    @pytest.mark.parametrize("temperature", [0.1, 0.5, 2.0])
    def test_temperature_sweep_stable(self, key, temperature):
        def trans(k, x, p):
            return 0.9 * x + 0.3 * jax.random.normal(k, x.shape)

        def loglik(x, y, p):
            return jnp.sum(-0.5 * (y[:, None, :] - x) ** 2 / 0.25, axis=-1)

        dpf = DifferentiableParticleFilter(
            32, 1, trans, loglik, gumbel_temperature=temperature
        )
        Y = jax.random.normal(key, (2, 8, 1))
        ps, lws = dpf.filter(key, Y, jnp.zeros(1), jnp.eye(1))
        assert np.all(np.isfinite(np.asarray(ps)))

    def test_colder_assignments_lower_entropy(self, key):
        def trans(k, x, p):
            return x

        def loglik(x, y, p):
            return jnp.sum(-0.5 * (y[:, None, :] - x) ** 2, axis=-1)

        ents = {}
        for temp in (0.05, 2.0):
            dpf = DifferentiableParticleFilter(
                32, 1, trans, loglik, gumbel_temperature=temp, soft_alpha=0.0
            )
            p0, lw0 = dpf.init_particles(key, 1, jnp.zeros(1), jnp.eye(1))
            _, _, diag = dpf.step(
                key, p0, lw0, jnp.array([[2.0]]), return_diagnostics=True
            )
            ents[temp] = float(diag["assignment_entropy_mean"])
        assert ents[0.05] < ents[2.0]
