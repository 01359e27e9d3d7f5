"""EDH/LEDH flow-filter creation/config/init archetypes — completes the
counterpart of the reference ``tests/unit_tests/models/test_edh_flow_pf.py``
(22 tests) and ``test_ledh_flow_pf.py`` (30 tests) beyond the tracking and
mechanism tests in ``tests/unit/test_flow_filters.py``.
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
)


def _system(small_system, nonlinear=False, use_ukf=False):
    s = small_system
    A, C = jnp.asarray(s["A"]), jnp.asarray(s["C"])
    Q, R = jnp.asarray(s["Q"]), jnp.asarray(s["R"])
    LQ = jnp.linalg.cholesky(Q + 1e-10 * jnp.eye(2))
    LR = jnp.linalg.cholesky(R)
    g = lambda x, u, v: A @ x + v
    if nonlinear:
        h = lambda x: jnp.array([x[0] + 0.2 * x[1] ** 2, x[1]])
        jac_h = jax.jacfwd(h)
    else:
        h = lambda x: C @ x
        jac_h = lambda x: C
    log_trans = lambda xn, xo: mvn_logpdf_chol(xn, A @ xo, LQ)
    log_like = lambda z, x: mvn_logpdf_chol(z, h(x), LR)
    noise = lambda key, n, nx: jax.random.normal(key, (n, nx)) @ LQ.T
    if use_ukf:
        filt = UnscentedKalmanFilter(lambda x, u: A @ x, h, Q, R, alpha=0.5)
    else:
        filt = ExtendedKalmanFilter(lambda x, u: A @ x, h, Q, R)
    tracker = GaussianTracker(filt)
    return dict(
        g=g, h=h, jac_h=jac_h, log_trans=log_trans, log_like=log_like,
        R=R, tracker=tracker, noise=noise,
    )


def _make(cls, cfg, sys_):
    return cls(
        sys_["tracker"], sys_["g"], sys_["h"], sys_["jac_h"],
        sys_["log_trans"], sys_["log_like"], sys_["R"], cfg,
    )


@pytest.fixture(scope="module")
def lin(small_system):
    return _system(small_system)


@pytest.fixture(scope="module")
def nonlin(small_system):
    return _system(small_system, nonlinear=True)


class TestCreation:
    def test_edh_default_config(self, lin):
        f = EDHFlowPF(
            lin["tracker"], lin["g"], lin["h"], lin["jac_h"],
            lin["log_trans"], lin["log_like"], lin["R"],
        )
        assert f.cfg.n_particles == 512 and f.cfg.n_lambda_steps == 8
        assert f.cfg.flow_integrator == "rk4"

    def test_ledh_default_config(self, lin):
        f = LEDHFlowPF(
            lin["tracker"], lin["g"], lin["h"], lin["jac_h"],
            lin["log_trans"], lin["log_like"], lin["R"],
        )
        assert f.cfg.n_particles == 512
        assert f.cfg.resample_ess_ratio == 0.0  # off by default, as upstream

    def test_edh_custom_config(self, lin):
        f = _make(EDHFlowPF, EDHConfig(n_particles=32, n_lambda_steps=3,
                                       flow_integrator="euler"), lin)
        assert f.cfg.n_particles == 32 and f.cfg.n_lambda_steps == 3

    @pytest.mark.parametrize("cls,cfg", [
        (EDHFlowPF, EDHConfig(n_particles=16)),
        (LEDHFlowPF, LEDHConfig(n_particles=16)),
    ])
    def test_with_ukf_tracker(self, small_system, key, cls, cfg):
        sys_ = _system(small_system, use_ukf=True)
        f = _make(cls, cfg, sys_)
        st = f.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = sys_["tracker"].init(jnp.zeros(2), jnp.eye(2))
        st2, ts2 = f.step(key, st, ts, jnp.array([0.5, -0.2]),
                          process_noise_sampler=sys_["noise"])
        assert np.isfinite(np.asarray(st2.mean)).all()
        assert np.isfinite(np.asarray(ts2.mean)).all()


class TestInit:
    @pytest.mark.parametrize("cls,cfg", [
        (EDHFlowPF, EDHConfig(n_particles=2048)),
        (LEDHFlowPF, LEDHConfig(n_particles=2048)),
    ])
    def test_particles_distributed_as_gaussian(self, key, lin, cls, cfg):
        f = _make(cls, cfg, lin)
        m0 = jnp.array([1.0, -2.0])
        P0 = jnp.array([[2.0, 0.3], [0.3, 0.5]])
        st = f.init_from_gaussian(key, m0, P0)
        emp_m = np.asarray(st.particles).mean(0)
        emp_P = np.cov(np.asarray(st.particles).T)
        np.testing.assert_allclose(emp_m, m0, atol=0.15)
        np.testing.assert_allclose(emp_P, P0, atol=0.25)

    @pytest.mark.parametrize("cls,cfg", [
        (EDHFlowPF, EDHConfig(n_particles=64)),
        (LEDHFlowPF, LEDHConfig(n_particles=64)),
    ])
    def test_equal_weights(self, key, lin, cls, cfg):
        st = _make(cls, cfg, lin).init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        np.testing.assert_allclose(np.asarray(st.weights), 1.0 / 64, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(st.log_weights), -np.log(64), rtol=1e-5)

    def test_deterministic_with_key(self, key, lin):
        f = _make(EDHFlowPF, EDHConfig(n_particles=32), lin)
        a = f.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        b = f.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        np.testing.assert_array_equal(np.asarray(a.particles), np.asarray(b.particles))

    def test_different_keys_differ(self, key, lin):
        f = _make(EDHFlowPF, EDHConfig(n_particles=32), lin)
        a = f.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        b = f.init_from_gaussian(jax.random.fold_in(key, 1), jnp.zeros(2), jnp.eye(2))
        assert not np.allclose(np.asarray(a.particles), np.asarray(b.particles))


class TestStepMechanics:
    @pytest.mark.parametrize("n_lambda", [1, 4, 20])
    def test_lambda_step_counts(self, key, lin, n_lambda):
        f = _make(EDHFlowPF, EDHConfig(n_particles=64, n_lambda_steps=n_lambda), lin)
        st = f.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = lin["tracker"].init(jnp.zeros(2), jnp.eye(2))
        st2, _ = f.step(key, st, ts, jnp.array([0.3, 0.1]),
                        process_noise_sampler=lin["noise"])
        assert st2.diagnostics["condition_numbers"].shape == (n_lambda,)
        assert np.isfinite(np.asarray(st2.mean)).all()

    def test_custom_process_noise_sampler_zero(self, key, lin):
        # a zero-noise sampler makes the propagated cloud the deterministic
        # image of the prior cloud
        f = _make(EDHFlowPF, EDHConfig(n_particles=32, n_lambda_steps=2), lin)
        st = f.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = lin["tracker"].init(jnp.zeros(2), jnp.eye(2))
        zero = lambda k, n, nx: jnp.zeros((n, nx))
        st2, _ = f.step(key, st, ts, jnp.array([0.0, 0.0]),
                        process_noise_sampler=zero)
        assert np.isfinite(np.asarray(st2.particles)).all()

    def test_ledh_equals_edh_under_linear_obs_per_particle(self, key, lin):
        # with a LINEAR h, LEDH's per-particle linearization is the same
        # H at every particle, so the two flows' posterior means agree closely
        kw = dict(n_particles=128, n_lambda_steps=8)
        edh = _make(EDHFlowPF, EDHConfig(flow_integrator="euler", **kw), lin)
        ledh = _make(LEDHFlowPF, LEDHConfig(**kw), lin)
        st = edh.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = lin["tracker"].init(jnp.zeros(2), jnp.eye(2))
        z = jnp.array([1.0, 0.5])
        m_edh = edh.step(key, st, ts, z, process_noise_sampler=lin["noise"])[0].mean
        m_ledh = ledh.step(key, st, ts, z, process_noise_sampler=lin["noise"])[0].mean
        np.testing.assert_allclose(np.asarray(m_edh), np.asarray(m_ledh), atol=0.3)

    def test_ledh_differs_from_edh_under_nonlinear_obs(self, key, nonlin):
        # with a curved h, per-particle linearization genuinely differs from
        # the global mean-path linearization: particle clouds must diverge
        kw = dict(n_particles=128, n_lambda_steps=8)
        edh = _make(EDHFlowPF, EDHConfig(flow_integrator="euler", **kw), nonlin)
        ledh = _make(LEDHFlowPF, LEDHConfig(**kw), nonlin)
        st = edh.init_from_gaussian(key, jnp.array([0.0, 2.0]), jnp.eye(2))
        ts = nonlin["tracker"].init(jnp.array([0.0, 2.0]), jnp.eye(2))
        z = jnp.array([3.0, 1.0])
        p_edh = edh.step(key, st, ts, z, process_noise_sampler=nonlin["noise"])[0].particles
        p_ledh = ledh.step(key, st, ts, z, process_noise_sampler=nonlin["noise"])[0].particles
        assert float(jnp.max(jnp.abs(p_edh - p_ledh))) > 1e-3

    def test_small_initial_covariance(self, key, lin):
        f = _make(LEDHFlowPF, LEDHConfig(n_particles=32), lin)
        st = f.init_from_gaussian(key, jnp.zeros(2), 1e-6 * jnp.eye(2))
        ts = lin["tracker"].init(jnp.zeros(2), 1e-6 * jnp.eye(2))
        st2, _ = f.step(key, st, ts, jnp.array([0.1, 0.0]),
                        process_noise_sampler=lin["noise"])
        assert np.isfinite(np.asarray(st2.mean)).all()
        assert np.isfinite(np.asarray(st2.log_weights)).all()

    def test_numerical_stability_large_obs(self, key, lin):
        f = _make(LEDHFlowPF, LEDHConfig(n_particles=32), lin)
        st = f.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = lin["tracker"].init(jnp.zeros(2), jnp.eye(2))
        st2, _ = f.step(key, st, ts, jnp.array([500.0, -500.0]),
                        process_noise_sampler=lin["noise"])
        assert np.isfinite(np.asarray(st2.mean)).all()

    def test_multiple_steps_ukf_tracker(self, small_system, key):
        sys_ = _system(small_system, use_ukf=True)
        f = _make(EDHFlowPF, EDHConfig(n_particles=64, n_lambda_steps=4), sys_)
        st = f.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = sys_["tracker"].init(jnp.zeros(2), jnp.eye(2))
        for i in range(3):
            st, ts = f.step(jax.random.fold_in(key, i), st, ts,
                            jnp.array([0.1 * i, -0.05 * i]),
                            process_noise_sampler=sys_["noise"])
        assert int(ts.t) == 3
        assert np.isfinite(np.asarray(st.mean)).all()

    def test_input_state_not_mutated(self, key, lin):
        f = _make(EDHFlowPF, EDHConfig(n_particles=32), lin)
        st = f.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts = lin["tracker"].init(jnp.zeros(2), jnp.eye(2))
        before = np.asarray(st.particles).copy()
        f.step(key, st, ts, jnp.array([0.4, 0.2]), process_noise_sampler=lin["noise"])
        np.testing.assert_array_equal(np.asarray(st.particles), before)
