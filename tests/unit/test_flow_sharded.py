"""Sharded EDH/LEDH flow filters (parallel/flow_sharded.py).

The flow filters' per-particle work is embarrassingly parallel and their
linearization inputs (tracker mean/cov) are replicated, so with
``process_noise_sampler=None`` the sharded run is the SAME deterministic
computation as the single-device run — psum-reduced instead of locally
reduced, all_gather-resampled with the same global ancestry key — and the
trajectories must agree to float rounding. With a noise sampler, shard
streams are folded distinct and agreement is statistical.

Reference semantics being scaled: ``/root/reference/models/
EDH_particle_filter.py:182-317`` (EDH step) and
``LEDH_particle_filter.py:93-211`` (per-particle flow — the reference's
2,096 s MAT workload), which run strictly on one host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from particle_filters_jax.core.linalg import mvn_logpdf_chol
from particle_filters_jax.models import (
    EDHConfig,
    EDHFlowPF,
    ExtendedKalmanFilter,
    GaussianTracker,
    LEDHConfig,
    LEDHFlowPF,
)
from particle_filters_jax.parallel import (
    make_sharded_flow_run,
    shard_flow_state,
)


def _linear_setup(small_system):
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

    def make_tracker():
        ekf = ExtendedKalmanFilter(lambda x, u: A @ x, h, Q, R)
        return GaussianTracker(ekf)

    return g, h, jac_h, log_trans, log_like, R, make_tracker, noise_sampler


@pytest.fixture(scope="module")
def flow_parts(small_system):
    return _linear_setup(small_system)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("particles",))


class TestShardedEDH:
    def test_8shard_matches_single_device_deterministic(
        self, key, lgssm_data, flow_parts
    ):
        """No process noise ⇒ the flow is deterministic given the shared
        init cloud; 8 shards must reproduce the single-device trajectory
        (incl. identical global resample ancestry) to float rounding."""
        g, h, jh, lt, ll, R, mk_tracker, _ = flow_parts
        cfg = EDHConfig(n_particles=256, n_lambda_steps=5)
        zs = lgssm_data.Y[:20]

        tr1 = mk_tracker()
        edh1 = EDHFlowPF(tr1, g, h, jh, lt, ll, R, cfg)
        st0 = edh1.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts0 = tr1.init(jnp.zeros(2), jnp.eye(2))
        _, _, h1 = jax.jit(lambda k, s, t: edh1.run(k, s, t, zs))(
            key, st0, ts0
        )

        trs = mk_tracker()
        edhs = EDHFlowPF(
            trs, g, h, jh, lt, ll, R, cfg, axis_name="particles"
        )
        mesh = _mesh(8)
        sts = shard_flow_state(st0, mesh)
        run = make_sharded_flow_run(edhs, mesh)
        final_s, _, hs = run(key, sts, ts0, zs)

        np.testing.assert_allclose(
            np.asarray(h1["mean"]), np.asarray(hs["mean"]),
            rtol=2e-3, atol=2e-4,
        )
        np.testing.assert_allclose(
            np.asarray(h1["ess"]), np.asarray(hs["ess"]), rtol=2e-3
        )
        np.testing.assert_array_equal(
            np.asarray(h1["resampled"]), np.asarray(hs["resampled"])
        )
        np.testing.assert_allclose(
            np.asarray(h1["condition_numbers"]),
            np.asarray(hs["condition_numbers"]),
            rtol=1e-3,
        )
        # the final cloud itself agrees (same ancestry, same flow)
        assert final_s.particles.shape == (256, 2)

    def test_8shard_with_noise_tracks(self, key, lgssm_data, flow_parts):
        """Distinct per-shard noise streams: the sharded run is a different
        MC draw of the same filter — finite, normalized, tracking."""
        g, h, jh, lt, ll, R, mk_tracker, ns = flow_parts
        cfg = EDHConfig(n_particles=256, n_lambda_steps=5)
        zs = lgssm_data.Y[:20]

        trs = mk_tracker()
        edhs = EDHFlowPF(
            trs, g, h, jh, lt, ll, R, cfg, axis_name="particles"
        )
        mesh = _mesh(8)
        st0 = edhs.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts0 = trs.init(jnp.zeros(2), jnp.eye(2))
        run = make_sharded_flow_run(edhs, mesh, process_noise_sampler=ns)
        final_s, _, hs = run(key, shard_flow_state(st0, mesh), ts0, zs)

        means = np.asarray(hs["mean"])
        assert np.all(np.isfinite(means))
        rmse = float(
            np.sqrt(np.mean((means - np.asarray(lgssm_data.X[:20])) ** 2))
        )
        assert rmse < 1.5  # tracks the LGSSM truth
        # per-shard folded keys ⇒ shards drew DIFFERENT noise: the final
        # cloud's shard blocks are not identical copies
        p = np.asarray(final_s.particles).reshape(8, 32, 2)
        assert not np.allclose(p[0], p[1])


class TestShardedLEDH:
    def test_8shard_matches_single_device_deterministic(
        self, key, lgssm_data, flow_parts
    ):
        """LEDH (per-particle flow matrices): 8 shards reproduce the
        single-device trajectory without process noise."""
        g, h, jh, lt, ll, R, mk_tracker, _ = flow_parts
        # resample_ess_ratio > 0 so the cross-shard all_gather resample runs
        cfg = LEDHConfig(
            n_particles=64, n_lambda_steps=4, resample_ess_ratio=0.5
        )
        zs = lgssm_data.Y[:8]

        tr1 = mk_tracker()
        l1 = LEDHFlowPF(tr1, g, h, jh, lt, ll, R, cfg)
        st0 = l1.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts0 = tr1.init(jnp.zeros(2), jnp.eye(2))
        _, _, h1 = jax.jit(lambda k, s, t: l1.run(k, s, t, zs))(
            key, st0, ts0
        )

        trs = mk_tracker()
        ls = LEDHFlowPF(
            trs, g, h, jh, lt, ll, R, cfg, axis_name="particles"
        )
        mesh = _mesh(8)
        run = make_sharded_flow_run(ls, mesh)
        _, _, hs = run(key, shard_flow_state(st0, mesh), ts0, zs)

        np.testing.assert_allclose(
            np.asarray(h1["mean"]), np.asarray(hs["mean"]),
            rtol=2e-3, atol=2e-4,
        )
        np.testing.assert_allclose(
            np.asarray(h1["ess"]), np.asarray(hs["ess"]), rtol=2e-3
        )
        np.testing.assert_array_equal(
            np.asarray(h1["resampled"]), np.asarray(hs["resampled"])
        )

    def test_ledh_cond_diagnostic_is_pmax_over_shards(
        self, key, lgssm_data, flow_parts
    ):
        """The sharded representative-particle cond(S) is the pmax over
        each shard's first particle — replicated, finite, ≥ the
        single-device shard-0 value by construction."""
        g, h, jh, lt, ll, R, mk_tracker, _ = flow_parts
        cfg = LEDHConfig(n_particles=64, n_lambda_steps=4)
        zs = lgssm_data.Y[:4]

        trs = mk_tracker()
        ls = LEDHFlowPF(
            trs, g, h, jh, lt, ll, R, cfg, axis_name="particles"
        )
        mesh = _mesh(8)
        st0 = ls.init_from_gaussian(key, jnp.zeros(2), jnp.eye(2))
        ts0 = trs.init(jnp.zeros(2), jnp.eye(2))
        run = make_sharded_flow_run(ls, mesh)
        _, _, hs = run(key, shard_flow_state(st0, mesh), ts0, zs)
        conds = np.asarray(hs["condition_numbers"])
        assert conds.shape == (4, cfg.n_lambda_steps)
        assert np.all(np.isfinite(conds)) and np.all(conds >= 1.0)
