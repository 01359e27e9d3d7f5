"""Unified run-history schema across every filter driver (VERDICT r2 #6).

Every particle-filter ``run`` — generic ``ParticleFilter``, its sharded
form under ``parallel.make_sharded_pf_run``, ``FusedSIRFilter``, and the
EDH/LEDH flow
filters — must emit the shared
history keys ``mean / cov / ess / resampled`` with consistent shapes and
dtypes, plus ``log_evidence`` where the driver defines it (SIR paths).
One parametrized test so a future driver can't silently drop a key.
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
    FusedSIRFilter,
    GaussianTracker,
    LEDHConfig,
    LEDHFlowPF,
    ParticleFilter,
)
from particle_filters_jax.parallel import (
    make_mesh,
    make_sharded_pf_run,
    shard_pf_state,
)

T = 12
NX = 2
ALPHA, SIGMA = 0.9, 0.2

SHARED_KEYS = ("mean", "cov", "ess", "resampled")


def _zs_2d(key):
    return 0.3 * jax.random.normal(key, (T, NX))


def _zs_1d(key):
    return 0.3 * jax.random.normal(key, (T, 1))


def _sv_filter(n, axis_name=None):
    def obs_loglik(x, z):
        var = jnp.exp(x[0])
        return -0.5 * (z[0] ** 2 / var + jnp.log(var))

    return ParticleFilter(
        lambda x, u: ALPHA * x, None,
        Q=np.array([[SIGMA**2]], np.float32), R=None,
        Np=n, obs_loglik=obs_loglik, axis_name=axis_name,
    )


def _run_particle_filter(key, n=256):
    pf = _sv_filter(n)
    st = pf.initialize(key, jnp.zeros(1), jnp.array([[1.0]]))
    _, hist = pf.run(jax.random.fold_in(key, 1), st, _zs_1d(key))
    return hist, 1, True  # hist, nx, has_log_evidence


def _run_fused_sir(key, n=256):
    pf = FusedSIRFilter(
        lambda x: ALPHA * x,
        lambda x, z: -0.5 * (z * z / jnp.exp(x) + x),
        Q=np.array([[SIGMA**2]], np.float32), Np=n,
    )
    st = pf.initialize(key, jnp.zeros(1), jnp.array([[1.0]]))
    _, hist = pf.run(jax.random.fold_in(key, 1), st, _zs_1d(key))
    return hist, 1, True


def _run_sharded_sir(key, n=256):
    mesh = make_mesh(n_batch=1, n_particles=2, devices=jax.devices()[:2])
    pf = _sv_filter(n, axis_name="particles")
    st = shard_pf_state(
        pf.initialize(key, jnp.zeros(1), jnp.array([[1.0]])), mesh
    )
    _, hist = make_sharded_pf_run(pf, mesh)(
        jax.random.fold_in(key, 1), st, _zs_1d(key)
    )
    return hist, 1, True


def _flow_ingredients():
    A = jnp.asarray([[0.9, 0.1], [0.0, 0.8]], jnp.float32)
    C = jnp.eye(NX, dtype=jnp.float32)
    Q = 0.05 * jnp.eye(NX, dtype=jnp.float32)
    R = 0.1 * jnp.eye(NX, dtype=jnp.float32)
    LQ = jnp.linalg.cholesky(Q + 1e-9 * jnp.eye(NX))
    LR = jnp.linalg.cholesky(R)
    g = lambda x, u, v: A @ x + v
    h = lambda x: C @ x
    jh = lambda x: C
    lt = lambda xn, xo: mvn_logpdf_chol(xn, A @ xo, LQ)
    ll = lambda z, x: mvn_logpdf_chol(z, C @ x, LR)
    ns = lambda key, n, nx: jax.random.normal(key, (n, nx)) @ LQ.T
    tracker = GaussianTracker(ExtendedKalmanFilter(lambda x, u: A @ x, h, Q, R))
    return g, h, jh, lt, ll, R, tracker, ns


def _run_edh(key):
    g, h, jh, lt, ll, R, tracker, ns = _flow_ingredients()
    edh = EDHFlowPF(
        tracker, g, h, jh, lt, ll, R,
        EDHConfig(n_particles=64, n_lambda_steps=4),
    )
    st = edh.init_from_gaussian(key, jnp.zeros(NX), jnp.eye(NX))
    ts = tracker.init(jnp.zeros(NX), jnp.eye(NX))
    _, _, hist = edh.run(
        jax.random.fold_in(key, 1), st, ts, _zs_2d(key),
        process_noise_sampler=ns,
    )
    return hist, NX, False


def _run_ledh(key):
    g, h, jh, lt, ll, R, tracker, ns = _flow_ingredients()
    ledh = LEDHFlowPF(
        tracker, g, h, jh, lt, ll, R,
        LEDHConfig(n_particles=32, n_lambda_steps=4),
    )
    st = ledh.init_from_gaussian(key, jnp.zeros(NX), jnp.eye(NX))
    ts = tracker.init(jnp.zeros(NX), jnp.eye(NX))
    _, _, hist = ledh.run(
        jax.random.fold_in(key, 1), st, ts, _zs_2d(key),
        process_noise_sampler=ns,
    )
    return hist, NX, False


DRIVERS = {
    "particle_filter": _run_particle_filter,
    "sharded_sir": _run_sharded_sir,
    "fused_sir": _run_fused_sir,
    "edh": _run_edh,
    "ledh": _run_ledh,
}


class TestHistorySchema:
    @pytest.mark.parametrize("name", sorted(DRIVERS))
    def test_shared_schema(self, key, name):
        hist, nx, has_log_ev = DRIVERS[name](key)
        for k in SHARED_KEYS:
            assert k in hist, f"{name}.run history missing '{k}'"
        assert hist["mean"].shape == (T, nx)
        assert hist["cov"].shape == (T, nx, nx)
        assert hist["ess"].shape == (T,)
        assert hist["resampled"].shape == (T,)
        assert hist["resampled"].dtype == jnp.bool_
        assert np.all(np.isfinite(np.asarray(hist["mean"])))
        assert np.all(np.asarray(hist["ess"]) > 0)
        if has_log_ev:
            assert "log_evidence" in hist
            assert hist["log_evidence"].shape == (T,)
            assert np.all(np.isfinite(np.asarray(hist["log_evidence"])))

    def test_sharded_log_evidence_matches_generic(self, key):
        """The sharded run's per-step log-normalizer follows the generic
        ParticleFilter's incremental log-evidence convention: shards draw
        their own noise (the key is folded per shard), so particles differ,
        but on the SAME model the cumulative evidences agree closely at
        large N."""
        hist_g, _, _ = _run_particle_filter(key, n=4096)
        hist_s, _, _ = _run_sharded_sir(key, n=4096)
        tot_g = float(jnp.sum(hist_g["log_evidence"]))
        tot_s = float(jnp.sum(hist_s["log_evidence"]))
        assert abs(tot_g - tot_s) < 0.15 * abs(tot_g) + 0.25
