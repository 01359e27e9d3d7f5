"""SIR particle filter with a fused propagate + weight step, for scalar
elementwise models.

For models of the form

    x_k = g(x_{k−1}) + w,  w ~ N(0, σ²),   log p(z_k | x_k) = ℓ(x_k, z_k)

with a scalar state and a scalar observation, where ``g`` and ``ℓ`` act
elementwise on an array of particle states, each filter step is ONE pass
over the particles (``ops/fused_sir_triton.py``, a Triton kernel on CUDA):
propagate, weight, and per-block partials from which the log-normalizer,
ESS and weighted moments follow. Weight normalisation is lazy — two carried
scalars instead of a pass over the weights — and only resampling steps
touch the particles again.

Everything else is ``ParticleFilter``'s: constructor options, key stream
and Gaussian draws (so the two filters agree draw for draw), the resample
branch (single device, all_gather or neighbor exchange), the history schema
of ``run``, and sharding through ``parallel.make_sharded_pf_run``. Moments
in the history are those of the weighted cloud after any resample, as in
``ParticleFilter``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from particle_filters_jax.core.weights import weighted_mean_cov
from particle_filters_jax.models.particle_filter import ParticleFilter, PFState
from particle_filters_jax.ops.fused_sir_triton import (
    combine_partials,
    fused_sir_step,
)


class FusedSIRFilter(ParticleFilter):
    """SIR filter for scalar elementwise models with a fused step.

    ``g_vec(x)`` maps an array of states elementwise; ``obs_loglik_vec(x,
    z)`` maps an array of states and a scalar observation to per-particle
    log-likelihoods. ``Q`` is the 1×1 process-noise covariance. Keyword
    arguments are ``ParticleFilter``'s. Observations are (T, 1); controls
    and ``track_degeneracy`` are not supported.
    """

    def __init__(
        self, g_vec: Callable, obs_loglik_vec: Callable, Q, **kwargs
    ) -> None:
        Q = jnp.atleast_2d(jnp.asarray(Q, jnp.float32))
        if Q.shape != (1, 1):
            raise ValueError("FusedSIRFilter needs a scalar state (1x1 Q).")
        super().__init__(
            lambda x, u: g_vec(x),
            None,
            Q,
            None,
            obs_loglik=lambda x, z: obs_loglik_vec(x[0], z[0]),
            **kwargs,
        )
        self.g_vec = g_vec
        self.obs_loglik_vec = obs_loglik_vec

    def _run_with_keys(self, state0, keys, zs, us_seq, track_degeneracy=False):
        if track_degeneracy:
            raise ValueError("FusedSIRFilter does not track degeneracy.")
        if us_seq.shape[-1]:
            raise ValueError("FusedSIRFilter takes no controls.")
        if zs.ndim != 2 or zs.shape[1] != 1:
            raise ValueError("FusedSIRFilter takes (T, 1) observations.")
        n_local = state0.particles.shape[0]
        n_total = self._total_n(state0.particles)
        log_unif = -jnp.log(jnp.float32(n_total))
        sigma = self.Lq[0, 0].astype(jnp.float32)

        def body(carry, inputs):
            x, lw, off, uni = carry
            k, z = inputs
            k_pred, k_upd = jax.random.split(k)
            eps = jax.random.normal(
                self._shard_key(k_pred), (n_local, 1), jnp.float32
            )[:, 0]
            sc = jnp.stack([z[0], off, uni, sigma, log_unif])
            x, lw, part = fused_sir_step(
                x, eps, lw, sc,
                g_vec=self.g_vec, obs_vec=self.obs_loglik_vec,
            )
            log_z, ess, mean, var = combine_partials(part, self.axis_name)
            trig = ess < self.resample_thresh * n_total

            def do_resample(op):
                k_r, x_r, lw_r = op
                p_new, lw_u, ok = self._resample(k_r, x_r[:, None], lw_r - log_z)
                m_u, c_u = weighted_mean_cov(p_new, lw_u, self.axis_name)
                return p_new[:, 0], ok, m_u, c_u

            def no_resample(op):
                return op[1], jnp.asarray(True), mean[None], var.reshape(1, 1)

            x, ok, m_out, c_out = lax.cond(
                trig, do_resample, no_resample, (k_upd, x, lw)
            )
            off = jnp.where(trig, 0.0, log_z)
            uni = jnp.where(trig, 1.0, 0.0)
            out = {
                "mean": m_out,
                "cov": c_out,
                "ess": ess,
                "resampled": trig,
                "log_evidence": log_z,
                "exchange_ok": ok,
            }
            return (x, lw, off, uni), out

        carry0 = (
            state0.particles[:, 0].astype(jnp.float32),
            state0.log_weights.astype(jnp.float32),
            jnp.float32(0.0),
            jnp.float32(0.0),
        )
        (x, lw, off, uni), hist = lax.scan(body, carry0, (keys, zs))
        final = PFState(
            particles=x[:, None],
            log_weights=jnp.where(uni > 0.5, log_unif, lw - off),
            mean=hist["mean"][-1],
            cov=hist["cov"][-1],
            t=state0.t + zs.shape[0],
        )
        return final, hist
