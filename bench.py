#!/usr/bin/env python
"""Benchmark: SIR particle filter on the 1-D stochastic-volatility model.

North-star metric (BASELINE.json): particle-steps/sec/chip at N≈1e6.
Reference baseline: CPU NumPy SIR PF ≈ 2×10⁵ particle-steps/s
(BASELINE.md — 10.24 ms/step at Np≈2000, EKF_UKF_PF_comparison.ipynb).

Times the generic ``ParticleFilter.run`` — one jitted ``lax.scan`` over
T = 200 steps at N = 2²⁰ particles (α = 0.95, σ = 0.2, β = 1, ESS-triggered
systematic resampling at 0.5·N) — with ``jax.block_until_ready`` after a
warm-up run of the same shape. Needs a GPU: on any other backend it exits
non-zero without printing a result.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "extras": {...}}
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

from particle_filters_jax.utils.device import (
    device_summary,
    enable_compile_cache,
    query_cards,
    require_gpu,
)

BASELINE_PARTICLE_STEPS_PER_SEC = 2.0e5  # reference CPU SIR PF (BASELINE.md)

N_PARTICLES = 1 << 20
N_STEPS = 200
ALPHA, SIGMA, BETA = 0.95, 0.2, 1.0
N_TIMED = 5


def make_sv_filter(n_particles: int, **kwargs):
    """The north-star SIR filter on the SV model (shared with
    ``chip_smoke.py`` and ``__graft_entry__.py``)."""
    from particle_filters_jax.models.particle_filter import ParticleFilter

    def obs_loglik(x, z):
        var = BETA**2 * jnp.exp(x[0])
        return -0.5 * (z[0] ** 2 / var + jnp.log(var))

    return ParticleFilter(
        lambda x, u: ALPHA * x,
        None,
        Q=jnp.array([[SIGMA**2]], jnp.float32),
        R=None,
        Np=n_particles,
        resample_thresh=0.5,
        resample_method="systematic",
        obs_loglik=obs_loglik,
        **kwargs,
    )


def make_sv_fused_filter(n_particles: int, **kwargs):
    """The same filter as ``FusedSIRFilter`` (fused Triton step on GPUs)."""
    from particle_filters_jax.models import FusedSIRFilter

    def obs_loglik(x, z):
        var = BETA**2 * jnp.exp(x)
        return -0.5 * (z * z / var + jnp.log(var))

    return FusedSIRFilter(
        lambda x: ALPHA * x,
        obs_loglik,
        Q=jnp.array([[SIGMA**2]], jnp.float32),
        Np=n_particles,
        resample_thresh=0.5,
        **kwargs,
    )


def sv_prior():
    """Stationary prior of the SV state: N(0, σ²/(1−α²))."""
    return (
        jnp.zeros(1, jnp.float32),
        jnp.array([[SIGMA**2 / (1 - ALPHA**2)]], jnp.float32),
    )


def main() -> None:
    require_gpu()
    enable_compile_cache()
    cards = query_cards()

    from particle_filters_jax.simulators.stochastic_volatility import (
        simulate_sv_1d,
    )

    sv = simulate_sv_1d(N_STEPS, ALPHA, SIGMA, BETA, seed=42)
    zs = jnp.asarray(sv.Y[:, None], jnp.float32)
    pf = make_sv_filter(N_PARTICLES)
    state0 = pf.initialize(jax.random.key(0, impl="rbg"), *sv_prior())
    run = jax.jit(lambda k, s: pf.run(k, s, zs))
    keys = [jax.random.key(2 + i, impl="rbg") for i in range(N_TIMED + 1)]

    t0 = time.perf_counter()
    jax.block_until_ready(run(keys[0], state0))  # compile + warm-up
    compile_and_first_s = time.perf_counter() - t0

    times = []
    for k in keys[1:]:
        t0 = time.perf_counter()
        _, hist = jax.block_until_ready(run(k, state0))
        times.append(time.perf_counter() - t0)
    best = min(times)

    particle_steps_per_sec = N_PARTICLES * N_STEPS / best
    rmse = float(jnp.sqrt(jnp.mean((hist["mean"][:, 0] - sv.X) ** 2)))
    resample_frac = float(jnp.mean(hist["resampled"]))
    dev = device_summary()
    print(
        json.dumps(
            {
                "metric": "particle_steps_per_sec_per_chip",
                "value": particle_steps_per_sec,
                "unit": "particle-steps/s",
                "vs_baseline": particle_steps_per_sec
                / BASELINE_PARTICLE_STEPS_PER_SEC,
                "extras": {
                    "n_particles": N_PARTICLES,
                    "n_steps": N_STEPS,
                    "ms_per_step": best / N_STEPS * 1e3,
                    "run_seconds": times,
                    "compile_and_first_run_s": compile_and_first_s,
                    "sv_rmse": rmse,
                    "resample_frac": resample_frac,
                    "device_kind": dev["kind"],
                    "device_count": dev["count"],
                    "card_name": cards[0][0],
                    "card_power_limit": cards[0][1],
                },
            }
        )
    )


if __name__ == "__main__":
    main()
