#!/usr/bin/env python
"""Million-particle SIR filtering sharded across a device mesh.

Shards the particle axis over all available devices (works identically on
several GPUs or on virtual CPU devices; run with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` to try 8-way sharding
on CPU). Weight normalization/ESS/moments are psum across devices; resampling
ancestry crosses shards via all_gather.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import time

import jax
import jax.numpy as jnp

from particle_filters_jax.models import ParticleFilter
from particle_filters_jax.parallel import (
    make_mesh,
    make_sharded_pf_run,
    shard_pf_state,
)
from particle_filters_jax.simulators import simulate_sv_1d
from particle_filters_jax.utils import rmse

N = 1_000_000
T = 200
ALPHA, SIGMA, BETA = 0.95, 0.2, 1.0

n_dev = len(jax.devices())
mesh = make_mesh(n_batch=1, n_particles=n_dev)
print(f"devices: {n_dev} × {jax.devices()[0].device_kind}; mesh {mesh.devices.shape}")

sv = simulate_sv_1d(T, ALPHA, SIGMA, BETA, seed=42)


def obs_loglik(x, z):
    var = BETA**2 * jnp.exp(x[0])
    return -0.5 * (z[0] ** 2 / var + jnp.log(var))


pf = ParticleFilter(
    lambda x, u: ALPHA * x, None,
    Q=jnp.array([[SIGMA**2]]), R=None,
    Np=N, obs_loglik=obs_loglik, axis_name="particles",
)
state0 = shard_pf_state(
    pf.initialize(
        jax.random.PRNGKey(0), jnp.zeros(1),
        jnp.array([[SIGMA**2 / (1 - ALPHA**2)]]),
    ),
    mesh,
)
run = make_sharded_pf_run(pf, mesh)

final, hist = run(jax.random.PRNGKey(1), state0, sv.Y[:, None])
jax.block_until_ready(hist["mean"])
t0 = time.perf_counter()
final, hist = run(jax.random.PRNGKey(2), state0, sv.Y[:, None])
jax.block_until_ready(hist["mean"])
dt = time.perf_counter() - t0

print(f"N={N:,} particles, T={T} steps on {n_dev} device(s):")
print(f"  {N*T/dt/1e9:.2f}e9 particle-steps/s  ({dt/T*1e3:.2f} ms/step)")
print(f"  RMSE {float(rmse(hist['mean'][:,0], sv.X)):.3f}, "
      f"resampled {float(jnp.mean(hist['resampled']))*100:.0f}% of steps")
