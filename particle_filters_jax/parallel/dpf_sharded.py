"""Sharded differentiable-PF training: DP over sequences × particle sharding.

Packages the mesh-parallel DPF training step: B independent sequences shard
over the ``batch`` axis (data parallelism), N particles shard over the
``particles`` axis (the SMC analog of sequence parallelism). Inside
``shard_map``: propagate/weight are local; the log-normalizer is a
pmax/psum pair; soft resampling mixes over the GLOBAL ancestor set via
``all_gather``; the loss is ``pmean`` over batch; gradients flow through
everything into the SSM parameters.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from particle_filters_jax.resampling.soft import gumbel_softmax


def sharded_soft_resample(
    key,
    particles,
    logw,
    *,
    n_particles: int,
    soft_alpha: float = 0.5,
    temperature: float = 0.5,
    axis_name: str = "particles",
):
    """Soft (Gumbel-softmax) resampling over the GLOBAL ancestor set.

    Call inside ``shard_map``: ``particles``/``logw`` are the local
    ``(n_local, d)``/``(n_local,)`` shards with globally-normalized log
    weights. Each shard computes its own ``n_local`` rows of the
    conceptual global (N, N) assignment, so the Gumbel key is folded with
    the shard index — every shard must draw a DISTINCT slice of the global
    noise or the resampled cloud degenerates to ``n_local`` distinct
    particles replicated across shards.
    """
    n_local = particles.shape[0]
    p_all = jax.lax.all_gather(particles, axis_name, axis=0, tiled=True)
    lw_all = jax.lax.all_gather(logw, axis_name, axis=0, tiled=True)
    probs = (1.0 - soft_alpha) * jnp.exp(lw_all) + soft_alpha / n_particles
    log_probs = jnp.log(probs + 1e-20)
    tiled = jnp.broadcast_to(log_probs[None, :], (n_local, n_particles))
    key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
    assign = gumbel_softmax(key, tiled, temperature)
    new_particles = assign @ p_all
    new_logw = jnp.full((n_local,), -jnp.log(float(n_particles)))
    return new_particles, new_logw


def make_sharded_dpf_train_step(
    mesh: Mesh,
    *,
    n_particles: int,
    transition_fn: Callable,  # (params, key, particles (n_local, d)) -> particles
    obs_loglik_fn: Callable,  # (params, particles (n_local, d), y) -> (n_local,)
    init_fn: Callable,  # (params, key, n_local) -> particles (n_local, d)
    loss_fn: Callable,  # (step_means (T, d), truth (T, d)) -> scalar
    soft_alpha: float = 0.5,
    gumbel_temperature: float = 0.5,
    learning_rate: float = 0.05,
):
    """Build a jitted ``train_step(params, key, ys, xs) -> (loss, params)``.

    ``ys``/``xs`` are (B, T, d_obs)/(B, T, d) batches sharded over 'batch';
    particles shard over 'particles'. The returned step performs one SGD
    update through the fully sharded differentiable filter.
    """
    n_part_axis = mesh.shape["particles"]
    if n_particles % n_part_axis != 0:
        raise ValueError("n_particles must divide the particles mesh axis.")
    n_local = n_particles // n_part_axis

    def seq_loss(params, key, y_seq, x_seq):
        kp = jax.random.fold_in(key, jax.lax.axis_index("particles"))
        particles = init_fn(params, kp, n_local)
        logw = jnp.full((n_local,), -jnp.log(float(n_particles)))

        def step(carry, y):
            particles, logw, k = carry
            k, k1, k2 = jax.random.split(k, 3)
            k1 = jax.random.fold_in(k1, jax.lax.axis_index("particles"))
            particles = transition_fn(params, k1, particles)
            logw = logw + obs_loglik_fn(params, particles, y)
            # global log-normalize (max via all_gather: pmax has no JVP)
            m = jnp.max(
                jax.lax.all_gather(
                    jax.lax.stop_gradient(jnp.max(logw)), "particles"
                )
            )
            s = jax.lax.psum(jnp.sum(jnp.exp(logw - m)), "particles")
            logw = logw - (m + jnp.log(s))
            # soft resampling over the GLOBAL ancestor set (shard-distinct
            # Gumbel rows — see sharded_soft_resample)
            particles, logw = sharded_soft_resample(
                k2,
                particles,
                logw,
                n_particles=n_particles,
                soft_alpha=soft_alpha,
                temperature=gumbel_temperature,
            )
            mean = jax.lax.psum(
                jnp.sum(jnp.exp(logw)[:, None] * particles, axis=0), "particles"
            )
            return (particles, logw, k), mean

        _, means = jax.lax.scan(step, (particles, logw, key), y_seq)
        return loss_fn(means, x_seq)

    def shard_fn(params, key, ys_shard, xs_shard):
        b_idx = jax.lax.axis_index("batch")
        keys = jax.vmap(
            lambda i: jax.random.fold_in(jax.random.fold_in(key, b_idx), i)
        )(jnp.arange(ys_shard.shape[0]))
        losses = jax.vmap(lambda k, y, x: seq_loss(params, k, y, x))(
            keys, ys_shard, xs_shard
        )
        return jax.lax.pmean(jnp.mean(losses), "batch")

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("batch", None), P("batch", None)),
        out_specs=P(),
        check_vma=False,
    )

    @jax.jit
    def train_step(params, key, ys, xs):
        loss, grads = jax.value_and_grad(lambda p: sharded(p, key, ys, xs))(
            params
        )
        new_params = jax.tree_util.tree_map(
            lambda p, g: p - learning_rate * g, params, grads
        )
        return loss, new_params

    return train_step
