"""One SIR step for scalar elementwise models as a Triton-route kernel.

For x_k = g(x_{k−1}) + σ·ε with an elementwise log-likelihood, one pass over
the particle arrays does

    x' = g(x) + σ·ε → lw' = lw_in + obs_loglik(x', z)
    → per-block partials (max lw', Σe, Σe², Σe·x', Σe·x'²), e = exp(lw' − max)

where ``lw_in`` folds in the previous step's pending log-normalizer (or the
uniform weight right after a resample), so normalising the weights never
costs a pass of its own. The Gaussian draws ε come from ``jax.random``
outside the kernel, so the step matches ``ParticleFilter`` draw for draw.
``combine_partials`` turns the partials into the log-normalizer, ESS and
weighted mean and variance, across shards when given an ``axis_name``.

``fused_sir_step`` lowers the kernel on CUDA and the same arithmetic in
plain ``jnp`` everywhere else.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 4096  # particles per program
N_PARTIALS = 8  # [max, Σe, Σe², Σe·x, Σe·x², 0, 0, 0] per block
# Scalars handed to the step: observation, pending log-normalizer,
# uniform flag (1 right after a resample), noise scale σ, uniform log-weight.
SCALARS = ("z", "off", "uniform", "sigma", "uniform_logw")


def _step_math(x, eps, lw, z, off, uniform, sigma, uniform_logw, g_vec,
               obs_vec):
    x_new = g_vec(x) + sigma * eps
    lw_in = jnp.where(uniform > 0.5, uniform_logw, lw - off)
    return x_new, lw_in + obs_vec(x_new, z)


def _kernel(sc_ref, x_ref, eps_ref, lw_ref, x_out, lw_out, part_out, *, n,
            blk, g_vec, obs_vec):
    idx = pl.program_id(0) * blk + jnp.arange(blk, dtype=jnp.int32)
    live = idx < n
    z, off, uniform, sigma, uniform_logw = (
        plgpu.load(sc_ref.at[i]) for i in range(len(SCALARS))
    )
    x = plgpu.load(x_ref.at[idx], mask=live, other=0.0)
    eps = plgpu.load(eps_ref.at[idx], mask=live, other=0.0)
    lw = plgpu.load(lw_ref.at[idx], mask=live, other=0.0)
    x_new, lw_new = _step_math(x, eps, lw, z, off, uniform, sigma,
                               uniform_logw, g_vec, obs_vec)
    plgpu.store(x_out.at[idx], x_new, mask=live)
    plgpu.store(lw_out.at[idx], lw_new, mask=live)
    m = jnp.max(jnp.where(live, lw_new, -jnp.inf))
    e = jnp.where(live, jnp.exp(lw_new - m), 0.0)
    vals = (m, jnp.sum(e), jnp.sum(e * e), jnp.sum(e * x_new),
            jnp.sum(e * x_new * x_new))
    lane = jnp.arange(N_PARTIALS, dtype=jnp.int32)
    row = jnp.zeros((N_PARTIALS,), jnp.float32)
    for k, v in enumerate(vals):
        row = jnp.where(lane == k, v, row)
    plgpu.store(part_out.at[pl.program_id(0) * N_PARTIALS + lane], row)


def fused_sir_step_pallas(x, eps, lw, sc, *, g_vec, obs_vec,
                          interpret=False):
    """The kernel itself: ``(x', lw', partials (n_blocks, 8))``.
    ``interpret=True`` runs it in the Pallas interpreter (tests only)."""
    n = x.shape[0]
    blk = min(BLOCK, pl.next_power_of_2(n))
    nb = pl.cdiv(n, blk)
    x_new, lw_new, part = pl.pallas_call(
        functools.partial(_kernel, n=n, blk=blk, g_vec=g_vec,
                          obs_vec=obs_vec),
        grid=(nb,),
        out_shape=(
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((nb * N_PARTIALS,), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=8, num_stages=1),
        interpret=interpret,
        name="fused_sir_triton",
    )(sc, x, eps, lw)
    return x_new, lw_new, part.reshape(nb, N_PARTIALS)


def fused_sir_step_plain(x, eps, lw, sc, *, g_vec, obs_vec):
    """The same step in plain ``jnp``, with the kernel's block partials."""
    x_new, lw_new = _step_math(x, eps, lw, *(sc[i] for i in
                                             range(len(SCALARS))),
                               g_vec, obs_vec)
    n = x.shape[0]
    blk = min(BLOCK, pl.next_power_of_2(n))
    pad = pl.cdiv(n, blk) * blk - n
    xb = jnp.pad(x_new, (0, pad)).reshape(-1, blk)
    lb = jnp.pad(lw_new, (0, pad), constant_values=-jnp.inf).reshape(-1, blk)
    m = jnp.max(lb, axis=1, keepdims=True)
    e = jnp.exp(lb - m)
    vals = [m[:, 0], jnp.sum(e, 1), jnp.sum(e * e, 1), jnp.sum(e * xb, 1),
            jnp.sum(e * xb * xb, 1)]
    vals += [jnp.zeros_like(m[:, 0])] * (N_PARTIALS - len(vals))
    return x_new, lw_new, jnp.stack(vals, axis=1)


def fused_sir_step(x: jax.Array, eps: jax.Array, lw: jax.Array,
                   sc: jax.Array, *, g_vec: Callable, obs_vec: Callable):
    """One fused SIR step (see the module docstring); the Triton kernel on
    CUDA, plain ``jnp`` elsewhere, both returning ``(x', lw', partials
    (n_blocks, 8))``. ``x``, ``eps``, ``lw`` are (n,) float32; ``sc`` holds
    the ``SCALARS`` in order."""
    kw = dict(g_vec=g_vec, obs_vec=obs_vec)
    return lax.platform_dependent(
        x, eps, lw, sc,
        cuda=functools.partial(fused_sir_step_pallas, **kw),
        default=functools.partial(fused_sir_step_plain, **kw),
    )


def combine_partials(part: jax.Array, axis_name: Optional[str] = None):
    """``(log_z, ess, mean, var)`` of the weighted cloud from per-block
    partials, exact up to float rounding: each block's sums are rescaled
    from its own max to the global max (``pmax``/``psum`` across shards
    when ``axis_name`` is given)."""
    m_g = jnp.max(part[:, 0])
    if axis_name is not None:
        m_g = lax.pmax(m_g, axis_name)
    scale = jnp.exp(part[:, 0] - m_g)
    sums = jnp.sum(part[:, 1:5] * jnp.stack(
        [scale, scale * scale, scale, scale], axis=1), axis=0)
    if axis_name is not None:
        sums = lax.psum(sums, axis_name)
    s, s2, sx, sxx = sums[0], sums[1], sums[2], sums[3]
    mean = sx / s
    return m_g + jnp.log(s), s * s / s2, mean, sxx / s - mean * mean
