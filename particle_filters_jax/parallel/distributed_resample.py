"""Memory-bounded cross-shard systematic resampling (neighbor exchange).

The all-gather resample (``models/particle_filter.py:_maybe_resample``)
replicates the FULL cloud on every device during the resample step —
exact and simple, but O(N) memory per device, which caps multi-host runs
near N ~ 1e7. This module implements the ragged-ancestry alternative
promised in ``parallel/sharded.py``: each shard materializes only its
2·radius+1 neighbor shards (ring ``ppermute``), O((2r+1)·N/S) memory.

Why neighbors suffice: under systematic resampling, output slot i draws
the ancestor with CDF cell containing (i + u)/N. Shard d owns the output
slots [d·n/S, (d+1)·n/S) — positions in ≈ [d/S, (d+1)/S) — and the global
CDF segment of shard s spans [offsets_s, offsets_{s+1}), which for a
weight imbalance bounded by a factor of (r+...) stays within r shards of
d/S. The replicated ``ok`` flag reports exactly (per call) whether every
ancestor fell inside the pool. The result is exact EITHER WAY: when the
radius is insufficient (``ok`` False) the step ``lax.cond``s into an
in-graph all_gather rescue that reproduces the exact global ancestry for
the same key — ``ok`` is a pool-sizing signal (persistent False means the
radius is too small to ever save memory), never a correctness flag.
Memory: pooled steps hold O((2r+1)·N/S) per device; a rescue step's
branch holds the full O(N) gather (XLA allocates cond branches
exclusively, so this is the rare-step peak, not the steady state).

Exactness: same key ⇒ same u ⇒ the SAME global child-start vector
t_j = ceil(N·cdf_j − u) as the all-gather path; the local output is
``resampling.hard.resample_values_from_starts`` applied to the pooled
values with the slot offset subtracted — the same selection, so the two
paths agree wherever their float32 CDFs round the same way.

Precision: below N = 2^24 the child starts are computed as
``ceil(N·cdf − u)`` in float32 exactly as ``resampling/hard.py`` does.
Past that, float32 loses unit spacing, so the starts switch to the exact
quantized-integer convention of ``resampling/exact.py`` — per-shard
3-limb int32 cumsums, exact limb offsets across shards (all_gather of
3-limb shard totals), and exact integer division — which is
bit-identical to the single-device exact path for the same key at ANY N
(tested by forcing ``exact=True`` at small N in
``tests/unit/test_sharding.py``). In exact mode the ``ok`` sufficiency
flag is itself computed from exact run ends of the pool-boundary CDF
values rather than the f32 edge heuristic.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from particle_filters_jax.core.block_cumsum import blocked_cumsum
from particle_filters_jax.resampling.exact import (
    EXACT_THRESHOLD,
    _add3,
    _coarse_int_limbs,
    _exact_int_sum3,
    _f32_exponent,
    _norm3,
    _split_f32_to_limbs3,
    clean_weights,
    exact_run_ends_from_cumsum,
    exact_u_limbs,
    weight_scale_pow2,
)


def _f32_pool_starts(
    key, particles, w_local, axis_name, radius, n_shards, d, n_total, n_local
):
    """Float32 pooled child-run starts + sufficiency flag (N <= 2^24)."""
    dtype = particles.dtype
    local_sum = jnp.sum(w_local)
    shard_sums = lax.all_gather(local_sum, axis_name)  # (S,)
    offsets = jnp.concatenate(
        [jnp.zeros((1,), dtype), jnp.cumsum(shard_sums)]
    )  # (S+1,)
    total = offsets[-1]

    # Global CDF values of MY particles (normalized to [0, 1]).
    my_cdf = (offsets[d] + blocked_cumsum(w_local)) / total

    pool_cdf = []
    for off in range(-radius, radius + 1):
        if off == 0:
            cdf = my_cdf
        else:
            perm = [(int(s), int((s - off) % n_shards)) for s in range(n_shards)]
            cdf = lax.ppermute(my_cdf, axis_name, perm)
        src = d + off
        valid = jnp.logical_and(src >= 0, src <= n_shards - 1)
        # Leading out-of-range sources get CDF 0 (never selected by the
        # strict '>' inverse-CDF since positions are > 0 w.p. 1); trailing
        # get CDF 2 (> 1 ≥ any position). Keeps the pooled CDF ascending.
        fill = jnp.where(src < 0, jnp.zeros((), dtype), jnp.full((), 2.0, dtype))
        pool_cdf.append(jnp.where(valid, cdf, fill))
    pool_cdf = jnp.concatenate(pool_cdf)

    # Same u as the single-shard/all-gather path (replicated key; drawn in
    # f32 exactly as resampling/hard.py does).
    u = jax.random.uniform(key, (), jnp.float32).astype(dtype)

    t = jnp.clip(jnp.ceil(n_total * pool_cdf - u), 0.0, n_total)
    t = lax.cummax(t)  # sorted run ends despite prefix-sum rounding
    starts_global = jnp.concatenate([jnp.zeros((1,), t.dtype), t[:-1]])

    # Sufficiency: the ancestor of my FIRST slot must not precede the pool
    # (its CDF cell would live on shard < d - radius), and the ancestor of
    # my LAST slot must not follow it. Positions of my slots: (i + u)/N.
    p_first = (d * n_local + u) / n_total
    p_last = ((d + 1) * n_local - 1 + u) / n_total
    lo_edge = offsets[jnp.maximum(d - radius, 0)] / total
    ok_lo = jnp.logical_or(d - radius <= 0, p_first >= lo_edge)
    hi_edge = offsets[jnp.minimum(d + radius + 1, n_shards)] / total
    ok_hi = jnp.logical_or(d + radius >= n_shards - 1, p_last < hi_edge)
    ok_local = jnp.logical_and(ok_lo, ok_hi)
    return starts_global, ok_local


def _exact_pool_starts(
    key, particles, w_local, axis_name, radius, n_shards, d, n_total, n_local
):
    """Exact quantized-integer pooled child-run starts (any N <= 2^27).

    Bit-identical to ``resampling.exact.exact_child_run_ends`` on the
    all-gathered weight vector for the same key: the quantization scale
    is built from a global pmax exponent and an exact integer psum
    (associative — identical for any shard layout), the limb cumsum
    telescopes across shards via exact 3-limb offsets, and u enters
    through the same ``exact_u_limbs`` convention.
    """
    # Quantize MY weights on the GLOBAL power-of-two grid (identical
    # elementwise products to the single-device path by construction).
    q = quantize_weights_limbs_global(w_local, axis_name)
    Q_local = lax.associative_scan(_add3, q)  # exact local limb cumsum

    # Exact 3-limb shard offsets: all_gather each shard's limb total and
    # exact-scan over the (small) shard axis. Every shard computes the
    # same offsets.
    my_total = tuple(l[-1] for l in Q_local)
    gathered = tuple(lax.all_gather(l, axis_name) for l in my_total)  # (S,)
    offsets_incl = lax.associative_scan(_add3, gathered)  # (S,) inclusive
    zero = tuple(jnp.zeros((1,), jnp.int32) for _ in range(3))
    offsets = tuple(
        jnp.concatenate([z, o]) for z, o in zip(zero, offsets_incl)
    )  # (S+1,) exclusive offsets; offsets[S] = Q_total
    q_total = tuple(o[-1] for o in offsets)

    my_Q = tuple(
        jnp.broadcast_to(o[d], ql.shape) + ql
        for o, ql in zip(offsets, Q_local)
    )
    my_Q = _renorm3(my_Q)

    pool_Q = [[], [], []]
    for off in range(-radius, radius + 1):
        if off == 0:
            Qs = my_Q
        else:
            perm = [(int(s), int((s - off) % n_shards)) for s in range(n_shards)]
            Qs = tuple(lax.ppermute(l, axis_name, perm) for l in my_Q)
        src = d + off
        valid = jnp.logical_and(src >= 0, src <= n_shards - 1)
        # leading invalid -> Q = 0 (t clips to 0); trailing -> Q = Q_total
        # (t = M, dropped after the slot shift)
        fill = tuple(
            jnp.where(src < 0, jnp.zeros((), jnp.int32), l) for l in q_total
        )
        for i in range(3):
            pool_Q[i].append(
                jnp.where(valid, Qs[i], jnp.broadcast_to(fill[i], Qs[i].shape))
            )
    pool_Q = tuple(jnp.concatenate(ls) for ls in pool_Q)

    u = jax.random.uniform(key, (), jnp.float32)
    U = exact_u_limbs(u, q_total)
    U = tuple(l.reshape(()) for l in U)

    t = exact_run_ends_from_cumsum(pool_Q, q_total, U, n_total)
    starts_global = jnp.concatenate([jnp.zeros((1,), t.dtype), t[:-1]])

    # Exact sufficiency: the pool's first run starts at the run end of the
    # last particle BEFORE the pool, whose cumulative mass is exactly
    # offsets[d - radius]; the pool's coverage ends at the run end of the
    # last pooled particle, offsets[d + radius + 1].
    def _t_of_offset(idx):
        Qb = tuple(o[idx].reshape(()) for o in offsets)
        return exact_run_ends_from_cumsum(Qb, q_total, U, n_total)

    t_lo = _t_of_offset(jnp.maximum(d - radius, 0))
    ok_lo = jnp.logical_or(d - radius <= 0, t_lo <= d * n_local)
    t_hi = _t_of_offset(jnp.minimum(d + radius + 1, n_shards))
    ok_hi = jnp.logical_or(
        d + radius >= n_shards - 1, t_hi >= (d + 1) * n_local
    )
    ok_local = jnp.logical_and(ok_lo, ok_hi)
    return starts_global.astype(jnp.float32), ok_local


def _renorm3(q):
    l0, l1, l2 = q
    c0 = l0 >> 15
    l0 = l0 & 32767
    l1 = l1 + c0
    c1 = l1 >> 15
    l1 = l1 & 32767
    l2 = l2 + c1
    return l0, l1, l2


def quantize_weights_limbs_global(w_local: jax.Array, axis_name: str):
    """Per-shard quantization on the GLOBAL power-of-two grid — the same
    elementwise convention as ``quantize_weights_limbs`` on the
    concatenated weight vector, bit-for-bit: the max exponent comes from
    ``pmax`` (exact) and the coarse integer total from per-shard exact
    limb sums combined with an int32 ``psum`` (integer addition is
    associative, so shard layout cannot change the value)."""
    w = clean_weights(w_local)
    mx = lax.pmax(jnp.max(w), axis_name)
    e_max = _f32_exponent(jnp.maximum(mx, jnp.float32(2.0**-40)))
    part = _exact_int_sum3(*_coarse_int_limbs(w, e_max))
    v_total = _norm3(*(lax.psum(l, axis_name) for l in part))
    scale = weight_scale_pow2(e_max, v_total)
    return _split_f32_to_limbs3(w * scale)


def neighbor_exchange_systematic_resample(
    key: jax.Array,
    particles: jax.Array,  # (n_local, d) — this shard's slice
    logw: jax.Array,  # (n_local,) globally normalized log-weights
    *,
    axis_name: str,
    radius: int = 2,
    exact: Optional[bool] = None,
):
    """Systematic resample of the global cloud, exact by construction.

    Call inside ``shard_map``. Returns ``(new_local_particles, ok)``. The
    output is ALWAYS the exact global systematic resample for this key:
    when every ancestor of this shard's output slots lies within
    ``radius`` shards (``ok`` True, the common case) it comes from the
    memory-bounded neighbor pool; otherwise (``ok`` False) the step
    ``lax.cond``s into an all_gather rescue computing the identical
    ancestry from the full cloud. ``ok`` is therefore a pool-sizing
    diagnostic — a persistently False flag means ``radius`` is too small
    to deliver the memory bound — never a correctness condition.

    ``exact`` selects the child-start arithmetic: None (default) uses
    float32 up to N = 2^24 and the exact integer convention beyond;
    True/False force either path (True is required for bit-exact ancestry
    at N > 2^24 and is what the default picks there). The rescue branch
    uses the same arithmetic (``resampling.hard._child_run_ends`` with the
    same resolved ``exact``), so forced modes stay internally consistent.
    """
    from particle_filters_jax.resampling.hard import (
        _child_run_ends,
        resample_values_from_starts,
    )

    n_local = particles.shape[0]
    n_shards = lax.axis_size(axis_name)
    d = lax.axis_index(axis_name)
    n_total = n_local * n_shards
    if exact is None:
        exact = n_total > EXACT_THRESHOLD
    dtype = particles.dtype

    w_local = jnp.exp(logw).astype(dtype)
    fn = _exact_pool_starts if exact else _f32_pool_starts
    starts_global, ok_local = fn(
        key, particles, w_local, axis_name, radius, n_shards, d, n_total,
        n_local,
    )
    # Replicated sufficiency flag: every shard computes the same value, so
    # all shards take the same lax.cond branch below (their collectives
    # stay matched).
    ok = lax.psum(ok_local.astype(jnp.int32), axis_name) == n_shards

    def _pooled(_):
        """Memory-bounded path: ±radius ring ppermute pool + gather."""
        pool_vals = []
        for off in range(-radius, radius + 1):
            if off == 0:
                vals = particles
            else:
                perm = [
                    (int(s), int((s - off) % n_shards))
                    for s in range(n_shards)
                ]
                vals = lax.ppermute(particles, axis_name, perm)
            pool_vals.append(vals)
        pool_vals = jnp.concatenate(pool_vals, axis=0)  # ((2r+1)·n_local, d)

        # Shift the global child starts into MY slot range [d·n_local,
        # (d+1)·n_local). Entries whose children all precede my range clip
        # to 0 (and are counted past there); entries whose children all
        # follow land at n_local and are dropped.
        my_slot0 = (d * n_local).astype(starts_global.dtype)
        starts = jnp.clip(starts_global - my_slot0, 0.0, n_local).astype(
            jnp.int32
        )
        return resample_values_from_starts(starts, pool_vals, n_local)

    def _rescue(_):
        """Exact all_gather fallback: full cloud, same key ⇒ same u ⇒ the
        identical global ancestry the pooled path would produce with an
        unbounded radius (and bit-identical to the all_gather
        ``distributed_resample`` mode's convention: normalized weights +
        ``_child_run_ends`` + ``resample_values_from_starts``)."""
        p_all = lax.all_gather(particles, axis_name, axis=0, tiled=True)
        w_all = lax.all_gather(w_local, axis_name, axis=0, tiled=True)
        w_all = w_all / jnp.sum(w_all)
        t = _child_run_ends(key, w_all, n_total, exact=exact)
        starts_all = jnp.concatenate([jnp.zeros((1,), jnp.int32), t[:-1]])
        vals = resample_values_from_starts(starts_all, p_all)
        return lax.dynamic_slice_in_dim(vals, d * n_local, n_local, axis=0)

    new_particles = lax.cond(ok, _pooled, _rescue, None)
    return new_particles, ok
