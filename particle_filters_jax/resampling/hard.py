"""Hard (index-producing) resampling: systematic, multinomial, stratified, residual.

The reference's systematic resampler is an O(N) *sequential* CDF walk
(``models/particle_filter.py:146-171``) — a Python while-loop that cannot
vectorize. Here both the CDF (cumsum of weights) and the systematic
positions (u + i)/N are sorted, so ancestors are an inverse-CDF lookup. The
systematic path computes each ancestor's child-run start once and turns the
starts into ancestors with an integer scatter + prefix sum (O(N), no
search); the other methods use ``searchsorted`` of sorted queries into the
sorted CDF.

All functions take **normalized linear weights or log-weights** — pass
``logw=`` to stay in the log domain end to end.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from particle_filters_jax.core.block_cumsum import blocked_cumsum
from particle_filters_jax.core.weights import log_normalize
from particle_filters_jax.ops.resample_triton import resample_values_triton


def _weights_from(w: Optional[jax.Array], logw: Optional[jax.Array]) -> jax.Array:
    if (w is None) == (logw is None):
        raise ValueError("Pass exactly one of w= or logw=.")
    if logw is not None:
        logw_n, _ = log_normalize(logw)
        return jnp.exp(logw_n)
    return w / jnp.sum(w)


def _inverse_cdf(cdf: jax.Array, positions: jax.Array) -> jax.Array:
    """idx[i] = smallest j with positions[i] < cdf[j] (the CDF-walk invariant
    of reference ``models/particle_filter.py:160-171``)."""
    n = cdf.shape[0]
    # Guard round-off: force the final CDF entry to 1 (reference :159).
    cdf = cdf / cdf[-1]
    idx = jnp.searchsorted(cdf, positions, side="right")
    return jnp.clip(idx, 0, n - 1).astype(jnp.int32)


def _child_run_ends(
    key, weights: jax.Array, m: int, *, exact: Optional[bool] = None
) -> jax.Array:
    """t_j = #{i : (u + i)/M < cdf_j} = ⌈M·cdf_j − u⌉ — the END (exclusive)
    of each ancestor's child run under systematic resampling with M
    positions (u + i)/M. The ONE definition of the inverse-CDF convention:
    ``_systematic_starts`` (used by the Pallas/scatter value paths) and
    ``systematic_counts`` both derive from it, so the three stay
    bit-identical for the same key.

    Past N = 2^24 the f32 product M·cdf loses unit spacing, so the run
    ends are computed by the exact quantized-integer path
    (``resampling/exact.py``: 3-limb int32 cumsum + exact integer
    division) — bit-identical across backends and oracle-tested at
    N = 2^25. ``exact=True/False`` forces either path (testing).
    """
    from particle_filters_jax.resampling.exact import (
        EXACT_THRESHOLD,
        exact_child_run_ends,
    )

    n = weights.shape[0]
    if exact is None:
        exact = max(n, m) > EXACT_THRESHOLD
    if exact:
        return exact_child_run_ends(key, weights, m)
    cdf = blocked_cumsum(weights)
    cdf = cdf / cdf[-1]
    u = jax.random.uniform(key, (), weights.dtype)
    t = jnp.clip(jnp.ceil(m * cdf - u), 0.0, m).astype(jnp.int32)
    # A parallel float prefix sum is not monotone in rounding: behind a
    # near-zero weight cdf_j can land one ulp below cdf_{j−1}, and t with
    # it. The running max restores sorted run ends (a no-op elsewhere), so
    # every slot has exactly one ancestor and counts are never negative.
    return lax.cummax(t)


def _systematic_starts(key, weights: jax.Array, m: int) -> jax.Array:
    """Start position of each ancestor's child run: start_j = t_{j−1}
    (t_{−1} = 0). Returns int32 (N,) with starts in [0, M]; particle j gets
    children at output slots [starts_j, starts_{j+1})."""
    t = _child_run_ends(key, weights, m)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), t[:-1]])


def systematic_resample(
    key: jax.Array,
    w: Optional[jax.Array] = None,
    *,
    logw: Optional[jax.Array] = None,
    num_samples: Optional[int] = None,
) -> jax.Array:
    """Systematic resampling: positions (u + i)/M with one shared u ~ U[0,1).

    Parity with reference ``_systematic_resample``
    (``models/particle_filter.py:146``); returns int32 ancestor indices.

    ``idx[i] = max{j : start_j ≤ i}`` is computed as
    ``cumsum(scatter_add(1 at start_j)) − 1``: one sorted-index scatter and
    an integer prefix sum in place of a binary search per output.
    """
    weights = _weights_from(w, logw)
    n = weights.shape[0]
    m = num_samples or n
    return _ancestors_from_starts(_systematic_starts(key, weights, m), m)


def systematic_counts(
    key: jax.Array,
    w: Optional[jax.Array] = None,
    *,
    logw: Optional[jax.Array] = None,
) -> jax.Array:
    """Per-ancestor child counts under systematic resampling with the SAME
    inverse-CDF convention (and the same ``key`` ⇒ same u) as
    ``systematic_resample``: counts_j = t_j − t_{j−1}.

    Lets diagnostics report the post-resample unique-particle fraction
    (``mean(counts > 0)``) without materializing ancestors — the cloud-
    diversity proxy of ``notebooks/particle_filter_NLNGSSM.ipynb`` phase 1.
    """
    weights = _weights_from(w, logw)
    n = weights.shape[0]
    t = _child_run_ends(key, weights, n)
    return jnp.diff(t, prepend=jnp.zeros((1,), jnp.int32))


def _ancestors_from_starts(starts: jax.Array, m: int) -> jax.Array:
    """``max{j : starts_j ≤ i}`` for i < m as the running count of run
    starts at or before each slot: scatter-add a 1 at each start (sorted
    indices; zero-count ancestors collide on one slot and are counted
    there; starts at or past ``m`` are dropped), then an exact integer
    prefix sum."""
    marks = jnp.zeros((m,), jnp.int32).at[starts].add(
        1, indices_are_sorted=True, mode="drop"
    )
    return blocked_cumsum(marks) - 1


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _select(starts, particles, m):
    out = lax.platform_dependent(
        starts, particles.reshape(particles.shape[0], -1),
        cuda=lambda s, p: resample_values_triton(s, p, m),
        default=lambda s, p: jnp.take(p, _ancestors_from_starts(s, m), axis=0),
    )
    return out.reshape((m,) + particles.shape[1:])


def _select_fwd(starts, particles, m):
    return _select(starts, particles, m), (starts, particles)


def _select_bwd(m, res, g):
    starts, particles = res
    anc = _ancestors_from_starts(starts, m)
    grad_p = jnp.zeros(particles.shape, g.dtype).at[anc].add(g)
    return None, grad_p.astype(particles.dtype)


_select.defvjp(_select_fwd, _select_bwd)


def resample_values_from_starts(
    starts: jax.Array, particles: jax.Array, m: Optional[int] = None
) -> jax.Array:
    """``m`` (default N) resampled particle values from sorted child-run
    starts: ``out[i] = particles[max{j : starts_j ≤ i}]``.

    Pure selection — the output holds the input values bit for bit, and
    for the same starts it is the same on every backend. On CUDA the
    particles, of any shape (N, ...), go through the Triton kernel of
    ``ops/resample_triton.py`` (per-row binary search + row gather);
    elsewhere the ancestors come from an integer scatter + prefix sum and
    one ``jnp.take``. The gradient with respect to ``particles`` scatters
    the cotangent back onto the ancestors.
    """
    m = particles.shape[0] if m is None else m
    return _select(starts, particles, m)


def systematic_resample_values(
    key: jax.Array,
    particles: jax.Array,
    *,
    w: Optional[jax.Array] = None,
    logw: Optional[jax.Array] = None,
) -> jax.Array:
    """Systematic resampling returning the resampled particle VALUES, with
    the same ancestry (same key ⇒ same u, same inverse-CDF convention) as
    ``systematic_resample``. See :func:`resample_values_from_starts`."""
    weights = _weights_from(w, logw)
    starts = _systematic_starts(key, weights, weights.shape[0])
    return resample_values_from_starts(starts, particles)


def stratified_resample(
    key: jax.Array,
    w: Optional[jax.Array] = None,
    *,
    logw: Optional[jax.Array] = None,
    num_samples: Optional[int] = None,
) -> jax.Array:
    """Stratified resampling: positions (uᵢ + i)/M with independent uᵢ."""
    weights = _weights_from(w, logw)
    n = weights.shape[0]
    m = num_samples or n
    u = jax.random.uniform(key, (m,), weights.dtype)
    positions = (u + jnp.arange(m, dtype=weights.dtype)) / m
    return _inverse_cdf(jnp.cumsum(weights), positions)


def multinomial_resample(
    key: jax.Array,
    w: Optional[jax.Array] = None,
    *,
    logw: Optional[jax.Array] = None,
    num_samples: Optional[int] = None,
) -> jax.Array:
    """Multinomial resampling (reference ``_multinomial_resample`` :173).

    Draws M iid uniforms, *sorts* them, and inverse-CDF maps — equivalent in
    distribution to ``rng.choice(p=w)`` but every lookup is a sorted-query
    binary search.
    """
    weights = _weights_from(w, logw)
    n = weights.shape[0]
    m = num_samples or n
    u = jnp.sort(jax.random.uniform(key, (m,), weights.dtype))
    idx_sorted = _inverse_cdf(jnp.cumsum(weights), u)
    # Sorted ancestors are exchangeable for SIR, but return a permuted
    # version so marginals match rng.choice exactly.
    return jax.random.permutation(jax.random.fold_in(key, 1), idx_sorted)


def residual_resample(
    key: jax.Array,
    w: Optional[jax.Array] = None,
    *,
    logw: Optional[jax.Array] = None,
) -> jax.Array:
    """Residual resampling: ⌊N wᵢ⌋ deterministic copies + multinomial on the
    fractional residuals. Static-shape formulation: the deterministic copy
    expansion is an inverse-CDF over the integer count cumsum; remaining
    slots are filled from the residual distribution and selected per-slot.
    """
    weights = _weights_from(w, logw)
    n = weights.shape[0]
    counts = jnp.floor(n * weights)
    n_det = jnp.sum(counts).astype(jnp.int32)  # traced scalar
    cum_counts = jnp.cumsum(counts)

    slots = jnp.arange(n, dtype=weights.dtype)
    det_idx = jnp.clip(
        jnp.searchsorted(cum_counts, slots, side="right"), 0, n - 1
    ).astype(jnp.int32)

    resid = jnp.maximum(n * weights - counts, 0.0)
    resid_cdf = jnp.cumsum(resid / jnp.maximum(jnp.sum(resid), 1e-38))
    u = jax.random.uniform(key, (n,), weights.dtype)
    multi_idx = jnp.clip(
        jnp.searchsorted(resid_cdf, u, side="right"), 0, n - 1
    ).astype(jnp.int32)

    # Slot i takes the deterministic ancestor while i < n_det, else a
    # multinomial draw from the residuals.
    i = jnp.arange(n, dtype=jnp.int32)
    return jnp.where(i < n_det, det_idx, multi_idx)


_METHODS = {
    "systematic": systematic_resample,
    "multinomial": multinomial_resample,
    "stratified": stratified_resample,
    "residual": residual_resample,
}


def resample_indices(
    method: str,
    key: jax.Array,
    w: Optional[jax.Array] = None,
    *,
    logw: Optional[jax.Array] = None,
) -> jax.Array:
    """Dispatch by method name ('systematic' | 'multinomial' | 'stratified' |
    'residual')."""
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(
            f"Unknown resample method {method!r}; expected one of {sorted(_METHODS)}."
        ) from None
    return fn(key, w, logw=logw)
