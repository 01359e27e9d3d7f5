"""Systematic-resample gather as a Triton-route Pallas kernel.

Given the sorted child-run starts of systematic resampling (``starts[0] =
0``; particle j fills output slots [starts_j, starts_{j+1})), output row i
holds ``particles[max{j : starts_j ≤ i}]``. Each program owns a tile of
output rows × state columns: it binary-searches the starts for every row's
ancestor (the starts stay in L2 at the sizes used here) and copies the
ancestors' columns as one 2-D gather, so one kernel serves every state
width. Pure selection: for the same starts the output is bit-identical to
the plain path of ``resampling.hard.resample_values_from_starts``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 1024  # most output rows per program
TILE = 4096  # most gathered elements (rows × columns) per program
MAX_COLS = 128  # most state columns per program; wider states span several


def tile_shape(m: int, d: int) -> tuple[int, int]:
    """(rows, columns) of one program's tile for m output rows of width d:
    columns the next power of two of d (at most ``MAX_COLS``), rows filling
    ``TILE`` elements (at most ``BLOCK``, at least 16)."""
    cols = min(pl.next_power_of_2(d), MAX_COLS)
    rows = min(BLOCK, max(TILE // cols, 16), pl.next_power_of_2(m))
    return rows, cols


def _kernel(starts_ref, p_ref, out_ref, *, n, m, d, blk, cols, n_iter):
    slot = pl.program_id(0) * blk + jnp.arange(blk, dtype=jnp.int32)
    col = pl.program_id(1) * cols + jnp.arange(cols, dtype=jnp.int32)
    # Invariant: starts[lo] <= slot < starts[hi], with starts[0] = 0 and
    # hi = n a virtual +inf, so lo ends as max{j : starts[j] <= slot}.
    lo = jnp.zeros((blk,), jnp.int32)
    hi = jnp.full((blk,), n, jnp.int32)

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) // 2
        s = plgpu.load(starts_ref.at[jnp.minimum(mid, n - 1)])
        right = s <= slot
        return jnp.where(right, mid, lo), jnp.where(right, hi, mid)

    lo, _ = lax.fori_loop(0, n_iter, body, (lo, hi))
    live = (slot < m)[:, None] & (col < d)[None, :]
    # Row and column indices, not a flat int32 offset: Pallas forms the
    # element offsets itself, in 64 bits once an array passes 4 GiB.
    v = plgpu.load(p_ref.at[lo[:, None], col[None, :]], mask=live, other=0.0)
    plgpu.store(out_ref.at[slot[:, None], col[None, :]], v, mask=live)


def resample_values_triton(
    starts: jax.Array, particles: jax.Array, m: int, *, interpret=False
) -> jax.Array:
    """(m, d) values ``particles[max{j : starts_j ≤ i}]`` for i < m.

    ``starts`` (N,) int32 sorted with ``starts[0] = 0``; ``particles``
    (N, d), any d. ``interpret=True`` runs the kernel in the Pallas
    interpreter (tests only).
    """
    n, d = particles.shape
    n_iter = max(int(np.ceil(np.log2(n + 1))), 1)
    blk, cols = tile_shape(m, d)
    return pl.pallas_call(
        functools.partial(_kernel, n=n, m=m, d=d, blk=blk, cols=cols,
                          n_iter=n_iter),
        grid=(pl.cdiv(m, blk), pl.cdiv(d, cols)),
        out_shape=jax.ShapeDtypeStruct((m, d), particles.dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="resample_triton",
    )(starts.astype(jnp.int32), particles)
