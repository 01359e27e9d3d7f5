"""Two-level blocked cumulative sum.

The prefix sum is computed as

    reshape (rows, 128) → 7 shifted adds along each row (within-row
    inclusive cumsum) → recursive cumsum of the 1-per-row totals →
    broadcast row offsets back

so every pass is a full-width (rows, 128) elementwise op. Used by the
systematic-resampling starts (``resampling/hard.py::_child_run_ends``) and
the ancestor-mark prefix sum. Whether it beats XLA's own ``jnp.cumsum`` on
a given backend is a measurement (ROADMAP A3), not an assumption.

Summation ORDER differs from ``jnp.cumsum`` (blocked tree vs XLA's
internal association), so floating-point results differ by O(eps) and are
not guaranteed monotone for nonnegative inputs — ``_child_run_ends``
restores sorted run ends with a running max. Integer dtypes are exact
regardless of order.
"""

from __future__ import annotations

import jax.numpy as jnp

_LANES = 128
# Below this, padding + two passes cost more than XLA's native op.
_MIN_BLOCKED = 1 << 14


def blocked_cumsum(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive cumsum of a 1-D array, blocked for large N.

    Bit-equal to ``jnp.cumsum`` for integer dtypes; O(eps)-equal for floats
    (different summation tree). Works on any backend.
    """
    n = x.shape[0]
    if n < _MIN_BLOCKED:
        return jnp.cumsum(x)
    rows = -(-n // _LANES)
    pad = rows * _LANES - n
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,), x.dtype)])
    x2 = x.reshape(rows, _LANES)
    c = x2
    for s in (1, 2, 4, 8, 16, 32, 64):
        c = c + jnp.pad(c, ((0, 0), (s, 0)))[:, :-s]
    row_tot = c[:, -1]  # (rows,)
    row_incl = blocked_cumsum(row_tot)  # recurse; rows ≤ n/128
    row_off = row_incl - row_tot  # exclusive offsets
    out = (c + row_off[:, None]).reshape(rows * _LANES)
    return out[:n] if pad else out
