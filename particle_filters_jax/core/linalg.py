"""Robust SPD linear algebra: Cholesky-with-jitter, triangular solves, MVN pdfs.

The reference re-implements a "Cholesky + progressive jitter" pattern in at
least four places (``simulator/simulator_sensor_network_linear_gaussian.py:127``,
``simulator_sensor_network_skewt_dynamic.py:158``,
``models/unscented_kalman_filter.py:113``, ``models/particle_filter.py:232``).
The filters run in float32 by default, so the jitter discipline matters even
more here; these helpers centralize it as branchless ``lax``-friendly code (a fixed
unrolled retry ladder instead of a data-dependent Python loop).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp


def with_f32_matmuls(fn):
    """Trace ``fn`` under full-float32 matmul precision.

    An accelerator's default f32 "matmul" may run in reduced precision
    (TF32 on NVIDIA tensor cores keeps ~10 mantissa bits). That is fine for
    the particle-sized elementwise math but can corrupt the small-matrix
    covariance algebra in the filters: the EDH flow on the acoustic-tracking
    benchmark diverged under reduced-precision matmuls while being
    bit-stable on CPU. Every filter whose step is built from covariance
    products decorates its hot methods with this; whether each one still
    needs it on the GPU is ROADMAP A8.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped


def symmetrize(a: jax.Array) -> jax.Array:
    """0.5 (A + Aᵀ) — applied after covariance updates, as the reference does
    (``models/unscented_kalman_filter.py:190``, ``models/EDH_particle_filter.py:197``)."""
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


_HI = jax.lax.Precision.HIGHEST


def _chol_base_unrolled(a: jax.Array) -> jax.Array:
    """Unrolled right-looking Cholesky of a small (..., b, b) block.

    Every step is a statically-shaped vector op (no While loop, no
    dynamic slices), so XLA fuses the whole factorization into straight
    elementwise code — the property the batched path is built on. The
    update per column is a broadcast rank-1 FMA, NOT an einsum over the
    already-factored columns: a left-looking form stacks (..., j, ·)
    temps whose tiny leading dim a tiled layout can pad many times over
    (an OOM at the skew-t LEDH's (25, 200) batch). NaNs from a negative pivot propagate into
    all later columns via the rank-1 updates, preserving the
    "failure == non-finite factor" contract of ``jnp.linalg.cholesky``.
    """
    b = a.shape[-1]
    # Batch-last layout: the rank-1 recursion's temps are (b, b, batch…)
    # and (b, batch…), putting the LARGE batch axis on the 128-wide lane
    # dim. Batch-first (b on lanes) pads 16 → 128 on every one of the
    # ~3·b ops — 8× the HBM traffic, measured 17.5 ms vs ~4 ms for the
    # (5000, 144, 144) factorization (benchmarks/profile_d144_linalg.py).
    # The two tiny-block transposes at the boundary are noise.
    nb = a.ndim - 2
    S = jnp.moveaxis(a, (-2, -1), (0, 1))  # (b, b, batch…)
    iota = jnp.arange(b).reshape((b,) + (1,) * nb)
    cols = []
    for j in range(b):
        d = jnp.sqrt(S[j, j])  # (batch…)
        col = jnp.where(iota >= j, S[:, j] / d, 0.0)  # (b, batch…)
        cols.append(col)
        if j + 1 < b:
            S = S - col[:, None] * col[None, :]
    L = jnp.stack(cols, axis=1)  # (b, b, batch…)
    return jnp.moveaxis(L, (0, 1), (-2, -1))


def _tri_inv_unrolled(l: jax.Array) -> jax.Array:
    """Explicit inverse of a small lower-triangular (..., b, b) block by
    unrolled forward substitution on the identity (rank-1 FMA per row —
    same layout rationale as ``_chol_base_unrolled``). All temps are
    (..., b, b), so the cost is independent of any RHS width; every solve
    against the block afterwards is ONE batched matmul. This is the
    cuBLAS-style trsm design: substitution runs only on the b×b diagonal
    blocks, GEMMs do everything else — substituting directly on the
    (..., b, m) RHS would rewrite the full RHS panel b times per block.
    NaNs from a non-finite
    diagonal propagate to all later rows, preserving the failure
    contract. Row i of L⁻¹ keeps exact zeros past column i.
    """
    b = l.shape[-1]
    nb = l.ndim - 2
    lt = jnp.moveaxis(l, (-2, -1), (0, 1))  # (b, b, batch…) — see
    # _chol_base_unrolled for the batch-last layout rationale.
    iota = jnp.arange(b).reshape((b,) + (1,) * nb)
    s = jnp.broadcast_to(
        jnp.eye(b, dtype=l.dtype).reshape((b, b) + (1,) * nb), lt.shape
    )
    rows = []
    for i in range(b):
        row = s[i] / lt[i, i]  # (b, batch…)
        rows.append(row)
        if i + 1 < b:
            lcol = jnp.where(iota > i, lt[:, i], 0.0)  # (b, batch…)
            s = s - lcol[:, None] * row[None, :]
    inv = jnp.stack(rows, axis=0)  # (b, b, batch…)
    return jnp.moveaxis(inv, (0, 1), (-2, -1))


_CHOL_BLOCK = 16
_CHOL_UNROLL_MIN = 32   # below this, unrolled only when batched — see gate
_CHOL_UNROLL_MAX = 160  # above the cap the unrolled graph (and compile
# time) grows too far.
# 160 covers the skew-t sensor network's d=144 (reference sn_skew
# notebook): every Cholesky in its UKF tracker and LEDH per-particle flow.
_SMALL_DIM_BATCH_MIN = 128
# Below-32 dims are where the balance between XLA's looped factorization
# and the many small unrolled ops flips with batch size, so the unrolled
# form is used there only for large static batches.
# Gate: unrolled for 32 ≤ n ≤ 160 always, and for n < 32 only when the
# static batch (leading-dims product) is ≥ _SMALL_DIM_BATCH_MIN. The gate's
# thresholds predate the GPU; measuring them there is ROADMAP A4.


def _use_unrolled(shape, rhs_cols: int = 1) -> bool:
    """Gate on the TRIANGULAR dim ``shape[-1]``: n ≥ 32 always takes the
    unrolled form; below 32 it pays per-op overhead that must amortize
    over ``batch × rhs_cols`` independent columns."""
    n = shape[-1]
    if not (1 <= n <= _CHOL_UNROLL_MAX):
        return False
    if n >= _CHOL_UNROLL_MIN:
        return True
    batch = rhs_cols
    for s in shape[:-2]:
        batch *= int(s)
    return batch >= _SMALL_DIM_BATCH_MIN


@functools.partial(jax.jit, inline=True)
def _chol_blocked_unrolled(a: jax.Array) -> jax.Array:
    """Right-looking blocked Cholesky with fully static shapes.

    Diagonal blocks factor via ``_chol_base_unrolled``; panels solve via
    unrolled substitution; the trailing Schur update is one batched
    float32-precision matmul. Unlike a looped factorization with dynamic
    slices, this form is pure fused vector/matrix code with static
    shapes.

    jit(inline=True): the unrolled body is ~10³ traced ops; without the
    jit cache every CALL SITE re-traces it (minutes to lower one d=144
    EKF). The inline jit caches the trace by shape and
    splices the jaxpr into the caller — no call-primitive overhead, no
    separate XLA compilation unit.

    The trailing matrix SHRINKS each panel (static slices of a smaller
    array per iteration) instead of updating a full-size copy of S in
    place: the in-place form writes n/16 full (..., n, n) copies per
    factorization — 9 × 415 MB of pure HBM traffic per call at the
    skew-t LEDH's (25, 200, 144, 144) batch — where the shrinking form's
    total update traffic telescopes to ~n³/3 elements.
    """
    n = a.shape[-1]
    S = a
    col_blocks = []
    for k in range(0, n, _CHOL_BLOCK):
        kb = min(_CHOL_BLOCK, n - k)
        Lkk = _chol_base_unrolled(S[..., :kb, :kb])
        if k + kb < n:
            # Panel solve Xp Lkkᵀ = S_panel as ONE matmul against the
            # explicit kb×kb inverse (substitution cost stays on kb×kb
            # temps instead of rewriting the (..., n−k, kb) panel kb
            # times — see _tri_inv_unrolled).
            Linv = _tri_inv_unrolled(Lkk)
            Xp = jnp.einsum(
                "...mj,...kj->...mk", S[..., kb:, :kb], Linv, precision=_HI
            )
            S = S[..., kb:, kb:] - jnp.einsum(
                "...mj,...nj->...mn", Xp, Xp, precision=_HI
            )
            body = jnp.concatenate([Lkk, Xp], axis=-2)  # (..., n−k, kb)
        else:
            body = Lkk
        if k:
            zeros = jnp.zeros(a.shape[:-2] + (k, kb), a.dtype)
            body = jnp.concatenate([zeros, body], axis=-2)
        col_blocks.append(body)  # (..., n, kb)
    return jnp.concatenate(col_blocks, axis=-1)


def chol_nojitter(a: jax.Array) -> jax.Array:
    """Single-shot Cholesky of (..., n, n) SPD matrices, fast-path aware.

    For 32 ≤ n ≤ 160 this is the unrolled blocked factorization (static
    shapes, fused elementwise columns + matmul Schur updates); outside that range it
    defers to ``jnp.linalg.cholesky``. Use when SPD-ness is guaranteed by
    construction and the jitter ladder of ``chol_with_jitter`` would be
    waste — e.g. the LEDH flow's K = P⁻¹/λ + HᵀR⁻¹H (caller adds its own
    fixed jitter). Failure contract matches ``jnp.linalg.cholesky``:
    non-SPD input yields NaNs in the factor.
    """
    if _use_unrolled(a.shape):
        return _chol_blocked_unrolled(a)
    return jnp.linalg.cholesky(a)


def _diag_block_invs(l: jax.Array) -> list:
    """Explicit inverses of the 16×16 diagonal blocks of a lower-triangular
    (..., n, n) matrix, as a list of (..., kb, kb) arrays.

    All full blocks invert in ONE ``_tri_inv_unrolled`` call over a
    stacked block axis (one unrolled substitution pass regardless of n);
    a ragged tail block inverts separately."""
    n = l.shape[-1]
    bs = _CHOL_BLOCK
    nb = n // bs
    invs = []
    if nb:
        blocks = jnp.stack(
            [l[..., k * bs : (k + 1) * bs, k * bs : (k + 1) * bs]
             for k in range(nb)],
            axis=-3,
        )  # (..., nb, bs, bs)
        inv_stack = _tri_inv_unrolled(blocks)
        invs = [inv_stack[..., i, :, :] for i in range(nb)]
    if n % bs:
        invs.append(_tri_inv_unrolled(l[..., nb * bs :, nb * bs :]))
    return invs


@functools.partial(jax.jit, inline=True)
def _trsm_left_lower_blocked(l: jax.Array, b_mat: jax.Array) -> jax.Array:
    """Solve L X = B (L (..., n, n) lower-triangular, B (..., n, m)) with
    fully static shapes: batched explicit 16×16 diagonal-block inverses,
    then one matmul per block row (diagonal solve) plus one for the
    right-looking trailing update on a SHRINKING remainder (temp traffic
    telescopes to ~n²m/2 — no full-RHS rewrites, no per-iteration
    concatenations). Same design rationale as ``_chol_blocked_unrolled``:
    static shapes and matmuls in place of a looped substitution."""
    n = l.shape[-1]
    invs = _diag_block_invs(l)
    s = b_mat
    rows = []
    for bi, k in enumerate(range(0, n, _CHOL_BLOCK)):
        kb = min(_CHOL_BLOCK, n - k)
        xk = jnp.einsum(
            "...ij,...jm->...im", invs[bi], s[..., :kb, :], precision=_HI
        )
        rows.append(xk)
        if k + kb < n:
            s = s[..., kb:, :] - jnp.einsum(
                "...ij,...jm->...im", l[..., k + kb :, k : k + kb], xk,
                precision=_HI,
            )
    return jnp.concatenate(rows, axis=-2)


@functools.partial(jax.jit, inline=True)
def _trsm_left_lower_t_blocked(l: jax.Array, b_mat: jax.Array) -> jax.Array:
    """Solve Lᵀ X = B given the LOWER factor L (backward substitution),
    blocked like ``_trsm_left_lower_blocked`` but walking block rows
    bottom-up with transposed panels — no flipped copies of L or B."""
    n = l.shape[-1]
    invs = _diag_block_invs(l)
    ks = list(range(0, n, _CHOL_BLOCK))
    s = b_mat
    rows_rev = []
    for bi in reversed(range(len(ks))):
        k = ks[bi]
        kb = min(_CHOL_BLOCK, n - k)
        xk = jnp.einsum(
            "...ji,...jm->...im", invs[bi], s[..., k:, :], precision=_HI
        )
        rows_rev.append(xk)
        if k:
            s = s[..., :k, :] - jnp.einsum(
                "...ji,...jm->...im", l[..., k : k + kb, :k], xk,
                precision=_HI,
            )
    return jnp.concatenate(rows_rev[::-1], axis=-2)


def tri_solve_lower(l: jax.Array, b_mat: jax.Array) -> jax.Array:
    """Solve L X = B with L lower-triangular; B is (..., n, m) or (..., n).

    Uses the unrolled blocked substitution where ``_use_unrolled`` says
    so, ``jax.scipy`` otherwise. Batched over leading
    axes either way.
    """
    vec = b_mat.ndim == l.ndim - 1
    if vec:
        b_mat = b_mat[..., None]
    if _use_unrolled(l.shape, rhs_cols=b_mat.shape[-1]):
        x = _trsm_left_lower_blocked(l, b_mat)
    else:
        x = jax.scipy.linalg.solve_triangular(l, b_mat, lower=True)
    return x[..., 0] if vec else x


def tri_solve_lower_t(l: jax.Array, b_mat: jax.Array) -> jax.Array:
    """Solve Lᵀ X = B given the LOWER factor L (backward substitution).

    In the 32–160 window this is the blocked bottom-up substitution on
    transposed panels (``_trsm_left_lower_t_blocked`` — no flipped array
    copies); outside it, ``jax.scipy`` on Lᵀ.
    """
    vec = b_mat.ndim == l.ndim - 1
    if vec:
        b_mat = b_mat[..., None]
    if _use_unrolled(l.shape, rhs_cols=b_mat.shape[-1]):
        x = _trsm_left_lower_t_blocked(l, b_mat)
    else:
        x = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(l, -1, -2), b_mat, lower=False
        )
    return x[..., 0] if vec else x


def chol_with_jitter(
    a: jax.Array,
    jitter: float = 0.0,
    max_tries: int = 6,
    initial: float = 1e-9,
    factor: float = 10.0,
) -> jax.Array:
    """Cholesky factor of an SPD matrix with a branchless jitter ladder.

    Tries ``chol(A + jitter·I)``; if that fails (NaNs in the factor),
    falls to progressively larger diagonal jitter ``initial·factor^k``;
    the first finite rung wins, and if every rung fails the (non-finite)
    base attempt is returned. Replaces the reference's Python retry loops
    (progressive 10× jitter,
    ``simulator_sensor_network_linear_gaussian.py:127-156``).

    All ``max_tries + 1`` rungs are factorized in ONE batched call over a
    stacked rung axis — identical candidates and selection to factorizing
    them one by one (compile-time fixed shapes, no host syncs), but the
    per-call overhead of the factorization is paid once instead of seven
    times. Where ``_use_unrolled`` allows, the factorization itself is the
    unrolled blocked form (``_chol_blocked_unrolled``).
    """
    a = symmetrize(a)
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=a.dtype)
    rungs = [jitter] + [jitter + initial * factor**k for k in range(max_tries)]
    eps = jnp.asarray(rungs, dtype=a.dtype).reshape((-1,) + (1,) * a.ndim)
    stacked = a[None, ...] + eps * eye  # (R, ..., n, n)
    if _use_unrolled(stacked.shape):
        Ls = _chol_blocked_unrolled(stacked)
    else:
        Ls = jnp.linalg.cholesky(stacked)
    ok = jnp.all(jnp.isfinite(Ls), axis=tuple(range(1, Ls.ndim)))
    idx = jnp.argmax(ok)  # first finite rung; 0 (the NaN base) if none
    return jnp.take(Ls, idx, axis=0)


def chol_solve(chol_l: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b given lower Cholesky factor L (A = L Lᵀ).

    Two triangular solves — the gain computation pattern of the reference KF
    (``models/kalman_filter.py:57-77``). Routed through the unrolled blocked
    substitution in the 32–160 dim window (see ``tri_solve_lower``).
    """
    return tri_solve_lower_t(chol_l, tri_solve_lower(chol_l, b))


def solve_psd(a: jax.Array, b: jax.Array, jitter: float = 0.0) -> jax.Array:
    """Solve with an SPD ``a`` via jittered Cholesky."""
    return chol_solve(chol_with_jitter(a, jitter=jitter), b)


def inv_psd(a: jax.Array, jitter: float = 0.0) -> jax.Array:
    eye = jnp.eye(a.shape[-1], dtype=a.dtype)
    return chol_solve(chol_with_jitter(a, jitter=jitter), eye)


_LOG_2PI = 1.8378770664093453


def mvn_logpdf_chol(x: jax.Array, mean: jax.Array, chol_l: jax.Array) -> jax.Array:
    """log N(x; mean, L Lᵀ) given the lower Cholesky factor L.

    Vectorizes over leading axes of ``x`` (the per-particle likelihood path,
    cf. reference ``models/particle_filter.py:257-263`` which solves
    ``L_R⁻¹ diffs`` for all particles at once).
    """
    d = x.shape[-1]
    diff = x - mean
    sol = tri_solve_lower(
        chol_l, jnp.swapaxes(jnp.atleast_2d(diff), -1, -2)
    )
    maha = jnp.sum(sol * sol, axis=-2)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.abs(jnp.diagonal(chol_l, axis1=-2, axis2=-1))))
    out = -0.5 * (maha + logdet + d * _LOG_2PI)
    return out.reshape(diff.shape[:-1])


def mvn_logpdf(x: jax.Array, mean: jax.Array, cov: jax.Array, jitter: float = 0.0) -> jax.Array:
    """log N(x; mean, cov) with jittered Cholesky."""
    return mvn_logpdf_chol(x, mean, chol_with_jitter(cov, jitter=jitter))


def diag_gaussian_logpdf(x: jax.Array, mean: jax.Array, var: jax.Array) -> jax.Array:
    """Elementwise-independent Gaussian log-density, summed over the last axis."""
    var = jnp.maximum(var, 1e-38)
    z = (x - mean) ** 2 / var
    return -0.5 * jnp.sum(z + jnp.log(var) + _LOG_2PI, axis=-1)


def cond_spd(a: jax.Array) -> jax.Array:
    """Condition number of an SPD matrix via eigvalsh (diagnostic only).

    Mirrors the reference's flow-stability diagnostics
    (``models/EDH_particle_filter.py:239-243``). Exact but expensive: a
    batched eigh is an iterative decomposition. The flow filters default
    to ``cond_spd_power`` and keep this as the opt-in exact mode.
    """
    ev = jnp.linalg.eigvalsh(symmetrize(a))
    return jnp.abs(ev[-1]) / jnp.maximum(jnp.abs(ev[0]), 1e-38)


def cond_spd_power(
    a: jax.Array, chol_l: Optional[jax.Array] = None, iters: int = 24
) -> jax.Array:
    """Fast cond₂(a) estimate for SPD ``a`` (..., n, n): power iteration
    for λmax and Cholesky inverse iteration for λmin.

    2·iters matvecs (d² flops each) replace the iterative eigensolve of
    ``eigvalsh`` — the EDH/LEDH flows evaluate their cond(S) diagnostic
    once per λ-step, where the exact eigendecomposition cost more than
    the flow itself at d = 144 (see ``cond_spd``). Rayleigh quotients
    converge as (λ₂/λ₁)^{2k}, so 24 iterations give the leading digits
    unless the extreme eigenvalues are nearly tied (a geomspace spectrum
    over 6 decades at d=144 — λ₂/λ₁ = 0.91, the dense-spectrum worst
    case — still reads within 2%; see the unit test) — in which case the
    estimate errs LOW on λmax and HIGH on λmin by at most that ratio,
    i.e. cond is slightly underestimated but its order of magnitude (the
    thing the blow-up diagnostic exists to track) is preserved. Pass
    ``chol_l`` when a Cholesky factor of ``a`` is already in hand;
    otherwise one is computed with a tiny fixed jitter.
    """
    a = symmetrize(a)
    n = a.shape[-1]
    if chol_l is None:
        eye = jnp.eye(n, dtype=a.dtype)
        tr = jnp.trace(a, axis1=-2, axis2=-1)[..., None, None]
        chol_l = chol_nojitter(a + (1e-10 / n) * tr * eye)
    # Deterministic non-degenerate start: the diagonal plus a ramp (never
    # orthogonal to the leading eigvec of an SPD matrix in practice).
    v = jnp.diagonal(a, axis1=-2, axis2=-1) + jnp.arange(
        1, n + 1, dtype=a.dtype
    )
    w = v
    for _ in range(iters):
        v = jnp.einsum("...ij,...j->...i", a, v, precision=_HI)
        v = v / jnp.maximum(
            jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30
        )
        w = tri_solve_lower_t(chol_l, tri_solve_lower(chol_l, w))
        w = w / jnp.maximum(
            jnp.linalg.norm(w, axis=-1, keepdims=True), 1e-30
        )
    av = jnp.einsum("...ij,...j->...i", a, v, precision=_HI)
    lam_max = jnp.einsum("...i,...i->...", v, av)
    aw = jnp.einsum("...ij,...j->...i", a, w, precision=_HI)
    lam_min = jnp.einsum("...i,...i->...", w, aw)
    return jnp.maximum(
        jnp.abs(lam_max) / jnp.maximum(jnp.abs(lam_min), 1e-38), 1.0
    )
