"""SIR (sequential importance resampling) particle filter.

Capability parity with reference ``models/particle_filter.py``:
``PFState`` (:27), Gaussian initialization (:110), ESS (:134),
systematic/multinomial resampling with ESS trigger ``Neff < thresh·Np``
(:188-218), optional post-resample regularization jitter ``0.001·Lq``
(:212-218), per-particle propagate (:223) and Gaussian log-weight update
(:239-263), weighted mean/cov (:266-267).

Design (SURVEY.md §3.2):
- propagate/measure are one ``vmap`` over the particle axis (the reference's
  hot per-particle Python list comprehensions, :237 and :257);
- weights live in the log domain with a single logsumexp normalization;
- resampling is the vectorized inverse-CDF from ``resampling/hard.py``
  under a ``lax.cond`` on the ESS trigger (no host sync);
- ``run`` drives the whole sequence in one ``lax.scan`` — the full filter is
  one XLA program;
- optional ``axis_name`` makes every reduction a psum so the same code runs
  with the particle axis sharded across a mesh (see ``parallel/``).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from particle_filters_jax.core.linalg import chol_with_jitter
from particle_filters_jax.core.structs import pytree_dataclass
from particle_filters_jax.core.weights import (
    ess_from_logw,
    log_normalize,
    uniform_logw,
    weighted_mean_cov,
)
from particle_filters_jax.resampling.hard import (
    resample_indices,
    systematic_resample_values,
)


@pytree_dataclass
class PFState:
    """Particle posterior (reference ``PFState`` :27, plus log-weights).

    ``log_weights`` are the authoritative representation; the reference's
    linear ``weights`` field (:27) is a lazy property materialized only when
    read (an extra N-element exp + HBM write per step bought nothing in the
    scan body — the carry is log-domain throughout).
    """

    particles: jax.Array  # (Np, nx)
    log_weights: jax.Array  # (Np,)
    mean: jax.Array  # (nx,)
    cov: jax.Array  # (nx, nx)
    t: jax.Array  # scalar int32

    @property
    def weights(self) -> jax.Array:
        """Normalized linear weights (parity view of ``log_weights``)."""
        return jnp.exp(self.log_weights)


class ParticleFilter:
    """SIR particle filter for

        x_k = g(x_{k−1}, u_{k−1}) + w,  w ~ N(0, Q)
        z_k = h(x_k) + v,               v ~ N(0, R)

    or a custom observation log-density via ``obs_loglik(x, z) -> scalar``
    (per particle; used for non-additive / non-Gaussian likelihoods such as
    the SV model and Poisson counts).

    Constructor parameters mirror the reference (:53-100); randomness is
    explicit ``jax.random`` keys instead of a stored ``np.random.Generator``.
    """

    def __init__(
        self,
        g: Callable,
        h: Optional[Callable],
        Q,
        R,
        *,
        Np: int = 1000,
        resample_thresh: float = 0.5,
        resample_method: str = "systematic",
        regularize_after_resample: bool = False,
        obs_loglik: Optional[Callable] = None,
        axis_name: Optional[str] = None,
        distributed_resample: str = "all_gather",
        neighbor_radius: int = 2,
    ) -> None:
        """``distributed_resample`` selects the cross-shard ancestry
        exchange when ``axis_name`` is set: ``"all_gather"`` replicates the
        full cloud per device during the (rare) resample step — exact,
        O(N) memory; ``"neighbor"`` pools only ±``neighbor_radius``
        neighbor shards via ppermute — O((2r+1)·N/S) memory on pooled
        steps, and exact by construction: a step whose ancestry needs
        shards beyond the radius automatically rescues through the exact
        all_gather path in-graph, flagging ``exchange_ok=False`` in the
        history as a pool-sizing signal
        (see ``parallel/distributed_resample.py``)."""
        self.g = g
        self.h = h
        self.Q = jnp.asarray(Q)
        self.R = jnp.asarray(R) if R is not None else None
        self.Np = int(Np)
        self.resample_thresh = float(resample_thresh)
        self.resample_method = str(resample_method)
        self.regularize_after_resample = bool(regularize_after_resample)
        self.axis_name = axis_name
        if distributed_resample not in ("all_gather", "neighbor"):
            raise ValueError(
                "distributed_resample must be 'all_gather' or 'neighbor'."
            )
        if distributed_resample == "neighbor" and resample_method != "systematic":
            raise ValueError(
                "neighbor-exchange resampling requires resample_method="
                "'systematic' (its ancestry is a contiguous inverse-CDF)."
            )
        self.distributed_resample = distributed_resample
        self.neighbor_radius = int(neighbor_radius)

        self.nx = self.Q.shape[0]
        self.Lq = chol_with_jitter(self.Q, initial=1e-10)
        if obs_loglik is not None:
            self._obs_loglik = obs_loglik
        else:
            if h is None or self.R is None:
                raise ValueError("Provide either (h, R) or obs_loglik.")
            self.nz = self.R.shape[0]
            LR = chol_with_jitter(self.R, initial=1e-12)

            def gaussian_obs_loglik(x, z):
                diff = z - self.h(x)
                y = jax.scipy.linalg.solve_triangular(LR, diff, lower=True)
                # Reference drops the Gaussian constant (:259) — it cancels
                # in the weight normalization.
                return -0.5 * jnp.sum(y * y)

            self._obs_loglik = gaussian_obs_loglik

    # -------------------- initialization & diagnostics --------------------

    def initialize(self, key: jax.Array, mean, cov) -> PFState:
        """Particles ~ N(mean, cov), uniform weights (reference :110)."""
        mean = jnp.asarray(mean).reshape(-1)
        cov = jnp.atleast_2d(jnp.asarray(cov))
        Lc = chol_with_jitter(cov, initial=1e-10)
        eps = jax.random.normal(key, (self.Np, mean.shape[0]), mean.dtype)
        particles = eps @ Lc.T + mean
        logw = uniform_logw(self.Np, mean.dtype)
        return PFState(
            particles=particles,
            log_weights=logw,
            mean=mean,
            cov=cov,
            t=jnp.asarray(0, jnp.int32),
        )

    def effective_sample_size(self, state: PFState) -> jax.Array:
        """Neff = 1/Σw² (reference :134)."""
        return ess_from_logw(state.log_weights, self.axis_name)

    # ------------------------------ core ops ------------------------------

    def _shard_key(self, key: jax.Array) -> jax.Array:
        """Decorrelate per-shard randomness: inside shard_map every shard
        receives the same (replicated) key, so fold in the shard index."""
        if self.axis_name is None:
            return key
        return jax.random.fold_in(key, lax.axis_index(self.axis_name))

    def _total_n(self, particles: jax.Array) -> int:
        n = particles.shape[0]
        if self.axis_name is not None:
            n = n * lax.axis_size(self.axis_name)
        return n

    def predict(self, key: jax.Array, state: PFState, u=None) -> jax.Array:
        """Propagate all particles: vmapped g + correlated Gaussian noise
        (replaces the per-particle loop at reference :237)."""
        key = self._shard_key(key)
        noise = (
            jax.random.normal(key, state.particles.shape, state.particles.dtype)
            @ self.Lq.T
        )
        prop = jax.vmap(lambda x: self.g(x, u))(state.particles)
        return prop + noise

    def _resample_values(self, k_idx, p, lw):
        """Dispatch the single-shard resample implementation."""
        if self.resample_method == "systematic":
            return systematic_resample_values(k_idx, p, logw=lw)
        idx = resample_indices(self.resample_method, k_idx, logw=lw)
        return jnp.take(p, idx, axis=0)

    def _resample_keys(self, key):
        """(k_idx, k_jitter) derivation of the resample branch — the ONE
        place this split is defined, so diagnostics (``run``'s
        ``track_degeneracy``) can reproduce the exact ancestry stream."""
        return jax.random.split(key)

    def _resample(self, key, p, lw):
        """The resample branch: ``(new_particles, uniform_logw, ok)`` for
        globally normalized log-weights ``lw`` (reference :188-218)."""
        k_idx, k_jit = self._resample_keys(key)
        n_local = p.shape[0]
        ok = jnp.asarray(True)
        if self.axis_name is not None:
            if self.distributed_resample == "neighbor":
                # Memory-bounded ±r neighbor-shard exchange; exact by
                # construction (in-graph all_gather rescue when the pool
                # is insufficient; ok flags pool sizing).
                from particle_filters_jax.parallel.distributed_resample import (
                    neighbor_exchange_systematic_resample,
                )

                p_new, ok = neighbor_exchange_systematic_resample(
                    k_idx, p, lw,
                    axis_name=self.axis_name,
                    radius=self.neighbor_radius,
                )
            else:
                # Cross-shard resampling: gather the global cloud, run the
                # deterministic-per-key global systematic resample on every
                # shard (same key ⇒ same u ⇒ identical ancestry), and keep
                # this shard's output slice.
                p_all = lax.all_gather(p, self.axis_name, axis=0, tiled=True)
                lw_all = lax.all_gather(lw, self.axis_name, axis=0, tiled=True)
                vals = self._resample_values(k_idx, p_all, lw_all)
                i = lax.axis_index(self.axis_name)
                p_new = lax.dynamic_slice_in_dim(
                    vals, i * n_local, n_local, axis=0
                )
        else:
            p_new = self._resample_values(k_idx, p, lw)
        if self.regularize_after_resample:
            jitter = (
                jax.random.normal(
                    self._shard_key(k_jit), p_new.shape, p_new.dtype
                )
                @ (0.001 * self.Lq.T)
            )
            p_new = p_new + jitter
        return p_new, uniform_logw(self._total_n(p), lw.dtype)[:n_local], ok

    def _maybe_resample(self, key, particles, logw):
        """ESS-triggered resample under lax.cond (reference :188-218)."""
        ess = ess_from_logw(logw, self.axis_name)
        trigger = ess < self.resample_thresh * self._total_n(particles)

        def no_resample(operand):
            _, p, lw = operand
            return p, lw, jnp.asarray(True)

        particles, logw, exchange_ok = lax.cond(
            trigger, lambda op: self._resample(*op), no_resample,
            (key, particles, logw),
        )
        return particles, logw, ess, trigger, exchange_ok

    def update(self, key: jax.Array, state: PFState, z, particles=None,
               return_diagnostics: bool = False):
        """Log-weight update + conditional resample + posterior moments
        (reference :239-267). ``particles`` defaults to ``state.particles``
        (call after ``predict``).

        With ``return_diagnostics`` returns ``(state, diag)`` where diag
        carries ``ess``, ``resampled``, and ``exchange_ok`` — the latter is
        the pool-sizing signal of the memory-bounded neighbor-exchange
        resample (``distributed_resample="neighbor"``): False on a step
        whose ancestry needed shards beyond ±neighbor_radius, in which
        case the exact all_gather rescue ran in-graph (the result is still
        exact; a persistently False flag means the radius is too small to
        deliver the memory bound). ``run`` surfaces the same flag in its
        history.
        """
        z = jnp.asarray(z)
        if particles is None:
            particles = state.particles
        loglik = jax.vmap(lambda x: self._obs_loglik(x, z))(particles)
        logw, _ = log_normalize(state.log_weights + loglik, self.axis_name)
        particles, logw, ess, trig, ex_ok = self._maybe_resample(
            key, particles, logw
        )
        mean, cov = weighted_mean_cov(particles, logw, self.axis_name)
        new = PFState(
            particles=particles,
            log_weights=logw,
            mean=mean,
            cov=cov,
            t=state.t + 1,
        )
        if return_diagnostics:
            return new, {"ess": ess, "resampled": trig, "exchange_ok": ex_ok}
        return new

    def step(self, key: jax.Array, state: PFState, z, u=None,
             return_diagnostics: bool = False):
        """Predict then update (reference :271). See ``update`` for
        ``return_diagnostics``."""
        k_pred, k_upd = jax.random.split(key)
        particles = self.predict(k_pred, state, u)
        return self.update(
            k_upd, state, z, particles=particles,
            return_diagnostics=return_diagnostics,
        )

    def run(
        self,
        key: jax.Array,
        state0: PFState,
        zs: jax.Array,
        us=None,
        *,
        track_degeneracy: bool = False,
    ):
        """Filter a whole (T, nz) sequence in one ``lax.scan``.

        Returns ``(final_state, history)`` where history is a dict of stacked
        per-step diagnostics: mean (T, nx), cov (T, nx, nx), ess (T,),
        resampled (T,) — the trace the reference's tests/notebooks rebuild by
        hand around ``pf.step`` (e.g. ``test_pf_vs_simulator_sv.py:137``).

        With ``track_degeneracy`` the history additionally carries the
        degeneracy panel of ``notebooks/particle_filter_NLNGSSM.ipynb``
        phase 1 — normalized weight entropy, Gini coefficient, max weight
        (all on the pre-resample posterior weights), and ``unique_frac``, the
        fraction of ancestors that survive the step's systematic resample
        (1.0 on steps that do not resample). Single-device only: the panel
        reads local weights, so it is not defined under ``axis_name``.
        """
        if track_degeneracy and self.axis_name is not None:
            raise ValueError(
                "track_degeneracy reads the local weight vector and is not "
                "defined for sharded (axis_name) runs."
            )
        T = zs.shape[0]
        keys = jax.random.split(key, T)
        us_seq = us if us is not None else jnp.zeros((T, 0))
        return self._run_with_keys(state0, keys, zs, us_seq, track_degeneracy)

    def _run_with_keys(self, state0, keys, zs, us_seq, track_degeneracy=False):
        """The ``run`` scan with per-step keys made explicit — the shared
        core of ``run`` (one scan over the whole sequence) and
        ``run_chunked`` (the same scan over key/observation slices, so a
        chunked run consumes the identical per-step key stream and matches
        the monolithic run bit for bit)."""

        def body(state, inputs):
            k, z, u = inputs
            k_pred, k_upd = jax.random.split(k)
            particles = self.predict(k_pred, state, u if u.shape[-1] else None)
            z = jnp.asarray(z)
            loglik = jax.vmap(lambda x: self._obs_loglik(x, z))(particles)
            # log_z = logsumexp of the reweighted normalized weights — the
            # incremental marginal likelihood log p(z_t | z_{1:t-1}) up to
            # the constant the Gaussian path drops (the KF path returns the
            # exact analog, reference models/kalman_filter.py:229-234).
            logw_pre, log_z = log_normalize(
                state.log_weights + loglik, self.axis_name
            )
            particles, logw, ess, trig, ex_ok = self._maybe_resample(
                k_upd, particles, logw_pre
            )
            mean, cov = weighted_mean_cov(particles, logw, self.axis_name)
            new = PFState(
                particles=particles,
                log_weights=logw,
                mean=mean,
                cov=cov,
                t=state.t + 1,
            )
            out = {
                "mean": mean,
                "cov": cov,
                "ess": ess,
                "resampled": trig,
                "log_evidence": log_z,
                # True unless a neighbor-exchange resample needed ancestors
                # beyond ±neighbor_radius shards this step.
                "exchange_ok": ex_ok,
            }
            if track_degeneracy:
                from particle_filters_jax.resampling.hard import (
                    systematic_counts,
                )
                from particle_filters_jax.utils.diagnostics import (
                    max_weight,
                    weight_entropy,
                    weight_gini,
                )

                # Same key derivation as _maybe_resample's do_resample branch
                # so the ancestry matches the resample that actually ran —
                # per configured method, not hardwired to systematic.
                k_idx, _ = self._resample_keys(k_upd)

                def _survive(op):
                    k, lw = op
                    if self.resample_method == "systematic":
                        counts = systematic_counts(k, logw=lw)
                        return jnp.mean((counts > 0).astype(jnp.float32))
                    idx = resample_indices(self.resample_method, k, logw=lw)
                    hit = jnp.zeros((idx.shape[0],), jnp.int32).at[idx].add(
                        1, mode="drop"
                    )
                    return jnp.mean((hit > 0).astype(jnp.float32))

                # Ancestry reconstruction is as expensive as the resample
                # itself at large N — only run it on steps that resampled.
                survive = lax.cond(
                    trig,
                    _survive,
                    lambda op: jnp.float32(1.0),
                    (k_idx, logw_pre),
                )
                out.update(
                    entropy=weight_entropy(logw_pre),
                    gini=weight_gini(logw_pre),
                    max_weight=max_weight(logw_pre),
                    unique_frac=jnp.where(trig, survive, 1.0),
                )
            return new, out

        final, hist = lax.scan(body, state0, (keys, zs, us_seq))
        return final, hist

    def run_chunked(
        self,
        key: jax.Array,
        state0: PFState,
        zs: jax.Array,
        us=None,
        *,
        chunk_size: int,
        ckpt_dir: Optional[str] = None,
        resume: bool = False,
        stop_after_chunks: Optional[int] = None,
        track_degeneracy: bool = False,
    ):
        """``run`` in ``chunk_size``-step jitted pieces with an orbax
        checkpoint between chunks — mid-sequence checkpoint/resume for
        long filtering runs (SURVEY.md §5.4; the reference persists only
        datasets, ``simulator/simulator_Lorenz_96.py:215-295``).

        The per-step key stream is ``jax.random.split(key, T)`` exactly as
        in ``run``, derived once up front and sliced per chunk, so the
        chunked run — interrupted and resumed or not — produces the SAME
        trajectory, history, and final state as the monolithic ``run``
        (bit-for-bit; pinned by ``tests/unit/test_particle_filter.py``).

        - ``ckpt_dir``: after each completed chunk the carry state and the
          chunk's history slab are saved under ``ckpt_dir/state`` /
          ``ckpt_dir/hist`` (orbax, ``step_<c>`` subdirs, c = number of
          completed chunks). Omit it for pure chunked execution.
        - ``resume=True``: continue from the latest checkpoint in
          ``ckpt_dir``, reloading completed chunks' histories so the
          returned history still covers the full sequence.
        - ``stop_after_chunks=j``: return after j more chunks (simulating /
          scheduling an interruption); the return then carries the partial
          history (state reflects the last completed chunk).

        Single-device driver: the chunk calls are jitted here, so this
        method cannot itself be placed under ``shard_map`` — for sharded
        runs keep ``run`` (one scan) or drive chunks through
        ``parallel.sharded``.
        """
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive.")
        if stop_after_chunks is not None and stop_after_chunks < 1:
            raise ValueError("stop_after_chunks must be >= 1.")
        if resume and ckpt_dir is None:
            raise ValueError("resume=True requires ckpt_dir.")
        if zs.shape[0] == 0:
            raise ValueError("zs must contain at least one observation.")
        from particle_filters_jax.utils.checkpoint import (
            latest_step,
            restore_checkpoint,
            save_checkpoint,
        )

        T = zs.shape[0]
        keys = jax.random.split(key, T)
        us_seq = us if us is not None else jnp.zeros((T, 0))
        n_chunks = -(-T // chunk_size)

        cache_key = bool(track_degeneracy)
        fns = getattr(self, "_chunk_fns", None)
        if fns is None:
            fns = self._chunk_fns = {}
        if cache_key not in fns:

            def _chunk(state, ks, zc, uc, _td=track_degeneracy):
                return self._run_with_keys(state, ks, zc, uc, _td)

            fns[cache_key] = jax.jit(_chunk)
        chunk_fn = fns[cache_key]

        state = state0
        hists = []
        start_chunk = 0
        if resume:
            import os

            done = latest_step(os.path.join(ckpt_dir, "state"))
            if done is not None:
                state = restore_checkpoint(
                    os.path.join(ckpt_dir, "state"), template=state0,
                    step=done,
                )
                # Completed chunks' history slabs (plain dicts of arrays —
                # orbax restores them without a template).
                hists = [
                    restore_checkpoint(os.path.join(ckpt_dir, "hist"), step=c)
                    for c in range(1, done + 1)
                ]
                start_chunk = done

        end_chunk = n_chunks
        if stop_after_chunks is not None:
            end_chunk = min(n_chunks, start_chunk + int(stop_after_chunks))

        for c in range(start_chunk, end_chunk):
            lo, hi = c * chunk_size, min((c + 1) * chunk_size, T)
            state, hist = chunk_fn(
                state, keys[lo:hi], zs[lo:hi], us_seq[lo:hi]
            )
            jax.block_until_ready(state.particles)
            hists.append(hist)
            if ckpt_dir is not None:
                import os

                save_checkpoint(
                    os.path.join(ckpt_dir, "state"), state, step=c + 1
                )
                save_checkpoint(
                    os.path.join(ckpt_dir, "hist"), hist, step=c + 1
                )

        history = jax.tree.map(
            lambda *xs: jnp.concatenate([jnp.asarray(x) for x in xs], axis=0),
            *hists,
        )
        return state, history
