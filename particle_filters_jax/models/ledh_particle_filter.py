"""EKF/UKF-assisted LEDH (Local EDH) particle-flow particle filter.

Capability parity with reference ``models/LEDH_particle_filter.py``:
``LEDHConfig`` (:44), ``LEDHFlowPF`` (:60) — per-particle linearization
Hⁱ = Jh(ηⁱ) (:142-145), per-particle flow matrices Aⁱ, bⁱ (:149-165),
per-particle Euler migration of both ηⁱ and the auxiliary path ȳⁱ
(:168-171), log-det-Jacobian accumulation θⁱ via slogdet(I + εAⁱ)
(:173-179), invertible weights w ∝ w·θ·p(z|x)p(x|x₋)/p(η₀|x₋) (:184-195),
tracker update, optional ESS resampling.

Design: the reference's nested λ×N Python loop (:136-179 —
the reason LEDH runs 330× slower than EDH in BASELINE.md) becomes an exact
``vmap`` over particles inside a ``lax.scan`` over λ. The per-particle
linear algebra is reformulated via Woodbury so the only factorizations are
(nx, nx) SPD Choleskys whose diagonals also yield the flow log-dets — no
(nz, nz) factor and no LU slogdet (see ``_per_particle_flow``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from particle_filters_jax.core.linalg import (
    chol_nojitter,
    chol_solve,
    chol_with_jitter,
    cond_spd,
    cond_spd_power,
    symmetrize,
    tri_solve_lower,
    with_f32_matmuls,
)
from particle_filters_jax.core.structs import pytree_dataclass, static_field
from particle_filters_jax.core.weights import (
    ess_from_logw,
    log_normalize,
    uniform_logw,
    weighted_mean_cov,
)
from particle_filters_jax.models.edh_particle_filter import FlowPFState
from particle_filters_jax.models.trackers import GaussianTracker, TrackerState
from particle_filters_jax.resampling.hard import systematic_resample_values


@pytree_dataclass
class LEDHConfig:
    """Reference ``LEDHConfig`` (:44-49)."""

    n_particles: int = static_field(default=512)
    n_lambda_steps: int = static_field(default=8)
    resample_ess_ratio: float = static_field(default=0.0)
    # "power" (fast cond(S⁰) estimate, see EDHConfig.cond_mode) | "eigh"
    cond_mode: str = static_field(default="power")


class LEDHFlowPF:
    """Local EDH flow PF (per-particle linearization). Constructor mirrors
    the reference (:64-81): ``g(x, u, v)``, ``h(x)``, ``jacobian_h(x)``,
    ``log_trans_pdf``, ``log_like_pdf``, ``R``, tracker, config."""

    def __init__(
        self,
        tracker: GaussianTracker,
        g: Callable,
        h: Callable,
        jacobian_h: Callable,
        log_trans_pdf: Callable,
        log_like_pdf: Callable,
        R,
        config: Optional[LEDHConfig] = None,
        axis_name: Optional[str] = None,
    ) -> None:
        self.tracker = tracker
        self.g = g
        self.h = h
        self.Jh = jacobian_h
        self.log_trans_pdf = log_trans_pdf
        self.log_like_pdf = log_like_pdf
        self.R = jnp.asarray(R)
        self.cfg = config or LEDHConfig()
        self.LR = chol_with_jitter(self.R, initial=1e-10)
        self.R_inv = jax.scipy.linalg.cho_solve(
            (self.LR, True), jnp.eye(self.R.shape[0], dtype=self.R.dtype)
        )
        # With axis_name set the per-particle flow shards over the mesh
        # (it is embarrassingly parallel — each particle factors its own
        # flow matrices); reductions psum and the resample all_gathers.
        # See parallel/flow_sharded.py.
        self.axis_name = axis_name

    def _total_n(self, particles: jax.Array) -> int:
        """Global particle count (local rows × mesh axis size)."""
        n = particles.shape[0]
        if self.axis_name is not None:
            n = n * jax.lax.axis_size(self.axis_name)
        return n

    def _shard_key(self, key: jax.Array) -> jax.Array:
        """Per-shard key so sharded noise draws are distinct streams."""
        if self.axis_name is None:
            return key
        return jax.random.fold_in(key, jax.lax.axis_index(self.axis_name))

    def init_from_gaussian(self, key: jax.Array, mean0, cov0) -> FlowPFState:
        """Particles ~ N(mean0, cov0), uniform weights (reference :84)."""
        mean0 = jnp.asarray(mean0)
        n = self.cfg.n_particles
        L = chol_with_jitter(jnp.asarray(cov0))
        particles = (
            mean0 + jax.random.normal(key, (n, mean0.shape[0]), mean0.dtype) @ L.T
        )
        logw = uniform_logw(n, mean0.dtype)
        mean, cov = weighted_mean_cov(particles, logw)
        return FlowPFState(
            particles=particles,
            weights=jnp.exp(logw),
            log_weights=logw,
            mean=mean,
            cov=cov,
            diagnostics={
                "condition_numbers": jnp.zeros(
                    (self.cfg.n_lambda_steps,), mean0.dtype
                ),
                "resampled": jnp.asarray(False),
            },
        )

    def _per_particle_flow(
        self, lam, dlam, eta_i, etabar_i, eta0_i, P, P_inv, z, I
    ):
        """Aⁱ, bⁱ, migrations and log-det increment for ONE particle
        (reference λ-loop body :140-179); vmapped over particles.

        Reformulation (the reference — and round 1 here — factored the
        nz×nz innovation Sⁱ = λHⁱPHⁱᵀ+R per particle and took an LU slogdet
        of I+εAⁱ; at MAT scale those two ops dominate the filter). Via
        Woodbury with Wⁱ = HⁱᵀR⁻¹Hⁱ and Kⁱ = P⁻¹/λ + Wⁱ:

            HⁱᵀSⁱ⁻¹Hⁱ = Gⁱ = Wⁱ − Wⁱ Kⁱ⁻¹ Wⁱ,     Aⁱ = −½ P Gⁱ,

        so the only factorization is an nx×nx SPD Cholesky. And since
        Gⁱ = (1/λ) Wⁱ Kⁱ⁻¹ P⁻¹, the flow Jacobian determinant reduces to a
        ratio of SPD determinants sharing that factorization:

            det(I + εAⁱ) = det(I − (ε/2)PGⁱ) = det(Kⁱ − (ε/2λ)Wⁱ)/det(Kⁱ),

        with Kⁱ − (ε/2λ)Wⁱ = P⁻¹/λ + (1 − ε/2λ)Wⁱ SPD because ε = dλ ≤ λ
        on the grid — both log-dets come from Cholesky diagonals, no LU:
        at the MAT config (N=500) a 25×25 chol plus an LU slogdet per
        λ-step become two 16×16 chols.
        """
        Hi = self.Jh(eta_i)
        ei = self.h(eta_i) - Hi @ eta_i
        RinvH = self.R_inv @ Hi  # (nz, nx)
        W = symmetrize(Hi.T @ RinvH)  # (nx, nx) PSD
        K = P_inv / lam + W
        # Single-shot Cholesky: K ⪰ P⁻¹/λ is SPD by construction (P⁻¹ comes
        # from the jittered factorization in step()), so the 7-attempt
        # chol_with_jitter ladder is pure waste here — at MAT scale the two
        # ladders were ~half the whole filter's runtime. chol_nojitter
        # takes the unrolled blocked form where core.linalg's gate says so.
        jit_eye = 1e-8 * I
        # Both SPD factorizations of this λ-step in ONE batched call:
        # stacking K and the θ-ratio numerator pays the per-block fixed
        # costs once instead of twice. core.linalg's gate sees only this
        # explicit (2, nx, nx) shape, not the particle vmap's batch axis.
        c = dlam / (2.0 * lam)
        Ls = chol_nojitter(
            jnp.stack([K + jit_eye, P_inv / lam + (1.0 - c) * W + jit_eye])
        )
        LK, L_num = Ls[0], Ls[1]
        # G = W − W K⁻¹ W needs only ONE forward substitution: with
        # Y = LK⁻¹ W, symmetry gives W K⁻¹ W = Yᵀ Y (the back-substitution
        # half of a cho_solve would be redundant work).
        Y = tri_solve_lower(LK, W)
        G = symmetrize(W - Y.T @ Y)  # HᵀS⁻¹H
        Ai = -0.5 * P @ G
        Rin_innov = self.R_inv @ (z - ei)
        bi = (I + 2.0 * lam * Ai) @ (
            (I + lam * Ai) @ (P @ (Hi.T @ Rin_innov)) + Ai @ eta0_i
        )
        etabar_new = etabar_i + dlam * (Ai @ etabar_i + bi)
        eta_new = eta_i + dlam * (Ai @ eta_i + bi)
        # θ accumulation: log|det(I + εAⁱ)| from the SPD determinant ratio.
        logdet = 2.0 * (
            jnp.sum(jnp.log(jnp.diagonal(L_num)))
            - jnp.sum(jnp.log(jnp.diagonal(LK)))
        )
        return eta_new, etabar_new, logdet

    def _cond_first_particle(self, lam, eta_0, P):
        """cond(S⁰) diagnostic for particle 0 only — matching the reference
        (:150-157), which records a single particle's condition number. Kept
        OUT of the vmapped flow: an eigvalsh per particle per λ-step would
        dominate the whole filter."""
        H0 = self.Jh(eta_0)
        S0 = lam * (H0 @ P @ H0.T) + self.R
        if self.cfg.cond_mode == "eigh":
            return cond_spd(S0)
        return cond_spd_power(symmetrize(S0))

    @with_f32_matmuls
    def step(
        self,
        key: jax.Array,
        state: FlowPFState,
        tracker_state: TrackerState,
        z,
        u=None,
        process_noise_sampler: Optional[Callable] = None,
        beta_schedule: Optional[jax.Array] = None,
    ) -> Tuple[FlowPFState, TrackerState]:
        """One LEDH step (reference ``step`` :93-211).

        ``beta_schedule`` optionally replaces the uniform λ grid with a
        custom monotone temper schedule β(λ) of shape (n_lambda_steps + 1,)
        running 0 → 1 — e.g. the SPF stiffness-mitigating optimal β* from
        ``solve_beta_star_bisection`` (the coupling demonstrated by reference
        ``notebooks/SPF_LEDH.ipynb``, class ``LEDHFlowPF_CustomBeta``). The
        flow is then evaluated at temper levels β_k with Euler increments
        ε_k = β_{k+1} − β_k; the Woodbury log-det identity stays valid since
        monotone β ⇒ ε_k ≤ β_{k+1}."""
        z = jnp.asarray(z)
        n, nx = state.particles.shape
        I = jnp.eye(nx, dtype=state.particles.dtype)
        k_noise, k_res = jax.random.split(key)

        ts, m_pred, P = self.tracker.predict(tracker_state, u=u)
        P = symmetrize(P)

        if process_noise_sampler is None:
            v = jnp.zeros((n, nx), state.particles.dtype)
        else:
            v = process_noise_sampler(self._shard_key(k_noise), n, nx)
        eta0 = jax.vmap(lambda x, vi: self.g(x, u, vi))(state.particles, v)

        n_steps = max(1, int(self.cfg.n_lambda_steps))
        dtype = state.particles.dtype
        if beta_schedule is None:
            dlam = 1.0 / n_steps
            lams = jnp.minimum((jnp.arange(n_steps, dtype=dtype) + 1) * dlam, 1.0)
            dlams = jnp.full((n_steps,), dlam, dtype)
        else:
            beta = jnp.asarray(beta_schedule, dtype)
            if beta.shape != (n_steps + 1,):
                raise ValueError(
                    f"beta_schedule must have shape ({n_steps + 1},) = "
                    f"(n_lambda_steps + 1,); got {beta.shape}."
                )
            # Validate values when the schedule is concrete (the usual
            # case): the Woodbury flow divides by λ and its SPD argument
            # K ⪰ P⁻¹/λ requires a strictly increasing positive pseudo-time
            # — a zero or non-monotone schedule would otherwise produce
            # silent inf/NaN particles instead of an error.
            if not isinstance(beta, jax.core.Tracer):
                b = np.asarray(beta)
                if not np.all(np.diff(b) > 0.0):
                    raise ValueError(
                        "beta_schedule must be strictly increasing."
                    )
                if not np.all(b[1:] > 0.0):
                    raise ValueError(
                        "beta_schedule values past index 0 must be positive "
                        "(the flow divides by λ)."
                    )
                # The flow assumes FULL tempering 0 → 1: the θ log-det weight
                # correction telescopes to the λ=1 posterior only if the
                # schedule actually ends at 1, and ε₀ = λ₁ − λ₀ with λ₀ = 0
                # underpins the SPD argument of the Woodbury log-det (a
                # negative λ₀ could make ε₀ > λ₁). Partial schedules would
                # silently yield a partially-tempered posterior.
                if b[0] != 0.0:
                    raise ValueError(
                        f"beta_schedule must start at 0.0 (got {b[0]!r}); "
                        "the flow integrates pseudo-time from λ=0."
                    )
                if b[-1] != 1.0:
                    raise ValueError(
                        f"beta_schedule must end at 1.0 (got {b[-1]!r}); "
                        "the weight correction assumes full tempering to λ=1."
                    )
            lams = beta[1:]
            dlams = jnp.diff(beta)

        Lp = chol_with_jitter(P, initial=1e-9)
        P_inv = chol_solve(Lp, I)

        flow_batched = jax.vmap(
            self._per_particle_flow,
            in_axes=(None, None, 0, 0, 0, None, None, None, None),
        )

        def flow_step(carry, inp):
            lam, dlam = inp
            eta, etabar, theta_log = carry
            cond0 = self._cond_first_particle(lam, eta[0], P)
            if self.axis_name is not None:
                # Replicate the representative-particle diagnostic across
                # shards as the worst case over each shard's first particle.
                cond0 = lax.pmax(cond0, self.axis_name)
            eta_new, etabar_new, logdets = flow_batched(
                lam, dlam, eta, etabar, eta0, P, P_inv, z, I
            )
            return (eta_new, etabar_new, theta_log + logdets), cond0

        # ȳ₀ⁱ = η₀ⁱ (strict LEDH, reference :117-121); θ = 1 (log 0).
        (eta, _, theta_log), conds = lax.scan(
            flow_step,
            (eta0, eta0, jnp.zeros((n,), state.particles.dtype)),
            (lams, dlams),
        )
        xk = eta

        # Weights w ∝ w·θ·p(z|x)p(x|x₋)/p(η₀|x₋) (reference :184-195)
        log_corr = jax.vmap(
            lambda x_new, x_old, e0: self.log_trans_pdf(x_new, x_old)
            + self.log_like_pdf(z, x_new)
            - self.log_trans_pdf(e0, x_old)
        )(xk, state.particles, eta0)
        logw, _ = log_normalize(
            state.log_weights + theta_log + log_corr, self.axis_name
        )

        ts, _, _ = self.tracker.update(ts, z)

        # Sharded: deterministic-per-key GLOBAL ancestry from an all_gather
        # of the cloud, each shard keeping its slice (same scheme as
        # ParticleFilter._maybe_resample; flow clouds are N ≤ 10⁴).
        trigger = jnp.asarray(False)
        if self.cfg.resample_ess_ratio > 0.0:
            ess = ess_from_logw(logw, self.axis_name)
            trigger = ess < self.cfg.resample_ess_ratio * self._total_n(xk)

            def do_res(op):
                k, p, lw = op
                if self.axis_name is not None:
                    p_all = lax.all_gather(p, self.axis_name, axis=0, tiled=True)
                    lw_all = lax.all_gather(lw, self.axis_name, axis=0, tiled=True)
                    vals = systematic_resample_values(k, p_all, logw=lw_all)
                    i = lax.axis_index(self.axis_name)
                    p_new = lax.dynamic_slice_in_dim(vals, i * n, n, axis=0)
                else:
                    p_new = systematic_resample_values(k, p, logw=lw)
                return (
                    p_new,
                    uniform_logw(self._total_n(p), lw.dtype)[:n],
                )

            xk, logw = lax.cond(
                trigger, do_res, lambda op: (op[1], op[2]), (k_res, xk, logw)
            )

        mean, cov = weighted_mean_cov(xk, logw, self.axis_name)
        new_state = FlowPFState(
            particles=xk,
            weights=jnp.exp(logw),
            log_weights=logw,
            mean=mean,
            cov=symmetrize(cov),
            diagnostics={"condition_numbers": conds, "resampled": trigger},
        )
        return new_state, ts

    def run(
        self,
        key: jax.Array,
        state0: FlowPFState,
        tracker_state0: TrackerState,
        zs: jax.Array,
        process_noise_sampler: Optional[Callable] = None,
        beta_schedule: Optional[jax.Array] = None,
    ):
        """Filter a (T, nz) sequence in one ``lax.scan``."""
        T = zs.shape[0]
        keys = jax.random.split(key, T)

        def body(carry, inp):
            st, ts = carry
            k, z = inp
            st, ts = self.step(
                k, st, ts, z,
                process_noise_sampler=process_noise_sampler,
                beta_schedule=beta_schedule,
            )
            hist = {
                "mean": st.mean,
                "cov": st.cov,
                "ess": ess_from_logw(st.log_weights, self.axis_name),
                "resampled": st.diagnostics["resampled"],
                "condition_numbers": st.diagnostics["condition_numbers"],
            }
            return (st, ts), hist

        (final, ts), hist = lax.scan(body, (state0, tracker_state0), (keys, zs))
        return final, ts, hist
