"""EKF/UKF-assisted EDH (Exact Daum-Huang) particle-flow particle filter.

Capability parity with reference ``models/EDH_particle_filter.py``:
``EDHConfig`` (:58), ``EDHFlowPF`` (:137) — propagate particles, integrate
the affine flow dη/dλ = A(λ)η + b(λ) over pseudo-time λ ∈ [0, 1] with
S(λ) = λHPHᵀ + R (:236), A = −½PHᵀS⁻¹H (:248-254),
b = (I + 2λA)[(I + λA)PHᵀR⁻¹(z − e) + Aη̄] (:256-264), Euler or RK4
integrator, invertible PF-PF importance-weight correction
w ∝ w·p(x|x₋)p(z|x)/p(η₀|x₋) in the log domain (:285-298), tracker
measurement update (:301), ESS-triggered resampling (:304-309), and
condition-number diagnostics (:239-243).

Design: per-particle loops (propagate :206-208, RK4 :277-280,
weight correction :285-298) are ``vmap``; the λ-loop is a ``lax.scan``
(fixed length — static shapes); the tracker is explicit carried state
(see ``trackers.py``); solves are Cholesky-based.

With ``axis_name`` set, the particle axis shards over a device mesh: the
flow integration and weight correction are embarrassingly parallel per
shard (the flow matrices A(λ), b(λ) depend only on the replicated tracker
state), the log-normalizer/ESS/moments ride psum, and the ESS-triggered
resample gathers the global cloud with the deterministic-per-key ancestry
(each shard keeps its slice) — see ``parallel/flow_sharded.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from particle_filters_jax.core.linalg import (
    chol_solve,
    chol_with_jitter,
    cond_spd,
    cond_spd_power,
    symmetrize,
)
from particle_filters_jax.core.linalg import with_f32_matmuls
from particle_filters_jax.core.structs import pytree_dataclass, static_field
from particle_filters_jax.core.weights import (
    ess_from_logw,
    log_normalize,
    uniform_logw,
    weighted_mean_cov,
)
from particle_filters_jax.models.trackers import GaussianTracker, TrackerState
from particle_filters_jax.resampling.hard import systematic_resample_values


@pytree_dataclass
class EDHConfig:
    """Reference ``EDHConfig`` (:58-65); rng is an explicit key at call time."""

    n_particles: int = static_field(default=512)
    n_lambda_steps: int = static_field(default=8)
    resample_ess_ratio: float = static_field(default=0.5)
    flow_integrator: str = static_field(default="rk4")  # "rk4" | "euler"
    # cond(S) diagnostic estimator: "power" (default — power/inverse
    # iteration off the already-computed Cholesky factor; a batched
    # eigvalsh per λ-step can cost more than the flow itself at d=144)
    # | "eigh" (exact, the
    # reference's np.linalg.cond semantics :239-243).
    cond_mode: str = static_field(default="power")


@pytree_dataclass
class FlowPFState:
    """Flow-PF posterior (reference ``PFState``, ``EDH_particle_filter.py:70``)."""

    particles: jax.Array  # (N, nx)
    weights: jax.Array  # (N,) normalized linear
    log_weights: jax.Array  # (N,)
    mean: jax.Array  # (nx,)
    cov: jax.Array  # (nx, nx)
    diagnostics: Dict[str, jax.Array]  # e.g. condition_numbers (n_lambda,)


def _rk4_affine(x, A, b, dt):
    """One RK4 step of the affine field f(x) = A x + b, batched over leading
    axes of x (replaces the per-particle loop at reference :277-280)."""
    f = lambda v: v @ A.T + b
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


class EDHFlowPF:
    """EDH flow PF with global linearization at the mean path.

    Parameters mirror the reference constructor (:140-178):
    ``g(x, u, v)``, ``h(x)``, ``jacobian_h(x)``, ``log_trans_pdf(x_k, x_km1)``,
    ``log_like_pdf(z, x)``, observation covariance ``R``; ``tracker`` is a
    :class:`~particle_filters_jax.models.trackers.GaussianTracker`.
    """

    def __init__(
        self,
        tracker: GaussianTracker,
        g: Callable,
        h: Callable,
        jacobian_h: Callable,
        log_trans_pdf: Callable,
        log_like_pdf: Callable,
        R,
        config: Optional[EDHConfig] = None,
        axis_name: Optional[str] = None,
    ) -> None:
        self.tracker = tracker
        self.g = g
        self.h = h
        self.Jh = jacobian_h
        self.log_trans_pdf = log_trans_pdf
        self.log_like_pdf = log_like_pdf
        self.R = jnp.asarray(R)
        self.cfg = config or EDHConfig()
        self.LR = chol_with_jitter(self.R, initial=1e-10)
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

    # ------------------------------- API --------------------------------

    def init_from_gaussian(self, key: jax.Array, mean0, cov0) -> FlowPFState:
        """Particles ~ N(mean0, cov0), uniform weights (reference :179)."""
        mean0 = jnp.asarray(mean0)
        cov0 = jnp.asarray(cov0)
        n = self.cfg.n_particles
        L = chol_with_jitter(cov0)
        particles = mean0 + jax.random.normal(key, (n, mean0.shape[0]), mean0.dtype) @ L.T
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

    def _flow_matrices(self, lam, etabar, P, z):
        """A(λ), b(λ), cond(S) at linearization point etabar (reference
        :230-264)."""
        nx = etabar.shape[0]
        I = jnp.eye(nx, dtype=etabar.dtype)
        H = self.Jh(etabar)
        e = self.h(etabar) - H @ etabar
        S = lam * (H @ P @ H.T) + self.R
        LS = chol_with_jitter(S, initial=1e-8)
        S_inv_H = chol_solve(LS, H)
        A = -0.5 * P @ H.T @ S_inv_H
        R_inv_innov = chol_solve(self.LR, z - e)
        b = (I + 2.0 * lam * A) @ ((I + lam * A) @ (P @ H.T @ R_inv_innov) + A @ etabar)
        # cond(S) diagnostic (reference's per-λ-step np.linalg.cond
        # :239-243). Default: power/inverse iteration reusing LS instead
        # of a batched eigvalsh per λ-step.
        if self.cfg.cond_mode == "eigh":
            cond = cond_spd(S)
        else:
            cond = cond_spd_power(symmetrize(S), chol_l=LS)
        return A, b, cond

    @with_f32_matmuls
    def step(
        self,
        key: jax.Array,
        state: FlowPFState,
        tracker_state: TrackerState,
        z,
        u=None,
        process_noise_sampler: Optional[Callable] = None,
    ) -> Tuple[FlowPFState, TrackerState]:
        """One EDH-PF step (reference ``step`` :182-317)."""
        z = jnp.asarray(z)
        n, nx = state.particles.shape
        k_noise, k_res = jax.random.split(key)

        # Tracker prediction (m_{k|k-1}, P)
        ts, m_pred, P = self.tracker.predict(tracker_state, u=u)
        P = symmetrize(P)

        # Propagate: η₀ⁱ = g(xⁱ, u, vⁱ) — vmapped (reference loop :206-208)
        if process_noise_sampler is None:
            v = jnp.zeros((n, nx), state.particles.dtype)
        else:
            v = process_noise_sampler(self._shard_key(k_noise), n, nx)
        eta0 = jax.vmap(lambda x, vi: self.g(x, u, vi))(state.particles, v)
        etabar0 = self.g(ts.past_mean, u, jnp.zeros(nx, state.particles.dtype))

        # λ-flow as a scan (reference loop :225-280)
        n_steps = max(1, int(self.cfg.n_lambda_steps))
        dlam = 1.0 / n_steps
        lams = jnp.minimum(
            (jnp.arange(n_steps, dtype=state.particles.dtype) + 1) * dlam, 1.0
        )

        euler = self.cfg.flow_integrator.lower() == "euler"

        def flow_step(carry, lam):
            eta, etabar = carry
            A, b, cond = self._flow_matrices(lam, etabar, P, z)
            if euler:
                eta_new = eta + dlam * (eta @ A.T + b)
                etabar_new = etabar + dlam * (A @ etabar + b)
            else:
                eta_new = _rk4_affine(eta, A, b, dlam)
                etabar_new = _rk4_affine(etabar, A, b, dlam)
            return (eta_new, etabar_new), cond

        (eta, _), conds = lax.scan(flow_step, (eta0, etabar0), lams)
        xk = eta

        # Invertible-flow weight correction (reference :285-298), vmapped
        log_corr = jax.vmap(
            lambda x_new, x_old, e0: self.log_trans_pdf(x_new, x_old)
            + self.log_like_pdf(z, x_new)
            - self.log_trans_pdf(e0, x_old)
        )(xk, state.particles, eta0)
        logw, _ = log_normalize(state.log_weights + log_corr, self.axis_name)

        # Tracker measurement update (reference :301)
        ts, _, _ = self.tracker.update(ts, z)

        # ESS-triggered systematic resample (reference :304-309). Sharded:
        # deterministic-per-key GLOBAL ancestry from an all_gather of the
        # cloud, each shard keeping its slice (same scheme as
        # ParticleFilter._maybe_resample; flow clouds are small enough —
        # N ≤ 10⁴ in every reference workload — that the gather is cheap).
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
    ):
        """Filter a (T, nz) sequence in one ``lax.scan``; returns the final
        (state, tracker_state) and stacked history (mean, cov, ess, cond)."""
        T = zs.shape[0]
        keys = jax.random.split(key, T)

        def body(carry, inp):
            st, ts = carry
            k, z = inp
            st, ts = self.step(
                k, st, ts, z, process_noise_sampler=process_noise_sampler
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
