"""1-D stochastic volatility model simulator.

Model (parity with reference ``simulator/simulator_sto_volatility_model.py:51``):

    X_1 ~ N(0, σ² / (1 − α²))         (stationary init, unless x0 given)
    X_t = α X_{t−1} + σ V_t,          V_t ~ N(0, 1)
    Y_t = β exp(X_t / 2) W_t,         W_t ~ N(0, 1)

This is the north-star SIR-PF benchmark workload (SURVEY.md §3.2, §6).
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from particle_filters_jax.core.structs import pytree_dataclass, static_field


@pytree_dataclass
class SV1DParams:
    alpha: jax.Array  # AR(1) coefficient, |alpha| < 1
    sigma: jax.Array  # state noise std >= 0
    beta: jax.Array  # observation scale >= 0


@pytree_dataclass
class SV1DResults:
    """X (n,), Y (n,) plus the generating parameters.

    Mirrors reference ``SV1DResults`` (``simulator_sto_volatility_model.py:9``)
    including the ``.npz`` keys of ``save`` (:37).
    """

    X: jax.Array
    Y: jax.Array
    alpha: float = static_field(default=0.0)
    sigma: float = static_field(default=0.0)
    beta: float = static_field(default=0.0)
    n: int = static_field(default=0)
    seed: Optional[int] = static_field(default=None)

    def save(self, filename: str) -> None:
        np.savez(
            filename,
            X=np.asarray(self.X),
            Y=np.asarray(self.Y),
            alpha=self.alpha,
            sigma=self.sigma,
            beta=self.beta,
            n=self.n,
            seed=self.seed if self.seed is not None else -1,
        )

    @classmethod
    def load(cls, filename: str) -> "SV1DResults":
        target = filename if filename.endswith(".npz") else f"{filename}.npz"
        with np.load(target) as d:
            seed = int(d["seed"])
            return cls(
                X=jnp.asarray(d["X"]),
                Y=jnp.asarray(d["Y"]),
                alpha=float(d["alpha"]),
                sigma=float(d["sigma"]),
                beta=float(d["beta"]),
                n=int(d["n"]),
                seed=None if seed == -1 else seed,
            )


def simulate_sv_1d(
    n: int,
    alpha: float,
    sigma: float,
    beta: float,
    *,
    seed: Union[int, jax.Array, None] = None,
    x0: Optional[float] = None,
    dtype=jnp.float32,
) -> SV1DResults:
    """Simulate the 1-D SV model; parity with reference ``simulate_sv_1d``
    (``simulator_sto_volatility_model.py:51``) including input validation
    (:88-95) and stationary initialization (:103-107).

    The AR(1) recursion is a ``lax.scan``; observations are one fused
    vectorized op (no time dependence given X).
    """
    if n <= 0:
        raise ValueError("n must be positive.")
    if not np.isfinite(alpha) or abs(alpha) >= 1:
        raise ValueError("alpha must be finite with |alpha| < 1 for stationarity.")
    if sigma < 0 or not np.isfinite(sigma):
        raise ValueError("sigma must be a finite, nonnegative scalar.")
    if beta < 0 or not np.isfinite(beta):
        raise ValueError("beta must be a finite, nonnegative scalar.")

    if seed is None:
        seed = 0
    key = jax.random.PRNGKey(int(seed)) if isinstance(seed, (int, np.integer)) else seed
    k0, kv, kw = jax.random.split(key, 3)

    alpha_ = jnp.asarray(alpha, dtype)
    sigma_ = jnp.asarray(sigma, dtype)
    beta_ = jnp.asarray(beta, dtype)

    if x0 is None:
        var0 = max(sigma**2 / (1.0 - alpha**2), 0.0)
        x_init = jnp.sqrt(jnp.asarray(var0, dtype)) * jax.random.normal(k0, (), dtype)
    else:
        x_init = jnp.asarray(float(x0), dtype)

    V = jax.random.normal(kv, (max(n - 1, 0),), dtype)

    def ar_step(x, v):
        x_next = alpha_ * x + sigma_ * v
        return x_next, x_next

    _, X_rest = lax.scan(ar_step, x_init, V)
    X = jnp.concatenate([x_init[None], X_rest]) if n > 1 else x_init[None]

    W = jax.random.normal(kw, (n,), dtype)
    Y = beta_ * jnp.exp(0.5 * X) * W

    return SV1DResults(
        X=X,
        Y=Y,
        alpha=float(alpha),
        sigma=float(sigma),
        beta=float(beta),
        n=int(n),
        seed=None if seed is None else (int(seed) if isinstance(seed, (int, np.integer)) else None),
    )


# --- SSM callables for the filters (g, h, log-densities) ------------------
def sv_transition_sample(key, params: SV1DParams, x, n_noise=None):
    """x' = α x + σ v, vectorized over leading axes of x."""
    v = jax.random.normal(key, x.shape, x.dtype)
    return params.alpha * x + params.sigma * v


def sv_transition_logpdf(params: SV1DParams, x_next, x):
    var = params.sigma**2
    z = (x_next - params.alpha * x) ** 2 / var
    return -0.5 * (z + jnp.log(var) + jnp.log(2 * jnp.pi))


def sv_obs_logpdf(params: SV1DParams, y, x):
    """log p(y|x) with y ~ N(0, β² exp(x))."""
    var = params.beta**2 * jnp.exp(x)
    return -0.5 * (y**2 / var + jnp.log(var) + jnp.log(2 * jnp.pi))
