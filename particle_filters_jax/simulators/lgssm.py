"""Linear Gaussian state-space model simulator.

Model (capability parity with reference ``simulator/simulator_LGSSM.py:66``):

    x_1 ~ N(0, Σ)
    x_{n+1} = A x_n + B v_n,  v_n ~ N(0, I)
    y_n     = C x_n + D w_n,  w_n ~ N(0, I)

Design: the time recursion is a single ``lax.scan`` over a pure
step function (the reference uses a Python loop,
``simulator_LGSSM.py:133-139``); all noise is drawn up front as one batched
``jax.random.normal`` so the scan body is two matmuls.
"""

from __future__ import annotations

import os
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from particle_filters_jax.core.structs import pytree_dataclass
from particle_filters_jax.core.linalg import chol_with_jitter


@pytree_dataclass
class LGSSMParams:
    """System matrices for the LGSSM (pytree; jit/vmap-safe)."""

    A: jax.Array  # (nx, nx)
    B: jax.Array  # (nx, nv)
    C: jax.Array  # (ny, nx)
    D: jax.Array  # (ny, nw)
    Sigma: jax.Array  # (nx, nx) initial-state covariance


@pytree_dataclass
class LGSSMSimulationResult:
    """Simulated LGSSM data: latent states X (N, nx) and observations Y (N, ny).

    Mirrors reference ``LGSSMSimulationResult``
    (``simulator/simulator_LGSSM.py:10``) including the ``.npz`` layout of
    ``to_file`` (:36): keys X, Y, A, B, C, D.
    """

    X: jax.Array
    Y: jax.Array
    A: jax.Array
    B: jax.Array
    C: jax.Array
    D: jax.Array

    def to_file(self, path: str, format: str = "npz", overwrite: bool = False) -> None:
        if format != "npz":
            raise ValueError(f"Unsupported format: {format!r} (only 'npz').")
        target = path if path.endswith(".npz") else f"{path}.npz"
        if os.path.exists(target) and not overwrite:
            raise FileExistsError(f"File already exists: {target}")
        np.savez(
            target,
            X=np.asarray(self.X),
            Y=np.asarray(self.Y),
            A=np.asarray(self.A),
            B=np.asarray(self.B),
            C=np.asarray(self.C),
            D=np.asarray(self.D),
        )

    # alias used elsewhere in this package
    save = to_file

    @classmethod
    def from_file(cls, path: str) -> "LGSSMSimulationResult":
        target = path if path.endswith(".npz") else f"{path}.npz"
        with np.load(target) as d:
            return cls(
                X=jnp.asarray(d["X"]),
                Y=jnp.asarray(d["Y"]),
                A=jnp.asarray(d["A"]),
                B=jnp.asarray(d["B"]),
                C=jnp.asarray(d["C"]),
                D=jnp.asarray(d["D"]),
            )


def _as_key(seed: Union[int, jax.Array, None]) -> jax.Array:
    if seed is None:
        seed = 0
    if isinstance(seed, (int, np.integer)):
        return jax.random.PRNGKey(int(seed))
    return seed


def simulate_lgssm(
    A,
    B,
    C,
    D,
    Sigma,
    N: int,
    *,
    seed: Union[int, jax.Array, None] = None,
    burn_in: int = 0,
    dtype=jnp.float32,
) -> LGSSMSimulationResult:
    """Simulate N steps of the LGSSM (after ``burn_in`` discarded steps).

    Parity with reference ``simulate_lgssm`` (``simulator_LGSSM.py:66``):
    same model, same result fields; randomness comes from a JAX key instead
    of NumPy PCG64 (statistical, not bitwise, parity — see SURVEY.md §7).
    """
    if N <= 0:
        raise ValueError("N must be positive.")
    if burn_in < 0:
        raise ValueError("burn_in must be >= 0.")

    A = jnp.asarray(A, dtype)
    B = jnp.asarray(B, dtype)
    C = jnp.asarray(C, dtype)
    D = jnp.asarray(D, dtype)
    Sigma = jnp.asarray(Sigma, dtype)
    nx, nv = B.shape
    ny, nw = D.shape
    if A.shape != (nx, nx):
        raise ValueError(f"A must be ({nx},{nx}), got {A.shape}.")
    if C.shape[1] != nx:
        raise ValueError(f"C must have {nx} columns, got {C.shape}.")

    key = _as_key(seed)
    k0, kv, kw = jax.random.split(key, 3)

    # x_1 ~ N(0, Σ) via Cholesky (jitter-robust on f32)
    L0 = chol_with_jitter(Sigma)
    x0 = L0 @ jax.random.normal(k0, (nx,), dtype)

    total = burn_in + N
    V = jax.random.normal(kv, (total, nv), dtype)  # process noise, all steps
    W = jax.random.normal(kw, (N, nw), dtype)  # measurement noise, recorded steps

    def burn_step(x, v):
        return A @ x + B @ v, None

    x_start, _ = lax.scan(burn_step, x0, V[:burn_in]) if burn_in > 0 else (x0, None)

    def step(x, inputs):
        v, w = inputs
        y = C @ x + D @ w
        x_next = A @ x + B @ v
        return x_next, (x, y)

    _, (X, Y) = lax.scan(step, x_start, (V[burn_in:], W))
    return LGSSMSimulationResult(X=X, Y=Y, A=A, B=B, C=C, D=D)


def lgssm_noise_covs(params: LGSSMParams):
    """Process / measurement covariances Q = BBᵀ, R = DDᵀ for the filters."""
    Q = params.B @ params.B.T
    R = params.D @ params.D.T
    return Q, R
