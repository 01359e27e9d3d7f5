"""SPF condition-number machinery: κ₂(M) and dκ₂/dβ.

Reproduces the reference's ``tests/unit_tests/models/test_spf_condition_number.py``
(15 tests) against ``kappa2_and_derivative``
(``models/stochastic_particle_filter.py:108``, reference :123-167):
identity/diagonal/random-SPD values, symmetrization, derivative signs,
extreme conditioning stability.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.stochastic_particle_filter import (
    kappa2_and_derivative,
)


def _np_kappa(M):
    w = np.linalg.eigvalsh(np.asarray(M, np.float64))
    return abs(w[-1]) / abs(w[0])


class TestKappaValues:
    def test_identity(self):
        k, dk = kappa2_and_derivative(jnp.eye(3), jnp.zeros((3, 3)))
        assert np.isclose(float(k), 1.0, rtol=1e-5)
        assert np.isclose(float(dk), 0.0, atol=1e-6)

    def test_diagonal(self):
        M = jnp.diag(jnp.array([4.0, 2.0, 1.0]))
        k, _ = kappa2_and_derivative(M, jnp.zeros((3, 3)))
        assert np.isclose(float(k), 4.0, rtol=1e-5)

    def test_well_conditioned(self):
        M = jnp.array([[2.0, 0.1], [0.1, 2.0]])
        k, _ = kappa2_and_derivative(M, jnp.zeros((2, 2)))
        assert 1.0 <= float(k) < 1.2

    def test_ill_conditioned(self):
        M = jnp.diag(jnp.array([1e6, 1.0]))
        k, _ = kappa2_and_derivative(M, jnp.zeros((2, 2)))
        assert np.isclose(float(k), 1e6, rtol=1e-3)

    def test_random_spd(self, key):
        for i in range(5):
            A = jax.random.normal(jax.random.fold_in(key, i), (4, 4))
            M = A @ A.T + 0.5 * jnp.eye(4)
            k, _ = kappa2_and_derivative(M, jnp.zeros((4, 4)))
            assert np.isclose(float(k), _np_kappa(M), rtol=1e-3)

    def test_3d_case(self):
        M = jnp.diag(jnp.array([9.0, 3.0, 1.0]))
        k, _ = kappa2_and_derivative(M, jnp.eye(3))
        assert np.isclose(float(k), 9.0, rtol=1e-5)

    def test_scale_invariance(self):
        M = jnp.diag(jnp.array([5.0, 1.0]))
        k1, _ = kappa2_and_derivative(M, jnp.zeros((2, 2)))
        k2, _ = kappa2_and_derivative(100.0 * M, jnp.zeros((2, 2)))
        assert np.isclose(float(k1), float(k2), rtol=1e-4)


class TestSymmetrization:
    def test_asymmetric_input_symmetrized(self):
        """Reference symmetrizes before eigh (``test_kappa2_symmetrization``)."""
        M = jnp.array([[2.0, 1.0], [0.0, 1.0]])  # asymmetric
        Msym = 0.5 * (M + M.T)
        k, _ = kappa2_and_derivative(M, jnp.zeros((2, 2)))
        assert np.isclose(float(k), _np_kappa(Msym), rtol=1e-4)

    def test_asymmetric_derivative_matrix(self):
        M = jnp.diag(jnp.array([3.0, 1.0]))
        dM = jnp.array([[1.0, 2.0], [0.0, 1.0]])
        k, dk = kappa2_and_derivative(M, dM)
        # symmetrized dM is [[1,1],[1,1]]: dλ_max = dλ_min = 1
        # dκ = 1/1 − 3·1/1 = −2
        assert np.isclose(float(dk), -2.0, rtol=1e-4)


class TestDerivative:
    def test_zero_derivative_matrix(self):
        M = jnp.diag(jnp.array([7.0, 2.0]))
        _, dk = kappa2_and_derivative(M, jnp.zeros((2, 2)))
        assert np.isclose(float(dk), 0.0, atol=1e-6)

    def test_derivative_sign_growing_lmax(self):
        """dM that only grows λ_max ⇒ dκ > 0."""
        M = jnp.diag(jnp.array([3.0, 1.0]))
        dM = jnp.diag(jnp.array([1.0, 0.0]))
        _, dk = kappa2_and_derivative(M, dM)
        assert float(dk) > 0

    def test_derivative_sign_growing_lmin(self):
        """dM that only grows λ_min ⇒ dκ < 0."""
        M = jnp.diag(jnp.array([3.0, 1.0]))
        dM = jnp.diag(jnp.array([0.0, 1.0]))
        _, dk = kappa2_and_derivative(M, dM)
        assert float(dk) < 0

    def test_matches_finite_difference(self, key):
        """First-order perturbation vs numeric dκ/dβ on a random SPD path."""
        A = jax.random.normal(key, (3, 3))
        M0 = A @ A.T + jnp.eye(3)
        B = jax.random.normal(jax.random.fold_in(key, 1), (3, 3))
        Mh = B @ B.T  # SPD increment keeps eigenvalues simple
        _, dk = kappa2_and_derivative(M0, Mh)
        eps = 1e-4
        k_hi, _ = kappa2_and_derivative(M0 + eps * Mh, Mh)
        k_lo, _ = kappa2_and_derivative(M0 - eps * Mh, Mh)
        fd = (float(k_hi) - float(k_lo)) / (2 * eps)
        assert np.isclose(float(dk), fd, rtol=5e-2, atol=1e-3)


class TestStability:
    def test_near_singular_regularized(self):
        """eps floor keeps κ finite on a singular matrix (reference's eigh
        fallback :149-153 analog)."""
        M = jnp.diag(jnp.array([1.0, 0.0]))
        k, dk = kappa2_and_derivative(M, jnp.eye(2))
        assert np.isfinite(float(k))
        assert np.isfinite(float(dk))

    def test_extreme_conditioning(self):
        M = jnp.diag(jnp.array([1e12, 1e-6]))
        k, _ = kappa2_and_derivative(M, jnp.zeros((2, 2)))
        assert np.isfinite(float(k))
        assert float(k) > 1e15

    def test_jit_and_vmap(self):
        Ms = jnp.stack([jnp.diag(jnp.array([float(i + 2), 1.0])) for i in range(4)])
        ks, _ = jax.jit(jax.vmap(lambda M: kappa2_and_derivative(M, jnp.eye(2))))(Ms)
        np.testing.assert_allclose(np.asarray(ks), [2.0, 3.0, 4.0, 5.0], rtol=1e-5)
