"""Resampling mechanism tests.

Reproduces the reference's resampling test archetypes
(``tests/unit_tests/models/test_pf_resampling.py``): favors high weights,
uniform output, edge cases — plus the differentiable resamplers' gradient
and distribution properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.core.weights import log_normalize, uniform_logw
from particle_filters_jax.resampling import (
    RNNResampler,
    multinomial_resample,
    ot_resample,
    resample_indices,
    residual_resample,
    sinkhorn_ot_resample,
    soft_resample,
    stratified_resample,
    systematic_resample,
)
from particle_filters_jax.resampling.hard import systematic_resample_values

METHODS = ["systematic", "multinomial", "stratified", "residual"]


class TestHardResampling:
    @pytest.mark.parametrize("method", METHODS)
    def test_indices_valid(self, key, method):
        w = jax.nn.softmax(jax.random.normal(key, (100,)))
        idx = resample_indices(method, key, w)
        assert idx.shape == (100,)
        assert idx.dtype == jnp.int32
        assert np.all(np.asarray(idx) >= 0) and np.all(np.asarray(idx) < 100)

    @pytest.mark.parametrize("method", METHODS)
    def test_favors_high_weights(self, key, method):
        """The dominant particle gets most copies (reference
        ``test_pf_resampling.py:76``)."""
        n = 100
        w = jnp.full((n,), 0.002).at[7].set(1.0 - 0.002 * (n - 1))
        idx = resample_indices(method, key, w)
        frac = float(jnp.mean((idx == 7).astype(jnp.float32)))
        assert frac > 0.6

    @pytest.mark.parametrize("method", METHODS)
    def test_uniform_weights_counts(self, key, method):
        """Uniform weights: systematic/stratified/residual give each particle
        exactly one copy; multinomial close on average."""
        n = 64
        idx = resample_indices(method, key, jnp.full((n,), 1.0 / n))
        counts = np.bincount(np.asarray(idx), minlength=n)
        if method in ("systematic", "stratified", "residual"):
            np.testing.assert_array_equal(counts, np.ones(n))
        else:
            assert counts.sum() == n

    def test_systematic_counts_within_one_of_expected(self, key):
        """Systematic resampling guarantees |count_j − N·w_j| ≤ 1."""
        n = 1000
        w = jax.nn.softmax(jax.random.normal(key, (n,)) * 2)
        idx = systematic_resample(key, w)
        counts = np.bincount(np.asarray(idx), minlength=n)
        assert np.max(np.abs(counts - n * np.asarray(w))) <= 1.0 + 1e-3

    def test_systematic_accepts_logw(self, key):
        w = jax.nn.softmax(jax.random.normal(key, (50,)))
        i1 = systematic_resample(key, w)
        i2 = systematic_resample(key, logw=jnp.log(w))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    def test_values_matches_index_gather(self, key):
        """Gather-free telescoping path == indices+gather path."""
        for n, d in [(5, 1), (64, 3), (1000, 2)]:
            w = jax.nn.softmax(jax.random.normal(jax.random.fold_in(key, n), (n,)) * 2)
            p = jax.random.normal(jax.random.fold_in(key, n + 1), (n, d))
            idx = systematic_resample(key, w)
            v = systematic_resample_values(key, p, w=w)
            np.testing.assert_allclose(
                np.asarray(jnp.take(p, idx, axis=0)),
                np.asarray(v),
                atol=1e-4,
            )

    def test_single_particle(self, key):
        """Np=1 edge case (reference ``test_pf_resampling.py:338``)."""
        idx = systematic_resample(key, jnp.ones(1))
        assert int(idx[0]) == 0

    def test_multinomial_unbiased(self, key):
        n = 50
        w = jax.nn.softmax(jax.random.normal(key, (n,)))
        counts = np.zeros(n)
        for i in range(200):
            idx = multinomial_resample(jax.random.fold_in(key, i), w)
            counts += np.bincount(np.asarray(idx), minlength=n)
        freq = counts / counts.sum()
        np.testing.assert_allclose(freq, np.asarray(w), atol=0.02)

    def test_residual_deterministic_floor(self, key):
        """Residual resampling gives at least ⌊N·w⌋ copies of each particle."""
        # Dyadic weights: exactly representable in f32, so the floor
        # guarantee is exact (non-dyadic weights can lose a deterministic
        # copy to f32 rounding, which residual resampling legitimately
        # reassigns to the residual pool).
        n = 8
        w = jnp.array([12.0, 8.0, 4.0, 4.0, 1.0, 1.0, 1.0, 1.0]) / 32.0
        idx = residual_resample(key, w)
        counts = np.bincount(np.asarray(idx), minlength=n)
        floor = np.floor(n * np.asarray(w))
        assert np.all(counts >= floor)

    def test_unknown_method_raises(self, key):
        with pytest.raises(ValueError, match="Unknown resample"):
            resample_indices("bogus", key, jnp.ones(4) / 4)


class TestSoftResampling:
    def test_shapes_and_uniform_weights(self, key):
        n, d = 32, 2
        p = jax.random.normal(key, (n, d))
        logw = jax.random.normal(key, (n,))
        new_p, new_logw = soft_resample(key, p, logw, alpha=0.5, temperature=0.5)
        assert new_p.shape == (n, d)
        np.testing.assert_allclose(
            np.asarray(jnp.exp(new_logw)), np.full(n, 1.0 / n), atol=1e-5
        )

    def test_batched(self, key):
        b, n, d = 4, 16, 3
        p = jax.random.normal(key, (b, n, d))
        logw = jax.random.normal(key, (b, n))
        new_p, new_logw = soft_resample(key, p, logw)
        assert new_p.shape == (b, n, d)
        assert new_logw.shape == (b, n)

    def test_differentiable(self, key):
        n, d = 16, 2
        p = jax.random.normal(key, (n, d))
        logw = jax.random.normal(key, (n,))

        def loss(p):
            q, _ = soft_resample(key, p, logw, temperature=0.5)
            return jnp.sum(q**2)

        g = jax.grad(loss)(p)
        assert np.all(np.isfinite(np.asarray(g)))
        assert float(jnp.max(jnp.abs(g))) > 0

    def test_low_temperature_concentrates(self, key):
        """Cold Gumbel-Softmax → barycenters near single ancestors."""
        n = 64
        p = jnp.arange(n, dtype=jnp.float32)[:, None]
        logw, _ = log_normalize(jnp.zeros(n))
        new_p, _, aux = soft_resample(
            key, p, logw, alpha=0.0, temperature=0.01, return_aux=True
        )
        assert float(aux["assignment_entropy_mean"]) < 0.1

    def test_alpha_one_is_uniform_proposal(self, key):
        """α=1: proposal ignores weights entirely."""
        n = 32
        p = jax.random.normal(key, (n, 1))
        logw = jnp.log(jnp.zeros(n).at[0].set(1.0) + 1e-20)
        _, _, aux = soft_resample(
            key, p, logw, alpha=1.0, temperature=1.0, return_aux=True
        )
        # With a uniform mixture, entropy of assignments stays high.
        assert float(aux["assignment_entropy_mean"]) > 2.0


class TestOTResampling:
    def test_shapes_and_uniform_weights(self, key):
        n, d = 20, 2
        p = jax.random.normal(key, (n, d))
        w = jax.nn.softmax(jax.random.normal(key, (n,)))
        new_p, new_w = sinkhorn_ot_resample(p, w, epsilon=0.2, n_iters=30)
        assert new_p.shape == (n, d)
        np.testing.assert_allclose(np.asarray(new_w), np.full(n, 1.0 / n), atol=1e-6)

    def test_preserves_weighted_mean(self, key):
        """Barycentric projection preserves Σ wᵢ xᵢ (mass conservation)."""
        n, d = 30, 2
        p = jax.random.normal(key, (n, d))
        w = jax.nn.softmax(jax.random.normal(key, (n,)) * 2)
        new_p, new_w = sinkhorn_ot_resample(p, w, epsilon=0.2, n_iters=200)
        np.testing.assert_allclose(
            np.asarray(w @ p), np.asarray(new_w @ new_p), atol=8e-2
        )

    def test_converges(self, key):
        n = 16
        p = jax.random.normal(key, (n, 1))
        w = jax.nn.softmax(jax.random.normal(key, (n,)))
        _, _, diag = sinkhorn_ot_resample(
            p, w, epsilon=0.5, n_iters=100, return_diagnostics=True
        )
        assert float(diag["final_delta"]) < 1e-3

    def test_differentiable(self, key):
        n, d = 12, 2
        p = jax.random.normal(key, (n, d))
        logw = jax.random.normal(key, (n,))

        def loss(p):
            q, _ = ot_resample(key, p, logw, n_iters=15)
            return jnp.sum(q**2)

        g = jax.grad(loss)(p)
        assert np.all(np.isfinite(np.asarray(g)))

    def test_degenerate_weights_stable(self, key):
        """Near-degenerate weights must not blow up (reference
        ``test_dpf_ot_vs_simulator_lgssm.py:451``)."""
        n = 16
        p = jax.random.normal(key, (n, 2))
        w = jnp.full((n,), 1e-12).at[3].set(1.0)
        new_p, _ = sinkhorn_ot_resample(p, w / jnp.sum(w), epsilon=0.1, n_iters=50)
        assert np.all(np.isfinite(np.asarray(new_p)))
        # All mass at particle 3 → every output near p[3].
        np.testing.assert_allclose(
            np.asarray(new_p), np.tile(np.asarray(p[3]), (n, 1)), atol=1e-2
        )


class TestRNNResampling:
    def test_shapes(self, key):
        n, d = 12, 2
        rs = RNNResampler(n, d, hidden_dim=8)
        params = rs.init(key)
        p = jax.random.normal(key, (n, d))
        logw = jax.random.normal(key, (n,))
        new_p, new_logw = rs.apply(params, key, p, logw)
        assert new_p.shape == (n, d)
        np.testing.assert_allclose(
            np.asarray(jnp.exp(new_logw)), np.full(n, 1.0 / n), atol=1e-5
        )

    def test_near_uniform_initial_assignments(self, key):
        """Near-zero output init → near-uniform assignments (reference
        ``_initialize_sensible_weights`` :127)."""
        n = 10
        rs = RNNResampler(n, 2, hidden_dim=8)
        params = rs.init(key)
        p = jax.random.normal(key, (n, 2))
        logw = jax.random.normal(key, (n,))
        _, _, aux = rs.apply(params, key, p, logw, return_aux=True)
        assert float(aux["assignment_entropy_mean"]) > 0.9 * np.log(n)

    def test_lstm_variant(self, key):
        rs = RNNResampler(8, 2, hidden_dim=8, rnn_type="lstm")
        params = rs.init(key)
        p = jax.random.normal(key, (8, 2))
        new_p, _ = rs.apply(params, key, p, jnp.zeros(8))
        assert np.all(np.isfinite(np.asarray(new_p)))

    def test_baseline_mode_follows_weights(self, key):
        n = 16
        rs = RNNResampler(n, 1, use_baseline_resampling=True, temperature=0.2)
        params = rs.init(key)
        p = jnp.arange(n, dtype=jnp.float32)[:, None]
        logw, _ = log_normalize(jnp.log(jnp.zeros(n).at[5].set(1.0) + 1e-20))
        new_p, _ = rs.apply(params, key, p, logw)
        # Dominant ancestor 5 → barycenters near 5.
        assert float(jnp.mean(jnp.abs(new_p - 5.0))) < 1.5

    def test_trainable(self, key):
        n, d = 6, 1
        rs = RNNResampler(n, d, hidden_dim=4)
        params = rs.init(key)
        p = jax.random.normal(key, (n, d))
        logw = jnp.zeros(n)

        def loss(params):
            q, _ = rs.apply(params, key, p, logw)
            return jnp.sum((q - 1.0) ** 2)

        g = jax.grad(loss)(params)
        leaves = jax.tree_util.tree_leaves(g)
        assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
        assert any(float(jnp.max(jnp.abs(l))) > 0 for l in leaves)

    def test_invalid_rnn_type_raises(self):
        with pytest.raises(ValueError, match="Unknown RNN type"):
            RNNResampler(4, 1, rnn_type="transformer")


class TestOTBlockwise:
    """Blockwise Sinkhorn (never materializes N×N) vs the dense path."""

    def test_matches_dense(self, key):
        from particle_filters_jax.resampling import (
            sinkhorn_ot_resample,
            sinkhorn_ot_resample_blockwise,
        )

        for n, d, block in [(100, 2, 32), (130, 1, 64)]:
            p = jax.random.normal(jax.random.fold_in(key, n), (n, d))
            w = jax.nn.softmax(jax.random.normal(key, (n,)) * 1.5)
            d_p, d_w = sinkhorn_ot_resample(p, w, epsilon=0.2, n_iters=25)
            b_p, b_w = sinkhorn_ot_resample_blockwise(
                p, w, epsilon=0.2, n_iters=25, block=block
            )
            np.testing.assert_allclose(
                np.asarray(d_p), np.asarray(b_p), atol=1e-4
            )
            np.testing.assert_allclose(np.asarray(d_w), np.asarray(b_w))

    def test_ragged_n_padding(self, key):
        """N not a multiple of the block size is handled by padding."""
        from particle_filters_jax.resampling import sinkhorn_ot_resample_blockwise

        n = 77
        p = jax.random.normal(key, (n, 2))
        w = jax.nn.softmax(jax.random.normal(key, (n,)))
        b_p, b_w = sinkhorn_ot_resample_blockwise(p, w, n_iters=10, block=32)
        assert b_p.shape == (n, 2)
        assert np.all(np.isfinite(np.asarray(b_p)))

    def test_differentiable(self, key):
        from particle_filters_jax.resampling import ot_resample_blockwise

        p = jax.random.normal(key, (64, 2))
        lw = jax.random.normal(key, (64,))

        def loss(p):
            q, _ = ot_resample_blockwise(key, p, lw, n_iters=5, block=32)
            return jnp.sum(q**2)

        g = jax.grad(loss)(p)
        assert np.all(np.isfinite(np.asarray(g)))


class TestSystematicCounts:
    """``systematic_counts`` must agree with ``systematic_resample`` exactly:
    same key ⇒ the counts are the ancestor-index bincount (they share the
    inverse-CDF convention — see CLAUDE.md design invariants)."""

    def test_matches_ancestor_bincount(self, key):
        from particle_filters_jax.resampling.hard import systematic_counts

        n = 128
        lw = jax.random.normal(key, (n,)) * 2.0
        idx = systematic_resample(key, logw=lw)
        counts = systematic_counts(key, logw=lw)
        np.testing.assert_array_equal(
            np.asarray(counts), np.bincount(np.asarray(idx), minlength=n)
        )

    def test_sum_is_n(self, key):
        from particle_filters_jax.resampling.hard import systematic_counts

        for n in (1, 7, 64):
            w = jax.nn.softmax(jax.random.normal(jax.random.fold_in(key, n), (n,)))
            counts = systematic_counts(key, w)
            assert int(jnp.sum(counts)) == n

    def test_point_mass(self, key):
        from particle_filters_jax.resampling.hard import systematic_counts

        n = 32
        w = jnp.zeros((n,)).at[5].set(1.0)
        counts = systematic_counts(key, w)
        assert int(counts[5]) == n
        assert int(jnp.sum(counts)) == n


class TestResampleValuesFromStarts:
    """``systematic_resample_values`` (sorted starts → integer mark
    cumsum → gather) against the ancestor-index path of ``hard.py`` and a
    NumPy oracle, across weight regimes. The values are pure selection, so
    every comparison is exact."""

    @staticmethod
    def _oracle(starts, p):
        idx = np.searchsorted(starts, np.arange(p.shape[0]), side="right") - 1
        return p[idx]

    def _run(self, key, w, d):
        from particle_filters_jax.resampling.hard import (
            _systematic_starts,
            systematic_resample_values,
        )

        n = w.shape[0]
        p = jax.random.normal(jax.random.fold_in(key, 1), (n, d))
        v = np.asarray(systematic_resample_values(key, p, w=w))
        v_idx = np.asarray(jnp.take(p, systematic_resample(key, w), axis=0))
        starts = np.asarray(_systematic_starts(key, w, n))
        np.testing.assert_array_equal(v, v_idx)
        np.testing.assert_array_equal(v, self._oracle(starts, np.asarray(p)))
        return v

    def test_exact_smooth_weights(self, key):
        w = jax.nn.softmax(jax.random.normal(key, (4096,)))
        self._run(key, w, 1)

    def test_exact_near_uniform_weights(self, key):
        k = jax.random.fold_in(key, 9)
        w = jax.nn.softmax(0.05 * jax.random.normal(k, (4096,)))
        self._run(k, w, 1)

    def test_exact_heavy_weights_multi_dim(self, key):
        k = jax.random.fold_in(key, 7)
        w = jax.nn.softmax(3.0 * jax.random.normal(k, (4096,)))
        self._run(k, w, 2)

    def test_exact_tail_block(self, key):
        """A ragged N (not a multiple of any block width)."""
        k = jax.random.fold_in(key, 8)
        w = jax.nn.softmax(2.0 * jax.random.normal(k, (3000,)))
        self._run(k, w, 1)

    def test_moderate_degeneracy_exact(self, key):
        """A 640-particle near-zero-weight run starting mid-block: the
        outputs around the gap draw real ancestors on both sides of it."""
        n = 4096
        w = jnp.ones((n,)).at[64:704].set(1e-6)
        w = w / jnp.sum(w)
        v = self._run(jax.random.fold_in(key, 3), w, 4)
        assert v.shape == (n, 4)

    def test_degenerate_point_mass(self, key):
        n = 4096
        w = jnp.zeros(n).at[321].set(1.0)  # one particle takes every slot
        p = jax.random.normal(key, (n, 2))
        from particle_filters_jax.resampling.hard import (
            systematic_resample_values,
        )

        v = systematic_resample_values(jax.random.PRNGKey(1), p, w=w)
        np.testing.assert_array_equal(
            np.asarray(v), np.tile(np.asarray(p[321]), (n, 1))
        )
        self._run(key, w, 2)

    def test_run_ends_sorted_under_heavy_weights(self, key):
        """At N = 2^20 with heavy-tailed weights the blocked float prefix
        sum is not monotone in rounding; the run ends (and so the starts)
        must still come out sorted, or a slot would get no single
        ancestor."""
        from particle_filters_jax.resampling.hard import (
            _child_run_ends,
            systematic_counts,
        )

        n = 1 << 20
        k = jax.random.PRNGKey(201)
        w = jax.nn.softmax(3.0 * jax.random.normal(k, (n,)))
        t = np.asarray(_child_run_ends(jax.random.fold_in(k, 1), w, n))
        assert np.all(np.diff(t) >= 0)
        assert t[-1] == n
        counts = np.asarray(systematic_counts(jax.random.fold_in(k, 1), w))
        assert counts.min() >= 0 and counts.sum() == n


class TestBlockedCumsum:
    """core.block_cumsum: the two-level blocked prefix sum behind the
    resample starts."""

    def test_int_exact_across_sizes(self, key):
        from particle_filters_jax.core.block_cumsum import blocked_cumsum

        for n in [1, 7, 128, 16383, 16384, 16385, 1 << 17, (1 << 17) + 129]:
            x = jax.random.randint(
                jax.random.fold_in(key, n), (n,), -5, 6, jnp.int32
            )
            np.testing.assert_array_equal(
                np.asarray(blocked_cumsum(x)), np.cumsum(np.asarray(x))
            )

    def test_float_close_and_total_consistent(self, key):
        from particle_filters_jax.core.block_cumsum import blocked_cumsum

        n = (1 << 17) + 3  # ragged: exercises the zero-pad path
        x = jax.nn.softmax(jax.random.normal(key, (n,)))
        got = np.asarray(blocked_cumsum(x))
        ref = np.cumsum(np.asarray(x, np.float64))
        assert np.max(np.abs(got - ref)) < 1e-5
        assert got.shape == (n,)
        # monotone non-decreasing for nonnegative inputs
        assert np.all(np.diff(got) >= -1e-7)

    def test_starts_convention_shared_by_all_paths(self, key):
        """The inverse-CDF convention is whatever _child_run_ends computes:
        index, counts, and values paths must stay mutually consistent after
        the blocked-cumsum swap (N above the blocking threshold)."""
        from particle_filters_jax.resampling.hard import (
            systematic_counts,
            systematic_resample,
            systematic_resample_values,
        )

        n = 1 << 15
        w = jax.nn.softmax(
            2.0 * jax.random.normal(jax.random.fold_in(key, 1), (n,))
        )
        p = jax.random.normal(jax.random.fold_in(key, 2), (n, 1))
        idx = systematic_resample(key, w)
        counts = systematic_counts(key, w=w)
        vals = systematic_resample_values(key, p, w=w)
        np.testing.assert_array_equal(
            np.asarray(jnp.bincount(idx, length=n)), np.asarray(counts)
        )
        np.testing.assert_allclose(
            np.asarray(jnp.take(p, idx, axis=0)), np.asarray(vals), atol=1e-4
        )
