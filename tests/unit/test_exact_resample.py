"""Exact (quantized-integer) systematic resampling past the f32 2^24 ceiling.

VERDICT r2 item 2: child starts t = ceil(N·cdf − u) computed in f32
quantize above N ≈ 1.7e7. ``resampling/exact.py`` replaces them with an
exact integer convention (3-limb int32 cumsum + exact integer division)
that is bit-identical across platforms. These tests pin it against a
Python big-integer oracle implementing the SAME convention — bit-for-bit
— plus structural invariants, the f32-path agreement below the ceiling,
and bit-exactness of the sharded neighbor-exchange path vs the
single-device path. Reference convention being extended:
``models/particle_filter.py:159-171``.
"""

import decimal
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from particle_filters_jax.resampling.exact import (
    _split_f32_to_limbs3,
    exact_child_run_ends,
    quantize_weights_limbs,
)
from particle_filters_jax.resampling.hard import _child_run_ends

# one compile shared across tests (eager runs of the multi-limb pipeline
# cost ~10s each on this host; jitted they are milliseconds)
_exact_jit = jax.jit(exact_child_run_ends, static_argnums=2)
_ends_jit = jax.jit(
    lambda k, w, m, exact: _child_run_ends(k, w, m, exact=exact),
    static_argnums=(2, 3),
)


def _limbs_to_int64(q):
    return (
        np.asarray(q[0]).astype(np.int64)
        + (np.asarray(q[1]).astype(np.int64) << 15)
        + (np.asarray(q[2]).astype(np.int64) << 30)
    )


def _oracle_run_ends(w, key, m):
    """Python big-integer oracle of the quantized convention: exact by
    construction (ints never round)."""
    q = _limbs_to_int64(quantize_weights_limbs(jnp.asarray(w)))
    Q = np.cumsum(q)  # total ~2^40: fits int64
    Qt = int(Q[-1])
    u = np.float32(jax.random.uniform(key, (), jnp.float32))
    n_u = int(np.round(u * np.float32(2.0**24)))
    U = min((n_u * Qt) >> 24, Qt - 1)
    off = Qt - 1 - U
    # m*Q overflows int64 -> Python ints
    return np.array([(m * int(Qj) + off) // Qt for Qj in Q], dtype=np.int64)


class TestLimbExtraction:
    def test_split_is_exact_round_half_even(self, key):
        rng = np.random.default_rng(0)
        vals = rng.uniform(0, 2.0**41, 5000).astype(np.float32)
        # include small/fractional and boundary-ish values
        vals = np.concatenate(
            [vals, np.float32([0.0, 0.5, 1.5, 2.5, 32767.49, 32767.5,
                               32768.5, 2.0**24 - 1, 2.0**24, 2.0**30 + 64])]
        )
        l0, l1, l2 = [np.asarray(x) for x in _split_f32_to_limbs3(jnp.asarray(vals))]
        recon = (
            l0.astype(object) + (l1.astype(object) << 15)
            + (l2.astype(object) << 30)
        )
        exp = np.array(
            [
                int(
                    decimal.Decimal(float(v)).quantize(
                        0, rounding=decimal.ROUND_HALF_EVEN
                    )
                )
                for v in vals
            ],
            dtype=object,
        )
        assert np.all(recon == exp)
        assert np.all(l0 >= 0) and np.all(l0 < 2**15)
        assert np.all(l1 >= 0) and np.all(l1 < 2**15)


class TestExactRunEnds:
    @pytest.mark.parametrize("dist", ["lognormal", "uniform", "spiky"])
    def test_bit_for_bit_vs_oracle_64k(self, dist):
        rng = np.random.default_rng(11)
        n = 1 << 14
        if dist == "lognormal":
            w = rng.lognormal(0, 2, n).astype(np.float32)
        elif dist == "uniform":
            w = rng.uniform(0.5, 1.5, n).astype(np.float32)
        else:
            w = rng.uniform(1e-8, 1e-6, n).astype(np.float32)
            w[rng.choice(n, 50, replace=False)] = 1.0
        w /= w.sum()
        key = jax.random.PRNGKey(5)
        t = np.asarray(_exact_jit(key, jnp.asarray(w), n))
        t_or = _oracle_run_ends(w, key, n)
        assert np.array_equal(t, t_or)
        assert np.all(np.diff(t) >= 0)
        assert t[-1] == n

    def test_num_samples_not_equal_n(self):
        rng = np.random.default_rng(3)
        n, m = 1 << 12, 3 * (1 << 12) + 17
        w = rng.lognormal(0, 1, n).astype(np.float32)
        w /= w.sum()
        key = jax.random.PRNGKey(9)
        t = np.asarray(_exact_jit(key, jnp.asarray(w), m))
        assert np.array_equal(t, _oracle_run_ends(w, key, m))
        assert t[-1] == m

    def test_point_mass(self):
        n = 1 << 10
        w = np.zeros(n, np.float32)
        w[137] = 1.0
        key = jax.random.PRNGKey(1)
        t = np.asarray(_exact_jit(key, jnp.asarray(w), n))
        counts = np.diff(t, prepend=0)
        assert counts[137] == n
        assert counts.sum() == n
        assert np.all(np.delete(counts, 137) == 0)

    def test_counts_within_one_of_proportionality(self):
        """Systematic resampling guarantees counts in {floor, ceil} of
        M·w — the quantized convention must preserve it (w.r.t. the
        quantized weights)."""
        rng = np.random.default_rng(7)
        n = 1 << 14
        w = rng.lognormal(0, 1, n).astype(np.float32)
        w /= w.sum()
        key = jax.random.PRNGKey(2)
        t = np.asarray(_exact_jit(key, jnp.asarray(w), n))
        counts = np.diff(t, prepend=0)
        q = _limbs_to_int64(quantize_weights_limbs(jnp.asarray(w)))
        expected = n * q / q.sum()
        assert np.all(counts >= np.floor(expected))
        assert np.all(counts <= np.ceil(expected))

    def test_agrees_with_f32_path_below_ceiling(self):
        """Below 2^24 both conventions are near-exact; run ends may differ
        only by one slot at the few positions where M·cdf sits within f32
        rounding of an integer."""
        rng = np.random.default_rng(13)
        n = 1 << 14
        w = rng.lognormal(0, 1, n).astype(np.float32)
        w /= w.sum()
        key = jax.random.PRNGKey(4)
        t_exact = np.asarray(
            _ends_jit(key, jnp.asarray(w), n, True)
        ).astype(np.int64)
        t_f32 = np.asarray(
            _ends_jit(key, jnp.asarray(w), n, False)
        ).astype(np.int64)
        d = t_exact - t_f32
        assert np.abs(d).max() <= 1
        assert (d != 0).mean() < 0.05

    def test_auto_dispatch_threshold(self):
        """m > 2^24 must route to the exact path (trace-level check via
        the jaxpr: the exact path contains no float ceil)."""
        w = jnp.ones((64,), jnp.float32) / 64

        def f_small(w):
            return _child_run_ends(jax.random.PRNGKey(0), w, 1 << 10)

        def f_large(w):
            return _child_run_ends(jax.random.PRNGKey(0), w, (1 << 24) + 8)

        assert "ceil" in str(jax.make_jaxpr(f_small)(w))
        assert "ceil" not in str(jax.make_jaxpr(f_large)(w))


@pytest.mark.slow
class TestExactRunEndsLarge:
    def test_bit_for_bit_sampled_oracle_2_25(self):
        """N = 2^25 (past the f32 ceiling): structural invariants over the
        full array, bit-for-bit vs the big-int oracle on 100k sampled
        positions, and the f32 path's quantization error quantified."""
        rng = np.random.default_rng(1)
        n = 1 << 25
        w = rng.lognormal(0, 1.5, n).astype(np.float32)
        w /= w.sum()
        key = jax.random.PRNGKey(3)
        t = np.asarray(
            jax.jit(lambda w: exact_child_run_ends(key, w, n))(jnp.asarray(w))
        )
        assert np.all(np.diff(t) >= 0)
        assert t[-1] == n

        q = _limbs_to_int64(quantize_weights_limbs(jnp.asarray(w)))
        Q = np.cumsum(q)
        Qt = int(Q[-1])
        u = np.float32(jax.random.uniform(key, (), jnp.float32))
        n_u = int(np.round(u * np.float32(2.0**24)))
        U = min((n_u * Qt) >> 24, Qt - 1)
        off = Qt - 1 - U
        idx = rng.choice(n, 100000, replace=False)
        t_or = np.array([(n * int(Q[j]) + off) // Qt for j in idx])
        assert np.array_equal(t[idx], t_or)

        # the f32 path's ancestry jitter past the ceiling is real and
        # material — this is what the exact path removes
        t32 = np.asarray(
            jax.jit(lambda w: _child_run_ends(key, w, n, exact=False))(
                jnp.asarray(w)
            )
        ).astype(np.int64)
        d = np.abs(t32 - t.astype(np.int64))
        assert d.max() >= 2  # f32 is genuinely wrong out here


S = 8


class TestShardedExactResample:
    """Forced-exact neighbor exchange at small N must reproduce the
    single-device exact ancestry bit-for-bit (the property that makes the
    N > 2^24 multi-host claim testable without 2^24 particles)."""

    def _mesh(self):
        devs = jax.devices()[:S]
        return Mesh(np.asarray(devs).reshape(1, S), ("batch", "particles"))

    def _run_neighbor_exact(self, key, particles, logw, radius):
        mesh = self._mesh()
        from particle_filters_jax.parallel import (
            neighbor_exchange_systematic_resample,
        )

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), P("particles", None), P("particles")),
            out_specs=(P("particles", None), P()),
            check_vma=False,
        )
        def f(k, p, lw):
            return neighbor_exchange_systematic_resample(
                k, p, lw, axis_name="particles", radius=radius, exact=True
            )

        # jit is essential: eager shard_map re-executes the multi-limb
        # pipeline op-by-op across 8 devices (minutes); jitted it runs in
        # ~5 s including compile.
        return jax.jit(f)(key, particles, logw)

    @pytest.mark.parametrize("radius", [2, 3])
    def test_matches_single_device_exact_ancestry(self, key, radius):
        N, d = 512, 2
        particles = jax.random.normal(key, (N, d))
        logw = 0.3 * jax.random.normal(jax.random.fold_in(key, 1), (N,))
        logw = logw - jax.scipy.special.logsumexp(logw)

        k_res = jax.random.fold_in(key, 2)
        # single-device exact ancestry -> values via the same telescoping
        w = np.asarray(jnp.exp(logw))
        t = np.asarray(exact_child_run_ends(k_res, jnp.asarray(w), N))
        starts = np.concatenate([[0], t[:-1]])
        p_np = np.asarray(particles)
        expected = p_np[np.searchsorted(starts, np.arange(N), "right") - 1]

        got, ok = self._run_neighbor_exact(k_res, particles, logw, radius)
        assert bool(ok)
        np.testing.assert_allclose(
            np.asarray(got), expected, rtol=1e-5, atol=1e-5
        )

    def test_exact_ok_flag_detects_insufficient_radius(self, key):
        N = 128
        particles = jax.random.normal(key, (N, 1))
        logw = jnp.full((N,), -1e6).at[-N // S:].set(0.0)
        logw = logw - jax.scipy.special.logsumexp(logw)
        _, ok = self._run_neighbor_exact(
            jax.random.fold_in(key, 4), particles, logw, 1
        )
        assert not bool(ok)

    def test_exact_and_f32_modes_agree_at_small_n(self, key):
        """Below the ceiling the two shard-level conventions must produce
        statistically identical resamples (same particles up to the
        at-most-one-slot convention differences)."""
        N = 512
        particles = jax.random.normal(key, (N, 1))
        logw = 0.2 * jax.random.normal(jax.random.fold_in(key, 1), (N,))
        logw = logw - jax.scipy.special.logsumexp(logw)
        k_res = jax.random.fold_in(key, 6)

        mesh = self._mesh()
        from particle_filters_jax.parallel import (
            neighbor_exchange_systematic_resample,
        )

        outs = {}
        for exact in (False, True):

            @partial(
                shard_map,
                mesh=mesh,
                in_specs=(P(), P("particles", None), P("particles")),
                out_specs=(P("particles", None), P()),
                check_vma=False,
            )
            def f(k, p, lw, exact=exact):
                return neighbor_exchange_systematic_resample(
                    k, p, lw, axis_name="particles", radius=3, exact=exact
                )

            got, ok = jax.jit(f)(k_res, particles, logw)
            assert bool(ok)
            outs[exact] = np.asarray(got)[:, 0]
        # conventions may shift ancestry by at most one slot at rounding
        # boundaries: compare as multisets of ancestors
        same = np.mean(outs[True] == outs[False])
        assert same > 0.95
