"""The Triton-route kernels of ``ops/`` in the Pallas interpreter against
their plain twins, their dispatch, and ``FusedSIRFilter`` against
``ParticleFilter``.

On CUDA the kernels run compiled; here the interpreter runs the same kernel
bodies, and every non-CUDA lowering takes the plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models import FusedSIRFilter, ParticleFilter
from particle_filters_jax.ops.fused_sir_triton import (
    BLOCK,
    SCALARS,
    combine_partials,
    fused_sir_step,
    fused_sir_step_pallas,
    fused_sir_step_plain,
)
from particle_filters_jax.ops.resample_triton import (
    MAX_COLS,
    resample_values_triton,
    tile_shape,
)
from particle_filters_jax.parallel import (
    make_mesh,
    make_sharded_pf_run,
    shard_pf_state,
)
from particle_filters_jax.resampling.hard import (
    _ancestors_from_starts,
    _systematic_starts,
    resample_values_from_starts,
)

ALPHA, SIGMA = 0.95, 0.2


def _g(x):
    return ALPHA * x


def _obs(x, z):
    var = jnp.exp(x)
    return -0.5 * (z * z / var + jnp.log(var))


def _starts(key, n, scale):
    w = jax.nn.softmax(scale * jax.random.normal(key, (n,)))
    return _systematic_starts(jax.random.fold_in(key, 1), w, n)


class TestResampleTriton:
    @pytest.mark.parametrize("n", [1, 1000, 1024, 3001])
    @pytest.mark.parametrize("d", [1, 2, 4])
    def test_interpret_matches_plain(self, key, n, d):
        """Ragged N (not a multiple of the block) and d ∈ {1, 2, 4}: the
        kernel's binary search + gather selects exactly the plain path's
        ancestors."""
        k = jax.random.fold_in(key, n * 10 + d)
        starts = _starts(k, n, 2.0)
        p = jax.random.normal(jax.random.fold_in(k, 2), (n, d))
        got = resample_values_triton(starts, p, n, interpret=True)
        want = jnp.take(p, _ancestors_from_starts(starts, n), axis=0)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_fewer_outputs_than_starts(self, key):
        """m < N (the neighbor-exchange pool): clipped leading starts and
        dropped trailing ones select as the plain path does."""
        n, m = 2000, 700
        starts = jnp.clip(_starts(key, n, 1.0) - 500, 0, m)
        p = jax.random.normal(jax.random.fold_in(key, 3), (n, 2))
        got = resample_values_triton(starts, p, m, interpret=True)
        want = jnp.take(p, _ancestors_from_starts(starts, m), axis=0)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_degenerate_point_mass(self, key):
        n = 1500
        w = jnp.zeros(n).at[77].set(1.0)
        starts = _systematic_starts(key, w, n)
        p = jax.random.normal(key, (n, 3))
        got = resample_values_triton(starts, p, n, interpret=True)
        np.testing.assert_array_equal(
            np.asarray(got), np.tile(np.asarray(p[77]), (n, 1))
        )

    @pytest.mark.parametrize("n,d", [(700, 3), (513, 16), (300, 64),
                                     (257, 144)])
    def test_wide_and_odd_widths(self, key, n, d):
        """Widths that are not a power of two, fill a tile's columns, or
        span several column blocks (d > MAX_COLS): one kernel selects every
        column of the ancestor's row."""
        k = jax.random.fold_in(key, n * 1000 + d)
        starts = _starts(k, n, 2.0)
        p = jax.random.normal(jax.random.fold_in(k, 2), (n, d))
        got = resample_values_triton(starts, p, n, interpret=True)
        want = jnp.take(p, _ancestors_from_starts(starts, n), axis=0)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    @pytest.mark.parametrize(
        "m,d,want",
        [(1 << 20, 1, (1024, 1)), (1 << 20, 4, (1024, 4)),
         (1 << 20, 8, (512, 8)), (1 << 20, 64, (64, 64)),
         (1 << 20, 144, (32, MAX_COLS)), (300, 2, (512, 2)),
         (5, 144, (8, MAX_COLS))],
    )
    def test_tile_shape(self, m, d, want):
        assert tile_shape(m, d) == want

    @pytest.mark.parametrize("shape", [(600,), (600, 19), (600, 2, 3)],
                             ids=["1", "19", "2x3"])
    def test_dispatch_off_cuda_is_plain(self, key, shape):
        """Off CUDA the jitted entry point lowers the plain path, for 1-D,
        narrow, wide and multi-axis particle states alike."""
        n = shape[0]
        starts = _starts(key, n, 1.5)
        p = jax.random.normal(jax.random.fold_in(key, 4), shape)
        got = jax.jit(resample_values_from_starts)(starts, p)
        want = jnp.take(p, _ancestors_from_starts(starts, n), axis=0)
        assert got.shape == shape
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_gradient_rule(self, key):
        """d out / d particles scatters the cotangent onto the ancestors,
        as the gradient of the equivalent ``jnp.take`` does."""
        n = 300
        starts = _starts(key, n, 2.0)
        p = jax.random.normal(jax.random.fold_in(key, 5), (n, 2))
        c = jax.random.normal(jax.random.fold_in(key, 6), (n, 2))
        f = lambda q: jnp.sum(c * resample_values_from_starts(starts, q))
        f_ref = lambda q: jnp.sum(
            c * jnp.take(q, _ancestors_from_starts(starts, n), axis=0)
        )
        np.testing.assert_allclose(
            np.asarray(jax.grad(f)(p)), np.asarray(jax.grad(f_ref)(p)),
            rtol=1e-6, atol=1e-6,
        )


def _step_inputs(key, n, uniform=0.0):
    x = jax.random.normal(key, (n,))
    eps = jax.random.normal(jax.random.fold_in(key, 1), (n,))
    lw = jax.nn.log_softmax(0.3 * jax.random.normal(jax.random.fold_in(key, 2), (n,)))
    sc = jnp.array([0.7, 0.01, uniform, SIGMA, -np.log(n)], jnp.float32)
    return x, eps, lw, sc


class TestFusedSirStep:
    @pytest.mark.parametrize("n", [1000, BLOCK, BLOCK + 517])
    @pytest.mark.parametrize("uniform", [0.0, 1.0])
    def test_interpret_matches_plain(self, key, n, uniform):
        args = _step_inputs(jax.random.fold_in(key, n), n, uniform)
        kw = dict(g_vec=_g, obs_vec=_obs)
        xk, lwk, pk = fused_sir_step_pallas(*args, interpret=True, **kw)
        xp, lwp, pp = fused_sir_step_plain(*args, **kw)
        np.testing.assert_allclose(np.asarray(xk), np.asarray(xp), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(lwk), np.asarray(lwp),
                                   rtol=1e-5, atol=1e-5)
        assert pk.shape == pp.shape == (-(-n // BLOCK), 8)
        np.testing.assert_allclose(np.asarray(pk), np.asarray(pp), rtol=1e-4,
                                   atol=1e-5)
        for a, b in zip(combine_partials(pk), combine_partials(pp)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-4,
                                       atol=1e-5)

    def test_plain_matches_direct_formulas(self, key):
        n = 2048
        x, eps, lw, sc = _step_inputs(key, n)
        xn, lwn, part = fused_sir_step(x, eps, lw, sc, g_vec=_g, obs_vec=_obs)
        x_ref = ALPHA * x + SIGMA * eps
        lw_ref = lw - sc[1] + _obs(x_ref, sc[0])
        np.testing.assert_allclose(np.asarray(xn), np.asarray(x_ref), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(lwn), np.asarray(lw_ref),
                                   rtol=1e-6, atol=1e-6)
        log_z, ess, mean, var = combine_partials(part)
        w = jax.nn.softmax(lw_ref)
        m_ref = jnp.sum(w * x_ref)
        np.testing.assert_allclose(float(log_z),
                                   float(jax.nn.logsumexp(lw_ref)), rtol=1e-5)
        np.testing.assert_allclose(float(ess), float(1 / jnp.sum(w * w)),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(mean), float(m_ref), atol=1e-5)
        np.testing.assert_allclose(
            float(var), float(jnp.sum(w * (x_ref - m_ref) ** 2)), atol=1e-5
        )
        assert len(SCALARS) == sc.shape[0]


def _filters(n, **kw):
    fused = FusedSIRFilter(_g, _obs, jnp.array([[SIGMA**2]]), Np=n, **kw)
    generic = ParticleFilter(
        lambda x, u: ALPHA * x, None, jnp.array([[SIGMA**2]]), None, Np=n,
        obs_loglik=lambda x, z: _obs(x[0], z[0]), **kw,
    )
    return fused, generic


class TestFusedSIRFilter:
    def test_matches_generic_draw_for_draw(self, key, sv_data):
        """Same keys ⇒ same Gaussian draws and resample keys: the fused
        filter tracks ParticleFilter step for step up to the first
        resample. There float rounding may move an ancestor across a CDF
        boundary, after which the clouds drift apart as two runs of one
        filter do, so later steps are held to the RMSE."""
        n = 4096
        zs = jnp.asarray(sv_data.Y[:60, None], jnp.float32)
        fused, generic = _filters(n)
        st = generic.initialize(key, jnp.zeros(1), jnp.array([[0.2]]))
        run = lambda f: jax.jit(lambda k, s: f.run(k, s, zs))(
            jax.random.fold_in(key, 1), st)
        fin_f, h_f = run(fused)
        _, h_g = run(generic)
        trig = np.asarray(h_g["resampled"])
        assert trig.any()
        first = int(np.argmax(trig))
        for k_ in ("mean", "cov", "ess", "log_evidence"):
            np.testing.assert_allclose(
                np.asarray(h_f[k_])[: first + 1],
                np.asarray(h_g[k_])[: first + 1], rtol=1e-4, atol=1e-4,
            )
        assert np.mean(np.asarray(h_f["resampled"]) == trig) >= 0.95
        x = np.asarray(sv_data.X[:60])
        rmse = [float(np.sqrt(np.mean((np.asarray(h["mean"][:, 0]) - x) ** 2)))
                for h in (h_f, h_g)]
        assert abs(rmse[0] - rmse[1]) < 0.02
        assert float(jax.nn.logsumexp(fin_f.log_weights)) == pytest.approx(
            0.0, abs=1e-4)

    def test_sharded_matches_single_device(self, key, sv_data):
        n, T = 2048, 40
        zs = jnp.asarray(sv_data.Y[:T, None], jnp.float32)
        x_true = np.asarray(sv_data.X[:T])
        rmse = {}
        for mode in ("single", "all_gather", "neighbor"):
            if mode == "single":
                pf, _ = _filters(n)
                st = pf.initialize(key, jnp.zeros(1), jnp.array([[0.2]]))
                _, h = jax.jit(lambda k, s: pf.run(k, s, zs))(
                    jax.random.fold_in(key, 1), st)
            else:
                mesh = make_mesh(n_batch=1, n_particles=4,
                                 devices=jax.devices()[:4])
                pf, _ = _filters(n, axis_name="particles",
                                 distributed_resample=mode)
                st = shard_pf_state(
                    pf.initialize(key, jnp.zeros(1), jnp.array([[0.2]])), mesh)
                _, h = make_sharded_pf_run(pf, mesh)(
                    jax.random.fold_in(key, 1), st, zs)
                assert bool(np.all(np.asarray(h["exchange_ok"])))
            rmse[mode] = float(np.sqrt(np.mean(
                (np.asarray(h["mean"][:, 0]) - x_true) ** 2)))
        for mode in ("all_gather", "neighbor"):
            assert abs(rmse[mode] - rmse["single"]) < 0.05

    @pytest.mark.parametrize(
        "bad",
        [
            dict(Q=jnp.eye(2)),
            dict(track_degeneracy=True),
            dict(zs=jnp.zeros((5, 2))),
        ],
        ids=["vector_state", "degeneracy", "vector_obs"],
    )
    def test_refuses_unsupported(self, key, bad):
        if "Q" in bad:
            with pytest.raises(ValueError):
                FusedSIRFilter(_g, _obs, bad["Q"], Np=64)
            return
        pf, _ = _filters(64)
        st = pf.initialize(key, jnp.zeros(1), jnp.array([[0.2]]))
        zs = bad.get("zs", jnp.zeros((5, 1)))
        with pytest.raises(ValueError):
            pf.run(key, st, zs, track_degeneracy=bad.get("track_degeneracy",
                                                         False))


class TestDispatchShapes:
    """``lax.platform_dependent`` needs both branches to return the same
    types; the lowering for CUDA checks it even where only the plain branch
    runs, so the check is made here by abstract evaluation."""

    @pytest.mark.parametrize("n", [1000, BLOCK, 3 * BLOCK + 5])
    def test_fused_branches_agree(self, n):
        args = [jax.ShapeDtypeStruct((n,), jnp.float32)] * 3 + [
            jax.ShapeDtypeStruct((len(SCALARS),), jnp.float32)]
        kw = dict(g_vec=_g, obs_vec=_obs)
        k = jax.eval_shape(lambda *a: fused_sir_step_pallas(*a, **kw), *args)
        p = jax.eval_shape(lambda *a: fused_sir_step_plain(*a, **kw), *args)
        assert k == p

    @pytest.mark.parametrize("n,m,d", [(1000, 1000, 1), (2000, 700, 4),
                                       (500, 500, 144)])
    def test_resample_branches_agree(self, n, m, d):
        s = jax.ShapeDtypeStruct((n,), jnp.int32)
        p = jax.ShapeDtypeStruct((n, d), jnp.float32)
        k = jax.eval_shape(lambda a, b: resample_values_triton(a, b, m), s, p)
        q = jax.eval_shape(
            lambda a, b: jnp.take(b, _ancestors_from_starts(a, m), axis=0),
            s, p)
        assert k == q
