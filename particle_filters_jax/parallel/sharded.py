"""Sharded SIR particle filtering with ``shard_map``.

Wraps :class:`~particle_filters_jax.models.particle_filter.ParticleFilter`
(constructed with ``axis_name='particles'``) so the N-particle ensemble is
sharded over the mesh's ``particles`` axis:

- propagate / weight: fully local (vmapped per shard);
- log-normalizer, ESS, weighted moments: ``psum`` collectives
  (``core.weights`` reductions take ``axis_name``);
- ESS-triggered systematic resampling: deterministic-per-key global
  ancestry computed on every shard from an ``all_gather`` of the cloud,
  each shard keeping its slice (see ``ParticleFilter._maybe_resample``).

The all-gather resample is exact and simple; it holds one full copy of the
cloud per device during the (rare) resample step. For multi-host N >> 1e7,
construct the ParticleFilter with ``distributed_resample="neighbor"``: the
memory-bounded ppermute neighbor exchange in
``parallel/distributed_resample.py`` pools only ±radius neighbor shards,
rescuing through the exact all_gather path in-graph on the (rare) steps
whose ancestry exceeds the pool; the ``exchange_ok`` history flag reports
pool sufficiency (a sizing signal — results are exact either way).
"""

from __future__ import annotations

from functools import partial

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from particle_filters_jax.models.particle_filter import ParticleFilter, PFState


def shard_pf_state(state: PFState, mesh: Mesh) -> PFState:
    """Device-put a PFState with particles/weights sharded over 'particles'."""
    sh_p = NamedSharding(mesh, P("particles", None))
    sh_w = NamedSharding(mesh, P("particles"))
    rep = NamedSharding(mesh, P())
    return PFState(
        particles=jax.device_put(state.particles, sh_p),
        log_weights=jax.device_put(state.log_weights, sh_w),
        mean=jax.device_put(state.mean, rep),
        cov=jax.device_put(state.cov, rep),
        t=jax.device_put(state.t, rep),
    )


def make_sharded_pf_run(pf: ParticleFilter, mesh: Mesh):
    """Build a jitted ``run(key, state0, zs) -> (final, history)`` whose
    particle axis is sharded over ``mesh``'s ``particles`` axis.

    ``pf`` must have been constructed with ``axis_name='particles'``.
    """
    if pf.axis_name != "particles":
        raise ValueError(
            "ParticleFilter must be constructed with axis_name='particles'."
        )

    state_spec = PFState(
        particles=P("particles", None),
        log_weights=P("particles"),
        mean=P(),
        cov=P(),
        t=P(),
    )
    hist_spec = {
        "mean": P(),
        "cov": P(),
        "ess": P(),
        "resampled": P(),
        "log_evidence": P(),
        "exchange_ok": P(),
    }

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), state_spec, P()),
        out_specs=(state_spec, hist_spec),
        check_vma=False,
    )
    def _run(key, state0, zs):
        return pf.run(key, state0, zs)

    return jax.jit(_run)
