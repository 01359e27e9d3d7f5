"""Sharded particle-flow filtering: EDH/LEDH under ``shard_map``.

Scales the flow filters' particle axis over a device mesh — the per-λ-step
work per particle is an affine-field evaluation (EDH) or a per-particle
flow-matrix factorization (LEDH, the expensive one: the reference runs it
at 2,096 s for 40 steps, ``/root/reference/notebooks/
PF_PF_results_reproduction_MAT.ipynb``), both embarrassingly parallel, so
the mesh cut is along particles exactly like the SIR path
(``parallel/sharded.py``):

- flow integration + invertible-weight correction: local per shard (the
  flow's linearization inputs — tracker mean/cov — are replicated);
- log-normalizer / ESS / posterior moments: ``psum`` collectives
  (``core.weights`` reductions take ``axis_name``);
- ESS-triggered systematic resample: deterministic-per-key GLOBAL ancestry
  from an ``all_gather`` of the cloud, each shard keeping its slice —
  flow clouds are small (N ≤ 10⁴ in every reference workload), so the
  gather is cheap and exact.

Construct the filter with ``axis_name="particles"`` and wrap its ``run``
with :func:`make_sharded_flow_run`. The same wrapper serves
:class:`~particle_filters_jax.models.edh_particle_filter.EDHFlowPF` and
:class:`~particle_filters_jax.models.ledh_particle_filter.LEDHFlowPF`
(their state / run signatures agree; LEDH-only kwargs like
``beta_schedule`` pass through).
"""

from __future__ import annotations

from functools import partial

import jax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from particle_filters_jax.models.edh_particle_filter import FlowPFState


def _flow_state_spec():
    """Partition specs for a FlowPFState: particle-major arrays sharded
    over 'particles', posterior moments replicated, diagnostics replicated
    (a prefix P() covers the dict)."""
    return FlowPFState(
        particles=P("particles", None),
        weights=P("particles"),
        log_weights=P("particles"),
        mean=P(),
        cov=P(),
        diagnostics=P(),
    )


def shard_flow_state(state: FlowPFState, mesh: Mesh) -> FlowPFState:
    """Device-put a FlowPFState with the particle axis sharded.

    Initialize globally (``init_from_gaussian`` outside ``shard_map``) and
    shard the result — the cloud is identical to the single-device draw,
    so sharded runs with ``process_noise_sampler=None`` match the
    single-device trajectory to float rounding.
    """
    sh_p = NamedSharding(mesh, P("particles", None))
    sh_w = NamedSharding(mesh, P("particles"))
    rep = NamedSharding(mesh, P())
    return FlowPFState(
        particles=jax.device_put(state.particles, sh_p),
        weights=jax.device_put(state.weights, sh_w),
        log_weights=jax.device_put(state.log_weights, sh_w),
        mean=jax.device_put(state.mean, rep),
        cov=jax.device_put(state.cov, rep),
        diagnostics=jax.device_put(state.diagnostics, rep),
    )


def make_sharded_flow_run(pf, mesh: Mesh, **run_kwargs):
    """Jitted ``run(key, state0, tracker_state0, zs) -> (final, ts, hist)``
    with the particle axis sharded over ``mesh``'s ``particles`` axis.

    ``pf`` is an :class:`EDHFlowPF` or :class:`LEDHFlowPF` constructed with
    ``axis_name='particles'``; ``run_kwargs`` (``process_noise_sampler``,
    LEDH's ``beta_schedule``) forward to ``pf.run``. The tracker state and
    history are replicated.
    """
    if getattr(pf, "axis_name", None) != "particles":
        raise ValueError(
            "flow filter must be constructed with axis_name='particles'."
        )
    state_spec = _flow_state_spec()
    hist_spec = {
        "mean": P(),
        "cov": P(),
        "ess": P(),
        "resampled": P(),
        "condition_numbers": P(),
    }

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), state_spec, P(), P()),
        out_specs=(state_spec, P(), hist_spec),
        check_vma=False,
    )
    def _run(key, state0, tracker_state0, zs):
        return pf.run(key, state0, tracker_state0, zs, **run_kwargs)

    return jax.jit(_run)
