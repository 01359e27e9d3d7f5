"""Particle-axis data parallelism over a ``jax.sharding.Mesh``.

The reference has no distributed backend at all (SURVEY.md §2.4); here
it is SPMD over a mesh ``('batch', 'particles')``: per-particle
propagate/weight are local, weight normalization / ESS / moments are
``psum`` collectives, and resampling ancestry crosses shards via
``all_gather`` or the memory-bounded neighbor exchange. Three filter
families ride the mesh: the SIR filter (``sharded.py``), the EDH/LEDH
particle-flow filters (``flow_sharded.py``), and differentiable-PF
training (``dpf_sharded.py``).
"""

from particle_filters_jax.parallel.mesh import make_mesh
from particle_filters_jax.parallel.sharded import (
    make_sharded_pf_run,
    shard_pf_state,
)
from particle_filters_jax.parallel.dpf_sharded import (
    make_sharded_dpf_train_step,
    sharded_soft_resample,
)
from particle_filters_jax.parallel.distributed_resample import (
    neighbor_exchange_systematic_resample,
)
from particle_filters_jax.parallel.flow_sharded import (
    make_sharded_flow_run,
    shard_flow_state,
)

__all__ = [
    "make_mesh",
    "make_sharded_pf_run",
    "shard_pf_state",
    "make_sharded_dpf_train_step",
    "sharded_soft_resample",
    "neighbor_exchange_systematic_resample",
    "make_sharded_flow_run",
    "shard_flow_state",
]
