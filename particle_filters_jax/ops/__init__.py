"""Pallas kernels for NVIDIA GPUs, written for the Triton route
(``backend="triton"``).

Each kernel has a plain-``jnp`` twin with the same arithmetic, which is
what every other backend runs (``lax.platform_dependent`` picks the kernel
only when lowering for CUDA) and what the CPU tests compare the kernel
with in interpret mode. Each stays only while it beats its twin end to end
on the card (PERF.md).

- ``resample_triton``: systematic-resample gather from sorted child-run
  starts (per-row binary search + row gather, any state width).
- ``fused_sir_triton``: one SIR step for scalar elementwise models —
  propagate, weight and per-block weight/moment partials in one pass.
"""

from particle_filters_jax.ops.fused_sir_triton import fused_sir_step
from particle_filters_jax.ops.resample_triton import resample_values_triton

__all__ = ["fused_sir_step", "resample_values_triton"]
