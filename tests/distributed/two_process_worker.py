"""Worker for the 2-process ``jax.distributed`` CPU smoke test.

Each process owns 4 virtual CPU devices (XLA_FLAGS set by the launcher);
``jax.distributed.initialize`` stitches them into one 8-device global
mesh. The worker runs the sharded SIR filter
(``parallel/sharded.make_sharded_pf_run``) on the SV model across BOTH
processes — cross-process psum/all_gather collectives — and prints the
replicated history moments as one JSON line for the launcher to compare
against a single-process 8-device run of the identical config.

Proves SURVEY §5.8's "multi-host falls out of jax.distributed with the
same code" claim with running code (VERDICT r2 item 4).
"""

import argparse
import json
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from particle_filters_jax.models import ParticleFilter
    from particle_filters_jax.models.particle_filter import PFState
    from particle_filters_jax.parallel.sharded import (
        make_sharded_pf_run,
        shard_pf_state,  # noqa: F401  (single-process analog)
    )
    from particle_filters_jax.simulators import simulate_sv_1d

    devices = jax.devices()
    assert len(devices) == 4 * args.num_processes, (
        f"expected {4 * args.num_processes} global devices, got "
        f"{len(devices)}"
    )
    mesh = Mesh(np.asarray(devices).reshape(1, -1), ("batch", "particles"))

    alpha, sigma = 0.9, 0.2
    sv = simulate_sv_1d(100, alpha, sigma, 1.0, seed=42)
    zs_np = np.asarray(sv.Y[:, None], np.float32)

    def obs_loglik(x, z):
        var = jnp.exp(x[0])
        return -0.5 * (z[0] ** 2 / var + jnp.log(var))

    pf = ParticleFilter(
        lambda x, u: alpha * x, None,
        Q=np.array([[sigma**2]], np.float32), R=None,
        Np=4096, obs_loglik=obs_loglik, axis_name="particles",
    )

    # Every process computes the same host-side initial state (seeded) and
    # assembles global arrays shard-by-shard.
    key0 = jax.random.PRNGKey(0)
    st_local = pf.initialize(
        key0, np.zeros(1, np.float32),
        np.array([[sigma**2 / (1 - alpha**2)]], np.float32),
    )

    def to_global(x, spec):
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    state0 = PFState(
        particles=to_global(st_local.particles, P("particles", None)),
        log_weights=to_global(st_local.log_weights, P("particles")),
        mean=to_global(st_local.mean, P()),
        cov=to_global(st_local.cov, P()),
        t=to_global(st_local.t, P()),
    )
    run_key = to_global(
        jax.random.key_data(jax.random.PRNGKey(7)), P()
    )
    zs = to_global(zs_np, P())

    run = make_sharded_pf_run(pf, mesh)

    def run_wrapped(kd, s, z):
        return run(jax.random.wrap_key_data(kd), s, z)

    _, hist = jax.jit(run_wrapped)(run_key, state0, zs)

    # history is replicated -> fully addressable on every process
    means = np.asarray(hist["mean"])[:, 0]
    ess = np.asarray(hist["ess"])
    rmse = float(np.sqrt(np.mean((means - np.asarray(sv.X)) ** 2)))
    out = {
        "process_id": args.process_id,
        "num_global_devices": len(devices),
        "rmse": rmse,
        "mean_head": [float(v) for v in means[:5]],
        "mean_tail": [float(v) for v in means[-5:]],
        "ess_mean": float(ess.mean()),
        "resample_frac": float(np.asarray(hist["resampled"]).mean()),
    }
    print("SMOKE_RESULT " + json.dumps(out), flush=True)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
