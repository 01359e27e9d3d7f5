"""Multi-card scaling of the sharded SIR particle filter.

Runs the generic ``ParticleFilter`` on the SV model (T = 100) with the
particle axis sharded over 1, 2 and 4 GPUs (``parallel.make_sharded_pf_run``)
at a fixed global cloud (strong scaling), in the all_gather resample mode on
every mesh width and the memory-bounded neighbor exchange on the widest.
Each run is timed with ``jax.block_until_ready`` after a warm-up of the same
shape. Needs GPUs: exits non-zero elsewhere.

Usage:  python benchmarks/bench_multichip.py [--log2-n 24]
Prints one JSON line per configuration.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import ALPHA, SIGMA, make_sv_filter, sv_prior  # noqa: E402
from particle_filters_jax.parallel import (  # noqa: E402
    make_mesh,
    make_sharded_pf_run,
    shard_pf_state,
)
from particle_filters_jax.simulators import simulate_sv_1d  # noqa: E402
from particle_filters_jax.utils.device import (  # noqa: E402
    device_summary,
    enable_compile_cache,
    query_cards,
    require_gpu,
)
from particle_filters_jax.utils.timing import time_best  # noqa: E402

T = 100


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2-n", type=int, default=24)
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    card = query_cards()[0]
    n_global = 1 << args.log2_n
    sv = simulate_sv_1d(T, ALPHA, SIGMA, 1.0, seed=42)
    devices = jax.devices()
    widths = [n for n in (1, 2, 4) if n <= len(devices)]
    configs = [(n, "all_gather") for n in widths] + [(widths[-1], "neighbor")]
    for n_dev, mode in configs:
        mesh = make_mesh(n_batch=1, n_particles=n_dev, devices=devices[:n_dev])
        pf = make_sv_filter(n_global, axis_name="particles",
                            distributed_resample=mode)
        st0 = shard_pf_state(pf.initialize(jax.random.PRNGKey(0),
                                           *sv_prior()), mesh)
        zs = jnp.asarray(sv.Y[:, None], jnp.float32)
        best, first, (_, hist) = time_best(
            make_sharded_pf_run(pf, mesh), jax.random.PRNGKey(1), st0, zs,
            reps=3,
        )
        rmse = float(jnp.sqrt(jnp.mean((hist["mean"][:, 0] - sv.X) ** 2)))
        print(json.dumps({
            "devices": n_dev,
            "resample": mode,
            "n_global": n_global,
            "T": T,
            "wall_s": best,
            "first_call_s": first,
            "ms_per_step": best / T * 1e3,
            "sv_rmse": rmse,
            "resample_frac": float(jnp.mean(hist["resampled"])),
            "exchange_ok_all": bool(jnp.all(hist["exchange_ok"])),
            "device": device_summary(),
            "card": card[0],
            "power_limit": card[1],
        }), flush=True)


if __name__ == "__main__":
    main()
