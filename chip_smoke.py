#!/usr/bin/env python
"""Smoke test of the SMC engine on one NVIDIA GPU (or four, with --four).

Run from the repository root:

    python chip_smoke.py          # phases: device, main, reference,
                                  #         resample, families (one card)
    python chip_smoke.py --four   # the sharded SIR path on four cards

Phases
- device: the first JAX device is a GPU; prints the card's name and power
  limit as ``nvidia-smi --query-gpu=name,power.limit`` reports them.
- main: the north-star path of ``bench.py`` — ``ParticleFilter.run`` on the
  stochastic-volatility model, N = 2²⁰, T = 200 — and the same model through
  ``FusedSIRFilter``, each with compile time, ms/step, particle-steps/s,
  RMSE against the simulated truth, resample fraction and device memory.
  Asserts finite outputs and RMSE < 1.5, and that the two filters (same
  keys, same draws) agree on resample triggers and RMSE.
- reference: the same program with threefry keys under
  ``jax.default_matmul_precision("highest")``, on the GPU and on this
  process's CPU device; per-step means, resample triggers and RMSE must
  agree. Also reports how far default (TF32) precision moves the RMSE.
- resample: ``resampling.hard.resample_values_from_starts`` (the Triton
  gather on the GPU, the plain path on the CPU) at N ∈ {2²⁰, 2²²},
  d ∈ {1, 4, 144}, from starts computed once, against a NumPy oracle;
  the values are pure selection, so for the same starts they must be
  bit-identical.
- families: every filter family once through its public entry point at
  the widths ``benchmarks/run_benchmarks.py`` uses (T cut to a few steps),
  on the GPU and on the CPU, compared within a stated tolerance.
- four (``--four`` only): SIR on SV with 2²² particles per card over a
  4-card mesh — ``ParticleFilter`` and ``FusedSIRFilter``, all_gather and
  neighbor resampling — against a 1-card run at the same global N; then
  ``dryrun_multichip(4)``.

Every failed phase makes the exit code non-zero. The last line of standard
output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "particle_filters_jax"


# ---------------------------------------------------------------------------
# Comparison helpers (plain NumPy; unit-tested on the CPU)
# ---------------------------------------------------------------------------


def max_abs_diff(a, b) -> float:
    """Largest absolute elementwise difference (shapes must match)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def frac_within(a, b, atol: float) -> float:
    """Fraction of elements with |a − b| <= atol."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.mean(np.abs(a - b) <= atol)) if a.size else 1.0


def frac_equal(a, b) -> float:
    """Fraction of elements that are exactly equal."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.mean(a == b)) if a.size else 1.0


def within(got, ref, *, atol: float = 0.0, rtol: float = 0.0) -> bool:
    """|got − ref| <= atol + rtol·|ref|, elementwise, all finite."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return False
    if not (np.all(np.isfinite(got)) and np.all(np.isfinite(ref))):
        return False
    return bool(np.all(np.abs(got - ref) <= atol + rtol * np.abs(ref)))


def final_line(device: dict) -> str:
    """The script's last line: {"ok": true, "device": {...}}."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": device["platform"],
                "kind": device["kind"],
                "count": int(device["count"]),
            },
        }
    )


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

N_MAIN = 1 << 20
T_MAIN = 200
N_FOUR_PER_CARD = 1 << 22
# State widths of the resample phase: the SV state, a small tracker state,
# and the skew-t flow state (wider than one column block of the kernel).
RESAMPLE_WIDTHS = (1, 4, 144)
RESAMPLE_LOG_SIZES = (20, 22)


class Ctx:
    """What the phases share: the card's identity and the SV data."""

    def __init__(self):
        import jax
        import jax.numpy as jnp

        from bench import ALPHA, BETA, SIGMA
        from particle_filters_jax.simulators import simulate_sv_1d

        self.gpu = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]
        sv = simulate_sv_1d(T_MAIN, ALPHA, SIGMA, BETA, seed=42)
        self.x_true = jax.device_get(sv.X)
        self.zs_host = jax.device_get(jnp.asarray(sv.Y[:, None], jnp.float32))
        self.label = ""


def _rmse(means, truth) -> float:
    import numpy as np

    return float(np.sqrt(np.mean((np.asarray(means) - np.asarray(truth)) ** 2)))


def _compile(fn, *args):
    """(compiled, seconds) for ``jax.jit(fn)`` at these arguments."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _peak_bytes(dev) -> int | None:
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_device(ctx: Ctx) -> None:
    from particle_filters_jax.utils.device import query_cards, require_gpu

    require_gpu()
    cards = query_cards()
    ctx.label = f"{cards[0][0]}, power limit {cards[0][1]}"
    for name, limit in cards:
        print(f"{name}, {limit}")
    print(f"[device] jax: {ctx.gpu.platform} {ctx.gpu.device_kind} "
          f"x{len(__import__('jax').devices())}; card: {ctx.label}")


def _sv_run_fn(n, zs, key_impl, fused=False):
    """(run(key, state0) -> (final, hist), state0) for the north-star SIR
    (``FusedSIRFilter`` on the same model with ``fused``)."""
    import jax

    from bench import make_sv_filter, make_sv_fused_filter, sv_prior

    pf = make_sv_fused_filter(n) if fused else make_sv_filter(n)
    state0 = pf.initialize(jax.random.key(0, impl=key_impl), *sv_prior())
    return (lambda k, s: pf.run(k, s, zs)), state0


def phase_main(ctx: Ctx) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    zs = jax.device_put(ctx.zs_host, ctx.gpu)
    hists = {}
    for label, fused in (("ParticleFilter", False), ("FusedSIRFilter", True)):
        run, state0 = _sv_run_fn(N_MAIN, zs, "rbg", fused=fused)
        key = jax.random.key(2, impl="rbg")
        compiled, t_compile = _compile(run, key, state0)
        jax.block_until_ready(compiled(key, state0))  # warm-up
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            _, hist = jax.block_until_ready(compiled(key, state0))
            times.append(time.perf_counter() - t0)
        best = min(times)
        hists[label] = hist = jax.device_get(hist)
        means = hist["mean"][:, 0]
        rmse = _rmse(means, ctx.x_true)
        frac = float(np.mean(hist["resampled"]))
        print(f"[main] {label} N={N_MAIN} T={T_MAIN} "
              f"compile_s={t_compile:.3f} "
              f"run_s={['%.6f' % t for t in times]}")
        print(f"[main] {label} ms_per_step={best / T_MAIN * 1e3:.6f} "
              f"particle_steps_per_s={N_MAIN * T_MAIN / best:.6e} "
              f"on {ctx.label}")
        print(f"[main] {label} rmse={rmse:.6f} resample_frac={frac:.4f}")
        print(f"[main] {label} memory_analysis: "
              f"{compiled.memory_analysis()}")
        print(f"[main] {label} peak_bytes_in_use={_peak_bytes(ctx.gpu)}")
        _check(bool(np.all(np.isfinite(means))), "non-finite filter means")
        _check(bool(np.all(np.isfinite(hist["ess"]))), "non-finite ESS")
        _check(rmse < 1.5, f"{label}: RMSE {rmse} >= 1.5")
    # Same keys ⇒ same draws: the fused filter tracks the generic one up to
    # the first resample; after it float rounding can move an ancestor
    # across a CDF boundary and the clouds drift apart as two runs of one
    # filter do, so a trigger near the threshold may flip.
    g, f = hists["ParticleFilter"], hists["FusedSIRFilter"]
    f_trig = frac_equal(g["resampled"], f["resampled"])
    d_rmse = abs(_rmse(g["mean"][:, 0], ctx.x_true)
                 - _rmse(f["mean"][:, 0], ctx.x_true))
    print(f"[main] fused vs generic: triggers agree on {f_trig:.4f} of "
          f"steps, |Δrmse|={d_rmse:.6g}")
    _check(f_trig >= 0.95, f"fused/generic triggers agree on {f_trig}")
    _check(d_rmse <= 0.02, f"fused/generic RMSE differ by {d_rmse}")


def _sv_threefry_on(dev, zs_host, precision):
    """Run the north-star program with threefry keys on ``dev``."""
    import jax

    with jax.default_device(dev), jax.default_matmul_precision(precision):
        zs = jax.device_put(zs_host, dev)
        run, state0 = _sv_run_fn(N_MAIN, zs, "threefry2x32")
        key = jax.device_put(jax.random.key(2, impl="threefry2x32"), dev)
        _, hist = jax.block_until_ready(jax.jit(run)(key, state0))
    return jax.device_get(hist)


def phase_reference(ctx: Ctx) -> None:
    import numpy as np

    t0 = time.perf_counter()
    h_gpu = _sv_threefry_on(ctx.gpu, ctx.zs_host, "highest")
    t1 = time.perf_counter()
    h_cpu = _sv_threefry_on(ctx.cpu, ctx.zs_host, "highest")
    t2 = time.perf_counter()
    h_tf32 = _sv_threefry_on(ctx.gpu, ctx.zs_host, "default")
    m_gpu, m_cpu = h_gpu["mean"][:, 0], h_cpu["mean"][:, 0]
    f_mean = frac_within(m_gpu, m_cpu, 0.05)
    f_trig = frac_equal(h_gpu["resampled"], h_cpu["resampled"])
    r_gpu, r_cpu = _rmse(m_gpu, ctx.x_true), _rmse(m_cpu, ctx.x_true)
    r_tf32 = _rmse(h_tf32["mean"][:, 0], ctx.x_true)
    worst = int(np.argmax(np.abs(m_gpu - m_cpu)))
    print(f"[reference] gpu_s={t1 - t0:.3f} cpu_s={t2 - t1:.3f}")
    print(f"[reference] mean within 0.05 on {f_mean:.4f} of steps; "
          f"worst |Δmean|={max_abs_diff(m_gpu, m_cpu):.6g} at step {worst}")
    print(f"[reference] resample triggers agree on {f_trig:.4f} of steps")
    print(f"[reference] rmse gpu={r_gpu:.6f} cpu={r_cpu:.6f} "
          f"Δ={abs(r_gpu - r_cpu):.6g}")
    print(f"[reference] default-precision (TF32) rmse={r_tf32:.6f}, "
          f"Δ vs highest={abs(r_tf32 - r_gpu):.6g}")
    _check(f_mean >= 0.99, f"per-step means agree on only {f_mean}")
    _check(f_trig >= 0.99, f"resample triggers agree on only {f_trig}")
    _check(abs(r_gpu - r_cpu) <= 0.02, f"RMSE gpu {r_gpu} vs cpu {r_cpu}")


def _numpy_resample_oracle(starts, p):
    """out[i] = p[max{j : starts[j] <= i}] (starts sorted, starts[0] = 0)."""
    import numpy as np

    idx = np.searchsorted(starts, np.arange(p.shape[0]), side="right") - 1
    return p[idx]


def phase_resample(ctx: Ctx) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from particle_filters_jax.resampling import hard

    regimes = {"smooth": 1.0, "near_uniform": 0.05, "heavy": 3.0,
               "degenerate": None}
    rng = np.random.default_rng(5)
    for lg in RESAMPLE_LOG_SIZES:
        n = 1 << lg
        for d in RESAMPLE_WIDTHS:
            p = rng.standard_normal((n, d), dtype=np.float32)
            p_g = jax.device_put(p, ctx.gpu)
            for name, scale in regimes.items():
                key = jax.random.PRNGKey(lg * 10 + d)
                with jax.default_device(ctx.cpu):
                    if scale is None:
                        w = jnp.zeros((n,)).at[n // 3].set(1.0)
                    else:
                        w = jax.nn.softmax(
                            scale * jax.random.normal(key, (n,)))
                    starts = np.asarray(hard._systematic_starts(
                        jax.random.fold_in(key, 1), w, n))
                    out_cpu = np.asarray(
                        jax.jit(hard.resample_values_from_starts)(starts, p))
                fn = jax.jit(hard.resample_values_from_starts)
                s_g = jax.device_put(starts, ctx.gpu)
                out_gpu = np.asarray(jax.block_until_ready(fn(s_g, p_g)))
                oracle = _numpy_resample_oracle(starts, p)
                eq_gpu = np.array_equal(out_gpu, oracle)
                eq_cpu = np.array_equal(out_cpu, oracle)
                print(f"[resample] N=2^{lg} d={d} {name}: "
                      f"gpu==oracle {eq_gpu} cpu==oracle {eq_cpu} "
                      f"unique={len(np.unique(starts))}")
                _check(eq_gpu and eq_cpu,
                       f"resample mismatch at N=2^{lg} d={d} {name}")
            del p, p_g


# -- families -----------------------------------------------------------------


def _run_families(ctx, jobs) -> None:
    """For each ``(name, build, compare)``: lower ``build() -> (fn, args)``
    for the GPU and for the CPU (each traced under
    ``default_matmul_precision("highest")``), compile every program
    concurrently, then run each pair and check that the GPU output is
    finite and ``compare(out_gpu, out_cpu) -> (ok, message)`` holds."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import numpy as np

    t0 = time.perf_counter()
    lowered = []
    for _, build, _ in jobs:
        for dev in (ctx.gpu, ctx.cpu):
            with jax.default_device(dev), \
                    jax.default_matmul_precision("highest"):
                fn, args = build()
                args = jax.device_put(args, dev)
                lowered.append((jax.jit(fn).lower(*args), args))
    t_lower = time.perf_counter() - t0

    def compile_one(low):
        t = time.perf_counter()
        return low.compile(), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(len(lowered),
                                            os.cpu_count() or 1)) as ex:
        compiled = list(ex.map(lambda la: compile_one(la[0]), lowered))
    print(f"[families] lowered {len(lowered)} programs in {t_lower:.1f} s, "
          f"compiled them concurrently in {time.perf_counter() - t0:.1f} s")

    failures = []
    for i, (name, _, compare) in enumerate(jobs):
        outs, secs = [], []
        for j in (2 * i, 2 * i + 1):
            (exe, t_c), (_, args) = compiled[j], lowered[j]
            t = time.perf_counter()
            out = jax.block_until_ready(exe(*args))
            secs.append((t_c, time.perf_counter() - t))
            outs.append(jax.device_get(out))
        ok, msg = compare(*outs)
        finite = all(bool(np.all(np.isfinite(x)))
                     for x in jax.tree_util.tree_leaves(outs[0]))
        print(f"[families] {name}: gpu compile_s={secs[0][0]:.3f} "
              f"run_s={secs[0][1]:.4f} | cpu compile_s={secs[1][0]:.3f} "
              f"run_s={secs[1][1]:.4f} | {msg}", flush=True)
        if not (finite and ok):
            failures.append(f"{name}: finite={finite} {msg}")
    _check(not failures, "; ".join(failures))


def _mse_compare(truth, rtol):
    import numpy as np

    def compare(g, c):
        g0 = g[0] if isinstance(g, tuple) else g
        c0 = c[0] if isinstance(c, tuple) else c
        mg = float(np.mean((np.asarray(g0) - truth) ** 2))
        mc = float(np.mean((np.asarray(c0) - truth) ** 2))
        return (within(mg, mc, rtol=rtol),
                f"mse gpu={mg:.6g} cpu={mc:.6g} (rtol {rtol}); "
                f"max|Δmean|={max_abs_diff(g0, c0):.3g}")

    return compare


def phase_families(ctx: Ctx) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from particle_filters_jax.core.linalg import mvn_logpdf_chol
    from particle_filters_jax.models import (
        DPF_OT,
        DifferentiableParticleFilter,
        DifferentiableParticleFilterRNN,
        EDHConfig,
        EDHFlowPF,
        ExtendedKalmanFilter,
        GaussianTracker,
        KernelParticleFilter,
        KPFConfig,
        LEDHConfig,
        LEDHFlowPF,
        LinearGaussianBayes,
        Model,
        UnscentedKalmanFilter,
        kalman_filter_general,
        make_ekf_state,
        make_ukf_state,
        run_generalized_spf,
    )
    from particle_filters_jax.simulators import (
        SkewTDynConfig,
        SkewTGridConfig,
        SkewTMeasConfig,
        SkewTSimConfig,
        l96_integrate,
        simulate_lorenz96,
        simulate_skewt_many,
    )
    from particle_filters_jax.simulators.sensor_network_lg import (
        make_grid_coords,
        se_kernel_cov,
    )

    jobs = []
    # Deterministic filters agree to float rounding; filters that resample
    # may flip a resample decision or an ancestor at a CDF boundary between
    # backends, so they are held to their accuracy metric instead.
    DET_RTOL = 1e-3
    PF_RTOL = 0.1

    # --- SNLG d=64 (run_benchmarks.bench_snlg): KF, UKF, EDH-200, LEDH-200
    D, T, TR, SZ, AL = 64, 5, 100, 2.0, 0.9
    Sigma = np.asarray(se_kernel_cov(make_grid_coords(D), 3.0, 20.0, 0.01),
                       np.float32)
    rng = np.random.default_rng(123)
    L = np.linalg.cholesky(Sigma.astype(np.float64))
    X = np.zeros((TR, T, D), np.float32)
    Z = np.zeros((TR, T, D), np.float32)
    for r in range(TR):
        x = np.zeros(D)
        for t in range(T):
            x = AL * x + L @ rng.standard_normal(D)
            X[r, t] = x
            Z[r, t] = x + SZ * rng.standard_normal(D)

    def kf_build():
        S = jnp.asarray(Sigma)
        I = jnp.eye(D)
        f = jax.vmap(lambda z: kalman_filter_general(
            z, AL * I, I, I, S, SZ**2 * I, x0=jnp.zeros(D), P0=S).x_filt)
        return f, (Z,)

    jobs.append(("KF snlg d=64 x100 trials", kf_build,
                 _mse_compare(X, DET_RTOL)))

    def ukf_snlg_build():
        S = jnp.asarray(Sigma)
        ukf = UnscentedKalmanFilter(lambda x, u: AL * x, lambda x: x, S,
                                    SZ**2 * jnp.eye(D), alpha=1.0)
        f = jax.vmap(lambda z: ukf.run(make_ukf_state(jnp.zeros(D), S), z)[1])
        return f, (Z,)

    jobs.append(("UKF snlg d=64 x100 trials", ukf_snlg_build,
                 _mse_compare(X, DET_RTOL)))

    def flow_snlg_build(cls, cfg):
        def build():
            S = jnp.asarray(Sigma)
            I = jnp.eye(D)
            R = SZ**2 * I
            LQ = jnp.linalg.cholesky(S + 1e-6 * I)
            LR = SZ * I
            tracker = GaussianTracker(
                ExtendedKalmanFilter(lambda x, u: AL * x, lambda x: x, S, R))
            filt = cls(tracker, lambda x, u, v: AL * x + v, lambda x: x,
                       lambda x: I,
                       lambda xn, xo: mvn_logpdf_chol(xn, AL * xo, LQ),
                       lambda z, x: mvn_logpdf_chol(z, x, LR), R, cfg)
            ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T

            def one(key, z):
                st = filt.init_from_gaussian(key, jnp.zeros(D), S)
                ts = tracker.init(jnp.zeros(D), S)
                return filt.run(key, st, ts, z,
                                process_noise_sampler=ns)[2]["mean"]

            keys = jax.random.split(jax.random.PRNGKey(0), TR)
            return jax.vmap(one), (keys, Z)

        return build

    jobs.append(("EDH-200 snlg d=64 x100 trials",
                 flow_snlg_build(EDHFlowPF,
                                 EDHConfig(n_particles=200, n_lambda_steps=4)),
                 _mse_compare(X, PF_RTOL)))
    jobs.append(("LEDH-200 snlg d=64 x100 trials",
                 flow_snlg_build(LEDHFlowPF,
                                 LEDHConfig(n_particles=200, n_lambda_steps=4,
                                            resample_ess_ratio=0.5)),
                 _mse_compare(X, PF_RTOL)))

    # --- skew-t d=144 (run_benchmarks.bench_skewt): EKF, UKF, EDH, LEDH
    DS, TS, TRS = 144, 3, 100
    M1, M2 = 1.0, 1.0 / 3.0
    with jax.default_device(ctx.cpu):
        data = simulate_skewt_many(
            SkewTGridConfig(d=DS, alpha0=1.0, alpha1=1e-3, beta=8.0),
            SkewTDynConfig(alpha=AL, nu=8.0, gamma_scale=0.1, seed=42),
            SkewTMeasConfig(m1=M1, m2=M2),
            SkewTSimConfig(T=TS, n_trials=TRS),
        )
        Xs = np.asarray(data.X)
        Zs = np.asarray(data.Z, np.float32)
        SigS = np.asarray(data.Sigma)
        LQS = np.asarray(data.L)

    def skewt_parts():
        S = jnp.asarray(SigS)
        h = lambda x: M1 * jnp.exp(M2 * jnp.clip(x, -10, 10))
        R = jnp.diag(h(jnp.zeros(DS)))
        return S, h, R

    def ekf_skewt_build():
        S, h, R = skewt_parts()
        ekf = ExtendedKalmanFilter(lambda x, u: AL * x, h, S, R,
                                   joseph=True, jitter=1e-4)
        f = jax.vmap(lambda z: ekf.run(make_ekf_state(jnp.zeros(DS), S), z)[1])
        return f, (Zs,)

    jobs.append(("EKF skewt d=144 x100 trials", ekf_skewt_build,
                 _mse_compare(Xs, DET_RTOL)))

    def ukf_skewt_build():
        S, h, R = skewt_parts()
        ukf = UnscentedKalmanFilter(lambda x, u: AL * x, h, S, R, alpha=0.5,
                                    jitter=1e-5)
        f = jax.vmap(lambda z: ukf.run(make_ukf_state(jnp.zeros(DS), S), z)[1])
        return f, (Zs,)

    jobs.append(("UKF skewt d=144 x100 trials", ukf_skewt_build,
                 _mse_compare(Xs, DET_RTOL)))

    TRF = 4  # trials for the d=144 flows (the CPU side bounds the phase)

    def flow_skewt_build(cls, cfg):
        def build():
            S, h, R = skewt_parts()
            LQ = jnp.asarray(LQS)
            tracker = GaussianTracker(UnscentedKalmanFilter(
                lambda x, u: AL * x, h, S, R, alpha=0.5, jitter=1e-5))

            def poisson_ll(z, x):
                lam = h(x)
                return jnp.sum(z * jnp.log(lam + 1e-10) - lam)

            filt = cls(tracker, lambda x, u, v: AL * x + v, h,
                       jax.jacfwd(h),
                       lambda xn, xo: mvn_logpdf_chol(xn, AL * xo, LQ),
                       poisson_ll, R, cfg)
            ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T

            def one(key, z):
                st = filt.init_from_gaussian(key, jnp.zeros(DS), S)
                ts = tracker.init(jnp.zeros(DS), S)
                return filt.run(jax.random.fold_in(key, 1), st, ts, z,
                                process_noise_sampler=ns)[2]["mean"]

            keys = jax.random.split(jax.random.PRNGKey(7), TRF)
            return jax.vmap(one), (keys, Zs[:TRF])

        return build

    jobs.append((f"EDH-200 skewt d=144 x{TRF} trials",
                 flow_skewt_build(EDHFlowPF, EDHConfig(
                     n_particles=200, n_lambda_steps=8,
                     flow_integrator="euler", resample_ess_ratio=0.5)),
                 _mse_compare(Xs[:TRF], PF_RTOL)))
    jobs.append((f"LEDH-200 skewt d=144 x{TRF} trials",
                 flow_skewt_build(LEDHFlowPF, LEDHConfig(
                     n_particles=200, n_lambda_steps=8,
                     resample_ess_ratio=0.5)),
                 _mse_compare(Xs[:TRF], PF_RTOL)))

    # --- KPF on Lorenz-96 (examples/12: nx=1000, Np=20, every 4th variable
    # observed every 20 steps): 3 assimilation cycles, the analysis
    # while_loop nested in a lax.scan.
    with jax.default_device(ctx.cpu):
        l96 = simulate_lorenz96(nx=1000, spinup_steps=1000, total_steps=80,
                                Np=20, obs_interval=20, obs_fraction=4,
                                obs_error_std=1.0, seed=42)
        t_obs = np.asarray(l96.obs_times)
        ens0 = np.asarray(l96.ensemble_traj[:, t_obs[0], :])
        obs = np.asarray(l96.observations[1:4])
        truth_l96 = np.asarray(l96.truth_traj[t_obs[1:4]])
        _check(bool(np.all(np.diff(t_obs[:4]) == 20)), f"obs times {t_obs}")
        H_idx = np.asarray(l96.H_idx)
        R_l96 = np.asarray(l96.R)

    def kpf_build():
        nx = 1000
        model = Model(
            H=lambda x: jnp.take(x, H_idx, axis=-1),
            JH=lambda x: jnp.zeros((H_idx.shape[0], nx)).at[
                jnp.arange(H_idx.shape[0]), H_idx].set(1.0),
            R=jnp.asarray(R_l96),
        )
        kpf = KernelParticleFilter(model, KPFConfig(localization_radius=4.0))

        def cycles(X0, ys):
            def body(X, y):
                X = l96_integrate(X, 0.01, 20)[-1]
                X = kpf.analyze(X, y).particles
                return X, jnp.mean(X, axis=0)

            return jax.lax.scan(body, X0, ys)[1]

        return cycles, (ens0, obs)

    jobs.append(("KPF lorenz96 nx=1000 Np=20 x3 cycles", kpf_build,
                 _mse_compare(truth_l96, PF_RTOL)))

    # --- SPF (run_benchmarks.bench_spf): bearing-only tempered update, 20
    # runs under vmap with the while-loop bisection β* solver.
    def spf_build():
        sensors = jnp.array([[3.5, 0.0], [-3.5, 0.0]])
        x_prior = jnp.array([3.0, 5.0])

        def h(x):
            dd = x[None, :] - sensors
            return jnp.arctan2(dd[:, 1], dd[:, 0])

        H = jax.jacfwd(h)(x_prior)
        z = jnp.array([0.4754, 1.1868])
        model = LinearGaussianBayes.create(
            m0=x_prior, P0=jnp.diag(jnp.array([1000.0, 2.0])), H=H,
            R=0.04 * jnp.eye(2), z=z - (h(x_prior) - H @ x_prior))
        f = jax.vmap(lambda k: run_generalized_spf(
            model, N=50, n_steps=1000, beta_mode="optimal", mu=0.2, key=k,
            beta_solver="bisection")[1])
        return f, (jax.random.split(jax.random.PRNGKey(0), 20),)

    jobs.append(("SPF optimal-beta bisection x20 runs", spf_build,
                 _mse_compare(np.array([4.0, 4.0]), PF_RTOL)))

    # --- DPF value_and_grad steps (run_benchmarks.bench_dpf_linear widths)
    A_C, SQ, SR, N_D, T_D = 0.9, 0.3, 0.5, 50, 5
    rng = np.random.default_rng(0)
    xs_d = np.cumsum(SQ * rng.standard_normal((T_D, 1)), 0).astype(np.float32)
    ys_d = (xs_d + SR * rng.standard_normal((T_D, 1))).astype(np.float32)

    def dpf_loss_build(kind):
        def build():
            def trans(k, p, params):
                return params["a"] * p + SQ * jax.random.normal(k, p.shape)

            def loglik(p, y, params):
                return jnp.sum(-0.5 * (y[:, None, :] - p) ** 2 / SR**2, -1)

            def mse(ps, lws):
                w = jax.nn.softmax(lws, axis=-1)
                m = jnp.einsum("btn,btnd->btd", w, ps)
                return jnp.mean((m[:, 1:] - xs_d[None]) ** 2)

            if kind == "soft":
                dpf = DifferentiableParticleFilter(N_D, 1, trans, loglik)

                def loss(a, key):
                    return mse(*dpf.filter(key, ys_d[None], jnp.zeros(1),
                                           jnp.eye(1), params={"a": a}))
            elif kind == "rnn":
                dpf = DifferentiableParticleFilterRNN(
                    N_D, 1, trans, loglik, rnn_hidden_dim=16,
                    temperature=0.5)
                rparams = dpf.init_resampler(jax.random.PRNGKey(1))

                def loss(a, key):
                    return mse(*dpf.filter(rparams, key, ys_d[None],
                                           jnp.zeros(1), jnp.eye(1),
                                           model_params={"a": a}))
            else:
                def loss(a, key):
                    ot = DPF_OT(
                        N_D, 1,
                        lambda k, p, t: a * p + SQ * jax.random.normal(
                            k, p.shape),
                        lambda p, y, t: jnp.sum(
                            -0.5 * (p - y[None, :]) ** 2 / SR**2, 1),
                        epsilon=0.01, n_sinkhorn_iters=50)
                    ps, ws = ot.run_filter(key, ys_d, jnp.zeros(1),
                                           jnp.eye(1))
                    m = jnp.einsum("tn,tnd->td", ws, ps)
                    return jnp.mean((m[1:] - xs_d) ** 2)

            return (jax.value_and_grad(loss),
                    (jnp.float32(A_C), jax.random.PRNGKey(3)))

        return build

    def grad_compare(g, c):
        ok = within(g[0], c[0], rtol=PF_RTOL) and within(
            g[1], c[1], rtol=PF_RTOL, atol=1e-3)
        return ok, (f"loss gpu={float(g[0]):.6g} cpu={float(c[0]):.6g}; "
                    f"grad gpu={float(g[1]):.6g} cpu={float(c[1]):.6g}")

    for kind in ("soft", "ot", "rnn"):
        jobs.append((f"DPF-{kind} value_and_grad N=50 T={T_D}",
                     dpf_loss_build(kind), grad_compare))

    _run_families(ctx, jobs)


def phase_four(ctx: Ctx) -> None:
    import jax
    import numpy as np

    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__
    from bench import make_sv_filter, make_sv_fused_filter, sv_prior
    from particle_filters_jax.parallel import (
        make_mesh,
        make_sharded_pf_run,
        shard_pf_state,
    )

    devs = jax.devices()
    _check(len(devs) >= 4, f"--four needs 4 GPUs, JAX sees {len(devs)}")
    n_per, n_cards = N_FOUR_PER_CARD, 4
    n = n_per * n_cards
    zs = jax.device_put(ctx.zs_host, devs[0])
    key = jax.random.PRNGKey(2)

    run1, state1 = _sv_run_fn(n, zs, "threefry2x32")
    c1, t_c1 = _compile(run1, key, state1)
    t0 = time.perf_counter()
    _, h1 = jax.block_until_ready(c1(key, state1))
    t_r1 = time.perf_counter() - t0
    r1 = _rmse(h1["mean"][:, 0], ctx.x_true)
    print(f"[four] 1 card N={n}: compile_s={t_c1:.3f} run_s={t_r1:.4f} "
          f"rmse={r1:.6f}")
    del state1, h1

    mesh = make_mesh(n_batch=1, n_particles=n_cards, devices=devs[:n_cards])
    rep = NamedSharding(mesh, P())
    key, zs = jax.device_put((key, ctx.zs_host), rep)
    for make, mode in [(make_sv_filter, "all_gather"),
                       (make_sv_filter, "neighbor"),
                       (make_sv_fused_filter, "all_gather"),
                       (make_sv_fused_filter, "neighbor")]:
        pf = make(n, axis_name="particles", distributed_resample=mode)
        label = f"{type(pf).__name__} {mode}"
        st = shard_pf_state(
            pf.initialize(jax.random.key(0, impl="threefry2x32"),
                          *sv_prior()), mesh)
        run = make_sharded_pf_run(pf, mesh)
        t0 = time.perf_counter()
        compiled = run.lower(key, st, zs).compile()
        t_c = time.perf_counter() - t0
        jax.block_until_ready(compiled(key, st, zs))
        t0 = time.perf_counter()
        _, h = jax.block_until_ready(compiled(key, st, zs))
        t_r = time.perf_counter() - t0
        r = _rmse(h["mean"][:, 0], ctx.x_true)
        ex_ok = bool(np.all(np.asarray(h["exchange_ok"])))
        frac = float(np.mean(np.asarray(h["resampled"])))
        peaks = [_peak_bytes(d) for d in devs[:n_cards]]
        print(f"[four] {label}: {n_cards} cards x {n_per} particles "
              f"compile_s={t_c:.3f} run_s={t_r:.4f} "
              f"ms_per_step={t_r / T_MAIN * 1e3:.4f} rmse={r:.6f} "
              f"(1-card Δ={abs(r - r1):.6g}) resample_frac={frac:.4f} "
              f"exchange_ok={ex_ok} on {ctx.label}")
        print(f"[four] {label}: peak_bytes_in_use per card={peaks}")
        _check(abs(r - r1) <= 0.02, f"{label}: RMSE {r} vs 1-card {r1}")
        _check(ex_ok, f"{label}: exchange_ok not all true")
        del st, h

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n_cards)
    print(f"[four] dryrun_multichip({n_cards}) s={time.perf_counter() - t0:.3f}"
          f" peak_bytes_in_use per card="
          f"{[_peak_bytes(d) for d in devs[:n_cards]]}")


PHASES = {
    "device": phase_device,
    "main": phase_main,
    "reference": phase_reference,
    "resample": phase_resample,
    "families": phase_families,
    "four": phase_four,
}
DEFAULT_PHASES = ["device", "main", "reference", "resample", "families"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import jax

    from particle_filters_jax.utils.device import (
        device_summary,
        enable_compile_cache,
        require_gpu,
    )

    require_gpu()  # SystemExit (non-zero) when there is no GPU
    enable_compile_cache()
    phases = ["device", "four"] if args.four else DEFAULT_PHASES

    ctx = Ctx()
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        print(f"=== phase {name} ===", flush=True)
        try:
            PHASES[name](ctx)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            if name == "device":
                break
        print(f"=== phase {name}: "
              f"{'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s) ===", flush=True)
        jax.clear_caches()
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(final_line(device_summary()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
