#!/usr/bin/env python
"""Reproduce the reference's headline benchmarks on a GPU.

Reference numbers (BASELINE.md, CPU NumPy/TF-eager):

| workload                         | reference                  |
|----------------------------------|----------------------------|
| SV (T=2000): EKF/UKF/PF ms/step  | 0.123 / 0.327 / 10.24      |
| SV RMSE: EKF/UKF/PF              | 9.735 / 7.705 / 3.450      |
| DPF N=50 step ms: soft/OT/RNN    | 8.0 / 3550 / 4.2           |
| SNLG d=64 T=50: KF/UKF/EDH-200 s | 0.01 / 0.22 / 1.98 (x100 trials) |
| MAT T=40 N=500: EDH/LEDH total s | 6.39 / 2095.7              |
| SIR N=1e6 particle-steps/s       | ~2e5 (CPU, extrapolated)   |

Data is re-simulated with the same model configs (seeds differ — JAX
threefry vs NumPy PCG64 — so accuracy comparisons are config-parity, not
bitwise). Needs a GPU (exits non-zero elsewhere). Writes
bench_out/run_benchmarks.json with the device it ran on.

Usage:  python benchmarks/run_benchmarks.py [name ...]
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from particle_filters_jax.utils.device import (  # noqa: E402
    device_summary,
    enable_compile_cache,
    query_cards,
    require_gpu,
)
from particle_filters_jax.utils.timing import time_best  # noqa: E402

RESULTS = {}


def timed(fn, *args, reps=3, warmup=1):
    """Best-of-``reps`` wall time, each call ended by
    ``jax.block_until_ready`` (``utils.timing.time_best``); returns
    ``(seconds, output)``."""
    best, _, out = time_best(fn, *args, reps=reps, warmup=warmup)
    return best, out


def bench_sv_classic():
    """EKF / UKF / SIR-PF on the SV model, T=2000 (reference
    EKF_UKF_PF_comparison.ipynb cell 9)."""
    from particle_filters_jax.models import (
        ExtendedKalmanFilter,
        ParticleFilter,
        UnscentedKalmanFilter,
        make_ekf_state,
        make_ukf_state,
    )
    from particle_filters_jax.simulators import simulate_sv_1d

    T = 2000
    alpha, sigma, beta = 0.95, 0.2, 1.0
    sv = simulate_sv_1d(T, alpha, sigma, beta, seed=42)
    X = sv.X

    # EKF/UKF on the log-squared-observation transform (the standard
    # Gaussianization; raw SV obs have state-dependent variance).
    eps = 1e-8
    y_log = jnp.log(sv.Y**2 + eps)[:, None]  # ≈ x + log β² + log W²
    # log W² for W~N(0,1): mean ≈ −1.2704, var ≈ π²/2
    gm = lambda x, u: alpha * x
    hm = lambda x: x + jnp.log(beta**2) - 1.2704
    Q = jnp.array([[sigma**2]])
    R_log = jnp.array([[np.pi**2 / 2]])

    ekf = ExtendedKalmanFilter(gm, hm, Q, R_log)
    t_ekf, (_, means_e, _) = timed(
        jax.jit(lambda z: ekf.run(make_ekf_state(jnp.zeros(1), jnp.eye(1)), z)),
        y_log,
    )
    ukf = UnscentedKalmanFilter(gm, hm, Q, R_log, alpha=1.0)
    t_ukf, (_, means_u, _) = timed(
        jax.jit(lambda z: ukf.run(make_ukf_state(jnp.zeros(1), jnp.eye(1)), z)),
        y_log,
    )

    def obs_ll(x, z):
        var = beta**2 * jnp.exp(x[0])
        return -0.5 * (z[0] ** 2 / var + jnp.log(var))

    pf = ParticleFilter(gm, None, Q, None, Np=2000, obs_loglik=obs_ll)
    st0 = pf.initialize(
        jax.random.PRNGKey(0), jnp.zeros(1), jnp.array([[sigma**2 / (1 - alpha**2)]])
    )
    t_pf, (_, hist) = timed(
        jax.jit(lambda k, s: pf.run(k, s, sv.Y[:, None])),
        jax.random.PRNGKey(1),
        st0,
    )

    RESULTS["sv_classic"] = {
        "T": T,
        "ekf_ms_per_step": t_ekf / T * 1e3,
        "ukf_ms_per_step": t_ukf / T * 1e3,
        "pf_ms_per_step": t_pf / T * 1e3,
        "ekf_rmse": float(jnp.sqrt(jnp.mean((means_e[:, 0] - X) ** 2))),
        "ukf_rmse": float(jnp.sqrt(jnp.mean((means_u[:, 0] - X) ** 2))),
        "pf_rmse": float(jnp.sqrt(jnp.mean((hist["mean"][:, 0] - X) ** 2))),
        "reference_ms_per_step": {"ekf": 0.123, "ukf": 0.327, "pf": 10.24},
        "reference_rmse": {"ekf": 9.735, "ukf": 7.705, "pf": 3.450},
    }


def bench_dpf_linear():
    """DPF soft/OT/RNN on a 1-D LGSSM, N=50, T=20 (reference
    DPF_resampling_comparison_linear.ipynb cell 5)."""
    from particle_filters_jax.models import (
        DPF_OT,
        DifferentiableParticleFilter,
        DifferentiableParticleFilterRNN,
    )

    key = jax.random.PRNGKey(0)
    A_C, SQ, SR = 0.9, 0.3, 0.5
    B, T, N = 1, 20, 50
    ks = jax.random.split(key, T + 1)
    x = jnp.zeros((B, 1))
    xs, ys = [], []
    for t in range(T):
        k1, k2 = jax.random.split(ks[t])
        x = A_C * x + SQ * jax.random.normal(k1, x.shape)
        ys.append(x + SR * jax.random.normal(k2, x.shape))
        xs.append(x)
    X = jnp.stack(xs, 1)
    Y = jnp.stack(ys, 1)
    truth = jnp.concatenate([jnp.zeros((B, 1, 1)), X], axis=1)

    def trans(k, p, params):
        return A_C * p + SQ * jax.random.normal(k, p.shape, p.dtype)

    def loglik(p, y, params):
        return jnp.sum(-0.5 * (y[:, None, :] - p) ** 2 / SR**2, axis=-1)

    out = {}
    # soft
    dpf = DifferentiableParticleFilter(N, 1, trans, loglik)
    f = jax.jit(
        lambda k: dpf.filter(k, Y, jnp.zeros(1), jnp.eye(1),
                             return_diagnostics=True, ground_truth=truth)
    )
    t_soft, (_, _, diag) = timed(f, key)
    out["soft_ms_per_step"] = t_soft / T * 1e3
    out["soft_rmse"] = float(diag["mean_rmse"])

    # OT
    def trans1(k, p, t):
        return A_C * p + SQ * jax.random.normal(k, p.shape, p.dtype)

    def obsll1(p, y, t):
        return jnp.sum(-0.5 * (y - p) ** 2 / SR**2, axis=-1)

    # Tuned settings from the epsilon/damping/iteration sweep
    # (examples/08_dpf_ot_tuning.py: best RMSE 0.3336 at eps=0.01,
    # damping=1.0, 50 iters — matches the reference's 0.3336).
    dpf_ot = DPF_OT(N, 1, trans1, obsll1, epsilon=0.01, n_sinkhorn_iters=50,
                    damping=1.0)
    f_ot = jax.jit(lambda k: dpf_ot.run_filter(k, Y[0], jnp.zeros(1), jnp.eye(1)))
    t_ot, (ps, ws) = timed(f_ot, key)
    means = jnp.einsum("tn,tnd->td", ws, ps)
    out["ot_ms_per_step"] = t_ot / T * 1e3
    out["ot_rmse"] = float(jnp.sqrt(jnp.mean((means[1:] - X[0]) ** 2)))

    # RNN (baseline mode — untrained, like the reference comparison)
    dpf_rnn = DifferentiableParticleFilterRNN(
        N, 1, trans, loglik, use_baseline_resampling=True, temperature=0.5
    )
    params = dpf_rnn.init_resampler(key)
    f_rnn = jax.jit(
        lambda k: dpf_rnn.filter(params, k, Y, jnp.zeros(1), jnp.eye(1),
                                 return_diagnostics=True, ground_truth=truth)
    )
    t_rnn, (_, _, diag_r) = timed(f_rnn, key)
    out["rnn_ms_per_step"] = t_rnn / T * 1e3
    out["rnn_rmse"] = float(diag_r["mean_rmse"])

    # rnn (trained): short optax NLL run (the calibration objective — see
    # examples/09_train_rnn_resampler.py; on a linear-Gaussian model the
    # RMSE floor is resampler-insensitive, so the trained win is NLL).
    import optax

    dpf_tr = DifferentiableParticleFilterRNN(
        N, 1, trans, loglik, rnn_hidden_dim=16, temperature=0.5,
        use_weight_prior=True,
    )

    def moments(dpf_obj, p, k, ys):
        ps_, lws_ = dpf_obj.filter(p, k, ys, jnp.zeros(1), jnp.eye(1))
        w_ = jnp.exp(
            lws_ - jax.scipy.special.logsumexp(lws_, axis=-1, keepdims=True)
        )
        m_ = jnp.einsum("btn,btnd->btd", w_, ps_)
        v_ = jnp.sum(w_ * (ps_[..., 0] - m_[..., 0][..., None]) ** 2, axis=-1)
        return m_[:, 1:], v_[:, 1:]

    def nll(dpf_obj, p, k, ys, xs):
        m_, v_ = moments(dpf_obj, p, k, ys)
        v_ = v_ + 1e-4
        return jnp.mean(
            0.5 * jnp.log(v_) + 0.5 * (m_[..., 0] - xs[..., 0]) ** 2 / v_
        )

    # Train on FRESH simulated minibatches of the same system — never on
    # the benchmark sequence itself (examples/09's protocol; the earlier
    # train-on-the-test-sequence version overstated the trained row).
    def sim_batch(k, batch, t_steps):
        k0, ks = jax.random.split(k)
        x0 = jnp.zeros((batch, 1))

        def body(x, kk):
            k1, k2 = jax.random.split(kk)
            x = A_C * x + SQ * jax.random.normal(k1, x.shape)
            y = x + SR * jax.random.normal(k2, x.shape)
            return x, (x, y)

        _, (xs_, ys_) = jax.lax.scan(body, x0, jax.random.split(ks, t_steps))
        return xs_.swapaxes(0, 1), ys_.swapaxes(0, 1)

    p_tr = dpf_tr.init_resampler(key)
    opt = optax.adam(3e-3)
    opt_state = opt.init(p_tr)

    @jax.jit
    def tstep(p, s, k):
        kd, kf = jax.random.split(k)
        xs_b, ys_b = sim_batch(kd, 8, T)
        loss, g = jax.value_and_grad(
            lambda q: nll(dpf_tr, q, kf, ys_b, xs_b)
        )(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s, loss

    for i in range(300):
        p_tr, opt_state, _ = tstep(p_tr, opt_state, jax.random.fold_in(key, i))

    # Held-out evaluation ON the benchmark sequence, averaged over 8
    # fresh filter keys (one-key results on T=20 are seed noise).
    eval_keys = [jax.random.fold_in(key, 990 + i) for i in range(8)]
    f_tr = jax.jit(
        lambda k: dpf_tr.filter(p_tr, k, Y, jnp.zeros(1), jnp.eye(1),
                                return_diagnostics=True, ground_truth=truth)
    )
    t_tr, _ = timed(f_tr, eval_keys[0])
    out["rnn_trained_ms_per_step"] = t_tr / T * 1e3
    out["rnn_trained_rmse"] = float(np.mean(
        [float(f_tr(k)[2]["mean_rmse"]) for k in eval_keys]
    ))
    out["rnn_trained_nll"] = float(np.mean(
        [float(nll(dpf_tr, p_tr, k, Y, X)) for k in eval_keys]
    ))
    dpf_rnn_b = DifferentiableParticleFilterRNN(
        N, 1, trans, loglik, rnn_hidden_dim=16, temperature=0.5,
        use_weight_prior=True, use_baseline_resampling=True,
    )
    out["rnn_baseline_nll"] = float(np.mean(
        [float(nll(dpf_rnn_b, p_tr, k, Y, X)) for k in eval_keys]
    ))
    f_rnn_multi = jax.jit(
        lambda k: dpf_rnn.filter(params, k, Y, jnp.zeros(1), jnp.eye(1),
                                 return_diagnostics=True, ground_truth=truth)
    )
    out["rnn_rmse_8keys"] = float(np.mean(
        [float(f_rnn_multi(k)[2]["mean_rmse"]) for k in eval_keys]
    ))

    out["reference_ms_per_step"] = {"soft": 8.0, "ot": 3550.0, "rnn": 4.2}
    out["reference_rmse"] = {"soft": 0.3653, "ot": 0.3336, "rnn": 0.5018}
    RESULTS["dpf_linear"] = out


def bench_dpf_nonlinear():
    """DPF soft/OT/RNN on the stochastic-volatility model, N=100, T=100
    (reference DPF_resampling_comparison_nonlinear.ipynb cells 10-12:
    RMSE soft/OT/RNN = 0.3586/0.3131/0.3496; runtimes 0.76/626.7/842.0 s)."""
    from particle_filters_jax.models import (
        DPF_OT,
        DifferentiableParticleFilter,
        DifferentiableParticleFilterRNN,
    )

    T, N = 100, 100
    alpha, sigma, beta = 0.95, 0.2, 0.6
    # The reference's EXACT seed-42 data realization (NumPy PCG64, same
    # draw order as simulator_sto_volatility_model.py:96-119) so the RMSE
    # column is directly comparable — JAX threefry seed 42 is a different,
    # and as it happens harder, trajectory.
    rng = np.random.default_rng(42)
    var0 = sigma**2 / (1 - alpha**2)
    Xr = np.empty(T)
    Xr[0] = rng.normal(0.0, np.sqrt(var0))
    V = rng.standard_normal(T - 1)
    for t in range(1, T):
        Xr[t] = alpha * Xr[t - 1] + sigma * V[t - 1]
    W = rng.standard_normal(T)
    Yr = beta * np.exp(0.5 * Xr) * W
    X = jnp.asarray(Xr[:, None], jnp.float32)  # (T, 1)
    Y = jnp.asarray(Yr[None, :, None], jnp.float32)  # (1, T, 1)
    truth = jnp.concatenate([jnp.zeros((1, 1, 1)), X[None]], axis=1)
    init_chol = jnp.float32(np.sqrt(var0)) * jnp.eye(1)
    key = jax.random.PRNGKey(0)

    def trans(k, p, params):
        return alpha * p + sigma * jax.random.normal(k, p.shape, p.dtype)

    def loglik(p, y, params):
        var = beta**2 * jnp.exp(p[..., 0])
        return -0.5 * (y[:, None, 0] ** 2 / var + jnp.log(var))

    out = {"T": T, "N": N}
    # soft (notebook: alpha=0.1, tau=0.5)
    dpf = DifferentiableParticleFilter(
        N, 1, trans, loglik, soft_alpha=0.1, gumbel_temperature=0.5
    )
    f = jax.jit(
        lambda k: dpf.filter(k, Y, jnp.zeros(1), init_chol,
                             return_diagnostics=True, ground_truth=truth)
    )
    t_soft, (_, _, diag) = timed(f, key)
    out["soft_ms_per_step"] = t_soft / T * 1e3
    out["soft_rmse"] = float(diag["mean_rmse"])

    # OT (notebook: eps=0.1, 50 iters; damping tuned undamped)
    def trans1(k, p, t):
        return alpha * p + sigma * jax.random.normal(k, p.shape, p.dtype)

    def obsll1(p, y, t):
        var = beta**2 * jnp.exp(p[:, 0])
        return -0.5 * (y[0] ** 2 / var + jnp.log(var))

    # eps tuned on this config (sweep in examples/08_dpf_ot_tuning.py style;
    # 0.02 is the flat optimum across damping/iterations)
    dpf_ot = DPF_OT(N, 1, trans1, obsll1, epsilon=0.02, n_sinkhorn_iters=50,
                    damping=1.0)
    f_ot = jax.jit(lambda k: dpf_ot.run_filter(k, Y[0], jnp.zeros(1), init_chol))
    t_ot, (ps, ws) = timed(f_ot, key)
    means = jnp.einsum("tn,tnd->td", ws, ps)
    out["ot_ms_per_step"] = t_ot / T * 1e3
    out["ot_rmse"] = float(jnp.sqrt(jnp.mean((means[1:] - X) ** 2)))

    # RNN (notebook: LSTM hidden 32; untrained -> baseline-equivalent
    # near-uniform head; baseline mode gives the comparable training-free
    # resampler)
    dpf_rnn = DifferentiableParticleFilterRNN(
        N, 1, trans, loglik, rnn_type="lstm", rnn_hidden_dim=32,
        use_baseline_resampling=True, temperature=0.5,
    )
    params = dpf_rnn.init_resampler(key)
    f_rnn = jax.jit(
        lambda k: dpf_rnn.filter(params, k, Y, jnp.zeros(1), init_chol,
                                 return_diagnostics=True, ground_truth=truth)
    )
    t_rnn, (_, _, diag_r) = timed(f_rnn, key)
    out["rnn_ms_per_step"] = t_rnn / T * 1e3
    out["rnn_rmse"] = float(diag_r["mean_rmse"])
    out["reference_total_s"] = {"soft": 0.76, "ot": 626.7, "rnn": 842.0}
    out["reference_rmse"] = {"soft": 0.3586, "ot": 0.3131, "rnn": 0.3496}
    RESULTS["dpf_nonlinear"] = out


def bench_snlg():
    """KF / UKF / EDH-200 / LEDH-200 / EDH-10000 on SNLG d=64, T=50,
    100 trials (reference PF_PF_results_reproduction_snlg.ipynb cell 11
    config, exactly — the full five-filter column of its table)."""
    from particle_filters_jax.core.linalg import mvn_logpdf_chol
    from particle_filters_jax.models import (
        EDHConfig,
        EDHFlowPF,
        ExtendedKalmanFilter,
        GaussianTracker,
        LEDHConfig,
        LEDHFlowPF,
        UnscentedKalmanFilter,
        kalman_filter_general,
        make_ukf_state,
    )
    from particle_filters_jax.simulators.sensor_network_lg import (
        make_grid_coords,
        se_kernel_cov,
    )

    D, T, TRIALS, SZ, AL = 64, 50, 100, 2.0, 0.9
    # The reference's EXACT seed-123 data stream (NumPy PCG64, trial-major
    # draw order as simulate_dataset, sigma_z=2.0 block first) so the MSE
    # column is directly comparable; Sigma comes from the parity-tested
    # SE-kernel builder (no need to simulate a throwaway JAX dataset).
    Sigma_jax = se_kernel_cov(make_grid_coords(D), 3.0, 20.0, 0.01)
    Sigma_np = np.asarray(Sigma_jax, np.float64)
    L_np = np.linalg.cholesky(Sigma_np)
    rng = np.random.default_rng(123)

    def sim_block(sz):
        X = np.zeros((TRIALS, T + 1, D))
        Z = np.zeros((TRIALS, T, D))
        for r in range(TRIALS):
            x = np.zeros(D)
            for t in range(1, T + 1):
                x = AL * x + L_np @ rng.standard_normal(D)
                X[r, t] = x
                Z[r, t - 1] = x + sz * rng.standard_normal(D)
        return jnp.asarray(X, jnp.float32), jnp.asarray(Z, jnp.float32)

    # The reference draws its noise-level blocks sequentially from ONE
    # seed-123 PCG64 stream, sigma_z = 2.0 first, then 1.0 (its table's
    # second column) — reproduce both blocks in that order.
    X_ref, Z_ref = sim_block(SZ)
    X_ref1, Z_ref1 = sim_block(1.0)

    I = jnp.eye(D)
    Sigma = jnp.asarray(Sigma_jax, jnp.float32)
    R = SZ**2 * I

    # KF over all trials (vmapped)
    kf_run = jax.jit(
        jax.vmap(
            lambda Z: kalman_filter_general(
                Z, AL * I, I, I, Sigma, R, x0=jnp.zeros(D), P0=Sigma
            ).x_filt
        )
    )
    t_kf, kf_means = timed(kf_run, Z_ref)
    kf_mse = float(jnp.mean((kf_means - X_ref[:, 1:]) ** 2))

    # KF at sigma_z = 1.0 (reference table's second noise level: 0.1918)
    kf_run1 = jax.jit(
        jax.vmap(
            lambda Z: kalman_filter_general(
                Z, AL * I, I, I, Sigma, 1.0 * I, x0=jnp.zeros(D), P0=Sigma
            ).x_filt
        )
    )
    kf_mse_sz1 = float(jnp.mean((kf_run1(Z_ref1) - X_ref1[:, 1:]) ** 2))

    ukf = UnscentedKalmanFilter(lambda x, u: AL * x, lambda x: x, Sigma, R, alpha=1.0)
    ukf_run = jax.jit(
        jax.vmap(lambda Z: ukf.run(make_ukf_state(jnp.zeros(D), Sigma), Z)[1])
    )
    t_ukf, ukf_means = timed(ukf_run, Z_ref)
    ukf_mse = float(jnp.mean((ukf_means - X_ref[:, 1:]) ** 2))

    # Flow filters — the reference table's remaining three rows:
    # EDH-200 (1.98 s/trial), LEDH-200 (7.38 s/trial), EDH-10000
    # (90.9 s/trial). All 100 trials vmapped into one device program.
    LQ = jnp.linalg.cholesky(Sigma + 1e-6 * I)
    LR = SZ * I
    g = lambda x, u, v: AL * x + v
    h = lambda x: x
    jh = lambda x: I
    lt = lambda xn, xo: mvn_logpdf_chol(xn, AL * xo, LQ)
    ll = lambda z, x: mvn_logpdf_chol(z, x, LR)
    ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T
    keys = jax.random.split(jax.random.PRNGKey(0), TRIALS)

    out = {
        "trials": TRIALS,
        "kf_total_s": t_kf,
        "ukf_total_s": t_ukf,
        "kf_mse": kf_mse,
        "kf_mse_sz1": kf_mse_sz1,
        "ukf_mse": ukf_mse,
    }
    # The notebook overrides the shared defaults for SNLG: 4 lambda steps
    # and ESS/N < 0.5 resampling for BOTH flows (its run_{edh,ledh}_
    # experiment cells; EDH keeps the default RK4 integrator).
    for tag, cls, cfg in [
        ("edh200", EDHFlowPF,
         EDHConfig(n_particles=200, n_lambda_steps=4)),
        ("ledh200", LEDHFlowPF,
         LEDHConfig(n_particles=200, n_lambda_steps=4,
                    resample_ess_ratio=0.5)),
        ("edh10000", EDHFlowPF,
         EDHConfig(n_particles=10000, n_lambda_steps=4)),
    ]:
        ekf = ExtendedKalmanFilter(lambda x, u: AL * x, h, Sigma, R)
        tracker = GaussianTracker(ekf)
        filt = cls(tracker, g, h, jh, lt, ll, R, cfg)

        def run_one(key, Z, filt=filt, tracker=tracker):
            st = filt.init_from_gaussian(key, jnp.zeros(D), Sigma)
            ts = tracker.init(jnp.zeros(D), Sigma)
            _, _, hist = filt.run(key, st, ts, Z, process_noise_sampler=ns)
            return hist["mean"]

        t_run, means = timed(jax.jit(jax.vmap(run_one)), keys, Z_ref)
        out[f"{tag}_total_s"] = t_run
        out[f"{tag}_mse"] = float(jnp.mean((means - X_ref[:, 1:]) ** 2))

    out["reference"] = {
        "trials": 100,
        "kf_s": 0.01, "ukf_s": 0.22, "edh200_s": 1.98,
        "ledh200_s": 7.38, "edh10000_s": 90.9,
        "kf_mse": 0.4958, "kf_mse_sz1": 0.1918,
        "ukf_mse": 0.4958, "edh200_mse": 0.6510,
        "ledh200_mse": 0.6512, "edh10000_mse": 0.5340,
    }
    RESULTS["snlg_d64"] = out


def bench_skewt():
    """EKF / UKF / EDH-200 / EDH-10000 / LEDH-200 on the skew-t sensor
    network, d=144, T=10, 100 trials — the reference's full
    PF_PF_results_reproduction_sn_skew.ipynb table (cell 9: EDH-200
    MSE 1.0535 / 1.05 s, EDH-10000 1.0427 / 31.7 s, LEDH-200 0.9695 /
    13.2 s per trial; EKF ≈0.010 s and UKF ≈0.336 s per its trial logs).

    Same working-Gaussian-model setup as ``examples/13_skewt_flows.py``
    (notebook cell 5): dynamics g(x) = 0.9x with Q = Σ, measurement
    h(x) = e^{x/3}, R = diag(h(0)), flows carry the exact Poisson
    log-likelihood. Data comes from our simulator with the notebook's
    config (α₀=1, α₁=1e-3, β=8; α=0.9, ν=8, γ-scale 0.1; m₁=1, m₂=1/3;
    seed 42) — config parity, not a bitwise stream replay, so the MSE
    column is statistically (not exactly) comparable. UKF runs at
    alpha=0.5 (the notebook's 1e-3 is unusable in f32 — see
    unscented_kalman_filter.py)."""
    from particle_filters_jax.core.linalg import mvn_logpdf_chol
    from particle_filters_jax.models import (
        EDHConfig,
        EDHFlowPF,
        ExtendedKalmanFilter,
        GaussianTracker,
        LEDHConfig,
        LEDHFlowPF,
        UnscentedKalmanFilter,
        make_ekf_state,
        make_ukf_state,
    )
    from particle_filters_jax.simulators import (
        SkewTDynConfig,
        SkewTGridConfig,
        SkewTMeasConfig,
        SkewTSimConfig,
        simulate_skewt_many,
    )

    D, T, TRIALS = 144, 10, 100
    M1, M2, AL = 1.0, 1.0 / 3.0, 0.9
    data = simulate_skewt_many(
        SkewTGridConfig(d=D, alpha0=1.0, alpha1=1e-3, beta=8.0),
        SkewTDynConfig(alpha=AL, nu=8.0, gamma_scale=0.1, seed=42),
        SkewTMeasConfig(m1=M1, m2=M2),
        SkewTSimConfig(T=T, n_trials=TRIALS),
    )
    X_all = jnp.asarray(data.X)  # (TRIALS, T, d)
    Z_all = jnp.asarray(data.Z, jnp.float32)
    Sigma = jnp.asarray(data.Sigma)
    LQ = jnp.asarray(data.L)

    h = lambda x: M1 * jnp.exp(M2 * jnp.clip(x, -10, 10))
    jac_h = jax.jacfwd(h)
    R = jnp.diag(h(jnp.zeros(D)))
    g_kf = lambda x, u: AL * x
    g_flow = lambda x, u, v: AL * x + v
    lt = lambda xn, xo: mvn_logpdf_chol(xn, AL * xo, LQ)
    ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T

    def poisson_ll(z, x):
        lam = h(x)
        return jnp.sum(z * jnp.log(lam + 1e-10) - lam)

    out = {"trials": TRIALS, "d": D, "T": T}

    ekf = ExtendedKalmanFilter(g_kf, h, Sigma, R, joseph=True, jitter=1e-4)
    ekf_run = jax.jit(
        jax.vmap(lambda Z: ekf.run(make_ekf_state(jnp.zeros(D), Sigma), Z)[1])
    )
    t_ekf, ekf_means = timed(ekf_run, Z_all)
    out["ekf_total_s"] = t_ekf
    out["ekf_mse"] = float(jnp.mean((ekf_means - X_all) ** 2))

    ukf = UnscentedKalmanFilter(g_kf, h, Sigma, R, alpha=0.5, jitter=1e-5)
    ukf_run = jax.jit(
        jax.vmap(lambda Z: ukf.run(make_ukf_state(jnp.zeros(D), Sigma), Z)[1])
    )
    t_ukf, ukf_means = timed(ukf_run, Z_all)
    out["ukf_total_s"] = t_ukf
    out["ukf_mse"] = float(jnp.mean((ukf_means - X_all) ** 2))

    keys = jax.random.split(jax.random.PRNGKey(7), TRIALS)
    # n_chunks: LEDH-200 at d=144 carries per-particle 144x144 temps; its
    # 100 trials run in 4 host-dispatched chunks of 25 to bound device
    # memory (whether one vmap fits a GPU is ROADMAP C6).
    for tag, cls, cfg, n_chunks in [
        ("edh200", EDHFlowPF,
         EDHConfig(n_particles=200, n_lambda_steps=8,
                   flow_integrator="euler", resample_ess_ratio=0.5), 1),
        ("edh10000", EDHFlowPF,
         EDHConfig(n_particles=10000, n_lambda_steps=8,
                   flow_integrator="euler", resample_ess_ratio=0.5), 1),
        ("ledh200", LEDHFlowPF,
         LEDHConfig(n_particles=200, n_lambda_steps=8,
                    resample_ess_ratio=0.5), 4),
    ]:
        ukf_tr = UnscentedKalmanFilter(g_kf, h, Sigma, R, alpha=0.5,
                                       jitter=1e-5)
        tracker = GaussianTracker(ukf_tr)
        filt = cls(tracker, g_flow, h, jac_h, lt, poisson_ll, R, cfg)

        def run_one(key, Z, filt=filt, tracker=tracker):
            st = filt.init_from_gaussian(key, jnp.zeros(D), Sigma)
            ts = tracker.init(jnp.zeros(D), Sigma)
            _, _, hist = filt.run(
                jax.random.fold_in(key, 1), st, ts, Z,
                process_noise_sampler=ns,
            )
            return hist["mean"], hist["ess"]

        run_v = jax.jit(jax.vmap(run_one))
        if n_chunks == 1:
            fn = run_v
        else:
            def fn(ks, Zs, run_v=run_v, n_chunks=n_chunks):
                outs = [
                    run_v(k, Z)
                    for k, Z in zip(
                        jnp.split(ks, n_chunks), jnp.split(Zs, n_chunks)
                    )
                ]
                return (
                    jnp.concatenate([o[0] for o in outs]),
                    jnp.concatenate([o[1] for o in outs]),
                )
        t_run, (means, ess) = timed(fn, keys, Z_all)
        out[f"{tag}_total_s"] = t_run
        out[f"{tag}_mse"] = float(jnp.mean((means - X_all) ** 2))
        out[f"{tag}_ess"] = float(jnp.mean(ess))

    out["reference"] = {
        "trials": 100,
        # per-trial seconds (table + trial logs) scaled to 100-trial totals
        "ekf_s": 1.0, "ukf_s": 33.6,
        "edh200_s": 105.4, "edh10000_s": 3173.6, "ledh200_s": 1321.3,
        "ekf_mse": None, "ukf_mse": None,
        "edh200_mse": 1.0535, "edh10000_mse": 1.0427,
        "ledh200_mse": 0.9695,
        "edh200_ess": 165.2, "edh10000_ess": 8450.6, "ledh200_ess": 163.1,
    }
    RESULTS["skewt_flows"] = out


def bench_mat_flows():
    """EDH / LEDH / EKF / UKF on MAT, T=40, N=500 — the reference's full
    joint-tracking table (PF_PF_results_reproduction_multi_target_acoustic_
    tracking.ipynb: OMAT 10.05 / 10.70 / 24.79 / 29.47, times 6.39 s /
    2095.7 s / 0.03 s / 0.10 s)."""
    from particle_filters_jax.core.linalg import mvn_logpdf_chol
    from particle_filters_jax.models import (
        EDHConfig,
        EDHFlowPF,
        ExtendedKalmanFilter,
        GaussianTracker,
        LEDHConfig,
        LEDHFlowPF,
        UnscentedKalmanFilter,
        make_ekf_state,
        make_ukf_state,
    )
    from particle_filters_jax.simulators import (
        MATDynamicsConfig,
        MATScenarioConfig,
        acoustic_measurement_model,
        article_initial_states,
        article_process_noise_cov,
        build_cv_transition,
        simulate_acoustic_dataset,
    )
    from particle_filters_jax.utils.diagnostics import omat

    C, NX, T, N = 4, 16, 40, 500
    mat = simulate_acoustic_dataset(
        MATScenarioConfig(n_steps=T, seed=7), MATDynamicsConfig()
    )
    sensors = mat.S
    nz = sensors.shape[0]
    F = jnp.kron(jnp.eye(C), build_cv_transition(1.0))
    Q = jnp.kron(jnp.eye(C), article_process_noise_cov())
    LQ = jnp.linalg.cholesky(Q + 1e-8 * jnp.eye(NX))
    R = 0.01 * jnp.eye(nz)
    LR = 0.1 * jnp.eye(nz)

    def h(x):
        pos = x.reshape(C, 4)[:, :2]
        return acoustic_measurement_model(pos[None], sensors, 10.0, 0.1)[0]

    jac_h = jax.jacfwd(h)
    g = lambda x, u, v: F @ x + v
    lt = lambda xn, xo: mvn_logpdf_chol(xn, F @ xo, LQ)
    ll = lambda z, x: mvn_logpdf_chol(z, h(x), LR)
    ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T
    key = jax.random.PRNGKey(0)
    zs = mat.Z + 0.1 * jax.random.normal(key, mat.Z.shape)
    x0 = article_initial_states(C).reshape(-1) + 0.5 * jax.random.normal(key, (NX,))

    out = {"T": T, "N": N}
    for name, cls, cfg in [
        ("edh", EDHFlowPF, EDHConfig(n_particles=N, flow_integrator="euler")),
        ("ledh", LEDHFlowPF, LEDHConfig(n_particles=N)),
    ]:
        ekf = ExtendedKalmanFilter(lambda x, u: F @ x, h, Q, R, jitter=1e-5)
        tracker = GaussianTracker(ekf)
        filt = cls(tracker, g, h, jac_h, lt, ll, R, cfg)
        st = filt.init_from_gaussian(key, x0, jnp.eye(NX))
        ts = tracker.init(x0, jnp.eye(NX))
        run = jax.jit(
            lambda k, s, t: filt.run(k, s, t, zs, process_noise_sampler=ns)
        )
        t_run, (_, _, hist) = timed(run, key, st, ts, reps=2)
        est = np.asarray(hist["mean"])
        omats = [
            omat(est[t].reshape(C, 4)[:, :2], np.asarray(mat.P[t + 0]))
            for t in range(0, T, 5)
        ]
        out[f"{name}_total_s"] = t_run
        out[f"{name}_avg_omat"] = float(np.mean(omats))

    # EKF / UKF rows of the same table (the flows should beat both —
    # reference OMATs 24.79 / 29.47; UKF uses the notebook's alpha).
    def omat_of(means):
        est = np.asarray(means)
        return float(np.mean([
            omat(est[t].reshape(C, 4)[:, :2], np.asarray(mat.P[t]))
            for t in range(0, T, 5)
        ]))

    ekf_f = ExtendedKalmanFilter(lambda x, u: F @ x, h, Q, R, jitter=1e-5)
    ekf_run = jax.jit(lambda z: ekf_f.run(make_ekf_state(x0, jnp.eye(NX)), z)[1])
    t_ekf, ekf_means = timed(ekf_run, zs)
    out["ekf_total_s"], out["ekf_avg_omat"] = t_ekf, omat_of(ekf_means)

    ukf_f = UnscentedKalmanFilter(
        lambda x, u: F @ x, h, Q, R, alpha=0.5, jitter=1e-5
    )
    ukf_run = jax.jit(lambda z: ukf_f.run(make_ukf_state(x0, jnp.eye(NX)), z)[1])
    t_ukf, ukf_means = timed(ukf_run, zs)
    out["ukf_total_s"], out["ukf_avg_omat"] = t_ukf, omat_of(ukf_means)

    out["reference"] = {
        "edh_s": 6.39, "ledh_s": 2095.7, "ekf_s": 0.03, "ukf_s": 0.10,
        "edh_omat": 10.05, "ledh_omat": 10.70,
        "ekf_omat": 24.79, "ukf_omat": 29.47,
    }
    RESULTS["mat_flows"] = out



def bench_ot_large():
    """Blockwise Sinkhorn-OT resampling at N the reference cannot touch.

    The upstream dense Sinkhorn (``models/DPF_OT_resampling.py``) took
    3.55 s/step at N=50 (BASELINE.md); its O(N²·iters) TensorArray loops
    extrapolate to ~10⁶ s at N=65536, and the dense cost matrix alone is
    17 GB. The blockwise path (``resampling/ot_blockwise.py``) streams the
    flash-attention-style logsumexp recurrence and never materializes N².
    """
    from particle_filters_jax.resampling.ot_blockwise import (
        sinkhorn_ot_resample_blockwise,
    )

    key = jax.random.PRNGKey(0)
    out = {}
    for n in (4096, 16384, 65536):
        p = jax.random.normal(key, (n, 2), jnp.float32)
        lw = jax.random.normal(jax.random.fold_in(key, 1), (n,)) * 0.5
        w = jax.nn.softmax(lw)

        f = jax.jit(
            lambda pp, ww: sinkhorn_ot_resample_blockwise(
                pp, ww, epsilon=0.1, n_iters=10, block=512
            )[0]
        )
        t, new_p = timed(f, p, w)
        # sanity: barycentric projection preserves the weighted mean
        err = float(
            jnp.linalg.norm(jnp.mean(new_p, 0) - (w @ p))
        )
        out[f"n{n}_s"] = t
        out[f"n{n}_mean_err"] = err
    out["n_iters"] = 10
    out["reference"] = {
        "dense_step_s_at_n50": 3.55,
        "note": "O(N^2 iters) extrapolation to N=65536 ~ 1e6 s; dense cost "
        "matrix 17 GB — infeasible upstream",
    }
    RESULTS["ot_large"] = out


def bench_nlngssm_flows():
    """EDH / LEDH / KPF on the nonlinear-non-Gaussian SV model, T=1000,
    N=500, 10 lambda steps, RK4 (reference EDH_LEDH_KPF_NLNGSSM.ipynb:
    EDH 113 s, LEDH 460 s, both RMSE 1.1422; its sv_simul_data.npz is not
    checked in upstream, so the data here is re-simulated — runtime
    comparison is config-parity)."""
    from particle_filters_jax.models import (
        EDHConfig,
        EDHFlowPF,
        KPFConfig,
        KernelParticleFilter,
        LEDHConfig,
        LEDHFlowPF,
        Model,
        UnscentedKalmanFilter,
        GaussianTracker,
    )
    from particle_filters_jax.simulators import simulate_sv_1d

    T, N = 1000, 500
    alpha, sigma, beta = 0.95, 0.2, 1.0
    sv = simulate_sv_1d(T, alpha, sigma, beta, seed=42)
    zs = sv.Y[:, None]
    key = jax.random.PRNGKey(0)

    # Notebook setup: h(x) = 0 (zero-mean observation), nominal R, UKF
    # tracker, true SV likelihood in the weights.
    g = lambda x, u, v: alpha * x + (v if v is not None else 0.0)
    h = lambda x: jnp.zeros(1)
    jh = lambda x: jnp.zeros((1, 1))
    R_nom = jnp.array([[beta**2 * float(jnp.exp(0.5 * sigma**2 / (1 - alpha**2)))]])
    Q = jnp.array([[sigma**2]])
    var0 = sigma**2 / (1 - alpha**2)

    def log_trans(xn, xo):
        return -0.5 * ((xn[0] - alpha * xo[0]) ** 2 / sigma**2)

    def log_like(z, x):
        var = beta**2 * jnp.exp(x[0])
        return -0.5 * (z[0] ** 2 / var + jnp.log(var))

    ns = lambda k, n, nx: sigma * jax.random.normal(k, (n, nx))

    out = {"T": T, "N": N}
    for name, cls, cfg in [
        ("edh", EDHFlowPF,
         EDHConfig(n_particles=N, n_lambda_steps=10, flow_integrator="rk4")),
        ("ledh", LEDHFlowPF, LEDHConfig(n_particles=N, n_lambda_steps=10,
                                        resample_ess_ratio=0.5)),
    ]:
        ukf = UnscentedKalmanFilter(
            lambda x, u: alpha * x, h, Q, R_nom, alpha=0.5
        )
        tracker = GaussianTracker(ukf)
        filt = cls(tracker, g, h, jh, log_trans, log_like, R_nom, cfg)
        st = filt.init_from_gaussian(key, jnp.zeros(1), jnp.array([[var0]]))
        ts = tracker.init(jnp.zeros(1), jnp.array([[var0]]))
        run = jax.jit(
            lambda k, s, t, f=filt: f.run(k, s, t, zs, process_noise_sampler=ns)
        )
        t_run, (_, _, hist) = timed(run, key, st, ts, reps=2)
        out[f"{name}_total_s"] = t_run
        out[f"{name}_rmse"] = float(
            jnp.sqrt(jnp.mean((hist["mean"][:, 0] - sv.X) ** 2))
        )

    # KPF: one analyze per step on propagated particles (notebook protocol)
    model = Model(H=h, JH=jh, R=R_nom)
    kpf = KernelParticleFilter(model, KPFConfig(max_steps=20))
    kpf_analyze = jax.jit(lambda X, y: kpf.analyze(X, y).particles)

    def kpf_run(key):
        def body(carry, inp):
            X, = carry
            k, z = inp
            X = alpha * X + sigma * jax.random.normal(k, X.shape)
            X = kpf_analyze(X, z)
            return (X,), jnp.mean(X)

        keys = jax.random.split(key, T)
        X0 = jnp.sqrt(var0) * jax.random.normal(key, (N, 1))
        _, means = jax.lax.scan(body, (X0,), (keys, zs))
        return means

    t_kpf, kpf_means = timed(jax.jit(kpf_run), key, reps=2)
    out["kpf_total_s"] = t_kpf
    out["kpf_rmse"] = float(jnp.sqrt(jnp.mean((kpf_means - sv.X) ** 2)))
    out["reference"] = {
        "edh_s": 113.0, "ledh_s": 460.0,
        "edh_rmse": 1.1422, "ledh_rmse": 1.1422,
        "note": "reference data file absent upstream; config parity only",
    }
    RESULTS["nlngssm_flows"] = out

def bench_spf():
    """SPF example 1 — bearing-only single tempered Bayes update, 20 MC
    runs with linear and optimal-β* homotopies (reference
    ``SPF_results_reproduction_example1.ipynb`` cell 13: ~1.66 s/run on
    CPU at N=50, n_steps=1000; the 20 runs here are one vmap).

    Scenario: sensors at (±3.5, 0), true target (4, 4), prior
    N([3, 5], diag(1000, 2)), R = 0.04·I, z = [0.4754, 1.1868], μ = 0.2 —
    the notebook's numbers exactly. Linearization is the notebook's
    cell-3 "global Gauss-Newton at the prior mean" variant (its preferred
    one: the frozen Hessian makes M(β) consistent between the β* design
    and the flow), which maps the bearing update onto
    ``LinearGaussianBayes`` with z adjusted by the innovation form.
    Diffusion is the paper's Q = M⁻¹ (the notebook's fixed diag(4, .4) is
    its per-particle variant's knob), so RMSE is design-parity, not
    bitwise.
    """
    from particle_filters_jax.models import (
        LinearGaussianBayes,
        run_generalized_spf,
    )

    x_true = jnp.array([4.0, 4.0])
    sensors = jnp.array([[3.5, 0.0], [-3.5, 0.0]])
    x_prior = jnp.array([3.0, 5.0])
    P_prior = jnp.diag(jnp.array([1000.0, 2.0]))
    R = 0.04 * jnp.eye(2)
    z = jnp.array([0.4754, 1.1868])

    def h(x):
        d = x[None, :] - sensors
        return jnp.arctan2(d[:, 1], d[:, 0])

    H = jax.jacfwd(h)(x_prior)
    z_adj = z - (h(x_prior) - H @ x_prior)
    model = LinearGaussianBayes.create(
        m0=x_prior, P0=P_prior, H=H, R=R, z=z_adj
    )

    n_runs, N, n_steps = 20, 50, 1000
    keys = jax.random.split(jax.random.PRNGKey(0), n_runs)
    out = {"n_runs": n_runs, "N": N, "n_steps": n_steps}
    for mode in ("linear", "optimal"):
        f = jax.jit(
            jax.vmap(
                lambda k: run_generalized_spf(
                    model, N=N, n_steps=n_steps, beta_mode=mode, mu=0.2,
                    key=k,
                )[1]
            )
        )
        t, means = timed(f, keys)
        out[f"{mode}_total_s"] = t
        out[f"{mode}_rmse"] = float(
            jnp.mean(jnp.linalg.norm(means - x_true, axis=1))
        )
    out["reference"] = {
        "per_run_s": 1.66,
        "total_s_20runs": 33.2,
        "rmse_linear": 6.3,
        "note": "reference RMSE is its per-particle-Hessian variant with "
        "fixed Q=diag(4,.4); this row uses the notebook's global-"
        "linearization variant with Q=M^-1 (design parity)",
    }
    RESULTS["spf_example1"] = out


def main():
    require_gpu()
    enable_compile_cache()
    card = query_cards()[0]
    which = sys.argv[1:] if len(sys.argv) > 1 else [
        "sv_classic", "dpf_linear", "dpf_nonlinear", "snlg", "skewt_flows",
        "mat_flows", "nlngssm_flows", "ot_large", "spf_example1",
    ]
    benches = {
        "sv_classic": bench_sv_classic,
        "dpf_linear": bench_dpf_linear,
        "dpf_nonlinear": bench_dpf_nonlinear,
        "snlg": bench_snlg,
        "skewt_flows": bench_skewt,
        "mat_flows": bench_mat_flows,
        "nlngssm_flows": bench_nlngssm_flows,
        "ot_large": bench_ot_large,
        "spf_example1": bench_spf,
    }
    for name in which:
        print(f"=== {name} ===", flush=True)
        t0 = time.time()
        benches[name]()
        print(json.dumps(RESULTS[list(RESULTS)[-1]], indent=2, default=float))
        print(f"({time.time()-t0:.0f}s incl. compile)", flush=True)

    out_path = os.path.join("bench_out", "run_benchmarks.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(
            {"device": device_summary(), "card": card[0],
             "power_limit": card[1], "results": RESULTS},
            f, indent=2, default=float,
        )
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
