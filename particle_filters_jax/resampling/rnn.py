"""Learned (RNN) differentiable resampling.

Parity with reference ``models/DPF_RNN_resampling.py``: an LSTM/GRU scans the
particle set — per-ancestor features = weights ⊕ states ⊕ one-hot target
index (:169-215) — and a Dense head maps the final hidden state to per-new-
particle assignment logits over ancestors (:121-125, :263-360); softmax with
temperature → barycentric projection; near-zero output-layer init for
uniform initial assignments (:127-162); ``use_baseline_resampling`` mode
(weight-proportional soft assignment + small Gumbel noise, :217-261).

Design: the cells are hand-rolled pure-jnp GRU/LSTM (parameters
are an explicit pytree — trainable under ``jax.grad``/optax); the reference's
O(N) outer Python loop over new particles is a ``vmap`` and its manual O(N)
cell unroll is a ``lax.scan`` over the ancestor axis.
"""

from __future__ import annotations

import math
from typing import Dict

import jax
import jax.numpy as jnp
from jax import lax

from particle_filters_jax.resampling.soft import (
    log_normalize_lastaxis,
    sample_gumbel,
)


def _glorot(key, shape, dtype=jnp.float32):
    fan_in, fan_out = shape[0], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, minval=-lim, maxval=lim)


def gru_cell_init(key, input_dim: int, hidden_dim: int) -> Dict[str, jax.Array]:
    ks = jax.random.split(key, 6)
    return {
        "Wz": _glorot(ks[0], (input_dim, hidden_dim)),
        "Uz": _glorot(ks[1], (hidden_dim, hidden_dim)),
        "bz": jnp.zeros((hidden_dim,)),
        "Wr": _glorot(ks[2], (input_dim, hidden_dim)),
        "Ur": _glorot(ks[3], (hidden_dim, hidden_dim)),
        "br": jnp.zeros((hidden_dim,)),
        "Wh": _glorot(ks[4], (input_dim, hidden_dim)),
        "Uh": _glorot(ks[5], (hidden_dim, hidden_dim)),
        "bh": jnp.zeros((hidden_dim,)),
    }


def gru_cell_apply(p, x, h):
    z = jax.nn.sigmoid(x @ p["Wz"] + h @ p["Uz"] + p["bz"])
    r = jax.nn.sigmoid(x @ p["Wr"] + h @ p["Ur"] + p["br"])
    h_tilde = jnp.tanh(x @ p["Wh"] + (r * h) @ p["Uh"] + p["bh"])
    h_new = (1.0 - z) * h + z * h_tilde
    return h_new, h_new


def lstm_cell_init(key, input_dim: int, hidden_dim: int) -> Dict[str, jax.Array]:
    ks = jax.random.split(key, 2)
    return {
        "W": _glorot(ks[0], (input_dim, 4 * hidden_dim)),
        "U": _glorot(ks[1], (hidden_dim, 4 * hidden_dim)),
        # Forget-gate bias 1.0 (standard practice; keras default).
        "b": jnp.concatenate(
            [
                jnp.zeros((hidden_dim,)),
                jnp.ones((hidden_dim,)),
                jnp.zeros((2 * hidden_dim,)),
            ]
        ),
    }


def lstm_cell_apply(p, x, state):
    h, c = state
    gates = x @ p["W"] + h @ p["U"] + p["b"]
    i, f, g, o = jnp.split(gates, 4, axis=-1)
    c_new = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
    h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
    return (h_new, c_new), h_new


class RNNResampler:
    """Learned resampler with explicit parameter pytrees.

    ``init(key)`` returns the parameter pytree; ``apply(params, key,
    particles, log_weights)`` returns ``(new_particles, new_logw, aux)``.
    Constructor options mirror the reference module (:9-80).
    """

    def __init__(
        self,
        n_particles: int,
        state_dim: int,
        *,
        hidden_dim: int = 32,
        num_layers: int = 1,
        rnn_type: str = "gru",
        temperature: float = 1.0,
        use_weight_features: bool = True,
        use_particle_features: bool = True,
        use_baseline_resampling: bool = False,
        use_weight_prior: bool = False,
        output_init_scale: float = 0.001,
    ) -> None:
        """``use_weight_prior`` adds the normalized log-weights as a residual
        prior to the learned logits: assignment = softmax((head(h) +
        log w)/T). With the near-zero head init the fresh resampler then
        REPRODUCES the weight-proportional baseline (instead of the
        reference's near-uniform start, :127-162) and training learns
        corrections on top — this is what lets the trained resampler beat
        baseline mode (examples/09_train_rnn_resampler.py). Default off for
        reference-architecture parity."""
        if rnn_type not in ("gru", "lstm"):
            raise ValueError(f"Unknown RNN type: {rnn_type}. Use 'lstm' or 'gru'")
        self.n_particles = int(n_particles)
        self.state_dim = int(state_dim)
        self.hidden_dim = int(hidden_dim)
        self.num_layers = int(num_layers)
        self.rnn_type = rnn_type
        self.temperature = float(temperature)
        self.use_weight_features = bool(use_weight_features)
        self.use_particle_features = bool(use_particle_features)
        self.use_baseline_resampling = bool(use_baseline_resampling)
        self.use_weight_prior = bool(use_weight_prior)
        self.output_init_scale = float(output_init_scale)

        input_dim = 0
        if use_weight_features:
            input_dim += 1
        if use_particle_features:
            input_dim += self.state_dim
        if input_dim == 0:
            raise ValueError(
                "Must use at least one of weight_features or particle_features"
            )
        input_dim += self.n_particles  # one-hot target index
        self.input_dim = input_dim

    # ------------------------------ params ------------------------------

    def init(self, key: jax.Array):
        ks = jax.random.split(key, self.num_layers + 1)
        cell_init = gru_cell_init if self.rnn_type == "gru" else lstm_cell_init
        cells = []
        for layer in range(self.num_layers):
            in_dim = self.input_dim if layer == 0 else self.hidden_dim
            cells.append(cell_init(ks[layer], in_dim, self.hidden_dim))
        # Near-zero output head → near-uniform initial assignments
        # (reference ``_initialize_sensible_weights`` :127-162).
        out_kernel = self.output_init_scale * jax.random.normal(
            ks[-1], (self.hidden_dim, self.n_particles)
        )
        return {
            "cells": cells,
            "out_kernel": out_kernel,
            "out_bias": jnp.zeros((self.n_particles,)),
        }

    # ------------------------------ features ------------------------------

    def _features(self, particles, log_weights, target_idx):
        """(N, feature_dim) ancestor-sequence features for one target index
        (reference ``_compute_rnn_features`` :169)."""
        n = self.n_particles
        feats = []
        if self.use_weight_features:
            logw_n, _ = log_normalize_lastaxis(log_weights)
            feats.append(jnp.exp(logw_n)[:, None])
        if self.use_particle_features:
            feats.append(particles)
        onehot = jax.nn.one_hot(target_idx, n, dtype=particles.dtype)
        feats.append(jnp.broadcast_to(onehot[None, :], (n, n)))
        return jnp.concatenate(feats, axis=-1)

    # ------------------------------ forward ------------------------------

    def _run_cells(self, params, seq):
        """Scan a (N, input_dim) sequence through the stacked cells; return
        the final layer's last hidden state (hidden_dim,)."""
        x = seq
        for layer, cell_params in enumerate(params["cells"]):
            if self.rnn_type == "gru":
                h0 = jnp.zeros((self.hidden_dim,), x.dtype)
                _, outs = lax.scan(
                    lambda h, xt: gru_cell_apply(cell_params, xt, h), h0, x
                )
            else:
                s0 = (
                    jnp.zeros((self.hidden_dim,), x.dtype),
                    jnp.zeros((self.hidden_dim,), x.dtype),
                )
                _, outs = lax.scan(
                    lambda s, xt: lstm_cell_apply(cell_params, xt, s), s0, x
                )
            x = outs
        return x[-1]

    def _baseline_assignment(self, key, log_weights):
        """Weight-proportional soft assignment + 0.1·Gumbel (reference :217)."""
        n = self.n_particles
        logw_n, _ = log_normalize_lastaxis(log_weights)
        log_probs = jnp.log(jnp.exp(logw_n) + 1e-10) / self.temperature
        tiled = jnp.broadcast_to(log_probs[None, :], (n, n))
        g = sample_gumbel(key, (n, n), log_probs.dtype, eps=1e-10)
        return jax.nn.softmax(tiled + 0.1 * g, axis=-1)

    def apply(
        self,
        params,
        key: jax.Array,
        particles: jax.Array,
        log_weights: jax.Array,
        return_aux: bool = False,
    ):
        """Resample an (N, d) cloud → (new_particles, uniform logw[, aux])."""
        n = self.n_particles
        if self.use_baseline_resampling:
            assignment = self._baseline_assignment(key, log_weights)
        else:
            def logits_for(i):
                feats = self._features(particles, log_weights, i)
                h_final = self._run_cells(params, feats)
                return h_final @ params["out_kernel"] + params["out_bias"]

            logits = jax.vmap(logits_for)(jnp.arange(n))  # (N, N)
            if self.use_weight_prior:
                logw_n, _ = log_normalize_lastaxis(log_weights)
                prior = jnp.log(jnp.exp(logw_n) + 1e-10)
                logits = logits + prior[None, :]
            assignment = jax.nn.softmax(logits / self.temperature, axis=-1)

        new_particles = assignment @ particles
        new_logw = jnp.full(
            (n,), -jnp.log(jnp.asarray(n, log_weights.dtype)), log_weights.dtype
        )
        if not return_aux:
            return new_particles, new_logw
        entropy = -jnp.sum(assignment * jnp.log(assignment + 1e-10), axis=-1)
        aux = {
            "assignment": assignment,
            "assignment_entropy_mean": jnp.mean(entropy),
            "assignment_entropy_std": jnp.std(entropy),
        }
        return new_particles, new_logw, aux


def rnn_resample(
    resampler: RNNResampler,
    params,
    key: jax.Array,
    particles: jax.Array,
    log_weights: jax.Array,
):
    """Functional convenience wrapper around :meth:`RNNResampler.apply`."""
    return resampler.apply(params, key, particles, log_weights)
