#!/usr/bin/env python
"""Learning SSM parameters by gradient descent THROUGH the particle filter.

The point of differentiable resampling: the filter's tracking loss is
differentiable w.r.t. model parameters, so unknown dynamics can be learned
end-to-end (this is what the reference's TF DPF modules enable; here it is
plain ``jax.grad`` + a simple SGD loop).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import jax
import jax.numpy as jnp

from particle_filters_jax.models import DifferentiableParticleFilter

TRUE_A, SQ, SR = 0.85, 0.3, 0.4
B, T, N = 8, 30, 64

key = jax.random.PRNGKey(0)
# simulate training data with the TRUE parameter
x = jnp.zeros((B, 1))
xs, ys = [], []
for t in range(T):
    k1, k2 = jax.random.split(jax.random.fold_in(key, t))
    x = TRUE_A * x + SQ * jax.random.normal(k1, x.shape)
    xs.append(x)
    ys.append(x + SR * jax.random.normal(k2, x.shape))
X = jnp.stack(xs, 1)
Y = jnp.stack(ys, 1)
truth = jnp.concatenate([jnp.zeros((B, 1, 1)), X], 1)


def transition(k, p, params):
    return params["a"] * p + SQ * jax.random.normal(k, p.shape, p.dtype)


def loglik(p, y, params):
    return jnp.sum(-0.5 * (y[:, None, :] - p) ** 2 / SR**2, axis=-1)


dpf = DifferentiableParticleFilter(N, 1, transition, loglik,
                                   soft_alpha=0.2, gumbel_temperature=0.5)


def loss_fn(a, k):
    ps, lws = dpf.filter(k, Y, jnp.zeros(1), jnp.eye(1), params={"a": a})
    w = jax.nn.softmax(lws, axis=-1)
    means = jnp.einsum("btn,btnd->btd", w, ps)
    return jnp.mean((means[:, 1:] - truth[:, 1:]) ** 2)


grad_fn = jax.jit(jax.value_and_grad(loss_fn))
a = jnp.asarray(0.3)  # bad initial guess
print(f"true a = {TRUE_A}, initial guess a = {float(a)}")
for step in range(60):
    k = jax.random.fold_in(key, 1000 + step)
    loss, g = grad_fn(a, k)
    a = a - 0.25 * g
    if step % 10 == 0:
        print(f"  step {step:3d}: loss {float(loss):.4f}  a = {float(a):.4f}")
print(f"learned a = {float(a):.4f}  (true {TRUE_A})")
assert abs(float(a) - TRUE_A) < 0.15, "training did not converge"
