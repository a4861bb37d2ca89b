"""Hand-rolled LSTM for the delayed-XOR task.

Reference parity: /root/reference/lstm_with_xor_problem.py:29-47 — a
peephole-style variation where the cell state joins the input features
(`[x, h, c] @ W1`), forget-gate bias +1.0 to encourage long memory, and a
single (hidden + 1, out) readout of the final hidden state. Two PSGD
matrices: (in + 2*hidden + 1, 4*hidden) and (hidden + 1, out).

Design: the time loop is `lax.scan` over a (T, batch, in) tensor — one
compiled fused cell instead of the reference's Python-unrolled graph — and
the four gates come from one (batch, 4*hidden) matmul.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def layer_shapes(dim_in: int = 2, dim_hidden: int = 30, dim_out: int = 1):
    return [
        (dim_in + 2 * dim_hidden + 1, 4 * dim_hidden),
        (dim_hidden + 1, dim_out),
    ]


def init(key: jax.Array, dim_in: int = 2, dim_hidden: int = 30, dim_out: int = 1, dtype=jnp.float32):
    """W ~ 0.1 * N(0, 1) (ref :29-30)."""
    shapes = layer_shapes(dim_in, dim_hidden, dim_out)
    keys = jax.random.split(key, len(shapes))
    return [0.1 * jax.random.normal(k, s, dtype) for k, s in zip(keys, shapes)]


def apply(params, x: jax.Array) -> jax.Array:
    """x: (batch, T, dim_in) -> logits (batch, dim_out)."""
    w1, w2 = params
    dim_hidden = w2.shape[0] - 1
    batch = x.shape[0]
    h0 = jnp.zeros((batch, dim_hidden), x.dtype)
    c0 = jnp.zeros((batch, dim_hidden), x.dtype)

    def cell(carry, xt):
        h, c = carry
        ifgo = jnp.concatenate([xt, h, c], axis=1) @ w1[:-1] + w1[-1]
        i = jax.nn.sigmoid(ifgo[:, :dim_hidden])
        f = jax.nn.sigmoid(ifgo[:, dim_hidden : 2 * dim_hidden] + 1.0)  # ref :38
        g = jnp.tanh(ifgo[:, 2 * dim_hidden : 3 * dim_hidden])
        o = jax.nn.sigmoid(ifgo[:, 3 * dim_hidden :])
        c = f * c + i * g
        h = o * jnp.tanh(c)
        return (h, c), None

    (h, _), _ = lax.scan(cell, (h0, c0), jnp.swapaxes(x, 0, 1))
    return h @ w2[:-1] + w2[-1]


def loss(params, x: jax.Array, y: jax.Array) -> jax.Array:
    """Logistic loss -mean log sigmoid(y * logit), y in {-1, +1} (ref :46-47)."""
    from psgd_tf_tpu.data.xor import logistic_loss

    return logistic_loss(apply(params, x), y)
