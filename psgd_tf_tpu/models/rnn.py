"""Vanilla (simple) RNN for delayed-XOR with the LRA/UVd optimizer.

Reference parity: /root/reference/rnn_xor_UVd_preconditioner.py:28-34 — a
keras SimpleRNN(30) + Dense(1), kernels shrunk to 1/3 of glorot-uniform.
Here the same network in PSGD matrix form: W_rnn is
(dim_in + hidden + 1, hidden) with tanh, W_fc is (hidden + 1, out).

Design: `lax.scan` time loop, fused input+recurrent matmul.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def init(key: jax.Array, dim_in: int = 2, hidden: int = 30, dim_out: int = 1, dtype=jnp.float32):
    """Keras SimpleRNN defaults with the reference's 1/3 shrink (ref :33-34):
    input kernel glorot-uniform / 3, recurrent kernel ORTHOGONAL (unshrunk —
    the reference divides only `cell.kernel` and the fc kernel), biases 0.
    The orthogonal recurrence is what keeps gradient signal alive across
    the ~100-step delay; a generic scaled-normal recurrence plateaus at
    chance level on this task."""
    k1, k2, k3 = jax.random.split(key, 3)

    lim = (6.0 / (dim_in + hidden)) ** 0.5 / 3.0
    w_in = jax.random.uniform(k1, (dim_in, hidden), dtype, -lim, lim)
    # orthogonal recurrent kernel via QR of a square normal
    a = jax.random.normal(k2, (hidden, hidden), dtype)
    q, r = jnp.linalg.qr(a)
    w_rec = q * jnp.sign(jnp.diagonal(r))[None, :]
    w_rnn = jnp.concatenate(
        [w_in, w_rec, jnp.zeros((1, hidden), dtype)], axis=0
    )

    lim_fc = (6.0 / (hidden + dim_out)) ** 0.5 / 3.0
    w_fc = jnp.concatenate(
        [
            jax.random.uniform(k3, (hidden, dim_out), dtype, -lim_fc, lim_fc),
            jnp.zeros((1, dim_out), dtype),
        ],
        axis=0,
    )
    return [w_rnn, w_fc]


def apply(params, x: jax.Array) -> jax.Array:
    """x: (batch, T, dim_in) -> logits (batch, dim_out)."""
    w_rnn, w_fc = params
    hidden = w_fc.shape[0] - 1
    h0 = jnp.zeros((x.shape[0], hidden), x.dtype)

    def cell(h, xt):
        h = jnp.tanh(jnp.concatenate([xt, h], axis=1) @ w_rnn[:-1] + w_rnn[-1])
        return h, None

    h, _ = lax.scan(cell, h0, jnp.swapaxes(x, 0, 1))
    return h @ w_fc[:-1] + w_fc[-1]


def loss(params, x: jax.Array, y: jax.Array) -> jax.Array:
    """Logistic loss, y in {-1, +1} (ref :44-45)."""
    from psgd_tf_tpu.data.xor import logistic_loss

    return logistic_loss(apply(params, x), y)
