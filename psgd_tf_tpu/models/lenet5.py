"""LeNet5 CNN in PSGD matrix layout.

Reference parity: /root/reference/mnist_with_lenet5.py:12-33 — five weight
matrices of shape (fan_in + 1, fan_out) with the bias as the last row; conv
kernels reshape from the (H*W*Cin, Cout) rows. Architecture: conv5x5(6) →
maxpool2 → relu → conv5x5(16) → maxpool2 → relu → fc120 → fc84 → fc10, all
VALID padding, so 28x28 input yields a 4*4*16 flatten.

Notes: NHWC layout with `lax.conv_general_dilated`. Maxpool is a reshape
into 2x2 blocks + two `jnp.max` reductions rather than
`lax.reduce_window`: identical values for even dims / stride-2 VALID
windows, but every derivative is a select / elementwise op, whereas
reduce_window differentiates through select-and-scatter inside the
exact-Hvp (jvp-of-grad) graph. The forward is shard-agnostic — batch-shard
under pjit for data parallelism.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

LAYER_SHAPES = [
    (5 * 5 * 1 + 1, 6),
    (5 * 5 * 6 + 1, 16),
    (4 * 4 * 16 + 1, 120),
    (120 + 1, 84),
    (84 + 1, 10),
]


def init(key: jax.Array, dtype=jnp.float32):
    """W ~ 0.1 * N(0, 1), matching ref :12-16."""
    keys = jax.random.split(key, len(LAYER_SHAPES))
    return [
        0.1 * jax.random.normal(k, shape, dtype)
        for k, shape in zip(keys, LAYER_SHAPES)
    ]


def _conv(x: jax.Array, w: jax.Array, hw: int, cin: int, cout: int) -> jax.Array:
    kernel = w[:-1].reshape(hw, hw, cin, cout)
    y = lax.conv_general_dilated(
        x, kernel, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + w[-1]


def _maxpool2(x: jax.Array) -> jax.Array:
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return jnp.max(jnp.max(x, axis=4), axis=2)


def apply(params, x: jax.Array) -> jax.Array:
    """x: (batch, 28, 28, 1) -> logits (batch, 10)."""
    w1, w2, w3, w4, w5 = params
    x = jax.nn.relu(_maxpool2(_conv(x, w1, 5, 1, 6)))
    x = jax.nn.relu(_maxpool2(_conv(x, w2, 5, 6, 16)))
    x = x.reshape(x.shape[0], 4 * 4 * 16)
    x = jax.nn.relu(x @ w3[:-1] + w3[-1])
    x = jax.nn.relu(x @ w4[:-1] + w4[-1])
    return x @ w5[:-1] + w5[-1]


def loss(params, x: jax.Array, labels: jax.Array) -> jax.Array:
    """Mean softmax cross-entropy (ref :35-38)."""
    logits = apply(params, x)
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))


def error_rate(params, x: jax.Array, labels: jax.Array) -> jax.Array:
    """Classification error fraction (ref :74)."""
    return jnp.mean(jnp.argmax(apply(params, x), axis=1) != labels)
