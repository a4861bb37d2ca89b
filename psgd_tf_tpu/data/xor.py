"""Delayed-XOR sequence task (reference parity:
/root/reference/lstm_with_xor_problem.py:11-27).

Each sequence of length T has 2 input channels: channel 0 is a random ±1
stream; channel 1 is zero except at two marker positions (the first in the
first 10% of the sequence, the second in the 10%-50% window), where it is 1.
The label is -1 if the ±1 values at the two marked positions agree, else +1
— the XOR — solvable only by carrying information across O(T) steps, the
classic long-memory stress test (ref README.md:46).

Design: the generator is a pure jittable function of a PRNG key
producing the whole batch at once in (batch, T, 2) layout (the reference
builds (T, batch, 2) with Python loops over numpy, ref :17-27, because its
model scans with a Python `for`); marker positions are sampled with
`jax.random.randint` and scattered with one-hot masks so shapes stay static.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def batch(
    key: jax.Array,
    batch_size: int = 128,
    seq_len: int = 100,
    dtype=jnp.float32,
) -> tuple[jax.Array, jax.Array]:
    """Returns (x, y): x is (batch, T, 2); y is (batch, 1) in {-1, +1}."""
    k_bits, k_i, k_j = jax.random.split(key, 3)
    bits = jnp.where(
        jax.random.bernoulli(k_bits, 0.5, (batch_size, seq_len)), 1.0, -1.0
    ).astype(dtype)
    # marker 1 in [0, T/10); marker 2 in [T/10, T/2)  (ref :18-19)
    i = jax.random.randint(k_i, (batch_size,), 0, seq_len // 10)
    j = jax.random.randint(k_j, (batch_size,), seq_len // 10, seq_len // 2)
    pos = jnp.arange(seq_len)[None, :]
    marks = (
        (pos == i[:, None]).astype(dtype) + (pos == j[:, None]).astype(dtype)
    )
    x = jnp.stack([bits, marks], axis=-1)

    bit_i = jnp.take_along_axis(bits, i[:, None], axis=1)[:, 0]
    bit_j = jnp.take_along_axis(bits, j[:, None], axis=1)[:, 0]
    # -1 when the two bits agree, +1 when they differ (ref :22-25)
    y = jnp.where(bit_i == bit_j, -1.0, 1.0).astype(dtype)[:, None]
    return x, y


def logistic_loss(logits: jax.Array, y: jax.Array) -> jax.Array:
    """-mean log sigmoid(y * logit), y in {-1, +1} (ref :46-47).

    softplus form: `log1p(exp(z))` overflows fp32 for z > ~88, poisoning
    gradients with inf/nan; softplus computes max(z, 0) + log1p(exp(-|z|)).
    Shared by the lstm/rnn XOR models."""
    return jnp.mean(jax.nn.softplus(-y * logits))
