"""Rank-R CP tensor decomposition with L1 sparsity penalty.

Reference parity: /root/reference/demo_usage_of_all_preconditioners.py:7-21 —
fit a uniform[0,1) (I, J, K) tensor T with sum_r x_r ⊗ y_r ⊗ z_r, loss =
sum((T - fit)^2) + 1e-3 * sum|factors|, factors initialized N(0, 1). The
workload every preconditioner family runs on (dense / sparse-LU / kron /
diag / xmat / lra).

Design: the triple outer product contracts via one einsum (a matmul),
not three chained expand_dims multiplies.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def make_target(key: jax.Array, shape=(10, 20, 50), dtype=jnp.float32) -> jax.Array:
    """Uniform [0, 1) target (ref :8)."""
    return jax.random.uniform(key, shape, dtype)


def init(key: jax.Array, shape=(10, 20, 50), rank: int = 5, dtype=jnp.float32):
    """x, y, z factor matrices ~ N(0, 1) (ref :10-12)."""
    kx, ky, kz = jax.random.split(key, 3)
    i, j, k = shape
    return {
        "x": jax.random.normal(kx, (rank, i), dtype),
        "y": jax.random.normal(ky, (rank, j), dtype),
        "z": jax.random.normal(kz, (rank, k), dtype),
    }


def loss(params, target: jax.Array, l1: float = 1e-3) -> jax.Array:
    fit = jnp.einsum("ri,rj,rk->ijk", params["x"], params["y"], params["z"])
    err = jnp.sum((target - fit) ** 2)
    pen = sum(jnp.sum(jnp.abs(p)) for p in params.values())
    return err + l1 * pen
