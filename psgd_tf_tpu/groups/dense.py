"""Dense (full triangular) preconditioner: P = Q^T Q with Q upper triangular.

Math contract (reference parity: update_precond_dense / precond_grad_dense,
/root/reference/preconditioned_stochastic_gradient_descent.py:26-63):

  a = Q h,   b = Q^{-T} v
  grad = triu(a a^T - b b^T)
  Q <- Q - (step / (max|grad| + tiny)) * grad @ Q
  P g = Q^T (Q g)

With vector probes the group gradient is rank-2, so `grad @ Q` is
computed in O(n^2) via reverse cumulative sums
(`ops.linalg.triu_outer_diff_matmul`) instead of the reference's O(n^3)
dense matmul chain.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from psgd_tf_tpu import struct
from psgd_tf_tpu.ops import linalg


@struct.dataclass
class DenseState:
    Q: jax.Array  # (n, n) upper triangular


def init(n: int, init_scale: float = 1.0, dtype=jnp.float32) -> DenseState:
    """Identity-scaled init; `hello_psgd.py:8` uses 0.1 * I."""
    return DenseState(Q=init_scale * jnp.eye(n, dtype=dtype))


def update(
    state: DenseState,
    v: jax.Array,
    h: jax.Array,
    step: jax.Array | float = 0.01,
    key: jax.Array | None = None,
) -> DenseState:
    """One Lie-group step fitting Q to the curvature pair (v, h) in
    O(n^2) (rank-2 cumsum formulation)."""
    del key  # deterministic family
    q = state.Q
    a = q @ h
    b = linalg.solve_ut_t(q, v)
    step0 = linalg.step_scale(step, linalg.triu_outer_diff_maxabs(a, b), q.dtype)
    grad_q = linalg.triu_outer_diff_matmul(a, b, q)
    return DenseState(Q=q - step0 * grad_q)


def apply(state: DenseState, g: jax.Array) -> jax.Array:
    """P g = Q^T (Q g) — two triangular matvecs (ref :55)."""
    q = state.Q
    return q.T @ (q @ g)


def materialize(state: DenseState) -> jax.Array:
    """Dense P = Q^T Q, for tests/diagnostics only."""
    return state.Q.T @ state.Q
