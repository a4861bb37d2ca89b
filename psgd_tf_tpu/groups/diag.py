"""Diagonal / Jacobi preconditioner: Q = diag(q).

The reference repo *documents* this family ("Subgroup {e} induces the
diagonal/Jacobi preconditioner ... closed-form solution is available",
/root/reference/README.md:13,35) but ships no code for it; we implement it
from the math. PSGD with diagonal Q reduces exactly to equilibrated
SGD / AdaHessian-style equilibration.

Lie-group step (the diagonal specialization of the dense rule):
  a = q * h,  b = v / q
  grad = a*a - b*b                      (diagonal of a a^T - b b^T)
  q <- q - (step / (max|grad| + tiny)) * grad * q

Closed-form fit (available because the group is abelian): the criterion
E[(q h)^2 + (v/q)^2] is minimized elementwise by q* = (v^2 / h^2)^(1/4);
`closed_form_update` moves q toward q* by a multiplicative interpolation,
which is unconditionally stable.

All ops are pure elementwise work — O(n) state and compute, the
cheapest family and the usual large-model default.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from psgd_tf_tpu import struct
from psgd_tf_tpu.ops import linalg


@struct.dataclass
class DiagState:
    q: jax.Array  # (n,) positive


def init(n: int, init_scale: float = 1.0, dtype=jnp.float32) -> DiagState:
    return DiagState(q=jnp.full((n,), init_scale, dtype=dtype))


def update(
    state: DiagState,
    v: jax.Array,
    h: jax.Array,
    step: jax.Array | float = 0.01,
    key: jax.Array | None = None,
) -> DiagState:
    del key
    q = state.q
    a = q * h
    b = v / q
    grad = a * a - b * b
    step0 = linalg.step_scale(step, linalg.max_abs(grad), q.dtype)
    return DiagState(q=q - step0 * grad * q)


def closed_form_update(
    state: DiagState,
    v: jax.Array,
    h: jax.Array,
    step: jax.Array | float = 0.01,
    key: jax.Array | None = None,
) -> DiagState:
    """Multiplicative interpolation toward the exact minimizer q*."""
    del key
    q = state.q
    dtype = q.dtype
    t = linalg.tiny(dtype)
    q_star = jnp.sqrt((jnp.abs(v) + t) / (jnp.abs(h) + t))
    s = jnp.asarray(step, dtype)
    return DiagState(q=q * (q_star / q) ** s)


def apply(state: DiagState, g: jax.Array) -> jax.Array:
    return state.q * state.q * g


def materialize(state: DiagState) -> jax.Array:
    return jnp.diag(state.q * state.q)
