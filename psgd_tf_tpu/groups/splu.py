"""Sparse-LU preconditioner: P = Q^T Q with Q = L U.

Structure (reference parity: update_precond_splu / precond_grad_splu,
/root/reference/preconditioned_stochastic_gradient_descent.py:396-524):

  L = [L1   0      ]      U = [U1  U2        ]
      [L2   diag(l3)]         [0   diag(u3)  ]

with a dense order-r corner (L1 lower-tri, U1 upper-tri) and diagonal tails,
so the state is O(n r) for n parameters. This family resembles limited-memory
BFGS (ref README.md:33).

Layout — RANK-MAJOR: both rectangular factors are stored with the
parameter axis contiguous, `Lt = L12^T: (r, n)` (the reference keeps
(n, r) columns, ref :398-405) and `U12: (r, n)`. Blocks:
L1 = Lt[:, :r]^T (r x r lower-tri), L2^T = Lt[:, r:], U1 = U12[:, :r],
U2 = U12[:, r:]; l3 and u3 are (n - r,) vectors.

Per update: 4 triangular solves on the r x r corner + tail streaming. The
block algebra below computes Q dg, Q^{-T} dx, P dg and P^{-1} dx without
ever forming n x n matrices.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from psgd_tf_tpu import struct
from psgd_tf_tpu.ops import linalg


@struct.dataclass
class SpLUState:
    Lt: jax.Array   # (r, n) = L12^T: [:, :r] = L1^T, [:, r:] = L2^T
    l3: jax.Array   # (n - r,)
    U12: jax.Array  # (r, n): [U1 (r x r upper-tri), U2 (r x (n-r))]
    u3: jax.Array   # (n - r,)

    @property
    def rank(self) -> int:
        return self.U12.shape[0]

    @property
    def L12(self) -> jax.Array:
        """(n, r) column layout view (tests/diagnostics; ref layout)."""
        return self.Lt.T


def init(n: int, rank: int = 10, init_scale: float = 1.0, dtype=jnp.float32):
    r = min(rank, n)
    s = init_scale
    return SpLUState(
        Lt=jnp.concatenate(
            [s * jnp.eye(r, dtype=dtype), jnp.zeros((r, n - r), dtype=dtype)], axis=1
        ),
        l3=s * jnp.ones((n - r,), dtype=dtype),
        U12=jnp.concatenate(
            [s * jnp.eye(r, dtype=dtype), jnp.zeros((r, n - r), dtype=dtype)], axis=1
        ),
        u3=s * jnp.ones((n - r,), dtype=dtype),
    )


def _blocks(state: SpLUState):
    """(L1, L2t, U1, U2): L1 (r, r) lower-tri, L2t = L2^T (r, n-r)."""
    r = state.rank
    return (
        state.Lt[:, :r].T,
        state.Lt[:, r:],
        state.U12[:, :r],
        state.U12[:, r:],
    )


def _max0(x: jax.Array) -> jax.Array:
    """max(x) that returns -inf-safe 0-size handling (rank >= n edge)."""
    return jnp.max(x, initial=-jnp.inf)


def _max_abs0(x: jax.Array) -> jax.Array:
    """max|x| that returns 0 on empty arrays (rank >= n degenerate case).

    Safe as a step normalizer because it is always max'd with the non-empty
    corner gradient's max-abs before use."""
    return jnp.max(jnp.abs(x), initial=0.0)


def update(
    state: SpLUState,
    v: jax.Array,
    h: jax.Array,
    step: jax.Array | float = 0.01,
    key: jax.Array | None = None,
) -> SpLUState:
    del key
    dtype = state.Lt.dtype
    r = state.rank

    # dynamic-range balancing of L vs U (ref :411-417). The tails l3/u3 are
    # empty when rank >= n (Q degenerates to a full LU); reductions must be
    # empty-safe.
    Lt, l3, U12, u3 = state.Lt, state.l3, state.U12, state.u3
    max_l = jnp.maximum(jnp.max(jnp.diagonal(Lt[:, :r])), _max0(l3))
    max_u = jnp.maximum(jnp.max(jnp.diagonal(U12[:, :r])), _max0(u3))
    rho = jnp.sqrt(max_l / max_u)
    Lt, l3, U12, u3 = Lt / rho, l3 / rho, rho * U12, rho * u3

    L1, L2t, U1, U2 = Lt[:, :r].T, Lt[:, r:], U12[:, :r], U12[:, r:]
    dx1, dx2 = v[:r], v[r:]
    dg1, dg2 = h[:r], h[r:]

    # Q dg (ref :430-434)
    Ug1 = U1 @ dg1 + U2 @ dg2
    Ug2 = u3 * dg2
    Qg1 = L1 @ Ug1
    Qg2 = Ug1 @ L2t + l3 * Ug2
    # Q^{-T} dx (ref :436-440)
    iUtx1 = linalg.solve_ut_t(U1, dx1)
    iUtx2 = (dx2 - iUtx1 @ U2) / u3
    iQtx2 = iUtx2 / l3
    iQtx1 = linalg.solve_lt_t(L1, iUtx1 - L2t @ iQtx2)
    # P dg (ref :442-446)
    LtQg1 = L1.T @ Qg1 + L2t @ Qg2
    LtQg2 = l3 * Qg2
    Pg1 = U1.T @ LtQg1
    Pg2 = LtQg1 @ U2 + u3 * LtQg2
    # P^{-1} dx (ref :448-452)
    iLiQtx1 = linalg.solve_lt(L1, iQtx1)
    iLiQtx2 = (iQtx2 - iLiQtx1 @ L2t) / l3
    iPx2 = iLiQtx2 / u3
    iPx1 = linalg.solve_ut(U1, iLiQtx1 - U2 @ iPx2)

    s = jnp.asarray(step, dtype)

    # update L (ref :455-465)
    gl1 = linalg.tril(jnp.outer(Qg1, Qg1) - jnp.outer(iQtx1, iQtx1))
    gl3 = Qg2 * Qg2 - iQtx2 * iQtx2
    # max|gl2| without materializing the (n-r, r) outer difference
    gl2_max = _max_abs0(
        jnp.outer(Qg1, Qg2) - jnp.outer(iQtx1, iQtx2)
    )
    mx = jnp.maximum(
        linalg.max_abs(gl1), jnp.maximum(gl2_max, _max_abs0(gl3))
    )
    step_l = linalg.step_scale(s, mx, dtype)
    newL1 = L1 - step_l * (gl1 @ L1)
    # (gl2 @ L1)^T = outer(L1^T Qg1, Qg2) - outer(L1^T iQtx1, iQtx2), rank-2
    c1, c2 = L1.T @ Qg1, L1.T @ iQtx1
    newL2t = (
        L2t
        - step_l * (jnp.outer(c1, Qg2) - jnp.outer(c2, iQtx2))
        - step_l * gl3[None, :] * L2t
    )
    newl3 = l3 - step_l * gl3 * l3

    # update U (ref :468-478)
    gu1 = linalg.triu(jnp.outer(Pg1, dg1) - jnp.outer(dx1, iPx1))
    gu3 = Pg2 * dg2 - dx2 * iPx2
    gu2_max = _max_abs0(jnp.outer(Pg1, dg2) - jnp.outer(dx1, iPx2))
    mx = jnp.maximum(
        linalg.max_abs(gu1), jnp.maximum(gu2_max, _max_abs0(gu3))
    )
    step_u = linalg.step_scale(s, mx, dtype)
    newU1 = U1 - step_u * (U1 @ gu1)
    # U1 @ gu2 = outer(U1 Pg1, dg2) - outer(U1 dx1, iPx2), rank-2
    d1, d2 = U1 @ Pg1, U1 @ dx1
    newU2 = (
        U2
        - step_u * (jnp.outer(d1, dg2) - jnp.outer(d2, iPx2))
        - step_u * gu3[None, :] * U2
    )
    newu3 = u3 - step_u * gu3 * u3

    return SpLUState(
        Lt=jnp.concatenate([newL1.T, newL2t], axis=1),
        l3=newl3,
        U12=jnp.concatenate([newU1, newU2], axis=1),
        u3=newu3,
    )


def apply(state: SpLUState, g: jax.Array) -> jax.Array:
    """P g via the block matvec chain U -> L -> L^T -> U^T (ref :506-516)."""
    r = state.rank
    L1, L2t, U1, U2 = _blocks(state)
    l3, u3 = state.l3, state.u3
    g1, g2 = g[:r], g[r:]

    Ug1 = U1 @ g1 + U2 @ g2
    Ug2 = u3 * g2
    Qg1 = L1 @ Ug1
    Qg2 = Ug1 @ L2t + l3 * Ug2
    LtQg1 = L1.T @ Qg1 + L2t @ Qg2
    LtQg2 = l3 * Qg2
    return jnp.concatenate([U1.T @ LtQg1, LtQg1 @ U2 + u3 * LtQg2])


def materialize(state: SpLUState) -> jax.Array:
    """Dense P = (L U)^T (L U), for tests only."""
    r = state.rank
    L1, L2t, U1, U2 = _blocks(state)
    n = state.Lt.shape[1]
    L = jnp.zeros((n, n), state.Lt.dtype)
    L = L.at[:r, :r].set(L1).at[r:, :r].set(L2t.T).at[r:, r:].set(jnp.diag(state.l3))
    U = jnp.zeros((n, n), state.U12.dtype)
    U = U.at[:r, :r].set(U1).at[:r, r:].set(U2).at[r:, r:].set(jnp.diag(state.u3))
    q = L @ U
    return q.T @ q
