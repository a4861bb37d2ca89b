"""Kronecker-factored preconditioner for matrix parameters.

P = (Qr^T Qr) ⊗ (Ql^T Ql) acting on an (m, n) gradient as
Ql^T Ql @ G @ Qr^T Qr. Each side is one of three formats:

  dense : (d, d) upper-triangular Cholesky factor   — feature whitening
  norm  : (2, d) "arrow" factor; row 0 = diag(Q), row 1 = last column of Q
          (excluding its last entry)                — batch-norm-like
  scale : (d,)  diagonal factor                     — output scaling

Reference parity: update_precond_kron / precond_grad_kron and the six
_update/_precond_grad_{dense,norm,scale} pair kernels,
/root/reference/preconditioned_stochastic_gradient_descent.py:67-391.

Design change: the reference dispatches on *runtime* tensor shapes
inside a tf.function with [None, None] signatures (ref :80-110) — ambiguous
at d = 2 (ref README.md:39) and untraceable under jax.jit. Here the format
pair is a *static* tag carried in the state pytree's aux data, so dispatch
happens at trace time, each (shape, format) pair compiles once, and the
d = 2 ambiguity cannot arise. Mirror cases ((dense,norm), (scale,dense),
(scale,norm)) are served by transposing to the implemented sibling, same as
the reference (ref :86, :102, :104, :128, :144, :146).

Supported pairs: (dense,dense), (norm,dense), (dense,norm), (dense,scale),
(scale,dense), (norm,scale), (scale,norm) — exactly the reference's set.
(norm,norm) and (scale,scale) are rejected at init, matching the
reference's "Unknown Kronecker product preconditioner" refusal (ref :90).
"""
from __future__ import annotations

from typing import Literal, Sequence

import jax
import jax.numpy as jnp

from psgd_tf_tpu import struct
from psgd_tf_tpu.ops import linalg

Format = Literal["dense", "norm", "scale"]

_SUPPORTED = {
    ("dense", "dense"),
    ("norm", "dense"), ("dense", "norm"),
    ("dense", "scale"), ("scale", "dense"),
    ("norm", "scale"), ("scale", "norm"),
}


@struct.dataclass
class KronState:
    ql: jax.Array
    qr: jax.Array
    fmt: tuple[Format, Format] = struct.field(static=True, default=("dense", "dense"))


def _factor_init(fmt: Format, d: int, scale: float, dtype) -> jax.Array:
    """Typical initial guesses, ref README.md:48."""
    if fmt == "dense":
        return scale * jnp.eye(d, dtype=dtype)
    if fmt == "norm":
        return jnp.stack([scale * jnp.ones((d,), dtype), jnp.zeros((d,), dtype)])
    if fmt == "scale":
        return scale * jnp.ones((d,), dtype=dtype)
    raise ValueError(f"unknown kron factor format: {fmt!r}")


def auto_format(shape: tuple[int, int], dense_max: int = 1024) -> tuple[Format, Format]:
    """Pick formats per the reference's own capacity guidance (README.md:54):
    dense up to ~1e3 per side, else norm on the left / scale on the right."""
    m, n = shape
    return (
        "dense" if m <= dense_max else "norm",
        "dense" if n <= dense_max else "scale",
    )


def init(
    shape: tuple[int, int],
    fmt: tuple[Format, Format] | Literal["auto"] = "auto",
    init_scale: float = 1.0,
    dtype=jnp.float32,
) -> KronState:
    m, n = shape
    if fmt == "auto":
        fmt = auto_format(shape)
    fmt = (fmt[0], fmt[1])
    if fmt not in _SUPPORTED:
        raise ValueError(f"unsupported Kronecker format pair: {fmt}")
    return KronState(
        ql=_factor_init(fmt[0], m, init_scale, dtype),
        qr=_factor_init(fmt[1], n, init_scale, dtype),
        fmt=fmt,
    )


# ---------------------------------------------------------------------------
# (dense, dense)  — ref :156-192
# ---------------------------------------------------------------------------

def _update_dd(Ql, Qr, dX, dG, step, t):
    # dynamic-range balancing (ref :166-170)
    rho = jnp.sqrt(jnp.max(jnp.diagonal(Ql)) / jnp.max(jnp.diagonal(Qr)))
    Ql, Qr = Ql / rho, rho * Qr

    A = Ql @ (dG @ Qr.T)
    # Bt = Ql^{-T} dX Qr^{-1} via two triangular solves (ref :174)
    Bt = linalg.solve_ut_t(Ql, linalg.solve_ut_t(Qr, dX.T).T)
    grad1 = linalg.triu(A @ A.T - Bt @ Bt.T)
    grad2 = linalg.triu(A.T @ A - Bt.T @ Bt)
    step1 = linalg.step_scale(step, linalg.max_abs(grad1), Ql.dtype)
    step2 = linalg.step_scale(step, linalg.max_abs(grad2), Qr.dtype)
    return Ql - step1 * (grad1 @ Ql), Qr - step2 * (grad2 @ Qr)


def _apply_dd(Ql, Qr, G):
    # multiplication order chosen by static shape to minimize FLOPs (ref :189-192)
    if G.shape[0] < G.shape[1]:
        return ((Ql.T @ Ql) @ G) @ (Qr.T @ Qr)
    return Ql.T @ (Ql @ (G @ (Qr.T @ Qr)))


# ---------------------------------------------------------------------------
# (norm, dense)  — ref :198-270
# ---------------------------------------------------------------------------
# The norm factor is the "arrow" matrix Ql = diag(ql0) with last column
# [ql1[:-1]; ql0[-1]]; its inverse has closed form (ref :222-229).

def _norm_matmul(ql, X):
    """Ql @ X for the arrow factor: diag mult + rank-1 last-row pull (ref :218-219)."""
    return ql[0][:, None] * X + jnp.outer(ql[1], X[-1])


def _norm_t_matmul(ql, X):
    """Ql^T @ X: diag mult + correction added to the last row (ref :265-268)."""
    add_last = ql[1] @ X
    out = ql[0][:, None] * X
    return out.at[-1].add(add_last)


def _norm_inv_t_matmul(ql, X):
    """Ql^{-T} @ X using the closed-form arrow inverse (ref :230-232)."""
    Bt = X / ql[0][:, None]
    last = Bt[-1] - (ql[1] / (ql[0] * ql[0][-1])) @ X
    return Bt.at[-1].set(last)


def _update_nd(ql, Qr, dX, dG, step, t):
    rho = jnp.sqrt(jnp.max(ql[0]) / jnp.max(jnp.diagonal(Qr)))
    ql, Qr = ql / rho, rho * Qr

    A = _norm_matmul(ql, dG) @ Qr.T
    Bt = linalg.solve_ut_t(Qr, _norm_inv_t_matmul(ql, dX).T).T  # Ql^{-T} dX Qr^{-1}

    grad1_diag = jnp.sum(A * A, axis=1) - jnp.sum(Bt * Bt, axis=1)
    grad1_bias = A[:-1] @ A[-1] - Bt[:-1] @ Bt[-1]
    grad1_bias = jnp.concatenate([grad1_bias, jnp.zeros((1,), A.dtype)])

    step1 = linalg.step_scale(
        step, jnp.maximum(linalg.max_abs(grad1_diag), linalg.max_abs(grad1_bias)),
        A.dtype,
    )
    new_ql0 = ql[0] - step1 * grad1_diag * ql[0]
    new_ql1 = ql[1] - step1 * (grad1_diag * ql[1] + ql[0, -1] * grad1_bias)

    grad2 = linalg.triu(A.T @ A - Bt.T @ Bt)
    step2 = linalg.step_scale(step, linalg.max_abs(grad2), A.dtype)
    return jnp.stack([new_ql0, new_ql1]), Qr - step2 * (grad2 @ Qr)


def _apply_nd(ql, Qr, G):
    preG = _norm_matmul(ql, G)
    if preG.shape[0] < preG.shape[1]:
        preG = (preG @ Qr.T) @ Qr
    else:
        preG = preG @ (Qr.T @ Qr)
    return _norm_t_matmul(ql, preG)


# ---------------------------------------------------------------------------
# (dense, scale)  — ref :276-322
# ---------------------------------------------------------------------------

def _update_ds(Ql, qr, dX, dG, step, t):
    rho = jnp.sqrt(jnp.max(jnp.diagonal(Ql)) / jnp.max(qr))
    Ql, qr = Ql / rho, rho * qr

    A = (Ql @ dG) * qr[None, :]
    Bt = linalg.solve_ut_t(Ql, dX) / qr[None, :]

    grad1 = linalg.triu(A @ A.T - Bt @ Bt.T)
    step1 = linalg.step_scale(step, linalg.max_abs(grad1), A.dtype)
    grad2 = jnp.sum(A * A, axis=0) - jnp.sum(Bt * Bt, axis=0)
    step2 = linalg.step_scale(step, linalg.max_abs(grad2), A.dtype)
    return Ql - step1 * (grad1 @ Ql), qr - step2 * grad2 * qr


def _apply_ds(Ql, qr, G):
    if G.shape[0] < G.shape[1]:
        preG = (Ql.T @ Ql) @ G
    else:
        preG = Ql.T @ (Ql @ G)
    return preG * (qr * qr)[None, :]


# ---------------------------------------------------------------------------
# (norm, scale)  — ref :328-391, the O(m + n) sparsest pair
# ---------------------------------------------------------------------------

def _update_ns(ql, qr, dX, dG, step, t):
    rho = jnp.sqrt(jnp.max(ql[0]) / jnp.max(qr))
    ql, qr = ql / rho, rho * qr

    A = _norm_matmul(ql, dG) * qr[None, :]
    Bt = _norm_inv_t_matmul(ql, dX) / qr[None, :]

    grad1_diag = jnp.sum(A * A, axis=1) - jnp.sum(Bt * Bt, axis=1)
    grad1_bias = A[:-1] @ A[-1] - Bt[:-1] @ Bt[-1]
    grad1_bias = jnp.concatenate([grad1_bias, jnp.zeros((1,), A.dtype)])

    step1 = linalg.step_scale(
        step, jnp.maximum(linalg.max_abs(grad1_diag), linalg.max_abs(grad1_bias)),
        A.dtype,
    )
    new_ql0 = ql[0] - step1 * grad1_diag * ql[0]
    new_ql1 = ql[1] - step1 * (grad1_diag * ql[1] + ql[0, -1] * grad1_bias)

    grad2 = jnp.sum(A * A, axis=0) - jnp.sum(Bt * Bt, axis=0)
    step2 = linalg.step_scale(step, linalg.max_abs(grad2), A.dtype)
    return jnp.stack([new_ql0, new_ql1]), qr - step2 * grad2 * qr


def _apply_ns(ql, qr, G):
    preG = _norm_matmul(ql, G) * (qr * qr)[None, :]
    return _norm_t_matmul(ql, preG)


# ---------------------------------------------------------------------------
# static dispatch (replaces ref :80-110 runtime shape sniffing)
# ---------------------------------------------------------------------------

def update(
    state: KronState,
    dX: jax.Array,
    dG: jax.Array,
    step: jax.Array | float = 0.01,
    key: jax.Array | None = None,
) -> KronState:
    del key
    ql, qr, fmt = state.ql, state.qr, state.fmt
    t = linalg.tiny(jnp.result_type(ql))
    s = jnp.asarray(step, jnp.result_type(ql))

    if fmt == ("dense", "dense"):
        ql, qr = _update_dd(ql, qr, dX, dG, s, t)
    elif fmt == ("norm", "dense"):
        ql, qr = _update_nd(ql, qr, dX, dG, s, t)
    elif fmt == ("dense", "norm"):      # mirror of (norm, dense), ref :86
        qr, ql = _update_nd(qr, ql, dX.T, dG.T, s, t)
    elif fmt == ("dense", "scale"):
        ql, qr = _update_ds(ql, qr, dX, dG, s, t)
    elif fmt == ("scale", "dense"):     # mirror of (dense, scale), ref :102
        qr, ql = _update_ds(qr, ql, dX.T, dG.T, s, t)
    elif fmt == ("norm", "scale"):
        ql, qr = _update_ns(ql, qr, dX, dG, s, t)
    elif fmt == ("scale", "norm"):      # mirror of (norm, scale), ref :104
        qr, ql = _update_ns(qr, ql, dX.T, dG.T, s, t)
    else:
        raise ValueError(f"unsupported Kronecker format pair: {fmt}")
    return state.replace(ql=ql, qr=qr)


def update_multi(
    states: Sequence[KronState],
    dXs: Sequence[jax.Array],
    dGs: Sequence[jax.Array],
    step: jax.Array | float = 0.01,
    key: jax.Array | None = None,
) -> list[KronState]:
    """Element-wise `update` over a layer list (the optimizer's per-layer
    path)."""
    del key
    if not (len(states) == len(dXs) == len(dGs)):
        raise ValueError("states/dXs/dGs length mismatch")
    return [update(st, x, g, step) for st, x, g in zip(states, dXs, dGs)]


def apply(state: KronState, G: jax.Array) -> jax.Array:
    ql, qr, fmt = state.ql, state.qr, state.fmt
    if fmt == ("dense", "dense"):
        return _apply_dd(ql, qr, G)
    if fmt == ("norm", "dense"):
        return _apply_nd(ql, qr, G)
    if fmt == ("dense", "norm"):        # ref :128
        return _apply_nd(qr, ql, G.T).T
    if fmt == ("dense", "scale"):
        return _apply_ds(ql, qr, G)
    if fmt == ("scale", "dense"):       # ref :144
        return _apply_ds(qr, ql, G.T).T
    if fmt == ("norm", "scale"):
        return _apply_ns(ql, qr, G)
    if fmt == ("scale", "norm"):        # ref :146
        return _apply_ns(qr, ql, G.T).T
    raise ValueError(f"unsupported Kronecker format pair: {fmt}")


# ---------------------------------------------------------------------------
# batched (dense, dense) path — many same-shape layers, one op chain
# ---------------------------------------------------------------------------
# Layers whose (dense, dense) factors have identical shapes are stored
# stacked — Ql: (B, m, m), Qr: (B, n, n) — and updated by one vmapped op
# chain instead of B separate ones.


@struct.dataclass
class BatchedDDState:
    """Stacked (dense, dense) factors of B layers of one (m, n) shape."""

    ql: jax.Array  # (B, m, m)
    qr: jax.Array  # (B, n, n)


def init_batched(
    shape: tuple[int, int],
    count: int,
    init_scale: float = 1.0,
    dtype=jnp.float32,
) -> BatchedDDState:
    """Stacked identity init for `count` (dense, dense) layers of one
    shape (ref README.md:48)."""
    m, n = shape
    return BatchedDDState(
        ql=jnp.broadcast_to(_factor_init("dense", m, init_scale, dtype), (count, m, m)),
        qr=jnp.broadcast_to(_factor_init("dense", n, init_scale, dtype), (count, n, n)),
    )


def update_batched(
    state: BatchedDDState,
    dXs: Sequence[jax.Array],
    dGs: Sequence[jax.Array],
    step: jax.Array | float = 0.01,
    key: jax.Array | None = None,
) -> BatchedDDState:
    """One Lie-group step for every stacked layer."""
    del key
    dtype = jnp.result_type(state.ql)
    ql, qr = jax.vmap(_update_dd, in_axes=(0, 0, 0, 0, None, None))(
        state.ql, state.qr, jnp.stack(dXs), jnp.stack(dGs),
        jnp.asarray(step, dtype), linalg.tiny(dtype))
    return state.replace(ql=ql, qr=qr)


def apply_batched(
    state: BatchedDDState, Gs: Sequence[jax.Array]
) -> list[jax.Array]:
    """P_i G_i for every stacked layer via batched matmuls."""
    pre = jax.vmap(_apply_dd)(state.ql, state.qr, jnp.stack(Gs))
    return list(pre)


def unbatch(state: BatchedDDState) -> list[KronState]:
    """Per-layer views of a batched state (tests / interop)."""
    return [
        KronState(ql=ql, qr=qr, fmt=("dense", "dense"))
        for ql, qr in zip(state.ql, state.qr)
    ]


def _factor_dense(fmt: Format, q: jax.Array) -> jax.Array:
    """Materialize one factor as a dense matrix (tests only)."""
    if fmt == "dense":
        return q
    if fmt == "scale":
        return jnp.diag(q)
    # norm: diag(q[0]) with last column [q[1,:-1]; q[0,-1]]
    m = jnp.diag(q[0])
    return m.at[:-1, -1].set(q[1, :-1])


def materialize(state: KronState) -> tuple[jax.Array, jax.Array]:
    """Dense (Ql, Qr) factors, for tests only."""
    return (
        _factor_dense(state.fmt[0], state.ql),
        _factor_dense(state.fmt[1], state.qr),
    )
