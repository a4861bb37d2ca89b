"""Core structured linear-algebra ops shared by every preconditioner family.

This is the L1 numeric vocabulary of the framework: triangular solves,
triangular masking, max-abs step normalization, and the numerical constants
that PSGD's Lie-group updates depend on.

Reference parity (see /root/reference/preconditioned_stochastic_gradient_descent.py):
  - `_tiny` underflow guard: reference computes the smallest positive
    *subnormal* of the dtype via a recursive-halving lambda (ref :21-22, :682).
  - `delta_scale` = sqrt(machine eps), the finite-difference probe scale
    (ref :683).
  - upper-triangular solves with adjoint (ref :39, :174, :233, :298).
  - `band_part(x, 0, -1)` triangular extraction (ref :40, :175-176, :243, :301).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "tiny",
    "delta_scale",
    "max_abs",
    "triu",
    "tril",
    "solve_ut",
    "solve_ut_t",
    "solve_lt",
    "solve_lt_t",
    "solve_small",
    "step_scale",
    "triu_outer_diff_matmul",
    "norm_clip_scale",
]


@functools.lru_cache(maxsize=None)
def tiny(dtype) -> float:
    """Smallest positive *subnormal* of `dtype` (not the smallest normal).

    Matches the reference's recursive-halving `_tiny` (ref :21-22): for fp32
    this is ~1.4e-45, not `finfo.tiny` (~1.18e-38). Used to guard the
    `step / max|grad|` normalization against division by zero.
    `smallest_subnormal` covers the ml_dtypes half types (bf16 ~9.2e-41)
    that `np.nextafter` cannot produce.
    """
    return float(_finfo(dtype).smallest_subnormal)


def _finfo(dtype):
    """np.finfo, falling back to ml_dtypes.finfo for bf16/fp8-style types
    this numpy build does not classify as inexact."""
    try:
        return np.finfo(np.dtype(dtype))
    except ValueError:
        import ml_dtypes

        return ml_dtypes.finfo(np.dtype(dtype))


@functools.lru_cache(maxsize=None)
def delta_scale(dtype) -> float:
    """sqrt(machine eps): finite-difference perturbation scale (ref :683)."""
    return float(np.sqrt(float(_finfo(dtype).eps)))


def max_abs(x: jax.Array) -> jax.Array:
    """max |x| over all entries — the Lie-group step normalizer (ref :41)."""
    return jnp.max(jnp.abs(x))


def triu(x: jax.Array) -> jax.Array:
    """Upper-triangular part, `band_part(x, 0, -1)` in the reference."""
    return jnp.triu(x)


def tril(x: jax.Array) -> jax.Array:
    """Lower-triangular part, `band_part(x, -1, 0)` in the reference."""
    return jnp.tril(x)


def _as_col(x: jax.Array) -> jax.Array:
    return x[:, None] if x.ndim == 1 else x


def _solve_tri(a: jax.Array, b: jax.Array, *, lower: bool, trans: bool) -> jax.Array:
    # solves amplify rounding through back-substitution: run them in fp32
    # even when the state is half precision (the reference flags exactly
    # this caveat for its half-precision mode, ref :657-658 "Note 3"), then
    # cast back. Statistical GEMMs elsewhere stay in the state dtype.
    out_dtype = jnp.result_type(a, b)
    compute = jnp.promote_types(out_dtype, jnp.float32)
    b2 = _as_col(b)
    out = jax.lax.linalg.triangular_solve(
        a.astype(compute),
        b2.astype(compute),
        left_side=True,
        lower=lower,
        transpose_a=trans,
        conjugate_a=False,
        unit_diagonal=False,
    ).astype(out_dtype)
    return out[:, 0] if b.ndim == 1 else out


def solve_ut(u: jax.Array, b: jax.Array) -> jax.Array:
    """Solve U x = b with U upper triangular."""
    return _solve_tri(u, b, lower=False, trans=False)


def solve_ut_t(u: jax.Array, b: jax.Array) -> jax.Array:
    """Solve U^T x = b with U upper triangular (the reference's
    `triangular_solve(Q, ., lower=False, adjoint=True)`, ref :39)."""
    return _solve_tri(u, b, lower=False, trans=True)


def solve_lt(l: jax.Array, b: jax.Array) -> jax.Array:
    """Solve L x = b with L lower triangular (ref :448)."""
    return _solve_tri(l, b, lower=True, trans=False)


def solve_lt_t(l: jax.Array, b: jax.Array) -> jax.Array:
    """Solve L^T x = b with L lower triangular (ref :440)."""
    return _solve_tri(l, b, lower=True, trans=True)


def step_scale(step, max_grad: jax.Array, dtype) -> jax.Array:
    """The Lie-group step normalizer `step / (max|grad| + tiny)` (ref :41),
    computed in fp32 and saturated at the state dtype's finite max.

    A group gradient that underflows to exactly 0 (routine in bf16 near
    convergence, possible in fp32) would otherwise produce
    `step / tiny = inf` and then `inf * 0 = NaN` in the multiplicative
    update — a latent reference bug this formulation removes: the saturated
    scale multiplies the zero gradient back to a zero update.
    """
    f32 = jnp.float32
    s = jnp.asarray(step, f32) / (max_grad.astype(f32) + tiny(dtype))
    return jnp.minimum(s, float(_finfo(dtype).max)).astype(dtype)


def solve_small(a: jax.Array, b: jax.Array) -> jax.Array:
    """Dense solve of a small (r, r) system in >= fp32 — the Woodbury cores
    (ref :577-578); half-precision states upcast per ref Note 3 (:657-658)."""
    out_dtype = jnp.result_type(a, b)
    compute = jnp.promote_types(out_dtype, jnp.float32)
    return jax.scipy.linalg.solve(
        a.astype(compute), b.astype(compute)
    ).astype(out_dtype)


def triu_outer_diff_matmul(a: jax.Array, b: jax.Array, q: jax.Array) -> jax.Array:
    """Compute `triu(a a^T - b b^T) @ Q` in O(n^2) instead of O(n^3).

    The reference materializes the n x n group gradient and multiplies it
    into Q (ref :40-42). With *vector* probes the gradient is rank-2, so
    row i of `triu(a a^T) @ Q` is `a_i * sum_{j >= i} a_j Q[j, :]` — a
    reverse cumulative sum: two elementwise products plus two reverse
    cumsums, elementwise work that XLA fuses, with no n^3 matmul.

    Args:
      a, b: (n,) vectors.
      q: (n, n) matrix.
    Returns:
      (n, n) result equal to `jnp.triu(outer(a,a) - outer(b,b)) @ q`.
    """
    sa = jnp.cumsum((a[:, None] * q)[::-1], axis=0)[::-1]
    sb = jnp.cumsum((b[:, None] * q)[::-1], axis=0)[::-1]
    return a[:, None] * sa - b[:, None] * sb


def triu_outer_diff_maxabs(a: jax.Array, b: jax.Array) -> jax.Array:
    """max over the upper triangle of |a a^T - b b^T|.

    O(n^2) elementwise work; XLA fuses the mask+abs+max so the n x n
    intermediate never round-trips to HBM.
    """
    n = a.shape[0]
    m = a[:, None] * a[None, :] - b[:, None] * b[None, :]
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    return jnp.max(jnp.where(rows <= cols, jnp.abs(m), 0.0))


def norm_clip_scale(norm: jax.Array, max_norm: jax.Array, dtype=None) -> jax.Array:
    """Return the lr multiplier `min(max_norm / norm, 1)` (ref :750-754).

    `max_norm = inf` (no clipping) yields exactly 1.
    """
    return jnp.minimum(max_norm / norm, jnp.asarray(1.0, dtype=dtype or norm.dtype))
