"""Low-rank-approximation (LRA / "UVd") preconditioner: Q = (I + U V^T) diag(d).

Reference parity: IpUVtmatvec / update_precond_UVd_math_ /
precond_grad_UVd_math, /root/reference/preconditioned_stochastic_gradient_descent.py:540-627.
Unlike standard low-rank forms (diag + U U^T) this fits *both* ends of the
Hessian spectrum, so tiny ranks (~10) work at millions of parameters
(ref README.md:17-19).

Layout: the factors are stored **rank-major**, `U, V: (r, n)`, the
parameter axis contiguous (the reference stores (n, r) columns,
ref :687-689). All compute is O(n r) streaming plus two solves against the
r x r Gram matrix I + V U^T (Woodbury identity, ref :574-579). On a
sharded mesh U, V shard along the parameter axis together with d and the
probe vectors; the r-sized reductions become psums that GSPMD inserts.

Stochastic branches, functionalized with explicit PRNG keys (the reference
uses in-place tf.Variable assigns and global RNG, ref :562, :588):
  - with prob 0.01 rebalance the dynamic ranges of U and V;
  - per step update *either* U or V (prob 0.5 each), each with a
    closed-form spectral-norm-proxy step size.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from psgd_tf_tpu import struct
from psgd_tf_tpu.ops import linalg


@struct.dataclass
class LRAState:
    # U and V live packed in one (2r, n) rank-major array (U rows, then
    # V rows); the properties below are slices XLA fuses.
    UV: jax.Array  # (2r, n) packed rank-major factors
    d: jax.Array   # (n,)

    @property
    def U(self) -> jax.Array:  # (r, n) view; XLA fuses the slice
        return self.UV[: self.UV.shape[0] // 2]

    @property
    def V(self) -> jax.Array:
        return self.UV[self.UV.shape[0] // 2 :]


def init(
    key: jax.Array,
    n: int,
    rank: int = 10,
    init_scale: float = 1.0,
    dtype=jnp.float32,
) -> LRAState:
    """U, V ~ N(0, (n * r)^{-1/2}), d = init_scale (ref :687-690)."""
    scale = (1.0 / (n * rank)) ** 0.5
    return LRAState(
        UV=scale * jax.random.normal(key, (2 * rank, n), dtype=dtype),
        d=init_scale * jnp.ones((n,), dtype=dtype),
    )


def pack(U: jax.Array, V: jax.Array, d: jax.Array) -> LRAState:
    """Build the packed state from separate (r, n) factors (tests/oracles)."""
    return LRAState(UV=jnp.concatenate([U, V], axis=0), d=d)


def _ip_uvt_matvec(u: jax.Array, v: jax.Array, x: jax.Array) -> jax.Array:
    """(I + U V^T) x with rank-major factors: x + (v x) @ u (ref :540-544)."""
    return x + (v @ x) @ u


def update(
    state: LRAState,
    v: jax.Array,
    h: jax.Array,
    step: jax.Array | float = 0.01,
    key: jax.Array | None = None,
) -> LRAState:
    if key is None:
        raise ValueError("lra.update requires a PRNG key (stochastic branches)")
    dtype = state.d.dtype
    k_bal, k_uv = jax.random.split(key)
    s = jnp.asarray(step, dtype)

    # 1% probability U/V dynamic-range rebalance (ref :562-567)
    def _balance(st: LRAState) -> LRAState:
        r = st.UV.shape[0] // 2
        rho = jnp.sqrt(linalg.max_abs(st.U) / linalg.max_abs(st.V))
        scale = jnp.concatenate(
            [jnp.full((r, 1), 1.0, st.UV.dtype) / rho,
             jnp.full((r, 1), 1.0, st.UV.dtype) * rho]
        )
        return st.replace(UV=st.UV * scale)

    state = jax.lax.cond(
        jax.random.uniform(k_bal, dtype=dtype) < 0.01, _balance, lambda st: st, state
    )
    U, V, d = state.U, state.V, state.d

    Qh = _ip_uvt_matvec(U, V, d * h)
    Ph = d * _ip_uvt_matvec(V, U, Qh)

    # Woodbury: P^{-1} v via two r x r solves (ref :574-579; fp32-pinned
    # for half-precision states per ref Note 3)
    IpVtU = jnp.eye(U.shape[0], dtype=dtype) + V @ U.T
    invQtv = v / d
    invQtv = invQtv - linalg.solve_small(IpVtU.T, U @ invQtv) @ V
    invPv = invQtv - linalg.solve_small(IpVtU, V @ invQtv) @ U
    invPv = invPv / d

    # diagonal update (ref :581-584)
    nablaD = Ph * h - v * invPv
    mu = linalg.step_scale(s, linalg.max_abs(nablaD), dtype)
    new_d = d - mu * d * nablaD

    # update either U or V, not both (ref :588-615)
    a, b = Qh, invQtv

    f32 = jnp.float32  # spectral-proxy norms are cancellation-prone
    #                  # (x*y + z*w - 2*u*v): fp32-pinned like the solves,
    #                  # or bf16 rounds a nonzero norm to 0 and the
    #                  # saturated step blows the factor up
    a32, b32 = a.astype(f32), b.astype(f32)

    def _update_u(U, V):
        atV = V @ a               # (r,)
        btV = V @ b
        atVVt = atV @ V           # (n,)
        btVVt = btV @ V
        x32, y32 = atVVt.astype(f32), btVVt.astype(f32)
        norm = jnp.sqrt(
            jnp.abs(
                (a32 @ a32) * (x32 @ x32)
                + (b32 @ b32) * (y32 @ y32)
                - 2.0 * (a32 @ b32) * (x32 @ y32)
            )
        )
        mu = linalg.step_scale(s, norm, dtype)
        newU = U - mu * (
            jnp.outer(IpVtU.T @ atV, a) - jnp.outer(IpVtU.T @ btV, b)
        )
        return newU, V

    def _update_v(U, V):
        atU = U @ a               # (r,)
        btU = U @ b
        UUta = atU @ U            # (n,)
        UUtb = btU @ U
        x32, y32 = UUta.astype(f32), UUtb.astype(f32)
        norm = jnp.sqrt(
            jnp.abs(
                (x32 @ x32) * (a32 @ a32)
                + (y32 @ y32) * (b32 @ b32)
                - 2.0 * (x32 @ y32) * (a32 @ b32)
            )
        )
        mu = linalg.step_scale(s, norm, dtype)
        newV = V - mu * (
            jnp.outer(atU, a + atU @ V) - jnp.outer(btU, b + btU @ V)
        )
        return U, newV

    new_U, new_V = jax.lax.cond(
        jax.random.uniform(k_uv, dtype=dtype) < 0.5, _update_u, _update_v, U, V
    )
    return pack(new_U, new_V, new_d)


def apply(state: LRAState, g: jax.Array) -> jax.Array:
    """P g = d * (I + V U^T) (I + U V^T) (d * g)  (ref :619-627)."""
    x = _ip_uvt_matvec(state.U, state.V, state.d * g)
    return state.d * _ip_uvt_matvec(state.V, state.U, x)


def materialize(state: LRAState) -> jax.Array:
    """Dense P = Q^T Q for tests only."""
    n = state.d.shape[0]
    q = (jnp.eye(n, dtype=state.d.dtype) + state.U.T @ state.V) @ jnp.diag(state.d)
    return q.T @ q
