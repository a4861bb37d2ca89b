"""Butterfly (half-length circular-shift subgroup) preconditioner.

The reference README names this family as the remaining member of its
permutation-subgroup taxonomy — "{e, half len circular shifting}" — and
states it is implemented in NO release ("Butterfly matrices … not
implemented", /root/reference/README.md:15). We derive and ship it from
the same Lie-group math as the X-shape family.

Q couples index i with its half-shift partner: Q[i, i] = a_i and
Q[i, σ(i)] = b_i where σ(i) = (i + n//2) mod n for even n. σ is an
involution, so invertible Q of this pattern form the group algebra of
{e, σ} — the same algebraic structure as the flipping subgroup, with a
different orbit pairing. Unlike xmat (which shortcuts position i to its
mirror n-1-i), shift couples each coordinate to the one half the vector
away — the first butterfly stage of an FFT dataflow.

Layout: the fold that puts each orbit {i, i+m} in a column of a (2, m)
array is a pure RESHAPE — `xf = x.reshape(2, m)` — so unlike xmat not
even the boundary reverses data. All the pair math lives
in groups/_pairs.py (shared with xmat; see the derivation there).

Odd n: a half-length circular shift is not an involution (σ² = shift by
1), so the group needs even n. We keep the family total by pairing
i ↔ i + m (m = n//2) for i < m and fixing the LAST index as a σ-fixed
center with a diagonal-only entry — the same center convention as xmat's
middle index, relocated to the tail so the fold stays a reshape.

O(n) state, O(n) compute, pure elementwise work.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from psgd_tf_tpu import struct
from psgd_tf_tpu.groups import _pairs


@struct.dataclass
class ShiftState:
    af: jax.Array  # (2, m) folded diagonal: af[0, i] = a_i, af[1, i] = a_{i+m}
    bf: jax.Array  # (2, m) folded shift part: bf[0, i] = Q[i, i+m], bf[1, i] = Q[i+m, i]
    ac: jax.Array  # () center (last-index) diagonal entry; only meaningful when odd
    odd: bool = struct.field(static=True, default=False)

    @property
    def n(self) -> int:
        return 2 * self.af.shape[1] + (1 if self.odd else 0)

    @property
    def a(self) -> jax.Array:
        """Unfolded (n,) diagonal view (tests/diagnostics)."""
        center = self.ac[None] if self.odd else None
        return _unfold(self.af, center)

    @property
    def b(self) -> jax.Array:
        """Unfolded (n,) shift-part view; center is 0 by convention."""
        center = jnp.zeros((1,), self.bf.dtype) if self.odd else None
        return _unfold(self.bf, center)


def _fold(x: jax.Array, m: int, odd: bool):
    """(n,) -> folded (2, m) + center scalar (a pure reshape)."""
    xf = x[: 2 * m].reshape(2, m)
    xc = x[2 * m] if odd else jnp.zeros((), x.dtype)
    return xf, xc


def _unfold(xf: jax.Array, center: jax.Array | None) -> jax.Array:
    flat = xf.reshape(-1)
    return flat if center is None else jnp.concatenate([flat, center])


def init(n: int, init_scale: float = 1.0, dtype=jnp.float32) -> ShiftState:
    m, odd = n // 2, bool(n % 2)
    return ShiftState(
        af=jnp.full((2, m), init_scale, dtype=dtype),
        bf=jnp.zeros((2, m), dtype=dtype),
        ac=jnp.asarray(init_scale, dtype=dtype),
        odd=odd,
    )


def matvec(state: ShiftState, x: jax.Array) -> jax.Array:
    """Q x = a*x + b*(x shifted by n//2)."""
    m, odd = state.af.shape[1], state.odd
    xf, xc = _fold(x, m, odd)
    yf, yc = _pairs.matvec(state.af, state.bf, state.ac, xf, xc, odd)
    return _unfold(yf, yc[None] if odd else None)


def update(
    state: ShiftState,
    v: jax.Array,
    h: jax.Array,
    step: jax.Array | float = 0.01,
    key: jax.Array | None = None,
) -> ShiftState:
    del key
    m, odd = state.af.shape[1], state.odd
    hf, hc = _fold(h, m, odd)
    vf, vc = _fold(v, m, odd)
    new_af, new_bf, new_ac = _pairs.update(
        state.af, state.bf, state.ac, vf, hf, vc, hc, step, odd
    )
    return ShiftState(af=new_af, bf=new_bf, ac=new_ac, odd=odd)


def apply(state: ShiftState, g: jax.Array) -> jax.Array:
    """P g = Q^T (Q g)."""
    m, odd = state.af.shape[1], state.odd
    gf, gc = _fold(g, m, odd)
    of, oc = _pairs.apply(state.af, state.bf, state.ac, gf, gc, odd)
    return _unfold(of, oc[None] if odd else None)


def materialize(state: ShiftState) -> jax.Array:
    """Dense P = Q^T Q for tests."""
    n, m = state.n, state.af.shape[1]
    perm = (jnp.arange(n) + m) % (2 * m)
    if state.odd:
        perm = perm.at[2 * m].set(2 * m)
    q = jnp.diag(state.a) + jnp.zeros((n, n), state.af.dtype).at[
        jnp.arange(n), perm
    ].set(state.b)
    return q.T @ q
