"""X-shape (flipping-subgroup) preconditioner.

The reference README names this family ("Subgroup {e, flipping} induces the
X-shape matrices", /root/reference/README.md:15) but the TF repo ships no
implementation; we derive it from the Lie-group math.

Q is an "X-matrix": Q[i, i] = a_i and Q[i, n-1-i] = b_i — a diagonal plus an
anti-diagonal. The set of invertible X-matrices is closed under
multiplication and inversion (it is the group algebra of {e, flip}), so the
standard PSGD relative-gradient update applies with the gradient projected
onto the X sparsity pattern.

Derivation (f = flip):
  Q x        = a*x + b*f(x)
  Q^T x      = a*x + f(b)*f(x)
  Q^{-T} v   : pairing rows (i, n-1-i) gives 2x2 systems with determinant
               D = a*f(a) - b*f(b), so  Q^{-T} v = (f(a)*v - f(b)*f(v)) / D
  group grad G = X-project(u u^T - w w^T), u = Q h, w = Q^{-T} v:
               diag part  p = u*u - w*w
               anti part  q = u*f(u) - w*f(w)
  G @ Q      : diag part  p*a + q*f(b),  anti part  p*b + q*f(a)
  Q <- Q - (step / (max(|p|,|q|) + tiny)) * (G @ Q)

Layout — FOLDED: the math only ever couples index i with its mirror
n-1-i, so the state stores both halves stacked, `af[0, i] = a_i`,
`af[1, i] = a_{n-1-i}` (i < n//2). Every `flip` above becomes "use the
other row": compute splits the (2, m) arrays into (m,) row pairs and
writes the coupled equations explicitly — fusable elementwise work with
no data reversals. Only the probe fold/unfold at the boundary reverses
data, touching each element once. On a mesh the folded rows co-locate
each (i, n-1-i) pair, so sharded updates need no cross-device exchange.

Odd n: the center index lies on both diagonals; its diagonal entry is the
scalar `ac` and its anti entry is fixed at 0 (the projected anti gradient
at the center is zero by symmetry).

O(n) state, O(n) compute, pure elementwise work — but unlike diag it
couples coordinate i with coordinate n-1-i, shortcutting gradients across
distant positions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from psgd_tf_tpu import struct
from psgd_tf_tpu.groups import _pairs


@struct.dataclass
class XMatState:
    af: jax.Array  # (2, m) folded diagonal: af[0, i] = a_i, af[1, i] = a_{n-1-i}
    bf: jax.Array  # (2, m) folded anti-diagonal
    ac: jax.Array  # () center diagonal entry; only meaningful when odd
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
        """Unfolded (n,) anti-diagonal view; center is 0 by convention."""
        center = jnp.zeros((1,), self.bf.dtype) if self.odd else None
        return _unfold(self.bf, center)


def _fold(x: jax.Array, m: int, odd: bool):
    """(n,) -> folded (2, m) + center scalar (the only data reversal)."""
    xf = jnp.stack([x[:m], jnp.flip(x[m + 1 :] if odd else x[m:])])
    xc = x[m] if odd else jnp.zeros((), x.dtype)
    return xf, xc


def _unfold(xf: jax.Array, center: jax.Array | None) -> jax.Array:
    parts = [xf[0]] + ([center] if center is not None else []) + [jnp.flip(xf[1])]
    return jnp.concatenate(parts)


def init(n: int, init_scale: float = 1.0, dtype=jnp.float32) -> XMatState:
    m, odd = n // 2, bool(n % 2)
    return XMatState(
        af=jnp.full((2, m), init_scale, dtype=dtype),
        bf=jnp.zeros((2, m), dtype=dtype),
        ac=jnp.asarray(init_scale, dtype=dtype),
        odd=odd,
    )


def matvec(state: XMatState, x: jax.Array) -> jax.Array:
    """Q x = a*x + b*flip(x)."""
    m, odd = state.af.shape[1], state.odd
    xf, xc = _fold(x, m, odd)
    yf, yc = _pairs.matvec(state.af, state.bf, state.ac, xf, xc, odd)
    return _unfold(yf, yc[None] if odd else None)


def update(
    state: XMatState,
    v: jax.Array,
    h: jax.Array,
    step: jax.Array | float = 0.01,
    key: jax.Array | None = None,
) -> XMatState:
    # all math on (m,) row pairs (groups/_pairs.py): "flip" = use the
    # other row, no reversals
    del key
    m, odd = state.af.shape[1], state.odd
    hf, hc = _fold(h, m, odd)
    vf, vc = _fold(v, m, odd)
    new_af, new_bf, new_ac = _pairs.update(
        state.af, state.bf, state.ac, vf, hf, vc, hc, step, odd
    )
    return XMatState(af=new_af, bf=new_bf, ac=new_ac, odd=odd)


def apply(state: XMatState, g: jax.Array) -> jax.Array:
    """P g = Q^T (Q g)."""
    m, odd = state.af.shape[1], state.odd
    gf, gc = _fold(g, m, odd)
    of, oc = _pairs.apply(state.af, state.bf, state.ac, gf, gc, odd)
    return _unfold(of, oc[None] if odd else None)


def materialize(state: XMatState) -> jax.Array:
    """Dense P = Q^T Q for tests."""
    q = jnp.diag(state.a) + jnp.fliplr(jnp.diag(state.b))
    return q.T @ q
