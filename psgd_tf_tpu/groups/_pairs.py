"""Shared row-pair math for involution-subgroup preconditioners.

Any index involution σ (σ∘σ = identity) induces the group algebra of
{e, σ}: matrices Q = diag(a) + diag(b)·Pσ with Q[i, i] = a_i and
Q[i, σ(i)] = b_i. Invertible members form a Lie group closed under
multiplication and inversion, so the standard PSGD relative-gradient
update applies with the group gradient projected onto the {(i, i),
(i, σ(i))} sparsity pattern.

Two members of this zoo ship here — σ = flip (the reference README's
"X-shape" family, /root/reference/README.md:15) in `groups/xmat.py`, and
σ = half-length circular shift (the README's "butterfly" subgroup, same
line, which NO reference release implements) in `groups/shift.py`. Their
math is identical once vectors are FOLDED so each σ-orbit {i, σ(i)} is a
column of a (2, m) array: `xf[0, i] = x_i`, `xf[1, i] = x_{σ(i)}`. The
families differ only in the fold/unfold boundary (a lane reversal for
flip, a pure reshape for shift) and in which index (if any) is the
σ-fixed "center" carried as a scalar.

All functions below take folded (2, m) rows plus the optional center and
do pure fusable elementwise work — zero data reversals (see
groups/xmat.py).

Derivation on a folded pair, writing (a0, a1) = (a_i, a_{σ(i)}):
  Q x        : y0 = a0·x0 + b0·x1,  y1 = a1·x1 + b1·x0
  Q^T x      : y0 = a0·x0 + b1·x1,  y1 = a1·x1 + b0·x0
  Q^{-T} v   : per-pair 2×2 solve, det D = a0·a1 − b0·b1
  group grad : p = u∘u − w∘w (diag), q = u0·u1 − w0·w1 (σ part,
               symmetric across the pair), u = Q h, w = Q^{-T} v
  G·Q        : diag p0·a0 + q·b1, σ part p0·b0 + q·a1 (and mirrored)
  Q ← Q − step/(max|G| + tiny) · G·Q
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from psgd_tf_tpu.ops import linalg


def matvec(af, bf, ac, xf, xc, odd: bool):
    """Q x on folded rows; returns (yf, yc)."""
    (a0, a1), (b0, b1) = af, bf
    x0, x1 = xf
    yf = jnp.stack([a0 * x0 + b0 * x1, a1 * x1 + b1 * x0])
    yc = ac * xc if odd else None
    return yf, yc


def update(af, bf, ac, vf, hf, vc, hc, step, odd: bool):
    """One Lie-group step; returns (af', bf', ac')."""
    dtype = af.dtype
    a0, a1 = af[0], af[1]
    b0, b1 = bf[0], bf[1]
    h0, h1 = hf[0], hf[1]
    v0, v1 = vf[0], vf[1]

    u0 = a0 * h0 + b0 * h1                            # Q h
    u1 = a1 * h1 + b1 * h0
    det = a0 * a1 - b0 * b1                           # (m,) pair determinant
    w0 = (a1 * v0 - b1 * v1) / det                    # Q^{-T} v
    w1 = (a0 * v1 - b0 * v0) / det

    p0 = u0 * u0 - w0 * w0                            # diag gradient
    p1 = u1 * u1 - w1 * w1
    qv = u0 * u1 - w0 * w1                            # σ gradient (symmetric)

    max_p = jnp.maximum(
        jnp.max(jnp.abs(p0), initial=0.0), jnp.max(jnp.abs(p1), initial=0.0)
    )
    max_q = jnp.max(jnp.abs(qv), initial=0.0)
    pc = None
    if odd:
        uc = ac * hc
        wc = vc / ac
        pc = uc * uc - wc * wc
        max_p = jnp.maximum(max_p, jnp.abs(pc))
    step0 = linalg.step_scale(step, jnp.maximum(max_p, max_q), dtype)

    new_af = jnp.stack([
        a0 - step0 * (p0 * a0 + qv * b1),
        a1 - step0 * (p1 * a1 + qv * b0),
    ])
    new_bf = jnp.stack([
        b0 - step0 * (p0 * b0 + qv * a1),
        b1 - step0 * (p1 * b1 + qv * a0),
    ])
    new_ac = ac - step0 * pc * ac if odd else ac
    return new_af, new_bf, new_ac


def apply(af, bf, ac, gf, gc, odd: bool):
    """P g = Q^T (Q g) on folded rows; returns (of, oc)."""
    a0, a1 = af[0], af[1]
    b0, b1 = bf[0], bf[1]
    g0, g1 = gf[0], gf[1]
    t0 = a0 * g0 + b0 * g1                            # Q g
    t1 = a1 * g1 + b1 * g0
    of = jnp.stack([a0 * t0 + b1 * t1, a1 * t1 + b0 * t0])  # Q^T (Q g)
    oc = ac * ac * gc if odd else None
    return of, oc
