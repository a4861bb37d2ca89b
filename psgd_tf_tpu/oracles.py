"""Float64 numpy oracles of the reference's update equations.

Independent of the library code they check: they implement the math
contracts (SURVEY.md §0/§2.1 — dense C2, kron C6/C8/C10/C12, splu C14,
UVd C17) in plain numpy, float64, one update step per call. The tests
(tests/test_golden.py and the XLA-path tests) and the on-chip smoke run
(chip_smoke.py) compare the library against them.

The sparse-family oracles deliberately use a DIFFERENT formulation than
the implementation: an arrow ("norm") factor is materialized as a dense
matrix, the group gradient is computed with np.linalg solves on the dense
forms, projected onto the factor's sparsity pattern, and the
multiplicative update applied densely. The implementation's closed-form
arrow inverses and block algebra must agree with this — a transcription
error in either form cannot cancel. A diagonal ("scale") factor is kept as
a vector, so that probe widths of 10^4..10^6 stay affordable.
"""
from __future__ import annotations

import numpy as np

TINY = float(np.nextafter(np.float32(0), np.float32(1)))  # fp32 subnormal


def dense_oracle(Q, v, h, step):
    """C2: a = Q h; b = Q^-T v; Q <- Q - step/(max|triu(aa'-bb')|+tiny) triu(..) Q."""
    a = Q @ h
    b = np.linalg.solve(Q.T, v)
    grad = np.triu(np.outer(a, a) - np.outer(b, b))
    step0 = step / (np.abs(grad).max() + TINY)
    return Q - step0 * (grad @ Q)


def dense_apply(Q, g):
    return Q.T @ (Q @ g)


def lra_oracle(U, V, d, v, h, step, *, balance, update_u):
    """C17 on (n, r) column factors: optional rebalance; Woodbury P^-1 v;
    diag grad; U-or-V update."""
    if balance:
        rho = np.sqrt(np.abs(U).max() / np.abs(V).max())
        U, V = U / rho, rho * V

    Qh = d * h + U @ (V.T @ (d * h))
    Ph = d * (Qh + V @ (U.T @ Qh))
    IpVtU = np.eye(U.shape[1]) + V.T @ U
    invQtv = v / d
    invQtv = invQtv - V @ np.linalg.solve(IpVtU.T, U.T @ invQtv)
    invPv = (invQtv - U @ np.linalg.solve(IpVtU, V.T @ invQtv)) / d

    nablaD = Ph * h - v * invPv
    mu = step / (np.abs(nablaD).max() + TINY)
    new_d = d - mu * d * nablaD

    a, b = Qh, invQtv
    if update_u:
        atV = a @ V
        btV = b @ V
        atVVt = V @ atV
        btVVt = V @ btV
        norm = np.sqrt(
            np.abs(
                (a @ a) * (atVVt @ atVVt)
                + (b @ b) * (btVVt @ btVVt)
                - 2.0 * (a @ b) * (atVVt @ btVVt)
            )
        )
        mu = step / (norm + TINY)
        U = U - mu * (np.outer(a, atV @ IpVtU) - np.outer(b, btV @ IpVtU))
    else:
        atU = a @ U
        btU = b @ U
        norm = np.sqrt(
            np.abs(
                ((U @ atU) @ (U @ atU)) * (a @ a)
                + ((U @ btU) @ (U @ btU)) * (b @ b)
                - 2.0 * ((U @ atU) @ (U @ btU)) * (a @ b)
            )
        )
        mu = step / (norm + TINY)
        V = V - mu * (np.outer(a + V @ atU, atU) - np.outer(b + V @ btU, btU))
    return U, V, new_d


def lra_apply(U, V, d, g):
    """P g = d (I + V U^T)(I + U V^T)(d g) with (n, r) column factors."""
    x = d * g
    x = x + U @ (V.T @ x)
    return d * (x + V @ (U.T @ x))


# ------------------------------------------------------------------- kron

def arrow(ql0, ql1):
    """Dense arrow matrix: diag(ql0) with last column [ql1[:-1]; ql0[-1]]."""
    Q = np.diag(np.asarray(ql0, np.float64))
    Q[:-1, -1] = ql1[:-1]
    return Q


def _project_arrow(M):
    """Project a dense group gradient onto the arrow pattern
    {diagonal, last column} (the bias entry at [-1, -1] is diagonal)."""
    G = np.diag(np.diag(M)).astype(np.float64)
    G[:-1, -1] += M[:-1, -1]
    return G


def factor_to_oracle(fmt, q):
    """A kron factor in the oracle's form: dense and norm factors as dense
    (d, d) matrices, scale factors as (d,) diagonal vectors."""
    q = np.asarray(q, np.float64)
    if fmt == "norm":
        return arrow(q[0], q[1])
    return q


def kron_oracle(fmt, Ql, Qr, dX, dG, step):
    """C6/C8/C10/C12 for the canonical pairs (dense, dense), (norm, dense),
    (dense, scale), (norm, scale): balance by rho, A = Ql dG Qr^T,
    Bt = Ql^-T dX Qr^-1, group gradients projected on each factor's
    pattern (triu / arrow / diagonal), multiplicative updates.
    Factors in `factor_to_oracle` form."""
    fl, fr = fmt
    rho = np.sqrt(_diag(Ql).max() / _diag(Qr).max())
    Ql, Qr = Ql / rho, rho * Qr
    A = _lmul(Ql, dG)
    A = A @ Qr.T if Qr.ndim == 2 else A * Qr[None, :]
    Bt = np.linalg.solve(Ql.T, dX) if Ql.ndim == 2 else dX / Ql[:, None]
    Bt = Bt @ np.linalg.inv(Qr) if Qr.ndim == 2 else Bt / Qr[None, :]
    new = []
    for f, Q, X, Y in ((fl, Ql, A, Bt), (fr, Qr, A.T, Bt.T)):
        if f == "scale":
            G = np.sum(X * X, axis=1) - np.sum(Y * Y, axis=1)
            s = step / (np.abs(G).max() + TINY)
            new.append(Q - s * G * Q)
            continue
        M = X @ X.T - Y @ Y.T
        G = np.triu(M) if f == "dense" else _project_arrow(M)
        s = step / (np.abs(G).max() + TINY)
        new.append(Q - s * (G @ Q))
    return tuple(new)


_MIRRORS = {("dense", "norm"), ("scale", "dense"), ("scale", "norm")}


def kron_update(fmt, ql, qr, dX, dG, step):
    """`kron_oracle` for any supported pair, factors in the library's layout
    (groups/kron.py) in, `factor_to_oracle` form out. Mirror pairs run
    their canonical sibling on transposed probes (ref :86, :102, :104)."""
    fl, fr = fmt
    ql, qr = factor_to_oracle(fl, ql), factor_to_oracle(fr, qr)
    dX, dG = np.asarray(dX, np.float64), np.asarray(dG, np.float64)
    if tuple(fmt) in _MIRRORS:
        nr, nl = kron_oracle((fr, fl), qr, ql, dX.T, dG.T, step)
        return nl, nr
    return kron_oracle(fmt, ql, qr, dX, dG, step)


def kron_apply(Ql, Qr, G):
    """P G = Ql^T Ql G Qr^T Qr with factors in `factor_to_oracle` form."""
    X = _lmul(Ql, G)
    X = _lmul(Ql.T if Ql.ndim == 2 else Ql, X)
    X = X @ (Qr.T @ Qr) if Qr.ndim == 2 else X * (Qr * Qr)[None, :]
    return X


def _diag(Q):
    return np.diag(Q) if Q.ndim == 2 else Q


def _lmul(Q, X):
    return Q @ X if Q.ndim == 2 else Q[:, None] * X


# ------------------------------------------------------------------- splu

def _project_splu_l(M, r):
    """L pattern: lower-tri r x r corner, full lower-left block, diag tail."""
    G = np.zeros_like(M)
    G[:r, :r] = np.tril(M[:r, :r])
    G[r:, :r] = M[r:, :r]
    G[r:, r:] = np.diag(np.diag(M[r:, r:]))
    return G


def _project_splu_u(M, r):
    """U pattern: upper-tri r x r corner, full upper-right block, diag tail."""
    G = np.zeros_like(M)
    G[:r, :r] = np.triu(M[:r, :r])
    G[:r, r:] = M[:r, r:]
    G[r:, r:] = np.diag(np.diag(M[r:, r:]))
    return G


def splu_oracle(L, U, r, v, h, step):
    """C14 on DENSE L, U: balance; Q = L U; the four probe images via dense
    solves; pattern-projected group grads; L <- L - s (G_L L),
    U <- U - s (U G_U) with joint max-abs steps (ref :396-480)."""
    rho = np.sqrt(np.diag(L).max() / np.diag(U).max())
    L, U = L / rho, rho * U
    Q = L @ U
    P = Q.T @ Q
    Qg = Q @ h
    iQtx = np.linalg.solve(Q.T, v)
    Pg = P @ h
    iPx = np.linalg.solve(P, v)

    GL = _project_splu_l(np.outer(Qg, Qg) - np.outer(iQtx, iQtx), r)
    sL = step / (np.abs(GL).max() + TINY)
    newL = L - sL * (GL @ L)

    GU = _project_splu_u(np.outer(Pg, h) - np.outer(v, iPx), r)
    sU = step / (np.abs(GU).max() + TINY)
    newU = U - sU * (U @ GU)
    return newL, newU


def splu_dense(state):
    """Dense float64 (L, U) of a `groups.splu.SpLUState`."""
    r = state.rank
    Lt = np.asarray(state.Lt, np.float64)
    U12 = np.asarray(state.U12, np.float64)
    n = Lt.shape[1]
    L = np.zeros((n, n))
    L[:, :r] = Lt.T
    L[r:, r:] = np.diag(np.asarray(state.l3, np.float64))
    U = np.zeros((n, n))
    U[:r, :] = U12
    U[r:, r:] = np.diag(np.asarray(state.u3, np.float64))
    return L, U


def splu_blocks(L, U, r):
    """The (Lt, l3, U12, u3) blocks of dense L, U — the state's layout."""
    return (L[:, :r].T, np.diag(L[r:, r:]), U[:r, :], np.diag(U[r:, r:]))


# ------------------------------------------------------- comparison metric

def delta_error(got, want, base):
    """max|got - want| / max|want - base|: the error of an update measured
    against the size of the update itself, so that a state that barely
    moves cannot hide a wrong step. An array the step leaves unchanged is
    measured against its own size."""
    got, want, base = (np.asarray(x, np.float64) for x in (got, want, base))
    den = np.abs(want - base).max(initial=0.0) or np.abs(want).max(initial=0.0) or 1.0
    return float(np.abs(got - want).max(initial=0.0) / den)


def rel_error(got, want):
    """max|got - want| / max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


# ----------------------------------------- random float32 states and probes
# Walked off identity so that no factor is trivial, conditioned so that
# fp32 solves stay accurate at every width (off-diagonal entries shrink as
# 1/sqrt(d): the condition number stays ~10 up to d = 16384), and with
# every factor's largest diagonal entry exactly 1, so that the updates'
# dynamic-range balancing is the identity and the comparison sees the
# Lie-group step alone.

def _unit_max_diag(rng, d):
    x = 0.5 + 0.5 * rng.random(d, dtype=np.float32)
    x[0] = 1.0
    return x


def random_triu(rng, d, noise=0.5):
    """(d, d) upper-triangular factor."""
    Q = rng.standard_normal((d, d), dtype=np.float32)
    Q *= np.float32(noise / np.sqrt(d))
    Q = np.triu(Q, 1)
    Q[np.diag_indices(d)] = _unit_max_diag(rng, d)
    return Q


def random_kron_factor(rng, fmt, d):
    """A kron factor in the library's layout: (d, d) dense, (2, d) norm
    (row 0 the diagonal, row 1 the last column, its last entry 0), (d,)
    scale."""
    if fmt == "dense":
        return random_triu(rng, d)
    if fmt == "scale":
        return _unit_max_diag(rng, d)
    col = rng.standard_normal(d, dtype=np.float32) * np.float32(0.5 / np.sqrt(d))
    col[-1] = 0.0
    return np.stack([_unit_max_diag(rng, d), col])


def random_splu(rng, n, r, noise=0.5):
    """(Lt, l3, U12, u3) of a sparse-LU state with r < n."""
    s = np.float32(noise / np.sqrt(n))
    L1 = random_triu(rng, r).T
    U1 = random_triu(rng, r)
    Lt = np.concatenate([L1.T, s * rng.standard_normal((r, n - r), dtype=np.float32)], 1)
    U12 = np.concatenate([U1, s * rng.standard_normal((r, n - r), dtype=np.float32)], 1)
    return Lt, _unit_max_diag(rng, n - r), U12, _unit_max_diag(rng, n - r)
