"""Golden-trajectory tests (SURVEY.md §4b).

Multi-step trajectories with *injected* probe sequences, the fp32 JAX
implementation against the independent float64 numpy oracles of
`psgd_tf_tpu.oracles` (dense C2, kron C6/C8/C10/C12, splu C14, UVd C17).
Injecting (v, h) and replicating the PRNG branch decisions factors
TF-vs-JAX RNG divergence out of the comparison, per the survey's test
strategy. The sparse-family oracles use a different formulation than the
implementation (see the oracles module), so a transcription error in
either form cannot cancel.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psgd_tf_tpu import oracles
from psgd_tf_tpu.groups import dense, kron, lra, splu
from psgd_tf_tpu.oracles import dense_oracle, lra_oracle, splu_oracle

STEPS = 20
N = 24


# ------------------------------------------------------------ trajectories

def _probes(seed, steps=STEPS, n=N):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal(n), rng.standard_normal(n)) for _ in range(steps)
    ]


def test_dense_trajectory_matches_oracle():
    state = dense.init(N, init_scale=0.5)
    Q64 = np.asarray(state.Q, np.float64)
    upd = jax.jit(partial(dense.update, step=0.05))
    for v, h in _probes(0):
        state = upd(state, jnp.asarray(v, jnp.float32), jnp.asarray(h, jnp.float32))
        Q64 = dense_oracle(Q64, v, h, 0.05)
    rel = np.abs(np.asarray(state.Q) - Q64).max() / np.abs(Q64).max()
    assert rel < 5e-4, rel


def test_kron_dd_trajectory_matches_oracle():
    m, n = 12, 8
    state = kron.init((m, n), fmt=("dense", "dense"), init_scale=0.7)
    Ql64 = np.asarray(state.ql, np.float64)
    Qr64 = np.asarray(state.qr, np.float64)
    rng = np.random.default_rng(1)
    upd = jax.jit(partial(kron.update, step=0.05))
    for _ in range(STEPS):
        dX = rng.standard_normal((m, n))
        dG = rng.standard_normal((m, n))
        state = upd(state, jnp.asarray(dX, jnp.float32), jnp.asarray(dG, jnp.float32))
        Ql64, Qr64 = oracles.kron_oracle(("dense", "dense"), Ql64, Qr64, dX, dG, 0.05)
    for got, want in ((state.ql, Ql64), (state.qr, Qr64)):
        rel = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
        assert rel < 5e-4, rel


def test_lra_trajectory_matches_oracle():
    key = jax.random.PRNGKey(7)
    state = lra.init(key, N, rank=4)
    # oracle keeps the reference's (n, r) column layout; the implementation
    # stores rank-major (r, n) — transpose at the boundary
    U64 = np.asarray(state.U, np.float64).T
    V64 = np.asarray(state.V, np.float64).T
    d64 = np.asarray(state.d, np.float64)
    upd = jax.jit(partial(lra.update, step=0.05))
    step_key = jax.random.PRNGKey(11)
    for v, h in _probes(2):
        step_key, k = jax.random.split(step_key)
        # replicate the implementation's branch decisions (lra.update
        # splits k into (k_bal, k_uv) and draws uniforms)
        k_bal, k_uv = jax.random.split(k)
        balance = bool(jax.random.uniform(k_bal, dtype=jnp.float32) < 0.01)
        update_u = bool(jax.random.uniform(k_uv, dtype=jnp.float32) < 0.5)
        state = upd(
            state, jnp.asarray(v, jnp.float32), jnp.asarray(h, jnp.float32), key=k
        )
        U64, V64, d64 = lra_oracle(
            U64, V64, d64, v, h, 0.05, balance=balance, update_u=update_u
        )
    for got, want in ((state.U.T, U64), (state.V.T, V64), (state.d, d64)):
        rel = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
        assert rel < 1e-3, rel


_SPARSE_KRON = [("norm", "dense"), ("dense", "scale"), ("norm", "scale")]
_factor_to_dense64 = oracles.factor_to_oracle


@pytest.mark.parametrize("fmt", sorted(_SPARSE_KRON), ids=str)
def test_sparse_kron_trajectory_matches_oracle(fmt):
    """The arrow-inverse / diag-shortcut kron updates vs the dense float64
    materialization (most transcription-error-prone code per VERDICT r1)."""
    m, n = 11, 9
    state = kron.init((m, n), fmt=fmt, init_scale=0.8)
    Ql64 = _factor_to_dense64(fmt[0], state.ql)
    Qr64 = _factor_to_dense64(fmt[1], state.qr)
    oracle = partial(oracles.kron_oracle, fmt)
    rng = np.random.default_rng(5)
    upd = jax.jit(partial(kron.update, step=0.05))
    for _ in range(STEPS):
        dX = rng.standard_normal((m, n))
        dG = rng.standard_normal((m, n))
        state = upd(state, jnp.asarray(dX, jnp.float32), jnp.asarray(dG, jnp.float32))
        Ql64, Qr64 = oracle(Ql64, Qr64, dX, dG, 0.05)
    got_l = _factor_to_dense64(fmt[0], state.ql)
    got_r = _factor_to_dense64(fmt[1], state.qr)
    for got, want in ((got_l, Ql64), (got_r, Qr64)):
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 5e-4, (fmt, rel)
    # the oracle's dense updates must also PRESERVE the sparsity pattern
    # (group closure) — catches a wrong projection in the oracle itself
    if fmt[0] == "norm":
        off = Ql64 - np.diag(np.diag(Ql64))
        off[:-1, -1] = 0.0
        assert np.abs(off).max() < 1e-12
    if fmt[1] == "scale":
        assert Qr64.ndim == 1  # a diagonal factor stays a vector


@pytest.mark.parametrize("fmt", [("dense", "norm"), ("scale", "dense"), ("scale", "norm")], ids=str)
def test_mirror_kron_trajectory_matches_transposed_oracle(fmt):
    """The transpose-mirror dispatch cases (ref :86, :102, :104) against the
    sibling oracle run on transposed probes."""
    m, n = 9, 11
    mirror = (fmt[1], fmt[0])
    state = kron.init((m, n), fmt=fmt, init_scale=0.8)
    # oracle runs the implemented sibling on (n, m) transposed data
    Qr64 = _factor_to_dense64(fmt[1], state.qr)   # left of the mirror
    Ql64 = _factor_to_dense64(fmt[0], state.ql)   # right of the mirror
    oracle = partial(oracles.kron_oracle, mirror)
    rng = np.random.default_rng(6)
    upd = jax.jit(partial(kron.update, step=0.05))
    for _ in range(STEPS):
        dX = rng.standard_normal((m, n))
        dG = rng.standard_normal((m, n))
        state = upd(state, jnp.asarray(dX, jnp.float32), jnp.asarray(dG, jnp.float32))
        Qr64, Ql64 = oracle(Qr64, Ql64, dX.T, dG.T, 0.05)
    got_l = _factor_to_dense64(fmt[0], state.ql)
    got_r = _factor_to_dense64(fmt[1], state.qr)
    for got, want in ((got_l, Ql64), (got_r, Qr64)):
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 5e-4, (fmt, rel)


def test_splu_trajectory_matches_oracle():
    rank = 6
    state = splu.init(N, rank=rank, init_scale=0.6)
    L64 = np.zeros((N, N))
    L64[:rank, :rank] = np.asarray(state.L12[:rank], np.float64)
    L64[rank:, :rank] = np.asarray(state.L12[rank:], np.float64)
    L64[rank:, rank:] = np.diag(np.asarray(state.l3, np.float64))
    U64 = np.zeros((N, N))
    U64[:rank, :rank] = np.asarray(state.U12[:, :rank], np.float64)
    U64[:rank, rank:] = np.asarray(state.U12[:, rank:], np.float64)
    U64[rank:, rank:] = np.diag(np.asarray(state.u3, np.float64))

    upd = jax.jit(partial(splu.update, step=0.05))
    for v, h in _probes(8):
        state = upd(state, jnp.asarray(v, jnp.float32), jnp.asarray(h, jnp.float32))
        L64, U64 = splu_oracle(L64, U64, rank, v, h, 0.05)

    got = {
        "L1": np.asarray(state.L12[:rank]),
        "L2": np.asarray(state.L12[rank:]),
        "l3": np.asarray(state.l3),
        "U1": np.asarray(state.U12[:, :rank]),
        "U2": np.asarray(state.U12[:, rank:]),
        "u3": np.asarray(state.u3),
    }
    want = {
        "L1": L64[:rank, :rank],
        "L2": L64[rank:, :rank],
        "l3": np.diag(L64[rank:, rank:]),
        "U1": U64[:rank, :rank],
        "U2": U64[:rank, rank:],
        "u3": np.diag(U64[rank:, rank:]),
    }
    scale = max(np.abs(L64).max(), np.abs(U64).max())
    for k in got:
        rel = np.abs(got[k] - want[k]).max() / scale
        assert rel < 5e-4, (k, rel)
    # oracle pattern closure: L stays splu-lower, U stays splu-upper
    assert np.abs(np.triu(L64, 1)[:rank]).max() < 1e-12
    assert np.abs(L64[rank:, rank:] - np.diag(np.diag(L64[rank:, rank:]))).max() < 1e-12
    assert np.abs(np.tril(U64, -1)[:, :rank]).max() < 1e-12


def test_dense_oracle_criterion_sanity():
    """The oracle itself must decrease the PSGD fitting criterion — guards
    against an oracle bug silently matching an implementation bug."""
    rng = np.random.default_rng(3)
    H = rng.standard_normal((N, N))
    H = H @ H.T / N + 0.5 * np.eye(N)
    Q = 0.3 * np.eye(N)

    def crit(Q):
        # E over fixed probe set of |Q h|^2 + |Q^-T v|^2
        tot = 0.0
        for v, _ in _probes(4, steps=8):
            h = H @ v
            b = np.linalg.solve(Q.T, v)
            tot += (Q @ h) @ (Q @ h) + b @ b
        return tot

    before = crit(Q)
    for v, _ in _probes(5, steps=40):
        Q = dense_oracle(Q, v, H @ v, 0.1)
    assert crit(Q) < before
