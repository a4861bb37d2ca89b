"""The triangular solves and the dense and sparse-LU families' XLA
formulations against the float64 oracles (`psgd_tf_tpu.oracles`) and the
factors' structural invariants."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psgd_tf_tpu import oracles
from psgd_tf_tpu.groups import dense, splu
from psgd_tf_tpu.ops import linalg

TOL = 1e-3  # fp32 one-step error, measured against the size of the step

_dense_upd = jax.jit(partial(dense.update, step=0.05))
_splu_upd = jax.jit(partial(splu.update, step=0.05))


def _update_apply(fam):
    """update() then apply() of the UPDATED state, as the optimizer runs
    them (the demos precondition with the new Q; ref
    mnist_with_lenet5.py:51-53)."""
    def fn(st, v, h, g):
        new = fam.update(st, v, h, step=0.05)
        return new, fam.apply(new, g)
    return jax.jit(fn)


_dense_ua = _update_apply(dense)
_splu_ua = _update_apply(splu)


def _vecs(seed, n, k=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n, dtype=np.float32) for _ in range(k)]


# -------------------------------------------------------- triangular solves

@pytest.mark.parametrize(
    "n,nrhs,lower,trans",
    [
        (128, 128, False, True),
        (300, 64, False, True),
        (512, 256, False, False),
        (257, 1, True, False),
        (640, 200, True, True),
    ],
)
def test_solve_triangular_matches_float64(n, nrhs, lower, trans):
    rng = np.random.default_rng(n)
    q = oracles.random_triu(rng, n)
    if lower:
        q = q.T
    b = rng.standard_normal((n, nrhs) if nrhs > 1 else (n,), dtype=np.float32)
    fn = {(False, False): linalg.solve_ut, (False, True): linalg.solve_ut_t,
          (True, False): linalg.solve_lt, (True, True): linalg.solve_lt_t}[lower, trans]
    got = jax.jit(fn)(jnp.asarray(q), jnp.asarray(b))
    q64 = q.astype(np.float64)
    want = np.linalg.solve(q64.T if trans else q64, b.astype(np.float64))
    assert got.shape == b.shape
    assert oracles.rel_error(got, want) < 1e-5


def test_solve_half_precision_runs_in_fp32():
    """bf16 operands solve in fp32 and come back bf16 (ref Note 3)."""
    rng = np.random.default_rng(0)
    q = jnp.asarray(oracles.random_triu(rng, 1024), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(1024, dtype=np.float32), jnp.bfloat16)
    got = jax.jit(linalg.solve_ut_t)(q, b)
    assert got.dtype == jnp.bfloat16
    want = np.linalg.solve(np.asarray(q, np.float64).T, np.asarray(b, np.float64))
    assert oracles.rel_error(got, want) < 1e-2  # one bf16 rounding of the result


# ------------------------------------------------------------------- dense

def _dense_case(n, seed):
    rng = np.random.default_rng(seed)
    Q = oracles.random_triu(rng, n)
    return Q, *_vecs(seed + 1, n)


def _check_dense_update(n, seed):
    Q, v, h, _ = _dense_case(n, seed)
    got = _dense_upd(dense.DenseState(Q=jnp.asarray(Q)), v, h)
    want = oracles.dense_oracle(Q.astype(np.float64), v, h, 0.05)
    assert oracles.delta_error(got.Q, want, Q) < TOL
    return np.asarray(got.Q)


@pytest.mark.parametrize("n", [64, 300, 768])
def test_dense_update_matches_oracle(n):
    _check_dense_update(n, seed=5)


@pytest.mark.parametrize("n", [300, 550])
def test_dense_update_matches_oracle_and_stays_triangular(n):
    got = _check_dense_update(n, seed=9)
    np.testing.assert_array_equal(np.tril(got, -1), 0.0)


def _check_dense_update_apply(n, seed):
    Q, v, h, g = _dense_case(n, seed)
    st = dense.DenseState(Q=jnp.asarray(Q))
    got, pre = _dense_ua(st, v, h, g)
    want = oracles.dense_oracle(Q.astype(np.float64), v, h, 0.05)
    assert oracles.delta_error(got.Q, want, Q) < TOL
    assert oracles.rel_error(pre, oracles.dense_apply(want, g)) < 1e-4


@pytest.mark.parametrize("n,seed", [(300, 12), (200, 21), (550, 21)])
def test_dense_update_apply_matches_oracle(n, seed):
    _check_dense_update_apply(n, seed)


@pytest.mark.parametrize("n", [96, 250])
def test_dense_update_apply_from_init_matches_oracle(n):
    """From the library's own 0.5 * I init (no random off-diagonal)."""
    v, h, g = _vecs(22, n)
    st, pre = _dense_ua(dense.init(n, 0.5), v, h, g)
    Q0 = 0.5 * np.eye(n)
    want = oracles.dense_oracle(Q0, v, h, 0.05)
    assert oracles.delta_error(st.Q, want, Q0) < TOL
    assert oracles.rel_error(pre, oracles.dense_apply(want, g)) < 1e-4


# -------------------------------------------------------------------- splu

def _splu_case(n, r, seed):
    Lt, l3, U12, u3 = oracles.random_splu(np.random.default_rng(seed), n, r)
    st = splu.SpLUState(Lt=jnp.asarray(Lt), l3=jnp.asarray(l3),
                        U12=jnp.asarray(U12), u3=jnp.asarray(u3))
    return st, *_vecs(seed + 1, n)


def _assert_splu_matches(got, st, want_LU):
    r = st.rank
    want = oracles.splu_blocks(*want_LU, r)
    base = oracles.splu_blocks(*oracles.splu_dense(st), r)
    scale = max(np.abs(w - b).max() for w, b in zip(want, base))
    for g, w in zip((got.Lt, got.l3, got.U12, got.u3), want):
        assert np.abs(np.asarray(g, np.float64) - w).max() / scale < TOL


def _check_splu_update(n, r, seed):
    st, v, h, _ = _splu_case(n, r, seed)
    got = _splu_upd(st, v, h)
    want = oracles.splu_oracle(*oracles.splu_dense(st), r, v, h, 0.05)
    _assert_splu_matches(got, st, want)
    return got


@pytest.mark.parametrize("n,r", [(64, 6), (100, 10), (300, 4), (48, 1)])
def test_splu_update_matches_oracle(n, r):
    _check_splu_update(n, r, seed=7)


@pytest.mark.parametrize("n,r", [(64, 6), (100, 10), (300, 4), (48, 1), (200, 16)])
def test_splu_update_matches_oracle_reseeded(n, r):
    _check_splu_update(n, r, seed=13)


def _assert_splu_structure(st):
    r = st.rank
    L1 = np.asarray(st.Lt[:, :r].T)
    U1 = np.asarray(st.U12[:, :r])
    np.testing.assert_array_equal(np.triu(L1, 1), 0.0)
    np.testing.assert_array_equal(np.tril(U1, -1), 0.0)


def test_splu_update_preserves_structure():
    """L1 stays lower-tri, U1 upper-tri through the update."""
    _assert_splu_structure(_check_splu_update(80, 5, seed=3))


def test_splu_structure_and_state_size():
    """Structure survives the update, and the state is O(n r) at any n:
    a 1M-parameter rank-10 state is (10, n) factors plus (n - 10,) tails."""
    _assert_splu_structure(_check_splu_update(80, 5, seed=15))
    st = jax.eval_shape(lambda: splu.init(1 << 20, rank=10))
    assert st.Lt.shape == st.U12.shape == (10, 1 << 20)
    assert st.l3.shape == st.u3.shape == ((1 << 20) - 10,)


def _check_splu_update_apply(n, r, seed):
    st, v, h, g = _splu_case(n, r, seed)
    got, pre = _splu_ua(st, v, h, g)
    L, U = oracles.splu_oracle(*oracles.splu_dense(st), r, v, h, 0.05)
    _assert_splu_matches(got, st, (L, U))
    Q = L @ U
    assert oracles.rel_error(pre, Q.T @ (Q @ g)) < 1e-4


@pytest.mark.parametrize("n,r,seed", [(64, 6, 12), (130, 10, 12), (100, 10, 12), (300, 4, 12),
                                      (48, 1, 12), (64, 6, 4), (130, 4, 4)])
def test_splu_update_apply_matches_oracle(n, r, seed):
    _check_splu_update_apply(n, r, seed)
