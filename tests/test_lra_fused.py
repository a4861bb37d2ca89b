"""The LRA family's update, and update followed by apply, against the float64 oracle
(`psgd_tf_tpu.oracles.lra_oracle`), with the PRNG branch decisions
replicated."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psgd_tf_tpu import oracles
from psgd_tf_tpu.groups import lra

TOL = 1e-3  # fp32 one-step error, measured against the size of the step


def _case(n, r, seed):
    key = jax.random.PRNGKey(seed)
    state = lra.init(jax.random.fold_in(key, 0), n, rank=r, init_scale=0.8)
    v = jax.random.normal(jax.random.fold_in(key, 1), (n,))
    h = jax.random.normal(jax.random.fold_in(key, 2), (n,))
    return state, v, h, jax.random.PRNGKey(seed + 100)


def _branches(key):
    """The coins lra.update draws from `key`: (balance, update_u)."""
    k_bal, k_uv = jax.random.split(key)
    return (bool(jax.random.uniform(k_bal) < 0.01),
            bool(jax.random.uniform(k_uv) < 0.5))


def _oracle(state, v, h, key, step=0.05):
    balance, update_u = _branches(key)
    f64 = lambda x: np.asarray(x, np.float64)
    return oracles.lra_oracle(f64(state.U).T, f64(state.V).T, f64(state.d),
                              f64(v), f64(h), step, balance=balance,
                              update_u=update_u)


def _assert_matches(got, state, want):
    U, V, d = want
    for g, w, b in ((got.U.T, U, state.U.T), (got.V.T, V, state.V.T), (got.d, d, state.d)):
        assert oracles.delta_error(g, w, b) < TOL


@pytest.mark.parametrize("n,r,seed", [(1000, 4, 1), (10000, 10, 2), (300, 3, 4), (8192, 16, 5)])
def test_update_matches_oracle(n, r, seed):
    state, v, h, k = _case(n, r, seed)
    got = jax.jit(partial(lra.update, step=0.05))(state, v, h, key=k)
    _assert_matches(got, state, _oracle(state, v, h, k))


def _balance_key():
    for i in range(3000):
        cand = jax.random.PRNGKey(100000 + i)
        if _branches(cand)[0]:
            return cand
    raise AssertionError("no key fires the 1% rebalance in 3000 tries")


def test_update_matches_oracle_on_balance_branch():
    """A key whose first split fires the 1% rebalance, on factors whose
    ranges differ (rho != 1)."""
    kk = _balance_key()
    state, v, h, _ = _case(500, 5, 9)
    state = lra.pack(state.U * 3.0, state.V, state.d)
    got = lra.update(state, v, h, 0.05, kk)
    _assert_matches(got, state, _oracle(state, v, h, kk))


def test_update_covers_both_uv_branches():
    """Across seeds both the U-branch and the V-branch run and match."""
    state, v, h, _ = _case(400, 4, 3)
    upd = jax.jit(partial(lra.update, step=0.05))
    hit = set()
    for seed in range(6):
        k = jax.random.PRNGKey(seed)
        hit.add(_branches(k)[1])
        _assert_matches(upd(state, v, h, key=k), state, _oracle(state, v, h, k))
    assert hit == {True, False}


@pytest.mark.parametrize("n,r,seed", [(64, 4, 2), (100, 5, 2), (257, 3, 2), (48, 4, 5)])
def test_update_apply_matches_oracle(n, r, seed):
    """update() then apply(): the new state and P' g of the NEW state."""
    key = jax.random.PRNGKey(seed)
    st = lra.init(key, n, rank=r)
    v, h, g = (jax.random.normal(jax.random.fold_in(key, i), (n,)) for i in (1, 2, 3))
    k_up = jax.random.fold_in(key, 4)

    def update_apply(st, v, h, g, k):
        new = lra.update(st, v, h, step=0.05, key=k)
        return new, lra.apply(new, g)

    got, pre = jax.jit(update_apply)(st, v, h, g, k_up)
    want = _oracle(st, v, h, k_up)
    _assert_matches(got, st, want)
    assert oracles.rel_error(pre, oracles.lra_apply(*want, np.asarray(g, np.float64))) < 1e-5
