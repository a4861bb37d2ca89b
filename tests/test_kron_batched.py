"""Batched (dense, dense) Kron path: parity vs the per-layer ops.

The batched path (groups/kron.py BatchedDDState) stacks layers of one
shape and vmaps the per-layer update and apply; every result must match
the per-layer path to fp32 tolerance, including through the full
optimizer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psgd_tf_tpu import PSGD, oracles
from psgd_tf_tpu.groups import kron
from psgd_tf_tpu.optim.psgd import KronPrecond

SHAPE, COUNT = (121, 84), 4
# the optimizer buckets layers of identical shape
BUCKET_SHAPES = [(26, 6), (26, 6), (85, 10), (85, 10)]


def _probes(key, shapes, salt=0):
    return (
        [jax.random.normal(jax.random.fold_in(key, 2 * i + salt), s) for i, s in enumerate(shapes)],
        [jax.random.normal(jax.random.fold_in(key, 999 + i + salt), s) for i, s in enumerate(shapes)],
    )


def test_update_batched_matches_per_layer():
    key = jax.random.PRNGKey(0)
    shapes = [SHAPE] * COUNT
    bst = kron.init_batched(SHAPE, COUNT)
    singles = [kron.init(s, ("dense", "dense")) for s in shapes]
    for it in range(4):
        dXs, dGs = _probes(key, shapes, salt=it)
        bst = kron.update_batched(bst, dXs, dGs, step=0.1)
        singles = [
            kron.update(s, x, g, step=0.1)
            for s, x, g in zip(singles, dXs, dGs)
        ]
    for u, s in zip(kron.unbatch(bst), singles):
        np.testing.assert_allclose(u.ql, s.ql, atol=2e-5)
        np.testing.assert_allclose(u.qr, s.qr, atol=2e-5)


def test_apply_batched_matches_per_layer():
    key = jax.random.PRNGKey(1)
    shapes = [SHAPE] * COUNT
    bst = kron.init_batched(SHAPE, COUNT)
    dXs, dGs = _probes(key, shapes)
    bst = kron.update_batched(bst, dXs, dGs, step=0.2)
    singles = kron.unbatch(bst)
    pre_b = kron.apply_batched(bst, dGs)
    for p, s, g in zip(pre_b, singles, dGs):
        np.testing.assert_allclose(p, kron.apply(s, g), atol=2e-4)


@pytest.mark.parametrize("shape", [(26, 6), (121, 84)])
def test_vmapped_update_matches_oracle(shape):
    """The vmapped update, each stacked layer against the float64 oracle."""
    key = jax.random.PRNGKey(2)
    shapes = [shape] * 3
    bst = kron.init_batched(shape, len(shapes), init_scale=0.8)
    dXs, dGs = _probes(key, shapes)
    new = jax.jit(lambda b, x, g: kron.update_batched(b, x, g, step=0.1))(bst, dXs, dGs)
    m, n = shape
    q0l, q0r = 0.8 * np.eye(m), 0.8 * np.eye(n)
    for i in range(len(shapes)):
        want = oracles.kron_oracle(("dense", "dense"), q0l, q0r,
                                   np.asarray(dXs[i], np.float64),
                                   np.asarray(dGs[i], np.float64), 0.1)
        for got, w, b in ((new.ql[i], want[0], q0l), (new.qr[i], want[1], q0r)):
            assert oracles.delta_error(got, w, b) < 1e-3


@pytest.mark.parametrize("formats", [
    [("dense", "dense")] * 4,
    [("scale", "dense")] + [("dense", "dense")] * 3,
])
def test_optimizer_batched_trajectory_matches_unbatched(formats):
    key = jax.random.PRNGKey(3)
    params = [
        0.1 * jax.random.normal(jax.random.fold_in(key, i), s)
        for i, s in enumerate(BUCKET_SHAPES)
    ]

    def loss(p):
        return sum(jnp.sum(w * w) * 0.5 + jnp.sum(jnp.sin(w)) for w in p)

    def run(batched):
        opt = PSGD(
            preconditioner="kron", kron_formats=formats,
            lr_params=0.05, lr_preconditioner=0.1,
            kron_batched=batched, kron_batch_min=2,
        )
        state = opt.init(params, key)
        if batched:
            assert isinstance(state.precond, KronPrecond)
        p = params
        k = jax.random.PRNGKey(7)
        step = jax.jit(lambda p, s, k: opt.step(loss, p, s, k))
        for _ in range(10):
            k, sub = jax.random.split(k)
            p, state, aux = step(p, state, sub)
        return p, aux["loss"]

    pb, lb = run(True)
    pu, lu = run(False)
    for a, b in zip(pb, pu):
        np.testing.assert_allclose(a, b, atol=5e-5)
    np.testing.assert_allclose(lb, lu, rtol=1e-5)


def test_bucket_threshold_respected():
    params = [jnp.ones(s) for s in [(20, 6), (30, 8)]]
    opt = PSGD(preconditioner="kron", kron_formats=[("dense", "dense")] * 2,
               kron_batch_min=4)
    state = opt.init(params, jax.random.PRNGKey(0))
    # bucket of 2 < kron_batch_min=4: falls back to the plain list path
    assert isinstance(state.precond, list)
