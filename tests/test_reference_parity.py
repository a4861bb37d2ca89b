"""HEAD-TO-HEAD parity against the actual reference implementation.

TensorFlow is available in this image, so beyond the independent float64
oracles (test_golden.py) we can run the reference's own update/apply
functions (/root/reference/preconditioned_stochastic_gradient_descent.py)
eagerly on CPU and compare multi-step fp32 trajectories directly, probes
injected. This is the strongest parity evidence available: same inputs,
the reference's exact TF code vs this library's JAX paths.

The UVd update draws its two coins internally via tf.random.uniform
(ref :562, :588); the test replicates OUR PRNG branch decisions by
scripting those draws (monkeypatched), exactly like test_golden.py
replicates them for the float64 oracle.

Our side runs the XLA paths on the CPU.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psgd_tf_tpu.groups import dense, kron, lra, splu

tf = pytest.importorskip("tensorflow")

sys.path.insert(0, "/root/reference")
ref = pytest.importorskip(
    "preconditioned_stochastic_gradient_descent",
    reason="the reference TF implementation is not on sys.path",
)

STEPS = 20
REL = 5e-4


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / (np.abs(want).max() + 1e-30)


def _probes(seed, n, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal(n).astype(np.float32),
         rng.standard_normal(n).astype(np.float32))
        for _ in range(steps)
    ]


def test_dense_trajectory_matches_reference_tf():
    n = 24
    state = dense.init(n, init_scale=0.5)
    Q_tf = tf.constant(np.asarray(state.Q))
    for v, h in _probes(0, n):
        state = dense.update(state, jnp.asarray(v), jnp.asarray(h), step=0.05)
        Q_tf = ref.update_precond_dense(
            Q_tf, [tf.constant(v)], [tf.constant(h)],
            step=tf.constant(0.05, tf.float32),
        )
    assert _rel_err(state.Q, Q_tf.numpy()) < REL

    g = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    ours = dense.apply(state, jnp.asarray(g))
    theirs = ref.precond_grad_dense(Q_tf, [tf.constant(g)])[0]
    assert _rel_err(ours, theirs.numpy()) < REL


_KRON_FMTS = [
    ("dense", "dense"),
    ("norm", "dense"),
    ("dense", "scale"),
    ("norm", "scale"),
    ("dense", "norm"),   # transpose-mirror branches of the ref dispatcher
    ("scale", "dense"),
    ("scale", "norm"),
]


def _factor_to_tf(fmt, q):
    """Our factor -> the reference's (shape-sniffed) representation:
    dense (d, d); norm (2, d); scale (1, d)."""
    q = np.asarray(q)
    return tf.constant(q[None, :] if fmt == "scale" else q)


def _factor_from_tf(fmt, q):
    q = q.numpy()
    return q[0] if fmt == "scale" else q


@pytest.mark.parametrize("fmt", _KRON_FMTS, ids=str)
def test_kron_trajectory_matches_reference_tf(fmt):
    m, n = 11, 9
    state = kron.init((m, n), fmt=fmt, init_scale=0.8)
    ql_tf = _factor_to_tf(fmt[0], state.ql)
    qr_tf = _factor_to_tf(fmt[1], state.qr)
    rng = np.random.default_rng(3)
    for _ in range(STEPS):
        dX = rng.standard_normal((m, n)).astype(np.float32)
        dG = rng.standard_normal((m, n)).astype(np.float32)
        state = kron.update(state, jnp.asarray(dX), jnp.asarray(dG), step=0.05)
        ql_tf, qr_tf = ref.update_precond_kron(
            ql_tf, qr_tf, tf.constant(dX), tf.constant(dG),
            step=tf.constant(0.05, tf.float32),
        )
    assert _rel_err(state.ql, _factor_from_tf(fmt[0], ql_tf)) < REL, fmt
    assert _rel_err(state.qr, _factor_from_tf(fmt[1], qr_tf)) < REL, fmt

    g = np.random.default_rng(4).standard_normal((m, n)).astype(np.float32)
    ours = kron.apply(state, jnp.asarray(g))
    theirs = ref.precond_grad_kron(ql_tf, qr_tf, tf.constant(g))
    assert _rel_err(ours, theirs.numpy()) < REL, fmt


def test_splu_trajectory_matches_reference_tf():
    n, r = 24, 6
    state = splu.init(n, rank=r, init_scale=0.6)
    L12_tf = tf.constant(np.asarray(state.Lt.T))
    l3_tf = tf.constant(np.asarray(state.l3)[:, None])
    U12_tf = tf.constant(np.asarray(state.U12))
    u3_tf = tf.constant(np.asarray(state.u3)[:, None])
    for v, h in _probes(5, n):
        state = splu.update(state, jnp.asarray(v), jnp.asarray(h), step=0.05)
        L12_tf, l3_tf, U12_tf, u3_tf = ref.update_precond_splu(
            L12_tf, l3_tf, U12_tf, u3_tf,
            [tf.constant(v)], [tf.constant(h)],
            step=tf.constant(0.05, tf.float32),
        )
    assert _rel_err(state.Lt.T, L12_tf.numpy()) < REL
    assert _rel_err(state.l3, l3_tf.numpy()[:, 0]) < REL
    assert _rel_err(state.U12, U12_tf.numpy()) < REL
    assert _rel_err(state.u3, u3_tf.numpy()[:, 0]) < REL

    g = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    ours = splu.apply(state, jnp.asarray(g))
    theirs = ref.precond_grad_splu(L12_tf, l3_tf, U12_tf, u3_tf, [tf.constant(g)])[0]
    assert _rel_err(ours, theirs.numpy().reshape(-1)) < REL


def test_uvd_trajectory_matches_reference_tf(monkeypatch):
    n, r = 24, 4
    key = jax.random.PRNGKey(7)
    state = lra.init(key, n, rank=r)
    # reference keeps (n, r) column factors and column vectors
    U_tf = tf.Variable(np.asarray(state.U.T))
    V_tf = tf.Variable(np.asarray(state.V.T))
    d_tf = tf.Variable(np.asarray(state.d)[:, None])

    # script the reference's internal coins to OUR branch decisions
    scripted = []
    orig_uniform = tf.random.uniform

    def fake_uniform(shape, *a, **k):
        if len(scripted) and tuple(shape) == ():
            return tf.constant(scripted.pop(0), tf.float32)
        return orig_uniform(shape, *a, **k)

    monkeypatch.setattr(tf.random, "uniform", fake_uniform)

    step_key = jax.random.PRNGKey(11)
    for v, h in _probes(8, n):
        step_key, k = jax.random.split(step_key)
        k_bal, k_uv = jax.random.split(k)
        balance = bool(jax.random.uniform(k_bal, dtype=jnp.float32) < 0.01)
        update_u = bool(jax.random.uniform(k_uv, dtype=jnp.float32) < 0.5)
        scripted.extend([0.0 if balance else 0.5, 0.3 if update_u else 0.7])
        state = lra.update(state, jnp.asarray(v), jnp.asarray(h), step=0.05, key=k)
        ref.update_precond_UVd_math_(
            U_tf, V_tf, d_tf,
            tf.constant(v[:, None]), tf.constant(h[:, None]),
            step=tf.constant(0.05, tf.float32), tiny=ref._tiny,
        )
    assert _rel_err(state.U.T, U_tf.numpy()) < 2e-3
    assert _rel_err(state.V.T, V_tf.numpy()) < 2e-3
    assert _rel_err(state.d, d_tf.numpy()[:, 0]) < 2e-3

    g = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    ours = lra.apply(state, jnp.asarray(g))
    theirs = ref.precond_grad_UVd_math(U_tf, V_tf, d_tf, tf.constant(g[:, None]))
    assert _rel_err(ours, theirs.numpy()[:, 0]) < 2e-3


def test_uvd_class_end_to_end_matches_reference_tf(monkeypatch):
    """FULL-STACK parity: the reference's class UVd (closure, the
    reverse-over-reverse double-tape Hvp, flatten/unflatten, lr plumbing,
    ref :692-764) against our functional PSGD with exact Hvp, on an
    identical quadratic with identical probes/coins (scripted)."""
    import psgd_tf_tpu as psgd
    from functools import partial

    n, r = 12, 4
    rng = np.random.default_rng(13)
    A_np = (rng.standard_normal((n, n)) / n**0.5).astype(np.float32)
    A_np = A_np @ A_np.T + 0.5 * np.eye(n, dtype=np.float32)
    b_np = rng.standard_normal(n).astype(np.float32)
    x0 = rng.standard_normal(n).astype(np.float32)

    # ---- ours: functional PSGD, exact Hvp, always-update
    opt = psgd.PSGD(preconditioner="lra", rank=r, lr_params=0.1,
                    lr_preconditioner=0.1)
    params = {"x": jnp.asarray(x0)}
    state = opt.init(params, jax.random.PRNGKey(0))

    def loss_fn(p):
        return 0.5 * p["x"] @ (jnp.asarray(A_np) @ p["x"]) - jnp.asarray(b_np) @ p["x"]

    step = jax.jit(partial(opt.step, loss_fn))

    # ---- theirs: class UVd with state forced to our init and RNG scripted
    x_tf = tf.Variable(tf.constant(x0))
    theirs = ref.UVd([x_tf], rank_of_modification=r,
                     lr_params=0.1, lr_preconditioner=0.1)
    theirs._U.assign(tf.constant(np.asarray(state.precond.U.T)))
    theirs._V.assign(tf.constant(np.asarray(state.precond.V.T)))
    theirs._d.assign(tf.constant(np.asarray(state.precond.d)[:, None]))
    A_tf, b_tf = tf.constant(A_np), tf.constant(b_np)

    def closure():
        return 0.5 * tf.tensordot(x_tf, tf.linalg.matvec(A_tf, x_tf), 1) - tf.tensordot(b_tf, x_tf, 1)

    scripted_u, scripted_n = [], []
    orig_uniform, orig_normal = tf.random.uniform, tf.random.normal

    def fake_uniform(shape, *a, **k):
        if len(scripted_u) and tuple(shape) == ():
            return tf.constant(scripted_u.pop(0), tf.float32)
        return orig_uniform(shape, *a, **k)

    def fake_normal(shape, *a, **k):
        if len(scripted_n) and tuple(shape) == (n,):
            return tf.constant(scripted_n.pop(0))
        return orig_normal(shape, *a, **k)

    monkeypatch.setattr(tf.random, "uniform", fake_uniform)
    monkeypatch.setattr(tf.random, "normal", fake_normal)

    key = jax.random.PRNGKey(42)
    for _ in range(20):
        key, sub = jax.random.split(key)
        # replicate OUR step's key splits (optim/psgd.py + groups/lra.py)
        k_coin, k_probe, k_prec = jax.random.split(sub, 3)
        k_bal, k_uv = jax.random.split(k_prec)
        v = np.asarray(jax.random.normal(k_probe, (n,), jnp.float32))
        balance = bool(jax.random.uniform(k_bal, dtype=jnp.float32) < 0.01)
        update_u = bool(jax.random.uniform(k_uv, dtype=jnp.float32) < 0.5)
        # ref draw order: update coin (:703), probe (:713), balance, U-vs-V
        scripted_u.extend([0.0, 0.0 if balance else 0.5, 0.3 if update_u else 0.7])
        scripted_n.append(v)

        params, state, aux = step(params, state, sub)
        theirs.step(closure)
        assert not scripted_u and not scripted_n  # all draws consumed

    assert _rel_err(params["x"], x_tf.numpy()) < 2e-3
    assert _rel_err(state.precond.U.T, theirs._U.numpy()) < 2e-3
    assert _rel_err(state.precond.d, theirs._d.numpy()[:, 0]) < 2e-3
