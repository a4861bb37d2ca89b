"""Property tests for every preconditioner family.

Per SURVEY.md §4: P = Q^T Q SPD-ness, apply == materialized P @ g, one
update step decreases the PSGD fitting criterion
c(Q) = h^T P h + v^T P^{-1} v on a fixed (v, h) pair, and structural
invariants (triangularity, X-center, arrow zeros).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psgd_tf_tpu.groups import dense, diag, kron, lra, shift, splu, xmat

N = 24


def _vh(key, n=N):
    kv, kh = jax.random.split(key)
    v = jax.random.normal(kv, (n,))
    # synthesize h = H v for a fixed SPD-ish H so the criterion has a minimum
    kH = jax.random.PRNGKey(99)
    M = jax.random.normal(kH, (n, n)) / np.sqrt(n)
    H = M @ M.T + 0.1 * jnp.eye(n)
    return v, H @ v


def criterion(P, v, h):
    """h^T P h + v^T P^{-1} v — what each Lie-group step must decrease."""
    return float(h @ (P @ h) + v @ jnp.linalg.solve(P, v))


FLAT_FAMILIES = {
    "dense": lambda: dense.init(N, 0.7),
    "diag": lambda: diag.init(N, 0.7),
    "xmat": lambda: xmat.init(N, 0.7),
    "xmat_odd": lambda: xmat.init(N + 1, 0.7),
    "shift": lambda: shift.init(N, 0.7),
    "shift_odd": lambda: shift.init(N + 1, 0.7),
    "splu": lambda: splu.init(N, rank=6, init_scale=0.7),
    "lra": lambda: lra.init(jax.random.PRNGKey(7), N, rank=4, init_scale=0.7),
}


def _module(name):
    return {"dense": dense, "diag": diag, "xmat": xmat, "xmat_odd": xmat,
            "shift": shift, "shift_odd": shift, "splu": splu, "lra": lra}[name]


def _n(name):
    return N + 1 if name.endswith("_odd") else N


@pytest.mark.parametrize("name", sorted(FLAT_FAMILIES))
def test_apply_matches_materialized(name):
    mod = _module(name)
    state = FLAT_FAMILIES[name]()
    n = _n(name)
    g = jax.random.normal(jax.random.PRNGKey(1), (n,))
    # perturb the state away from (scaled) identity first
    key = jax.random.PRNGKey(2)
    v, h = _vh(key, n)
    state = mod.update(state, v, h, step=0.05, key=jax.random.PRNGKey(3))
    P = mod.materialize(state)
    np.testing.assert_allclose(
        np.asarray(mod.apply(state, g)), np.asarray(P @ g), rtol=2e-4, atol=2e-4
    )


@pytest.mark.parametrize("name", sorted(FLAT_FAMILIES))
def test_update_decreases_criterion(name):
    mod = _module(name)
    state = FLAT_FAMILIES[name]()
    n = _n(name)
    v, h = _vh(jax.random.PRNGKey(11), n)
    c0 = criterion(mod.materialize(state), v, h)
    for i in range(20):
        state = mod.update(state, v, h, step=0.1, key=jax.random.PRNGKey(100 + i))
    c1 = criterion(mod.materialize(state), v, h)
    assert c1 < c0, f"{name}: criterion {c0} -> {c1}"


@pytest.mark.parametrize("name", sorted(FLAT_FAMILIES))
def test_P_is_spd(name):
    mod = _module(name)
    state = FLAT_FAMILIES[name]()
    n = _n(name)
    v, h = _vh(jax.random.PRNGKey(21), n)
    for i in range(5):
        state = mod.update(state, v, h, step=0.05, key=jax.random.PRNGKey(200 + i))
    P = np.asarray(mod.materialize(state))
    np.testing.assert_allclose(P, P.T, rtol=1e-4, atol=1e-5)
    eigs = np.linalg.eigvalsh(P)
    assert eigs.min() > 0, f"{name}: P not PD, min eig {eigs.min()}"


def _half_families(dtype):
    return {
        "dense": lambda: dense.init(N, 0.7, dtype=dtype),
        "diag": lambda: diag.init(N, 0.7, dtype=dtype),
        "xmat": lambda: xmat.init(N, 0.7, dtype=dtype),
        "shift": lambda: shift.init(N, 0.7, dtype=dtype),
        "splu": lambda: splu.init(N, rank=6, init_scale=0.7, dtype=dtype),
        "lra": lambda: lra.init(
            jax.random.PRNGKey(7), N, rank=4, init_scale=0.7, dtype=dtype
        ),
    }


BF16_FAMILIES = _half_families(jnp.bfloat16)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16], ids=str)
@pytest.mark.parametrize("name", sorted(BF16_FAMILIES))
def test_half_precision_update_decreases_criterion(name, dtype):
    """Half-precision states (ref Note 3, :657-658, which names fp16
    specifically): solves run in fp32 internally, statistical work stays
    in the half dtype; trajectories must still fit."""
    mod = _module(name)
    state = _half_families(dtype)[name]()
    v, h = _vh(jax.random.PRNGKey(11))
    v16, h16 = v.astype(dtype), h.astype(dtype)
    c0 = criterion(mod.materialize(state).astype(jnp.float32), v, h)
    for i in range(20):
        state = mod.update(state, v16, h16, step=0.1, key=jax.random.PRNGKey(100 + i))
    # dtype must be preserved end to end (no silent fp32 promotion)
    for leaf in jax.tree_util.tree_leaves(state):
        assert leaf.dtype == dtype, (name, leaf.dtype)
    c1 = criterion(mod.materialize(state).astype(jnp.float32), v, h)
    assert np.isfinite(c1) and c1 < c0, f"{name}: criterion {c0} -> {c1}"
    g = jax.random.normal(jax.random.PRNGKey(5), (N,), dtype)
    pre = mod.apply(state, g)
    assert pre.dtype == dtype
    assert bool(jnp.all(jnp.isfinite(pre.astype(jnp.float32))))


def test_bf16_kron_update_decreases_criterion():
    m, n = 12, 8
    fmts = [("dense", "dense"), ("norm", "dense"), ("dense", "scale"), ("norm", "scale")]
    rng = np.random.default_rng(9)
    for fmt in fmts:
        state = kron.init((m, n), fmt=fmt, init_scale=0.7, dtype=jnp.bfloat16)
        dX = jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16)
        dG = jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16)
        for _ in range(10):
            state = kron.update(state, dX, dG, step=0.1)
        assert state.ql.dtype == jnp.bfloat16 and state.qr.dtype == jnp.bfloat16
        pre = kron.apply(state, dG)
        assert pre.dtype == jnp.bfloat16
        assert bool(jnp.all(jnp.isfinite(pre.astype(jnp.float32)))), fmt


def test_dense_update_matches_naive_reference_formula():
    """The O(n^2) cumsum path must equal the reference's O(n^3) formula."""
    from psgd_tf_tpu.ops import linalg

    state = dense.init(N, 0.9)
    v, h = _vh(jax.random.PRNGKey(31))
    q = state.Q
    a = q @ h
    b = linalg.solve_ut_t(q, v)
    grad = jnp.triu(jnp.outer(a, a) - jnp.outer(b, b))
    step0 = 0.1 / (jnp.max(jnp.abs(grad)) + linalg.tiny(q.dtype))
    q_naive = q - step0 * (grad @ q)
    q_fast = dense.update(state, v, h, step=0.1).Q
    np.testing.assert_allclose(np.asarray(q_fast), np.asarray(q_naive), rtol=2e-4, atol=2e-5)


def test_dense_Q_stays_triangular():
    state = dense.init(N)
    for i in range(3):
        v, h = _vh(jax.random.PRNGKey(40 + i))
        state = dense.update(state, v, h, step=0.1)
    np.testing.assert_allclose(np.asarray(state.Q), np.triu(np.asarray(state.Q)))


def test_xmat_center_stays_zero_odd_n():
    n = N + 1
    state = xmat.init(n)
    for i in range(5):
        v, h = _vh(jax.random.PRNGKey(50 + i), n)
        state = xmat.update(state, v, h, step=0.1)
    assert float(state.b[n // 2]) == 0.0


def test_xmat_inverse_transpose_identity():
    """Internal Q^{-T} closed form: Q^T (Q^{-T} v) == v."""
    n = N
    state = xmat.init(n, 0.8)
    v, h = _vh(jax.random.PRNGKey(61), n)
    state = xmat.update(state, v, h, step=0.2)
    a, b = state.a, state.b
    det = a * jnp.flip(a) - b * jnp.flip(b)
    w = (jnp.flip(a) * v - jnp.flip(b) * jnp.flip(v)) / det
    qt_w = a * w + jnp.flip(b) * jnp.flip(w)
    np.testing.assert_allclose(np.asarray(qt_w), np.asarray(v), rtol=1e-4, atol=1e-5)


def test_shift_center_stays_zero_odd_n():
    n = N + 1
    state = shift.init(n)
    for i in range(5):
        v, h = _vh(jax.random.PRNGKey(50 + i), n)
        state = shift.update(state, v, h, step=0.1)
    assert float(state.b[n - 1]) == 0.0  # center is the LAST index (shift.py)


def test_shift_couples_half_shift_partners():
    """Q's off-diagonal pattern must be exactly {(i, (i + n//2) mod n)} —
    the butterfly pairing, not xmat's mirror pairing."""
    n = N
    m = n // 2
    state = shift.init(n, 0.8)
    v, h = _vh(jax.random.PRNGKey(81), n)
    state = shift.update(state, v, h, step=0.2)
    x = jax.random.normal(jax.random.PRNGKey(82), (n,))
    qx = shift.matvec(state, x)
    expected = state.a * x + state.b * jnp.roll(x, -m)
    np.testing.assert_allclose(np.asarray(qx), np.asarray(expected), rtol=1e-5, atol=1e-6)


def test_diag_closed_form_reaches_equilibration():
    n = N
    state = diag.init(n)
    v = jax.random.normal(jax.random.PRNGKey(71), (n,))
    h = 4.0 * v  # H = 4 I  =>  q* = 1/2
    for _ in range(200):
        state = diag.closed_form_update(state, v, h, step=0.1)
    np.testing.assert_allclose(np.asarray(state.q), 0.5, rtol=1e-3)


def test_lra_woodbury_matches_dense_inverse():
    """invPv computed via Woodbury inside lra.update must satisfy P invPv = v.
    Verified indirectly: after updates, apply() matches materialized P."""
    state = lra.init(jax.random.PRNGKey(81), N, rank=3, init_scale=1.1)
    P = np.asarray(lra.materialize(state))
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(82), (N,)))
    np.testing.assert_allclose(
        np.asarray(lra.apply(state, jnp.asarray(g))), P @ g, rtol=1e-4, atol=1e-5
    )
    iP = np.linalg.inv(P)
    v = np.asarray(jax.random.normal(jax.random.PRNGKey(83), (N,)))
    # reproduce the update's Woodbury solve chain ((n, r) column layout;
    # the state stores rank-major (r, n), so transpose at the boundary)
    U, V, d = state.U.T, state.V.T, state.d
    IpVtU = jnp.eye(3) + V.T @ U
    invQtv = jnp.asarray(v) / d
    invQtv = invQtv - V @ jax.scipy.linalg.solve(IpVtU.T, U.T @ invQtv)
    invPv = invQtv - U @ jax.scipy.linalg.solve(IpVtU, V.T @ invQtv)
    invPv = invPv / d
    np.testing.assert_allclose(np.asarray(invPv), iP @ v, rtol=1e-4, atol=1e-5)


def test_splu_blocks_keep_structure():
    state = splu.init(N, rank=6)
    v, h = _vh(jax.random.PRNGKey(91))
    for i in range(3):
        state = splu.update(state, v, h, step=0.1)
    r = state.rank
    L1 = np.asarray(state.L12[:r])
    U1 = np.asarray(state.U12[:, :r])
    np.testing.assert_allclose(L1, np.tril(L1))
    np.testing.assert_allclose(U1, np.triu(U1))


# ----------------------------------------------------------------- kron

KRON_SHAPE = (11, 15)
KRON_FMTS = [
    ("dense", "dense"),
    ("norm", "dense"),
    ("dense", "norm"),
    ("dense", "scale"),
    ("scale", "dense"),
    ("norm", "scale"),
    ("scale", "norm"),
]


def _kron_vh(key, shape=KRON_SHAPE):
    kv, kh = jax.random.split(key)
    dX = jax.random.normal(kv, shape)
    # h = "H dX" with a separable-ish curvature so updates converge
    Hl = jnp.eye(shape[0]) * 2.0
    Hr = jnp.eye(shape[1]) * 0.5
    dG = Hl @ dX @ Hr + 0.3 * dX
    return dX, dG


@pytest.mark.parametrize("fmt", KRON_FMTS, ids=["_".join(f) for f in KRON_FMTS])
def test_kron_apply_matches_materialized(fmt):
    state = kron.init(KRON_SHAPE, fmt=fmt, init_scale=0.9)
    dX, dG = _kron_vh(jax.random.PRNGKey(1))
    state = kron.update(state, dX, dG, step=0.05)
    Ql, Qr = kron.materialize(state)
    G = jax.random.normal(jax.random.PRNGKey(2), KRON_SHAPE)
    expected = (Ql.T @ Ql) @ G @ (Qr.T @ Qr)
    np.testing.assert_allclose(
        np.asarray(kron.apply(state, G)), np.asarray(expected), rtol=2e-4, atol=2e-4
    )


@pytest.mark.parametrize("fmt", KRON_FMTS, ids=["_".join(f) for f in KRON_FMTS])
def test_kron_update_decreases_criterion(fmt):
    state = kron.init(KRON_SHAPE, fmt=fmt, init_scale=0.9)
    dX, dG = _kron_vh(jax.random.PRNGKey(3))
    x = dX.reshape(-1)

    def crit(state):
        Ql, Qr = kron.materialize(state)
        g = np.asarray(dG.reshape(-1))
        # P acts as G -> Pl G Pr; use apply() for the P g term and dense
        # solves for the P^{-1} v term
        Pg = np.asarray(kron.apply(state, dG).reshape(-1))
        Ql_, Qr_ = np.asarray(Ql), np.asarray(Qr)
        Pl = Ql_.T @ Ql_
        Pr = Qr_.T @ Qr_
        iPx = np.linalg.solve(Pl, np.asarray(dX)) @ np.linalg.inv(Pr)
        return float(g @ Pg + np.asarray(x) @ iPx.reshape(-1))

    c0 = crit(state)
    for _ in range(20):
        state = kron.update(state, dX, dG, step=0.1)
    c1 = crit(state)
    assert c1 < c0, f"{fmt}: criterion {c0} -> {c1}"


def test_kron_mirror_equivalence():
    """(dense, norm) on G must equal (norm, dense) on G^T, transposed —
    the reference's transpose-mirroring (ref :86 vs :94)."""
    m, n = KRON_SHAPE
    dX, dG = _kron_vh(jax.random.PRNGKey(5))
    s_nd = kron.init((m, n), fmt=("norm", "dense"), init_scale=0.9)
    s_dn = kron.init((n, m), fmt=("dense", "norm"), init_scale=0.9)
    s_nd = kron.update(s_nd, dX, dG, step=0.1)
    s_dn = kron.update(s_dn, dX.T, dG.T, step=0.1)
    np.testing.assert_allclose(np.asarray(s_nd.ql), np.asarray(s_dn.qr), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s_nd.qr), np.asarray(s_dn.ql), rtol=1e-5)
    G = jax.random.normal(jax.random.PRNGKey(6), (m, n))
    np.testing.assert_allclose(
        np.asarray(kron.apply(s_nd, G)),
        np.asarray(kron.apply(s_dn, G.T).T),
        rtol=1e-5,
        atol=1e-6,
    )


def test_kron_rejects_unsupported_pairs():
    with pytest.raises(ValueError):
        kron.init((4, 4), fmt=("norm", "norm"))
    with pytest.raises(ValueError):
        kron.init((4, 4), fmt=("scale", "scale"))


def test_kron_auto_format():
    assert kron.auto_format((64, 64)) == ("dense", "dense")
    assert kron.auto_format((2000, 64)) == ("norm", "dense")
    assert kron.auto_format((64, 2000)) == ("dense", "scale")
    assert kron.auto_format((2000, 2000)) == ("norm", "scale")


# ------------------------------------------------ splu at a wider state

def _splu_wide_case(n, r, seed):
    from psgd_tf_tpu import oracles

    Lt, l3, U12, u3 = oracles.random_splu(np.random.default_rng(seed), n, r)
    st = splu.SpLUState(Lt=jnp.asarray(Lt), l3=jnp.asarray(l3),
                        U12=jnp.asarray(U12), u3=jnp.asarray(u3))
    key = jax.random.PRNGKey(seed)
    v, h, g = (jax.random.normal(jax.random.fold_in(key, i), (n,)) for i in range(3))
    return st, v, h, g


def test_splu_wide_update_matches_oracle():
    """A 3000-parameter rank-5 state: the block algebra against the dense
    float64 oracle, every block measured against the size of the step."""
    from psgd_tf_tpu import oracles

    n, r = 3000, 5
    st, v, h, _ = _splu_wide_case(n, r, 0)
    got = jax.jit(lambda s, v, h: splu.update(s, v, h, step=0.05))(st, v, h)
    f64 = lambda x: np.asarray(x, np.float64)
    want = oracles.splu_blocks(*oracles.splu_oracle(
        *oracles.splu_dense(st), r, f64(v), f64(h), 0.05), r)
    base = oracles.splu_blocks(*oracles.splu_dense(st), r)
    scale = max(np.abs(w - b).max() for w, b in zip(want, base))
    for g, w in zip((got.Lt, got.l3, got.U12, got.u3), want):
        assert np.abs(f64(g) - w).max() / scale < 1e-3


def test_splu_wide_apply_matches_materialized():
    """At n = 3000, apply() of an updated state equals the materialized
    P' g."""
    n, r = 3000, 5
    st, v, h, g = _splu_wide_case(n, r, 3)
    ref = jax.jit(lambda s, v, h: splu.update(s, v, h, step=0.05))(st, v, h)
    pre = jax.jit(splu.apply)(ref, g)
    P = np.asarray(splu.materialize(ref), np.float64)
    want = P @ np.asarray(g, np.float64)
    assert np.abs(np.asarray(pre) - want).max() / np.abs(want).max() < 1e-4
