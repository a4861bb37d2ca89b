"""The kron family's XLA formulations against the float64 oracles
(`psgd_tf_tpu.oracles`) and the factors' structural invariants, at the
reference's layer-zoo shapes and at wide probe shapes past 10^4 lanes."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psgd_tf_tpu import oracles
from psgd_tf_tpu.groups import kron
from psgd_tf_tpu.models import nmt

TOL = 1e-3  # fp32 one-step error, measured against the size of the step
_upd = jax.jit(partial(kron.update, step=0.05))
_apply = jax.jit(kron.apply)


def _case(fmt, shape, seed):
    """A random kron state of `fmt` and a probe pair, as (state, dX, dG)."""
    rng = np.random.default_rng(seed)
    m, n = shape
    ql = oracles.random_kron_factor(rng, fmt[0], m)
    qr = oracles.random_kron_factor(rng, fmt[1], n)
    dX = rng.standard_normal(shape, dtype=np.float32)
    dG = rng.standard_normal(shape, dtype=np.float32)
    st = kron.KronState(ql=jnp.asarray(ql), qr=jnp.asarray(qr), fmt=fmt)
    return st, dX, dG


def _oracle_step(st, dX, dG, step=0.05):
    return oracles.kron_update(st.fmt, st.ql, st.qr, dX, dG, step)


def _assert_matches_oracle(st, dX, dG, tol=TOL, step=0.05):
    got = _upd(st, jnp.asarray(dX), jnp.asarray(dG)) if step == 0.05 else \
        kron.update(st, jnp.asarray(dX), jnp.asarray(dG), step=step)
    want = _oracle_step(st, dX, dG, step)
    for f, g, w, b in zip(st.fmt, (got.ql, got.qr), want, (st.ql, st.qr)):
        err = oracles.delta_error(oracles.factor_to_oracle(f, g), w,
                                  oracles.factor_to_oracle(f, b))
        assert err < tol, (st.fmt, f, err)
    return got


@pytest.mark.parametrize("shape", [(26, 6), (151, 16), (257, 120), (384, 384)])
def test_kron_dd_update_matches_oracle(shape):
    _assert_matches_oracle(*_case(("dense", "dense"), shape, seed=1))


def test_kron_dd_layer_zoo_matches_oracle():
    """The LeNet5 layer zoo plus an odd extra shape through update_multi,
    each layer against its oracle step."""
    shapes = [(26, 6), (151, 16), (401, 120), (121, 84), (85, 10), (7, 3)]
    cases = [_case(("dense", "dense"), s, seed=10 + i) for i, s in enumerate(shapes)]
    got = jax.jit(partial(kron.update_multi, step=0.05))(
        [c[0] for c in cases], [c[1] for c in cases], [c[2] for c in cases])
    for (st, dX, dG), g in zip(cases, got):
        want = _oracle_step(st, dX, dG)
        for gf, w, b in zip((g.ql, g.qr), want, (st.ql, st.qr)):
            assert oracles.delta_error(gf, w, b) < TOL


def test_kron_update_multi_matches_elementwise_updates():
    """update_multi (the optimizer's layer-list path) is element-wise
    update, format pairs mixed."""
    fmts = [("dense", "dense"), ("norm", "scale"), ("dense", "dense")]
    shapes = [(26, 6), (151, 16), (121, 84)]
    cases = [_case(f, s, seed=30 + i) for i, (f, s) in enumerate(zip(fmts, shapes))]
    got = kron.update_multi([c[0] for c in cases], [c[1] for c in cases],
                            [c[2] for c in cases], step=0.1)
    for (st, dX, dG), g in zip(cases, got):
        ref = kron.update(st, dX, dG, step=0.1)
        for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kron_dd_preserves_triangularity():
    st, dX, _ = _case(("dense", "dense"), (100, 60), seed=2)
    got = _upd(st, dX, dX)
    np.testing.assert_array_equal(np.asarray(jnp.tril(got.ql, -1)), 0.0)
    np.testing.assert_array_equal(np.asarray(jnp.tril(got.qr, -1)), 0.0)


@pytest.mark.parametrize("fmt", [("norm", "scale"), ("dense", "scale"), ("norm", "dense")], ids=str)
@pytest.mark.parametrize("shape", [(12, 8), (130, 65), (321, 128)])
def test_sparse_kron_update_matches_oracle(fmt, shape):
    _assert_matches_oracle(*_case(fmt, shape, seed=3))


def _arrow_last_zero(st, fmt):
    norm_side = st.ql if fmt[0] == "norm" else st.qr
    return float(norm_side[1, -1]) == 0.0


def test_sparse_kron_arrow_convention_preserved():
    """ql[1, -1] stays exactly 0 through the (norm, scale) update."""
    st, dX, dG = _case(("norm", "scale"), (37, 21), seed=5)
    assert _arrow_last_zero(kron.update(st, dX, dG, step=0.1), st.fmt)


@pytest.mark.parametrize("fmt,shape", [
    (("norm", "scale"), (700, 130)),
    (("norm", "scale"), (1030, 257)),
    (("norm", "scale"), (80, 34000)),
    (("norm", "scale"), (16, 140000)),
    (("norm", "dense"), (900, 70)),
    (("norm", "dense"), (1500, 200)),
    (("dense", "scale"), (130, 900)),
    (("dense", "scale"), (260, 1500)),
], ids=str)
def test_wide_sparse_kron_update_matches_oracle(fmt, shape):
    _assert_matches_oracle(*_case(fmt, shape, seed=31))


def test_wide_sparse_kron_arrow_convention_preserved():
    """ql[1, -1] stays exactly 0 through the (norm, scale) and
    (norm, dense) updates at taller shapes."""
    for fmt, shape in [(("norm", "scale"), (600, 96)), (("norm", "dense"), (600, 64))]:
        st, dX, dG = _case(fmt, shape, seed=33)
        assert _arrow_last_zero(kron.update(st, dX, dG, step=0.1), fmt), fmt


@pytest.mark.parametrize("fmt,shape", [
    (("norm", "scale"), (700, 130)),
    (("norm", "scale"), (80, 34000)),
    (("norm", "scale"), (1030, 257)),
    (("norm", "dense"), (900, 70)),
    (("norm", "dense"), (1500, 200)),
], ids=str)
def test_norm_apply_matches_oracle(fmt, shape):
    st, _, G = _case(fmt, shape, seed=41)
    got = _apply(st, jnp.asarray(G))
    want = oracles.kron_apply(oracles.factor_to_oracle(fmt[0], st.ql),
                              oracles.factor_to_oracle(fmt[1], st.qr),
                              np.asarray(G, np.float64))
    assert oracles.rel_error(got, want) < 1e-5


def test_kron_update_multi_mixed_formats_matches_oracle():
    """Every supported format pair, mirrors included, through update_multi."""
    fmts = [("dense", "dense"), ("norm", "dense"), ("dense", "norm"),
            ("dense", "scale"), ("scale", "dense"),
            ("norm", "scale"), ("scale", "norm")]
    shapes = [(26, 6), (100, 40), (40, 100), (64, 33), (33, 64), (50, 20), (20, 50)]
    cases = [_case(f, s, seed=60 + i) for i, (f, s) in enumerate(zip(fmts, shapes))]
    got = kron.update_multi([c[0] for c in cases], [c[1] for c in cases],
                            [c[2] for c in cases], step=0.05)
    for (st, dX, dG), g in zip(cases, got):
        want = _oracle_step(st, dX, dG)
        for f, gf, w, b in zip(st.fmt, (g.ql, g.qr), want, (st.ql, st.qr)):
            err = oracles.delta_error(oracles.factor_to_oracle(f, gf), w,
                                      oracles.factor_to_oracle(f, b))
            assert err < TOL, (st.fmt, err)


def test_wide_ns_mirror_is_the_transpose():
    """(scale, norm) on a (140000, 16) probe is (norm, scale) on its
    transpose, factor for factor."""
    st, dX, dG = _case(("norm", "scale"), (16, 140000), seed=41)
    mirror = kron.KronState(ql=st.qr, qr=st.ql, fmt=("scale", "norm"))
    a = kron.update(st, dX, dG, step=0.05)
    b = kron.update(mirror, dX.T, dG.T, step=0.05)
    np.testing.assert_allclose(np.asarray(a.ql), np.asarray(b.qr), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(a.qr), np.asarray(b.ql), rtol=1e-6, atol=1e-7)


def test_ns_wide_apply_matches_oracle():
    """(norm, scale) apply at a ragged wide shape."""
    st, _, G = _case(("norm", "scale"), (70, 140000), seed=3)
    got = _apply(st, jnp.asarray(G))
    want = oracles.kron_apply(oracles.factor_to_oracle("norm", st.ql),
                              np.asarray(st.qr, np.float64), np.asarray(G, np.float64))
    assert oracles.rel_error(got, want) < 1e-5


def test_wide_ns_update_from_init_matches_oracle():
    """(norm, scale) at a 140000-lane scale side, from the library's own
    init (balancing active: both factors start at 0.8)."""
    shape = (16, 140000)
    st = kron.init(shape, fmt=("norm", "scale"), init_scale=0.8)
    rng = np.random.default_rng(5)
    dX = rng.standard_normal(shape, dtype=np.float32)
    dG = rng.standard_normal(shape, dtype=np.float32)
    _assert_matches_oracle(st, dX, dG)


@pytest.mark.parametrize("step", [0.05, 0.2])
def test_nd_update_matches_oracle_tall(step):
    """(norm, dense) at (1024, 384): the right factor's triangular solve
    at a width where it dominates, at two step sizes."""
    _assert_matches_oracle(*_case(("norm", "dense"), (1024, 384), seed=11), step=step)


def test_nmt_ref_layer_formats():
    """The optimizer's kron state for the NMT at the reference's real
    dimensions: each layer carries the reference's format pair (ref
    :99-148) with factors of the right layout."""
    from psgd_tf_tpu import PSGD

    cfg = nmt.ref_config()
    params = [jax.ShapeDtypeStruct(s, jnp.float32) for s in nmt.layer_shapes(cfg)]
    opt = PSGD(preconditioner="kron", kron_formats=nmt.kron_formats(cfg))
    state = jax.eval_shape(lambda p: opt.init(p, jax.random.PRNGKey(0)), params)
    layout = {"dense": lambda d: (d, d), "norm": lambda d: (2, d), "scale": lambda d: (d,)}
    for ks, (m, n), fmt in zip(state.precond, nmt.layer_shapes(cfg), nmt.kron_formats(cfg)):
        assert ks.fmt == fmt
        assert ks.ql.shape == layout[fmt[0]](m) and ks.qr.shape == layout[fmt[1]](n)
