"""Sharding tests on the 8-device virtual CPU mesh (SURVEY.md §4c):
sharded-vs-single-device equivalence of each preconditioner family's
update/apply, and the full sharded training step."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import psgd_tf_tpu as psgd
from psgd_tf_tpu.groups import base
from psgd_tf_tpu.models import nmt
from psgd_tf_tpu.data import translation
from psgd_tf_tpu.parallel import (
    build_sharded_step,
    make_mesh,
    precond_sharding,
    state_sharding,
)

N = 64
RANK = 4


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=2, shard=4)


def _flat_state(family, key):
    fam = base.FLAT_FAMILIES[family]
    if family == "lra":
        return fam, fam.init(key, N, rank=RANK)
    if family == "splu":
        return fam, fam.init(N, rank=RANK)
    return fam, fam.init(N)


@pytest.mark.parametrize("family", ["dense", "diag", "xmat", "shift", "splu", "lra"])
def test_sharded_update_apply_matches_single_device(family, mesh):
    key = jax.random.PRNGKey(0)
    fam, state = _flat_state(family, key)
    v = jax.random.normal(jax.random.fold_in(key, 1), (N,))
    h = jax.random.normal(jax.random.fold_in(key, 2), (N,))
    g = jax.random.normal(jax.random.fold_in(key, 3), (N,))
    k_up = jax.random.fold_in(key, 4)

    def update_apply(state, v, h, g, k):
        st = fam.update(state, v, h, step=0.05, key=k)
        return st, fam.apply(st, g)

    ref_state, ref_out = jax.jit(update_apply)(state, v, h, g, k_up)

    sh = precond_sharding(mesh, state)
    vec_sh = NamedSharding(mesh, P("shard"))
    sharded = jax.jit(
        update_apply,
        in_shardings=(sh, vec_sh, vec_sh, vec_sh, NamedSharding(mesh, P())),
        out_shardings=(sh, vec_sh),
    )
    got_state, got_out = sharded(
        jax.device_put(state, sh),
        jax.device_put(v, vec_sh),
        jax.device_put(h, vec_sh),
        jax.device_put(g, vec_sh),
        k_up,
    )
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(ref_out), rtol=2e-5, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(got_state), jax.tree_util.tree_leaves(ref_state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["lra", "kron"])
def test_sharded_full_step_matches_single_device(family, mesh):
    cfg = nmt.Config(vocab_src=16, vocab_tgt=16, embed=8, units=16, attn=4)
    key = jax.random.PRNGKey(0)
    params = nmt.init(key, cfg)
    src, tgt = translation.batch(
        jax.random.fold_in(key, 1), 16, 8, content_vocab=13
    )
    kwargs = dict(lr_params=0.01, lr_preconditioner=0.01, grad_clip_max_norm=1.0)
    if family == "kron":
        opt = psgd.PSGD(preconditioner="kron", kron_formats=nmt.kron_formats(cfg), **kwargs)
    else:
        opt = psgd.PSGD(preconditioner="lra", rank=RANK, **kwargs)
    state = opt.init(params, jax.random.fold_in(key, 2))
    k_step = jax.random.fold_in(key, 3)

    ref_params, ref_state, ref_aux = jax.jit(partial(opt.step, nmt.loss))(
        params, state, k_step, src, tgt
    )

    step = build_sharded_step(opt, nmt.loss, mesh, state, params, donate=False)
    got_params, got_state, got_aux = step(params, state, k_step, src, tgt)

    np.testing.assert_allclose(
        float(got_aux["loss"]), float(ref_aux["loss"]), rtol=1e-5
    )
    for a, b in zip(jax.tree_util.tree_leaves(got_params), jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-4, atol=5e-5)


def test_sharded_kron_multi_step_matches_single_device(mesh):
    """An MLP with 3 heterogeneous (dense, dense) layers through
    kron.update_multi (replicated factors under the mesh). Sharded step
    must match single-device."""
    key = jax.random.PRNGKey(5)
    shapes = [(9, 12), (12, 7), (7, 3)]
    params = [
        0.4 * jax.random.normal(jax.random.fold_in(key, i), s)
        for i, s in enumerate(shapes)
    ]
    x = jax.random.normal(jax.random.fold_in(key, 9), (16, 9))

    def loss(ws, x):
        y = x
        for w in ws:
            y = jnp.tanh(y @ w)
        return jnp.mean(jnp.sum(y * y, axis=-1))

    opt = psgd.PSGD(
        preconditioner="kron", lr_params=0.05, lr_preconditioner=0.05,
        grad_clip_max_norm=1.0, kron_batch_min=99,  # force the singles path
    )
    state = opt.init(params, jax.random.fold_in(key, 2))
    k_step = jax.random.fold_in(key, 3)

    ref_params, _, ref_aux = jax.jit(partial(opt.step, loss))(
        params, state, k_step, x
    )
    step = build_sharded_step(opt, loss, mesh, state, params, donate=False)
    got_params, _, got_aux = step(params, state, k_step, x)

    np.testing.assert_allclose(
        float(got_aux["loss"]), float(ref_aux["loss"]), rtol=1e-5
    )
    for a, b in zip(jax.tree_util.tree_leaves(got_params), jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-4, atol=5e-5)


def _lra_oracle_step(st, v, h, key):
    from psgd_tf_tpu import oracles

    k_bal, k_uv = jax.random.split(key)
    f64 = lambda x: np.asarray(x, np.float64)
    return oracles.lra_oracle(
        f64(st.U).T, f64(st.V).T, f64(st.d), f64(v), f64(h), 0.05,
        balance=bool(jax.random.uniform(k_bal) < 0.01),
        update_u=bool(jax.random.uniform(k_uv) < 0.5))


def _sharded_lra_update(mesh, st, v, h, k):
    """lra.update jitted with the family's sharding policy on the mesh
    (state and probes over `shard`, constrained inside the jit so widths
    the mesh does not divide are padded by GSPMD)."""
    from psgd_tf_tpu.groups import lra

    sh = precond_sharding(mesh, st)
    vec = NamedSharding(mesh, P("shard"))

    def fn(st, v, h, k):
        st = jax.lax.with_sharding_constraint(st, sh)
        v = jax.lax.with_sharding_constraint(v, vec)
        h = jax.lax.with_sharding_constraint(h, vec)
        out = lra.update(st, v, h, step=0.05, key=k)
        return jax.lax.with_sharding_constraint(out, sh)

    return jax.jit(fn)(st, v, h, k)


def _check_sharded_lra(mesh, n, rank, seed):
    from psgd_tf_tpu import oracles
    from psgd_tf_tpu.groups import lra

    key = jax.random.PRNGKey(seed)
    st = lra.init(key, n, rank=rank)
    v = jax.random.normal(jax.random.fold_in(key, 1), (n,))
    h = jax.random.normal(jax.random.fold_in(key, 2), (n,))
    k_up = jax.random.fold_in(key, 3)
    got = _sharded_lra_update(mesh, st, v, h, k_up)
    U, V, d = _lra_oracle_step(st, v, h, k_up)
    for g, w, b in ((got.U.T, U, st.U.T), (got.V.T, V, st.V.T), (got.d, d, st.d)):
        assert oracles.delta_error(g, w, b) < 1e-3


@pytest.mark.parametrize("n,rank", [(64, 4), (100, 5), (257, 3)])
def test_sharded_lra_update_matches_oracle(mesh, n, rank):
    """The GSPMD-partitioned lra update (psum'd rank-space reductions)
    against the float64 oracle — including widths the mesh does not
    divide."""
    _check_sharded_lra(mesh, n, rank, seed=1)


def test_sharded_lra_update_matches_oracle_wide(mesh):
    """The same at 65536 parameters (16384 per device)."""
    _check_sharded_lra(mesh, 65536, 3, seed=9)


def test_sharded_lra_update_moves_only_rank_space_data(mesh):
    """Design invariant of the lra sharding policy: the partitioned update
    exchanges only rank-space quantities — all-reduces of at most (2r+2)^2
    elements, and no gather, all-to-all or permute of the O(n) state."""
    import re

    from psgd_tf_tpu.groups import lra

    n, rank = 4096, 4
    key = jax.random.PRNGKey(3)
    st = lra.init(key, n, rank=rank)
    vec = NamedSharding(mesh, P("shard"))
    sh = precond_sharding(mesh, st)
    fn = jax.jit(
        lambda st, v, h, k: lra.update(st, v, h, step=0.05, key=k),
        in_shardings=(sh, vec, vec, NamedSharding(mesh, P())),
        out_shardings=sh,
    )
    v = jnp.ones((n,))
    hlo = fn.lower(st, v, v, key).compile().as_text()
    assert not re.search(r"all-gather|all-to-all|collective-permute", hlo)
    sizes = []
    for shape in re.findall(r"= \(?([a-z0-9]+\[[0-9,]*\][^ ]*)\)? all-reduce", hlo):
        dims = re.search(r"\[([0-9,]*)\]", shape).group(1)
        sizes.append(int(np.prod([int(x) for x in dims.split(",") if x] or [1])))
    assert sizes and max(sizes) <= (2 * rank + 2) ** 2, sizes


def test_sharded_step_keeps_lra_state_sharded(mesh):
    """build_sharded_step on lra: the step matches the single-device step
    and hands the state back sharded by the family policy."""
    key = jax.random.PRNGKey(0)
    params = {"w": jax.random.normal(key, (40,))}
    opt = psgd.PSGD(preconditioner="lra", rank=3, lr_params=0.05)
    state = opt.init(params, jax.random.fold_in(key, 1))

    def loss(p, x):
        return jnp.sum((x @ p["w"]) ** 2)

    x = jax.random.normal(jax.random.fold_in(key, 2), (16, 40))
    k = jax.random.fold_in(key, 3)
    step = build_sharded_step(opt, loss, mesh, state, params, donate=False)
    p, s, aux = step(params, state, k, x)
    p1, _, aux1 = jax.jit(partial(opt.step, loss))(params, state, k, x)
    assert s.precond.UV.sharding.spec == P(None, "shard")
    assert s.precond.d.sharding.spec == P("shard")
    np.testing.assert_allclose(float(aux["loss"]), float(aux1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p["w"]), np.asarray(p1["w"]), rtol=5e-4, atol=5e-5)


def test_state_sharding_structure(mesh):
    opt = psgd.PSGD(preconditioner="lra", rank=2)
    state = opt.init({"w": jnp.zeros((16,))}, jax.random.PRNGKey(0))
    sh = state_sharding(mesh, state)
    assert sh.precond.UV.spec == P(None, "shard")  # packed rank-major (2r, n)
    assert sh.precond.d.spec == P("shard")
    assert sh.hyper.lr_params.spec == P()


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(data=5, shard=3)


def test_sharded_dense_over_cap_matches_single_device(mesh):
    """dense at n = 1600 on a mesh: Q replicates by policy (row-sharding
    is useless for the row-sequential solve/cumsum and GSPMD's cumsum
    partition hangs — parallel/policies.py) and every device runs the
    whole update."""
    from psgd_tf_tpu.groups import dense

    n = 1600
    key = jax.random.PRNGKey(11)
    state = dense.init(n, init_scale=0.1)
    v = jax.random.normal(jax.random.fold_in(key, 1), (n,))
    h = jax.random.normal(jax.random.fold_in(key, 2), (n,))
    g = jax.random.normal(jax.random.fold_in(key, 3), (n,))

    def update_apply(st):
        new = dense.update(st, v, h, step=0.05)
        return new, dense.apply(new, g)

    ref_st, ref_out = jax.jit(update_apply)(state)

    sh = precond_sharding(mesh, state)
    assert sh.Q.is_fully_replicated

    got_st, got_out = jax.jit(
        update_apply, in_shardings=(sh,), out_shardings=(sh, None),
    )(jax.device_put(state, sh))
    np.testing.assert_allclose(
        np.asarray(got_st.Q), np.asarray(ref_st.Q), rtol=2e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(got_out), np.asarray(ref_out), rtol=2e-5, atol=1e-4
    )


@pytest.mark.parametrize("family", ["kron", "lra"])
def test_tensor_parallel_params_match_single_device(family, mesh):
    """TENSOR-PARALLEL params (SURVEY.md §2.4 TP row): a 3-layer MLP whose
    weight matrices shard over the mesh via `param_specs` — grads and Hvp
    probes live sharded, GSPMD psums the factor-update cross-terms — must
    trace the same trajectory as the single-device step."""
    key = jax.random.PRNGKey(7)
    shapes = [(16, 32), (32, 32), (32, 4)]
    params = [
        0.4 * jax.random.normal(jax.random.fold_in(key, i), s)
        for i, s in enumerate(shapes)
    ]
    # mixed TP layouts: col-shard, row-shard, replicated
    specs = [P(None, "shard"), P("shard", None), None]
    x = jax.random.normal(jax.random.fold_in(key, 9), (16, 16))

    def loss(ws, xb):
        y = xb
        for w in ws:
            y = jnp.tanh(y @ w)
        return jnp.mean(y**2)

    kwargs = dict(lr_params=0.05, lr_preconditioner=0.05)
    if family == "kron":
        opt = psgd.PSGD(preconditioner="kron", kron_formats=[("dense", "dense")] * 3, **kwargs)
    else:
        opt = psgd.PSGD(preconditioner="lra", rank=RANK, **kwargs)
    state = opt.init(params, jax.random.fold_in(key, 2))

    ref_step = jax.jit(partial(opt.step, loss))
    step = build_sharded_step(
        opt, loss, mesh, state, params, donate=False, param_specs=specs
    )

    ref_p, ref_s, p, s = params, state, params, state
    for i in range(3):  # multi-step: factor updates feed back
        k = jax.random.fold_in(key, 100 + i)
        ref_p, ref_s, ref_aux = ref_step(ref_p, ref_s, k, x)
        p, s, aux = step(p, s, k, x)
        np.testing.assert_allclose(
            float(aux["loss"]), float(ref_aux["loss"]), rtol=1e-5
        )
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(ref_p)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=5e-5
        )
    # the TP'd leaves really are sharded on the mesh
    assert any(
        not leaf.sharding.is_fully_replicated
        for leaf in jax.tree_util.tree_leaves(p)
    )


def test_comm_model_tp_accounting():
    # VERDICT r3: the comm model must cover tensor-parallel param_specs —
    # per-param DP payload from the LOCAL shard size plus 3 all-gathers
    # (probe/Hvp/grad) per sharded param, not the hard-coded
    # full-replication 2 * n_params term.
    from jax.sharding import PartitionSpec as P

    from psgd_tf_tpu.parallel import overlap

    shapes = [(24, 24)] * 6  # the kron-tp dryrun config
    specs = [P(None, "shard") if i % 2 == 0 else P("shard", None)
             for i in range(6)]
    m = overlap.comm_model("kron", rank=10, param_shapes=shapes,
                           param_specs=specs,
                           mesh_shape={"data": 4, "shard": 2})
    size = 24 * 24
    assert m["n_params"] == 6 * size
    assert m["tp_sharded_params"] == 6
    assert m["dp_bytes_per_step"] == 2 * 6 * (size // 2) * 4
    assert m["tp_gather_bytes_per_step"] == 3 * 6 * (size - size // 2) * 4
    # replicated specs reduce to the legacy model exactly
    legacy = overlap.comm_model("kron", 6 * size)
    rep = overlap.comm_model("kron", param_shapes=shapes,
                             param_specs=[None] * 6,
                             mesh_shape={"data": 8})
    assert rep["dp_bytes_per_step"] == legacy["dp_bytes_per_step"]
    assert rep["tp_gather_bytes_per_step"] == 0
    # non-divisible axis: GSPMD pads, so local = ceil(s/d) for BOTH terms
    odd = overlap.comm_model("kron", param_shapes=[(25, 24)],
                             param_specs=[P("shard", None)],
                             mesh_shape={"shard": 2})
    loc = 13 * 24  # ceil(25/2) rows
    assert odd["dp_bytes_per_step"] == 2 * loc * 4
    assert odd["tp_gather_bytes_per_step"] == 3 * (2 - 1) * loc * 4
    # a non-None spec without mesh_shape must be loud, not a silently
    # degree-1 (wrong) TP accounting (ADVICE r4)
    import pytest

    with pytest.raises(ValueError, match="mesh_shape"):
        overlap.comm_model("kron", param_shapes=[(25, 24)],
                           param_specs=[P("shard", None)])
    # all-None specs stay legal without a mesh (legacy replicated call)
    ok = overlap.comm_model("kron", param_shapes=[(25, 24)],
                            param_specs=[None])
    assert ok["tp_gather_bytes_per_step"] == 0


def test_sharded_step_with_stream_splu_state(mesh):
    """A 960-parameter rank-4 splu state under the sharded step: the
    policy shards its columns and tails, and three sharded steps match
    the single-device replay."""
    from psgd_tf_tpu import PSGD
    from psgd_tf_tpu.groups.splu import SpLUState
    from psgd_tf_tpu.parallel import build_sharded_step, policies

    params = [0.3 * jax.random.normal(jax.random.PRNGKey(0), (40, 24))]

    def loss(ws, x):
        y = jnp.tanh(x @ ws[0].T)
        return jnp.mean(jnp.sum(y * y, axis=-1))

    opt = PSGD(preconditioner="splu", rank=4, lr_params=0.05,
               grad_clip_max_norm=1.0)
    state = opt.init(params, jax.random.PRNGKey(1))
    assert isinstance(state.precond, SpLUState)
    assert state.precond.Lt.shape == (4, 960)
    sh = policies.state_sharding(mesh, state)
    assert sh.precond.Lt.spec == P(None, "shard")
    assert sh.precond.l3.spec == P("shard")

    x = jax.random.normal(jax.random.PRNGKey(2), (8, 24))
    step = build_sharded_step(opt, loss, mesh, state, params, donate=False)
    single = jax.jit(partial(opt.step, loss))
    p, s = params, state
    p1, s1 = params, state
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        p, s, aux = step(p, s, key, x)
        p1, s1, aux1 = single(p1, s1, key, x)
    rel = max(
        float(jnp.max(jnp.abs(a - b)) / (jnp.max(jnp.abs(b)) + 1e-30))
        for a, b in zip(jax.tree_util.tree_leaves(p),
                        jax.tree_util.tree_leaves(p1)))
    assert np.isfinite(float(aux["loss"])) and rel < 1e-4, rel


def test_state_of_undivided_width_replicates_and_steps(mesh, caplog):
    """A flat state whose width the `shard` axis does not divide (n = 41
    on 4 shards) cannot live sharded: its dimension replicates, with a
    warning, and the sharded step still matches the single-device step."""
    key = jax.random.PRNGKey(4)
    params = {"w": jax.random.normal(key, (41,))}
    x = jax.random.normal(jax.random.fold_in(key, 2), (16, 41))

    def loss(p, x):
        return jnp.sum((x @ p["w"]) ** 2)

    for family in ("lra", "splu"):
        opt = psgd.PSGD(preconditioner=family, rank=3, lr_params=0.05)
        state = opt.init(params, jax.random.fold_in(key, 1))
        caplog.clear()
        sh = state_sharding(mesh, state)
        assert all(s.is_fully_replicated for s in jax.tree_util.tree_leaves(sh.precond))
        assert "replicates on every device" in caplog.text
        k = jax.random.fold_in(key, 3)
        step = build_sharded_step(opt, loss, mesh, state, params, donate=False)
        p, _, aux = step(params, state, k, x)
        p1, _, aux1 = jax.jit(partial(opt.step, loss))(params, state, k, x)
        np.testing.assert_allclose(float(aux["loss"]), float(aux1["loss"]), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(p["w"]), np.asarray(p1["w"]), rtol=5e-4, atol=5e-5)
