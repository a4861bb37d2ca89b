"""chip_smoke.py's refusal of a non-GPU backend, its four-card check
against planted faults, and the compile-cache location."""
import os
from functools import partial

import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from psgd_tf_tpu import PSGD
from psgd_tf_tpu.parallel import build_sharded_step, make_mesh
from psgd_tf_tpu.utils import compile_cache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_a_non_gpu_backend(capsys):
    assert jax.default_backend() != "gpu"
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "platform=cpu" in out


def test_chip_smoke_checks_cover_every_family():
    names = " ".join(chip_smoke.FAMILY_CHECKS)
    for family in ("kron", "dense", "diag", "xmat", "shift", "splu", "lra"):
        assert family in names


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir() == os.path.join(CHECKOUT, ".jax_cache")


def test_compile_cache_enable_sets_jax_config():
    assert compile_cache.enable() == compile_cache.cache_dir()
    assert jax.config.jax_compilation_cache_dir == compile_cache.cache_dir()


def _mlp_loss(ws, x):
    y = x
    for w in ws:
        y = jnp.tanh(y @ w)
    return jnp.mean(jnp.sum(y * y, axis=-1))


def _faulty(step, fault):
    if fault == "skip_update":  # computes a step, returns the old params
        return lambda p, s, k, x: (p, *step(p, s, k, x)[1:])
    if fault == "half_batch":  # one data shard's examples dropped
        return lambda p, s, k, x: step(p, s, k, x[: x.shape[0] // 2])
    return step


@pytest.mark.parametrize("fault", ["none", "skip_update", "half_batch"])
@pytest.mark.parametrize("family", ["kron", "lra"])
def test_sharded_gap_separates_sound_and_faulty_steps(family, fault):
    """chip_smoke's four-card check at a small width on the virtual CPU
    mesh: a sound sharded step reads well inside TOL_SHARDED, a planted
    fault well outside it, in the parameters alone."""
    key = jax.random.PRNGKey(0)
    params = [0.5 * jax.random.normal(jax.random.fold_in(key, i), (24, 24)) for i in range(4)]
    x = jax.random.normal(jax.random.fold_in(key, 9), (64, 24))
    opt = PSGD(preconditioner=family, rank=4, kron_formats=("dense", "dense"),
               lr_params=0.02, lr_preconditioner=0.02, grad_clip_max_norm=1.0)
    state = opt.init(params, jax.random.fold_in(key, 7))
    sharded = build_sharded_step(opt, _mlp_loss, make_mesh(data=2, shard=2), state, params,
                                 donate=False)
    single = jax.jit(partial(opt.step, _mlp_loss))
    (pa, _), (pb, _), losses = chip_smoke.replay(_faulty(sharded, fault), single, params,
                                                 state, key, (x,))
    params_gap, loss_gap = chip_smoke.trajectory_gaps(params, pa, pb, losses)
    if fault == "none":
        assert max(params_gap, loss_gap) < chip_smoke.TOL_SHARDED / 100
    else:
        assert params_gap > 10 * chip_smoke.TOL_SHARDED
