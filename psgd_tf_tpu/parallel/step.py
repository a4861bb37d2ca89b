"""Builder for mesh-sharded PSGD training steps.

Jits `opt.step` with explicit in/out shardings so GSPMD partitions the
whole step — forward, backward, Hvp, preconditioner update, apply — and
inserts the collectives (psum of grads/Hvps over `data`, psums of the
r-sized reductions over `shard`). No hand-written communication: the
sharding annotations ARE the distributed implementation.
"""
from __future__ import annotations

from typing import Any, Callable

import jax
from jax.sharding import Mesh

from psgd_tf_tpu.optim.psgd import PSGD, PSGDState
from psgd_tf_tpu.parallel import policies


def build_sharded_step(
    opt: PSGD,
    loss_fn: Callable,
    mesh: Mesh,
    state: PSGDState,
    params: Any,
    batch_axes: tuple[int, ...] | None = None,
    donate: bool = True,
    param_specs: Any | None = None,
):
    """Returns a compiled `step(params, state, key, *batch)`.

    By default params replicate (pure DP + state sharding). Pass
    `param_specs` — a pytree of `jax.sharding.PartitionSpec` matching
    `params` (None leaves replicate) — for TENSOR-PARALLEL models: each
    parameter, its gradient, and its Hvp probe then live sharded on the
    mesh, and GSPMD partitions the preconditioner algebra around them
    (SURVEY.md §2.4 TP row: the per-layer Kron factors stay replicated —
    they are small by design, ref README.md:54 — and the factor updates'
    statistical Grams A A^T / A^T A contract over the sharded axis, which
    is exactly the "psum of cross-terms" the survey plans).

    Preconditioner state shards per family policy; every positional batch
    argument shards its leading axis over `data` (`batch_axes` selects
    which args are batches; default: all).
    """
    rep = policies.replicated(mesh)
    if param_specs is None:
        param_sh = jax.tree_util.tree_map(lambda _: rep, params)
    else:
        from jax.sharding import NamedSharding, PartitionSpec

        param_sh = jax.tree_util.tree_map(
            lambda spec: NamedSharding(
                mesh, spec if spec is not None else PartitionSpec()
            ),
            param_specs,
            is_leaf=lambda x: x is None or isinstance(x, PartitionSpec),
        )
    state_sh = policies.state_sharding(mesh, state)
    data_sh = policies.batch_sharding(mesh)

    def batch_shardings(nargs: int):
        axes = set(range(nargs)) if batch_axes is None else set(batch_axes)
        return tuple(data_sh if i in axes else rep for i in range(nargs))

    def make(nargs: int):
        def step_sharded(params, state, key, *batch):
            return opt.step(loss_fn, params, state, key, *batch)

        return jax.jit(
            step_sharded,
            in_shardings=(param_sh, state_sh, rep) + batch_shardings(nargs),
            out_shardings=(param_sh, state_sh, None),
            donate_argnums=(0, 1) if donate else (),
        )

    compiled: dict[int, Any] = {}

    def step(params, state, key, *batch):
        fn = compiled.get(len(batch))
        if fn is None:
            fn = compiled[len(batch)] = make(len(batch))
        return fn(params, state, key, *batch)

    return step
