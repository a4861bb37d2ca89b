"""Sharding policies: where each piece of PSGD state lives on the mesh.

Per SURVEY.md §2.4, the one real distributed-design problem this library
owns is block-partitioning the preconditioner state itself:

  dense  : Q replicates at every size. The update's triangular solve
           and reverse-cumsum rank-2 form are sequential along rows —
           row-sharding buys no parallelism and GSPMD's cumsum partition is
           pathological (see precond_sharding) — and the family's capacity
           envelope (n ~ 1e4, ref README.md:54) keeps replicated Q cheap
           next to model state.
  diag   : q over `shard`.
  xmat   : folded (2, m) rows over `shard` along the pair axis. The folded
           layout (groups/xmat.py) co-locates each coupled (i, n-1-i) pair,
           so the update itself needs NO cross-device exchange; only the
           probe fold/unfold at the boundary reverses data once.
  shift  : same folded pair-axis sharding as xmat (orbits {i, i+m}
           co-located; the fold is a pure reshape, groups/shift.py).
  splu   : rank-major Lt/U12 columns (the parameter axis) and the diagonal
           tails over `shard`; the r x r corner solves replicate
           (all_gather of r-vectors).
  lra    : U, V are rank-major (r, n) — the parameter axis (axis 1) shards
           over `shard` together with d and the probes; the r x r Grams
           (V U^T etc.) become psum-reduced wide contractions.
  kron   : per-layer factors replicate (they are small by design — the
           README's own capacity table caps dense factors at ~1e3); the
           *batch* axis carries the parallelism for those workloads.

Parameters and gradients replicate (pure DP); batches shard over `data`.
A state dimension that the `shard` axis does not divide replicates.
"""
from __future__ import annotations

import logging
from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from psgd_tf_tpu.groups import dense, diag, lra, shift, splu, xmat
from psgd_tf_tpu.optim.psgd import KronPrecond, PSGDState

log = logging.getLogger(__name__)

def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (batch) axis over `data`."""
    return NamedSharding(mesh, P("data"))


def precond_sharding(mesh: Mesh, precond: Any) -> Any:
    """A pytree of NamedShardings matching a family state's structure.

    A device array's sharded dimension must divide evenly over its mesh
    axes, so a dimension the `shard` axis does not divide (a flat state of
    odd width on two devices, say) stays replicated, with a warning: the
    whole state then sits on every device."""
    return jax.tree_util.tree_map(
        lambda sh, x: _fit(sh, x.shape), _policy(mesh, precond), precond
    )


def _fit(sh: NamedSharding, shape) -> NamedSharding:
    spec = []
    for k, entry in enumerate(tuple(sh.spec)):
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for ax in axes:
            if ax is not None:
                size *= sh.mesh.shape[ax]
        if shape[k] % size:
            log.warning("state dimension %d of shape %s does not divide over mesh axes %s "
                        "of size %d: it replicates on every device", k, shape, entry, size)
            entry = None
        spec.append(entry)
    return NamedSharding(sh.mesh, P(*spec))


def _policy(mesh: Mesh, precond: Any) -> Any:
    row = NamedSharding(mesh, P("shard"))
    rowmat = NamedSharding(mesh, P("shard", None))
    colmat = NamedSharding(mesh, P(None, "shard"))
    rep = replicated(mesh)

    if isinstance(precond, dense.DenseState):
        # Q replicates at every size. The dense capacity envelope tops out
        # at n ~ 1e4 (ref README.md:54; n = 16384 is ~1GB fp32 replicated
        # — cheap next to model state at that scale), and both the
        # update's triangular solve and its reverse-cumsum rank-2 form are
        # SEQUENTIAL along the row axis: row-sharding buys no speed, and
        # GSPMD's partition of cumsum over a sharded axis was pathological
        # (a (3456,)^2 reverse cumsum failed to complete in 120s on the
        # virtual CPU mesh vs 0.8s replicated).
        return dense.DenseState(Q=rep)
    if isinstance(precond, diag.DiagState):
        return diag.DiagState(q=row)
    if isinstance(precond, xmat.XMatState):
        return xmat.XMatState(
            af=colmat, bf=colmat, ac=rep, odd=precond.odd
        )
    if isinstance(precond, shift.ShiftState):
        # same folded co-location argument as xmat: each {i, i+m} orbit is
        # a column of the (2, m) state, so pair-axis sharding needs no
        # cross-device exchange
        return shift.ShiftState(
            af=colmat, bf=colmat, ac=rep, odd=precond.odd
        )
    if isinstance(precond, splu.SpLUState):
        return splu.SpLUState(Lt=colmat, l3=row, U12=colmat, u3=row)
    if isinstance(precond, lra.LRAState):
        return lra.LRAState(UV=colmat, d=row)
    if isinstance(precond, (list, tuple)):  # kron: replicate every factor
        return type(precond)(
            jax.tree_util.tree_map(lambda _: rep, ks) for ks in precond
        )
    if isinstance(precond, KronPrecond):
        # kron with the batched dd group: small factors, replicate all —
        # the stacked (B, S, S) factors are still tiny vs model state
        return jax.tree_util.tree_map(lambda _: rep, precond)
    raise TypeError(f"no sharding policy for {type(precond)!r}")


def state_sharding(mesh: Mesh, state: PSGDState) -> PSGDState:
    """Shardings for the full PSGDState pytree."""
    rep = replicated(mesh)
    return PSGDState(
        count=rep,
        hyper=jax.tree_util.tree_map(lambda _: rep, state.hyper),
        precond=precond_sharding(mesh, state.precond),
        always_update=state.always_update,  # static field: match treedef
    )
