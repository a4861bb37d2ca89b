"""The unified PSGD optimizer.

One functional optimizer for *every* preconditioner family — the reference
only wraps UVd in a class and leaves dense/kron/splu as free functions each
demo re-plumbs by hand (SURVEY.md §1). API shape:

    opt = PSGD(preconditioner="lra", rank=10, lr_params=0.01, ...)
    state = opt.init(params, key)
    params, state, aux = opt.step(loss_fn, params, state, key, *batch)

`step` is pure and jittable: `jax.jit(partial(opt.step, loss_fn))` (or under
an outer jit). All reference hyper-knobs are preserved
(/root/reference/preconditioned_stochastic_gradient_descent.py:663-680):
lr_params, lr_preconditioner, grad_clip_max_norm (inf sentinel = off),
preconditioner_update_probability, exact_hessian_vector_product. The first
four live in the state as traced scalars, so they can be rescheduled
mid-run without recompiling (the reference's `.assign` mutability feature,
ref :660-661, rnn_xor_UVd_preconditioner.py:62-69) — use `opt.set_hyper`.
`exact_hessian_vector_product` changes the autodiff graph, so it is static;
flipping it triggers one recompile (both variants stay cached).

Families: 'dense', 'diag', 'xmat', 'shift', 'splu', 'lra' operate on the
flattened parameter vector; 'kron' keeps one (Ql, Qr) pair per parameter
tensor with static per-tensor formats.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Literal, Sequence

import jax
import jax.flatten_util
import jax.numpy as jnp

from psgd_tf_tpu import hvp, struct
from psgd_tf_tpu.groups import kron
from psgd_tf_tpu.groups.base import FLAT_FAMILIES as _FLAT_FAMILIES
from psgd_tf_tpu.ops import linalg

PyTree = Any


@struct.dataclass
class Hyper:
    """Runtime-mutable hyperparameters (traced scalars; ref :673-680)."""

    lr_params: jax.Array
    lr_preconditioner: jax.Array
    grad_clip_max_norm: jax.Array  # inf = no clipping (ref :676)
    update_probability: jax.Array


@struct.dataclass
class PSGDState:
    count: jax.Array
    hyper: Hyper
    precond: Any  # family state (flat families), list[KronState] (kron),
    #             # or KronPrecond (kron with the batched dd group)
    always_update: bool = struct.field(static=True, default=False)
    # static: True when the ctor's preconditioner_update_probability >= 1.0
    # compiled the coin-flip branch out (the loss graph then compiles once,
    # not twice). `set_hyper(update_probability=...)` raises on such a
    # state instead of being silently ignored (ref :679, :703 allows
    # `.assign` at any time); flip it via `state.replace(
    # always_update=False)` (one recompile) to re-enable the coin.


@struct.dataclass
class KronPrecond:
    """Kron state with eligible (dense, dense) layers grouped for batching.

    `batches` holds one stacked BatchedDDState per *bucket* — layers of
    identical shape — so each bucket updates in one vmapped op chain.
    `singles` holds the remaining layers' per-layer states, including
    buckets smaller than kron_batch_min. The index tuples map each
    group back to parameter-tree leaf order and are static (part of the
    treedef).
    """

    batches: list
    singles: list
    batched_idx: tuple[tuple[int, ...], ...] = struct.field(static=True, default=())
    single_idx: tuple[int, ...] = struct.field(static=True, default=())


@dataclasses.dataclass(frozen=True)
class PSGD:
    preconditioner: Literal[
        "dense", "diag", "xmat", "shift", "splu", "lra", "kron"
    ] = "lra"
    rank: int = 10                      # splu corner / lra rank (ref :663)
    init_scale: float = 1.0             # initial Q scale (ref :637)
    lr_params: float = 0.01
    lr_preconditioner: float = 0.01
    grad_clip_max_norm: float | None = None
    preconditioner_update_probability: float = 1.0
    exact_hessian_vector_product: bool = True
    kron_formats: Any = "auto"          # 'auto' | (fmt_l, fmt_r) | callable(shape)->pair
    #                                   # | [per-leaf (fmt_l, fmt_r), ...] in tree-leaf
    #                                   # order (the reference's per-layer mixed
    #                                   # assignment, e.g. nmt ref :99-148)
    kron_batched: bool = True           # stack same-shape (dense, dense) layers
    #                                   # and update each bucket in one vmapped
    #                                   # op chain (groups/kron.py batched path);
    #                                   # numerically equivalent to the
    #                                   # per-layer ops
    kron_batch_min: int = 4             # min layers per bucket to batch
    dtype: Any = jnp.float32

    # ------------------------------------------------------------------ init

    def init(self, params: PyTree, key: jax.Array | None = None) -> PSGDState:
        if key is None:
            key = jax.random.PRNGKey(0)
        hyper = Hyper(
            lr_params=jnp.asarray(self.lr_params, self.dtype),
            lr_preconditioner=jnp.asarray(self.lr_preconditioner, self.dtype),
            grad_clip_max_norm=jnp.asarray(
                jnp.inf if self.grad_clip_max_norm is None else self.grad_clip_max_norm,
                self.dtype,
            ),
            update_probability=jnp.asarray(
                self.preconditioner_update_probability, self.dtype
            ),
        )
        if self.preconditioner == "kron":
            precond = self._init_kron(params)
        else:
            n = int(
                sum(leaf.size for leaf in jax.tree_util.tree_leaves(params))
            )
            fam = _FLAT_FAMILIES[self.preconditioner]
            if self.preconditioner == "lra":
                precond = fam.init(key, n, rank=self.rank, init_scale=self.init_scale, dtype=self.dtype)
            elif self.preconditioner == "splu":
                precond = fam.init(n, rank=self.rank, init_scale=self.init_scale, dtype=self.dtype)
            else:
                precond = fam.init(n, init_scale=self.init_scale, dtype=self.dtype)
        return PSGDState(
            count=jnp.zeros((), jnp.int32),
            hyper=hyper,
            precond=precond,
            always_update=self.preconditioner_update_probability >= 1.0,
        )

    def _leaf_format(self, shape: tuple[int, int], index: int, n_leaves: int):
        if isinstance(self.kron_formats, str) and self.kron_formats == "auto":
            return kron.auto_format(shape)
        if callable(self.kron_formats):
            return self.kron_formats(shape)
        fmts = list(self.kron_formats)
        if fmts and not isinstance(fmts[0], str):  # per-leaf list of pairs
            if len(fmts) != n_leaves:
                raise ValueError(
                    f"kron_formats lists {len(fmts)} pairs for {n_leaves} "
                    "parameter tensors"
                )
            return fmts[index]
        return tuple(fmts)

    def _init_kron(self, params: PyTree):
        leaves = jax.tree_util.tree_leaves(params)
        shapes = [_matrix_shape(leaf.shape) for leaf in leaves]
        fmts = [
            tuple(self._leaf_format(s, i, len(leaves)))
            for i, s in enumerate(shapes)
        ]
        buckets: dict[tuple[int, int], list[int]] = {}
        for i, (s, f) in enumerate(zip(shapes, fmts)):
            if f == ("dense", "dense"):
                buckets.setdefault(s, []).append(i)
        batched_idx = tuple(
            tuple(idx)
            for idx in buckets.values()
            if len(idx) >= max(2, self.kron_batch_min)
        )
        if (
            not self.kron_batched
            or not batched_idx
            or jnp.dtype(self.dtype) != jnp.float32
        ):
            return [
                kron.init(s, fmt=f, init_scale=self.init_scale, dtype=self.dtype)
                for s, f in zip(shapes, fmts)
            ]
        in_batch = {i for idx in batched_idx for i in idx}
        single_idx = tuple(i for i in range(len(leaves)) if i not in in_batch)
        return KronPrecond(
            batches=[
                kron.init_batched(
                    shapes[idx[0]], len(idx),
                    init_scale=self.init_scale,
                    dtype=self.dtype,
                )
                for idx in batched_idx
            ],
            singles=[
                kron.init(
                    shapes[i], fmt=fmts[i],
                    init_scale=self.init_scale, dtype=self.dtype,
                )
                for i in single_idx
            ],
            batched_idx=batched_idx,
            single_idx=single_idx,
        )

    # ------------------------------------------------------------------ step

    def step(
        self,
        loss_fn: Callable,
        params: PyTree,
        state: PSGDState,
        key: jax.Array,
        *args,
    ) -> tuple[PyTree, PSGDState, dict[str, jax.Array]]:
        """One PSGD step: maybe-update Q, precondition, clip, descend."""
        k_coin, k_probe, k_prec = jax.random.split(key, 3)
        hyper = state.hyper

        if self.preconditioner == "kron":
            step_with, step_without = self._kron_branches(
                loss_fn, params, state, k_probe, k_prec, args
            )
        else:
            step_with, step_without = self._flat_branches(
                loss_fn, params, state, k_probe, k_prec, args
            )

        if state.always_update:
            # Statically always-update: skip the coin-flip cond so the loss
            # graph compiles once, not twice. set_hyper raises (rather than
            # silently no-ops) if asked to schedule update_probability on
            # such a state.
            loss, grads, precond, pre_grads = step_with(None)
        else:
            do_update = (
                jax.random.uniform(k_coin, dtype=self.dtype)
                < hyper.update_probability
            )
            loss, grads, precond, pre_grads = jax.lax.cond(
                do_update, step_with, step_without, None
            )

        # global-norm clipping (ref :750-754, mnist_with_lenet5.py:54-55)
        sq = sum(
            jnp.sum(g * g) for g in jax.tree_util.tree_leaves(pre_grads)
        )
        pre_grad_norm = jnp.sqrt(sq) + linalg.tiny(self.dtype)
        lr = hyper.lr_params * linalg.norm_clip_scale(
            pre_grad_norm, hyper.grad_clip_max_norm
        )

        new_params = jax.tree_util.tree_map(
            lambda p, g: p - lr * g.astype(p.dtype), params, pre_grads
        )
        new_state = PSGDState(
            count=state.count + 1,
            hyper=hyper,
            precond=precond,
            always_update=state.always_update,
        )
        grad_sq = sum(
            jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads)
        )
        aux = {
            "loss": loss,
            "grad_norm": jnp.sqrt(grad_sq),
            "pre_grad_norm": pre_grad_norm,
            "lr_effective": lr,
        }
        return new_params, new_state, aux

    # ------------------------------------------------- flat-family internals

    def _flat_branches(self, loss_fn, params, state, k_probe, k_prec, args):
        fam = _FLAT_FAMILIES[self.preconditioner]
        hyper = state.hyper
        flat0, unravel = jax.flatten_util.ravel_pytree(params)

        def precondition(precond, grads):
            with jax.named_scope("psgd_apply"):
                g_flat = jax.flatten_util.ravel_pytree(grads)[0]
                pre = fam.apply(precond, g_flat.astype(self.dtype))
                return unravel(pre.astype(g_flat.dtype))

        def step_with(_):
            # probes in the PARAM dtype (the Hvp runs through the model);
            # cast to the preconditioner dtype only at the family boundary,
            # so a bf16 Q state composes with fp32 params and vice versa
            v_flat = jax.random.normal(k_probe, flat0.shape, flat0.dtype)
            v = unravel(v_flat)
            with jax.named_scope("psgd_hvp"):
                if self.exact_hessian_vector_product:
                    loss, grads, hvs = hvp.exact(loss_fn, params, v, *args)
                else:
                    loss, grads, hvs = hvp.finite_diff(loss_fn, params, v, *args)
            h_flat = jax.flatten_util.ravel_pytree(hvs)[0]
            with jax.named_scope("psgd_q_update"):
                precond = fam.update(
                    state.precond,
                    v_flat.astype(self.dtype),
                    h_flat.astype(self.dtype),
                    step=hyper.lr_preconditioner, key=k_prec,
                )
            return loss, grads, precond, precondition(precond, grads)

        def step_without(_):
            loss, grads = hvp.grad_only(loss_fn, params, *args)
            return loss, grads, state.precond, precondition(state.precond, grads)

        return step_with, step_without

    # -------------------------------------------------------- kron internals

    def _kron_branches(self, loss_fn, params, state, k_probe, k_prec, args):
        hyper = state.hyper
        treedef = jax.tree_util.tree_structure(params)

        def apply_kron(precond, grads):
            with jax.named_scope("psgd_apply"):
                return self._apply(precond, grads, params)

        def step_with(_):
            v = hvp.random_like(k_probe, params)
            with jax.named_scope("psgd_hvp"):
                if self.exact_hessian_vector_product:
                    loss, grads, hvs = hvp.exact(loss_fn, params, v, *args)
                else:
                    loss, grads, hvs = hvp.finite_diff(loss_fn, params, v, *args)
            v_leaves = [
                _as_matrix(x).astype(self.dtype) for x in treedef.flatten_up_to(v)
            ]
            h_leaves = [
                _as_matrix(x).astype(self.dtype) for x in treedef.flatten_up_to(hvs)
            ]
            with jax.named_scope("psgd_q_update"):
                pc = state.precond
                if isinstance(pc, KronPrecond):
                    precond = pc.replace(
                        batches=[
                            kron.update_batched(
                                bst,
                                [v_leaves[i] for i in idx],
                                [h_leaves[i] for i in idx],
                                step=hyper.lr_preconditioner,
                            )
                            for bst, idx in zip(pc.batches, pc.batched_idx)
                        ],
                        singles=kron.update_multi(
                            pc.singles,
                            [v_leaves[i] for i in pc.single_idx],
                            [h_leaves[i] for i in pc.single_idx],
                            step=hyper.lr_preconditioner,
                        ),
                    )
                else:
                    precond = kron.update_multi(
                        pc, v_leaves, h_leaves, step=hyper.lr_preconditioner
                    )
            return loss, grads, precond, apply_kron(precond, grads)

        def step_without(_):
            loss, grads = hvp.grad_only(loss_fn, params, *args)
            return loss, grads, state.precond, apply_kron(state.precond, grads)

        return step_with, step_without

    # ----------------------------------------------------------------- apply

    def _apply(self, precond, grads, params):
        # grads cast to the preconditioner dtype here; step() casts the
        # preconditioned result back to each param's dtype
        if self.preconditioner == "kron":
            treedef = jax.tree_util.tree_structure(params)
            g_leaves = [
                g.astype(self.dtype) for g in treedef.flatten_up_to(grads)
            ]
            if isinstance(precond, KronPrecond):
                pre = [None] * len(g_leaves)
                for bst, idx in zip(precond.batches, precond.batched_idx):
                    batched_pre = kron.apply_batched(
                        bst, [_as_matrix(g_leaves[i]) for i in idx]
                    )
                    for i, p in zip(idx, batched_pre):
                        pre[i] = p.reshape(g_leaves[i].shape)
                for ks, i in zip(precond.singles, precond.single_idx):
                    pre[i] = kron.apply(ks, _as_matrix(g_leaves[i])).reshape(
                        g_leaves[i].shape
                    )
            else:
                pre = [
                    kron.apply(ks, _as_matrix(g)).reshape(g.shape)
                    for ks, g in zip(precond, g_leaves)
                ]
            return jax.tree_util.tree_unflatten(treedef, pre)
        fam = _FLAT_FAMILIES[self.preconditioner]
        g_flat, unravel = jax.flatten_util.ravel_pytree(grads)
        pre = fam.apply(precond, g_flat.astype(self.dtype))
        return unravel(pre.astype(g_flat.dtype))

    # ----------------------------------------------------------------- hyper

    @staticmethod
    def set_hyper(state: PSGDState, **kwargs) -> PSGDState:
        """Reschedule hyperparameters mid-run without recompiling
        (the reference's `.assign` feature, ref :660-661).

        Scheduling `update_probability` requires the coin-flip branch to be
        compiled in: raises on an always-update state (constructed with
        probability >= 1.0) instead of being silently ignored.
        """
        if "update_probability" in kwargs and state.always_update:
            raise ValueError(
                "update_probability cannot be scheduled on an always-update "
                "state: the optimizer was constructed with "
                "preconditioner_update_probability >= 1.0, which compiles "
                "the coin-flip branch out. Construct PSGD with a "
                "probability < 1.0, or opt into one recompile with "
                "state.replace(always_update=False) first."
            )
        hyper = state.hyper
        for name, value in kwargs.items():
            field_val = getattr(hyper, name)
            hyper = hyper.replace(
                **{name: jnp.asarray(value, field_val.dtype)}
            )
        return state.replace(hyper=hyper)


def _matrix_shape(shape: Sequence[int]) -> tuple[int, int]:
    """Canonical 2-D shape for the kron family: scalars -> (1, 1),
    vectors -> (n, 1), higher-rank tensors fold leading dims
    (the reference's demos do this packing by hand, e.g.
    mnist_with_lenet5.py:12-16 lays conv kernels out as
    (H*W*Cin + 1, Cout) matrices)."""
    shape = tuple(shape)
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (shape[0], 1)
    if len(shape) == 2:
        return shape
    size = 1
    for s in shape[:-1]:
        size *= s
    return (size, shape[-1])


def _as_matrix(x: jax.Array) -> jax.Array:
    return x.reshape(_matrix_shape(x.shape))
