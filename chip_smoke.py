"""Smoke run of the PSGD training step on an NVIDIA GPU, in one process.

    python chip_smoke.py             # one card
    python chip_smoke.py --chips 4   # the sharded step on four cards

One card:
  * the NMT trainer (`workloads.nmt_attention.run`) at the reference's full
    width for 20 steps, plus one exact-Hvp step; its first step against the
    same step on the CPU backend at precision=highest;
  * the LeNet5 trainer (`workloads.mnist_lenet5.run`) for 20 steps;
  * every preconditioner family's update + apply against a plain
    reference: the float64 oracles of `psgd_tf_tpu.oracles` where the host
    can afford them, else the same function on the CPU backend at
    precision=highest.
Four cards: `build_sharded_step` on a (data=2, shard=2) mesh for the NMT at
reference width (kron-mixed, lra, splu), LeNet5 with its lra and splu
state sharded, and a tensor-parallel kron MLP, each against a
single-device replay with the same keys.

Lines starting `INFO` are records (compile time, steady step time, peak
device memory, the NMT step's memory analysis, step times with
kron_batched on and off, each family check's update + apply time on the
device), not gates. The last line of stdout is one JSON
object, `{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
N}}`, printed only when every phase passed. Without a GPU the script exits
non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import psgd_tf_tpu
from psgd_tf_tpu import PSGD, oracles
from psgd_tf_tpu.groups import base, dense, kron, lra, splu
from psgd_tf_tpu.utils import compile_cache

HERE = os.path.dirname(os.path.abspath(__file__))
STEP = 0.05  # preconditioner step of the family checks

# Tolerances. Errors of a state are measured against the size of the
# update (oracles.delta_error), errors of P g against its size.
#  - fp32 states run at the library's default precision, which on the GPU
#    lets fp32 matmuls use TF32 tensor cores: about 3 decimal digits per
#    product (2^-11 relative). An update chains a few products and a
#    max-normalised step; on an H100 the worst TF32 reading is 1.3e-3 of
#    the step (the dense kron factors at (131072, 512) and (512, 131072)).
#    With the matmuls forced to bf16 (8 significant bits) the same checks
#    read 3.3e-3 to 1.2e-2, so the limit sits between the two; a wrong
#    formula misses by O(1).
TOL_FP32 = 3e-3
#  - diag, xmat and shift are elementwise: no matmul, only fp32 rounding
#    and the order of reductions differ.
TOL_ELEMENTWISE = 1e-4
#  - a bf16 state keeps 8 significant bits (2^-9 relative per rounding).
#    Its check takes a step of STEP_BF16, so that rounding the new state to
#    bf16 (up to 2e-3 of a unit entry) is ~1% of the step; bf16 products
#    and sums over n add a few percent (4% at n = 262144 on the CPU).
STEP_BF16 = 0.2
TOL_BF16 = 1e-1
#  - the NMT's first-step loss and gradient norm average thousands of
#    TF32 products on the GPU against fp32 on the CPU (an H100 reads
#    4.5e-7 and 7.7e-5).
TOL_STEP_SCALARS = 1e-3
#  - sharded vs single-device trajectories: the same program up to the
#    order of the cross-device reductions. After 5 steps each parameter
#    leaf's gap is measured against the size of its own 5-step update
#    (oracles.delta_error), and the per-step losses against the loss's fall
#    over the run. A leaf whose update spans only a few hundred ulps of its
#    entries reads a one-ulp rounding flip as a few 1e-3: on four H100s the
#    sound steps read up to 9.8e-3 (= 4/407, the NMT splu case) in the
#    parameters and 2.5e-4 in the losses. A sharded step that skips its
#    update reads 1; one that drops a data shard's gradient about 0.8
#    (0.80 on a CPU mesh, 0.83 for the NMT at reference width on an H100;
#    tests/test_smoke_and_cache.py plants both).
TOL_SHARDED = 5e-2


def info(name: str, **fields) -> None:
    print("INFO " + json.dumps({"name": name, **fields}, default=str), flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return (out.stdout or out.stderr).strip()


def peak_bytes() -> int | None:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _on_cpu(tree):
    return jax.device_put(tree, jax.devices("cpu")[0])


def _on_device(fn, *args, reps=10):
    """`fn` jitted on the default device: its result on the host, and the
    median host-clock time of `reps` further calls on device-resident
    inputs, each ended by block_until_ready (a record for the benchmark,
    not a gate)."""
    jf = jax.jit(fn)
    args = jax.device_put(args, jax.devices()[0])
    out = jax.block_until_ready(jf(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(jf(*args))
        times.append(time.perf_counter() - t0)
    return jax.device_get(out), float(np.median(times))


def _vs_cpu(fn, *args):
    """`fn` on the default device at the library's default precision (see
    _on_device), and on the CPU backend at precision=highest."""
    dev, seconds = _on_device(fn, *args)
    with jax.default_matmul_precision("highest"):
        ref = jax.device_get(jax.jit(fn)(*_on_cpu(args)))
    return dev, ref, seconds


def _tree_errs(label, got, want, base, tol):
    out = []
    for i, (g, w, b) in enumerate(zip(jax.tree_util.tree_leaves(got),
                                      jax.tree_util.tree_leaves(want),
                                      jax.tree_util.tree_leaves(base))):
        out.append((f"{label}/state{i}", oracles.delta_error(g, w, b), tol))
    return out


def _update_apply(fam, step=STEP):
    def fn(st, v, h, g, k):
        new = fam.update(st, v, h, step=step, key=k)
        return new, fam.apply(new, g)
    return fn


def _kron_update_apply(st, dX, dG, G):
    new = kron.update(st, dX, dG, step=STEP)
    return new, kron.apply(new, G)


def _normals(key, shape, k=3, dtype=jnp.float32):
    return [jax.random.normal(jax.random.fold_in(key, i), shape, dtype) for i in range(k)]


# ------------------------------------------------- family checks: oracles

def check_kron_nmt_layers(cfg=None):
    """Every NMT kron layer at the reference's width, under its format."""
    from psgd_tf_tpu.models import nmt

    cfg = cfg or nmt.ref_config()
    out, times = [], {}
    for i, (shape, fmt) in enumerate(zip(nmt.layer_shapes(cfg), nmt.kron_formats(cfg))):
        rng = np.random.default_rng(100 + i)
        ql = oracles.random_kron_factor(rng, fmt[0], shape[0])
        qr = oracles.random_kron_factor(rng, fmt[1], shape[1])
        dX, dG, G = (rng.standard_normal(shape, dtype=np.float32) for _ in range(3))
        st = kron.KronState(ql=jnp.asarray(ql), qr=jnp.asarray(qr), fmt=tuple(fmt))
        label = f"kron{fmt}{shape}"
        (new, pre), times[label] = _on_device(_kron_update_apply, st, dX, dG, G)
        wl, wr = oracles.kron_update(fmt, ql, qr, dX, dG, STEP)
        out.append((f"{label}/ql", oracles.delta_error(
            oracles.factor_to_oracle(fmt[0], new.ql), wl, oracles.factor_to_oracle(fmt[0], ql)), TOL_FP32))
        out.append((f"{label}/qr", oracles.delta_error(
            oracles.factor_to_oracle(fmt[1], new.qr), wr, oracles.factor_to_oracle(fmt[1], qr)), TOL_FP32))
        out.append((f"{label}/Pg", oracles.rel_error(
            pre, oracles.kron_apply(wl, wr, G.astype(np.float64))), TOL_FP32))
    return out, times


def check_dense_oracle(n=4096):
    rng = np.random.default_rng(1)
    Q = oracles.random_triu(rng, n)
    v, h, g = (rng.standard_normal(n, dtype=np.float32) for _ in range(3))
    (new, pre), seconds = _on_device(
        _update_apply(dense), dense.DenseState(Q=jnp.asarray(Q)), v, h, g, None)
    want = oracles.dense_oracle(Q.astype(np.float64), v, h, STEP)
    return [(f"dense{n}/Q", oracles.delta_error(new.Q, want, Q), TOL_FP32),
            (f"dense{n}/Pg", oracles.rel_error(pre, oracles.dense_apply(want, g)), TOL_FP32)
            ], {f"dense{n}": seconds}


def check_lra_oracle(n=1 << 20, rank=10, dtype="float32", step=STEP):
    dtype = jnp.dtype(dtype)
    key = jax.random.PRNGKey(2)
    st = lra.init(key, n, rank=rank, dtype=dtype)
    rng = np.random.default_rng(2)
    d = 0.5 + 0.5 * rng.random(n, dtype=np.float32)
    st = st.replace(d=jnp.asarray(d, dtype))
    v, h, g = _normals(jax.random.fold_in(key, 1), (n,), dtype=dtype)
    f64 = lambda x: np.asarray(x, np.float64)
    tol = TOL_BF16 if dtype == jnp.bfloat16 else TOL_FP32
    out, times = [], {}
    for i, (balance, update_u) in _lra_branch_keys(dtype):
        k = jax.random.PRNGKey(i)
        (new, pre), seconds = _on_device(_update_apply(lra, step), st, v, h, g, k)
        U, V, dd = oracles.lra_oracle(f64(st.U).T, f64(st.V).T, f64(st.d), f64(v), f64(h),
                                      step, balance=balance, update_u=update_u)
        label = f"lra{n}r{rank}{dtype.name}/{'U' if update_u else 'V'}-branch"
        times[label] = seconds
        for name, gv, w, b in (("U", new.U.T, U, st.U.T), ("V", new.V.T, V, st.V.T), ("d", new.d, dd, st.d)):
            out.append((f"{label}/{name}", oracles.delta_error(gv, w, b), tol))
        out.append((f"{label}/Pg", oracles.rel_error(pre, oracles.lra_apply(U, V, dd, f64(g))), tol))
    return out, times


def _lra_branch_keys(dtype):
    """Seeds i of PRNGKey(i) whose coins in lra.update take the U branch
    and the V branch, with the coins: [(i, (balance, update_u)), ...]."""
    found = {}
    for i in range(1000):
        k_bal, k_uv = jax.random.split(jax.random.PRNGKey(i))
        coins = (bool(jax.random.uniform(k_bal, dtype=dtype) < 0.01),
                 bool(jax.random.uniform(k_uv, dtype=dtype) < 0.5))
        found.setdefault(coins[1], (i, coins))
        if len(found) == 2:
            return [found[True], found[False]]
    raise AssertionError("no seed reaches both lra branches")


def check_splu_oracle(n=4096, rank=10):
    rng = np.random.default_rng(3)
    Lt, l3, U12, u3 = oracles.random_splu(rng, n, rank)
    st = splu.SpLUState(Lt=jnp.asarray(Lt), l3=jnp.asarray(l3),
                        U12=jnp.asarray(U12), u3=jnp.asarray(u3))
    v, h, g = (rng.standard_normal(n, dtype=np.float32) for _ in range(3))
    (new, pre), seconds = _on_device(_update_apply(splu), st, v, h, g, None)
    L, U = oracles.splu_oracle(*oracles.splu_dense(st), rank,
                               v.astype(np.float64), h.astype(np.float64), STEP)
    want = oracles.splu_blocks(L, U, rank)
    base = oracles.splu_blocks(*oracles.splu_dense(st), rank)
    scale = max(np.abs(w - b).max() for w, b in zip(want, base))
    out = [(f"splu{n}r{rank}/{name}", float(np.abs(np.asarray(gv, np.float64) - w).max() / scale), TOL_FP32)
           for name, gv, w in zip(("Lt", "l3", "U12", "u3"), (new.Lt, new.l3, new.U12, new.u3), want)]
    Q = L @ U
    out.append((f"splu{n}r{rank}/Pg", oracles.rel_error(pre, Q.T @ (Q @ g.astype(np.float64))), TOL_FP32))
    return out, {f"splu{n}r{rank}": seconds}


# ------------------------------------- family checks: the CPU backend

def check_flat_vs_cpu(family, n, walk=2):
    """update + apply of a flat family on the GPU against the same
    function on the CPU, from a state walked `walk` steps off its init."""
    fam = base.FLAT_FAMILIES[family]
    key = jax.random.PRNGKey(n % 9973)
    st = fam.init(n, rank=10) if family == "splu" else fam.init(n)
    upd = jax.jit(lambda st, v, h, k: fam.update(st, v, h, step=STEP, key=k))
    for i in range(walk):
        v, h = _normals(jax.random.fold_in(key, 10 + i), (n,), k=2)
        st = upd(st, v, h, jax.random.fold_in(key, 20 + i))
    v, h, g = _normals(jax.random.fold_in(key, 1), (n,))
    (new, pre), (want, want_pre), seconds = _vs_cpu(
        _update_apply(fam), st, v, h, g, jax.random.fold_in(key, 2))
    tol = TOL_ELEMENTWISE if family in ("diag", "xmat", "shift") else TOL_FP32
    label = f"{family}{n}"
    return _tree_errs(label, new, want, jax.device_get(st), tol) + [
        (f"{label}/Pg", oracles.rel_error(pre, want_pre), tol)], {label: seconds}


def check_kron_vs_cpu(fmt, shape, walk=1):
    key = jax.random.PRNGKey(shape[0] % 9973)
    st = kron.init(shape, fmt=fmt, init_scale=0.9)
    upd = jax.jit(lambda st, dX, dG: kron.update(st, dX, dG, step=STEP))
    for i in range(walk):
        dX, dG = _normals(jax.random.fold_in(key, 10 + i), shape, k=2)
        st = upd(st, dX, dG)
    dX, dG, G = _normals(jax.random.fold_in(key, 1), shape)
    (new, pre), (want, want_pre), seconds = _vs_cpu(_kron_update_apply, st, dX, dG, G)
    label = f"kron{fmt}{shape}"
    return _tree_errs(label, new, want, jax.device_get(st), TOL_FP32) + [
        (f"{label}/Pg", oracles.rel_error(pre, want_pre), TOL_FP32)], {label: seconds}


FAMILY_CHECKS = {
    "kron_nmt_layers": check_kron_nmt_layers,
    "dense_4096": partial(check_dense_oracle, 4096),
    "lra_1M_fp32": partial(check_lra_oracle, 1 << 20, 10, "float32"),
    "lra_1M_bf16": partial(check_lra_oracle, 1 << 20, 10, "bfloat16", STEP_BF16),
    "splu_4096": partial(check_splu_oracle, 4096, 10),
    "diag_4M": partial(check_flat_vs_cpu, "diag", 1 << 22),
    "xmat_4M": partial(check_flat_vs_cpu, "xmat", 1 << 22),
    "shift_4M": partial(check_flat_vs_cpu, "shift", 1 << 22),
    "splu_1M": partial(check_flat_vs_cpu, "splu", 1 << 20),
    "dense_16384": partial(check_flat_vs_cpu, "dense", 1 << 14),
    "kron_nd": partial(check_kron_vs_cpu, ("norm", "dense"), (131072, 512)),
    "kron_ns": partial(check_kron_vs_cpu, ("norm", "scale"), (65536, 8192)),
    "kron_ds": partial(check_kron_vs_cpu, ("dense", "scale"), (512, 131072)),
    "kron_ns_wide": partial(check_kron_vs_cpu, ("norm", "scale"), (512, 1_000_000)),
}


def run_family_checks() -> None:
    bad = []
    for name, check in FAMILY_CHECKS.items():
        t0 = time.perf_counter()
        rows, times = check()
        worst = max(rows, key=lambda r: r[1] / r[2])
        info(f"family/{name}", seconds=round(time.perf_counter() - t0, 3),
             worst=worst[0], err=worst[1], tol=worst[2],
             errors={label: err for label, err, _ in rows},
             update_apply_s=times)
        bad += [r for r in rows if not (np.isfinite(r[1]) and r[1] < r[2])]
    if bad:
        raise AssertionError(f"outside tolerance: {bad}")


# ------------------------------------------------------------ trainers

def time_steps(name, opt, loss_fn, params, state, key, batch, steps=10):
    """Compile time, steady step time and peak device memory of one jitted
    training step; returns the compiled step."""
    step = jax.jit(partial(opt.step, loss_fn))
    t0 = time.perf_counter()
    compiled = step.lower(params, state, key, *batch).compile()
    compile_s = time.perf_counter() - t0
    keys = [jax.random.fold_in(key, i) for i in range(steps + 1)]
    p, s, aux = compiled(params, state, keys[0], *batch)
    jax.block_until_ready(aux)
    t0 = time.perf_counter()
    for k in keys[1:]:
        p, s, aux = compiled(p, s, k, *batch)
    jax.block_until_ready((p, s, aux))
    info(name, compile_s=compile_s, step_s=(time.perf_counter() - t0) / steps,
         steps=steps, loss=float(aux["loss"]), peak_bytes_in_use=peak_bytes())
    return compiled


def _falls(first: float, last: float, what: str) -> None:
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        raise AssertionError(f"{what}: loss {first} -> {last} is not finite and falling")


def phase_nmt() -> None:
    from psgd_tf_tpu.models import nmt
    from psgd_tf_tpu.workloads import nmt_attention

    cfg = nmt.ref_config()
    t0 = time.perf_counter()
    res = nmt_attention.run(steps=20, cfg=cfg)
    info("nmt/run_fd", seconds=time.perf_counter() - t0, first_loss=res["first_loss"],
         loss=res["loss"], token_accuracy=res["token_accuracy"], peak_bytes_in_use=peak_bytes())
    print(f"nmt ref width, FD Hvp, 20 steps: loss {res['first_loss']:.6f} -> {res['loss']:.6f}", flush=True)
    _falls(res["first_loss"], res["loss"], "nmt")
    t0 = time.perf_counter()
    ex = nmt_attention.run(steps=1, cfg=cfg, exact_hvp=True)
    info("nmt/run_exact", seconds=time.perf_counter() - t0, loss=ex["loss"])
    if not np.isfinite(ex["loss"]):
        raise AssertionError(f"nmt exact-Hvp step: loss {ex['loss']}")

    # the first step of run(), rebuilt, on the GPU and on the CPU
    key = jax.random.PRNGKey(0)
    k_init, k_opt, key = jax.random.split(key, 3)
    params = nmt.init(k_init, cfg)
    opt = PSGD(preconditioner="kron", kron_formats=nmt.kron_formats(cfg), lr_params=0.05,
               lr_preconditioner=0.05, grad_clip_max_norm=1.0,
               exact_hessian_vector_product=False)
    state = opt.init(params, k_opt)
    key, k_data, k_step = jax.random.split(key, 3)
    batch = nmt_attention.synthetic_batch(k_data, cfg, 64, 16)
    compiled = time_steps("nmt/step_fd kron_batched=True", opt, nmt.loss, params, state, k_step, batch)
    mem = compiled.memory_analysis()
    info("nmt/memory_analysis", **{f: getattr(mem, f, None) for f in (
        "argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")})
    time_steps("nmt/step_fd kron_batched=False", dataclasses.replace(opt, kron_batched=False),
               nmt.loss, params, state, k_step, batch)
    _, _, aux = jax.device_get(compiled(params, state, k_step, *batch))
    with jax.default_matmul_precision("highest"):
        _, _, aux_cpu = jax.device_get(jax.jit(partial(opt.step, nmt.loss))(
            *_on_cpu((params, state, k_step, *batch))))
    errs = {k: abs(float(aux[k]) - float(aux_cpu[k])) / abs(float(aux_cpu[k]))
            for k in ("loss", "grad_norm")}
    info("nmt/first_step_vs_cpu", gpu={k: float(aux[k]) for k in errs},
         cpu={k: float(aux_cpu[k]) for k in errs}, rel_err=errs, tol=TOL_STEP_SCALARS,
         run_first_loss=res["first_loss"])
    if max(errs.values()) >= TOL_STEP_SCALARS:
        raise AssertionError(f"nmt first step vs CPU: {errs}")


def phase_lenet5() -> None:
    from psgd_tf_tpu.data import mnist
    from psgd_tf_tpu.models import lenet5
    from psgd_tf_tpu.workloads import mnist_lenet5

    t0 = time.perf_counter()
    res = mnist_lenet5.run(epochs=1, steps_per_epoch=20)
    info("lenet5/run", seconds=time.perf_counter() - t0, first_loss=res["first_loss"],
         loss=res["loss"], best_test_error=res["best_test_error"], peak_bytes_in_use=peak_bytes())
    print(f"lenet5, batch 64, 20 steps: loss {res['first_loss']:.6f} -> {res['loss']:.6f}", flush=True)
    _falls(res["first_loss"], res["loss"], "lenet5")

    key = jax.random.PRNGKey(0)
    params = lenet5.init(key)
    num_params = sum(p.size for p in jax.tree_util.tree_leaves(params))
    opt = PSGD(preconditioner="kron", kron_formats=[("dense", "dense")] * 5, lr_params=0.1,
               lr_preconditioner=0.1, grad_clip_max_norm=0.1 * num_params**0.5)
    batch = mnist.synthetic_hard(jax.random.fold_in(key, 1), 64)
    for batched in (True, False, True, False):  # alternated: host-timing noise
        o = dataclasses.replace(opt, kron_batched=batched)
        time_steps(f"lenet5/step kron_batched={batched}", o, lenet5.loss, params,
                   o.init(params, key), key, batch, steps=50)


# ------------------------------------------------------- four cards

def replay(step_a, step_b, p0, s0, key, batch, steps=5):
    """Run two training steps `steps` times from the same start with the
    same keys: ((params, state) after step_a, (params, state) after
    step_b, per-step losses [(loss_a, loss_b), ...])."""
    pa, sa, pb, sb = p0, s0, p0, s0
    losses = []
    for i in range(steps):
        k = jax.random.fold_in(key, 100 + i)
        pa, sa, aux_a = step_a(pa, sa, k, *batch)
        pb, sb, aux_b = step_b(pb, sb, k, *batch)
        losses.append((float(aux_a["loss"]), float(aux_b["loss"])))
    return (pa, sa), (pb, sb), losses


def trajectory_gaps(p0, pa, pb, losses):
    """How far trajectory a strays from trajectory b: the worst leaf's
    delta_error(pa, pb, p0), and the largest per-step loss gap over the
    fall of b's loss from its first step to its last."""
    leaves = jax.tree_util.tree_leaves
    params = max(oracles.delta_error(a, b, z) for a, b, z in zip(leaves(pa), leaves(pb), leaves(p0)))
    la, lb = np.asarray(losses, np.float64).T
    loss = float(np.abs(la - lb).max() / abs(lb[0] - lb[-1]))
    return params, loss


def phase_sharded() -> None:
    from jax.sharding import PartitionSpec as P

    from psgd_tf_tpu.data import mnist
    from psgd_tf_tpu.models import lenet5, nmt
    from psgd_tf_tpu.parallel import build_sharded_step, make_mesh
    from psgd_tf_tpu.workloads import nmt_attention

    mesh = make_mesh(data=2, shard=2)
    cfg = nmt.ref_config()
    key = jax.random.PRNGKey(0)
    k_init, k_data, k_mlp, k_x, k_le = jax.random.split(key, 5)
    params = nmt.init(k_init, cfg)
    batch = nmt_attention.synthetic_batch(k_data, cfg, 64, 16)
    common = dict(lr_params=0.02, lr_preconditioner=0.02, grad_clip_max_norm=1.0)
    mlp = [0.5 * jax.random.normal(jax.random.fold_in(k_mlp, i), (24, 24)) for i in range(6)]
    x = jax.random.normal(k_x, (64, 24))
    le_params = lenet5.init(k_le)
    le_batch = mnist.synthetic_hard(jax.random.fold_in(k_le, 1), 64)

    def mlp_loss(ws, x):
        y = x
        for w in ws:
            y = jnp.tanh(y @ w)
        return jnp.mean(jnp.sum(y * y, axis=-1))

    # The NMT's flat state (n = 12,424,273, odd) cannot split over two
    # shards and replicates: its lra and splu cases check data parallelism
    # only. LeNet5 (n = 44,426) shards the lra and splu state over `shard`,
    # so the rank-space reductions cross the cards; the case fails if its
    # state is not sharded.
    cases = [
        ("kron-mixed", PSGD(preconditioner="kron", kron_formats=nmt.kron_formats(cfg), **common),
         nmt.loss, params, batch, None, False),
        ("lra", PSGD(preconditioner="lra", rank=10, **common), nmt.loss, params, batch, None, False),
        ("splu", PSGD(preconditioner="splu", rank=10, **common), nmt.loss, params, batch, None, False),
        ("lra-lenet5", PSGD(preconditioner="lra", rank=10, **common),
         lenet5.loss, le_params, le_batch, None, True),
        ("splu-lenet5", PSGD(preconditioner="splu", rank=10, **common),
         lenet5.loss, le_params, le_batch, None, True),
        ("kron-tp", PSGD(preconditioner="kron", kron_formats=[("dense", "dense")] * 6,
                         kron_batched=False, lr_params=0.05, grad_clip_max_norm=1.0),
         mlp_loss, mlp, (x,), [P(None, "shard") if i % 2 == 0 else P("shard", None) for i in range(6)],
         False),
    ]
    bad = []
    for name, opt, loss_fn, p0, b, specs, state_sharded in cases:
        t0 = time.perf_counter()
        state = opt.init(p0, jax.random.fold_in(key, 7))
        sharded = build_sharded_step(opt, loss_fn, mesh, state, p0, donate=False, param_specs=specs)
        single = jax.jit(partial(opt.step, loss_fn))
        (ps, ss), (p1, _), losses = replay(sharded, single, p0, state, key, b)
        params_gap, loss_gap = trajectory_gaps(p0, ps, p1, losses)
        specs_seen = sorted({str(leaf.sharding.spec) for leaf in jax.tree_util.tree_leaves(ss.precond)})
        info(f"sharded/{name}", seconds=time.perf_counter() - t0, losses=losses,
             params_gap=params_gap, loss_gap=loss_gap, tol=TOL_SHARDED, state_specs=specs_seen,
             peak_bytes_in_use=peak_bytes())
        print(f"sharded {name}: loss {losses[0][0]:.6f} -> {losses[-1][0]:.6f}, vs single device: "
              f"params {params_gap:.3e} of the update, losses {loss_gap:.3e} of the fall", flush=True)
        if not (np.all(np.isfinite(losses)) and max(params_gap, loss_gap) < TOL_SHARDED):
            bad.append((name, params_gap, loss_gap))
        if state_sharded and not any("shard" in spec for spec in specs_seen):
            bad.append((name, "state not sharded", specs_seen))
    if bad:
        raise AssertionError(f"sharded vs single device: {bad}")


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1,
                        help="4: run only the sharded path on four cards")
    args = parser.parse_args(argv)

    devs = jax.devices()
    platform, kind, count = devs[0].platform, devs[0].device_kind, len(devs)
    print(f"device: platform={platform} kind={kind} count={count}", flush=True)
    print(f"card: {card_line()}", flush=True)
    if platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {platform}", file=sys.stderr)
        return 2
    if count < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, found {count}",
              file=sys.stderr)
        return 2
    if not os.path.abspath(psgd_tf_tpu.__file__).startswith(HERE + os.sep):
        print(f"chip_smoke: psgd_tf_tpu comes from {psgd_tf_tpu.__file__}, "
              "not from this checkout", file=sys.stderr)
        return 2
    info("compile_cache", dir=compile_cache.enable())

    phases = ([("sharded", phase_sharded)] if args.chips == 4 else
              [("nmt", phase_nmt), ("lenet5", phase_lenet5), ("families", run_family_checks)])
    failed = []
    for name, phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
